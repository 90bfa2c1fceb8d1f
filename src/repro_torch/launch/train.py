"""Training launcher on one device: the JAX package's
``python -m repro.launch.train`` without the mesh (ROADMAP A11 brings
``--multi-pod`` and ``--distributed``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --steps 50 --smoke            # reduced config (the GPU)
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite_moe_3b_a800m --smoke --steps 3 --device cpu

Without ``--smoke`` the full config trains at ``train_4k``'s shape unless
``--batch``/``--seq`` cut it.  Float32 master weights, AdamW, per-layer
remat; checkpoints under ``--ckpt-dir`` (resumed from when present).
"""

from __future__ import annotations

import argparse

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import Trainer, TrainerConfig


def main(argv=None, *, device=None) -> dict:
    """``device``: ``None`` is CUDA (raising without it), unless
    ``--device`` names one; the tests pass ``"cpu"``.  Returns the
    Trainer's report."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default="checkpoints/launch")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
        batch = args.batch or 2
        seq = args.seq or 64
    else:
        shape = SHAPES["train_4k"]
        batch = args.batch or shape.global_batch
        seq = args.seq or shape.seq_len

    trainer = Trainer(
        cfg, batch_size=batch, seq_len=seq,
        tcfg=TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                           microbatches=args.microbatches),
        opt_cfg=AdamWConfig(), device=args.device or device)
    trainer.install_signal_handlers()
    report = trainer.run()
    print(f"finished at step {report['final_step']} "
          f"(preempted={report['preempted']}, "
          f"stragglers={report['straggler_events']})")
    for m in report["metrics"][-5:]:
        print(m)
    return report


if __name__ == "__main__":
    main()
