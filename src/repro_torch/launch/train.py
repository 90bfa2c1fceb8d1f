"""Training launcher: the JAX package's ``python -m repro.launch.train``.

``--distributed`` joins the process group the environment describes
(``torch.distributed.init_process_group`` from ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``: NCCL on CUDA, gloo on the
CPU), the counterpart of ``jax.distributed.initialize()``.  The mesh
covers the world: the production mesh (``--multi-pod``: 2×16×16) at 256
ranks or more, else a local ``data=world`` mesh, and the Trainer runs
under its axis rules.  On a world of one rank every leaf stays a plain
tensor on the device (as a one-device JAX array is a plain array), so
the model runs as without the flag; a world above one rank raises
(ROADMAP C.21), as the JAX package's launcher fails on two devices: its
``Trainer`` commits the state to one device, and the first sharding
constraint over the mesh refuses it ("Received incompatible devices for
jitted computation").

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
import contextlib

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import Trainer, TrainerConfig


def _mesh_rules(multi_pod: bool, device_type: str):
    """The rules of a mesh over the whole process group."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import (make_local_mesh,
                                         make_production_mesh,
                                         rules_for_mesh)

    world = dist.get_world_size()
    if world >= 256:
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=device_type)
    else:
        mesh = make_local_mesh(data=world, model=1, device_type=device_type)
    if world > 1:
        raise NotImplementedError(
            f"launch.train --distributed on {world} ranks: the port trains "
            f"on one rank only, as the JAX package's launcher does (its "
            f"Trainer's state sits on one device and a world of two fails "
            f"there; ROADMAP C.21)")
    return rules_for_mesh(mesh)


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
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group the environment names "
                         "(NCCL on CUDA, gloo on the CPU)")
    ap.add_argument("--ckpt-dir", default="checkpoints/launch")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.runtime import resolve_device
    from repro_torch.distributed.sharding import use_rules

    dev = resolve_device(args.device or device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
        batch = args.batch or 2
        seq = args.seq or 64
    else:
        shape = SHAPES["train_4k"]
        batch = args.batch or shape.global_batch
        seq = args.seq or shape.seq_len

    with contextlib.ExitStack() as stack:
        if args.distributed:
            import torch.distributed as dist

            cuda = dev.type == "cuda"
            dist.init_process_group(
                "nccl" if cuda else "gloo",
                device_id=torch.device("cuda", torch.cuda.current_device()
                                       if dev.index is None else dev.index)
                if cuda else None)
            stack.callback(dist.destroy_process_group)
            stack.enter_context(use_rules(
                _mesh_rules(args.multi_pod, dev.type)))
        trainer = Trainer(
            cfg, batch_size=batch, seq_len=seq,
            tcfg=TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                               microbatches=args.microbatches),
            opt_cfg=AdamWConfig(), device=dev)
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
