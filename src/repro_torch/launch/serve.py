"""Serving launcher: stand up a ServeEngine for an arch and pump a
synthetic request stream through it (batched, paged KV) on the GPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --smoke \
      --requests 16

The flags are the JAX package's (``python -m repro.launch.serve``),
``--smoke`` included: it is on by default and no flag turns it off, so
the launcher always serves the arch's smoke config in float32.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.runtime import resolve_device
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine


def main(argv=None, *, device=None) -> None:
    """``device``: ``None`` is CUDA (raising without it); the tests pass
    ``"cpu"``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--allocator", default="bitset",
                    choices=["bitset", "nextfit"])
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg.smoke(), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    eng = ServeEngine(cfg, params, max_batch=args.max_batch,
                      allocator=args.allocator, device=dev)
    rng = np.random.default_rng(0)
    reqs = [
        eng.submit(rng.integers(1, cfg.vocab, size=int(l)).tolist(),
                   max_new_tokens=args.max_new)
        for l in rng.integers(3, 10, size=args.requests)
    ]
    t0 = time.perf_counter()
    eng.run()
    wall = time.perf_counter() - t0
    tok = sum(len(r.generated) for r in reqs)
    print(f"{len(reqs)} requests, {tok} tokens, {wall:.2f}s "
          f"({tok/max(wall,1e-9):.1f} tok/s); pool free "
          f"{eng.pool.free_pages}/{eng.pool.num_pages}")


if __name__ == "__main__":
    main()
