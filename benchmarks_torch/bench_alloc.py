"""Paper Fig 7: hete_Malloc / hete_Free overhead vs block size.

Sweeps bitset block sizes 8 B .. 64 KiB and float problem sizes
32..8192, measuring per-call allocation and deallocation time on a
64 MiB arena, against python/numpy allocation as the "C/C++ default"
stand-in.  Host only: the arenas are bookkeeping, no device is touched.

Run:  PYTHONPATH=src python -m benchmarks_torch.bench_alloc
"""

from __future__ import annotations

import time

import numpy as np

from .common import emit

BLOCK_SIZES = (8, 64, 512, 4096, 65536)
PROBLEM_SIZES = (32, 512, 8192)  # float32 elements


def run(iters: int = 200) -> None:
    from repro_torch.core.allocator import BitsetAllocator

    for prob in PROBLEM_SIZES:
        nbytes = prob * 4
        # baseline: raw numpy allocation (malloc analogue)
        t0 = time.perf_counter()
        for _ in range(iters):
            a = np.empty(prob, np.float32)
            del a
        base_us = (time.perf_counter() - t0) / iters * 1e6
        emit(f"fig7_malloc_default_n{prob}", base_us, "numpy empty/free")
        for bs in BLOCK_SIZES:
            arena = BitsetAllocator(64 << 20, bs)
            # steady-state: arena half full of persistent allocations
            persist = []
            try:
                for _ in range(64):
                    persist.append(arena.alloc(max(nbytes, bs)))
            except Exception:
                pass
            t0 = time.perf_counter()
            exts = [arena.alloc(nbytes) for _ in range(iters)]
            alloc_us = (time.perf_counter() - t0) / iters * 1e6
            t0 = time.perf_counter()
            for e in exts:
                arena.free(e)
            free_us = (time.perf_counter() - t0) / iters * 1e6
            emit(
                f"fig7_hete_malloc_n{prob}_bs{bs}", alloc_us,
                f"free_us={free_us:.3f};metadata_B={arena.metadata_bytes()}",
            )


if __name__ == "__main__":
    run()
