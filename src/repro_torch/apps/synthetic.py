"""Synthetic DAG workloads for the graph executor benchmarks/tests.

The radar chains (:mod:`repro_torch.apps.radar`) are mostly linear per way;
these builders produce *fork-join* structures whose width is what the
async executor exploits: a shared source feeds ``ways`` independent
branches, whose results reduce pairwise back to one output.  All tasks
use the standard radar op set (``fft``/``ifft``/``zip``) so every
registered runtime kernel applies unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.apps.radar import _fill
from repro_torch.core.hete import HeteContext, HeteData
from repro_torch.core.runtime import Task

__all__ = ["build_fork_join", "build_diamonds", "submit_fork_join"]

C64 = np.complex64


def build_fork_join(
    ctx: HeteContext,
    *,
    ways: int = 4,
    n: int = 4096,
    depth: int = 2,
    seed: int = 0,
) -> Tuple[Dict[str, HeteData], List[Task]]:
    """Fork-join DAG: source FFT → ``ways`` parallel branches (each a
    ``depth``-long fft/zip chain) → pairwise zip reduction to one output.

    ``ways`` must be a power of two (for the clean reduction tree).
    Serial makespan grows with ``ways × depth``; critical path only with
    ``depth + log2(ways)`` — the gap is the executor's opportunity.
    """
    if ways < 1 or ways & (ways - 1):
        raise ValueError(f"ways must be a power of two, got {ways}")
    rng = np.random.default_rng(seed)
    src = ctx.malloc((n,), C64)
    _fill(src, rng)
    fsrc = ctx.malloc((n,), C64)
    tasks = [Task("fft", [src], [fsrc], name="src_fft")]

    branch_outs: List[HeteData] = []
    for w in range(ways):
        weight = ctx.malloc((n,), C64)
        _fill(weight, rng)
        cur = ctx.malloc((n,), C64)
        tasks.append(Task("zip", [fsrc, weight], [cur], name=f"fork{w}_zip"))
        for d in range(depth):
            nxt = ctx.malloc((n,), C64)
            op = "fft" if d % 2 == 0 else "ifft"
            tasks.append(Task(op, [cur], [nxt], name=f"branch{w}_{op}{d}"))
            cur = nxt
        branch_outs.append(cur)

    level = 0
    while len(branch_outs) > 1:
        nxt_outs: List[HeteData] = []
        for j in range(0, len(branch_outs), 2):
            merged = ctx.malloc((n,), C64)
            tasks.append(Task(
                "zip", [branch_outs[j], branch_outs[j + 1]], [merged],
                name=f"join{level}_{j // 2}",
            ))
            nxt_outs.append(merged)
        branch_outs = nxt_outs
        level += 1

    return {"src": src, "out": branch_outs[0]}, tasks


def submit_fork_join(
    session,
    *,
    ways: int = 4,
    n: int = 4096,
    depth: int = 2,
    seed: int = 0,
) -> Dict[str, "BufferFuture"]:
    """:func:`build_fork_join` through the streaming session API:
    identical DAG structure, buffer sizes, fill seeds and submission
    order, so a single-threaded session with static
    ``round_robin`` placement is bit-identical — outputs *and* per-pair
    copy counts — to batch ``run_graph``/serial ``run`` on the same
    build.  Returns ``{"src", "out"}`` futures; ``out.result()`` is the
    only sync point."""
    if ways < 1 or ways & (ways - 1):
        raise ValueError(f"ways must be a power of two, got {ways}")
    rng = np.random.default_rng(seed)
    src = session.malloc((n,), C64)
    _fill(src.hete, rng)
    fsrc = session.submit("fft", [src], name="src_fft")

    branch_outs = []
    for w in range(ways):
        weight = session.malloc((n,), C64)
        _fill(weight.hete, rng)
        cur = session.submit("zip", [fsrc, weight], name=f"fork{w}_zip")
        for d in range(depth):
            op = "fft" if d % 2 == 0 else "ifft"
            cur = session.submit(op, [cur], name=f"branch{w}_{op}{d}")
        branch_outs.append(cur)

    level = 0
    while len(branch_outs) > 1:
        nxt_outs = []
        for j in range(0, len(branch_outs), 2):
            nxt_outs.append(session.submit(
                "zip", [branch_outs[j], branch_outs[j + 1]],
                name=f"join{level}_{j // 2}",
            ))
        branch_outs = nxt_outs
        level += 1

    return {"src": src, "out": branch_outs[0]}


def build_diamonds(
    ctx: HeteContext,
    *,
    count: int = 8,
    n: int = 2048,
    seed: int = 0,
) -> Tuple[Dict[str, HeteData], List[Task]]:
    """``count`` independent diamond DAGs (fft → two zips → zip join) —
    maximal inter-diamond parallelism, for scheduler stress tests."""
    rng = np.random.default_rng(seed)
    outs: List[HeteData] = []
    tasks: List[Task] = []
    for c in range(count):
        a = ctx.malloc((n,), C64)
        _fill(a, rng)
        fa = ctx.malloc((n,), C64)
        left, right, out = (ctx.malloc((n,), C64) for _ in range(3))
        tasks += [
            Task("fft", [a], [fa], name=f"d{c}_top"),
            Task("zip", [fa, a], [left], name=f"d{c}_left"),
            Task("zip", [fa, fa], [right], name=f"d{c}_right"),
            Task("zip", [left, right], [out], name=f"d{c}_join"),
        ]
        outs.append(out)
    return {"outs": outs}, tasks
