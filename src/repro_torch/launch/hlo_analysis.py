"""Collective-traffic accounting for the roofline, the JAX package's
``src/repro/launch/hlo_analysis.py`` on torch.

The reference parses the per-device optimized HLO text.  The port has no
HLO: its input is the list of collectives rank 0 issued while the step
ran, each a functional collective (``_c10d_functional.*``, what DTensor
issues to redistribute) with its operand and result bytes and its
group's size (:func:`collective_event`, called by the dry-run's dispatch
mode on every local op).  Each is converted to *algorithm bytes per
device* with the reference's formulas:

  all-reduce       2·B·(g-1)/g        (ring: reduce-scatter + all-gather)
  all-gather       B_out·(g-1)/g      (received shards)
  reduce-scatter   B_in·(g-1)/g
  all-to-all       B·(g-1)/g
  collective-permute  B

These are per-rank link bytes — divide by link bandwidth for the
collective roofline term.
"""

from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence

__all__ = ["collective_stats", "CollectiveReport", "CollectiveEvent",
           "collective_event"]

#: functional collective → the reference's HLO opcode
_OPS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


@dataclasses.dataclass(frozen=True)
class CollectiveEvent:
    op: str             # the reference's opcode ("all-reduce", ...)
    operand_bytes: int
    result_bytes: int
    group_size: int


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _tensors(x) -> list:
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for t in x if isinstance(t, torch.Tensor)]
    return []


def collective_event(func, args, out) -> Optional[CollectiveEvent]:
    """The event of one functional collective op (its operand(s) are
    ``args[0]``, its group named by its last string argument), or None
    for any other op (``wait_tensor`` included)."""
    if getattr(func, "namespace", None) != "_c10d_functional":
        return None
    op = _OPS.get(func._overloadpacket.__name__)
    if op is None:
        return None
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = [a for a in args if isinstance(a, str)][-1]
    return CollectiveEvent(op, _nbytes(_tensors(args[0])),
                           _nbytes(_tensors(out)),
                           _resolve_process_group(name).size())


@dataclasses.dataclass
class CollectiveReport:
    total_algorithm_bytes: float
    by_op: Dict[str, float]
    counts: Dict[str, int]
    result_bytes: Dict[str, float]
    schedule: List[str]  # ordered (opcode, MB, group) lines
    n_while_loops: int   # 0: the port runs every loop eagerly


def collective_stats(events: Sequence[CollectiveEvent]) -> CollectiveReport:
    """Algorithm bytes per device of ``events``, in order."""
    by_op: Dict[str, float] = defaultdict(float)
    res_by_op: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = Counter()
    schedule: List[str] = []
    for ev in events:
        operand_b, result_b, g = (ev.operand_bytes, ev.result_bytes,
                                  ev.group_size)
        gf = (g - 1) / g if g > 1 else 0.0
        if ev.op == "all-reduce":
            algo = 2.0 * operand_b * gf
        elif ev.op == "all-gather":
            algo = result_b * gf
        elif ev.op == "reduce-scatter":
            algo = operand_b * gf
        elif ev.op == "all-to-all":
            algo = operand_b * gf
        else:  # collective-permute
            algo = float(operand_b)
        by_op[ev.op] += algo
        res_by_op[ev.op] += result_b
        counts[ev.op] += 1
        schedule.append(
            f"{ev.op:<20s} {operand_b/1e6:9.2f} MB op, "
            f"{result_b/1e6:9.2f} MB res, g={g}")
    return CollectiveReport(
        total_algorithm_bytes=float(sum(by_op.values())),
        by_op=dict(by_op),
        counts=dict(counts),
        result_bytes=dict(res_by_op),
        schedule=schedule,
        n_while_loops=0,
    )
