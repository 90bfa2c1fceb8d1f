"""Multi-pod dry-run on torch: run every (arch × shape × mesh) cell's step
once on fake ranks, the JAX package's ``src/repro/launch/dryrun.py``.

The reference fakes 512 host devices with an XLA flag and compiles each
step.  The port fakes the ranks with torch's ``fake`` process-group
backend (world 256 or 512, this process rank 0), builds parameters,
optimizer state, caches and batches as DTensors of fake tensors (no
storage anywhere), and runs its own step (:mod:`repro_torch.train.step`)
once, eagerly.  Nothing is allocated on any device.  Per cell it records:

  * ``cost.flops``: FLOPs per device — the local ops rank 0 runs on its
    shards, matmul-class ops by ``torch.utils.flop_counter``'s formulas
    (FlopCounterMode's table), every other pointwise op one FLOP per
    output element (transcendental ones under ``cost.transcendentals``;
    a copy none), as XLA's cost analysis counts them.  Counting the local ops is the
    rule "global FLOPs divided by the product of the mesh dims on which
    the op's output is Shard or Partial" (an op replicated on a dim runs
    on every rank of it);
  * ``cost.bytes_accessed`` (computed): each counted op's input and
    output bytes, views excluded; a gather by index tensors (the
    embedding's lookup) its output's bytes twice and its indices', as
    XLA counts a gather;
  * ``memory.per_device_total``: the peak of live local bytes on rank 0
    (inputs included) under eager execution — XLA's figure is arguments
    + temps + outputs − aliases under its own schedule; the serve step
    writes its caches in place, so ``alias_size_in_bytes`` is every
    returned cache's, as the reference's donated caches;
  * ``collectives``: the functional collectives DTensor issued on rank 0
    (:mod:`repro_torch.launch.hlo_analysis`);
  * ``model_flops``, ``recurrent_correction_flops``, ``params_total``,
    ``params_active`` from the full config, as the reference records
    them.

DTensor, not GSPMD, decides where to redistribute, so ``by_op`` and
``counts`` differ from the reference's for the same cell; what is equal
is the input: placements resolved from the same logical specs.  The
model lays out what GSPMD partitions by propagation where DTensor would
not: attention runs on each rank's head or sequence shards, a windowed
chunk on the keys of its span alone, and the loss's chunks on each
rank's sequence shard (:mod:`repro_torch.models.layers`); the MoE
dispatch on each rank's groups, a decode step's cache writes on each
rank's cache shard, cross attention's queries split over ranks that
would each do all of them (:mod:`repro_torch.models.blocks`); the
recurrent blocks' wide products by column shards and the mLSTM's chunks
on each rank's batch (:mod:`repro_torch.models.recurrent`).  Where
DTensor's own choice differs
from GSPMD's, :class:`_GspmdLike` reshards first (its docstring lists
each case), so torch 2.11 and 2.13 give the same plan.  On a CPU process
group DTensor does an all-to-all as all-gather + chunk.

Roofline probes (``--probe 1|2``) run the model with 1 or 2 layer
groups, and a training probe recomputes nothing (no remat), as the
reference's; the roofline tool extrapolates ``c1 + (G_eff - 1)·(c2 -
c1)``.
The port runs every layer, so its counts are complete and the
extrapolation equals the full cell's count for a model of identical
groups; the probes are kept so both packages build their tables the same
way.  The sLSTM's loop over time (:func:`repro_torch.models.recurrent.
time_loop`, forward and, in training, backward) runs its first two
steps, and the second's count is added for every other step
(:class:`_OneStep`): every step runs the same ops on the same shapes and
layouts, so the record's count is the whole loop's.  ``rec["loops"]``
holds each loop's step count and one step's figures.

Held to the reference: at one group (``--probe 1``) the reference
unrolls its layers, so its records count every op but those of its
while loops (``n_while_loops``: the sLSTM's ``lax.scan``, forward and in
training backward), whose body XLA's cost analysis and the collective
parser count once.  The cells of ``dryrun_reference.json`` (the
reference CLI's records of every cell on both meshes, written by
``tests/make_dryrun_reference.py``) are held to :data:`BOUNDS` of them by
:func:`against_reference`.  Against a record with while loops, the
port's FLOPs, collective bytes and bytes accessed are taken with each
loop's steps out but one (:func:`loop_body_once`: the body once, as XLA
counts it); against one without, its complete count.  The memory is the
eager peak against XLA's either way.  The CLI prints a cell's four
ratios whenever a record of it is there.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --sweep [--probes] [--skip-existing]
  python -m repro_torch.launch.dryrun --held [--jobs N]   # the held cells, exit 1 on a miss
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs.base import ARCH_IDS, SHAPES, cells_for, get_config
from repro_torch.distributed.sharding import gathered_numel, use_rules
from repro_torch.launch.hlo_analysis import collective_event, collective_stats
from repro_torch.launch.mesh import make_production_mesh, rules_for_mesh
from repro_torch.launch.specs import input_shardings, input_specs
from repro_torch.models import recurrent
from repro_torch.models.model_api import build_model, stack_plan
from repro_torch.train.step import (build_prefill_step, build_serve_step,
                                    build_train_step)
from repro_torch.tree import leaves, map_tree

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

#: gradient-accumulation factor per arch for train cells (activation
#: memory control; probes always use 1 — same per-step cost totals).
MICROBATCHES = {"command_r_plus_104b": 16, "internvl2_26b": 8}
DEFAULT_MICROBATCHES = 8

#: per-arch sharding-rule overrides: Megatron-style sequence parallelism
#: on the residual stream for the largest dense archs.
RULES_OVERRIDES = {
    "command_r_plus_104b": {"res_seq": ("model",)},
    "internvl2_26b": {"res_seq": ("model",)},
    "qwen3_moe_235b_a22b": {"res_seq": ("model",)},
}

aten = torch.ops.aten

#: pointwise ops XLA counts as transcendentals
_TRANSCENDENTAL = {
    aten.exp, aten.exp2, aten.expm1, aten.log, aten.log1p, aten.log2,
    aten.tanh, aten.sigmoid, aten.rsqrt, aten.sqrt, aten.sin, aten.cos,
    aten.erf, aten.pow, aten.log_sigmoid_forward, aten.softplus,
}

_VIEWS = {aten.view.default, aten._unsafe_view.default,
          aten.reshape.default}
_PRODUCTS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
             aten.baddbmm.default}
_ARG_REDUCTIONS = {aten.argmax.default, aten.argmin.default}
#: ops that move no data (a view that aten does not mark as one); with
#: the ``prim`` namespace's metadata queries (``prim.device``), no bytes
_NO_DATA = {aten._unsafe_view.default}
#: copies: bytes, and no FLOP, as XLA counts a copy
_COPIES = {aten.clone.default, aten.copy_.default, aten.copy.default}
#: gathers of rows by an index tensor (the embedding's lookup)
_GATHERS = {aten.index.Tensor, aten.embedding.default}
#: elementwise ops DTensor has no strategy for: run on the local shards,
#: every operand of the first's shape laid out as the first
_LOCAL_ELEMENTWISE = {aten.log_sigmoid_backward.default}


def _probe_cfg(cfg, probe_groups: int):
    plan = stack_plan(cfg)
    k = len(plan[0][0])
    return dataclasses.replace(
        cfg,
        name=f"{cfg.name}-p{probe_groups}",
        n_layers=k * probe_groups,
        n_enc_layers=probe_groups if cfg.n_enc_layers else 0,
    )


# ---------------------------------------------------------------------------
# fake ranks
# ---------------------------------------------------------------------------


def fake_world(n: int) -> None:
    """This process as rank 0 of a ``fake`` process group of ``n`` ranks
    (collectives return at once, moving nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _dtensors(shapes, shardings, fake_mode):
    """A tree of DTensors of fake tensors: each leaf of ``shapes``
    (shape-only tensors) laid out by its :class:`NamedSharding`."""
    from torch.distributed import tensor as dt

    def one(like, sh):
        with fake_mode:
            return dt.empty(tuple(like.shape), dtype=like.dtype,
                            device_mesh=sh.mesh, placements=sh.placements)

    return map_tree(one, shapes, shardings)


# ---------------------------------------------------------------------------
# what rank 0 runs
# ---------------------------------------------------------------------------


def _split_groups(src, dst):
    """(input dims, output dims) groups of equal element count of a view
    from shape ``src`` to ``dst``, in order."""
    out, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        gi, gj, pi, pj = [], [], 1, 1
        if i < len(src):
            gi.append(i)
            pi *= src[i]
            i += 1
        if j < len(dst):
            gj.append(j)
            pj *= dst[j]
            j += 1
        while pi != pj:
            if pi < pj and i < len(src):
                gi.append(i)
                pi *= src[i]
                i += 1
            elif j < len(dst):
                gj.append(j)
                pj *= dst[j]
                j += 1
            else:
                break
        out.append((gi, gj))
    return out


def _fit_for_view(view, x, shape):
    """``x`` redistributed so that DTensor can ``view`` it as ``shape``: a
    sharded dim that the view splits keeps its shards only when its first
    output dim divides by the dim's shard count; otherwise it is
    replicated on those mesh dims (GSPMD reshards there by itself).  A
    sharded dim merged behind another (batch and heads into one batch of
    products) keeps its shards where this torch's DTensor can view it so
    (torch 2.13 can, as a strided shard; torch 2.11 cannot, and there it
    is replicated: attention's products then run whole on every rank of
    the model axis)."""
    from torch.distributed.tensor import Replicate, Shard

    shape = list(shape)
    if -1 in shape:
        k = shape.index(-1)
        shape[k] = math.prod(x.shape) // math.prod(
            s for s in shape if s != -1)
    groups = _split_groups(list(x.shape), shape)
    sizes = x.device_mesh.shape
    by_dim = {}
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            by_dim.setdefault(p.dim, []).append(i)
    want, merged_behind = list(x.placements), []
    for d, mesh_dims in by_dim.items():
        m = math.prod(sizes[i] for i in mesh_dims)
        gi, gj = next(g for g in groups if d in g[0])
        gj = [j for j in gj if shape[j] != 1] or gj  # a size-1 dim moves
        if len(gj) > 1 and (d != gi[0] or shape[gj[0]] % m):
            for i in mesh_dims:
                want[i] = Replicate()
        elif d != gi[0]:
            merged_behind += mesh_dims
    if merged_behind and want == list(x.placements):
        try:
            view(x, shape)
        except RuntimeError:  # this DTensor refuses the strided merge
            for i in merged_behind:
                want[i] = Replicate()
    if want == list(x.placements):
        return x
    return _relaid(x, want)


def _relaid(x, placements):
    """``x`` redistributed to ``placements`` inside an op (below autograd,
    which differentiates the op itself): a parameter is detached first,
    as torch 2.11's DTensor cannot redistribute one that requires grad
    while grad mode is off (the backward pass)."""
    if x.requires_grad:
        x = x.detach()
    return x.redistribute(x.device_mesh, placements)


def _reduced(x):
    """``x`` with every pending sum (``Partial``) reduced: GSPMD reduces a
    product's operand first, where DTensor, whose costs count bytes moved
    and not work done, may rather gather the other operand and do the
    whole product on every rank of the axis."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return _relaid(x, [Replicate() if p.is_partial() else p
                       for p in x.placements])


def _pointwise_reduced(args):
    """A pointwise op's pending sums reduced first (each once), unless
    every operand is a pending sum over the same mesh dims at the
    output's size (a sum of sums stays pending).  Otherwise DTensor
    would carry a broadcast sum at the output's size, reduce a sum the
    op reads twice (``x * x``) once a read, turn a sharded operand into
    a pending sum, a whole-size tensor on every rank (which torch 2.11's
    cannot do, and fails), or, torch 2.13's, keep a sum pending past its
    sum with a whole operand where 2.11's reduces it: this gives both
    versions one plan."""
    from torch.distributed.tensor import DTensor

    ts = [a for a in args if isinstance(a, torch.Tensor)]
    pending = [a for a in ts if isinstance(a, DTensor)
               and any(p.is_partial() for p in a.placements)]
    if not pending:
        return args
    n = math.prod(torch.broadcast_shapes(*(t.shape for t in ts)))

    def dims(t):
        return {i for i, p in enumerate(t.placements) if p.is_partial()} \
            if isinstance(t, DTensor) else set()

    if (len({id(t) for t in ts}) == len(ts) and all(
            t.numel() == n and dims(t) == dims(pending[0]) for t in ts)):
        return args
    done = {}
    for a in pending:
        if id(a) not in done:
            done[id(a)] = _reduced(a)
    return tuple(done.get(id(a), a) for a in args)


def _gathered(x, dim):
    """``x`` whole along ``dim`` (all of it for ``dim`` None): DTensor's
    sharded argmax regroups its shards by a view that breaks when
    another mesh dim is replicated (a batch of 1)."""
    from torch.distributed.tensor import Replicate

    d = None if dim is None else dim % x.dim()
    want = [Replicate() if getattr(p, "dim", None) is not None
            and (d is None or p.dim == d) else p for p in x.placements]
    if want == list(x.placements):
        return x
    return _relaid(x, want)


def _argmax_on_shards(x, dim):
    """``argmax`` over a dim that lies in even shards across ranks: each
    rank's max and its first index there, then a max of the values and,
    among the ranks that hold it, the least global index (two all-reduces
    of the output's size), as GSPMD partitions the reference's.  None
    where the dim is not sharded or its shards are uneven."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import (all_reduce, from_local,
                                                  mesh_coordinate)

    if dim is None:
        return None
    d = dim % x.dim()
    mesh = x.device_mesh
    over = [i for i, p in enumerate(x.placements)
            if p.is_shard() and p.dim == d]
    if (not over or any(p.is_partial() for p in x.placements)
            or x.shape[d] % math.prod(mesh.shape[i] for i in over)):
        return None
    xl = x.to_local()
    v, idx = torch.max(xl, dim=d)
    idx = idx + mesh_coordinate(mesh, over) * xl.shape[d]
    top = all_reduce(v, mesh, over, "max")
    neg = torch.where(v == top, -idx, torch.full_like(idx, -x.shape[d]))
    out = -all_reduce(neg, mesh, over, "max")
    placements = [Replicate() if i in over or not p.is_shard()
                  else Shard(p.dim - (p.dim > d))
                  for i, p in enumerate(x.placements)]
    shape = [n for i, n in enumerate(x.shape) if i != d]
    return from_local(out, mesh, placements, shape)


def _flip_on_shards(x, dims):
    """``flip`` of dims that lie whole on every rank, on the local shards
    (torch 2.11's DTensor has no strategy for it; the mLSTM's plain
    backward flips each chunk's positions).  None where a flipped dim is
    sharded or ``x`` holds a pending sum."""
    from torch.distributed.tensor import DTensor

    dims = [d % x.dim() for d in dims]
    if any(p.is_partial() or getattr(p, "dim", None) in dims
           for p in x.placements):
        return None
    return DTensor.from_local(torch.flip(x._local_tensor, dims),
                              x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def _index_accumulate(func, args, kwargs):
    """``index_put(self, indices, values, accumulate=True)`` on the local
    shards when ``self`` is replicated and the indices are laid out
    alike.  Per mesh dim: values sharded on a trailing dim keep it (the
    indices are gathered there; ``self`` is sharded alike); otherwise
    the values are laid out as the indices on the indexed dims, and the
    result is a pending sum where those are sharded.  It is the
    embedding's backward (a zero ``self``, so each rank's copy of it adds
    nothing); torch 2.11's DTensor fails to shard it.  None where
    ``self`` or the indices do not fit."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    self_, indices, values = args[0], args[1], args[2]
    accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
    if not (accumulate and isinstance(self_, DTensor)
            and all(p.is_replicate() for p in self_.placements)
            and isinstance(values, DTensor)
            and all(isinstance(i, DTensor) for i in indices)
            and all(i.placements == indices[0].placements for i in indices)):
        return None
    n_idx = indices[0].dim()  # the values' leading dims are the index's
    p_idx_want, p_val_want, out = [], [], []
    for p_idx, p_val in zip(indices[0].placements, values.placements):
        if getattr(p_val, "dim", -1) >= n_idx:      # a trailing dim
            p_idx_want.append(Replicate())
            p_val_want.append(p_val)
            out.append(Shard(p_val.dim - n_idx + len(indices)))
        elif p_idx.is_shard() or p_val.is_shard():  # an indexed dim
            dim = p_idx if p_idx.is_shard() else p_val
            p_idx_want.append(dim)
            p_val_want.append(dim)
            out.append(Partial())
        else:                                       # replicated indices
            p_idx_want.append(p_idx)
            p_val_want.append(p_val)
            out.append(p_val)
    mesh = self_.device_mesh
    indices = [i if list(i.placements) == p_idx_want
               else i.redistribute(mesh, p_idx_want) for i in indices]
    if list(values.placements) != p_val_want:
        values = values.redistribute(mesh, p_val_want)
    # self's own shard where the result is sharded (a slice, no traffic)
    base = self_.redistribute(mesh, [o if o.is_shard() else Replicate()
                                     for o in out])._local_tensor
    local = func(base, [i._local_tensor for i in indices],
                 values._local_tensor, True)
    return DTensor.from_local(local, mesh, out, run_check=False,
                              shape=self_.shape, stride=self_.stride())


#: products whose two matrices are args 0, 1 (mm, bmm) or 1, 2
_MATRICES = {aten.mm.default: (0, 1), aten.bmm.default: (0, 1),
             aten.addmm.default: (1, 2), aten.baddbmm.default: (1, 2)}


def _paired(a, b, batched: bool) -> bool:
    """Whether the matrices' shards on one mesh dim pair up: the
    contraction on both, or (``bmm``) the batch on both."""
    k = 2 if batched else 1
    return (a.dim, b.dim) in ((k, k - 1),) + (((0, 0),) if batched else ())


def _fsdp_gathered(func, args):
    """A product's args with, on every mesh dim where both matrices are
    sharded along dims that do not pair (an activation's rows and an
    FSDP weight's contraction), the one whose gathered shard is the
    smaller whole on that dim, as GSPMD resolves such a clash: a training
    step's weight (its other dims still sharded), a decode step's few
    tokens.  DTensor may rather reshard the larger one."""
    from torch.distributed.tensor import DTensor, Replicate

    i, j = _MATRICES[func]
    a, b = args[i], args[j]
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)
            and a.device_mesh == b.device_mesh) or 0 in b.stride():
        # (a weight broadcast over a batch of products is left to DTensor:
        # gathering the broadcast view would move a copy per product)
        return args
    batched = a.dim() == 3
    clash = [d for d, (pa, pb) in enumerate(zip(a.placements, b.placements))
             if pa.is_shard() and pb.is_shard()
             and not _paired(pa, pb, batched)]
    if not clash:
        return args

    small = i if (gathered_numel(a, a.placements, clash)
                  < gathered_numel(b, b.placements, clash)) else j
    want = [Replicate() if d in clash else p
            for d, p in enumerate(args[small].placements)]
    args = list(args)
    args[small] = _relaid(args[small], want)
    return tuple(args)


def _split_over_idle_ranks(args):
    """A product ``mm(a, b)`` whose contraction is sharded on one mesh
    dim (its output a pending sum there: a weight's gradient, a decode
    step's product with an FSDP weight) while both matrices are whole on
    another, with ``a``'s rows split over that other dim's ranks where
    they divide: GSPMD spreads such a product over the ranks that would
    each do all of it."""
    from torch.distributed.tensor import DTensor, Shard

    a, b = args
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)
            and a.device_mesh == b.device_mesh):
        return args
    pairs = list(zip(a.placements, b.placements))
    if not any((pa.is_shard() and pa.dim == 1 or pa.is_replicate())
               and pb.is_shard() and pb.dim == 0
               or pa.is_shard() and pa.dim == 1 and pb.is_replicate()
               for pa, pb in pairs):
        return args
    mesh, want = a.device_mesh, list(a.placements)
    rows = a.shape[0]
    for d, (pa, pb) in enumerate(pairs):
        if (pa.is_replicate() and pb.is_replicate()
                and rows % mesh.shape[d] == 0):
            want[d] = Shard(0)
            rows //= mesh.shape[d]
    if want == list(a.placements):
        return args
    return _relaid(a, want), b


def _lookup_on_shards(table, indices):
    """``table[idx]`` (``aten.index`` of a 2-D table by one index tensor:
    the embedding) on each rank's shards, as GSPMD partitions the
    reference's.  Where the table's columns lie in fsdp shards, either
    they are gathered and each rank looks up its own tokens (the index's
    layout), or, for fewer tokens than the table has rows (a decode
    step), the tokens are gathered and each rank looks all of them up in
    its columns; over the vocab's ranks each looks up in its rows, the
    others' masked to zero, and the output is a pending sum there.  None
    where the index is not one DTensor or is sharded over the vocab's
    ranks."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import from_local, mesh_coordinate

    if not (len(indices) == 1 and isinstance(indices[0], DTensor)
            and table.dim() == 2):
        return None
    (idx,) = indices
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements)
             if p.is_shard() and p.dim == 0]
    cols = [i for i, p in enumerate(table.placements)
            if p.is_shard() and p.dim == 1]
    if any(p.is_partial() for p in table.placements) or any(
            idx.placements[i].is_shard() for i in vocab):
        return None
    few = idx.numel() < table.shape[0]
    keep = vocab + (cols if few else [])
    want = [p if i in keep else Replicate()
            for i, p in enumerate(table.placements)]
    if list(table.placements) != want:
        table = _relaid(table, want)
    if few and any(idx.placements[i].is_shard() for i in cols):
        idx = _relaid(idx, [Replicate() if i in cols else p
                            for i, p in enumerate(idx.placements)])
    tl, il = table.to_local(), idx.to_local()
    if vocab:
        n = tl.shape[0]
        il = il - mesh_coordinate(mesh, vocab) * n
        mine = (il >= 0) & (il < n)
        out = tl[torch.clamp(il, 0, n - 1)] * mine[..., None].to(tl.dtype)
    else:
        out = tl[il]
    placements = [Partial() if i in vocab else
                  Shard(idx.dim()) if i in cols and few else
                  (idx.placements[i] if idx.placements[i].is_shard()
                   else Replicate()) for i in range(mesh.ndim)]
    return from_local(out, mesh, placements,
                      tuple(idx.shape) + (table.shape[1],))


def _logsumexp_on_shards(x, dims, keepdim):
    """``logsumexp`` over dims that lie in shards across ranks: a max and
    a sum over the ranks, as GSPMD partitions the reference's (DTensor
    would gather the whole input first).  None where no reduced dim is
    sharded."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import all_reduce, from_local

    dims = sorted(d % x.dim() for d in dims)
    mesh = x.device_mesh
    over = [i for i, p in enumerate(x.placements)
            if p.is_shard() and p.dim in dims]
    if not over or any(p.is_partial() for p in x.placements):
        return None
    xl = x.to_local()
    m = all_reduce(torch.amax(xl, dims, keepdim=True), mesh, over, "max")
    s = all_reduce(torch.sum(torch.exp(xl - m), dims, keepdim=True), mesh,
                   over)
    out = torch.log(s) + m
    placements, shape = [], list(x.shape)
    for d in dims:
        shape[d] = 1
    for i, p in enumerate(x.placements):
        if i in over or not p.is_shard():
            placements.append(Replicate())
        else:
            placements.append(Shard(p.dim if keepdim else
                                    p.dim - sum(d < p.dim for d in dims)))
    if not keepdim:
        out = out.squeeze(dims)
        shape = [n for d, n in enumerate(shape) if d not in dims]
    return from_local(out, mesh, placements, shape)


def _strided(placements) -> bool:
    """Whether a placement is a strided shard (a dim merged behind a
    sharded one: batch and sequence into a product's rows)."""
    return any(type(p).__name__ == "_StridedShard" for p in placements)


def _as_dim(p, dim):
    """Placement ``p`` (a shard, plain or strided) moved to tensor dim
    ``dim``."""
    from torch.distributed.tensor import Shard

    if _strided([p]):
        return type(p)(dim, split_factor=p.split_factor)
    return Shard(dim)


def _strided_product(a, b):
    """``mm(a, b)`` on each rank's shards where a matrix lies in strided
    shards (a batch and a sequence merged: a product's rows or, in a
    weight's gradient, its contraction).  Per mesh dim: where ``a``'s
    rows and ``b``'s columns are both sharded, ``a`` is gathered (the
    sequence gathered before a column-parallel product, as GSPMD does
    under sequence parallelism); where ``b``'s rows are sharded against
    ``a``'s rows, ``b`` (the weight) is gathered; where one matrix alone
    has its contraction sharded, the other, whole there, takes that
    layout (a slice), or else is gathered with it; a contraction sharded
    alike on both leaves the output a pending sum.  DTensor reaches such
    plans through a search of redistribution paths that takes ~0.5 s a
    strategy on the two-pod mesh.  None where a matrix holds a pending
    sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not (isinstance(a, DTensor) and isinstance(b, DTensor)
            and a.device_mesh == b.device_mesh
            and (_strided(a.placements) or _strided(b.placements))
            and not any(p.is_partial()
                        for p in a.placements + b.placements)):
        return None

    def dim(p):
        return getattr(p, "dim", None)

    wa, wb = list(a.placements), list(b.placements)
    for d in range(len(wa)):
        if dim(wa[d]) == 0 and dim(wb[d]) == 1:
            wa[d] = Replicate()
        elif dim(wa[d]) == 0 and dim(wb[d]) == 0:
            wb[d] = Replicate()
        elif dim(wa[d]) == 1 and dim(wb[d]) == 0 and wa[d] != _as_dim(
                wb[d], 1):
            wb[d] = Replicate()
        if dim(wa[d]) == 1 and dim(wb[d]) != 0:
            if wb[d].is_replicate():
                wb[d] = _as_dim(wa[d], 0)
            else:
                wa[d] = Replicate()
        elif dim(wb[d]) == 0 and dim(wa[d]) != 1:
            if wa[d].is_replicate():
                wa[d] = _as_dim(wb[d], 1)
            else:
                wb[d] = Replicate()
    out = []
    for pa, pb in zip(wa, wb):
        if dim(pa) == 1 and dim(pb) == 0:
            out.append(Partial())
        elif dim(pa) == 0 and pb.is_replicate():
            out.append(pa)
        elif pa.is_replicate() and dim(pb) == 1:
            out.append(pb)
        elif pa.is_replicate() and pb.is_replicate():
            out.append(Replicate())
        else:
            return None
    if wa != list(a.placements):
        a = _relaid(a, wa)
    if wb != list(b.placements):
        b = _relaid(b, wb)
    local = torch.mm(a._local_tensor, b._local_tensor)
    n, m = a.shape[0], b.shape[1]
    return DTensor.from_local(local, a.device_mesh, out, run_check=False,
                              shape=torch.Size((n, m)), stride=(m, 1))


def _batch_only(placements) -> bool:
    """Every placement replicated or sharding dim 0 (plainly or strided)."""
    return all(p.is_replicate() or getattr(p, "dim", None) == 0
               for p in placements)


class _GspmdLike(TorchDispatchMode):
    """Partitions as GSPMD would where DTensor's choice differs.  Gives
    DTensor's views the input layouts they accept (:func:`_fit_for_view`),
    forward and backward alike; reduces a product's pending sums first,
    and a pointwise op's but where it adds sums (:func:`_pointwise_reduced`);
    settles a product's clash of layouts by gathering the matrix whose
    gathered shard is the smaller (:func:`_fsdp_gathered`: an LM head's
    weight, still sharded on the vocab, against a batch of activations)
    and spreads a weight's gradient over ranks that would each compute
    all of it (:func:`_split_over_idle_ranks`); looks the embedding up and
    takes ``logsumexp`` and ``argmax`` on each rank's shards
    (:func:`_lookup_on_shards`, :func:`_logsumexp_on_shards`,
    :func:`_argmax_on_shards`: a max and the least index of it, where
    DTensor would gather a decode step's logits); gathers another arg
    reduction's input (:func:`_gathered`), and runs the elementwise ops
    DTensor lacks, a ``flip`` of whole dims (:func:`_flip_on_shards`) and
    the embedding's backward (:func:`_index_accumulate`), on the local
    shards.  A ``bmm`` of
    two operands laid out alike on their batch dim alone (which attention
    meets where batch and heads, sharded on two mesh dims, merge into
    one strided dim) runs on the local shards at once: the product is
    batch-parallel, and DTensor's own strategy search over strided
    layouts takes ~0.1 s a call.  An ``mm`` of a matrix in strided shards
    (batch and sequence merged under sequence parallelism, or cross
    attention's queries split) is planned as GSPMD plans it and run on
    the local shards (:func:`_strided_product`): DTensor's search takes
    ~0.5 s a strategy there on the two-pod mesh.
    """

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if func in _VIEWS and isinstance(args[0], DTensor):
            args = (_fit_for_view(func, args[0], args[1]),) + tuple(args[1:])
        if func in _PRODUCTS:
            args = _fsdp_gathered(func, tuple(_reduced(a) for a in args))
            if func is aten.mm.default:
                args = _split_over_idle_ranks(args)
        elif torch.Tag.pointwise in func.tags:
            args = _pointwise_reduced(args)
        if func in _ARG_REDUCTIONS and isinstance(args[0], DTensor):
            dim = args[1] if len(args) > 1 else kwargs.get("dim")
            keepdim = args[2] if len(args) > 2 else kwargs.get("keepdim")
            if func is aten.argmax.default and not keepdim:
                out = _argmax_on_shards(args[0], dim)
                if out is not None:
                    return out
            args = (_gathered(args[0], dim),) + tuple(args[1:])
        if func in _LOCAL_ELEMENTWISE:
            first = _reduced(args[0])
            args = [a if not isinstance(a, DTensor) or a.shape != first.shape
                    else _relaid(a, first.placements)
                    for a in (first,) + tuple(args[1:])]
            local = func(*[a._local_tensor if isinstance(a, DTensor) else a
                           for a in args], **kwargs)
            return DTensor.from_local(local, first.device_mesh,
                                      first.placements, run_check=False,
                                      shape=first.shape,
                                      stride=first.stride())
        if func is aten.flip.default and isinstance(args[0], DTensor):
            out = _flip_on_shards(args[0], args[1])
            if out is not None:
                return out
        if func is aten.index_put.default:
            out = _index_accumulate(func, args, kwargs)
            if out is not None:
                return out
        if func is aten.index.Tensor and isinstance(args[0], DTensor):
            out = _lookup_on_shards(args[0], args[1])
            if out is not None:
                return out
        if func is aten.logsumexp.default and isinstance(args[0], DTensor):
            out = _logsumexp_on_shards(
                args[0], args[1], args[2] if len(args) > 2
                else kwargs.get("keepdim", False))
            if out is not None:
                return out
        if func is aten.mm.default and not kwargs:
            out = _strided_product(*args)
            if out is not None:
                return out
        if (func is aten.bmm.default and not kwargs
                and all(isinstance(a, DTensor) for a in args)):
            a, b = args
            if (a.device_mesh == b.device_mesh
                    and a.placements == b.placements
                    and _batch_only(a.placements)):
                local = torch.bmm(a._local_tensor, b._local_tensor)
                n, m, k = a.shape[0], a.shape[1], b.shape[2]
                return DTensor.from_local(local, a.device_mesh,
                                          a.placements, run_check=False,
                                          shape=torch.Size((n, m, k)),
                                          stride=(m * k, k, 1))
        return func(*args, **kwargs)


class _LocalCost(TorchDispatchMode):
    """Counts what rank 0 runs: every DTensor-level op is left to DTensor
    (``NotImplemented``), whose local ops on rank 0's shards come back
    through this mode and are counted — FLOPs, bytes, collectives — and
    whose outputs' storages are held to a live-bytes peak (see
    :meth:`_ours` for what is left out)."""

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.events = []
        self.live = 0
        self.peak = 0
        self._held = {}

    def hold(self, t) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def gone(_ref, key=key, n=n):
            self.live -= n
            self._held.pop(key, None)

        self._held[key] = weakref.ref(st, gone)

    def _ours(self, tensors) -> bool:
        """Whether an op touches the step's tensors (fake tensors of this
        run's mode) and no others: DTensor's shape propagation runs on
        fake tensors of its own mode, its mesh bookkeeping on small real
        ones."""
        from torch._subclasses.fake_tensor import FakeTensor

        fakes = [t for t in tensors if isinstance(t, FakeTensor)]
        return bool(fakes) and all(t.fake_mode is self.fake_mode
                                   for t in fakes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        if not self._ours(ins + outs):
            return out
        ev = collective_event(func, args, out)
        if ev is not None:
            self.events.append(ev)
        packet = func._overloadpacket
        if ev is None and getattr(func, "namespace", None) != "_c10d_functional":
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            elif torch.Tag.pointwise in func.tags and func not in _COPIES:
                n = sum(o.numel() for o in outs)
                if packet in _TRANSCENDENTAL:
                    self.transcendentals += n
                else:
                    self.flops += n
            if func in _GATHERS:
                # as XLA counts a gather: a copy of the output's size and
                # a read of the indices, not the whole table
                self.bytes += sum(2 * o.numel() * o.element_size()
                                  for o in outs) + sum(
                    t.numel() * t.element_size() for t in ins[1:])
            elif not (func.is_view or func in _NO_DATA
                      or func.namespace == "prim"):
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in ins + outs)
        if not func.is_view:
            for o in outs:
                self.hold(o)
        return out


class _OneStep:
    """The dry-run's :data:`repro_torch.models.recurrent.TIME_LOOP`: a time
    loop runs its first two steps, which :class:`_LocalCost` counts, and
    the second step's count is added ``steps - 2`` times more — FLOPs,
    transcendentals, bytes and collectives.  From the second step on every
    step runs the same ops on the same shapes and layouts (the first may
    also lay out the loop's initial states), so the count is the whole
    loop's; the peak of live bytes is a step's on top of what the loop
    keeps (its buffers of the whole sequence are allocated before it).
    ``loops`` holds each loop run's step count and one step's figures
    (the second's)."""

    def __init__(self, cost: "_LocalCost"):
        self.cost = cost
        self.loops = []

    def __call__(self, steps: int, body) -> None:
        c = self.cost
        for i in range(min(steps, 2)):
            f0, b0, t0 = c.flops, c.bytes, c.transcendentals
            e0 = len(c.events)
            body(i)
        events = c.events[e0:]
        step = {"flops": c.flops - f0, "bytes_accessed": c.bytes - b0,
                "transcendentals": c.transcendentals - t0}
        more = max(steps - 2, 0)
        c.flops += more * step["flops"]
        c.bytes += more * step["bytes_accessed"]
        c.transcendentals += more * step["transcendentals"]
        c.events += events * more
        coll = collective_stats(events)
        self.loops.append(dict(step, steps=steps,
                               collective_bytes=coll.total_algorithm_bytes,
                               by_op=coll.by_op))


def _local_bytes(tree) -> dict:
    """{storage id: bytes} of the local shards of a tree's DTensors."""
    from torch.distributed.tensor import DTensor

    out = {}
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            loc = t._local_tensor if isinstance(t, DTensor) else t
            st = loc.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def _cell_step(model, arch_id, shape, probe, batch_shards):
    """(the cell's step, its microbatches or None): AdamW training,
    prefill, or the serve step that donates its caches."""
    if shape.kind == "train":
        k_micro = 1 if probe else MICROBATCHES.get(
            arch_id, DEFAULT_MICROBATCHES)
        # cap: per-microbatch batch must stay shardable over the
        # full DP extent (pod×data), else activations replicate
        k_micro = max(1, min(k_micro, shape.global_batch // batch_shards))
        return build_train_step(model, remat=True, probe=probe,
                                microbatches=k_micro), k_micro
    if shape.kind == "prefill":
        return build_prefill_step(model, shape.seq_len), None
    return build_serve_step(model), None


def count_world1(arch_id: str, shape_name: str,
                 probe_groups: int = 1) -> dict:
    """The cell's step on one device: the same step and the same
    :class:`_LocalCost`, on fake tensors of the global shapes with no
    mesh (every ``shard`` returns its input).  ``{"flops",
    "transcendentals", "bytes_accessed"}`` of the whole step: where the
    dry-run counts every op a rank runs, its per-device count times the
    ranks reaches this."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.sharding import (SINGLE_POD_RULES,
                                                  AxisRules)

    cfg = get_config(arch_id)
    shape = SHAPES[shape_name]
    if probe_groups:
        cfg = _probe_cfg(cfg, probe_groups)
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)

    def fake(t):
        with fake_mode:
            return torch.empty(tuple(t.shape), dtype=t.dtype)

    with use_rules(AxisRules(dict(SINGLE_POD_RULES), mesh=None)):
        model = build_model(cfg)
        inputs = [map_tree(fake, spec) for spec in input_specs(cfg, shape)]
        step, _ = _cell_step(model, arch_id, shape, probe_groups > 0, 1)
        cost = _LocalCost(fake_mode)
        recurrent.TIME_LOOP = _OneStep(cost)
        try:
            with cost:
                step(*inputs)
        finally:
            recurrent.TIME_LOOP = None
    return {"flops": float(cost.flops),
            "transcendentals": float(cost.transcendentals),
            "bytes_accessed": float(cost.bytes)}


def lower_cell(arch_id: str, shape_name: str, multi_pod: bool,
               probe_groups: int = 0, rules_overrides=None) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = get_config(arch_id)
    shape = SHAPES[shape_name]
    probe = probe_groups > 0
    eff_groups = sum(G for _, G in stack_plan(cfg))  # extrapolation count
    if probe:
        cfg = _probe_cfg(cfg, probe_groups)
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    rules = rules_for_mesh(mesh, overrides=rules_overrides)
    n_dev = mesh.size()

    rec = {
        "arch": arch_id, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "n_devices": n_dev, "probe": probe_groups,
        "eff_groups": eff_groups,
    }
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    t0 = time.time()
    with use_rules(rules):
        model = build_model(cfg)
        specs = input_specs(cfg, shape)
        shardings = input_shardings(cfg, shape, rules)
        inputs = [_dtensors(s, sh, fake_mode)
                  for s, sh in zip(specs, shardings)]

        step, k_micro = _cell_step(
            model, arch_id, shape, probe,
            rules.mesh_size(rules.axes_for("batch")))
        if k_micro is not None:
            rec["microbatches"] = k_micro
        rec["lower_s"] = round(time.time() - t0, 2)

        cost = _LocalCost(fake_mode)
        args_bytes = _local_bytes(inputs)
        for n in args_bytes.values():
            cost.live += n
        cost.peak = cost.live
        one_step = _OneStep(cost)
        t1 = time.time()
        recurrent.TIME_LOOP = one_step
        try:
            with implicit_replication(), cost, _GspmdLike():
                out = step(*inputs)
        finally:
            recurrent.TIME_LOOP = None
        rec["compile_s"] = round(time.time() - t1, 2)

    out_bytes = _local_bytes(out)
    alias = sum(n for k, n in out_bytes.items() if k in args_bytes)
    arg_total = sum(args_bytes.values())
    rec["memory"] = {
        "argument_size_in_bytes": arg_total,
        "output_size_in_bytes": sum(out_bytes.values()),
        "temp_size_in_bytes": cost.peak - arg_total,
        "generated_code_size_in_bytes": 0,
        "alias_size_in_bytes": alias,
        # the eager peak of live local bytes, the inputs included
        "per_device_total": cost.peak,
    }
    rec["cost"] = {
        "flops": float(cost.flops),
        "bytes_accessed": float(cost.bytes),
        "transcendentals": float(cost.transcendentals),
    }
    coll = collective_stats(cost.events)
    rec["collectives"] = {
        "algorithm_bytes": coll.total_algorithm_bytes,
        "by_op": coll.by_op,
        "counts": coll.counts,
        "n_while_loops": coll.n_while_loops,
    }
    rec["collective_schedule"] = coll.schedule[:200]
    rec["loops"] = one_step.loops
    rec["dropped_shardings"] = [
        f"{l}:{d}:{a}" for (l, d, a) in rules.dropped
    ][:40]
    # analytic model flops (full model, not the probe's truncated stack)
    full_model = build_model(get_config(arch_id))
    rec["model_flops"] = full_model.model_flops(shape)
    rec["recurrent_correction_flops"] = \
        full_model.recurrent_correction_flops(shape)
    pc = full_model.param_counts()
    rec["params_total"] = pc["total"]
    rec["params_active"] = pc["active"]
    del out, inputs
    return rec


# ---------------------------------------------------------------------------
# the reference's one-group records
# ---------------------------------------------------------------------------

#: the JAX package's ``--probe 1 --mesh single`` records of the cells the
#: port is held to (``tests/make_dryrun_reference.py`` writes it)
REFERENCE = Path(__file__).with_name("dryrun_reference.json")

#: the most a port record may read, as a multiple of the reference's; one-
#: sided (a port that does less a device than GSPMD is not at fault, and
#: the dry-run's completeness is checked on its own).  ``bytes_accessed``
#: is held in decode cells only: XLA counts a fusion's operands and
#: outputs, the port every eager op.
BOUNDS = {"flops": 1.25, "collective_bytes": 2.0, "per_device_total": 1.5,
          "bytes_accessed": 2.0}


def reference_records(path: Path = REFERENCE) -> dict:
    """{cell name: the reference's record fields} (:func:`cell_name`)."""
    return json.loads(Path(path).read_text())["cells"]


def loop_body_once(port_rec: dict, ref_rec: dict) -> dict:
    """The port's FLOPs, collective bytes and bytes accessed as the
    reference's record counts them: where the reference's step holds while
    loops (``n_while_loops`` > 0: the sLSTM's scan over time, forward and
    in training backward), XLA's cost analysis and the collective parser
    count each loop's body once, so each of the port's loops
    (``port_rec["loops"]``) is taken out but for one step; otherwise the
    complete count."""
    flops = port_rec["cost"]["flops"]
    coll = port_rec["collectives"]["algorithm_bytes"]
    nbytes = port_rec["cost"]["bytes_accessed"]
    if ref_rec["collectives"]["n_while_loops"] > 0:
        for loop in port_rec.get("loops", []):
            k = loop["steps"] - 1
            flops -= k * loop["flops"]
            coll -= k * loop["collective_bytes"]
            nbytes -= k * loop["bytes_accessed"]
    return {"flops": flops, "collective_bytes": coll,
            "bytes_accessed": nbytes}


def ratios(port_rec: dict, ref_rec: dict) -> dict:
    """The port's figures over the reference's, for each bound: FLOPs,
    collective bytes and bytes accessed counted as the reference's
    (:func:`loop_body_once`), memory the eager peak against XLA's."""
    port = loop_body_once(port_rec, ref_rec)
    return {
        "flops": port["flops"] / ref_rec["cost"]["flops"],
        "collective_bytes": (port["collective_bytes"]
                             / ref_rec["collectives"]["algorithm_bytes"]),
        "per_device_total": (port_rec["memory"]["per_device_total"]
                             / ref_rec["memory"]["per_device_total"]),
        "bytes_accessed": (port["bytes_accessed"]
                           / ref_rec["cost"]["bytes_accessed"]),
    }


def returned_cache_bytes(port_rec: dict) -> int:
    """The local bytes of the caches a decode step returns: its outputs
    but the next token, (B,) int32 sharded over the batch's ranks (every
    rank but the 16 of the model axis), or whole where they do not
    divide B."""
    batch_ranks = port_rec["n_devices"] // 16
    B = SHAPES[port_rec["shape"]].global_batch
    token = 4 * (B // batch_ranks if B % batch_ranks == 0 else B)
    return port_rec["memory"]["output_size_in_bytes"] - token


def against_reference(port_rec: dict, ref_rec: dict) -> list:
    """The bounds a port record misses against the reference's record of
    the same cell (:data:`BOUNDS`); in a decode cell also the caches not
    written in place (the step's aliased bytes must be every returned
    cache's, as the reference's donated caches)."""
    r = ratios(port_rec, ref_rec)
    held = ["flops", "collective_bytes", "per_device_total"]
    decode = SHAPES[port_rec["shape"]].kind == "decode"
    if decode:
        held.append("bytes_accessed")
    misses = [f"{k} {r[k]:.4g}x the reference's > {BOUNDS[k]}x"
              for k in held if not r[k] <= BOUNDS[k]]
    if decode:
        alias = port_rec["memory"]["alias_size_in_bytes"]
        caches = returned_cache_bytes(port_rec)
        if alias != caches:
            misses.append(f"alias_size_in_bytes {alias} != the returned "
                          f"caches' {caches} B")
    return misses


def reference_line(port_rec: dict, ref_rec: dict) -> str:
    """One line: the cell, the four ratios, the misses and the torch."""
    r = ratios(port_rec, ref_rec)
    misses = against_reference(port_rec, ref_rec)
    name = cell_name(port_rec["arch"], port_rec["shape"],
                     port_rec["mesh"] == "multi", port_rec["probe"])
    return (f"[ref ] {name}: " + " ".join(f"{k} {v:.4g}x" for k, v in
                                         r.items())
            + f" torch {torch.__version__} "
            + ("within bounds" if not misses else "MISS " + "; ".join(misses)))


def cell_name(arch, shape, multi, probe):
    s = f"{arch}__{shape}__{'multi' if multi else 'single'}"
    if probe:
        s += f"__p{probe}"
    return s


def run_one(arch, shape, multi, probe, out_dir: Path, skip_existing=True,
            rules_overrides=None) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    name = cell_name(arch, shape, multi, probe)
    path = out_dir / (name + ".json")
    if skip_existing and path.exists():
        rec = json.loads(path.read_text())
        if "error" not in rec:
            print(f"[skip] {name}")
            return rec
    print(f"[run ] {name} ...", flush=True)
    try:
        rec = lower_cell(arch, shape, multi, probe,
                         rules_overrides=rules_overrides)
        status = (
            f"ok lower={rec['lower_s']}s run={rec['compile_s']}s "
            f"mem/dev={rec['memory']['per_device_total']/2**30:.2f}GiB "
            f"flops/dev={rec['cost']['flops']:.3e}"
        )
    except Exception as e:  # record failure, keep sweeping
        rec = {"arch": arch, "shape": shape,
               "mesh": "multi" if multi else "single", "probe": probe,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        status = f"FAIL {type(e).__name__}: {str(e)[:200]}"
    path.write_text(json.dumps(rec, indent=1))
    print(f"[done] {name}: {status}", flush=True)
    ref = reference_records().get(name)
    if ref is not None and "error" not in rec:
        print(reference_line(rec, ref), flush=True)
    return rec


def _parse_name(name: str):
    """(arch, shape, multi, probe) of a record's :func:`cell_name`."""
    arch, shape, mesh = name.split("__")[:3]
    probe = next((int(p[1:]) for p in name.split("__")[3:]
                  if p.startswith("p")), 0)
    return arch, shape, mesh == "multi", probe


def run_cells(names, out_dir: Path, jobs: int = 1, timeout=None,
              module: str = "repro_torch.launch.dryrun", env=None):
    """The dry-run CLI ``module`` (this one, or another taking its flags)
    on each cell name of ``names``, on the mesh and probe the name gives:
    one subprocess a cell, ``jobs`` at a time, each cell's output printed
    as it ends.  Returns ({name: record}, {name: output}).  A record left
    in ``out_dir`` by an earlier run is removed before its cell starts; a
    cell whose process exits with another code than 0, or has not ended
    ``timeout`` seconds after the first cell started, gets ``{"error":
    ..., "exit": its code or None}``.  No process outlives the call."""
    import subprocess
    import sys

    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, **(env or {})}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parents[2])]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    records, outputs = {}, {}
    todo, running = list(names), []
    t0 = time.monotonic()
    try:
        while todo or running:
            while todo and len(running) < jobs:
                name = todo.pop(0)
                arch, shape, multi, probe = _parse_name(name)
                (out_dir / f"{name}.json").unlink(missing_ok=True)
                log = open(out_dir / f"{name}.log", "w")
                running.append((name, log, subprocess.Popen(
                    [sys.executable, "-m", module, "--arch", arch,
                     "--shape", shape, "--mesh",
                     "multi" if multi else "single", "--probe", str(probe),
                     "--out", str(out_dir), "--no-skip-existing"],
                    env=env, stdout=log, stderr=subprocess.STDOUT)))
            late = timeout is not None and time.monotonic() - t0 > timeout
            done = [r for r in running if late or r[2].poll() is not None]
            if not done:
                time.sleep(0.2)
            for name, log, proc in done:
                running.remove((name, log, proc))
                cut = proc.poll() is None
                if cut:
                    proc.kill()
                    proc.wait()
                log.close()
                outputs[name] = (out_dir / f"{name}.log").read_text()
                print(outputs[name], end="", flush=True)
                path = out_dir / f"{name}.json"
                if cut or proc.returncode != 0 or not path.exists():
                    records[name] = {
                        "error": (f"past {timeout} s" if cut else
                                  f"exit {proc.returncode}"),
                        "exit": None if cut else proc.returncode}
                else:
                    records[name] = json.loads(path.read_text())
            if late:
                for name in todo:
                    records[name] = {"error": f"past {timeout} s",
                                     "exit": None}
                todo = []
    finally:  # a run stopped early leaves no cell running
        for _, log, proc in running:
            proc.kill()
            proc.wait()
            log.close()
    return records, outputs


def run_held(out_dir: Path, jobs: int = 1) -> int:
    """The cells of the reference's records (``dryrun_reference.json``),
    each on the mesh and probe its name gives, one subprocess a cell,
    ``jobs`` at a time.  Prints each cell's line of ratios; 1 if a cell
    fails or misses a bound, else 0."""
    refs = reference_records()
    records, _ = run_cells(list(refs), out_dir, max(jobs, 1))
    misses = sum("error" in rec or bool(against_reference(rec, refs[name]))
                 for name, rec in records.items())
    print(f"[held] {len(refs) - misses} of {len(refs)} cells within "
          f"bounds, torch {torch.__version__}", flush=True)
    return 1 if misses else 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--probe", type=int, default=0)
    ap.add_argument("--probes", action="store_true",
                    help="also run probe=1,2 cells (single-pod)")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--held", action="store_true",
                    help="the one-group probes of the cells the reference's "
                         "records hold (dryrun_reference.json), each with "
                         "its ratios; exit 1 if one misses a bound")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --held: cells run at once, one subprocess "
                         "a cell")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--skip-existing", action="store_true", default=True)
    ap.add_argument("--no-skip-existing", dest="skip_existing",
                    action="store_false")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    out_dir = Path(args.out)
    if args.held:
        return run_held(out_dir, args.jobs)
    archs = ARCH_IDS if args.arch == "all" else [args.arch.replace("-", "_")]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    for arch in archs:
        shapes = cells_for(arch) if args.shape == "all" else [args.shape]
        overrides = RULES_OVERRIDES.get(arch)
        for shape in shapes:
            for multi in meshes:
                run_one(arch, shape, multi, args.probe, out_dir,
                        args.skip_existing, rules_overrides=overrides)
            if args.probes or args.sweep:
                for p in (1, 2):
                    run_one(arch, shape, False, p, out_dir,
                            args.skip_existing, rules_overrides=overrides)


if __name__ == "__main__":
    raise SystemExit(main())
