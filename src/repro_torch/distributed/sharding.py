"""Logical-axis sharding rules on DTensor, the JAX package's
``src/repro/distributed/sharding.py``.

Models annotate tensors with *logical* axis names ("batch", "heads",
"ff", "fsdp", ...); the launcher installs an :class:`AxisRules` mapping
logical names → mesh dim names for the active
:class:`~torch.distributed.device_mesh.DeviceMesh` (2-dim single-pod or
3-dim multi-pod).  Every model definition stays mesh-agnostic: the same
code runs on ``("data","model")`` and ``("pod","data","model")``.

Torch has no ``PartitionSpec``: :class:`P` is a tuple of per-tensor-dim
entries (None, a name, or a tuple of names), the reference's vocabulary.
:func:`placements` turns a resolved spec into DTensor placements, and
:func:`shard` redistributes a DTensor to them (the reference's
``with_sharding_constraint``).  Without a mesh, or on a plain tensor,
:func:`shard` returns its input.

Divisibility guard: a logical dim that does not divide the mapped mesh
dims is *replicated* instead (e.g. 10 attention heads on a 16-wide model
axis; 40 experts on 16).  Each drop is recorded in ``AxisRules.dropped``
so the dry-run can report it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

__all__ = [
    "P",
    "NamedSharding",
    "AxisRules",
    "set_rules",
    "current_rules",
    "use_rules",
    "spec",
    "shard",
    "shard_if_divisible",
    "placements",
    "local_shards",
    "from_local",
    "all_reduce",
    "mesh_coordinate",
    "resolve_spec",
    "resolve_spec_tree",
    "SINGLE_POD_RULES",
    "MULTI_POD_RULES",
    "UNEVEN_OK",
]


class P(tuple):
    """A partition spec: one entry per tensor dim, each None (replicated),
    a mesh or logical axis name, or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


#: default logical→mesh map for the 16×16 single-pod mesh
SINGLE_POD_RULES: Dict[str, Union[str, Tuple[str, ...], None]] = {
    "batch": ("data",),
    "fsdp": ("data",),        # parameter / optimizer-state sharding axis
    "seq": None,               # qkv seq dim (halo-free ops only)
    "res_seq": None,           # residual-stream seq dim — ("model",) = Megatron-style SP
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "dmodel": None,            # activations replicated across model between ops
    "pages": None,
    "model": ("model",),       # direct tensor-parallel axis reference
    "data": ("data",),
}

#: boundary shardings must divide evenly, so non-divisible dims are
#: always replicated; KV caches with non-divisible head counts switch to
#: sequence-sharded layouts instead (blocks.kv_cache_spec).
UNEVEN_OK: set = set()

#: 2×16×16 multi-pod: pod is an outer DP axis; parameters and optimizer
#: state are FSDP-sharded over the full DP extent ("pod","data").
MULTI_POD_RULES: Dict[str, Union[str, Tuple[str, ...], None]] = {
    **SINGLE_POD_RULES,
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "pod": ("pod",),
}


@dataclasses.dataclass
class AxisRules:
    rules: Dict[str, Union[str, Tuple[str, ...], None]]
    #: a ``DeviceMesh`` with named dims, or None (no sharding)
    mesh: Optional[object] = None
    #: (logical, dim, axes) triples dropped for non-divisibility
    dropped: list = dataclasses.field(default_factory=list)

    def axes_for(self, logical: Optional[str]) -> Optional[Tuple[str, ...]]:
        if logical is None:
            return None
        if logical not in self.rules:
            raise KeyError(f"unknown logical axis {logical!r}")
        ax = self.rules[logical]
        if ax is None:
            return None
        return (ax,) if isinstance(ax, str) else tuple(ax)

    def mesh_size(self, axes: Sequence[str]) -> int:
        if self.mesh is None:
            return 1
        sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        n = 1
        for a in axes:
            n *= sizes[a]
        return n

    def entry(self, logical: Optional[str], dim: Optional[int]
              ) -> Union[None, Tuple[str, ...]]:
        """Resolve one spec entry, with the divisibility guard:
        non-divisible dims are replicated.  Always the canonical tuple
        form (or None)."""
        axes = self.axes_for(logical)
        if not axes:
            return None
        if dim is not None and self.mesh is not None:
            size = self.mesh_size(axes)
            if size > 1 and dim % size != 0:
                self.dropped.append((logical, dim, axes))
                return None
        return axes

    def spec(self, *logical: Optional[str],
             dims: Optional[Sequence[Optional[int]]] = None) -> P:
        dims = dims if dims is not None else [None] * len(logical)
        return P(*[self.entry(l, d) for l, d in zip(logical, dims)])


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A resolved spec on a mesh: the reference's ``NamedSharding``.
    ``placements`` are the DTensor placements it stands for."""

    mesh: object
    spec: P

    @property
    def placements(self):
        return placements(self.spec, self.mesh)


_state = threading.local()


def set_rules(rules: AxisRules) -> None:
    _state.rules = rules


def current_rules() -> AxisRules:
    r = getattr(_state, "rules", None)
    if r is None:
        r = AxisRules(dict(SINGLE_POD_RULES), mesh=None)
        _state.rules = r
    return r


@contextlib.contextmanager
def use_rules(rules: AxisRules) -> Iterator[AxisRules]:
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def spec(*logical: Optional[str],
         dims: Optional[Sequence[Optional[int]]] = None) -> P:
    return current_rules().spec(*logical, dims=dims)


def placements(p: P, mesh) -> tuple:
    """DTensor placements of a resolved spec: ``Shard(d)`` on every mesh
    dim that tensor dim ``d`` maps to, ``Replicate()`` elsewhere.  A dim
    over several mesh dims (``("pod", "data")``) is sharded in mesh-dim
    order, the first one major, as JAX shards it; its names must come in
    the mesh's own order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, e in enumerate(p):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {e!r} is not in the mesh's dim "
                             f"order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh dim {names[i]!r} used twice in {p!r}")
            out[i] = Shard(d)
    return tuple(out)


def shard(x, *logical: Optional[str]):
    """Redistribute a DTensor to the active rules' layout for its dims;
    ``x`` itself without a mesh or for a plain tensor."""
    rules = current_rules()
    if rules.mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(
        rules.mesh, placements(rules.spec(*logical, dims=x.shape), rules.mesh))


def shard_if_divisible(dim: int, logical: str
                       ) -> Union[None, str, Tuple[str, ...]]:
    return current_rules().entry(logical, dim)


def resolve_spec(p: P, rules: AxisRules,
                 dims: Optional[Sequence[int]] = None) -> P:
    """Translate a logical spec (entries are logical axis names) into a
    mesh spec under ``rules``, in the canonical tuple form of
    :meth:`AxisRules.entry`."""
    entries = []
    for i, e in enumerate(p):
        dim = dims[i] if dims is not None and i < len(dims) else None
        if e is None:
            entries.append(None)
            continue
        names = (e,) if isinstance(e, str) else tuple(e)
        axes: list = []
        for nm in names:
            a = rules.entry(nm, dim)
            if a is not None:
                axes.extend(a)
        entries.append(tuple(axes) if axes else None)
    return P(*entries)


def _map_specs(fn, tree, shapes):
    if isinstance(tree, P):
        return fn(tree, shapes)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, None if shapes is None else shapes[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_specs(fn, v, None if shapes is None else shapes[i])
                for i, v in enumerate(tree)]
    raise TypeError(f"not a spec tree leaf: {tree!r}")


def resolve_spec_tree(tree, rules: AxisRules, shapes=None):
    """Map a tree (dicts and lists) of logical specs, and optionally a
    tree of the same structure of tensors or shape-only tensors for the
    dim-aware guard, to :class:`NamedSharding` leaves on ``rules.mesh``."""
    return _map_specs(
        lambda p, s: NamedSharding(
            rules.mesh,
            resolve_spec(p, rules, None if s is None else tuple(s.shape))),
        tree, shapes)


# ---------------------------------------------------------------------------
# work on each rank's shards
# ---------------------------------------------------------------------------


def _is_dtensor(x) -> bool:
    if not hasattr(x, "device_mesh"):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local_shards(*xs, partial=()):
    """Each DTensor's local shard (a plain tensor is its own), for code
    that runs on each rank's shards: the gradient of a local shard flows
    back to its DTensor.  ``partial`` names mesh dims on which an input
    replicated there is put to a different use on each rank (its keys,
    its tokens): each rank's gradient is then a part of the input's, and
    the backward sums them."""
    out = []
    for x in xs:
        if not _is_dtensor(x):
            out.append(x)
            continue
        grad = None
        if partial:
            from torch.distributed.tensor import Partial

            grad = [Partial() if i in partial and p.is_replicate() else p
                    for i, p in enumerate(x.placements)]
        out.append(x.to_local(grad_placements=grad))
    return tuple(out)


def gathered_numel(x, placements, mesh_dims) -> float:
    """The elements of a DTensor's shard, laid out by ``placements``, once
    made whole on ``mesh_dims``: where two operands' shards clash on those
    dims, GSPMD gathers the one for which this is the smaller."""
    import math

    sizes = x.device_mesh.shape
    return x.numel() / math.prod(sizes[d] for d, p in enumerate(placements)
                                 if p.is_shard() and d not in mesh_dims)


def from_local(local, mesh, placements, shape):
    """A DTensor of global ``shape`` from each rank's contiguous
    ``local`` shard laid out by ``placements`` (differentiable)."""
    import math

    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, tuple(placements),
                              run_check=False, shape=shape, stride=stride)


def all_reduce(local, mesh, mesh_dims, op: str = "sum", *,
               per_rank_use: bool = False):
    """``local`` reduced (``"sum"`` or ``"max"``) over the ranks of
    ``mesh_dims``, every one of them left with the result: a DTensor
    redistribution, so the dry-run records the all-reduce.  The gradient
    of a sum reaches every rank whole: as it comes, where every rank puts
    the result to the same use, or summed over the ranks where each puts
    it to a use of its own (``per_rank_use``: each rank's gradient is then
    a part)."""
    if not mesh_dims:
        return local
    from torch.distributed.tensor import DTensor, Partial, Replicate

    part = [Partial(op) if i in mesh_dims else Replicate()
            for i in range(mesh.ndim)]
    d = DTensor.from_local(local, mesh, part, run_check=False)
    grad = [Partial() if per_rank_use and i in mesh_dims else Replicate()
            for i in range(mesh.ndim)]
    return d.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grad)


def mesh_coordinate(mesh, mesh_dims) -> int:
    """This rank's index among the shards of a tensor dim sharded over
    ``mesh_dims`` (in mesh order, the first one major)."""
    idx = 0
    for i in mesh_dims:
        idx = idx * mesh.shape[i] + mesh.get_local_rank(i)
    return idx
