"""``hete_Data`` and the hardware-agnostic memory API (RIMMS §3.2).

This is the paper's contribution, ported to PyTorch:

* :class:`HeteData` — a logical buffer that owns one materialization per
  :class:`~repro_torch.core.locations.Location` ("resource pointers") and a
  *last-resource flag* naming the location holding the valid bytes.
* :func:`hete_malloc` / :func:`hete_free` / :func:`hete_sync` — the
  hardware-agnostic allocation API.  ``hete_malloc`` reserves an extent in
  the target resource arena through a marking system
  (:mod:`repro_torch.core.allocator`) and exposes a host-resident data field;
  device materializations are created lazily by the runtime at task
  dispatch — and *reserve an arena extent at that point*, so a space's
  ``capacity`` is enforced whenever bytes actually land there.
* :meth:`HeteData.fragment` — O(n) subdivision of one allocation into n
  sub-buffers, each with its *own* last-resource flag, without touching
  the arena (RIMMS §3.2.3). ``hd[i]`` indexes the i-th fragment.

Consistency model (faithful to §3.2.2): a single resource owns each
buffer per API call; the flag is updated only when a task *writes* the
buffer; a task reading a buffer whose flag names another location pulls a
copy directly from that location (no host bounce).  ``tracking="cached"``
additionally remembers read-replicas (a beyond-paper optimization,
benchmarked separately; default is the paper's flag-only behaviour).

Thread safety: each :class:`HeteData` carries a lock serializing
``ensure``/``mark_written`` on that buffer, and arena reservations go
through a context-wide lock — the graph executor stages inputs from a
transfer pool concurrently with PE workers committing outputs.

Capacity pressure: device arenas behave like a managed cache
over host memory.  When a reservation cannot be satisfied, the context
selects victims among the space's resident buffers — cost-aware LRU over
an access clock touched on every flag check, never a pinned buffer —
writes dirty bytes back to host *through the existing coherence paths*
(fragment aliasing preserved), frees their extents and retries.
``AllocError`` surfaces only when the pinned working set genuinely
exceeds capacity.  ``pin``/``unpin`` (and the ``pinned`` context
manager) bound eviction; the graph executor additionally *protects*
bytes that queued tasks still read so prefetch never spills them
(prefetch under pressure defers instead — :class:`PrefetchDeferred`).

Buffer↔future lifecycle: the streaming session API
(:mod:`repro_torch.core.api`) hands out :class:`BufferFuture` handles over
``hete_Data`` buffers.  ``retain_use``/``release_use`` refcount
submitted-but-incomplete tasks per root allocation, and
``free_when_unused`` is ``hete_free`` deferred to after the last such
use — the session frees buffers the moment the stream no longer touches
them, without the application ever synchronizing.

Per-tenant arena quotas: a buffer may carry an ``owner`` (the
session client that allocated it), and :meth:`HeteContext.set_quota`
bounds each tenant's total reserved bytes *per device arena*.  A
reservation that would push its owner over budget first evicts the
owner's own least-valuable resident bytes; when nothing of the tenant's
is evictable the failure is :class:`~repro_torch.core.qos.QuotaExceeded` — an
``AllocError`` scoped to that tenant, leaving the arena (and every other
tenant) untouched.  Because pinned buffers hold arena extents, the quota
is also a pin budget: one tenant can never pin a whole arena.  General
capacity eviction prefers victims whose owner is over quota.

Interconnect topology: when the ledger's bandwidth model is a
:class:`~repro_torch.core.topology.TopologyBandwidthModel`, every copy
``stage`` performs is priced and recorded along its *route* — one ledger
entry per hop (store-and-forward), so a device↔device transfer on a
host-bridged platform shows up as two link crossings.  Eviction
write-back likewise chooses the cheapest destination: host, or a **peer
device arena** with free capacity when the interconnect makes the peer
link strictly cheaper (spill-to-peer) — the flag moves to the peer, host
bytes stay stale until synced, and fragment aliasing is preserved
because fragments' host views are never rebound.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import trace as trace_mod
from .allocator import AllocError, Extent, make_allocator
from .instrument import TransferLedger
from .locations import HOST, Location
from .qos import QuotaExceeded

__all__ = [
    "HeteData",
    "MemorySpace",
    "HeteContext",
    "PrefetchDeferred",
    "tensor_ingest",
    "tensor_egress",
    "default_context",
    "hete_malloc",
    "hete_free",
    "hete_sync",
]


class PrefetchDeferred(Exception):
    """Raised inside a :meth:`HeteContext.prefetch_guard` scope when a
    reservation would have to evict pinned or *protected* bytes (bytes a
    queued task still reads).  The graph executor catches it and falls
    back to staging on the PE worker at execute time, when earlier tasks
    have released their claims."""


class MemorySpace:
    """One resource memory region: placement rule + optional arena.

    ``ingest``: host-format (numpy) → this location's representation.
    ``egress``: this location's representation → host numpy.
    For accelerator PEs they are :func:`tensor_ingest` /
    :func:`tensor_egress`: real copies into and out of a
    ``torch.Tensor`` on the space's device.
    """

    def __init__(
        self,
        location: Location,
        *,
        capacity: Optional[int] = None,
        allocator: str = "nextfit",
        block_size: int = 4096,
        ingest: Optional[Callable[[np.ndarray], Any]] = None,
        egress: Optional[Callable[[Any], np.ndarray]] = None,
    ) -> None:
        self.location = location
        self.arena = (
            make_allocator(allocator, capacity, block_size) if capacity else None
        )
        # id(root) -> root HeteData holding an extent here (eviction pool)
        self.residents: Dict[int, "HeteData"] = {}
        self._ingest = ingest
        self._egress = egress

    def ingest(self, host_value: np.ndarray) -> Any:
        if self._ingest is None:  # host space: identity
            return host_value
        return self._ingest(host_value)

    def egress(self, value: Any) -> np.ndarray:
        if self._egress is None:
            return np.asarray(value)
        return self._egress(value)


def tensor_ingest(device) -> Callable[[np.ndarray], torch.Tensor]:
    """Ingest for a tensor-backed space: host numpy → a tensor on
    ``device`` that owns its bytes.  Always a copy, CPU included —
    ``torch.from_numpy`` alone would alias the host buffer, and the host
    views that ``stage``/``mark_written`` ``np.copyto`` into (and the
    radar builders' in-place fills) would silently rewrite the "device"
    copy.  Synchronous: no ``non_blocking`` and no pinned staging, so a
    later in-place host write can never race the transfer."""
    dev = torch.device(device)

    def ingest(host_value: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(host_value))
        return src.to(dev, copy=True)

    return ingest


def tensor_egress(value: torch.Tensor) -> np.ndarray:
    """Egress for a tensor-backed space: a host numpy array that owns
    its bytes (``.numpy()`` of a CPU tensor would share them, and the
    result is stored as the buffer's host copy).  A CUDA source is
    copied synchronously on the current stream."""
    return value.detach().to("cpu", copy=True).numpy()


@dataclasses.dataclass
class HeteData:
    """The paper's ``hete_Data``: per-location copies + last-resource flag."""

    shape: tuple
    dtype: np.dtype
    context: "HeteContext"
    last_location: Location = HOST
    # "resource pointers": location -> materialized value
    copies: Dict[Location, Any] = dataclasses.field(default_factory=dict)
    # arena bookkeeping: location -> Extent reserved in that space's arena
    extents: Dict[Location, Extent] = dataclasses.field(default_factory=dict)
    # fragmentation (§3.2.3)
    parent: Optional["HeteData"] = None
    frag_offset: int = 0
    fragments: Optional[List["HeteData"]] = None
    # beyond-paper read-replica cache; faithful mode ignores it
    valid_at: set = dataclasses.field(default_factory=set)
    # capacity-pressure state (kept on the ROOT allocation; fragments
    # delegate): eviction refcounts + access clock per location, and a
    # monotonic eviction epoch (prefetched stagings revalidate against it)
    pins: Dict[Location, int] = dataclasses.field(default_factory=dict)
    last_touch: Dict[Location, int] = dataclasses.field(default_factory=dict)
    eviction_epoch: int = 0
    freed: bool = False
    # buffer↔future lifecycle: number of
    # submitted-but-incomplete tasks touching this allocation, and
    # whether a deferred hete_free fires when that count drains
    pending_uses: int = 0
    free_pending: bool = False
    # owning tenant: the session client that allocated this
    # buffer — quota accounting and eviction preference key on it
    owner: Optional[str] = None
    # set when a fragment was written since the parent's copy was last
    # coherent — a whole-parent read gathers fragments first (see
    # HeteContext._gather_fragments)
    frag_dirty: bool = False
    lock: threading.RLock = dataclasses.field(
        default_factory=threading.RLock, repr=False, compare=False
    )

    # -- basics -----------------------------------------------------------
    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * np.dtype(self.dtype).itemsize

    @property
    def data(self) -> np.ndarray:
        """Host-resident data field (transparent access, as in the paper).

        NOTE: reading it without :func:`hete_sync` may observe stale bytes
        if an accelerator holds the valid copy — exactly the hazard
        ``hete_Sync`` exists to resolve.
        """
        return self.copies[HOST]

    def __getitem__(self, i: int) -> "HeteData":
        """Overloaded indexing: after ``fragment()``, ``hd[i]`` is the
        i-th fragment (paper §3.2.3)."""
        if self.fragments is None:
            raise IndexError(
                "hete_Data is not fragmented; call .fragment(nbytes) first"
            )
        return self.fragments[i]

    def __len__(self) -> int:
        return 0 if self.fragments is None else len(self.fragments)

    # -- aliasing (used by the task-graph builder) -------------------------
    @property
    def root(self) -> "HeteData":
        """The top-level allocation this buffer belongs to (self if not a
        fragment)."""
        return self.parent if self.parent is not None else self

    # -- capacity pressure ---------------------------------------
    def pin(self, loc: Location) -> None:
        """Make this buffer's root allocation non-evictable at ``loc``
        (refcounted).  Pinning does not force residency — it only bounds
        eviction while the count is non-zero."""
        self.context.pin(self, loc)

    def unpin(self, loc: Location) -> None:
        self.context.unpin(self, loc)

    def pin_count(self, loc: Location) -> int:
        return self.root.pins.get(loc, 0)

    @contextlib.contextmanager
    def pinned(self, loc: Location):
        """``with hd.pinned(dev): ...`` — eviction-safe scope at ``loc``."""
        self.pin(loc)
        try:
            yield self
        finally:
            self.unpin(loc)

    def byte_interval(self) -> Tuple[int, int]:
        """``[lo, hi)`` byte range inside :attr:`root`'s allocation —
        fragments alias their parent over this interval."""
        if self.parent is None:
            return (0, self.nbytes)
        per_elem = self.nbytes // int(self.shape[0])
        lo = self.frag_offset * per_elem
        return (lo, lo + self.nbytes)

    # -- fragmentation (§3.2.3) --------------------------------------------
    def fragment(self, frag_elems: int) -> List["HeteData"]:
        """Subdivide into fragments of ``frag_elems`` leading elements.

        O(n) in the number of fragments; does NOT touch the arenas (the
        parent's reserved extents simply get logically partitioned), which
        is the paper's point: one search, n usable buffers.

        Each fragment inherits the parent's last-resource flag.  When the
        parent's valid copy lives on a device, fragments also receive a
        sliced view of that device copy, so ``ensure``/``sync`` on a
        fragment resolves to the *current* bytes — never the stale host
        view (see tests/test_hete.py::test_fragment_of_device_parent).
        """
        if self.parent is not None:
            raise ValueError("cannot fragment a fragment")
        total = int(self.shape[0])
        if frag_elems <= 0 or total % frag_elems:
            raise ValueError(
                f"fragment size {frag_elems} must divide leading dim {total}"
            )
        n = total // frag_elems
        host_buf = self.copies[HOST]
        dev_buf = (
            self.copies.get(self.last_location)
            if self.last_location != HOST
            else None
        )
        frags: List[HeteData] = []
        for i in range(n):
            sub = HeteData(
                shape=(frag_elems,) + tuple(self.shape[1:]),
                dtype=self.dtype,
                context=self.context,
                last_location=self.last_location,
                parent=self,
                frag_offset=i * frag_elems,
            )
            # zero-copy host view into the parent buffer
            sub.copies[HOST] = host_buf[i * frag_elems : (i + 1) * frag_elems]
            if dev_buf is not None:
                sub.copies[self.last_location] = dev_buf[
                    i * frag_elems : (i + 1) * frag_elems
                ]
            sub.valid_at = {self.last_location}
            frags.append(sub)
        self.fragments = frags
        self.frag_dirty = False
        return frags


class HeteContext:
    """A RIMMS instance: memory-space registry + ledger + the three APIs."""

    def __init__(
        self,
        ledger: Optional[TransferLedger] = None,
        tracking: str = "flag",  # "flag" (paper-faithful) | "cached" (beyond-paper)
    ) -> None:
        if tracking not in ("flag", "cached"):
            raise ValueError(f"unknown tracking mode {tracking!r}")
        self.tracking = tracking
        # Each context gets an isolated ledger by default so concurrent
        # experiments (reference vs rimms) never share counters.
        self.ledger = ledger if ledger is not None else TransferLedger()
        self.spaces: Dict[Location, MemorySpace] = {HOST: MemorySpace(HOST)}
        self._arena_lock = threading.RLock()
        # -- capacity pressure --
        self._clock = 0  # monotonic access clock (approximate under races)
        # (id(root), loc) -> refcount of queued graph tasks reading those
        # bytes; prefetch staging must not evict them (executor-managed)
        self._protected: Dict[Tuple[int, Location], int] = {}
        # -- per-tenant quotas --
        self._quotas: Dict[str, int] = {}  # owner -> bytes per device arena
        # (owner, loc) -> bytes that owner currently reserves in loc's arena
        self._tenant_bytes: Dict[Tuple[str, Location], int] = {}
        self._tls = threading.local()  # .strict, .spill_s
        # -- tracing: off by default; a process-global collector
        # (benchmarks/run.py --trace-dir) captures contexts at creation.
        self.tracer = None
        _global_tracer = trace_mod.global_collector()
        if _global_tracer is not None:
            self.set_tracer(_global_tracer)

    def set_tracer(self, tracer) -> None:
        """Attach a :class:`~repro_torch.core.trace.TraceCollector` (or None to
        detach).  Registers this context with the collector and wires the
        ledger so every recorded copy emits a matching trace event."""
        self.tracer = tracer
        if tracer is None:
            self.ledger.tracer = None
            return
        label = tracer.register_context(self)
        baseline = self.ledger.attach_tracer(tracer, label)
        tracer.set_ledger_baseline(label, baseline)

    # -- registry ----------------------------------------------------------
    def register_space(self, space: MemorySpace) -> MemorySpace:
        self.spaces[space.location] = space
        return space

    # -- pins / protection ----------------------------------------
    def pin(self, hd: HeteData, loc: Location) -> None:
        root = hd.root
        with self._arena_lock:
            root.pins[loc] = root.pins.get(loc, 0) + 1

    def unpin(self, hd: HeteData, loc: Location) -> None:
        root = hd.root
        with self._arena_lock:
            n = root.pins.get(loc, 0)
            if n <= 0:
                raise ValueError(f"unpin without matching pin at {loc}")
            if n == 1:
                root.pins.pop(loc)
            else:
                root.pins[loc] = n - 1

    # -- per-tenant quotas -----------------------------------------
    def set_quota(self, owner: str, nbytes: Optional[int]) -> None:
        """Bound ``owner``'s reserved bytes in *each* device arena to
        ``nbytes`` (None lifts the bound).  Applies to future
        reservations; bytes already resident are not evicted eagerly, but
        an over-quota tenant becomes the preferred eviction victim."""
        with self._arena_lock:
            if nbytes is None:
                self._quotas.pop(owner, None)
            else:
                self._quotas[owner] = int(nbytes)

    def quota_of(self, owner: str) -> Optional[int]:
        with self._arena_lock:
            return self._quotas.get(owner)

    def tenant_bytes(self, owner: str, loc: Location) -> int:
        """Bytes ``owner`` currently reserves in ``loc``'s arena."""
        with self._arena_lock:
            return self._tenant_bytes.get((owner, loc), 0)

    def _tenant_charge(self, root: HeteData, loc: Location,
                       sign: int) -> None:
        """Track per-tenant reserved bytes at extent create (+1) /
        release (-1).  Called under the arena lock."""
        if root.owner is None:
            return
        key = (root.owner, loc)
        n = self._tenant_bytes.get(key, 0) + sign * root.nbytes
        if n <= 0:
            self._tenant_bytes.pop(key, None)
        else:
            self._tenant_bytes[key] = n

    def _over_quota(self, owner: Optional[str], loc: Location) -> bool:
        if owner is None:
            return False
        q = self._quotas.get(owner)
        return (q is not None
                and self._tenant_bytes.get((owner, loc), 0) > q)

    # -- buffer↔future lifecycle -----------------------------------
    def retain_use(self, hd: HeteData) -> None:
        """Count one submitted-but-incomplete task touching ``hd``'s root
        allocation.  The streaming session retains every distinct input/
        output root at submission and releases it at task completion, so
        a deferred free (:meth:`free_when_unused`) can never reclaim
        bytes an in-flight task still reads or writes."""
        with self._arena_lock:
            hd.root.pending_uses += 1

    def release_use(self, hd: HeteData) -> None:
        """Balance one :meth:`retain_use`; fires the deferred free when
        this was the last in-flight use of a buffer already marked via
        :meth:`free_when_unused`."""
        root = hd.root
        with self._arena_lock:
            if root.pending_uses <= 0:
                raise ValueError("release_use without matching retain_use")
            root.pending_uses -= 1
            if (root.free_pending and root.pending_uses == 0
                    and not root.freed):
                root.free_pending = False
                self.free(root)

    def free_when_unused(self, hd: HeteData) -> bool:
        """``hete_Free`` deferred to after the last in-flight use: frees
        immediately (returning True) when no submitted task still touches
        the root allocation, otherwise arms a deferred free that the
        final :meth:`release_use` performs (returning False)."""
        root = hd.root
        with self._arena_lock:
            if root.freed:
                raise AllocError("double hete_free")
            if root.pending_uses > 0:
                root.free_pending = True
                return False
            self.free(root)
            return True

    def protect(self, hd: HeteData, loc: Location) -> None:
        """Refcounted *soft* claim: a queued task still reads these bytes
        at ``loc``.  Prefetch-triggered eviction (inside
        :meth:`prefetch_guard`) refuses protected victims; demand staging
        on a PE worker may still evict them (the reader re-fetches)."""
        key = (id(hd.root), loc)
        with self._arena_lock:
            self._protected[key] = self._protected.get(key, 0) + 1

    def unprotect(self, hd: HeteData, loc: Location) -> None:
        key = (id(hd.root), loc)
        with self._arena_lock:
            n = self._protected.get(key, 0)
            if n <= 1:
                self._protected.pop(key, None)
            else:
                self._protected[key] = n - 1

    @contextlib.contextmanager
    def prefetch_guard(self):
        """Scope for speculative staging (the executor's transfer pool):
        a reservation that would have to evict pinned or protected bytes
        raises :class:`PrefetchDeferred` instead of spilling them."""
        prev = getattr(self._tls, "strict", False)
        self._tls.strict = True
        try:
            yield self
        finally:
            self._tls.strict = prev

    def take_spill_seconds(self) -> float:
        """Modeled eviction write-back seconds accumulated by THIS thread
        since the last call (spill-stall attribution for the Timeline)."""
        s = getattr(self._tls, "spill_s", 0.0)
        self._tls.spill_s = 0.0
        return s

    def _spill_add(self, seconds: float) -> None:
        self._tls.spill_s = getattr(self._tls, "spill_s", 0.0) + seconds

    # -- routed copy accounting ------------------------------------
    def record_copy(self, src: Location, dst: Location, nbytes: int) -> float:
        """Ledger-record one logical copy along its route and return the
        modeled seconds it costs.  Scalar bandwidth model: one direct
        (src, dst) entry.  Topology model: one entry per hop of the
        cheapest route (store-and-forward), each priced at that link's
        service time — the per-link traffic matrix falls out of the
        ledger's (src, dst) counters."""
        bw = self.ledger.bandwidth_model
        hops = bw.hops(src, dst)
        if hops is None:
            self.ledger.record(src, dst, nbytes)
            return bw.seconds(src, dst, nbytes)
        total = 0.0
        for link in hops:
            s = link.seconds(nbytes)
            self.ledger.record(link.src, link.dst, nbytes, seconds=s)
            total += s
        return total

    def _log_move(self, src: Location, dst: Location, nbytes: int) -> None:
        """Append one performed copy to THIS thread's move log (drained
        by :meth:`take_moves`) — the executor feeds these into the
        contention-aware schedule replay."""
        moves = getattr(self._tls, "moves", None)
        if moves is not None:
            moves.append((src, dst, nbytes))

    def take_moves(self) -> List[Tuple[Location, Location, int]]:
        """Drain (and re-arm) this thread's move log."""
        out = getattr(self._tls, "moves", None) or []
        self._tls.moves = []
        return out

    def _touch(self, root: HeteData, loc: Location) -> None:
        # Approximate LRU clock: racy increments lose ticks, which only
        # coarsens victim order — never correctness.
        self._clock += 1
        root.last_touch[loc] = self._clock

    # -- the three hardware-agnostic APIs (§3.2.1) ---------------------------
    def malloc(
        self,
        shape: Union[int, Sequence[int]],
        dtype: Any = np.uint8,
        *,
        spaces: Sequence[Location] = (),
        owner: Optional[str] = None,
    ) -> HeteData:
        """``hete_Malloc``: host buffer + arena reservations in ``spaces``.

        The user only names a size; which resource memories get extents is
        decided by the runtime (here: the ``spaces`` the embedding runtime
        passes — app code never does).  ``owner`` names the tenant the
        allocation is charged to (per-tenant quotas).
        """
        if isinstance(shape, (int, np.integer)):
            shape = (int(shape),)
        shape = tuple(int(s) for s in shape)
        hd = HeteData(shape=shape, dtype=np.dtype(dtype), context=self,
                      owner=owner)
        hd.copies[HOST] = np.zeros(shape, dtype=dtype)
        hd.valid_at = {HOST}
        for loc in spaces:
            self._reserve(hd, loc)
        return hd

    def free(self, hd: HeteData) -> None:
        """``hete_Free``: release every resource pointer + arena extent."""
        if hd.freed:
            raise AllocError("double hete_free")
        if hd.parent is not None:
            raise ValueError("free the parent allocation, not a fragment")
        if hd.fragments:
            for f in hd.fragments:
                f.copies.clear()
                f.freed = True
            hd.fragments = None
        with self._arena_lock:
            for loc, ext in hd.extents.items():
                space = self.spaces[loc]
                if space.arena is not None:
                    space.arena.free(ext)
                    self._tenant_charge(hd, loc, -1)
                space.residents.pop(id(hd), None)
            hd.extents.clear()
            hd.pins.clear()
        hd.copies.clear()
        hd.valid_at.clear()
        hd.freed = True

    def sync(self, hd: HeteData) -> np.ndarray:
        """``hete_Sync``: make the host copy current; return it."""
        return self.ensure(hd, HOST)

    # -- arena accounting ---------------------------------------------------
    def _reserve(self, hd: HeteData, loc: Location) -> None:
        """Reserve an extent for ``hd``'s root allocation in ``loc``'s
        arena on first materialization there (no-op for spaces without a
        capacity arena).  Fragments charge their parent's full extent —
        one arena search covers all n fragments (§3.2.3).

        Under pressure this is the evict-retry loop: each
        failed allocation evicts one victim (cost-aware LRU) and retries;
        ``AllocError`` surfaces only when nothing is evictable — i.e. the
        pinned (or, inside :meth:`prefetch_guard`, pinned+protected)
        working set genuinely exceeds capacity.

        Per-tenant quotas: a reservation that would push the
        owner over its arena budget first evicts the owner's *own*
        resident buffers; with nothing of the tenant's evictable it
        raises :class:`~repro_torch.core.qos.QuotaExceeded` — scoped to the
        tenant, other tenants keep allocating."""
        root = hd.root
        space = self.spaces[loc]
        if space.arena is None:
            return
        with self._arena_lock:
            if loc in root.extents:
                return
            stalled = False
            skip: set = set()  # victims whose eviction failed (in use)
            owner = root.owner
            quota = self._quotas.get(owner) if owner is not None else None
            while True:
                if (quota is not None
                        and self._tenant_bytes.get((owner, loc), 0)
                        + root.nbytes > quota):
                    victim = self._select_victim(space, loc, exclude=root,
                                                 skip=skip, tenant=owner)
                    if victim is None:
                        if getattr(self._tls, "strict", False):
                            self.ledger.record_prefetch_deferral()
                            if self.tracer is not None:
                                self.tracer.instant(
                                    "prefetch_deferred", "memory",
                                    f"mem:{loc}",
                                    {"reason": "quota", "owner": owner,
                                     "nbytes": root.nbytes})
                            raise PrefetchDeferred(
                                f"prefetch to {loc} deferred: tenant "
                                f"{owner!r} is at quota with no evictable "
                                f"bytes of its own"
                            )
                        raise QuotaExceeded(
                            f"tenant {owner!r} quota exhausted at {loc}: "
                            f"{self._tenant_bytes.get((owner, loc), 0)} B "
                            f"reserved of {quota} B budget, cannot add "
                            f"{root.nbytes} B (shape={root.shape}); other "
                            f"tenants are unaffected",
                            tenant=owner, location=loc,
                        )
                    if not stalled:
                        stalled = True
                        self.ledger.record_spill_stall()
                    if not self._evict_locked(victim, loc):
                        skip.add(id(victim))  # in active use; try others
                    continue
                try:
                    ext = space.arena.alloc(root.nbytes, tag=id(root))
                except AllocError as e:
                    victim = self._select_victim(space, loc, exclude=root,
                                                 skip=skip)
                    if victim is None:
                        if getattr(self._tls, "strict", False):
                            self.ledger.record_prefetch_deferral()
                            if self.tracer is not None:
                                self.tracer.instant(
                                    "prefetch_deferred", "memory",
                                    f"mem:{loc}",
                                    {"reason": "capacity",
                                     "nbytes": root.nbytes})
                            raise PrefetchDeferred(
                                f"prefetch to {loc} deferred: reserving "
                                f"{root.nbytes} B would evict pinned or "
                                f"still-queued bytes"
                            ) from e
                        pinned = sum(
                            r.nbytes for r in space.residents.values()
                            if r.pins.get(loc, 0) > 0
                        )
                        raise AllocError(
                            f"memory space {loc} exhausted: cannot reserve "
                            f"{root.nbytes} B for buffer shape={root.shape} "
                            f"({space.arena.free_bytes} B free of "
                            f"{space.arena.capacity} B, {pinned} B pinned, "
                            f"nothing evictable): {e}"
                        ) from e
                    if not stalled:
                        stalled = True
                        self.ledger.record_spill_stall()
                    if not self._evict_locked(victim, loc):
                        skip.add(id(victim))  # in active use; try others
                    continue
                root.extents[loc] = ext
                space.residents[id(root)] = root
                self._tenant_charge(root, loc, +1)
                self._touch(root, loc)
                return

    # -- eviction engine -------------------------------------------
    def _select_victim(self, space: MemorySpace, loc: Location,
                       exclude: HeteData,
                       skip: frozenset = frozenset(),
                       tenant: Optional[str] = None) -> Optional[HeteData]:
        """Cost-aware LRU victim pick, called under the arena lock.

        Candidates: resident roots that are not the buffer being
        reserved, not pinned, and — inside :meth:`prefetch_guard` — not
        protected by a queued reader.  A candidate whose lock is held by
        another thread is in active use and skipped (non-blocking probe,
        which also makes eviction deadlock-free).  Order: buffers whose
        owner is over its tenant quota first, then least
        recent access; ties broken by the modeled cost of the round trip
        the eviction causes (write-back now if dirty + re-fetch later),
        normalized per byte freed, then by id for determinism.

        ``tenant`` restricts candidates to that owner's buffers — the
        quota-enforcement path evicts only the over-budget tenant's own
        bytes, never another tenant's.
        """
        strict = getattr(self._tls, "strict", False)
        bw = self.ledger.bandwidth_model
        best, best_key = None, None
        for rid, cand in space.residents.items():
            if cand is exclude.root or rid in skip or cand.pins.get(loc, 0) > 0:
                continue
            if tenant is not None and cand.owner != tenant:
                continue
            if strict and self._protected.get((rid, loc), 0) > 0:
                continue
            dirty = self._dirty_bytes(cand, loc)
            cost_s = bw.seconds(HOST, loc, cand.nbytes)
            if dirty:
                # Write-back goes to the *cheapest* destination this
                # victim could spill to (host, or a peer arena with
                # room) — rank victims by the cost eviction really pays.
                _, wb_s = self._writeback_target(cand, loc, dirty)
                cost_s += wb_s
            key = (0 if self._over_quota(cand.owner, loc) else 1,
                   cand.last_touch.get(loc, 0), cost_s / max(cand.nbytes, 1),
                   rid)
            if best_key is None or key < best_key:
                best, best_key = cand, key
        return best

    def _writeback_target(
        self, root: HeteData, loc: Location, dirty: int
    ) -> Tuple[Location, float]:
        """Cheapest destination for ``root``'s dirty bytes when evicted
        from ``loc``: host, or a peer device arena that (a) the
        interconnect reaches strictly cheaper than host and (b) can take
        the root's full extent *without evicting anything itself* (no
        cascades).  Peers are considered only when a topology is active
        — under the scalar default model eviction stays host-bound, so
        pre-topology baselines and semantics hold exactly.  Called under
        the arena lock.  Returns ``(target, modeled write-back
        seconds)``."""
        bw = self.ledger.bandwidth_model
        best, best_s = HOST, bw.seconds(loc, HOST, dirty)
        if getattr(bw, "topology", None) is None:
            return best, best_s
        from .topology import TopologyError

        quota = (self._quotas.get(root.owner)
                 if root.owner is not None else None)
        for ploc, pspace in self.spaces.items():
            if ploc == loc or ploc == HOST or pspace.arena is None:
                continue
            if ploc not in root.extents:
                if pspace.arena.largest_free() < root.nbytes:
                    continue
                # Never let the runtime's own eviction path push the
                # owner over its budget in the peer arena:
                # spilling there would reserve a fresh extent.
                if (quota is not None
                        and self._tenant_bytes.get((root.owner, ploc), 0)
                        + root.nbytes > quota):
                    continue
            try:
                s = bw.seconds(loc, ploc, dirty)
            except TopologyError:  # unreachable in this topology
                continue
            if s < best_s:
                best, best_s = ploc, s
        return best, best_s

    def _spill_to_peer(
        self, root: HeteData, loc: Location, peer: Location
    ) -> Optional[float]:
        """Move ``root``'s dirty bytes from ``loc`` directly to ``peer``
        (device→device spill): reserve the root's extent in the
        peer arena (never evicting — pre-checked by
        :meth:`_writeback_target`), copy each dirty owner's bytes across
        the peer link, and move its flag to ``peer``.  Host bytes are
        untouched (still stale) and fragments' zero-copy host views stay
        aliased.  Called under the arena lock with every owner lock
        held.  Returns modeled write-back seconds, or ``None`` when the
        spill cannot proceed (caller falls back to host write-back)."""
        space, pspace = self.spaces[loc], self.spaces[peer]
        owners = [root] + list(root.fragments or ())
        dirty_owners = [o for o in owners if o.last_location == loc]
        if not dirty_owners or any(loc not in o.copies for o in dirty_owners):
            return None
        if peer not in root.extents:
            try:
                ext = pspace.arena.alloc(root.nbytes, tag=id(root))
            except AllocError:
                return None
            root.extents[peer] = ext
            pspace.residents[id(root)] = root
            self._tenant_charge(root, peer, +1)
        wb_s = 0.0
        if root.last_location == loc:
            # The parent's loc copy is current for every loc-flagged
            # interval: ONE whole-parent transfer covers root and
            # fragments alike; fragments get zero-copy slices of the
            # peer buffer (the shape _propagate_to_fragments produces).
            moved = pspace.ingest(space.egress(root.copies[loc]))
            root.copies[peer] = moved
            root.last_location = peer
            root.valid_at.add(peer)
            wb_s += self.record_copy(loc, peer, root.nbytes)
            if root.fragments:
                step = int(root.fragments[0].shape[0])
                for i, frag in enumerate(root.fragments):
                    if frag.last_location == loc:
                        frag.copies[peer] = moved[i * step:(i + 1) * step]
                        frag.last_location = peer
                        frag.valid_at.add(peer)
        else:
            # Fragments own the flag and hold their own device arrays:
            # spill each dirty fragment individually.
            for o in dirty_owners:
                o.copies[peer] = pspace.ingest(space.egress(o.copies[loc]))
                o.last_location = peer
                o.valid_at.add(peer)
                wb_s += self.record_copy(loc, peer, o.nbytes)
        self._touch(root, peer)
        return wb_s

    @staticmethod
    def _dirty_bytes(root: HeteData, loc: Location) -> int:
        """Bytes at ``loc`` not yet reflected in the host copy."""
        if root.fragments:
            return sum(f.nbytes for f in root.fragments
                       if f.last_location == loc)
        return root.nbytes if root.last_location == loc else 0

    def _evict_locked(self, root: HeteData, loc: Location) -> bool:
        """Evict ``root`` from ``loc``: write dirty bytes back to the
        cheapest destination — host through the normal coherence paths,
        or directly into a peer device arena when the interconnect makes
        that strictly cheaper and the peer has room (spill-to-peer) —
        then drop the materializations and free the extent.
        Fragment aliasing is preserved on both paths.  Called under the
        arena lock; probes the buffer locks (root + every fragment)
        without blocking — a contended lock means the buffer is in
        active use by another thread, so the caller skips this victim.
        The probe is what keeps eviction deadlock-free: no thread ever
        blocks on a buffer lock while holding the arena lock."""
        held = []
        for owner in [root] + list(root.fragments or ()):
            if not owner.lock.acquire(blocking=False):
                for h in held:
                    h.lock.release()
                return False
            held.append(owner)
        try:
            space = self.spaces[loc]
            ext = root.extents.get(loc)
            if ext is None:
                space.residents.pop(id(root), None)
                return False
            dirty = self._dirty_bytes(root, loc)
            wb_s, target = 0.0, HOST
            if dirty:
                target, _ = self._writeback_target(root, loc, dirty)
                # Write-back copies are spill cost, not staging traffic:
                # keep them out of this thread's move log (they are
                # accounted through spill_s / the ledger instead).
                moves = getattr(self._tls, "moves", None)
                mark = len(moves) if moves is not None else 0
                if target != HOST:
                    spilled = self._spill_to_peer(root, loc, target)
                    if spilled is None:  # peer filled up meanwhile
                        target = HOST
                    else:
                        wb_s = spilled
                if target == HOST:
                    # stage() makes the host bytes current — a direct
                    # loc→host copy, or a per-fragment gather when
                    # fragments own the flag — recording the copies in
                    # the ledger as usual.
                    self.stage(root, HOST)
                    wb_s = self.ledger.bandwidth_model.seconds(loc, HOST, dirty)
                if moves is not None:
                    del moves[mark:]
                self._spill_add(wb_s)
            # Move flags off the doomed materialization (eviction is the
            # one sanctioned flag move outside mark_written — the
            # write-back target becomes the owning resource; peer-spilled
            # owners were re-flagged inside _spill_to_peer).  HOST joins
            # valid_at only when a host write-back actually made it
            # current: a clean replica evicted while a *third* location
            # owns the flag must not resurrect a stale host copy
            # (cached tracking).
            if root.last_location == loc:
                root.last_location = HOST
            root.valid_at.discard(loc)
            if dirty and target == HOST:
                root.valid_at.add(HOST)
            root.copies.pop(loc, None)
            for frag in root.fragments or ():
                if frag.last_location == loc:
                    frag.last_location = HOST
                frag.valid_at.discard(loc)
                if dirty and target == HOST:
                    frag.valid_at.add(HOST)
                frag.copies.pop(loc, None)
            space.arena.free(ext)
            del root.extents[loc]
            space.residents.pop(id(root), None)
            self._tenant_charge(root, loc, -1)
            root.eviction_epoch += 1
            self.ledger.record_eviction(loc, root.nbytes, dirty, wb_s,
                                        target=target, owner=root.owner)
            if self.tracer is not None:
                spilled = (target is not None and target.kind != "host"
                           and dirty > 0)
                self.tracer.instant(
                    "spill_to_peer" if spilled else "evict", "memory",
                    f"mem:{loc}",
                    {"nbytes": root.nbytes, "dirty_bytes": dirty,
                     "writeback_s": wb_s, "target": str(target),
                     "owner": root.owner})
            return True
        finally:
            for h in held:
                h.lock.release()

    def evict(self, hd: HeteData, loc: Location) -> bool:
        """Explicitly evict ``hd``'s root allocation from ``loc`` (tests /
        manual spill).  Returns False if not resident, pinned, or in use."""
        root = hd.root
        with self._arena_lock:
            if root.pins.get(loc, 0) > 0 or loc not in root.extents:
                return False
            return self._evict_locked(root, loc)

    # -- runtime-internal protocol (§3.2.2) ----------------------------------
    def ensure(self, hd: HeteData, dst: Location) -> Any:
        """Last-resource-flag check + (only if needed) a direct copy.

        This is the 1–2 cycle check the paper measures: one flag compare
        per input. A copy is issued only when the flag names another
        location, and it goes *directly* src→dst (Fig 1b), never via host.
        """
        return self.stage(hd, dst)[0]

    def stage(self, hd: HeteData, dst: Location) -> Tuple[Any, float]:
        """:meth:`ensure` + report of the modeled seconds of the copy it
        performed (0.0 on a flag hit).  The graph executor uses the
        second element for schedule simulation."""
        self.ledger.record_flag_check()
        if hd.freed:
            raise AllocError("use after hete_free")
        # Lock-free fast path for the flag hit — the 1–2 cycle check the
        # paper measures (§5.2.2) must not pay a lock.  Safe because the
        # task graph orders writers against readers: the flag cannot move
        # concurrently with this read.
        if hd.last_location == dst and not (hd.fragments and hd.frag_dirty):
            # .get(): eviction (which holds hd.lock, not taken here) may
            # have moved the flag between the check and the read — fall
            # through to the locked slow path, which re-stages.
            value = hd.copies.get(dst)
            if value is not None:
                if dst != HOST:
                    self._touch(hd.root, dst)  # access clock: LRU evidence
                return value, 0.0
        with hd.lock:
            if hd.fragments and hd.frag_dirty:
                self._gather_fragments(hd)
            src = hd.last_location
            if dst == src:
                if dst != HOST:
                    self._touch(hd.root, dst)
                return hd.copies[dst], 0.0
            if self.tracking == "cached" and dst in hd.valid_at and dst in hd.copies:
                if dst != HOST:
                    self._touch(hd.root, dst)
                return hd.copies[dst], 0.0
            if dst != HOST:
                self._reserve(hd, dst)
            value = hd.copies[src]
            host_np = self.spaces[src].egress(value) if src != HOST else value
            if dst == HOST and (hd.parent is not None or hd.fragments):
                # preserve the zero-copy host views linking parent and
                # fragments (rebinding would orphan them)
                np.copyto(hd.copies[HOST], np.asarray(host_np).reshape(hd.shape))
                moved = hd.copies[HOST]
            else:
                moved = self.spaces[dst].ingest(host_np) if dst != HOST else host_np
                hd.copies[dst] = moved
            hd.valid_at.add(dst)
            if dst != HOST:
                self._touch(hd.root, dst)
            tr_s = self.record_copy(src, dst, hd.nbytes)
            self._log_move(src, dst, hd.nbytes)
            return moved, tr_s

    def mark_written(self, hd: HeteData, loc: Location, value: Any) -> None:
        """A task on ``loc`` produced ``value`` into ``hd`` (output flag
        update, §3.2.2 — the *only* place the flag moves).

        Parent/fragment coherence: writing a fragmented parent propagates
        sliced copies + the flag to every fragment; writing a fragment
        marks its parent dirty, so a later whole-parent read gathers the
        fragments' bytes first (the task graph supplies the ordering,
        this supplies the data).
        """
        if hd.freed:
            raise AllocError("use after hete_free")
        with hd.lock:
            if loc == HOST and (hd.parent is not None or hd.fragments):
                # preserve the zero-copy host views linking parent and
                # fragments (rebinding would orphan them)
                np.copyto(hd.copies[HOST], np.asarray(value).reshape(hd.shape))
            else:
                if loc != HOST:
                    self._reserve(hd, loc)
                hd.copies[loc] = value
            hd.last_location = loc
            hd.valid_at = {loc}
            if loc != HOST:
                self._touch(hd.root, loc)
            if hd.parent is not None:
                hd.parent.frag_dirty = True
            if hd.fragments:
                self._propagate_to_fragments(hd, loc)
                hd.frag_dirty = False

    def _propagate_to_fragments(self, hd: HeteData, loc: Location) -> None:
        """A whole-parent write supersedes every fragment: move their
        flags to ``loc`` and hand each a slice of the new value (host
        views already alias the parent buffer)."""
        value = hd.copies[loc]
        step = int(hd.fragments[0].shape[0])
        for i, frag in enumerate(hd.fragments):
            with frag.lock:
                frag.last_location = loc
                frag.valid_at = {loc}
                if loc != HOST:
                    frag.copies[loc] = value[i * step : (i + 1) * step]

    def _gather_fragments(self, hd: HeteData) -> None:
        """Make a fragmented parent's host copy current by syncing every
        fragment through its zero-copy host view (direct device→host
        copies, recorded in the ledger), then flag the parent at HOST.
        Called under ``hd.lock`` before a whole-parent read."""
        for frag in hd.fragments:
            self.ensure(frag, HOST)
        hd.last_location = HOST
        hd.valid_at = {HOST}
        hd.frag_dirty = False


#: default module-level context, mirroring the paper's single-runtime setup
default_context = HeteContext()


def hete_malloc(shape, dtype=np.uint8, *, context: Optional[HeteContext] = None,
                spaces: Sequence[Location] = ()) -> HeteData:
    return (context or default_context).malloc(shape, dtype, spaces=spaces)


def hete_free(hd: HeteData, *, context: Optional[HeteContext] = None) -> None:
    (context or hd.context or default_context).free(hd)


def hete_sync(hd: HeteData, *, context: Optional[HeteContext] = None) -> np.ndarray:
    return (context or hd.context or default_context).sync(hd)
