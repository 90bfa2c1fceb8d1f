"""Interconnect topology — routed transfers over a link graph.

RIMMS's premise is that the *runtime* decides how bytes move between
heterogeneous memories.  Up to now the cost side of that decision was a
flat 3-bucket :class:`~repro_torch.core.locations.BandwidthModel`; real
platforms are *topologies*: PCIe trees with a shared root complex,
NVLink-style peer meshes, FPGAs reachable only through a host bridge.
This module models them:

* :class:`Link` — one directed edge: bandwidth, latency, and a per-link
  ``busy_until`` contention state in modeled time;
* :class:`Topology` — the interconnect graph over
  :class:`~repro_torch.core.locations.Location` nodes, with Dijkstra
  cheapest-path routing (:meth:`Topology.route`, cached) yielding
  multi-hop store-and-forward transfer plans, and
  :meth:`Topology.transfer` which walks a plan through per-link
  contention (a shared bridge link serializes concurrent transfers);
* :func:`build_preset` — named platform shapes: ``emulated_soc`` (flat,
  equal to the scalar model's defaults), ``pcie_tree`` (devices behind a
  shared switch), ``nvlink_mesh`` (all-pairs fast peer links),
  ``host_bridged_fpga`` (no peer links at all — device↔device bytes
  route through the host);
* :class:`TopologyBandwidthModel` — drop-in for the scalar model: the
  same ``seconds(src, dst, nbytes)`` interface (so the ledger, eviction
  cost ranking and HEFT all price transfers by *route*), plus
  ``hops()`` so :meth:`repro_torch.core.hete.HeteContext.stage` can record
  per-hop ledger traffic.

Routing between nodes the graph does not connect raises
:class:`TopologyError` — a mis-built platform should fail loudly, not
fall back to a made-up constant.  The scalar model remains the default
everywhere; a topology is opted into via
``make_emulated_soc(topology=...)``.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from .locations import HOST, Location

__all__ = [
    "TopologyError",
    "Link",
    "Topology",
    "TopologyBandwidthModel",
    "build_preset",
    "PRESETS",
]

#: reference transfer size for route selection: Dijkstra weights are the
#: per-hop seconds of moving this many bytes, so routes are chosen for
#: bulk traffic, not for the latency-dominated empty-transfer corner.
ROUTE_REF_BYTES = 1 << 20


class TopologyError(Exception):
    """No route between two locations (or an unknown location) in a
    :class:`Topology` — the platform graph does not connect them."""


@dataclasses.dataclass(frozen=True)
class Link:
    """One directed interconnect edge.

    ``bandwidth`` in bytes/second, ``latency_s`` seconds per transfer.
    ``name`` groups the two directions of a physical link for reporting
    (both directions of a PCIe lane pair share one name).
    """

    src: Location
    dst: Location
    bandwidth: float
    latency_s: float
    name: str

    def seconds(self, nbytes: int) -> float:
        """Uncontended service time for one transfer over this link."""
        return self.latency_s + nbytes / self.bandwidth

    @property
    def key(self) -> Tuple[str, str]:
        return (str(self.src), str(self.dst))

    @property
    def label(self) -> str:
        return f"{self.src}->{self.dst}"


class Topology:
    """Interconnect graph: Locations as nodes, :class:`Link` edges,
    cached cheapest-path routing, per-link contention state.

    Thread safety: route computation and contention state are guarded by
    one lock; the graph itself is append-only (``add_link`` invalidates
    the route cache).
    """

    def __init__(self, name: str = "custom") -> None:
        self.name = name
        self.nodes: set = set()
        self._adj: Dict[Location, List[Link]] = {}
        self._routes: Dict[Tuple[Location, Location], Tuple[Link, ...]] = {}
        self._busy: Dict[Tuple[str, str], float] = {}  # link key -> busy-until
        self._lock = threading.RLock()

    # -- construction -------------------------------------------------------
    def add_node(self, loc: Location) -> None:
        with self._lock:
            self.nodes.add(loc)
            self._adj.setdefault(loc, [])

    def add_link(
        self,
        a: Location,
        b: Location,
        *,
        bandwidth: float,
        latency_s: float = 5e-6,
        bidirectional: bool = True,
        name: Optional[str] = None,
    ) -> None:
        """Add a link ``a→b`` (and ``b→a`` unless ``bidirectional`` is
        False).  The two directions contend independently (full duplex),
        like the paper's platforms' DMA engines."""
        name = name or f"{a}<->{b}"
        with self._lock:
            self.add_node(a)
            self.add_node(b)
            self._adj[a].append(Link(a, b, bandwidth, latency_s, name))
            if bidirectional:
                self._adj[b].append(Link(b, a, bandwidth, latency_s, name))
            self._routes.clear()

    def links(self) -> List[Link]:
        with self._lock:
            return [l for adj in self._adj.values() for l in adj]

    # -- routing ------------------------------------------------------------
    def route(self, src: Location, dst: Location) -> Tuple[Link, ...]:
        """Cheapest path ``src→dst`` as a tuple of hops (empty when
        ``src == dst``).  Dijkstra over per-hop seconds at
        :data:`ROUTE_REF_BYTES`; deterministic tie-break on node names.
        Raises :class:`TopologyError` when no route exists."""
        if src == dst:
            return ()
        with self._lock:
            cached = self._routes.get((src, dst))
            if cached is not None:
                return cached
            if src not in self._adj or dst not in self.nodes:
                raise TopologyError(
                    f"no route {src} -> {dst}: "
                    f"{src if src not in self._adj else dst} is not a node of "
                    f"topology {self.name!r} (nodes: "
                    f"{sorted(str(n) for n in self.nodes)})"
                )
            # Dijkstra; entries (cost, node_name_for_ties, node, path)
            best: Dict[Location, float] = {src: 0.0}
            heap: List[tuple] = [(0.0, str(src), src, ())]
            while heap:
                cost, _, node, path = heapq.heappop(heap)
                if node == dst:
                    self._routes[(src, dst)] = path
                    return path
                if cost > best.get(node, float("inf")):
                    continue
                for link in self._adj.get(node, ()):
                    nxt = cost + link.seconds(ROUTE_REF_BYTES)
                    if nxt < best.get(link.dst, float("inf")):
                        best[link.dst] = nxt
                        heapq.heappush(
                            heap, (nxt, str(link.dst), link.dst, path + (link,))
                        )
            raise TopologyError(
                f"no route {src} -> {dst} in topology {self.name!r}: "
                f"the link graph does not connect them"
            )

    def seconds(self, src: Location, dst: Location, nbytes: int) -> float:
        """Uncontended store-and-forward seconds along the cheapest
        route (sum of per-hop seconds)."""
        return sum(l.seconds(nbytes) for l in self.route(src, dst))

    def plan(
        self, src: Location, dst: Location, nbytes: int
    ) -> List[Tuple[Link, float]]:
        """The routed transfer plan: ``[(hop, hop_seconds), ...]``."""
        return [(l, l.seconds(nbytes)) for l in self.route(src, dst)]

    # -- contention (modeled time) ------------------------------------------
    def reset_contention(self) -> None:
        with self._lock:
            self._busy.clear()

    def transfer(
        self,
        src: Location,
        dst: Location,
        nbytes: int,
        *,
        at: float = 0.0,
        commit: bool = True,
    ) -> Tuple[float, float, List[Tuple[Link, float, float]]]:
        """Walk the routed plan through per-link contention starting at
        modeled time ``at``.  Each hop begins when both the previous hop
        has delivered the bytes *and* the link is free (``busy_until``);
        with ``commit`` the link reservations stick, so a later transfer
        sharing a link queues behind this one — that is the serialization
        a shared host bridge imposes.  Returns ``(start, end, hops)``
        with ``hops = [(link, hop_start, hop_end), ...]``."""
        with self._lock:
            t = at
            first: Optional[float] = None
            hops: List[Tuple[Link, float, float]] = []
            for link in self.route(src, dst):
                s = max(t, self._busy.get(link.key, 0.0))
                e = s + link.seconds(nbytes)
                if commit:
                    self._busy[link.key] = e
                hops.append((link, s, e))
                if first is None:
                    first = s
                t = e
            return (at if first is None else first), t, hops

    def queue_delay(
        self, src: Location, dst: Location, nbytes: int, *, at: float = 0.0
    ) -> float:
        """Extra modeled seconds a transfer issued at ``at`` would wait
        on busy links beyond its uncontended service time (peek only)."""
        _, end, _ = self.transfer(src, dst, nbytes, at=at, commit=False)
        return max(0.0, (end - at) - self.seconds(src, dst, nbytes))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Topology({self.name!r}, nodes={len(self.nodes)}, "
            f"links={len(self.links())})"
        )


class TopologyBandwidthModel:
    """Routes transfer costs over a :class:`Topology` — a drop-in for
    :class:`~repro_torch.core.locations.BandwidthModel` (same ``seconds()``
    interface), so the ledger, eviction write-back ranking and HEFT
    placement all price transfers by route instead of by kind pair."""

    def __init__(self, topology: Topology) -> None:
        self.topology = topology

    def seconds(self, src: Location, dst: Location, nbytes: int) -> float:
        if src == dst:
            return 0.0
        return self.topology.seconds(src, dst, nbytes)

    def hops(self, src: Location, dst: Location) -> Tuple[Link, ...]:
        """The routed hop list (empty when src == dst).  The scalar
        model's counterpart returns ``None`` (single direct record)."""
        return self.topology.route(src, dst)

    def typical(self, nbytes: int) -> float:
        """Mean single-link seconds for ``nbytes`` — the topology
        analogue of the scalar model's host↔device estimate, used for
        HEFT's placement-agnostic communication term."""
        links = self.topology.links()
        if not links:
            return 0.0
        lat = sum(l.latency_s for l in links) / len(links)
        inv_bw = sum(1.0 / l.bandwidth for l in links) / len(links)
        return lat + nbytes * inv_bw


# ---------------------------------------------------------------------------
# Named presets — the platform shapes the paper's targets span
# ---------------------------------------------------------------------------


def _emulated_soc(devices: Sequence[Location], host: Location) -> Topology:
    """Flat SoC: every device one hop from host, fast direct peer DMA —
    numerically identical to the scalar BandwidthModel's defaults."""
    topo = Topology("emulated_soc")
    for d in devices:
        topo.add_link(host, d, bandwidth=20e9, latency_s=5e-6,
                      name=f"dma:{d.name}")
    for i, a in enumerate(devices):
        for b in devices[i + 1:]:
            topo.add_link(a, b, bandwidth=100e9, latency_s=5e-6,
                          name=f"p2p:{a.name}-{b.name}")
    return topo


def _pcie_tree(devices: Sequence[Location], host: Location) -> Topology:
    """PCIe tree: all devices behind one switch; the host↔switch uplink
    is shared by every host-bound transfer (the contention hot spot),
    and peer traffic turns around at the switch without touching it."""
    topo = Topology("pcie_tree")
    bridge = Location("bridge", "pcie0")
    topo.add_link(host, bridge, bandwidth=25e9, latency_s=2e-6,
                  name="pcie:uplink")
    for d in devices:
        topo.add_link(bridge, d, bandwidth=12e9, latency_s=3e-6,
                      name=f"pcie:{d.name}")
    return topo


def _nvlink_mesh(devices: Sequence[Location], host: Location) -> Topology:
    """NVLink-style peer mesh: modest host links, fast low-latency
    direct links between every device pair."""
    topo = Topology("nvlink_mesh")
    for d in devices:
        topo.add_link(host, d, bandwidth=20e9, latency_s=5e-6,
                      name=f"pcie:{d.name}")
    for i, a in enumerate(devices):
        for b in devices[i + 1:]:
            topo.add_link(a, b, bandwidth=100e9, latency_s=2e-6,
                          name=f"nvlink:{a.name}-{b.name}")
    return topo


def _host_bridged_fpga(devices: Sequence[Location], host: Location) -> Topology:
    """Host-bridged FPGA fabric (ZCU102-style UDMA): slow high-latency
    host links and *no* peer links — device↔device bytes must route
    through the host, so both host links serialize under contention."""
    topo = Topology("host_bridged_fpga")
    for d in devices:
        topo.add_link(host, d, bandwidth=6e9, latency_s=20e-6,
                      name=f"udma:{d.name}")
    return topo


PRESETS = {
    "emulated_soc": _emulated_soc,
    "pcie_tree": _pcie_tree,
    "nvlink_mesh": _nvlink_mesh,
    "host_bridged_fpga": _host_bridged_fpga,
}


def build_preset(
    name: str,
    devices: Iterable[Union[Location, str]],
    *,
    host: Location = HOST,
) -> Topology:
    """Instantiate a named preset over ``devices`` (Locations, or bare
    names which become ``Location("device", name)``)."""
    try:
        builder = PRESETS[name]
    except KeyError:
        raise TopologyError(
            f"unknown topology preset {name!r} (have: {sorted(PRESETS)})"
        ) from None
    locs = [
        d if isinstance(d, Location) else Location("device", d)
        for d in devices
    ]
    return builder(locs, host)
