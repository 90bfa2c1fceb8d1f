"""Locations — where a logical buffer's bytes may live.

The paper's ``hete_Data`` keeps one *resource pointer* per memory region
(host DDR, GPU global memory, FPGA UDMA buffer).  On a PyTorch platform the
analogous set of regions is:

* ``host``     — host RAM (numpy arrays; the pipeline / CPU-PE side),
* ``device``   — a single accelerator's memory (a CUDA device's, or CPU
  tensors when the caller asks for the CPU),
* ``mesh``     — device memory *under a particular named sharding* — two
  different shardings of the same logical array are different locations,
  because moving between them costs collective traffic exactly like a
  host↔device copy costs PCIe/DMA traffic.

A :class:`Location` is a hashable identity; the payload representation per
location is managed by :mod:`repro_torch.core.hete`.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Location", "HOST", "BandwidthModel", "DEFAULT_BANDWIDTH_MODEL"]


@dataclasses.dataclass(frozen=True)
class Location:
    """Identity of one memory region.

    ``kind``  — coarse class: "host" | "device" | "mesh".
    ``name``  — unique name within the kind ("gpu0", "fft_acc1", ...).
    """

    kind: str
    name: str

    def __str__(self) -> str:  # compact for ledgers / logs
        return f"{self.kind}:{self.name}"


HOST = Location("host", "cpu")


@dataclasses.dataclass(frozen=True)
class BandwidthModel:
    """Models transfer cost between location kinds (for modeled-time
    reporting on the emulated SoC — measured wall time is reported too).

    Bandwidths in bytes/second, latency in seconds per transfer. Defaults
    approximate the paper's platforms (Jetson AGX PCIe-class host↔device
    link; direct device↔device DMA).
    """

    host_device_bw: float = 20e9  # ~PCIe4 x8 effective
    device_device_bw: float = 100e9  # on-SoC DMA / NVLink-class
    host_host_bw: float = 50e9
    latency_s: float = 5e-6

    def seconds(self, src: Location, dst: Location, nbytes: int) -> float:
        if src == dst:
            return 0.0
        if src.kind == "host" and dst.kind == "host":
            bw = self.host_host_bw
        elif src.kind == "host" or dst.kind == "host":
            bw = self.host_device_bw
        else:
            bw = self.device_device_bw
        return self.latency_s + nbytes / bw

    def hops(self, src: Location, dst: Location) -> None:
        """Routed hop list for a src→dst copy.  The scalar model has no
        topology: ``None`` means "record one direct hop".  The
        interconnect-aware counterpart
        (:class:`repro_torch.core.topology.TopologyBandwidthModel`) returns
        the actual route."""
        return None

    def typical(self, nbytes: int) -> float:
        """Placement-agnostic single-transfer estimate (HEFT's
        communication term): the host↔device link."""
        return self.latency_s + nbytes / self.host_device_bw


DEFAULT_BANDWIDTH_MODEL = BandwidthModel()
