"""Stable public namespace for the RIMMS runtime on PyTorch.

``import repro_torch.rimms as rimms`` is the supported surface for user
code: the streaming session API, the op/variant registry, calibration
and autotuning, platform registration, and the public exception types.
Internal module layout (``repro_torch.core.*``) may shift; names
re-exported here — everything in ``__all__`` — stay put.

    import repro_torch.rimms as rimms

    @rimms.op("fft", kinds=("cpu",))
    def my_fft(ins): ...

    with rimms.Session.emulated(n_cpu=2) as session:   # accelerators on CUDA
        table = rimms.autotune(session)       # measured variant winners
        session.save_calibration("calib.json")
    session = rimms.Session.emulated(calibration="calib.json")
"""

from __future__ import annotations

from repro_torch.core.allocator import AllocError
from repro_torch.core.api import (
    BufferFuture, OpRegistry, OpVariant, Session, SessionClient,
    SessionClosedError, default_registry, op,
)
from repro_torch.core.autotune import (
    Tunable, autotune, register_tunables, tunables,
)
from repro_torch.core.calibrate import (
    DEFAULT_VARIANT, CalibrationTable, calibrate, heft_plan,
    resolve_calibration, simulate_plan,
)
from repro_torch.core.graph import CostModel
from repro_torch.core.locations import HOST, Location
from repro_torch.core.pworker import WorkerDied
from repro_torch.core.qos import BackpressureFull, QuotaExceeded
from repro_torch.core.runtime import (
    BACKENDS, platform_names, register_platform, resolve_backend,
)

__all__ = [
    # streaming session API
    "Session", "SessionClient", "SessionClosedError", "BufferFuture",
    # op/variant registry
    "op", "OpRegistry", "OpVariant", "default_registry", "DEFAULT_VARIANT",
    # calibration + autotuning
    "CalibrationTable", "calibrate", "resolve_calibration", "autotune",
    "register_tunables", "tunables", "Tunable", "heft_plan",
    "simulate_plan", "CostModel",
    # platforms / backends
    "register_platform", "platform_names", "BACKENDS", "resolve_backend",
    "HOST", "Location",
    # public exception types
    "AllocError", "QuotaExceeded", "BackpressureFull", "WorkerDied",
]
