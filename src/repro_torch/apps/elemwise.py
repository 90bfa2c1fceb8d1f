"""Elementwise kernels — backend-parity fixtures (the port of
``repro.apps.elemwise``).

``@rimms.op`` kernels registered for every PE kind.  The cpu kind is
pure numpy, as in the reference, and bit-deterministic by construction.
Accelerator kinds (``acc``, ``gpu``) hold torch tensors — ``np.asarray``
of a CUDA tensor raises — so their variants run the same arithmetic in
torch ops on the PE's tensor and return a tensor on its device:
``scale``, ``axpy`` and ``square`` give numpy's bits (one IEEE operation
per element, in the same order); ``csum`` (a float64 cumulative sum) is
a parallel scan on the card and agrees with numpy's sequential sum to a
tolerance, not bit for bit.

Module-level functions only, as in the reference (its process backend
ships kernels by pickle reference).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import op

KINDS = ("cpu", "acc", "gpu")
DEVICE_KINDS = ("acc", "gpu")


@op("scale", kinds="cpu")
def scale(ins, *, factor: float = 2.0):
    return np.asarray(ins[0]) * factor


@op("scale", kinds=DEVICE_KINDS)
def scale_device(ins, *, factor: float = 2.0):
    return ins[0] * factor


@op("axpy", kinds="cpu")
def axpy(ins, *, alpha: float = 1.0):
    return alpha * np.asarray(ins[0]) + np.asarray(ins[1])


@op("axpy", kinds=DEVICE_KINDS)
def axpy_device(ins, *, alpha: float = 1.0):
    return alpha * ins[0] + ins[1]


@op("square", kinds="cpu")
def square(ins):
    return np.square(np.asarray(ins[0]))


@op("square", kinds=DEVICE_KINDS)
def square_device(ins):
    return ins[0] * ins[0]


@op("csum", kinds="cpu")
def csum(ins):
    return np.cumsum(np.asarray(ins[0]), dtype=np.float64)


@op("csum", kinds=DEVICE_KINDS)
def csum_device(ins):
    return torch.cumsum(ins[0].reshape(-1), 0, dtype=torch.float64)


@op("snooze", kinds="cpu")
def snooze(ins, *, seconds: float = 0.05):
    """Sleep then pass through — wall-clock overlap fixtures."""
    import time

    time.sleep(seconds)
    return np.asarray(ins[0])


@op("snooze", kinds=DEVICE_KINDS)
def snooze_device(ins, *, seconds: float = 0.05):
    """Sleep then pass a copy through (the output never aliases the
    input's device tensor)."""
    import time

    time.sleep(seconds)
    return ins[0].clone()


@op("boom", kinds=KINDS)
def boom(ins):
    """Deterministic failure — exception-propagation fixtures."""
    raise ValueError("boom kernel always fails")


@op("die", kinds=KINDS)
def die(ins):
    """Kill the executing process — worker-death fixtures.  On the
    thread backend this would kill the whole interpreter, so it is only
    for a process backend (not ported: ROADMAP A6), never run here."""
    import os

    os._exit(17)
