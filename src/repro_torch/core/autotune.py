"""Launch-parameter autotuning of the hand-written kernels.

Every kernel in :mod:`repro_torch.kernels` takes its launch geometry as
a parameter (``block_rows``, ``block_q``, ``chunk``, ``block_lanes``).
This module turns those parameters into **measured choices**: each
candidate value registers as a named :class:`~repro_torch.core.api.OpRegistry`
variant of a runtime op, :func:`~repro_torch.core.calibrate.calibrate`
races the variants per (op, PE kind, shape bucket) and records the
winner in the :class:`~repro_torch.core.calibrate.CalibrationTable`,
and :meth:`Runtime._select_kernel <repro_torch.core.runtime.Runtime>`
dispatches the winning variant — **only** if its outputs measured
bit-identical to the default variant's (``mlstm``'s ``chunk`` changes
accumulation order, so its candidates are measured but can never win;
``fft``/``zip`` row tiles, ``flash_attention``'s ``block_q`` and
``rg_lru``'s lane tile are pure launch parameters and stay bit-exact).

The tuned ops register under their own names (``fft_pallas``,
``zip_pallas``, ``flash_attention``, ``mlstm``, ``rg_lru``) — the names
the calibration tables of the reference use, so a table measured by
either package dispatches the same variants in the other.  On a ``gpu``
or ``acc`` PE an op receives CUDA tensors and runs the CUDA kernel; on
a ``cpu`` PE it receives host arrays and runs the same wrapper on CPU
tensors (the kernel's plain torch version), returning host arrays.

Usage::

    session = rimms.Session.emulated(...)
    table = rimms.autotune(session)       # register + race + attach
    table.save("calib.json")              # later: Session(calibration=...)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .calibrate import DEFAULT_LADDER, CalibrationTable, calibrate

__all__ = ["Tunable", "tunables", "register_tunables", "autotune",
           "tuned_summary", "TUNED_KINDS"]

#: PE kinds the tuned ops register for — a cpu PE runs the kernels'
#: plain versions on host tensors, gpu/acc PEs the CUDA kernels.
TUNED_KINDS = ("cpu", "gpu", "acc")


@dataclasses.dataclass(frozen=True)
class Tunable:
    """One autotunable launch parameter of one runtime op."""

    op: str                      # registry op name ("fft_pallas", ...)
    param: str                   # kernel kwarg ("block_rows", ...)
    default: Any                 # the kernel's default value
    candidates: Tuple[Any, ...]  # non-default values to race
    fn: Callable                 # runtime kernel: fn(ins, **params)
    make_inputs: Callable        # (rng, nbytes) -> [np.ndarray, ...]
    bit_identical: bool = True   # expected — calibrate() verifies


def _variant_name(param: str, value: Any) -> str:
    return f"{param}{value}"


# -- runtime kernel wrappers (ins list -> outs tuple, like every other
# registered kernel; launch params arrive as kwargs from the variant) --


def _tensors(ins) -> Tuple[List[torch.Tensor], bool]:
    """The inputs as tensors, and whether they came as host arrays (a
    cpu PE's operands: they become CPU tensors, copied, since the host
    space rewrites its arrays in place)."""
    host = not isinstance(ins[0], torch.Tensor)
    if host:
        return [torch.tensor(np.asarray(a)) for a in ins], True
    return list(ins), False


def _outs(outs, host: bool) -> tuple:
    return tuple(o.numpy() for o in outs) if host else tuple(outs)


def _fft_pallas_kernel(ins, *, block_rows: int = 8):
    from repro_torch.kernels.fft.ops import fft

    ts, host = _tensors(ins)
    return _outs([fft(ts[0], block_rows=block_rows)], host)


def _zip_pallas_kernel(ins, *, block_rows: int = 256):
    from repro_torch.kernels.zip.ops import zip_mul

    ts, host = _tensors(ins)
    return _outs([zip_mul(ts[0], ts[1], block_rows=block_rows)], host)


def _flash_attention_kernel(ins, *, block_q: int = 256, block_k: int = 256):
    from repro_torch.kernels.flash_attention.ops import flash_attention

    ts, host = _tensors(ins)
    return _outs([flash_attention(ts[0], ts[1], ts[2], block_q=block_q,
                                  block_k=block_k)], host)


def _mlstm_kernel(ins, *, chunk: int = 64):
    from repro_torch.kernels.mlstm.ops import mlstm_chunkwise

    ts, host = _tensors(ins)
    return _outs([mlstm_chunkwise(ts[0], ts[1], ts[2], ts[3], ts[4],
                                  chunk=chunk)], host)


def _rg_lru_kernel(ins, *, block_lanes: int = 128):
    from repro_torch.kernels.rg_lru.ops import rg_lru_scan

    ts, host = _tensors(ins)
    return _outs(rg_lru_scan(ts[0], ts[1], ts[2], block_lanes=block_lanes),
                 host)


# -- input factories (rng, nbytes -> representative inputs); the same
# draws as the reference's, so one seed gives byte-identical arrays ----


def _c64(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def _fft_inputs(rng, nbytes: int) -> List[np.ndarray]:
    rows = max(nbytes // (8 * 1024), 1)
    return [_c64(rng, (rows, 1024))]


def _zip_inputs(rng, nbytes: int) -> List[np.ndarray]:
    n = max(nbytes // 16, 128)
    return [_c64(rng, (n,)), _c64(rng, (n,))]


def _flash_inputs(rng, nbytes: int) -> List[np.ndarray]:
    # q,k,v: (1, S, 4, 64) f32 — S a multiple of 512 so every block_q
    # candidate tiles it exactly
    s = max((nbytes // (3 * 4 * 64 * 4)) // 512 * 512, 512)
    shape = (1, s, 4, 64)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _mlstm_inputs(rng, nbytes: int) -> List[np.ndarray]:
    # q,k,v: (1, S, 2, 64); gates (1, S, 2) — S a multiple of 128 so
    # every chunk candidate divides it
    s = max((nbytes // (3 * 2 * 64 * 4)) // 128 * 128, 128)
    qkv = [rng.standard_normal((1, s, 2, 64)).astype(np.float32)
           for _ in range(3)]
    i_gate = rng.standard_normal((1, s, 2)).astype(np.float32)
    log_f = -np.abs(rng.standard_normal((1, s, 2))).astype(np.float32)
    return qkv + [i_gate, log_f]


def _rg_lru_inputs(rng, nbytes: int) -> List[np.ndarray]:
    # a,b: (1, S, 512); h0: (1, 512) — D=512 admits every lane candidate
    d = 512
    s = max(nbytes // (2 * d * 4), 8)
    a = rng.uniform(0.5, 0.99, (1, s, d)).astype(np.float32)
    b = rng.standard_normal((1, s, d)).astype(np.float32)
    h0 = rng.standard_normal((1, d)).astype(np.float32)
    return [a, b, h0]


def tunables() -> List[Tunable]:
    """The autotuning search space: every kernel launch parameter, its
    default, and the candidate values to race."""
    return [
        Tunable("fft_pallas", "block_rows", 8, (32, 128),
                _fft_pallas_kernel, _fft_inputs),
        Tunable("zip_pallas", "block_rows", 256, (1024, 4096),
                _zip_pallas_kernel, _zip_inputs),
        Tunable("flash_attention", "block_q", 256, (128, 512),
                _flash_attention_kernel, _flash_inputs),
        Tunable("mlstm", "chunk", 64, (32, 128),
                _mlstm_kernel, _mlstm_inputs, bit_identical=False),
        Tunable("rg_lru", "block_lanes", 128, (256, 512),
                _rg_lru_kernel, _rg_lru_inputs),
    ]


def register_tunables(registry=None, *, kinds: Sequence[str] = TUNED_KINDS,
                      replace: bool = False) -> List[str]:
    """Register every tunable op (default + candidate variants + calib
    input factory) on ``registry`` (default: the process registry).
    Returns the op names, for ``calibrate(ops=...)``.  Idempotent with
    ``replace=True``."""
    if registry is None:
        from .api import default_registry as registry  # noqa: N813
    names = []
    for t in tunables():
        names.append(t.op)
        for kind in kinds:
            registry.register(t.op, kind, t.fn, params={t.param: t.default},
                              calib=t.make_inputs, replace=replace)
            for value in t.candidates:
                registry.register(t.op, kind, t.fn,
                                  variant=_variant_name(t.param, value),
                                  params={t.param: value}, replace=replace)
    return names


def autotune(session, *, nbytes: Sequence[int] = DEFAULT_LADDER, k: int = 5,
             warmup: int = 2, seed: int = 0,
             table: Optional[CalibrationTable] = None,
             install: bool = True, verbose: bool = False,
             extra_ops: Sequence[str] = ()) -> CalibrationTable:
    """Race every launch-parameter candidate on ``session``'s runtime,
    record winners, and attach the resulting calibration table so
    subsequent dispatch uses them.

    ``install=True`` (default) also installs the tuned ops' kernels into
    the runtime (missing-only) so ``session.submit("fft_pallas", ...)``
    dispatches the measured winner.  ``extra_ops`` adds already-
    registered ops (e.g. the radar app's ``fft``/``zip``) to the same
    calibration pass.
    """
    reg = getattr(session, "registry", None)
    if reg is None:
        from .api import default_registry as reg  # noqa: N813
    ops = register_tunables(reg, replace=True)
    if install:
        reg.install(session.runtime, missing_only=True,
                    extend_supports=("cpu", "gpu"))
    tab = calibrate(session, registry=reg, ops=list(ops) + list(extra_ops),
                    nbytes=nbytes, k=k, warmup=warmup, seed=seed,
                    table=table, verbose=verbose)
    tab.meta.setdefault("autotuned_ops", sorted(ops))
    session.calibration = tab
    session.runtime.set_calibration(tab)
    return tab


def tuned_summary(table: CalibrationTable) -> Dict[str, Dict[str, Any]]:
    """Winner rows for the tuned ops only — ``{op/kind/bucket: winner}``
    (what ``bench_calibrate`` and the CLI report print)."""
    tuned = {t.op for t in tunables()}
    return {key: dict(win) for key, win in table.winners()
            if key.split("/", 1)[0] in tuned}
