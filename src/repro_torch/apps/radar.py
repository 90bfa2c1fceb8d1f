"""The paper's radar signal-processing applications (§4.2–4.3) on the
RIMMS runtime: 2FFT, 2FZF, 3ZIP reference chains and the real-world
RC / PD / SAR workloads.

Every app builds (buffers, tasks) against a :class:`HeteContext`; the
caller runs them under a :class:`Runtime` with either the ``reference``
(host-owned) or ``rimms`` memory policy — the paper's comparisons fall
out of the transfer ledger.

PE kernels: numpy on the CPU PE; on accelerator PEs the hand-written
CUDA FFT and ZIP kernels (:mod:`repro_torch.kernels.fft`,
:mod:`repro_torch.kernels.zip`) over the PE's tensors — their plain torch
versions when the caller asked for the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core import api as rimms
from repro_torch.core.api import Session
from repro_torch.core.hete import HeteContext, HeteData
from repro_torch.core.runtime import (Runtime, Task, make_emulated_soc,
                                      resolve_device)
from repro_torch.kernels import _build
from repro_torch.kernels.fft import ops as fft_ops
from repro_torch.kernels.zip import ops as zip_ops

__all__ = [
    "register_kernels", "build_2fft", "build_2fzf", "build_3zip",
    "build_rc", "build_pd", "build_sar", "make_runtime", "make_session",
    "run_pipeline", "submit_2fzf",
]

C64 = np.complex64


# ---------------------------------------------------------------------------
# PE kernels — registered as per-kind op variants: importing
# this module fills the default registry, so `Session.emulated()` (and
# `register_kernels` for batch runtimes) get the radar op set.
# ---------------------------------------------------------------------------


# Calibration input factories: representative inputs at a
# requested total byte size, so `session.calibrate()` can measure the
# radar ops' real kernels per PE kind.
def _calib_single_c64(rng, nbytes):
    n = max(nbytes // 8, 1)
    return [(rng.standard_normal(n)
             + 1j * rng.standard_normal(n)).astype(C64)]


def _calib_pair_c64(rng, nbytes):
    n = max(nbytes // 16, 1)
    return [(rng.standard_normal(n)
             + 1j * rng.standard_normal(n)).astype(C64) for _ in range(2)]


@rimms.op("fft", kinds=("cpu",), calib=_calib_single_c64)
def _fft_cpu(ins):
    return np.fft.fft(ins[0], axis=-1).astype(C64)


@rimms.op("ifft", kinds=("cpu",), calib=_calib_single_c64)
def _ifft_cpu(ins):
    return np.fft.ifft(ins[0], axis=-1).astype(C64)


@rimms.op("zip", kinds=("cpu",), calib=_calib_pair_c64)
def _zip_cpu(ins):
    return (ins[0] * ins[1]).astype(C64)


@rimms.op("fft", kinds=("acc", "gpu"))
def _fft_device(ins):
    return fft_ops.fft(ins[0])


@rimms.op("ifft", kinds=("acc", "gpu"))
def _ifft_device(ins):
    return fft_ops.fft(ins[0], forward=False)


@rimms.op("zip", kinds=("acc", "gpu"))
def _zip_device(ins):
    return zip_ops.zip_mul(ins[0], ins[1])


def _build_kernels(device) -> None:
    """Build the CUDA kernels before a GPU runtime exists, so the first
    timed task never pays for nvcc (its time would poison the cost
    model's observations)."""
    if resolve_device(device).type == "cuda":
        _build.library()


def register_kernels(rt: Runtime) -> None:
    """Install the radar op registry into a batch runtime (compat shim —
    sessions install the registry themselves)."""
    rimms.default_registry.install(rt)


def make_runtime(*, policy: str, scheduler: str = "round_robin",
                 n_cpu: int = 1, accelerators: Sequence[str] = ("gpu0",),
                 allocator: str = "nextfit", tracking: str = "flag",
                 backend: Optional[str] = None, device=None):
    """Build (Runtime, HeteContext) for an emulated SoC.  ``scheduler``
    may be any of :data:`repro_torch.core.runtime.SCHEDULERS`, including the
    transfer-aware ``"heft"`` used by the graph executor; ``backend``
    is the kernel-execution backend (thread | process | auto); ``device`` is
    where accelerator spaces live (``None``: CUDA, ``"cpu"``: CPU
    tensors)."""
    _build_kernels(device)
    pes, ctx = make_emulated_soc(
        n_cpu=n_cpu, accelerators=tuple(accelerators), allocator=allocator,
        tracking=tracking, backend=backend, device=device,
    )
    rt = Runtime(pes, ctx, policy=policy, scheduler=scheduler,
                 backend=backend)
    register_kernels(rt)
    return rt, ctx


def make_session(*, policy: str = "rimms", scheduler: str = "heft",
                 n_cpu: int = 1, accelerators: Sequence[str] = ("gpu0",),
                 device=None, **kwargs) -> Session:
    """A streaming :class:`Session` over an emulated SoC with the radar
    op registry installed — the primary entry point for radar apps
    (``session.context`` / ``session.runtime`` expose the lower
    layers)."""
    _build_kernels(device)
    return Session.emulated(
        policy=policy, scheduler=scheduler, n_cpu=n_cpu,
        accelerators=tuple(accelerators), device=device, **kwargs,
    )


def run_pipeline(rt: Runtime, tasks, *, mode: str = "serial",
                 scheduler: Optional[str] = None) -> float:
    """Execute a built task list either serially (CEDR-style submission
    order) or on the async task-graph executor (automatic DAG, per-PE
    queues, transfer/compute overlap).  Returns wall seconds."""
    # internal calls go through the private impls: the DeprecationWarning
    # on run/run_graph is for user code migrating to Session, not for the
    # compat helpers themselves
    if mode == "serial":
        return rt._run_impl(tasks)
    if mode == "graph":
        return rt._run_graph_impl(tasks, scheduler=scheduler)
    raise ValueError(f"unknown execution mode {mode!r} (serial|graph)")


def _fill(hd: HeteData, rng: np.random.Generator) -> None:
    hd.copies[list(hd.copies)[0]][...] = (
        rng.normal(size=hd.shape) + 1j * rng.normal(size=hd.shape)
    ).astype(C64)


# ---------------------------------------------------------------------------
# reference chains (Fig 4)
# ---------------------------------------------------------------------------


def build_2fft(ctx: HeteContext, n: int, *, pins=(None, None), seed=0):
    """FFT → IFFT (Fig 4a)."""
    rng = np.random.default_rng(seed)
    x = ctx.malloc((n,), C64)
    mid = ctx.malloc((n,), C64)
    out = ctx.malloc((n,), C64)
    _fill(x, rng)
    tasks = [
        Task("fft", [x], [mid], pin=pins[0], name="fft0"),
        Task("ifft", [mid], [out], pin=pins[1], name="ifft0"),
    ]
    return {"in": x, "mid": mid, "out": out}, tasks


def build_2fzf(ctx: HeteContext, n: int, *, pins=(None,) * 4, seed=0):
    """FFT, FFT → ZIP → IFFT (Fig 4b); the two FFTs run sequentially to
    isolate memory effects (paper §5.2)."""
    rng = np.random.default_rng(seed)
    a, b = ctx.malloc((n,), C64), ctx.malloc((n,), C64)
    fa, fb = ctx.malloc((n,), C64), ctx.malloc((n,), C64)
    z, out = ctx.malloc((n,), C64), ctx.malloc((n,), C64)
    _fill(a, rng)
    _fill(b, rng)
    tasks = [
        Task("fft", [a], [fa], pin=pins[0], name="fftA"),
        Task("fft", [b], [fb], pin=pins[1], name="fftB"),
        Task("zip", [fa, fb], [z], pin=pins[2], name="zip"),
        Task("ifft", [z], [out], pin=pins[3], name="ifft"),
    ]
    return {"a": a, "b": b, "out": out}, tasks


def submit_2fzf(session: Session, n: int, *, pins=(None,) * 4, seed=0,
                tag=""):
    """The 2FZF chain (Fig 4b) through the streaming session API: four
    submissions, zero explicit sync — ``out.result()`` is the only sync
    point.  ``tag`` disambiguates task names when many clients submit
    chains against one session (bench_stream)."""
    rng = np.random.default_rng(seed)
    a, b = session.malloc((n,), C64), session.malloc((n,), C64)
    _fill(a.hete, rng)
    _fill(b.hete, rng)
    fa = session.submit("fft", [a], pin=pins[0], name=f"fftA{tag}")
    fb = session.submit("fft", [b], pin=pins[1], name=f"fftB{tag}")
    z = session.submit("zip", [fa, fb], pin=pins[2], name=f"zip{tag}")
    out = session.submit("ifft", [z], pin=pins[3], name=f"ifft{tag}")
    return {"a": a, "b": b, "fa": fa, "fb": fb, "z": z, "out": out}


def build_3zip(ctx: HeteContext, n: int, *, pins=(None,) * 3, seed=0):
    """ZIP, ZIP → ZIP (Fig 4c)."""
    rng = np.random.default_rng(seed)
    bufs = [ctx.malloc((n,), C64) for _ in range(4)]
    for hd in bufs:
        _fill(hd, rng)
    x, y, out = (ctx.malloc((n,), C64) for _ in range(3))
    tasks = [
        Task("zip", [bufs[0], bufs[1]], [x], pin=pins[0], name="zip0"),
        Task("zip", [bufs[2], bufs[3]], [y], pin=pins[1], name="zip1"),
        Task("zip", [x, y], [out], pin=pins[2], name="zip2"),
    ]
    return {"ins": bufs, "out": out}, tasks


# ---------------------------------------------------------------------------
# real-world applications (§4.3): RC, PD, SAR
# ---------------------------------------------------------------------------


def build_rc(ctx: HeteContext, *, seed=0):
    """Radar Correlator: 2FZF data flow at 256 samples (paper §5.4)."""
    return build_2fzf(ctx, 256, seed=seed)


def _parallel_fzf(ctx, ways: int, n: int, *, use_fragment: bool, seed=0):
    """``ways`` parallel (FFT, FFT→ZIP→IFFT) instances of size n —
    the PD/SAR phase structure.  With ``use_fragment`` every data point
    is ONE hete_malloc fragmented ``ways`` times (§3.2.3); otherwise
    ``ways`` separate allocations per data point."""
    rng = np.random.default_rng(seed)

    def alloc_point():
        if use_fragment:
            parent = ctx.malloc((ways * n,), C64)
            parent.fragment(n)
            return parent, [parent[i] for i in range(ways)]
        parents = [ctx.malloc((n,), C64) for _ in range(ways)]
        return None, parents

    points = {name: alloc_point() for name in
              ("a", "b", "fa", "fb", "z", "out")}
    for name in ("a", "b"):
        for frag in points[name][1]:
            _fill(frag, rng)
    tasks = []
    for i in range(ways):
        a, b = points["a"][1][i], points["b"][1][i]
        fa, fb = points["fa"][1][i], points["fb"][1][i]
        z, out = points["z"][1][i], points["out"][1][i]
        tasks += [
            Task("fft", [a], [fa], name=f"fftA{i}"),
            Task("fft", [b], [fb], name=f"fftB{i}"),
            Task("zip", [fa, fb], [z], name=f"zip{i}"),
            Task("ifft", [z], [out], name=f"ifft{i}"),
        ]
    return points, tasks


def build_pd(ctx: HeteContext, *, ways: int = 128, n: int = 128,
             use_fragment: bool = True, seed=0):
    """Pulse Doppler: 128 parallel 2FZF instances at 128 samples
    (paper §5.4 / Fig 9)."""
    return _parallel_fzf(ctx, ways, n, use_fragment=use_fragment, seed=seed)


def build_sar(ctx: HeteContext, *, use_fragment: bool = True, seed=0,
              scale: int = 1):
    """SAR: phase 1 = 512-way FZF at 256 samples; phase 2 = 256-way FZF
    at 512 samples.  ``scale`` divides the way-counts for quick runs."""
    p1, t1 = _parallel_fzf(ctx, 512 // scale, 256,
                           use_fragment=use_fragment, seed=seed)
    p2, t2 = _parallel_fzf(ctx, 256 // scale, 512,
                           use_fragment=use_fragment, seed=seed + 1)
    return {"phase1": p1, "phase2": p2}, t1 + t2
