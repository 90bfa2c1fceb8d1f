"""Drive the PyTorch/CUDA port of RIMMS on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on a failed check:

1. card — the GPU's name and power limit (``nvidia-smi``);
2. build — compiles ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a);
3. kernels — every CUDA kernel against its plain torch version on the
   card: FFT at every power of two from 2 to 2^20 (1, 3, 128 and 1024
   rows up to 8192, one launch; 1, 3 and 128 up to 65536 and 1 and 3
   above, the four-step passes), forward and inverse (and against
   ``torch.fft``), ZIP across the
   radar path's shapes, both at fragments' storage offsets (odd ones
   too, and ZIP operands at different 16-byte phases), inputs unwritten
   and ``block_rows`` bit-identical; flash attention, RG-LRU
   and mLSTM at the reference's test shapes and tolerances
   (``tests/test_kernels.py``), at the widths of the repo's model
   configs (llama3-8b, recurrentgemma-2b, xlstm-350m) and at the
   autotuning ladder's top rung, with ``block_q`` and ``block_lanes``
   bit-identical, the RG-LRU bit-equal to its plain chunked scan, the
   mLSTM's chunk candidates 32/64/128 within 2e-3 of plain at both
   widths, inputs unwritten, and plain TF32's error per mLSTM product;
4. timing — each kernel, its plain version and the one-call PyTorch
   equivalent where there is one (CUDA events, device time from
   ``torch.profiler``), beside the least time the card could take
   (bytes, or operations at the peak for the input type); FFT and ZIP
   at the radar path's one-row sizes (and FFT at 8192, 1024 rows of
   1024, and one row of 16384, 32768 and 2^20, 128 rows of 16384 and 64
   of 65536: the four-step's two launches) with, for the kernel and the library call alike, the latency
   of one call and a synchronise (what a runtime task pays), the host's
   enqueue time and the device time; the mLSTM and RG-LRU at the model
   width and the ladder's top rung, device time summed over every
   kernel of a call, beside the bound (the mLSTM's for split TF32, with
   the FP32 and plain TF32 bounds) and the autotuning path's launches
   at that shape (phase 7);
5. main path — the paper's radar evaluation (2FFT, 2FZF, 3ZIP, RC, PD,
   SAR, and a streaming Session) under the ``reference`` and ``rimms``
   memory policies on ``cuda:0``, checked against numpy's FFT chain and
   the paper's copy counts; each record logs the runtime's measured
   compute seconds per fft/ifft/zip task (its cost model's
   observations) beside the wall and the kernel share;
6. launch counts — every FFT/IFFT and ZIP task placed on a GPU PE in
   phase 5 launched its kernel exactly once;
7. autotuning path — ``repro_torch.rimms.autotune`` on a session with a
   ``gpu0`` PE over the default ladder, then every tuned op
   (``fft_pallas``, ``zip_pallas``, ``flash_attention``, ``mlstm``,
   ``rg_lru``) at every rung dispatched to ``gpu0``: the runtime must
   pick the table's winner, match the default variant bit for bit and
   the plain version within tolerance, and launch one kernel per task;
   then ``python -m repro_torch.calibrate run`` (one rung) and ``show``;
8. serving path — llama3-8b at full width (32 layers, bf16, random
   weights from ``Model.init`` with a seeded generator on ``cuda:0``)
   serves 8 requests through ``SessionServeEngine`` (two tenants) and
   then ``ServeEngine``: every request done, the two token streams equal
   bit for bit, no KV spill, every page back, no NaN logits, and the
   paged-attention kernel launched once per layer and decode step;
   beforehand a device-time profile of five decode steps and five
   teacher-forced prefill steps of the legacy engine;
9. dense path — llama3-8b at full width, 2 layers, float32:
   ``ServeEngine`` (the paged kernel) gives the greedy tokens of
   ``Model.prefill`` + ``decode_step`` (plain torch attention);
10. paper suite — the port's benchmark suite on ``cuda:0``: the gated
   benches' smokes (graph, pressure, stream, topology) and
   ``benchmarks_torch.run --json-dir`` at full depth (graph's fork-joins
   at n 32768, the rest at n 16384), their modeled gates equal to
   ``benchmarks/baselines/`` and ``benchmarks/baselines/nightly/`` through
   the port's ``check_regression`` (both sides logged); the paper-figure
   benches (Figs 5-8 and 10, Tables 1-3) at their default sizes with no
   MISMATCH row; both ``examples_torch`` scripts as subprocesses; every
   FFT/ZIP task on a device PE launched its kernel, FFT rows past 8192
   among them.  Records go to ``build/paper_suite/``.

Phases 3 and 4 also hold the paged-attention kernel against its plain
version (the reference's sweep, rows of length 0, repeated pages, and
llama3-8b decode width: 8 sequences of 4096 tokens) and time it there
and at phase 8's own shapes (batch 4, 32-page tables: a teacher-forced
prefill step with lengths [100, 0, 0, 0] and a lock-step decode step).
Device times from the profiler sum every kernel a call launches.

The last two lines are a JSON object of per-kernel records and
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits nonzero before printing any result.
"""

from __future__ import annotations

import collections
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, FP32
# outside the tensor cores, and the dense tensor-core rates for bf16 and
# TF32 (float32 inputs).  The bound is stated against these.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
PEAK_TF32_PER_S = 495e12

# Model widths from the repo's configs (src/repro/configs): llama3-8b
# attention, recurrentgemma-2b's RG-LRU width, xlstm-350m's mLSTM heads
# (m = 2 * d_model / heads).  Batch 1, one 4096-token sequence.
FLASH_MODEL = dict(B=1, S=4096, Hq=32, Hkv=8, d=128)
RG_LRU_MODEL = dict(B=1, S=4096, D=2560)
MLSTM_MODEL = dict(B=1, S=4096, H=4, m=512, chunk=64)
# timed shapes: the model width, then the autotuning ladder's largest
# rung (8 MiB: src/repro/core/autotune.py _mlstm_inputs, _rg_lru_inputs)
RG_LRU_TIMED = ((1, 4096, 2560), (1, 2048, 512))
MLSTM_TIMED = ((1, 4096, 4, 512, 64), (1, 5376, 2, 64, 64))

# llama3-8b decode: 8 sequences of 4096 tokens in 16-token pages
PAGED_MODEL = dict(B=8, Hq=32, Hkv=8, d=128, page=16, n_pages=256)
# the serving phase: two tenants as in examples/serve_llm.py, engines
# sized for prompts of 32-128 tokens and 32 new tokens each
SERVE = dict(max_batch=4, page_size=16, num_pages=512, max_pages_per_seq=32,
             pages_per_group=8)
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 8, (32, 129), 32

# (rows, N): the radar path's one-row FFTs, one row at the largest N of one
# launch, the autotuner's 8 MiB rung (1024 rows of 1024), and one row past
# one launch (the four-step passes): the paper suite's 16384 and 32768,
# the kernel's largest N, and many rows of 16384 and 65536
FFT_TIMED = ((1, 128), (1, 256), (1, 512), (1, 2048), (1, 8192),
             (1024, 1024), (1, 16384), (1, 32768), (1, 1 << 20),
             (128, 16384), (64, 65536))


def fft_sweep_rows(n: int):
    """Rows phase 3 holds the FFT kernel to at length ``n``: 1, 3, 128 and
    1024 up to one launch's 8192, 1, 3 and 128 up to 65536, then 1 and 3
    (up to 2^20)."""
    return ((1, 3, 128, 1024) if n <= 8192 else (1, 3, 128) if n <= 65536
            else (1, 3))
ZIP_TIMED_N = (128, 256, 512, 131072)
REPS = 5  # wall-time runs per main-path configuration and policy (median)
POLICIES = ("reference", "rimms")


def log(*parts) -> None:
    print(*parts, flush=True)


def fft_tol(n: int):
    """rtol, atol of tests/test_kernels.py: f32 twiddles and a different
    summation order.  They are sized for forward outputs (about sqrt(n) in
    magnitude); an inverse is compared times n (:func:`fft_scale`)."""
    rtol = 3e-3 if n >= 2048 else 5e-4
    return rtol, rtol * math.sqrt(n)


def fft_scale(n: int, forward: bool) -> int:
    """What an FFT output is multiplied by before it is held to
    :func:`fft_tol`: 1 forward, n inverse (an inverse is about 1/sqrt(n),
    so n times it has the forward's size; a power of two scales exactly)."""
    return 1 if forward else n


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).abs().max().item() if a.numel() else 0.0


def close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float,
          what: str) -> float:
    err = max_err(got, want)
    limit = atol + rtol * want.abs().max().item()
    if not torch.isfinite(got).all() or err > limit:
        raise AssertionError(f"{what}: max |err| {err:.3e} > {limit:.3e}")
    return err


# ---------------------------------------------------------------- 1. card
def phase_card():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    return smi, name


# --------------------------------------------------------------- 2. build
def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {time.perf_counter() - t0:.2f}s "
        f"(nvcc {_build.build_seconds:.2f}s) from {_build.CSRC}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            log(f"[build] {line.strip()}")


# ------------------------------------------------------------ 3. kernels
def phase_kernels(dev):
    from repro_torch.kernels.fft import fft as F
    from repro_torch.kernels.fft import ops as fft_ops
    from repro_torch.kernels.zip import ops as zip_ops
    from repro_torch.kernels.zip import zip as Z

    gen = torch.Generator(device=dev).manual_seed(0)

    def crandn(*shape):
        return torch.randn(*shape, dtype=torch.complex64, device=dev,
                           generator=gen)

    errs = {"fft": 0.0, "zip": 0.0}
    for n in (2 ** p for p in range(1, 21)):
        rtol, atol = fft_tol(n)
        worst_plain = worst_lib = 0.0
        for rows in fft_sweep_rows(n):
            x = crandn(rows, n)
            before = x.clone()
            for fwd in (True, False):
                got = fft_ops.fft(x, fwd)
                torch.cuda.synchronize()
                what = f"fft n={n} rows={rows} {'fwd' if fwd else 'inv'}"
                s = fft_scale(n, fwd)
                worst_plain = max(worst_plain, close(
                    got * s, F.fft_plain(x, inverse=not fwd) * s, rtol, atol,
                    what + " vs plain (inverse times n)"))
                lib = torch.fft.fft(x) if fwd else torch.fft.ifft(x)
                worst_lib = max(worst_lib, close(
                    got * s, lib * s, rtol, atol,
                    what + " vs torch.fft (inverse times n)"))
                for br in (32, 128):
                    if not torch.equal(fft_ops.fft(x, fwd, block_rows=br),
                                       got):
                        raise AssertionError(f"{what}: block_rows={br} not "
                                             f"bit-identical")
            if not torch.equal(x, before):
                raise AssertionError(f"fft n={n} rows={rows} wrote its input")
        log(f"[kernels] fft n={n} rows "
            f"{'/'.join(map(str, fft_sweep_rows(n)))} fwd+inv (inverse "
            f"times n): max|err| vs plain {worst_plain:.3e}, vs torch.fft "
            f"{worst_lib:.3e} (rtol {rtol}, atol {atol:.2e}); block_rows "
            f"8/32/128 bit-identical; "
            f"input unwritten")
        errs["fft"] = max(errs["fft"], worst_plain)
    # fragments: views at a nonzero storage offset, one at an odd element
    # (8 bytes past a 16-byte boundary) and rows of a 2-D view
    base = crandn(4 * 2048 + 1)
    before = base.clone()
    for what, frag in (("offset 256", base[256:512]),
                       ("odd offset 1", base[1:2049]),
                       ("odd offset 3, 3 rows", base[3:3 + 3 * 512]
                        .view(3, 512))):
        n, e = frag.shape[-1], 0.0
        for fwd in (True, False):
            got = fft_ops.fft(frag, fwd)
            want = F.fft_plain(frag.reshape(-1, n), inverse=not fwd)
            s = fft_scale(n, fwd)
            e = max(e, close(got.reshape(-1, n) * s, want * s, *fft_tol(n),
                             f"fft fragment view ({what})"))
            errs["fft"] = max(errs["fft"], e)
            for br in (32, 128):
                if not torch.equal(fft_ops.fft(frag, fwd, block_rows=br),
                                   got):
                    raise AssertionError(f"fft fragment view ({what}): "
                                         f"block_rows={br} not "
                                         f"bit-identical")
        log(f"[kernels] fft fragment view ({what}): max|err| {e:.3e}")
    if not torch.equal(base, before):
        raise AssertionError("fft wrote into its input")

    for shape in ((1,), (2,), (64,), (3, 300), (2, 5, 129), (131072,)):
        a, b = crandn(*shape), crandn(*shape)
        got = zip_ops.zip_mul(a, b)
        e = close(got, Z.zip_plain(a, b), 1e-5, 1e-5, f"zip {shape}")
        close(got, a * b, 1e-5, 1e-5, f"zip {shape} vs a*b")
        for br in (1024, 4096):
            if not torch.equal(zip_ops.zip_mul(a, b, block_rows=br), got):
                raise AssertionError(f"zip {shape}: block_rows={br} "
                                     f"not bit-identical")
        errs["zip"] = max(errs["zip"], e)
        log(f"[kernels] zip {shape}: max|err| vs plain {e:.3e} (tol 1e-5); "
            f"block_rows 256/1024/4096 bit-identical")
    # views at every pair of 8-byte phases (a and b at different 16-byte
    # phases), odd offsets, odd lengths; the inputs stay unwritten
    base_a, base_b = crandn(3 * 512 + 8), crandn(3 * 512 + 8)
    keep_a, keep_b = base_a.clone(), base_b.clone()
    for oa, ob, n in ((512, 1024, 512), (1, 0, 512), (0, 1, 511),
                      (1, 1, 1001), (3, 6, 1), (5, 2, 1537)):
        fa, fb = base_a[oa:oa + n], base_b[ob:ob + n]
        got = zip_ops.zip_mul(fa, fb)
        e = close(got, Z.zip_plain(fa, fb), 1e-5, 1e-5,
                  f"zip fragment views (offsets {oa}, {ob}, n {n})")
        for br in (1024, 4096):
            if not torch.equal(zip_ops.zip_mul(fa, fb, block_rows=br), got):
                raise AssertionError(f"zip fragment views ({oa}, {ob}, {n}):"
                                     f" block_rows={br} not bit-identical")
        errs["zip"] = max(errs["zip"], e)
        log(f"[kernels] zip fragment views (offsets {oa}, {ob}, n {n}): "
            f"max|err| {e:.3e}; block_rows bit-identical")
    if not (torch.equal(base_a, keep_a) and torch.equal(base_b, keep_b)):
        raise AssertionError("zip wrote into its inputs")
    torch.cuda.synchronize()
    return errs


# ------------------------------------------------------------- 4. timing
def _time_ms(fn, iters: int, warmup: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, kernel_name: str, iters: int = 50, per_call: int = 1):
    """Device time of one call of ``fn`` from the profiler's CUDA trace:
    every kernel whose name holds ``kernel_name``, ``per_call`` of them a
    call (a call may launch more than one, e.g. a split pass and its
    combine), summed and divided by the calls.  The trace occasionally
    comes back empty or drops events, so a trace that holds any other
    number of those kernels than ``iters * per_call`` is taken again,
    once; None ("not measured") when that fails too or the profiler
    cannot trace the card here."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    want = iters * per_call
    for _attempt in range(2):
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        except Exception as e:  # a measurement, not a check: report absent
            log(f"[timing] profiler unavailable ({type(e).__name__}: {e})")
            return None
        total, n = 0.0, 0
        for ev in prof.key_averages():
            if kernel_name in ev.key:
                t = getattr(ev, "device_time_total", None)
                if t is None:
                    t = getattr(ev, "cuda_time_total", 0.0)
                if t:  # a kernel on the card, not a host-side event
                    total += t
                    n += ev.count
        if n == want:
            return total / iters / 1e3  # µs per call -> ms
        log(f"[timing] the trace holds {n} {kernel_name} kernels, not "
            f"{want}")
    return None


def _bound(nbytes: float, flops: float, peak: float = PEAK_FP32_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sync_ms(fn, iters: int = 400, warmup: int = 20) -> float:
    """What a runtime task pays for one call: the median host-clock time
    of the call followed by ``torch.cuda.synchronize()``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def _enqueue_ms(fn, iters: int = 200) -> float:
    """The host's share of a call: the host clock over ``iters`` calls
    with no synchronisation between them, over the count."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e3


def _device_ms_all(fn, iters: int = 50):
    """Device time of one call of ``fn``, summed over every kernel and
    copy the profiler saw on the card in the window (a library call's
    kernels carry names of their own), and the number of them a call
    launches; (None, None) when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == DeviceType.CUDA]
    except Exception as e:  # a measurement, not a check: report absent
        log(f"[timing] profiler unavailable ({type(e).__name__}: {e})")
        return None, None
    if not us:
        return None, None
    return sum(us) / iters / 1e3, len(us) / iters


def _call_record(kernel_fn, kernel_name, library_fn, iters, per_call=1):
    """A kernel's and its library call's times at one shape: pipelined
    call (CUDA events), one call + synchronise (median), enqueue (host
    clock, no synchronisation) and device time (profiler, summed over the
    ``per_call`` kernels a call launches)."""
    lib_dev, lib_kernels = _device_ms_all(library_fn)
    return {
        "kernel_ms": _time_ms(kernel_fn, iters),
        "kernel_sync_ms": _sync_ms(kernel_fn),
        "kernel_enqueue_ms": _enqueue_ms(kernel_fn),
        "kernel_device_ms": _device_ms(kernel_fn, kernel_name,
                                       per_call=per_call),
        "library_ms": _time_ms(library_fn, iters),
        "library_sync_ms": _sync_ms(library_fn),
        "library_enqueue_ms": _enqueue_ms(library_fn),
        "library_device_ms": lib_dev,
        "library_device_kernels_per_call": lib_kernels,
    }


def phase_timing(dev):
    """FFT and ZIP at the radar path's one-row shapes (and the FFT at
    8192, at the autotuner's 8 MiB rung, 1024 rows of 1024, and at 16384,
    32768 and 2^20, 128 x 16384 and 64 x 65536, two launches a call): the kernel and its library call
    (``torch.fft.fft``, ``a * b``) each by :func:`_call_record`, the plain
    version's pipelined time and the bound (one pass over the data; past
    8192 also the bound of the four-step's two passes, each reading and
    writing every value, beside the step twiddles' 8 bytes a value)."""
    from repro_torch.kernels.fft import fft as F
    from repro_torch.kernels.fft import ops as fft_ops
    from repro_torch.kernels.zip import ops as zip_ops
    from repro_torch.kernels.zip import zip as Z

    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for nrows, n in FFT_TIMED:
        x = torch.randn(nrows, n, dtype=torch.complex64, device=dev,
                        generator=gen)
        bound_ms, bound_by = _bound(16.0 * nrows * n,
                                    5.0 * nrows * n * math.log2(n))
        four_step = n > F.TABLE_N
        rec = {"kernel": "fft", "rows": nrows, "n": n,
               **_call_record(lambda: fft_ops.fft(x), "fft",
                              lambda: torch.fft.fft(x), 2000 // nrows + 50,
                              per_call=2 if four_step else 1),
               "plain_ms": _time_ms(lambda: F.fft_plain(x),
                                    max(200 // nrows, 5), warmup=3),
               "bound_ms": bound_ms, "bound_by": bound_by}
        if four_step:
            rec["bound_two_pass_ms"] = _bound(32.0 * nrows * n, 0.0)[0]
            rec["bound_two_pass_twiddles_ms"] = _bound(
                32.0 * nrows * n + 8.0 * n, 0.0)[0]
        rows.append(rec)
        log("[timing] " + json.dumps(rec))
    for n in ZIP_TIMED_N:
        a = torch.randn(n, dtype=torch.complex64, device=dev, generator=gen)
        b = torch.randn(n, dtype=torch.complex64, device=dev, generator=gen)
        bound_ms, bound_by = _bound(24.0 * n, 6.0 * n)
        rec = {"kernel": "zip", "rows": 1, "n": n,
               **_call_record(lambda: zip_ops.zip_mul(a, b), "zip",
                              lambda: a * b, 2000),
               "plain_ms": _time_ms(lambda: Z.zip_plain(a, b), 2000),
               "bound_ms": bound_ms, "bound_by": bound_by}
        rows.append(rec)
        log("[timing] " + json.dumps(rec))
    return rows


# ------------------------------------------ 3. kernels: the tuned ones
# tests/test_kernels.py's sweeps and tolerances
FLASH_SWEEP = ((2, 256, 4, 2, 64, 128, 128, torch.float32),
               (1, 512, 2, 1, 128, 128, 256, torch.float32),
               (2, 128, 4, 4, 64, 64, 64, torch.bfloat16),
               (1, 384, 2, 2, 64, 128, 128, torch.float32))
RG_LRU_SWEEP = ((2, 32, 128), (3, 64, 200), (1, 128, 256))
MLSTM_SWEEP = ((2, 64, 2, 128, 16), (1, 32, 4, 64, 8), (1, 128, 1, 128, 64))


def flash_tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-4


class Inputs:
    """Seeded inputs on the card, drawn as tests/test_kernels.py draws
    them."""

    def __init__(self, dev, seed):
        self.dev = dev
        self.gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(self, *shape, scale=1.0, dtype=torch.float32):
        x = torch.randn(*shape, device=self.dev, generator=self.gen)
        return (x * scale).to(dtype)

    def uniform(self, lo, hi, *shape):
        u = torch.rand(*shape, device=self.dev, generator=self.gen)
        return u * (hi - lo) + lo

    def flash(self, B, S, Hq, Hkv, d, dtype):
        return (self.normal(B, S, Hq, d, dtype=dtype),
                self.normal(B, S, Hkv, d, dtype=dtype),
                self.normal(B, S, Hkv, d, dtype=dtype))

    def rg_lru(self, B, S, D, lo=0.3, hi=0.999):
        return (self.uniform(lo, hi, B, S, D), self.normal(B, S, D),
                self.normal(B, D))

    def mlstm(self, B, S, H, m):
        return (self.normal(B, S, H, m), self.normal(B, S, H, m, scale=0.3),
                self.normal(B, S, H, m), self.uniform(0.1, 0.9, B, S, H),
                torch.log(self.uniform(0.5, 0.95, B, S, H)))


def phase_tuned_kernels(dev):
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mlstm import mlstm as ML
    from repro_torch.kernels.mlstm import ops as mlstm_ops
    from repro_torch.kernels.rg_lru import ops as rg_ops
    from repro_torch.kernels.rg_lru import rg_lru as RL

    inp = Inputs(dev, 2)
    errs = {"flash_attention": 0.0, "rg_lru": 0.0, "mlstm": 0.0}
    m = FLASH_MODEL
    flash_cases = [(c, True) for c in FLASH_SWEEP]
    flash_cases.append(((1, 128, 2, 2, 64, 64, 64, torch.float32), False))
    flash_cases += [((m["B"], m["S"], m["Hq"], m["Hkv"], m["d"], 256, 256,
                      dt), True) for dt in (torch.bfloat16, torch.float32)]
    for (B, S, Hq, Hkv, d, bq, bk, dt), causal in flash_cases:
        q, k, v = inp.flash(B, S, Hq, Hkv, d, dt)
        got = flash_ops.flash_attention(q, k, v, causal=causal, block_q=bq,
                                        block_k=bk)
        torch.cuda.synchronize()
        tol = flash_tol(dt)
        what = (f"flash_attention B{B} S{S} Hq{Hq} Hkv{Hkv} d{d} "
                f"bq{bq} bk{bk} {str(dt)[6:]} "
                f"{'causal' if causal else 'full'}")
        e = close(got.float(), FA.flash_attention_plain(
            q, k, v, causal=causal, block_k=min(bk, S)).float(), tol, tol,
            what + " vs plain")
        for bq2 in (128, 256, 512):
            if not torch.equal(flash_ops.flash_attention(
                    q, k, v, causal=causal, block_q=bq2, block_k=bk), got):
                raise AssertionError(f"{what}: block_q={bq2} not "
                                     f"bit-identical")
        errs["flash_attention"] = max(errs["flash_attention"], e)
        log(f"[kernels] {what}: max|err| vs plain {e:.3e} (tol {tol}); "
            f"block_q 128/256/512 bit-identical")

    for (B, S, D), (lo, hi) in ([(c, (0.3, 0.999)) for c in RG_LRU_SWEEP]
                                + [((1, 16, 128), (0.5, 0.9)),
                                   ((2, 200, 384), (0.3, 0.999))]
                                + [(c, (0.3, 0.999)) for c in RG_LRU_TIMED]):
        a, b, h0 = inp.rg_lru(B, S, D, lo, hi)
        kept = [x.clone() for x in (a, b, h0)]
        hs, hn = rg_ops.rg_lru_scan(a, b, h0)
        torch.cuda.synchronize()
        ws, wn = RL.rg_lru_plain(a, b, h0)
        what = f"rg_lru B{B} S{S} D{D}"
        if not all(torch.equal(x, y) for x, y in zip((a, b, h0), kept)):
            raise AssertionError(f"{what}: the kernel wrote its inputs")
        e = max(close(hs, ws, 1e-4, 1e-4, what + " h_seq vs plain"),
                close(hn, wn, 1e-4, 1e-4, what + " h_final vs plain"))
        if not (torch.equal(hs, ws) and torch.equal(hn, wn)):
            raise AssertionError(f"{what}: not bit-equal to the plain scan")
        for bl in (256, 512):
            got = rg_ops.rg_lru_scan(a, b, h0, block_lanes=bl)
            if not (torch.equal(got[0], hs) and torch.equal(got[1], hn)):
                raise AssertionError(f"{what}: block_lanes={bl} not "
                                     f"bit-identical")
        errs["rg_lru"] = max(errs["rg_lru"], e)
        log(f"[kernels] {what}: max|err| vs plain {e:.3e} (tol 1e-4), "
            f"bit-equal; block_lanes 128/256/512 bit-identical; inputs "
            f"unwritten")

    for B, S, H, hw, c in MLSTM_SWEEP + MLSTM_TIMED:
        ins = inp.mlstm(B, S, H, hw)
        kept = [x.clone() for x in ins]
        got = mlstm_ops.mlstm_chunkwise(*ins, chunk=c)
        torch.cuda.synchronize()
        what = f"mlstm B{B} S{S} H{H} m{hw} chunk{c}"
        e = close(got, ML.mlstm_plain(*ins, chunk=c), 2e-3, 2e-3,
                  what + " vs plain")
        if not all(torch.equal(x, y) for x, y in zip(ins, kept)):
            raise AssertionError(f"{what}: the kernel wrote its inputs")
        errs["mlstm"] = max(errs["mlstm"], e)
        log(f"[kernels] {what}: max|err| vs plain {e:.3e} (tol 2e-3); "
            f"inputs unwritten")
    # the autotuner's chunk candidates, also at the model width and the
    # ladder's top rung: each within 2e-3 of plain and of chunk 64, but
    # not bit for bit
    for B, S, H, hw in [(1, 512, 2, 64)] + [t[:4] for t in MLSTM_TIMED]:
        ins = inp.mlstm(B, S, H, hw)
        base = mlstm_ops.mlstm_chunkwise(*ins, chunk=64)
        for c in (32, 64, 128):
            got = mlstm_ops.mlstm_chunkwise(*ins, chunk=c)
            what = f"mlstm B{B} S{S} H{H} m{hw} chunk{c}"
            e = close(got, ML.mlstm_plain(*ins, chunk=c), 2e-3, 2e-3,
                      what + " vs plain")
            d = close(got, base, 2e-3, 2e-3, what + " vs chunk64")
            errs["mlstm"] = max(errs["mlstm"], e)
            log(f"[kernels] {what}: max|err| vs plain {e:.3e}, vs chunk64 "
                f"{d:.3e} (bit-identical: {torch.equal(got, base)})")
    m = MLSTM_MODEL
    ins = inp.mlstm(m["B"], m["S"], m["H"], m["m"])
    log("[kernels] mlstm plain TF32 error at the model width, one product "
        "at a time in TF32 (max|h - h_fp32|; the kernel runs every product "
        "in split TF32): " + json.dumps(mlstm_tf32_errors(ins, m["chunk"])))
    torch.cuda.synchronize()
    return errs


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it (10-bit mantissa,
    nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mlstm_tf32_errors(ins, chunk):
    """The chunkwise recurrence (as ``mlstm_plain`` computes it) with one
    matrix product at a time on TF32-rounded operands (products exact,
    sums in float32, as the tensor cores take TF32): the largest
    deviation of h from the float32 result, by product."""
    q, k, v, ig, lf = ins
    batch, s, h, m = q.shape
    bh = batch * h

    def heads(x):
        return x.transpose(1, 2).reshape(bh, s, -1)

    qh, kh, vh = heads(q / math.sqrt(m)), heads(k), heads(v)
    ih, fh = heads(ig[..., None])[..., 0], heads(lf[..., None])[..., 0]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))

    def run(tf32_of):
        def mm(name, a, b):
            return _tf32(a) @ _tf32(b) if name == tf32_of else a @ b

        c_state = torch.zeros((bh, m, m), device=q.device)
        n_state = torch.zeros((bh, m, 1), device=q.device)
        outs = []
        for t0 in range(0, s, chunk):
            sl = slice(t0, t0 + chunk)
            qc, kc, vc, ic = qh[:, sl], kh[:, sl], vh[:, sl], ih[:, sl]
            cum = torch.cumsum(fh[:, sl], dim=-1)
            scores = mm("scores", qc, kc.transpose(-1, -2))
            dlt = cum[:, :, None] - cum[:, None, :]
            a = torch.where(mask, scores * torch.exp(dlt) * ic[:, None, :],
                            torch.zeros((), device=q.device))
            ecum = torch.exp(cum)[..., None]
            num = mm("av", a, vc) + ecum * mm("qc", qc, c_state)
            den = a.sum(dim=-1, keepdim=True) + ecum * (qc @ n_state)
            outs.append(num / den.abs().clamp_min(1.0))
            kw = kc * (torch.exp(cum[:, -1:] - cum) * ic)[..., None]
            decay = torch.exp(cum[:, -1])[:, None, None]
            c_state = decay * c_state + mm("c_update", kw.transpose(-1, -2),
                                           vc)
            n_state = decay * n_state + kw.sum(dim=1)[..., None]
        return torch.cat(outs, dim=1)

    want = run(None)
    return {name: max_err(run(name), want)
            for name in ("scores", "av", "qc", "c_update")}


# ---------------------------------------------- 4. timing: the tuned ones
def phase_tuned_timing(dev):
    import torch.nn.functional as TF

    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ops as flash_ops

    inp = Inputs(dev, 3)
    rows = []
    m = FLASH_MODEL
    B, S, Hq, Hkv, d = m["B"], m["S"], m["Hq"], m["Hkv"], m["d"]
    # bf16 at the bf16 tensor-core rate; float32 at the FP32 rate, the
    # arithmetic the kernel must keep (2e-4 rules out TF32), with the
    # TF32 tensor-core figure beside it
    for dt, peak in ((torch.bfloat16, PEAK_BF16_PER_S),
                     (torch.float32, PEAK_FP32_PER_S)):
        q, k, v = inp.flash(B, S, Hq, Hkv, d, dt)
        esize = q.element_size()
        nbytes = esize * (2 * q.numel() + 2 * k.numel())
        flops = 4.0 * d * Hq * B * S * (S + 1) / 2  # causal: keys <= row
        bound_ms, bound_by = _bound(nbytes, flops, peak)
        extra = ({"bound_tf32_ms": _bound(nbytes, flops, PEAK_TF32_PER_S)[0]}
                 if dt == torch.float32 else {})
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rec = {
            "kernel": "flash_attention", "dtype": str(dt)[6:],
            "shape": f"B{B} S{S} Hq{Hq} Hkv{Hkv} d{d} causal",
            "kernel_ms": _time_ms(
                lambda: flash_ops.flash_attention(q, k, v), 50, warmup=5),
            "kernel_device_ms": _device_ms(
                lambda: flash_ops.flash_attention(q, k, v),
                "flash_attention", iters=5),
            "plain_ms": _time_ms(
                lambda: FA.flash_attention_plain(q, k, v), 5, warmup=1),
            "library_ms": _time_ms(
                lambda: TF.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), 20,
                warmup=3),
            "bound_ms": bound_ms, "bound_by": bound_by, **extra,
        }
        rows.append(rec)
        log("[timing] " + json.dumps(rec))
        del q, k, v, qt, kt, vt

    for B, S, D in RG_LRU_TIMED:
        rec = _rg_lru_record(inp, B, S, D)
        rows.append(rec)
        log("[timing] " + json.dumps(rec))
    for B, S, H, hw, c in MLSTM_TIMED:
        rec = _mlstm_record(inp, B, S, H, hw, c)
        rows.append(rec)
        log("[timing] " + json.dumps(rec))
    return rows


def _device_ms_by_kernel(fn, iters: int = 10):
    """Device ms a call of ``fn`` spends in each kernel, by name (the
    profiler's sums over ``iters`` calls); {} when it records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    except Exception as e:  # a measurement, not a check: report absent
        log(f"[timing] profiler unavailable ({type(e).__name__}: {e})")
        return {}
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0.0)
        if t and "kernel" in ev.key:
            name = ev.key.split("::")[-1].split("(")[0].split("<")[0]
            out[name] = out.get(name, 0.0) + t / iters / 1e3
    return out


def _recurrent_times(kernel_fn, plain_fn, plain_iters):
    """A recurrent kernel's pipelined call time (CUDA events), its device
    time summed over every kernel a call launches (profiler) with the
    number of those kernels and each one's share, and the plain
    version's pipelined time."""
    device_ms, per_call = _device_ms_all(kernel_fn, iters=10)
    return {"kernel_ms": _time_ms(kernel_fn, 20, warmup=3),
            "kernel_device_ms": device_ms,
            "device_kernels_per_call": per_call,
            "device_ms_by_kernel": _device_ms_by_kernel(kernel_fn),
            "plain_ms": _time_ms(plain_fn, plain_iters, warmup=1)}


def _rg_lru_record(inp, B, S, D):
    from repro_torch.kernels.rg_lru import ops as rg_ops
    from repro_torch.kernels.rg_lru import rg_lru as RL

    a, b, h0 = inp.rg_lru(B, S, D)
    # a and b read once, h_seq written once, h0 read and h_final written
    # once; a multiply and an add an element on the CUDA cores
    bound_ms, bound_by = _bound(4.0 * (3 * B * S * D + 2 * B * D),
                                2.0 * B * S * D)
    return {"kernel": "rg_lru", "dtype": "float32",
            "shape": f"B{B} S{S} D{D}", "dims": [B, S, D],
            **_recurrent_times(lambda: rg_ops.rg_lru_scan(a, b, h0),
                               lambda: RL.rg_lru_plain(a, b, h0), 2),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


def mlstm_work(B, S, H, m, c):
    """(bytes, product flops, other flops) of one mLSTM call: q, k, v
    and the gates read once, h written once; per chunk and head the
    masked c x c scores and A @ v, q @ C and the C update as matrix
    products, q . n, the n update and the decays beside them."""
    tri = c * (c + 1) / 2
    chunks = (S // c) * B * H
    products = (2 * tri * m * 2 + 2 * c * m * m * 2) * chunks
    other = 4.0 * c * m * chunks
    nbytes = 4.0 * (4 * B * S * H * m + 2 * B * S * H)
    return nbytes, products, other


def _mlstm_record(inp, B, S, H, hw, c):
    from repro_torch.kernels.mlstm import mlstm as ML
    from repro_torch.kernels.mlstm import ops as mlstm_ops

    ins = inp.mlstm(B, S, H, hw)
    nbytes, products, other = mlstm_work(B, S, H, hw, c)
    # the kernel's arithmetic: every product as split TF32 (three TF32
    # products each on the tensor cores); beside it the same work on the
    # FP32 units and as plain TF32
    bound_ms, bound_by = _bound(nbytes, 3 * products, PEAK_TF32_PER_S)
    return {"kernel": "mlstm", "dtype": "float32",
            "shape": f"B{B} S{S} H{H} m{hw} chunk{c}", "dims": [B, S, H, hw],
            **_recurrent_times(
                lambda: mlstm_ops.mlstm_chunkwise(*ins, chunk=c),
                lambda: ML.mlstm_plain(*ins, chunk=c), 3),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_fp32_ms": _bound(nbytes, products + other)[0],
            "bound_tf32_ms": _bound(nbytes, products, PEAK_TF32_PER_S)[0]}


# ---------------------------------- 3./4. the paged-attention kernel
#: tests/test_kernels.py's sweep: (B, Hq, Hkv, d, P, page, n_pages)
PAGED_SWEEP = ((2, 4, 4, 64, 16, 8, 4), (4, 8, 2, 64, 32, 16, 6),
               (1, 2, 1, 128, 8, 4, 2))


def _paged_inputs(inp, B, Hq, Hkv, d, P, page, npg, dtype, *, perm=False,
                  lengths=None):
    """q, K/V pools, block tables (each row distinct pages; with ``perm``
    all rows together a random permutation of the pool) and lengths
    (random in 1..npg*page unless given)."""
    q = inp.normal(B, Hq, d, dtype=dtype)
    kp = inp.normal(P, page, Hkv, d, dtype=dtype)
    vp = inp.normal(P, page, Hkv, d, dtype=dtype)
    if perm:
        bt = torch.randperm(P, device=inp.dev, generator=inp.gen)[:B * npg]
        bt = bt.reshape(B, npg)
    else:
        bt = torch.stack([torch.randperm(P, device=inp.dev,
                                         generator=inp.gen)[:npg]
                          for _ in range(B)])
    if lengths is None:
        lengths = torch.randint(1, npg * page + 1, (B,), device=inp.dev,
                                generator=inp.gen)
    lengths = torch.as_tensor(lengths, device=inp.dev)
    return (q, kp, vp, bt.to(torch.int32).contiguous(),
            lengths.to(torch.int32).contiguous())


def phase_paged_kernel(dev):
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import paged_attention as PA

    inp = Inputs(dev, 4)
    m = PAGED_MODEL
    full = (m["B"], m["Hq"], m["Hkv"], m["d"], m["B"] * m["n_pages"],
            m["page"], m["n_pages"])
    zero_first = torch.randint(1, m["n_pages"] * m["page"] + 1, (m["B"],),
                               generator=torch.Generator().manual_seed(4))
    zero_first[0] = 0
    cases = [(c, torch.float32, {}, "sweep") for c in PAGED_SWEEP]
    cases.append(((3, 8, 2, 64, 16, 8, 5), torch.float32,
                  {"lengths": [0, 7, 0]}, "rows of length 0"))
    cases += [(full, dt, {"perm": True, "lengths": zero_first},
               "llama3-8b decode width, row 0 of length 0")
              for dt in (torch.bfloat16, torch.float32)]
    # odd groups: the last query row's items take 16 columns of it, up to
    # the kernel's limit of (Hq / Hkv) * d <= 4096 (252 and 255 items for
    # 256 threads), and d = 72, whose last item has one 8-column slice
    cases += [(shape, dt, {"lengths": ln}, f"odd group {hq // hkv}")
              for shape, ln in (((2, 21, 1, 192, 64, 16, 32), [300, 0]),
                                ((2, 34, 2, 240, 64, 16, 32), [512, 17]),
                                ((3, 9, 3, 72, 32, 8, 12), [96, 0, 41]))
              for hq, hkv in [shape[1:3]]
              for dt in (torch.bfloat16, torch.float32)]
    err = 0.0
    for shape, dt, kw, what in cases:
        ins = _paged_inputs(inp, *shape, dt, **kw)
        got = pa_ops.paged_attention(*ins)
        torch.cuda.synchronize()
        tol = flash_tol(dt)
        e = close(got.float(), PA.paged_attention_plain(*ins).float(), tol,
                  tol, f"paged_attention {shape} {str(dt)[6:]} ({what})")
        err = max(err, e)
        log(f"[kernels] paged_attention B,Hq,Hkv,d,P,page,n_pages={shape} "
            f"{str(dt)[6:]} ({what}): max|err| vs plain {e:.3e} (tol {tol})")
    # tables that repeat a page (the scratch page, padding)
    q, kp, vp, _, _ = _paged_inputs(inp, 2, 4, 2, 64, 8, 8, 4, torch.float32)
    bt = torch.tensor([[3, 3, 5, 3], [0, 0, 0, 0]], dtype=torch.int32,
                      device=dev)
    ln = torch.tensor([20, 3], dtype=torch.int32, device=dev)
    e = close(pa_ops.paged_attention(q, kp, vp, bt, ln),
              PA.paged_attention_plain(q, kp, vp, bt, ln), 2e-4, 2e-4,
              "paged_attention repeated pages")
    err = max(err, e)
    log(f"[kernels] paged_attention repeated pages: max|err| vs plain "
        f"{e:.3e} (tol 2e-4)")
    torch.cuda.synchronize()
    return {"paged_attention": err}


def _paged_work(ln, n_pages: int, page: int, Hq: int, Hkv: int, d: int,
                esize: int):
    """Bytes and flops these lengths need: a row of length L >= 1 reads
    K and V at its first min(L, n_pos) positions; a row of length 0 is
    the uniform mean of V over all n_pos table positions (no K)."""
    n_pos = n_pages * page
    rows = [int(x) for x in ln.tolist()]
    kv_rows = sum(2 * min(L, n_pos) if L > 0 else n_pos for L in rows)
    nbytes = (esize * (2 * len(rows) * Hq * d + kv_rows * Hkv * d)
              + 4 * len(rows) * (n_pages + 1))  # q, out; K/V; table, lengths
    flops = sum(4.0 * Hq * d * min(L, n_pos) if L > 0
                else 2.0 * Hq * d * n_pos for L in rows)
    return nbytes, flops


#: the timed shapes: llama3-8b decode width (8 sequences of 4096 tokens)
#: and phase 8's own (batch 4, 32-page tables) in a teacher-forced
#: prefill step (one row active, three of length 0) and a lock-step
#: decode step
PAGED_TIMED = (("decode_4096", dict(B=8, n_pages=256, lengths=[4096] * 8)),
               ("serve_prefill", dict(B=4, n_pages=32,
                                      lengths=[100, 0, 0, 0])),
               ("serve_decode", dict(B=4, n_pages=32, lengths=[100] * 4)))


def phase_paged_timing(dev):
    import torch.nn.functional as TF

    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import paged_attention as PA

    inp = Inputs(dev, 5)
    m = PAGED_MODEL
    Hq, Hkv, d, page = m["Hq"], m["Hkv"], m["d"], m["page"]
    rows = []
    for case, c in PAGED_TIMED:
        B, npg = c["B"], c["n_pages"]
        S = npg * page
        ins = _paged_inputs(inp, B, Hq, Hkv, d, B * npg, page, npg,
                            torch.bfloat16, perm=True, lengths=c["lengths"])
        q, kp, vp, bt, ln = ins
        nbytes, flops = _paged_work(ln, npg, page, Hq, Hkv, d,
                                    q.element_size())
        bound_ms, bound_by = _bound(nbytes, flops, PEAK_BF16_PER_S)
        # the library yardstick: SDPA over K/V already gathered densely
        kd = kp[bt.long()].reshape(B, S, Hkv, d).transpose(1, 2).contiguous()
        vd = vp[bt.long()].reshape(B, S, Hkv, d).transpose(1, 2).contiguous()
        qd = q[:, :, None, :]
        # (a row of length 0 attends over every position here: the
        # yardstick's cost, not the oracle's uniform weights)
        mask = None
        if any(0 < L < S for L in c["lengths"]):
            mask = ((torch.arange(S, device=dev)[None, :] < ln.long()[:, None])
                    | (ln.long()[:, None] <= 0))[:, None, None, :]
        # the serving shapes split each table 8 ways, with rows of length
        # 0 and rows that end before their later splits
        e = close(pa_ops.paged_attention(*ins).float(),
                  PA.paged_attention_plain(*ins).float(), 2e-2, 2e-2,
                  f"paged_attention {case}")
        torch.cuda.synchronize()
        log(f"[kernels] paged_attention {case}: max|err| vs plain {e:.3e} "
            f"(tol 2e-2)")
        rec = {
            "kernel": "paged_attention", "case": case, "dtype": "bfloat16",
            "max_abs_err": e,
            "shape": f"B{B} Hq{Hq} Hkv{Hkv} d{d} page{page} n_pages{npg} "
                     f"lengths {c['lengths'] if B <= 4 else S}",
            "kernel_ms": _time_ms(lambda: pa_ops.paged_attention(*ins), 200),
            "kernel_device_ms": _device_ms(
                lambda: pa_ops.paged_attention(*ins), "paged_attention"),
            "plain_ms": _time_ms(lambda: PA.paged_attention_plain(*ins), 20,
                                 warmup=3),
            "library_ms": _time_ms(lambda: TF.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask, enable_gqa=True), 200),
            "library_call": "scaled_dot_product_attention over K/V "
                            "gathered into dense (B, Hkv, S, d) beforehand "
                            "(the gather not timed), with a length mask "
                            "where a row is shorter than S; rows of length "
                            "0 attend over every position",
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        }
        rows.append(rec)
        log("[timing] " + json.dumps(rec))
    return rows


# --------------------------------------------------------- 5. main path
def _np_fzf(a, b):
    return np.fft.ifft(np.fft.fft(a) * np.fft.fft(b))


def _check_out(got, want, n, what):
    """Finite, right shape, and within rtol 1e-3, atol 1e-3*sqrt(n) of
    numpy's complex128 chain (the tolerance of the port's tests)."""
    rtol, atol = 1e-3, 1e-3 * math.sqrt(n)
    got = np.asarray(got)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{what}: shape {got.shape} or non-finite")
    err = float(np.max(np.abs(got - want)))
    if err > atol + rtol * float(np.max(np.abs(want))):
        raise AssertionError(f"{what}: max |err| {err:.3e}")
    return err


def _fzf_points(points, n):
    """Pairs (output HeteData, numpy want) of a parallel FZF phase."""
    a_frags, b_frags = points["a"][1], points["b"][1]
    return [(out, _np_fzf(a.data.copy(), b.data.copy()))
            for out, a, b in zip(points["out"][1], a_frags, b_frags)]


class DeviceTaskCounter:
    """fft/ifft and zip tasks the runtimes placed on GPU/accelerator
    PEs, from their task logs (task names carry the op as prefix)."""

    def __init__(self):
        self.fft = 0
        self.zip = 0

    def add(self, task_log):
        for name, pe in task_log:
            if pe.startswith("cpu"):
                continue
            if name.startswith(("fft", "ifft")):
                self.fft += 1
            elif name.startswith("zip"):
                self.zip += 1
            else:
                raise AssertionError(f"unexpected task {name!r} on {pe}")


def _compare(build, counter, *, device, accelerators=("gpu0",), n_cpu=1,
             reps=REPS):
    """Run one chain under both memory policies, in turns (reference,
    rimms, rimms, reference, ...), each time on a fresh runtime.  Returns
    ``{policy: (record, ctx, bufs)}`` of each policy's last run; the
    record (median wall seconds, ledger copies and bytes, modeled
    makespan, kernel share of the wall) is taken before the caller syncs
    any output back to the host."""
    from repro_torch.apps.radar import make_runtime, run_pipeline

    walls = {p: [] for p in POLICIES}
    last = {}
    for r in range(reps):
        for policy in (POLICIES if r % 2 == 0 else POLICIES[::-1]):
            rt, ctx = make_runtime(policy=policy, accelerators=accelerators,
                                   n_cpu=n_cpu, device=device)
            bufs, tasks = build(ctx)
            wall = run_pipeline(rt, tasks, mode="serial")
            walls[policy].append(wall)
            counter.add(rt.task_log)
            last[policy] = (rt, ctx, bufs, wall)
    out = {}
    for policy, (rt, ctx, bufs, wall) in last.items():
        events = rt.timeline.events()
        compute = sum(ev.compute_s for ev in events)
        rec = {"wall_s": statistics.median(walls[policy]),
               "copies": ctx.ledger.total_copies,
               "bytes": {f"{s}->{d}": b for (s, d), b
                         in sorted(ctx.ledger.bytes_moved.items())},
               "model_s": rt.last_makespan_model,
               "tasks": len(rt.task_log),
               "kernel_share": compute / max(wall, 1e-12),
               "task_compute_us": _task_compute_us(events)}
        out[policy] = (rec, ctx, bufs)
    return out


def _task_compute_us(events):
    """The runtime's measured compute seconds (what its cost model
    observes: the kernel call and the wait for its stream) of each
    fft/ifft/zip task on a device PE, per op: count, median and mean in
    µs."""
    by_op = collections.defaultdict(list)
    for ev in events:
        if ev.pe.startswith("cpu"):
            continue
        op = next(o for o in ("ifft", "fft", "zip") if ev.task.startswith(o))
        by_op[op].append(ev.compute_s * 1e6)
    return {op: {"tasks": len(v), "median_us": statistics.median(v),
                 "mean_us": statistics.fmean(v)}
            for op, v in sorted(by_op.items())}


def _report(app, res):
    ref, rim = res["reference"], res["rimms"]
    ratio = ref["wall_s"] / max(rim["wall_s"], 1e-12)
    rec = {"app": app, "ref_over_rimms_wall": ratio}
    for policy in POLICIES:
        r = res[policy]
        rec[policy] = {
            "wall_s": r["wall_s"], "copies": r["copies"],
            "bytes_by_pair": r["bytes"], "makespan_model_s": r["model_s"],
            "tasks": r["tasks"], "kernel_share": r["kernel_share"],
            "task_compute_us": r.get("task_compute_us"),
        }
    log("[main] " + json.dumps(rec))
    return rec


def _check_counts(app, res, want):
    got = (res["reference"]["copies"], res["rimms"]["copies"])
    if want == "minus_one":
        if got[0] - got[1] != 1:
            raise AssertionError(f"{app}: RIMMS did not save exactly one "
                                 f"copy ({got[0]} -> {got[1]})")
    elif want == "fewer":
        if not got[1] < got[0]:
            raise AssertionError(f"{app}: RIMMS made no fewer copies {got}")
    elif got != want:
        raise AssertionError(f"{app}: copies reference/rimms {got} != {want}")


def phase_main(device, *, fft_sizes=(64, 128, 256, 512, 1024, 2048),
               fzf_sizes=(32, 64, 128, 256, 512, 1024, 2048),
               zip_sizes=tuple(2 ** k for k in (7, 9, 11, 13, 15, 17)),
               pd=(128, 128), sar_scale=1, session_chains=16,
               session_n=2048, reps=REPS, counter=None):
    from repro_torch.apps import radar
    from repro_torch.core.hete import hete_sync

    counter = counter if counter is not None else DeviceTaskCounter()
    results = []

    def drive(app, build, want_counts=None, *, accelerators=("gpu0",),
              n_cpu=1, expected=None):
        """Compare both policies on ``build``; check every output against
        numpy (``expected(bufs)`` -> [(HeteData, want)]) and the copy
        counts; record the report line."""
        runs = _compare(build, counter, device=device,
                        accelerators=accelerators, n_cpu=n_cpu, reps=reps)
        for policy, (_, ctx, bufs) in runs.items():
            for i, (out, want) in enumerate(expected(bufs)):
                _check_out(hete_sync(out, context=ctx), want, want.size,
                           f"{app} {policy} output {i}")
        res = {p: r[0] for p, r in runs.items()}
        if want_counts is not None:
            _check_counts(app, res, want_counts)
        results.append(_report(app, res))

    def one(bufs, want_fn):
        return [(bufs["out"], want_fn(bufs))]

    # 2FFT sweep (paper Fig 5): ACC-ACC and CPU-ACC
    for scen, pins, counts in (("acc_acc", ("gpu0", "gpu0"), (4, 1)),
                               ("cpu_acc", ("cpu0", "gpu0"), "minus_one")):
        for n in fft_sizes:
            drive(f"2fft_{scen}_n{n}",
                  lambda c, n=n, pins=pins: radar.build_2fft(c, n, pins=pins,
                                                             seed=n),
                  counts,
                  expected=lambda b: one(b, lambda b: np.fft.ifft(
                      np.fft.fft(b["in"].data.copy()))))

    # 2FZF sweep (paper Table 1), accelerator only
    for n in fzf_sizes:
        drive(f"2fzf_acc_n{n}",
              lambda c, n=n: radar.build_2fzf(c, n, pins=("gpu0",) * 4,
                                              seed=n),
              (9, 2),
              expected=lambda b: one(b, lambda b: _np_fzf(
                  b["a"].data.copy(), b["b"].data.copy())))

    # 3ZIP sweep (paper Fig 8), GPU only
    def zip3_want(b):
        x = [h.data.copy() for h in b["ins"]]
        return (x[0] * x[1]) * (x[2] * x[3])

    for n in zip_sizes:
        drive(f"3zip_gpu_n{n}",
              lambda c, n=n: radar.build_3zip(c, n, pins=("gpu0",) * 3,
                                              seed=n),
              (9, 4), expected=lambda b: one(b, zip3_want))

    # RC, PD and SAR (paper §5.4), on the platforms of
    # benchmarks/bench_apps.py: GPU only, and 3 CPUs + 1 GPU under round
    # robin; SAR on the FFT and ZIP accelerators
    rc_want = lambda b: one(b, lambda b: _np_fzf(  # noqa: E731
        b["a"].data.copy(), b["b"].data.copy()))
    for platform, n_cpu in (("gpu_only", 0), ("3cpu_1gpu", 3)):
        drive(f"rc_{platform}", lambda c: radar.build_rc(c, seed=1),
              n_cpu=n_cpu, expected=rc_want)
        drive(f"pd_{platform}",
              lambda c: radar.build_pd(c, ways=pd[0], n=pd[1], seed=2),
              "fewer", n_cpu=n_cpu,
              expected=lambda b: _fzf_points(b, pd[1]))
    drive("sar", lambda c: radar.build_sar(c, scale=sar_scale, seed=3),
          "fewer", accelerators=("fft_acc0", "zip_acc0"), n_cpu=0,
          expected=lambda b: (_fzf_points(b["phase1"], 256)
                              + _fzf_points(b["phase2"], 512)))

    # one streaming Session: 16 2FZF chains at n = 2048, windowed HEFT
    res = {}
    for policy in POLICIES:
        with radar.make_session(policy=policy, scheduler="heft",
                                device=device) as s:
            t0 = time.perf_counter()
            chains = [radar.submit_2fzf(s, session_n, seed=100 + i,
                                        tag=f"_{i}")
                      for i in range(session_chains)]
            outs = [c["out"].result().copy() for c in chains]
            s.barrier()
            wall = time.perf_counter() - t0
            for i, (c, got) in enumerate(zip(chains, outs)):
                _check_out(got, _np_fzf(c["a"].data.copy(),
                                        c["b"].data.copy()),
                           session_n, f"session chain {i}")
            counter.add(s.runtime.task_log)
            rep = s.report()
            res[policy] = {
                "wall_s": wall, "copies": s.ledger.total_copies,
                "bytes": {f"{a}->{b}": v for (a, b), v
                          in sorted(s.ledger.bytes_moved.items())},
                "model_s": rep["makespan_model"],
                "tasks": len(s.runtime.task_log), "kernel_share": None,
                "task_compute_us": _task_compute_us(
                    rep["timeline"].events()),
            }
        s.runtime.close()
    results.append(_report(f"session_2fzf_{session_chains}x{session_n}", res))
    return results, counter


# ------------------------------------------------------ 7. autotuning
#: the kernel each tuned op launches, by its launch-counter name
TUNED_KERNEL = {"fft_pallas": "fft", "zip_pallas": "zip",
                "flash_attention": "flash_attention", "mlstm": "mlstm",
                "rg_lru": "rg_lru"}
#: tests/test_kernels.py's tolerance for each tuned op at the autotuner's
#: inputs (the FFT rows are 1024 long)
TUNED_TOL = {"fft_pallas": fft_tol(1024), "zip_pallas": (1e-5, 1e-5),
             "flash_attention": (2e-4, 2e-4), "mlstm": (2e-3, 2e-3),
             "rg_lru": (1e-4, 1e-4)}


def kernel_modules():
    """The kernel modules by name; each carries its launch counter."""
    from repro_torch.kernels.fft import fft as F
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.mlstm import mlstm as ML
    from repro_torch.kernels.paged_attention import paged_attention as PA
    from repro_torch.kernels.rg_lru import rg_lru as RL
    from repro_torch.kernels.zip import zip as Z

    return {"fft": F, "zip": Z, "flash_attention": FA, "mlstm": ML,
            "rg_lru": RL, "paged_attention": PA}


def reset_counts():
    for mod in kernel_modules().values():
        mod.launches = 0


def read_counts():
    return {name: mod.launches for name, mod in kernel_modules().items()}


def _tuned_plain(op, ts):
    """The plain torch version of a tuned op's default variant."""
    mods = kernel_modules()
    if op == "fft_pallas":
        return (mods["fft"].fft_plain(ts[0]),)
    if op == "zip_pallas":
        return (mods["zip"].zip_plain(ts[0], ts[1]),)
    if op == "flash_attention":
        fa = mods["flash_attention"]
        return (fa.flash_attention_plain(
            *ts, block_k=min(fa.BLOCK_K, ts[0].shape[1])),)
    if op == "mlstm":
        ml = mods["mlstm"]
        return (ml.mlstm_plain(*ts, chunk=min(ml.CHUNK, ts[0].shape[1])),)
    return mods["rg_lru"].rg_lru_plain(*ts)


class _LaunchShapes:
    """Counts the mLSTM and RG-LRU kernel wrappers' calls by input shape
    between :meth:`install` and :meth:`restore` (the launch counters stay
    as they are): which rung of the ladder the path's launches ran at."""

    def __init__(self):
        self.counts = collections.Counter()

    def install(self):
        from repro_torch.kernels.mlstm import ops as mlstm_ops
        from repro_torch.kernels.rg_lru import ops as rg_ops

        self._saved = []
        for mod, name, key in ((mlstm_ops, "mlstm_kernel", "mlstm"),
                               (rg_ops, "rg_lru_kernel", "rg_lru")):
            orig = getattr(mod, name)

            def rec(*args, _orig=orig, _key=key, **kw):
                self.counts[(_key, tuple(args[0].shape))] += 1
                return _orig(*args, **kw)

            self._saved.append((mod, name, orig))
            setattr(mod, name, rec)

    def restore(self):
        for mod, name, orig in self._saved:
            setattr(mod, name, orig)

    def snapshot(self):
        return collections.Counter(self.counts)


def phase_autotune(dev, ladder=None):
    """The autotuning path as a user drives it: ``rimms.autotune`` on a
    session with a ``gpu0`` PE, then every tuned op at every rung
    submitted to ``gpu0``.  Returns the path's launch counts."""
    from repro_torch import rimms
    from repro_torch.core.autotune import tuned_summary
    from repro_torch.core.calibrate import (DEFAULT_LADDER, DEFAULT_VARIANT,
                                            _host)

    ladder = tuple(ladder or DEFAULT_LADDER)
    session = rimms.Session.emulated(n_cpu=1, accelerators=("gpu0",),
                                     device=dev)
    shapes = _LaunchShapes()
    try:
        shapes.install()
        reset_counts()
        t0 = time.perf_counter()
        table = rimms.autotune(session, nbytes=ladder)
        torch.cuda.synchronize()
        calib = read_counts()
        path_shapes = shapes.snapshot()
        log(f"[autotune] {len(table)} cells over ladder {list(ladder)} in "
            f"{time.perf_counter() - t0:.1f}s; kernel launches while "
            f"calibrating {calib}")
        if any(calib[k] <= 0 for k in TUNED_KERNEL.values()):
            raise AssertionError(f"a kernel never ran in autotune: {calib}")
        winners = tuned_summary(table)
        log("[autotune] winners " + json.dumps(winners, sort_keys=True))

        # references first: these launches are not the path's
        cases = []
        for tun in rimms.tunables():
            for nb in ladder:
                ins = [np.asarray(a) for a in tun.make_inputs(
                    np.random.default_rng([0, int(nb)]), int(nb))]
                nb_act = sum(a.nbytes for a in ins)
                win = table.winner(tun.op, "gpu", nb_act)["variant"]
                ts = [torch.from_numpy(a).to(dev) for a in ins]
                default = [_host(o) for o in tun.fn(ts)]
                plain = [_host(o) for o in _tuned_plain(tun.op, ts)]
                cases.append((tun, nb, ins, win, default, plain))
        torch.cuda.synchronize()

        # the counted dispatch: every (op, rung) pinned to gpu0
        session.runtime.reset_stats()
        before = read_counts()
        shapes_before = shapes.snapshot()
        futs = []
        for tun, nb, ins, *_ in cases:
            name = f"{tun.op}@{nb}"
            if tun.op == "rg_lru":
                out = [session.malloc(ins[0].shape, np.float32),
                       session.malloc(ins[2].shape, np.float32)]
                futs.append(session.submit(tun.op, ins, out=out, pin="gpu0",
                                           name=name))
            else:
                futs.append((session.submit(tun.op, ins, pin="gpu0",
                                            name=name),))
        results = [[np.array(f.result()) for f in fs] for fs in futs]
        session.barrier()
        after = read_counts()
        dispatch = {k: after[k] - before[k] for k in after}
        path_shapes.update(shapes.snapshot() - shapes_before)
        tasks = collections.Counter(
            name.split("@")[0] for name, pe in session.runtime.task_log
            if pe == "gpu0")
        for op, kname in TUNED_KERNEL.items():
            if dispatch[kname] != tasks[op] or tasks[op] != len(ladder):
                raise AssertionError(
                    f"{op}: {dispatch[kname]} {kname} launches for "
                    f"{tasks[op]} gpu tasks ({len(ladder)} submitted)")
        want_log = sorted((tun.op, "gpu", win) for tun, _, _, win, *_ in cases
                          if win != DEFAULT_VARIANT)
        got_log = sorted(session.runtime.variant_log)
        if got_log != want_log:
            raise AssertionError(f"variant_log {got_log} != winners "
                                 f"{want_log}")
        rows = []
        for (tun, nb, ins, win, default, plain), outs in zip(cases, results):
            rtol, atol = TUNED_TOL[tun.op]
            identical = all(o.tobytes() == d.tobytes()
                            for o, d in zip(outs, default))
            if not identical:
                raise AssertionError(f"{tun.op}@{nb}: the dispatched "
                                     f"{win} differs from the default")
            err = 0.0
            for o, p in zip(outs, plain):
                err = max(err, close(torch.from_numpy(o), torch.from_numpy(p),
                                     rtol, atol, f"{tun.op}@{nb} vs plain"))
            rows.append({"op": tun.op, "nbytes": int(nb), "winner": win,
                         "bit_identical_to_default": identical,
                         "max_abs_err_vs_plain": err})
        log("[autotune] dispatch " + json.dumps(rows))
        log(f"[autotune] {len(cases)} gpu0 tasks; the runtime ran each "
            f"table winner ({len(want_log)} non-default); kernel launches "
            f"{dispatch} equal the gpu tasks {dict(tasks)}")
        log("[autotune] mlstm/rg_lru launches by input shape " + json.dumps(
            {f"{k} {list(shape)}": n for (k, shape), n in
             sorted(path_shapes.items())}))
    finally:
        shapes.restore()
        session.close()
    return calib, dispatch, winners, path_shapes


def phase_cli():
    """``python -m repro_torch.calibrate run`` on one rung, then
    ``show`` on the table it wrote."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "calib.json"
        t0 = time.perf_counter()
        for argv in (["run", "--out", str(path), "--ladder", "64KiB"],
                     ["show", str(path)]):
            out = subprocess.run(
                [sys.executable, "-m", "repro_torch.calibrate", *argv],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=900)
            if out.returncode != 0:
                raise AssertionError(f"calibrate {argv[0]} exited "
                                     f"{out.returncode}:\n{out.stderr}")
            tail = (out.stderr.strip() or out.stdout.strip()).splitlines()
            log(f"[cli] calibrate {argv[0]}: {tail[-1] if tail else ''}")
        shown = out.stdout
        for op in TUNED_KERNEL:
            if f"| {op} | gpu |" not in shown:
                raise AssertionError(f"calibrate show lists no gpu winner "
                                     f"for {op}")
        log(f"[cli] run + show in {time.perf_counter() - t0:.1f}s; "
            f"{len(shown.splitlines())} lines shown, gpu winners for "
            f"every tuned op")


# ------------------------------------------------------- 8. serving path
def serving_model(dev):
    """llama3-8b at full width (32 layers, bf16) with random weights from
    the port's ``Model.init`` and a seeded generator on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("llama3_8b")
    t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_}, vocab "
        f"{cfg.vocab}; {n / 1e9:.3f} B params in {cfg.dtype}, made in "
        f"{time.perf_counter() - t0:.1f}s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return cfg, params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def serving_work(vocab):
    rng = np.random.default_rng(0)
    return [(rng.integers(1, vocab, size=int(rng.integers(*SERVE_PROMPT)))
             .tolist(), SERVE_NEW) for _ in range(SERVE_REQUESTS)]


def _profile_steps(step, n: int):
    """Device time of ``n`` calls of ``step`` from the profiler's CUDA
    trace, split into the paged-attention kernel, matrix products
    (cuBLAS's kernels: nvjet, gemm, gemv, CUTLASS) and the rest, in ms
    per call; None ("not measured") when the profiler records no device
    time here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_name = collections.Counter()
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.name] += ev.time_range.elapsed_us()
    except Exception as e:  # a measurement, not a check: report absent
        log(f"[serve] profiler unavailable ({type(e).__name__}: {e})")
        return None
    if not by_name:
        return None
    split = {"paged_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for name, us in by_name.items():
        low = name.lower()
        key = ("paged_attention" if "paged_attention" in low else "matmul"
               if any(k in low for k in ("nvjet", "gemm", "gemv", "cutlass",
                                         "xmma"))
               else "other")
        split[key] += us / n / 1e3
    return {"device_ms_per_step": sum(split.values()),
            "device_ms_per_step_by_kind": split,
            "wall_ms_per_step_profiled": wall / n * 1e3,
            "top_kernels_ms_per_step": {
                name[:80]: us / n / 1e3
                for name, us in by_name.most_common(6)}}


def warm_serving(cfg, params):
    """Four requests through the legacy engine before the counted run
    (cuBLAS handles, the allocator), and device-time profiles of five of
    its batch-4 decode steps at contexts of about 100 tokens and of five
    teacher-forced prefill steps: where a full-width step's time goes."""
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, params, max_batch=SERVE["max_batch"],
                      page_size=SERVE["page_size"], num_pages=64,
                      max_pages_per_seq=SERVE["max_pages_per_seq"])
    rng = np.random.default_rng(1)
    for _ in range(SERVE["max_batch"]):
        eng.submit(rng.integers(1, cfg.vocab, 96).tolist(), 8)
    eng.step()  # admits all four (teacher-forced prefill), one decode step
    torch.cuda.synchronize()
    prof = _profile_steps(eng.step, 5)
    # a teacher-forced prefill step: slot 0 alone active (lengths
    # [pos + 1, 0, 0, 0]), rewriting its own next position with the token
    # it holds, as its next decode step will
    prefill = _profile_steps(lambda: eng._decode_one(
        0, int(eng.slot_tok[0]), int(eng.slot_pos[0])), 5)
    eng.run()
    torch.cuda.synchronize()
    log("[serve] decode-step profile (legacy engine, batch 4, contexts "
        "~100 tokens): " + json.dumps(prof))
    log("[serve] prefill-step profile (legacy engine, one row active at "
        "~100 tokens, three of length 0): " + json.dumps(prefill))
    return {"decode": prof, "prefill": prefill}


def phase_serving(cfg, params):
    """``SessionServeEngine`` then ``ServeEngine`` on the same 8 requests
    (engines on ``device=None``, which is CUDA).  Returns the records and
    the paged-attention launches of each engine."""
    from repro_torch.kernels.paged_attention import paged_attention as PA
    from repro_torch.models import layers as L
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.session_engine import SessionServeEngine

    work = serving_work(cfg.vocab)
    group_bytes = (2 * cfg.n_layers * SERVE["pages_per_group"]
                   * SERVE["page_size"] * cfg.n_kv_heads * cfg.head_dim_
                   * L.cdtype(cfg).itemsize)  # K and V of one group
    arena = (SERVE["num_pages"] // SERVE["pages_per_group"]) * group_bytes \
        + (64 << 20)
    nan_flags = []
    lm_logits = L.lm_logits

    def watched(c, p, x):  # every logits row of the phase, NaN or not
        out = lm_logits(c, p, x)
        nan_flags.append(torch.isnan(out).any())
        return out

    L.lm_logits = watched
    records, streams = {}, {}
    try:
        for name in ("session", "legacy"):
            before = PA.launches
            if name == "session":
                eng = SessionServeEngine(cfg, params, arena_bytes=arena,
                                         **SERVE)
                eng.tenant("pro", weight=4.0, quota_pages=192,
                           slo_latency_s=1.0, slo_target=0.99)
                eng.tenant("free", weight=1.0, quota_pages=32,
                           slo_latency_s=1.0, slo_target=0.99)
                reqs = [eng.submit(p, m, tenant="pro" if i % 2 == 0
                                   else "free")
                        for i, (p, m) in enumerate(work)]
            else:
                eng = ServeEngine(cfg, params, max_batch=SERVE["max_batch"],
                                  page_size=SERVE["page_size"],
                                  num_pages=SERVE["num_pages"],
                                  max_pages_per_seq=SERVE["max_pages_per_seq"])
                reqs = [eng.submit(p, m) for p, m in work]
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = PA.launches - before
            if name == "session":
                spill, used = eng.kv.spill_bytes(), eng.kv.used_pages
                pct = eng.qos_report()["latency_percentiles"]
                eng.close()
            else:
                spill, used, pct = 0, eng.pool.used_pages, None
            if not all(r.done for r in reqs):
                raise AssertionError(f"{name}: not every request done")
            if spill != 0 or used != 1:
                raise AssertionError(f"{name}: spill {spill} B, {used} "
                                     f"pages in use at the end (want 0, 1)")
            if launches != cfg.n_layers * eng.decode_steps:
                raise AssertionError(
                    f"{name}: {launches} paged-attention launches for "
                    f"{eng.decode_steps} decode steps of {cfg.n_layers} "
                    f"layers")
            tokens = sum(len(r.generated) for r in reqs)
            streams[name] = [r.generated for r in reqs]
            records[name] = {
                "requests": len(reqs), "new_tokens": tokens,
                "prompt_tokens": sum(len(r.prompt) for r in reqs),
                "decode_steps": eng.decode_steps,
                "prefill_steps": sum(len(r.prompt) - 1 for r in reqs),
                "wall_s": wall,
                "tokens_per_s": tokens / wall,
                "ms_per_decode_step": wall / eng.decode_steps * 1e3,
                "paged_attention_launches": launches,
                "spill_bytes": spill,
            }
            if pct is not None:
                records[name]["modeled_p95_s"] = {
                    t: pct[t]["p95"] for t in ("pro", "free", "prefill")}
            log(f"[serve] {name} engine: " + json.dumps(records[name]))
    finally:
        L.lm_logits = lm_logits
    if streams["session"] != streams["legacy"]:
        raise AssertionError("session and legacy token streams differ")
    if bool(torch.stack(nan_flags).any()):
        raise AssertionError("NaN in the serving phase's logits")
    log(f"[serve] {len(work)} requests, prompts {[len(p) for p, _ in work]}"
        f" tokens, {SERVE_NEW} new each: the two engines' token streams "
        f"are equal bit for bit; no NaN in {len(nan_flags)} logits "
        f"batches; no KV spill; every page back")
    return records


# ------------------------------------------------------- 9. dense path
def phase_dense_check(dev):
    """llama3-8b at full width, 2 layers, float32: the paged engine gives
    the greedy tokens of ``Model.prefill`` + ``decode_step``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention as PA
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(get_config("llama3_8b"), n_layers=2,
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    work = [([5, 9, 2, 7], 6), ([11, 12, 13], 4)]
    before = PA.launches
    eng = ServeEngine(cfg, params, max_batch=2, page_size=16, num_pages=64,
                      max_pages_per_seq=16)
    reqs = [eng.submit(p, m) for p, m in work]
    eng.run()
    if PA.launches - before != cfg.n_layers * eng.decode_steps:
        raise AssertionError("dense check: launches != layers x steps")
    for req, (prompt, n_new) in zip(reqs, work):
        logits, caches = model.prefill(
            params, {"tokens": torch.tensor([prompt], device=dev)},
            max_len=128)
        tok, pos, want = int(torch.argmax(logits[0])), len(prompt), []
        for _ in range(n_new):
            want.append(tok)
            logits, caches = model.decode_step(
                params, caches, torch.tensor([tok], device=dev),
                torch.tensor([pos], device=dev))
            tok, pos = int(torch.argmax(logits[0])), pos + 1
        if req.generated != want:
            raise AssertionError(f"dense check: engine {req.generated} != "
                                 f"prefill + decode_step {want}")
    log(f"[dense] llama3-8b width, 2 layers, float32: ServeEngine tokens "
        f"equal Model.prefill + decode_step for {len(work)} prompts "
        f"({[r.generated for r in reqs]})")


# ----------------------------------------------------- 10. paper suite
#: the gated benches of the paper suite, each with a record in
#: benchmarks/baselines/ (smoke sizes) and benchmarks/baselines/nightly/
#: (full depth; graph's nightly record is its smoke record)
GATED = ("graph", "pressure", "stream", "topology")
BASELINES = ROOT / "benchmarks" / "baselines"
#: where the JAX package's own smoke gate differs from its committed
#: baseline, its value (one ulp above it; tests/test_torch_benches.py
#: holds the port to the JAX package's value on the CPU)
JAX_SMOKE_GATES = {"topology": {"spill_makespan_model":
                                0.0006992620800000002}}
#: paper-figure rows each bench emits at its default sizes
PAPER_ROWS = {"fig5_2fft_": 12, "table1_2fzf_": 14, "fig8_3zip_": 6,
              "fig7_": 18, "table2_": 6, "fig10_": 3, "table3_": 10}


class RuntimeTaskCounter:
    """fft/ifft and zip tasks the runtimes ran on device PEs, counted
    where every runtime runs a kernel (``Runtime._run_kernel``, serial
    and graph alike), with the longest FFT row among them."""

    def __init__(self):
        self.fft = self.zip = self.max_fft_n = 0
        self.other = []
        self._lock = threading.Lock()
        self._orig = None

    def __enter__(self):
        from repro_torch.core.runtime import Runtime

        orig = self._orig = Runtime._run_kernel
        counter = self

        def run_kernel(rt, task, pe, ins):
            out = orig(rt, task, pe, ins)
            if pe.kind != "cpu":
                with counter._lock:
                    if task.op in ("fft", "ifft"):
                        counter.fft += 1
                        counter.max_fft_n = max(counter.max_fft_n,
                                                task.inputs[0].shape[-1])
                    elif task.op == "zip":
                        counter.zip += 1
                    else:
                        counter.other.append(task.op)
            return out

        Runtime._run_kernel = run_kernel
        return self

    def __exit__(self, *exc):
        from repro_torch.core.runtime import Runtime

        Runtime._run_kernel = self._orig
        return False


def _gates_equal(paths, baselines: Path, what: str, override=None):
    """The port's ``check_regression`` over ``paths`` against
    ``baselines`` (exit 0 required), then every gated metric exactly equal
    to the baseline's (or to ``override``'s value), both sides logged."""
    from benchmarks_torch import check_regression

    rc = check_regression.main([str(p) for p in paths]
                               + ["--baselines", str(baselines)])
    if rc != 0:
        raise AssertionError(f"check_regression ({what}) exited {rc}")
    for path in paths:
        name = json.loads(path.read_text())["bench"]
        got = json.loads(path.read_text())["gate"]
        base = json.loads((baselines / path.name).read_text())["gate"]
        want = {**base, **(override or {}).get(name, {})}
        for k in sorted(base):
            log(f"[paper] {what} {name}.{k}: baseline {base[k]!r}"
                + (f", JAX package {want[k]!r}" if want[k] != base[k]
                   else "") + f", port {got.get(k)!r}")
        if got != want:
            raise AssertionError(f"{what} {name}: gate {got} != {want}")


def phase_paper_suite(out_dir: Path):
    """The paper's benchmark suite on ``cuda:0`` (device ``None``): the
    gated benches' smokes, ``benchmarks_torch.run --json-dir`` at full
    depth (graph at n 32768, pressure, stream and topology at n 16384),
    their gates against ``benchmarks/baselines/`` and ``.../nightly/``,
    the paper-figure benches at their default sizes, and both examples
    as subprocesses; every FFT/ZIP task on a device PE must have launched
    its kernel, with rows past 8192 among them."""
    from benchmarks_torch import (bench_2fft, bench_2fzf, bench_3zip,
                                  bench_alloc, bench_apps, bench_graph,
                                  bench_marking, bench_pressure,
                                  bench_stream, bench_topology, common)
    from benchmarks_torch import run as bench_run

    smoke_dir, full_dir = out_dir / "smoke", out_dir / "nightly"
    smoke_dir.mkdir(parents=True, exist_ok=True)
    full_dir.mkdir(parents=True, exist_ok=True)
    times = {}
    reset_counts()
    with RuntimeTaskCounter() as counter:
        t0 = time.perf_counter()
        bench_graph.smoke(str(smoke_dir / "BENCH_graph.json"))
        bench_pressure.run_pressure(ways=4, n=1 << 12, smoke=True,
                                    json_path=str(smoke_dir
                                                  / "BENCH_pressure.json"))
        bench_stream.run_stream(clients=4, chains=6, n=1 << 13, smoke=True,
                                json_path=str(smoke_dir
                                              / "BENCH_stream.json"))
        bench_topology.run_topology(ways=4, n=1 << 13, depth=2, smoke=True,
                                    json_path=str(smoke_dir
                                                  / "BENCH_topology.json"))
        times["smokes_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bench_run.main(["--only", ",".join(GATED), "--json-dir",
                        str(full_dir)])
        times["full_depth_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        start = len(common.ROWS)
        bench_2fft.run()
        bench_2fzf.run()
        bench_3zip.run()
        bench_alloc.run()
        bench_apps.run()
        bench_marking.run()
        rows = common.ROWS[start:]
        times["paper_figures_s"] = time.perf_counter() - t0
    launches = read_counts()

    _gates_equal([smoke_dir / f"BENCH_{b}.json" for b in GATED], BASELINES,
                 "smoke", JAX_SMOKE_GATES)
    _gates_equal([full_dir / f"BENCH_{b}.json" for b in GATED],
                 BASELINES / "nightly", "nightly")

    if any("MISMATCH" in r for r in rows):
        raise AssertionError("a paper-figure row reads MISMATCH: "
                             + "; ".join(r for r in rows if "MISMATCH" in r))
    for prefix, want in PAPER_ROWS.items():
        got = sum(r.startswith(prefix) for r in rows)
        if got != want:
            raise AssertionError(f"{got} paper rows {prefix}*, not {want}")
    if sum("OK" in r for r in rows if r.startswith("fig5_2fft_")) != 12:
        raise AssertionError("2FFT copy elimination not OK in every row")
    (out_dir / "rows.csv").write_text("\n".join(rows) + "\n")
    log(f"[paper] {len(rows)} paper-figure rows (above) also in "
        f"{out_dir / 'rows.csv'}")

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for example in ("quickstart.py", "radar_pipeline.py"):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples_torch" / example)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        for line in proc.stdout.splitlines()[-8:]:
            log(f"[paper] {example}: {line}")
        if proc.returncode != 0:
            raise AssertionError(f"{example} exited {proc.returncode}:\n"
                                 f"{proc.stderr[-3000:]}")
        if (example == "quickstart.py"
                and "reference == rimms output" not in proc.stdout):
            raise AssertionError("quickstart.py did not compare policies")
    times["examples_s"] = time.perf_counter() - t0

    log(f"[paper] device tasks fft/ifft {counter.fft} (longest row "
        f"{counter.max_fft_n}), zip {counter.zip}; kernel launches "
        f"{launches}; {times}")
    if counter.other:
        raise AssertionError(f"unexpected device ops {set(counter.other)}")
    if (launches["fft"], launches["zip"]) != (counter.fft, counter.zip):
        raise AssertionError(f"launch counts {launches} != device tasks "
                             f"fft {counter.fft}, zip {counter.zip}")
    if counter.fft <= 0 or counter.zip <= 0 or counter.max_fft_n <= 8192:
        raise AssertionError("the paper suite ran no FFT past 8192 or no "
                             "ZIP on a device PE")
    return {"launches": launches, "device_tasks": {
        "fft": counter.fft, "zip": counter.zip,
        "max_fft_n": counter.max_fft_n}, "seconds": times}


# ------------------------------------------------------------------ main
def main() -> int:
    t_start = time.perf_counter()
    smi, name = phase_card()
    sys.path.insert(0, str(ROOT / "src"))
    # the plain versions' matrix products run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    errs = phase_kernels(dev)
    errs.update(phase_tuned_kernels(dev))
    errs.update(phase_paged_kernel(dev))
    log(f"[kernels] all checks passed in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    timing = (phase_timing(dev) + phase_tuned_timing(dev)
              + phase_paged_timing(dev))
    log(f"[timing] {time.perf_counter() - t0:.1f}s")
    errs["paged_attention"] = max(
        [errs["paged_attention"]] + [r["max_abs_err"] for r in timing
                                     if r["kernel"] == "paged_attention"])

    # warm the main path once (allocator, first H2D copies) — its
    # launches are not counted
    phase_main(None, fft_sizes=(64,), fzf_sizes=(64,), zip_sizes=(128,),
               pd=(4, 128), sar_scale=64, session_chains=1, session_n=64,
               reps=1)
    reset_counts()
    t0 = time.perf_counter()
    results, counter = phase_main(None)
    main_s = time.perf_counter() - t0
    launches = read_counts()
    log(f"[main] {len(results)} configurations in {main_s:.1f}s; "
        f"device tasks fft/ifft {counter.fft}, zip {counter.zip}; "
        f"kernel launches {launches}")
    if launches["fft"] <= 0 or launches["zip"] <= 0:
        raise AssertionError(f"a kernel never ran on the main path: {launches}")
    if (launches["fft"], launches["zip"]) != (counter.fft, counter.zip):
        raise AssertionError(
            f"launch counts {launches} != device tasks "
            f"fft {counter.fft}, zip {counter.zip}")

    t0 = time.perf_counter()
    calib, dispatch, _, path_shapes = phase_autotune(dev)
    tuned = {k: calib[k] + dispatch[k] for k in calib}
    log(f"[autotune] path in {time.perf_counter() - t0:.1f}s; kernel "
        f"launches over the path {tuned}")
    # launches x (device - bound) at each timed shape of the recurrent
    # kernels: the path's launches at that input shape
    for r in timing:
        if r["kernel"] in ("mlstm", "rg_lru"):
            r["autotune_launches"] = path_shapes[(r["kernel"],
                                                  tuple(r["dims"]))]
            dev_ms = r["kernel_device_ms"]
            r["launches_x_excess_ms"] = (
                None if dev_ms is None else
                r["autotune_launches"] * (dev_ms - r["bound_ms"]))
            log("[timing] at shape " + json.dumps(
                {k: r[k] for k in ("kernel", "shape", "kernel_ms",
                                   "kernel_device_ms", "bound_ms",
                                   "autotune_launches",
                                   "launches_x_excess_ms")}))
    phase_cli()

    # the serving path: warmed outside the counted run
    cfg, params = serving_model(dev)
    step_profile = warm_serving(cfg, params)
    reset_counts()
    t0 = time.perf_counter()
    serving = phase_serving(cfg, params)
    serve_counts = read_counts()
    log(f"[serve] path in {time.perf_counter() - t0:.1f}s; kernel launches "
        f"{serve_counts}")
    if serve_counts["paged_attention"] <= 0:
        raise AssertionError("the paged-attention kernel never ran on the "
                             "serving path")
    del params
    torch.cuda.empty_cache()
    phase_dense_check(dev)

    t0 = time.perf_counter()
    suite = phase_paper_suite(ROOT / "build" / "paper_suite")
    log(f"[paper] phase in {time.perf_counter() - t0:.1f}s")

    def pick(kernel, key, value):
        return next(r for r in timing
                    if r["kernel"] == kernel and r.get(key) == value)

    kernels = []
    for kname, t, replaces, shape in (
        ("fft", pick("fft", "n", 2048), "src/repro/kernels/fft/fft.py:27",
         "1 x 2048 complex64"),
        ("zip", pick("zip", "n", 131072), "src/repro/kernels/zip/zip.py:24",
         "131072 complex64"),
        ("flash_attention", pick("flash_attention", "dtype", "bfloat16"),
         "src/repro/kernels/flash_attention/flash_attention.py:30", None),
        ("mlstm", pick("mlstm", "kernel", "mlstm"),
         "src/repro/kernels/mlstm/mlstm.py:28", None),
        ("rg_lru", pick("rg_lru", "kernel", "rg_lru"),
         "src/repro/kernels/rg_lru/rg_lru.py:24", None),
        ("paged_attention", pick("paged_attention", "case", "decode_4096"),
         "src/repro/kernels/paged_attention/paged_attention.py:31", None),
    ):
        # the radar path for FFT and ZIP, the serving path for paged
        # attention, the autotuning path for the kernels only it runs
        path_launches = (launches[kname] if kname in ("fft", "zip") else
                         serve_counts[kname] if kname == "paged_attention"
                         else tuned[kname])
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{kname}.cu",
            "replaces": replaces,
            "launches": path_launches,
            "autotune_launches": tuned[kname],
            "autotune_dispatch_launches": dispatch[kname],
            "max_abs_err": errs[kname], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["kernel_device_ms"],
            "timed_shape": shape or f"{t['shape']} {t['dtype']}",
            **({"library_call": t["library_call"]}
               if "library_call" in t else {}),
            # mLSTM and RG-LRU: every timed shape (the model width and the
            # ladder's largest rung) with the path's launches there
            **({"timed_shapes": [
                {k: r.get(k) for k in (
                    "shape", "kernel_ms", "kernel_device_ms",
                    "device_kernels_per_call", "device_ms_by_kernel",
                    "bound_ms", "bound_by",
                    "bound_fp32_ms", "bound_tf32_ms", "plain_ms",
                    "autotune_launches", "launches_x_excess_ms")}
                for r in timing if r["kernel"] == kname]}
               if kname in ("mlstm", "rg_lru") else {}),
            # FFT: every timed shape, one launch up to 8192 and the
            # four-step's two past it; FFT and ZIP: the paper suite's
            # launches (phase 10)
            **({"timed_shapes": [
                {k: r.get(k) for k in (
                    "rows", "n", "kernel_ms", "kernel_sync_ms",
                    "kernel_device_ms", "library_ms", "library_device_ms",
                    "plain_ms", "bound_ms", "bound_by", "bound_two_pass_ms",
                    "bound_two_pass_twiddles_ms")}
                for r in timing if r["kernel"] == "fft"]}
               if kname == "fft" else {}),
            **({"paper_suite_launches": suite["launches"][kname]}
               if kname in ("fft", "zip") else {}),
            # FFT and ZIP: what a runtime task pays (one call then a
            # synchronise), the host's share, the library's device time
            **{k: t[k] for k in ("kernel_sync_ms", "kernel_enqueue_ms",
                                 "library_sync_ms", "library_enqueue_ms",
                                 "library_device_ms") if k in t},
        })
    log("[serve] summary " + json.dumps({"engines": serving,
                                         "step_profiles": step_profile}))
    log(f"[done] {time.perf_counter() - t_start:.1f}s in all")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
