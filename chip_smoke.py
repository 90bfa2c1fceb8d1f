"""Drive the PyTorch/CUDA port of RIMMS on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on a failed check:

1. card — the GPU's name and power limit (``nvidia-smi``);
2. build — compiles ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a);
3. kernels — every CUDA kernel against its plain torch version on the
   card: FFT and ZIP across the radar path's shapes, at a fragment's
   storage offset and across ``block_rows``; flash attention, RG-LRU
   and mLSTM at the reference's test shapes and tolerances
   (``tests/test_kernels.py``) and at the widths of the repo's model
   configs (llama3-8b, recurrentgemma-2b, xlstm-350m), with ``block_q``
   and ``block_lanes`` bit-identical;
4. timing — each kernel, its plain version and the one-call PyTorch
   equivalent where there is one (CUDA events, device time from
   ``torch.profiler``), beside the least time the card could take
   (bytes, or operations at the peak for the input type);
5. main path — the paper's radar evaluation (2FFT, 2FZF, 3ZIP, RC, PD,
   SAR, and a streaming Session) under the ``reference`` and ``rimms``
   memory policies on ``cuda:0``, checked against numpy's FFT chain and
   the paper's copy counts;
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
9. dense path — llama3-8b at full width, 2 layers, float32:
   ``ServeEngine`` (the paged kernel) gives the greedy tokens of
   ``Model.prefill`` + ``decode_step`` (plain torch attention).

Phases 3 and 4 also hold the paged-attention kernel against its plain
version (the reference's sweep, rows of length 0, repeated pages, and
llama3-8b decode width: 8 sequences of 4096 tokens) and time it.

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

# llama3-8b decode: 8 sequences of 4096 tokens in 16-token pages
PAGED_MODEL = dict(B=8, Hq=32, Hkv=8, d=128, page=16, n_pages=256)
# the serving phase: two tenants as in examples/serve_llm.py, engines
# sized for prompts of 32-128 tokens and 32 new tokens each
SERVE = dict(max_batch=4, page_size=16, num_pages=512, max_pages_per_seq=32,
             pages_per_group=8)
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 8, (32, 129), 32

FFT_TIMED_N = (128, 256, 512, 2048)
ZIP_TIMED_N = (128, 256, 512, 131072)
REPS = 5  # wall-time runs per main-path configuration and policy (median)
POLICIES = ("reference", "rimms")


def log(*parts) -> None:
    print(*parts, flush=True)


def fft_tol(n: int):
    """rtol, atol of tests/test_kernels.py: f32 twiddles and a different
    summation order."""
    rtol = 3e-3 if n >= 2048 else 5e-4
    return rtol, rtol * math.sqrt(n)


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
    for n in (2, 8, 64, 128, 256, 512, 1024, 2048, 8192):
        rtol, atol = fft_tol(n)
        worst_plain = worst_lib = 0.0
        for rows in (1, 3, 128):
            x = crandn(rows, n)
            for fwd in (True, False):
                got = fft_ops.fft(x, fwd)
                torch.cuda.synchronize()
                what = f"fft n={n} rows={rows} {'fwd' if fwd else 'inv'}"
                worst_plain = max(worst_plain, close(
                    got, F.fft_plain(x, inverse=not fwd), rtol, atol,
                    what + " vs plain"))
                lib = torch.fft.fft(x) if fwd else torch.fft.ifft(x)
                worst_lib = max(worst_lib, close(got, lib, rtol, atol,
                                                 what + " vs torch.fft"))
            for br in (32, 128):
                if not torch.equal(fft_ops.fft(x, block_rows=br),
                                   fft_ops.fft(x)):
                    raise AssertionError(f"fft n={n} rows={rows}: "
                                         f"block_rows={br} not bit-identical")
        log(f"[kernels] fft n={n}: max|err| vs plain {worst_plain:.3e}, "
            f"vs torch.fft {worst_lib:.3e} (rtol {rtol}, atol {atol:.2e}); "
            f"block_rows 8/32/128 bit-identical")
        errs["fft"] = max(errs["fft"], worst_plain)
    # a fragment: a view at a nonzero storage offset
    base = crandn(4 * 256)
    frag = base[256:512]
    before = base.clone()
    e = close(fft_ops.fft(frag), F.fft_plain(frag.reshape(1, -1)).reshape(-1),
              *fft_tol(256), "fft fragment view")
    if not torch.equal(base, before):
        raise AssertionError("fft wrote into its input")
    errs["fft"] = max(errs["fft"], e)
    log(f"[kernels] fft fragment view (offset 256): max|err| {e:.3e}")

    for shape in ((64,), (3, 300), (2, 5, 129), (131072,)):
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
    base_a, base_b = crandn(3 * 512), crandn(3 * 512)
    fa, fb = base_a[512:1024], base_b[1024:]
    e = close(zip_ops.zip_mul(fa, fb), Z.zip_plain(fa, fb), 1e-5, 1e-5,
              "zip fragment views")
    errs["zip"] = max(errs["zip"], e)
    log(f"[kernels] zip fragment views (offsets 512, 1024): max|err| {e:.3e}")
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


def _device_ms(fn, kernel_name: str, iters: int = 50):
    """Device time of one launch of ``kernel_name`` from the profiler's
    CUDA trace, or None ("not measured") when the profiler cannot trace
    the card here or records no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _attempt in range(2):  # the trace occasionally comes back empty
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        except Exception as e:  # a measurement, not a check: report absent
            log(f"[timing] profiler unavailable ({type(e).__name__}: {e})")
            return None
        for ev in prof.key_averages():
            if kernel_name in ev.key:
                total = getattr(ev, "device_time_total", None)
                if total is None:
                    total = getattr(ev, "cuda_time_total", 0.0)
                if total and ev.count:
                    return total / ev.count / 1e3  # µs -> ms
    return None


def _bound(nbytes: float, flops: float, peak: float = PEAK_FP32_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(dev):
    from repro_torch.kernels.fft import fft as F
    from repro_torch.kernels.fft import ops as fft_ops
    from repro_torch.kernels.zip import ops as zip_ops
    from repro_torch.kernels.zip import zip as Z

    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for n in FFT_TIMED_N:
        x = torch.randn(1, n, dtype=torch.complex64, device=dev,
                        generator=gen)
        bound_ms, bound_by = _bound(16.0 * n, 5.0 * n * math.log2(n))
        rec = {
            "kernel": "fft", "rows": 1, "n": n,
            "kernel_ms": _time_ms(lambda: fft_ops.fft(x), 2000),
            "kernel_device_ms": _device_ms(lambda: fft_ops.fft(x),
                                           "stockham_fft_kernel"),
            "plain_ms": _time_ms(lambda: F.fft_plain(x), 200),
            "library_ms": _time_ms(lambda: torch.fft.fft(x), 2000),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        rows.append(rec)
        log("[timing] " + json.dumps(rec))
    for n in ZIP_TIMED_N:
        a = torch.randn(n, dtype=torch.complex64, device=dev, generator=gen)
        b = torch.randn(n, dtype=torch.complex64, device=dev, generator=gen)
        bound_ms, bound_by = _bound(24.0 * n, 6.0 * n)
        rec = {
            "kernel": "zip", "n": n,
            "kernel_ms": _time_ms(lambda: zip_ops.zip_mul(a, b), 2000),
            "kernel_device_ms": _device_ms(lambda: zip_ops.zip_mul(a, b),
                                           "zip_kernel"),
            "plain_ms": _time_ms(lambda: Z.zip_plain(a, b), 2000),
            "library_ms": _time_ms(lambda: a * b, 2000),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
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

    m = RG_LRU_MODEL
    for (B, S, D), (lo, hi) in ([(c, (0.3, 0.999)) for c in RG_LRU_SWEEP]
                                + [((1, 16, 128), (0.5, 0.9)),
                                   ((m["B"], m["S"], m["D"]), (0.3, 0.999))]):
        a, b, h0 = inp.rg_lru(B, S, D, lo, hi)
        hs, hn = rg_ops.rg_lru_scan(a, b, h0)
        torch.cuda.synchronize()
        ws, wn = RL.rg_lru_plain(a, b, h0)
        what = f"rg_lru B{B} S{S} D{D}"
        e = max(close(hs, ws, 1e-4, 1e-4, what + " h_seq vs plain"),
                close(hn, wn, 1e-4, 1e-4, what + " h_final vs plain"))
        if not (torch.equal(hs, ws) and torch.equal(hn, wn)):
            raise AssertionError(f"{what}: not bit-equal to the plain loop")
        for bl in (256, 512):
            got = rg_ops.rg_lru_scan(a, b, h0, block_lanes=bl)
            if not (torch.equal(got[0], hs) and torch.equal(got[1], hn)):
                raise AssertionError(f"{what}: block_lanes={bl} not "
                                     f"bit-identical")
        errs["rg_lru"] = max(errs["rg_lru"], e)
        log(f"[kernels] {what}: max|err| vs plain {e:.3e} (tol 1e-4), "
            f"bit-equal; block_lanes 128/256/512 bit-identical")

    m = MLSTM_MODEL
    for B, S, H, hw, c in MLSTM_SWEEP + ((m["B"], m["S"], m["H"], m["m"],
                                          m["chunk"]),):
        ins = inp.mlstm(B, S, H, hw)
        got = mlstm_ops.mlstm_chunkwise(*ins, chunk=c)
        torch.cuda.synchronize()
        what = f"mlstm B{B} S{S} H{H} m{hw} chunk{c}"
        e = close(got, ML.mlstm_plain(*ins, chunk=c), 2e-3, 2e-3,
                  what + " vs plain")
        errs["mlstm"] = max(errs["mlstm"], e)
        log(f"[kernels] {what}: max|err| vs plain {e:.3e} (tol 2e-3)")
    # the autotuner's chunk candidates: they agree, but not bit for bit
    ins = inp.mlstm(1, 512, 2, 64)
    base = mlstm_ops.mlstm_chunkwise(*ins, chunk=64)
    for c in (32, 128):
        got = mlstm_ops.mlstm_chunkwise(*ins, chunk=c)
        e = close(got, ML.mlstm_plain(*ins, chunk=c), 2e-3, 2e-3,
                  f"mlstm chunk{c} vs plain")
        d = close(got, base, 2e-3, 2e-3, f"mlstm chunk{c} vs chunk64")
        log(f"[kernels] mlstm chunk{c}: max|err| vs plain {e:.3e}, "
            f"vs chunk64 {d:.3e} (bit-identical: {torch.equal(got, base)})")
    torch.cuda.synchronize()
    return errs


# ---------------------------------------------- 4. timing: the tuned ones
def phase_tuned_timing(dev):
    import torch.nn.functional as TF

    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mlstm import mlstm as ML
    from repro_torch.kernels.mlstm import ops as mlstm_ops
    from repro_torch.kernels.rg_lru import ops as rg_ops
    from repro_torch.kernels.rg_lru import rg_lru as RL

    inp = Inputs(dev, 3)
    rows = []
    m = FLASH_MODEL
    B, S, Hq, Hkv, d = m["B"], m["S"], m["Hq"], m["Hkv"], m["d"]
    for dt, peak in ((torch.bfloat16, PEAK_BF16_PER_S),
                     (torch.float32, PEAK_TF32_PER_S)):
        q, k, v = inp.flash(B, S, Hq, Hkv, d, dt)
        esize = q.element_size()
        nbytes = esize * (2 * q.numel() + 2 * k.numel())
        flops = 4.0 * d * Hq * B * S * (S + 1) / 2  # causal: keys <= row
        bound_ms, bound_by = _bound(nbytes, flops, peak)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rec = {
            "kernel": "flash_attention", "dtype": str(dt)[6:],
            "shape": f"B{B} S{S} Hq{Hq} Hkv{Hkv} d{d} causal",
            "kernel_ms": _time_ms(
                lambda: flash_ops.flash_attention(q, k, v), 10, warmup=2),
            "kernel_device_ms": _device_ms(
                lambda: flash_ops.flash_attention(q, k, v),
                "flash_attention_kernel", iters=5),
            "plain_ms": _time_ms(
                lambda: FA.flash_attention_plain(q, k, v), 5, warmup=1),
            "library_ms": _time_ms(
                lambda: TF.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), 20,
                warmup=3),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        rows.append(rec)
        log("[timing] " + json.dumps(rec))
        del q, k, v, qt, kt, vt

    m = RG_LRU_MODEL
    B, S, D = m["B"], m["S"], m["D"]
    a, b, h0 = inp.rg_lru(B, S, D)
    bound_ms, bound_by = _bound(4.0 * (3 * B * S * D + 2 * B * D),
                                2.0 * B * S * D, PEAK_TF32_PER_S)
    rec = {
        "kernel": "rg_lru", "dtype": "float32", "shape": f"B{B} S{S} D{D}",
        "kernel_ms": _time_ms(lambda: rg_ops.rg_lru_scan(a, b, h0), 50),
        "kernel_device_ms": _device_ms(lambda: rg_ops.rg_lru_scan(a, b, h0),
                                       "rg_lru_kernel", iters=20),
        "plain_ms": _time_ms(lambda: RL.rg_lru_plain(a, b, h0), 2,
                             warmup=1),
        "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    rows.append(rec)
    log("[timing] " + json.dumps(rec))

    m = MLSTM_MODEL
    B, S, H, hw, c = m["B"], m["S"], m["H"], m["m"], m["chunk"]
    ins = inp.mlstm(B, S, H, hw)
    # per chunk and head: the masked c x c scores and A @ v, q @ C,
    # q . n, the C update and the n update
    tri = c * (c + 1) / 2
    per_chunk = 2 * tri * hw * 2 + 2 * c * hw * hw * 2 + 4 * c * hw
    flops = per_chunk * (S // c) * B * H
    nbytes = 4.0 * (4 * B * S * H * hw + 2 * B * S * H)
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_TF32_PER_S)
    rec = {
        "kernel": "mlstm", "dtype": "float32",
        "shape": f"B{B} S{S} H{H} m{hw} chunk{c}",
        "kernel_ms": _time_ms(lambda: mlstm_ops.mlstm_chunkwise(*ins), 10,
                              warmup=2),
        "kernel_device_ms": _device_ms(
            lambda: mlstm_ops.mlstm_chunkwise(*ins), "mlstm_kernel",
            iters=5),
        "plain_ms": _time_ms(lambda: ML.mlstm_plain(*ins), 5, warmup=1),
        "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    rows.append(rec)
    log("[timing] " + json.dumps(rec))
    return rows


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


def phase_paged_timing(dev):
    import torch.nn.functional as TF

    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import paged_attention as PA

    inp = Inputs(dev, 5)
    m = PAGED_MODEL
    B, Hq, Hkv, d, page, npg = (m["B"], m["Hq"], m["Hkv"], m["d"], m["page"],
                                m["n_pages"])
    S = npg * page
    ins = _paged_inputs(inp, B, Hq, Hkv, d, B * npg, page, npg,
                        torch.bfloat16, perm=True, lengths=[S] * B)
    q, kp, vp, bt, ln = ins
    # what this run's data needs: every row reads its pages up to its
    # length, once, K and V; q read, out written; table and lengths read
    pages = int(((ln.long() + page - 1) // page).sum())
    nbytes = (q.element_size() * (2 * q.numel() + 2 * pages * page * Hkv * d)
              + 4 * (bt.numel() + ln.numel()))
    flops = 4.0 * Hq * d * int(ln.long().sum())
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_BF16_PER_S)
    # the library yardstick: SDPA over K/V already gathered densely
    kd = kp[bt.long()].reshape(B, S, Hkv, d).transpose(1, 2).contiguous()
    vd = vp[bt.long()].reshape(B, S, Hkv, d).transpose(1, 2).contiguous()
    qd = q[:, :, None, :]
    rec = {
        "kernel": "paged_attention", "dtype": "bfloat16",
        "shape": f"B{B} Hq{Hq} Hkv{Hkv} d{d} page{page} n_pages{npg} "
                 f"lengths {S}",
        "kernel_ms": _time_ms(lambda: pa_ops.paged_attention(*ins), 200),
        "kernel_device_ms": _device_ms(lambda: pa_ops.paged_attention(*ins),
                                       "paged_attention_kernel"),
        "plain_ms": _time_ms(lambda: PA.paged_attention_plain(*ins), 20,
                             warmup=3),
        "library_ms": _time_ms(lambda: TF.scaled_dot_product_attention(
            qd, kd, vd, enable_gqa=True), 200),
        "library_call": "scaled_dot_product_attention over K/V gathered "
                        "into dense (B, Hkv, S, d) beforehand; the gather "
                        "is not timed",
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
    }
    log("[timing] " + json.dumps(rec))
    return [rec]


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
        compute = sum(ev.compute_s for ev in rt.timeline.events())
        rec = {"wall_s": statistics.median(walls[policy]),
               "copies": ctx.ledger.total_copies,
               "bytes": {f"{s}->{d}": b for (s, d), b
                         in sorted(ctx.ledger.bytes_moved.items())},
               "model_s": rt.last_makespan_model,
               "tasks": len(rt.task_log),
               "kernel_share": compute / max(wall, 1e-12)}
        out[policy] = (rec, ctx, bufs)
    return out


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
            res[policy] = {
                "wall_s": wall, "copies": s.ledger.total_copies,
                "bytes": {f"{a}->{b}": v for (a, b), v
                          in sorted(s.ledger.bytes_moved.items())},
                "model_s": s.report()["makespan_model"],
                "tasks": len(s.runtime.task_log), "kernel_share": None,
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
    try:
        reset_counts()
        t0 = time.perf_counter()
        table = rimms.autotune(session, nbytes=ladder)
        torch.cuda.synchronize()
        calib = read_counts()
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
    finally:
        session.close()
    return calib, dispatch, winners


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
    (cuBLAS handles, the allocator), and a device-time profile of five of
    its batch-4 decode steps at contexts of about 100 tokens: where a
    full-width decode step's time goes."""
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
    eng.run()
    torch.cuda.synchronize()
    log("[serve] decode-step profile (legacy engine, batch 4, contexts "
        "~100 tokens): " + json.dumps(prof))
    return prof


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
                "decode_steps": eng.decode_steps, "wall_s": wall,
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
    calib, dispatch, _ = phase_autotune(dev)
    tuned = {k: calib[k] + dispatch[k] for k in calib}
    log(f"[autotune] path in {time.perf_counter() - t0:.1f}s; kernel "
        f"launches over the path {tuned}")
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
        ("paged_attention", pick("paged_attention", "kernel",
                                 "paged_attention"),
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
        })
    log("[serve] summary " + json.dumps({"engines": serving,
                                         "decode_step_profile": step_profile}))
    log(f"[done] {time.perf_counter() - t_start:.1f}s in all")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
