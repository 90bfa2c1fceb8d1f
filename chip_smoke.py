"""Drive the PyTorch/CUDA port of RIMMS on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on a failed check:

1. card — the GPU's name and power limit (``nvidia-smi``);
2. build — compiles ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a);
3. kernels — the CUDA FFT and ZIP kernels against their plain torch
   versions (and ``torch.fft``) on the card, across the main path's
   shapes, at a fragment's storage offset, and across ``block_rows``;
4. timing — each kernel, its plain version and the one-call PyTorch
   equivalent at the main path's shapes (CUDA events), beside the
   least time the card could take (bytes or FP32 operations);
5. main path — the paper's radar evaluation (2FFT, 2FZF, 3ZIP, RC, PD,
   SAR, and a streaming Session) under the ``reference`` and ``rimms``
   memory policies on ``cuda:0``, checked against numpy's FFT chain and
   the paper's copy counts;
6. launch counts — every FFT/IFFT and ZIP task placed on a GPU PE in
   phase 5 launched its kernel exactly once.

The last two lines are a JSON object of per-kernel records and
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits nonzero before printing any result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and
# FP32 outside the tensor cores.  The bound is stated against these.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

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


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_PER_S * 1e3
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


# ------------------------------------------------------------------ main
def main() -> int:
    smi, name = phase_card()
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels.fft import fft as F
    from repro_torch.kernels.zip import zip as Z

    phase_build()
    dev = torch.device("cuda", 0)
    errs = phase_kernels(dev)
    timing = phase_timing(dev)

    # warm the main path once (allocator, first H2D copies) — its
    # launches are not counted
    phase_main(None, fft_sizes=(64,), fzf_sizes=(64,), zip_sizes=(128,),
               pd=(4, 128), sar_scale=64, session_chains=1, session_n=64,
               reps=1)
    F.launches = 0
    Z.launches = 0
    t0 = time.perf_counter()
    results, counter = phase_main(None)
    main_s = time.perf_counter() - t0
    launches = {"fft": F.launches, "zip": Z.launches}
    log(f"[main] {len(results)} configurations in {main_s:.1f}s; "
        f"device tasks fft/ifft {counter.fft}, zip {counter.zip}; "
        f"kernel launches fft {launches['fft']}, zip {launches['zip']}")
    if launches["fft"] <= 0 or launches["zip"] <= 0:
        raise AssertionError(f"a kernel never ran on the main path: {launches}")
    if (launches["fft"], launches["zip"]) != (counter.fft, counter.zip):
        raise AssertionError(
            f"launch counts {launches} != device tasks "
            f"fft {counter.fft}, zip {counter.zip}")

    def pick(kernel, n):
        return next(r for r in timing if r["kernel"] == kernel and r["n"] == n)

    kernels = []
    for kname, n, replaces in (
        ("fft", 2048, "src/repro/kernels/fft/fft.py:27"),
        ("zip", 131072, "src/repro/kernels/zip/zip.py:24"),
    ):
        t = pick(kname, n)
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{kname}.cu",
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["kernel_device_ms"], "timed_n": n,
        })
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
