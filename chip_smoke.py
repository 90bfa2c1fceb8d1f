"""Drive the PyTorch/CUDA port of RIMMS on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on a failed check:

1. card — the GPU's name and power limit (``nvidia-smi``);
2. build — compiles ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a);
3. kernels — every CUDA kernel against its plain torch version on the
   card: FFT at every power of two from 2 to 2^20 (1, 3, 128 and 1024
   rows up to 8192, one launch; 1, 3 and 128 up to 65536 and 1 and 3
   above, the four-step passes), forward and inverse (and against
   ``torch.fft``), ZIP at every length the radar and multitenant paths
   give it (32 to 8192, 131072) and odd shapes, both at fragments'
   storage offsets (odd ones
   too, and ZIP operands at different 16-byte phases), inputs unwritten
   and ``block_rows`` bit-identical; flash attention, RG-LRU
   and mLSTM at the reference's test shapes and tolerances
   (``tests/test_kernels.py``), at the widths of the repo's model
   configs (llama3-8b, recurrentgemma-2b, xlstm-350m) and at the
   autotuning ladder's top rung, with ``block_q`` and ``block_lanes``
   bit-identical, the RG-LRU bit-equal to its plain chunked scan, the
   mLSTM's chunk candidates 32/64/128 within 2e-3 of plain at both
   widths, the mLSTM's final state (``return_state``: C and n) within
   2e-3 of plain with h the same bits as without it, inputs unwritten,
   and plain TF32's error per mLSTM product;
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
   among them.  Records go to ``build/paper_suite/``; the gated smokes
   are traced into ``build/paper_suite/traces/``;
11. runtime — the observability and QoS surface on ``cuda:0``:
   ``bench_multitenant`` (three light closed-loop clients and one heavy
   open-loop client on two accelerators that share the card) at smoke and
   nightly depth, traced, its gates exactly equal to
   ``benchmarks/baselines/`` and ``.../nightly/``, light chains bit-identical
   between the mix and solo runs, no light SLO violated and the heavy
   tenant's burn rate above 1, every task completed, and one FFT or ZIP
   launch per device task; ``bench_overhead`` at 20 000 calls and
   ``OVERHEAD_REPEATS`` repeats with its smoke asserts (host timings,
   logged beside the host CPU's model); the
   profile CLI (``python -m repro_torch.profile``) over every trace of
   this phase and phase 10 (exit 0, four sections) and over a malformed
   and a missing one (exit 1).  Records go to ``build/runtime/``;
12. recurrent path — xlstm-350m and recurrentgemma-2b at full width and
   depth (random weights from ``Model.init`` with a seeded generator on
   ``cuda:0``): in bf16 a prefill of 2 x 2048 and 2 x 3072 tokens (past
   recurrentgemma's 2048-token window) and 16 greedy decode steps, finite
   logits and tokens in range, each prefill's wall, the ms per decode
   step and a device-time profile of one prefill and five decode steps;
   the mLSTM (RG-LRU) kernel against its plain version on what its
   layer builds from the path's own activations (2e-3 with the final
   state; bit-equal); in float32 ``prefill(prompt)`` against
   ``prefill(prompt[:-1])`` + ``decode_step`` within 2e-3 (1 +
   max|logit|).  The mLSTM launches exactly 12 times a xlstm prefill,
   the RG-LRU 18 times a recurrentgemma prefill, neither in decode;
13. MoE, audio and training — (a) granite-moe-3b-a800m at full width and
   depth (32 layers, 40 experts, top-8; bf16, random weights from seed
   0): a prefill of 2 x 2048 tokens and 16 greedy decode steps (finite
   logits, tokens in range, the prefill's wall and device-time profile,
   ms per decode step, the share of (token, expert) slots dropped over
   capacity), and one MoE layer in float32 on the card against the CPU
   on the same input and weights: the same expert ids and keep mask,
   outputs within 1e-4 max|y|; (b) whisper-large-v3 at full width and
   depth (32 + 32 layers, 1500 frames): frames (2, 1500, 1280) and a 2 x
   64 prompt, 16 greedy steps, then float32 prefill <-> decode within
   2e-3 (1 + max|logit|); (c) granite trained at full width and depth
   through ``Trainer`` (float32 master weights, bf16 compute, AdamW,
   per-layer remat, batch 1 x 4096, 3 steps): finite loss and grad norm
   every step, every leaf with a nonzero gradient moved (steps 1-2),
   one host->device ledger copy per batch leaf and step of the
   reference's bytes, the peak device memory beside 16 bytes a
   parameter, and a kernel wrapper given an input that requires grad
   raising; (a)-(c) launch no kernel; (d) llama3-8b ``smoke()`` in
   float32 trains 3 steps, checkpoints, restores bit for bit and serves
   one request through ``ServeEngine`` (the paged kernel);
14. recurrent training — (a) the mLSTM and RG-LRU backward kernels
   (``csrc/mlstm_bwd.cu``, ``csrc/rg_lru_bwd.cu``) through their wrappers
   against ``torch.autograd.grad`` through the plain forwards, float32:
   the mLSTM at xlstm-350m width ((1, 4096, 4, 512), chunks 64 and 128,
   and S 1024 and 256, the training path's) and small shapes (m 40, one
   chunk, seeded final state, log_f near 0 and strongly negative, |den|
   on both sides of 1), each gradient within 1e-3 (full width) or 1e-4
   of its max; the RG-LRU at (1, 4096, 2560), (2, 3072, 2560), D 200 with
   S 64 and 65, nonzero h0 and dh_final, bit-equal to its plain backward
   and across every ``block_lanes``, within 1e-5 of autograd's max; h the
   same bits with and without grad; (b) their times beside the bound and
   the plain backward's (CUDA events, profiler); (c) the smoke() loss
   gradients of xlstm-350m and recurrentgemma-2b card vs CPU within 1e-4
   of each leaf's max; (d) recurrentgemma-2b (1 x 4096) and xlstm-350m (1
   x 256, the sLSTM's host loop) trained at full width and depth
   through ``Trainer`` (3 steps each, phase 13's checks), each kernel
   launched exactly twice forward (the step, remat's recompute) and once
   backward per layer of its kind and step;
15. process backend — ``backend="process"`` beside the card: (a) a
   Session with cpu0 and cpu1 in spawned subprocess workers over a
   shared-memory host arena and gpu0 in-process on ``cuda:0`` runs 2FZF,
   3ZIP and a 4-way fork-join at n 2048, every task pinned: outputs
   bit-identical to the thread backend's (2FZF within 1e-4 of numpy's),
   equal ledgers per pair and FFT/ZIP launches, worker pids apart from
   this process, no worker with CUDA initialised, every worker reaped by
   ``close()`` within 10 s; the run is traced, linted and read by the
   profile CLI; (b) ``die`` on cpu0 raises ``WorkerDied`` with "exit code
   17" and a later cpu0 task runs, ``boom`` on cpu0 propagates its error;
   the calibration CLI's ``run --backend process`` (cpu PEs measured on
   their workers) and ``show``;
   (c) ``bench_graph`` and ``bench_stream`` ``--backend process`` at smoke
   and ``bench_stream`` at the nightly workflow's depth: the port's
   ``check_regression`` table printed whole, every modeled row exactly
   the baseline's, bit-identical to the thread backend, compute
   divergence cells; the measured ``wall_speedup_vs_serial`` rows are
   reported beside the reference's own (which fails that gate on an
   8-CPU host too), not held.  Records go to ``build/process_backend/``;
16. sharding and the launch tools — (a) the dry-run CLI
   (``python -m repro_torch.launch.dryrun``, 256 fake ranks, no device;
   subprocesses started before phase 12 and waited for before phase
   15, whose wall rows and traces want a quiet host) on
   xlstm-350m ``decode_32k`` and llama3-8b ``train_4k`` on the
   single-pod mesh with their probes, then ``python -m
   repro_torch.launch.roofline``: exit 0, every record's n_devices 256,
   FLOPs and memory per device > 0, algorithm bytes >= 0, a roofline row
   for each cell; each record's FLOPs, memory, collective bytes by op and
   row printed; beside them ``python -m repro_torch.launch.dryrun
   --held``, the one-group probes of the eight cells whose JAX records
   ``src/repro_torch/launch/dryrun_reference.json`` holds, each within
   ``dryrun.BOUNDS`` of its record (``against_reference``: FLOPs a
   device, collective bytes, ``per_device_total``, and in decode the
   bytes accessed and the caches written in place) on this machine's
   torch, one line a cell with its four ratios and ``torch.__version__``;
   (b) ``launch.train`` (its ``main``, in this process) on
   recurrentgemma-2b at full width and depth, 1 x 4096, 2 steps, without
   and with ``--distributed`` (NCCL, a world of one from the environment
   the phase sets): the losses and grad norms of both steps equal bit for
   bit, the RG-LRU's launches exact in each run (forward twice a layer of
   its kind and step, backward once), the peak memory of each; (c) the
   model-FLOPs share (``Model.model_flops`` over seconds x the bf16 peak)
   of every step phases 12-14 timed, at their own shapes (diagnostic).

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
import itertools
import json
import math
import os
import socket
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
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, FP32
# outside the tensor cores, and the dense tensor-core rates for bf16 and
# TF32 (float32 inputs).  The bound is stated against these; the bf16
# and byte peaks are the roofline's own (src/repro_torch/launch/roofline.py).
from repro_torch.launch.roofline import HBM_BW as PEAK_BYTES_PER_S  # noqa: E402
from repro_torch.launch.roofline import PEAK_FLOPS as PEAK_BF16_PER_S  # noqa: E402

PEAK_FP32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12

# Model widths from the repo's configs (src/repro/configs): llama3-8b
# attention, recurrentgemma-2b's RG-LRU width, xlstm-350m's mLSTM heads
# (m = 2 * d_model / heads).  Batch 1, one 4096-token sequence.
FLASH_MODEL = dict(B=1, S=4096, Hq=32, Hkv=8, d=128)
RG_LRU_MODEL = dict(B=1, S=4096, D=2560)
MLSTM_MODEL = dict(B=1, S=4096, H=4, m=512, chunk=64)
# timed shapes: the model width, the autotuning ladder's largest rung
# (8 MiB: src/repro/core/autotune.py _mlstm_inputs, _rg_lru_inputs), then
# the recurrent path's own (phase 12: recurrentgemma-2b's and
# xlstm-350m's prefill of 2 x 3072 and 2 x 2048 tokens, the mLSTM at the
# reference's chunk of 256); the mLSTM also at the model width with chunk
# 256
RG_LRU_TIMED = ((1, 4096, 2560), (1, 2048, 512), (2, 3072, 2560))
MLSTM_TIMED = ((1, 4096, 4, 512, 64), (1, 5376, 2, 64, 64),
               (1, 4096, 4, 512, 256), (2, 2048, 4, 512, 256))

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
# 2^20, many rows of 16384 and 65536, and 2^21 (the kernel's largest N,
# Bluestein's inner length above 2^19)
FFT_TIMED = ((1, 128), (1, 256), (1, 512), (1, 2048), (1, 8192),
             (1024, 1024), (1, 16384), (1, 32768), (1, 1 << 20),
             (128, 16384), (64, 65536), (1, 1 << 21))


def fft_sweep_rows(n: int):
    """Rows phase 3 holds the FFT kernel to at length ``n``: 1, 3, 128 and
    1024 up to one launch's 8192, 1, 3 and 128 up to 65536, then 1 and 3
    (up to 2^21)."""
    return ((1, 3, 128, 1024) if n <= 8192 else (1, 3, 128) if n <= 65536
            else (1, 3))


# lengths that are not powers of two (Bluestein's algorithm over the FFT
# and ZIP kernels: inner lengths 8 to 2^21), the radar path's 1000 and 3000
# among them, each with the rows phase 3 holds it to
FFT_ANY_N = (3, 12, 1000, 1536, 3000, 4095, 12289, 100000, 524287,
             (1 << 20) - 1)


def fft_any_rows(n: int):
    return (1, 3, 64) if n <= 12289 else (1, 3) if n <= 100000 else (1, 2)


# (rows, N) timed through Bluestein: the radar chains' 1000, a length one
# below a power of two, the largest prime below 2^19, the longest N
FFT_ANY_TIMED = ((1, 1000), (1, 4095), (1, 524287), (1, (1 << 20) - 1))
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
    for n in (2 ** p for p in range(1, 22)):
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
    errs["fft_bluestein"] = _bluestein_checks(crandn)
    errs["fft"] = max(errs["fft"], errs["fft_bluestein"])
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

    # the radar path's 2FZF lengths (32..2048), the multitenant path's
    # (4096, 8192) and 3ZIP's largest (131072), beside odd shapes
    for shape in ((1,), (2,), (3, 300), (2, 5, 129),
                  *((2 ** k,) for k in range(5, 14)), (131072,)):
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


def _bluestein_checks(crandn) -> float:
    """The FFT at lengths that are not powers of two (:data:`FFT_ANY_N`),
    forward and inverse: the kernels' composition against the same
    composition over the plain versions, and against numpy's complex128
    FFT, both at the power-of-two tolerance of its inner length (an
    inverse times n); bit-identical across block_rows; the input
    unwritten.  Returns the worst error against the plain version."""
    from repro_torch.kernels.fft import bluestein as BL
    from repro_torch.kernels.fft import ops as fft_ops

    worst = 0.0
    for n in FFT_ANY_N:
        rtol, atol = fft_tol(BL.inner_length(n))
        atol = rtol * math.sqrt(n)
        w_plain = w_np = 0.0
        for rows in fft_any_rows(n):
            x = crandn(rows, n)
            before = x.clone()
            x64 = x.cpu().numpy().astype(np.complex128)
            for fwd in (True, False):
                got = fft_ops.fft(x, fwd)
                torch.cuda.synchronize()
                what = f"fft n={n} rows={rows} {'fwd' if fwd else 'inv'}"
                s = 1 if fwd else n
                w_plain = max(w_plain, close(
                    got * s, BL.bluestein_plain(x, inverse=not fwd) * s,
                    rtol, atol, what + " vs plain (inverse times n)"))
                ref = torch.from_numpy(
                    np.fft.fft(x64) if fwd else np.fft.ifft(x64) * n)
                w_np = max(w_np, close(
                    (got.cpu() * s).to(torch.complex128), ref, rtol, atol,
                    what + " vs numpy complex128 (inverse times n)"))
                for br in (32, 128):
                    if not torch.equal(fft_ops.fft(x, fwd, block_rows=br),
                                       got):
                        raise AssertionError(f"{what}: block_rows={br} not "
                                             f"bit-identical")
            if not torch.equal(x, before):
                raise AssertionError(f"fft n={n} rows={rows} wrote its input")
        log(f"[kernels] fft n={n} (Bluestein, inner "
            f"{BL.inner_length(n)}) rows "
            f"{'/'.join(map(str, fft_any_rows(n)))} fwd+inv (inverse times "
            f"n): max|err| vs plain {w_plain:.3e}, vs numpy complex128 "
            f"{w_np:.3e} (rtol {rtol}, atol {atol:.2e}); block_rows "
            f"8/32/128 bit-identical; input unwritten")
        worst = max(worst, w_plain)
    return worst


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
    rows += _bluestein_timing(dev, gen)
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


def _bluestein_timing(dev, gen):
    """The FFT through Bluestein at :data:`FFT_ANY_TIMED`: a call is two
    FFT launches (each one or two kernels) and three ZIP launches, beside
    the zero fill and copies of the padding; its device time sums every
    kernel and copy of the call (:func:`_device_ms_all`), and the launch
    counters count a call's launches.  The bound is the DFT's own (one
    pass over the data, 5 N log2 N flops); the library call is
    ``torch.fft.fft`` at the same N.  Also the peak memory a call adds
    (its workspace) and how far the kernels' result is from the plain
    composition's."""
    from repro_torch.kernels.fft import bluestein as BL
    from repro_torch.kernels.fft import fft as F
    from repro_torch.kernels.fft import ops as fft_ops
    from repro_torch.kernels.zip import zip as Z

    rows = []
    for nrows, n in FFT_ANY_TIMED:
        x = torch.randn(nrows, n, dtype=torch.complex64, device=dev,
                        generator=gen)
        call = lambda: fft_ops.fft(x)  # noqa: E731
        call()
        torch.cuda.synchronize()
        f0, z0 = F.launches, Z.launches
        call()
        launches = {"fft": F.launches - f0, "zip": Z.launches - z0}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = call()
        torch.cuda.synchronize()
        workspace = torch.cuda.max_memory_allocated() - base
        err = max_err(got, BL.bluestein_plain(x, inverse=False))
        dev_ms, per_call = _device_ms_all(call, iters=20)
        bound_ms, bound_by = _bound(16.0 * nrows * n,
                                    5.0 * nrows * n * math.log2(n))
        iters = 200 if n < 1 << 16 else 50
        lib_dev, lib_kernels = _device_ms_all(lambda: torch.fft.fft(x))
        rec = {"kernel": "fft", "route": "bluestein", "rows": nrows, "n": n,
               "inner_n": BL.inner_length(n), "launches_per_call": launches,
               "kernel_ms": _time_ms(call, iters),
               "kernel_sync_ms": _sync_ms(call, iters=100),
               "kernel_enqueue_ms": _enqueue_ms(call, iters=100),
               "kernel_device_ms": dev_ms,
               "kernel_device_kernels_per_call": per_call,
               "workspace_bytes": workspace, "max_abs_err_vs_plain": err,
               "library_ms": _time_ms(lambda: torch.fft.fft(x), iters),
               "library_sync_ms": _sync_ms(lambda: torch.fft.fft(x),
                                           iters=100),
               "library_device_ms": lib_dev,
               "library_device_kernels_per_call": lib_kernels,
               "plain_ms": _time_ms(
                   lambda: BL.bluestein_plain(x, inverse=False), 5,
                   warmup=2),
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
MLSTM_SWEEP = ((2, 64, 2, 128, 16), (1, 32, 4, 64, 8), (1, 128, 1, 128, 64),
               # chunks above 128 (row blocks of 128 in the first pass,
               # slices of 16 in the second): the reference's 256, one
               # that is not a multiple of 16 or of 128, the largest m
               (1, 512, 2, 64, 256), (1, 400, 1, 40, 200),
               (1, 512, 1, 1024, 256))


# head widths the kernel runs at a padded compiled width (32 at 64, 80 and
# 96 at 128, 256 at its own), both types, causal and not, ragged S; widths
# that take the element-wise loads (bf16 36, float32 33); and one call of
# B * Hq > 65535 (the grid's x dimension holds it)
FLASH_WIDTHS = [((1, 384, 4, 2, d, 128, 128, dt), causal)
                for d in (32, 80, 96, 256)
                for dt in (torch.bfloat16, torch.float32)
                for causal in (True, False)]
FLASH_WIDTHS += [((1, 200, 2, 1, 36, 64, 100, torch.bfloat16), True),
                 ((2, 130, 2, 2, 33, 64, 64, torch.float32), False),
                 ((2, 64, 32800, 4100, 32, 64, 64, torch.bfloat16), True)]
# phase 4's widths: the model's, then 96 and 256 at its shape
FLASH_TIMED_D = (FLASH_MODEL["d"], 96, 256)


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
    flash_cases += FLASH_WIDTHS
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
        # the final state (return_state): C and n against plain, h the
        # same bits as without it
        es = _mlstm_state_check(ins, c, got, what)
        errs["mlstm"] = max(errs["mlstm"], e, es)
        log(f"[kernels] {what}: max|err| vs plain {e:.3e}, final C and n "
            f"{es:.3e} (tol 2e-3); h bit-identical with the state; inputs "
            f"unwritten")
    # the autotuner's chunk candidates, also at the model width and the
    # ladder's top rung: each within 2e-3 of plain and of chunk 64, but
    # not bit for bit
    for B, S, H, hw in dict.fromkeys([(1, 512, 2, 64)]
                                     + [t[:4] for t in MLSTM_TIMED]):
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


def _mlstm_state_check(ins, chunk, h_alone, what):
    """``mlstm_chunkwise(..., return_state=True)`` on ``ins``: h the same
    bits as ``h_alone`` (the call without the state), C and n within 2e-3
    of the plain version's.  Returns the larger error of C and n."""
    from repro_torch.kernels.mlstm import mlstm as ML
    from repro_torch.kernels.mlstm import ops as mlstm_ops

    h, c_state, n_state = mlstm_ops.mlstm_chunkwise(*ins, chunk=chunk,
                                                    return_state=True)
    torch.cuda.synchronize()
    if not torch.equal(h, h_alone):
        raise AssertionError(f"{what}: h differs with return_state")
    _, wc, wn = ML.mlstm_plain(*ins, chunk=chunk, return_state=True)
    return max(close(c_state, wc, 2e-3, 2e-3, what + " final C vs plain"),
               close(n_state, wn, 2e-3, 2e-3, what + " final n vs plain"))


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
    B, S, Hq, Hkv = m["B"], m["S"], m["Hq"], m["Hkv"]
    # bf16 at the bf16 tensor-core rate; float32 at the FP32 rate, the
    # arithmetic the kernel must keep (2e-4 rules out TF32), with the
    # TF32 tensor-core figure beside it; the bound counts the true d
    for d, (dt, peak) in ((d, dp) for d in FLASH_TIMED_D for dp in (
            (torch.bfloat16, PEAK_BF16_PER_S),
            (torch.float32, PEAK_FP32_PER_S))):
        q, k, v = inp.flash(B, S, Hq, Hkv, d, dt)
        esize = q.element_size()
        nbytes = esize * (2 * q.numel() + 2 * k.numel())
        flops = 4.0 * d * Hq * B * S * (S + 1) / 2  # causal: keys <= row
        bound_ms, bound_by = _bound(nbytes, flops, peak)
        extra = ({"bound_tf32_ms": _bound(nbytes, flops, PEAK_TF32_PER_S)[0]}
                 if dt == torch.float32 else {})
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rec = {
            "kernel": "flash_attention", "dtype": str(dt)[6:], "d": d,
            "padded_d": FA.padded_width(d),
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


def _device_ms_by_kernel(fn, iters: int = 10, per_call=None):
    """Device ms a call of ``fn`` spends in each kernel, by name (the
    profiler's sums over ``iters`` calls).  The split is whole or absent:
    every kernel's count must be a multiple of the calls (and, given
    ``per_call``, the kernels a call launches, their counts must sum to
    ``iters * per_call``).  The trace occasionally comes back empty or
    drops events, so a trace that fails that is taken again, once; None
    ("not measured") when that fails too or the profiler cannot trace
    the card here."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
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
        out, counts = {}, {}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", 0.0)
            if t and "kernel" in ev.key:
                name = ev.key.split("::")[-1].split("(")[0].split("<")[0]
                out[name] = out.get(name, 0.0) + t / iters / 1e3
                counts[name] = counts.get(name, 0) + ev.count
        whole = bool(counts) and all(n % iters == 0 for n in counts.values())
        if per_call is not None:
            whole = whole and sum(counts.values()) == iters * per_call
        if whole:
            return out
        log(f"[timing] the trace holds kernels {counts} for {iters} calls"
            + (f" of {per_call} kernels" if per_call is not None else ""))
    return None


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
    # the lifecycle's: llama3-8b smoke() in float32 through ServeEngine's
    # defaults (page 16, 512 pages, 32 a row), one request and an idle row
    cases += [((2, 4, 2, 16, 512, 16, 32), torch.float32, {"lengths": ln},
               "llama3-8b smoke() lifecycle width")
              for ln in ([1, 0], [5, 0], [37, 300])]
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
    PEs, from their task logs (task names carry the op as prefix), and
    the kernel launches they make: one a task, but an FFT task of a
    length that is not a power of two (``n``, the chain's length) is
    Bluestein's two FFT and three ZIP launches."""

    def __init__(self):
        self.fft = 0
        self.zip = 0
        self.fft_bluestein = 0

    def add(self, task_log, n=None):
        bluestein = n is not None and n & (n - 1) != 0
        for name, pe in task_log:
            if pe.startswith("cpu"):
                continue
            if name.startswith(("fft", "ifft")):
                self.fft += 1
                self.fft_bluestein += bluestein
            elif name.startswith("zip"):
                self.zip += 1
            else:
                raise AssertionError(f"unexpected task {name!r} on {pe}")

    def launches(self):
        """The FFT and ZIP kernel launches these tasks make."""
        return {"fft": self.fft + self.fft_bluestein,
                "zip": self.zip + 3 * self.fft_bluestein}


def _compare(build, counter, *, device, accelerators=("gpu0",), n_cpu=1,
             reps=REPS, n=None):
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
            counter.add(rt.task_log, n)
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
               session_n=2048, any_sizes=(1000, 3000), any_chains=4,
               reps=REPS, counter=None):
    from repro_torch.apps import radar
    from repro_torch.core.hete import hete_sync

    counter = counter if counter is not None else DeviceTaskCounter()
    results = []

    def drive(app, build, want_counts=None, *, accelerators=("gpu0",),
              n_cpu=1, expected=None, n=None):
        """Compare both policies on ``build``; check every output against
        numpy (``expected(bufs)`` -> [(HeteData, want)]) and the copy
        counts; record the report line."""
        runs = _compare(build, counter, device=device,
                        accelerators=accelerators, n_cpu=n_cpu, reps=reps,
                        n=n)
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
        for n in (*fft_sizes, *any_sizes):
            drive(f"2fft_{scen}_n{n}",
                  lambda c, n=n, pins=pins: radar.build_2fft(c, n, pins=pins,
                                                             seed=n),
                  counts,
                  expected=lambda b: one(b, lambda b: np.fft.ifft(
                      np.fft.fft(b["in"].data.copy()))), n=n)

    # 2FZF sweep (paper Table 1), accelerator only; range lengths that are
    # not powers of two (Bluestein's launches) after the paper's
    for n in (*fzf_sizes, *any_sizes):
        drive(f"2fzf_acc_n{n}",
              lambda c, n=n: radar.build_2fzf(c, n, pins=("gpu0",) * 4,
                                              seed=n),
              (9, 2),
              expected=lambda b: one(b, lambda b: _np_fzf(
                  b["a"].data.copy(), b["b"].data.copy())), n=n)

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

    # streaming Sessions, windowed HEFT: 16 2FZF chains at n = 2048, then a
    # few at each range length that is not a power of two
    for chains_n, sn in ((session_chains, session_n),
                         *((any_chains, n) for n in any_sizes)):
        res = {}
        for policy in POLICIES:
            with radar.make_session(policy=policy, scheduler="heft",
                                    device=device) as s:
                t0 = time.perf_counter()
                chains = [radar.submit_2fzf(s, sn, seed=100 + i,
                                            tag=f"_{i}")
                          for i in range(chains_n)]
                outs = [c["out"].result().copy() for c in chains]
                s.barrier()
                wall = time.perf_counter() - t0
                for i, (c, got) in enumerate(zip(chains, outs)):
                    _check_out(got, _np_fzf(c["a"].data.copy(),
                                            c["b"].data.copy()),
                               sn, f"session n={sn} chain {i}")
                counter.add(s.runtime.task_log, sn)
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
        results.append(_report(f"session_2fzf_{chains_n}x{sn}", res))
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
        if hasattr(mod, "backward_launches"):
            mod.backward_launches = 0


def read_counts():
    return {name: mod.launches for name, mod in kernel_modules().items()}


def read_backward_counts():
    """The backward kernels' launches (the mLSTM's and the RG-LRU's)."""
    return {name: mod.backward_launches
            for name, mod in kernel_modules().items()
            if hasattr(mod, "backward_launches")}


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
    from repro_torch.tree import leaves

    cfg = get_config("llama3_8b")
    t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_}, vocab "
        f"{cfg.vocab}; {n / 1e9:.3f} B params in {cfg.dtype}, made in "
        f"{time.perf_counter() - t0:.1f}s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return cfg, params


def serving_work(vocab):
    rng = np.random.default_rng(0)
    return [(rng.integers(1, vocab, size=int(rng.integers(*SERVE_PROMPT)))
             .tolist(), SERVE_NEW) for _ in range(SERVE_REQUESTS)]


#: the kernels a device-time profile names, the longest first
PROFILE_TOP = 10


def _profile_steps(step, n: int, own=("paged_attention",)):
    """Device time of ``n`` calls of ``step`` from the profiler's CUDA
    trace, split into the port's kernels named in ``own`` (by a part of
    their names), matrix products (cuBLAS's kernels: nvjet, gemm, gemv,
    CUTLASS) and the rest, in ms per call; None ("not measured") when the
    profiler records no device time here.  The device alone is traced,
    and its events are read as the tracer recorded them (building the
    profiler's event tree takes ~50 s for a step of 3 x 10^5 launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_name = collections.Counter()
        events = 0
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() == DeviceType.CUDA:
                by_name[ev.name()] += (ev.end_ns() - ev.start_ns()) / 1e3
                events += 1
        read = time.perf_counter() - t0 - wall
    except Exception as e:  # a measurement, not a check: report absent
        log(f"[profile] profiler unavailable ({type(e).__name__}: {e})")
        return None
    if not by_name:
        return None
    split = dict.fromkeys(own + ("matmul", "other"), 0.0)
    for name, us in by_name.items():
        low = name.lower()
        key = next((k for k in own if k in low), None) or (
            "matmul" if any(k in low for k in ("nvjet", "gemm", "gemv",
                                                "cutlass", "xmma"))
            else "other")
        split[key] += us / n / 1e3
    return {"device_ms_per_step": sum(split.values()),
            "device_ms_per_step_by_kind": split,
            "wall_ms_per_step_profiled": wall / n * 1e3,
            "trace_read_s": read, "device_events_per_step": events / n,
            "top_kernels_ms_per_step": {
                name[:80]: us / n / 1e3
                for name, us in by_name.most_common(PROFILE_TOP)}}


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


def _gates_equal(paths, baselines: Path, what: str, override=None,
                 tag: str = "[paper]"):
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
            log(f"{tag} {what} {name}.{k}: baseline {base[k]!r}"
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
    its kernel, with rows past 8192 among them.  Each gated smoke is
    traced (``benchmarks_torch.common.tracing``, linted) into
    ``out_dir/traces/TRACE_<bench>.json`` for phase 11's profile CLI."""
    from benchmarks_torch import (bench_2fft, bench_2fzf, bench_3zip,
                                  bench_alloc, bench_apps, bench_graph,
                                  bench_marking, bench_pressure,
                                  bench_stream, bench_topology, common)
    from benchmarks_torch import run as bench_run

    smoke_dir, full_dir = out_dir / "smoke", out_dir / "nightly"
    trace_dir = out_dir / "traces"
    smoke_dir.mkdir(parents=True, exist_ok=True)
    full_dir.mkdir(parents=True, exist_ok=True)
    smokes = {
        "graph": lambda jp: bench_graph.smoke(jp),
        "pressure": lambda jp: bench_pressure.run_pressure(
            ways=4, n=1 << 12, smoke=True, json_path=jp),
        "stream": lambda jp: bench_stream.run_stream(
            clients=4, chains=6, n=1 << 13, smoke=True, json_path=jp),
        "topology": lambda jp: bench_topology.run_topology(
            ways=4, n=1 << 13, depth=2, smoke=True, json_path=jp),
    }
    times = {}
    reset_counts()
    with RuntimeTaskCounter() as counter:
        t0 = time.perf_counter()
        for bench, smoke in smokes.items():
            with common.tracing(str(trace_dir), bench):
                smoke(str(smoke_dir / f"BENCH_{bench}.json"))
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
        "max_fft_n": counter.max_fft_n}, "seconds": times,
        "traces": [trace_dir / f"TRACE_{b}.json" for b in smokes]}


# ----------------------------------------------------------- 11. runtime
#: multitenant depths: (n, light chains, heavy chains) and the committed
#: record its gate must equal
MULTITENANT_DEPTHS = (("smoke", (1 << 12, 4, 24), BASELINES),
                      ("nightly", (1 << 13, 8, 64), BASELINES / "nightly"))
#: the four sections the profile CLI prints for every trace
PROFILE_HEADINGS = ("### Top ops by wall time", "### Top ops by modeled time",
                    "### Critical path", "### Wall/modeled divergence")


def _multitenant(depth, dims, baselines, out_dir: Path):
    """One traced ``run_multitenant`` on ``cuda:0`` (device ``None``) with
    the bench's own smoke asserts (light chains bit-identical between the
    mix and solo runs, no light SLO violated, the heavy tenant's burn rate
    above 1, the mix's tasks all completed), its gate exactly equal to
    ``baselines``, every case's tasks completed, and every fft/ifft/zip
    task launched as the port's kernel."""
    from benchmarks_torch import bench_multitenant as mt, common

    n, lc, hc = dims
    rec_dir = out_dir / depth
    rec_dir.mkdir(parents=True, exist_ok=True)
    path = rec_dir / "BENCH_multitenant.json"
    reset_counts()
    with RuntimeTaskCounter() as counter:
        t0 = time.perf_counter()
        with common.tracing(str(out_dir / "traces"), f"multitenant_{depth}",
                            metrics_dir=str(out_dir / "metrics")):
            rec = mt.run_multitenant(n=n, light_chains=lc, heavy_chains=hc,
                                     json_path=str(path), smoke=True)
        seconds = time.perf_counter() - t0
    launches = read_counts()
    _gates_equal([path], baselines, depth, tag="[runtime]")
    for case in ("solo", "mix", "unbounded"):
        if rec[case]["n_completed"] != rec[case]["n_tasks"]:
            raise AssertionError(f"multitenant {depth} {case}: "
                                 f"{rec[case]['n_completed']} of "
                                 f"{rec[case]['n_tasks']} tasks completed")
    chains = 3 * mt.N_LIGHTS * lc + 2 * hc  # solo, mix and unbounded
    want = {"fft": 3 * chains, "zip": chains}
    got = {"fft": launches["fft"], "zip": launches["zip"]}
    log(f"[runtime] multitenant {depth} (n {n}, {lc}/{hc} chains) in "
        f"{seconds:.1f}s: wall s solo {rec['solo']['wall_s']:.4f}, mix "
        f"{rec['mix']['wall_s']:.4f}, unbounded "
        f"{rec['unbounded']['wall_s']:.4f}; light p95 over solo "
        f"{rec['light_p95_over_solo']!r}, heavy burn rate "
        f"{rec['slo']['heavy']['burn_rate']!r}; device tasks fft/ifft "
        f"{counter.fft}, zip {counter.zip}; kernel launches {got}")
    if counter.other or (counter.fft, counter.zip) != (want["fft"],
                                                       want["zip"]):
        raise AssertionError(f"multitenant {depth}: device tasks fft "
                             f"{counter.fft} zip {counter.zip} (other "
                             f"{set(counter.other)}), expected {want}")
    if got != want:
        raise AssertionError(f"multitenant {depth}: kernel launches {got} "
                             f"!= device tasks {want}")
    return {"launches": got, "seconds": seconds,
            "wall_s": {c: rec[c]["wall_s"]
                       for c in ("solo", "mix", "unbounded")}}


def _profile_cli(paths, out_dir: Path):
    """``python -m repro_torch.profile`` on every trace in ``paths``: exit
    0 and the four section headings; then exit 1 on a malformed trace and
    on a missing one."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def cli(path):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.profile", str(path)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)

    for path in paths:
        proc = cli(path)
        if proc.returncode != 0:
            raise AssertionError(f"profile {path} exited {proc.returncode}:"
                                 f"\n{proc.stderr[-3000:]}")
        missing = [h for h in PROFILE_HEADINGS if h not in proc.stdout]
        if missing:
            raise AssertionError(f"profile {path}: no {missing}")
        if "multitenant" in path.name and not (
                "| fft |" in proc.stdout and " tasks, " in proc.stdout
                and "| compute | " in proc.stdout):
            raise AssertionError(f"profile {path}: no fft rows, critical "
                                 f"path or compute divergence cells")
        path_line = next((ln for ln in proc.stdout.splitlines()
                          if " tasks, " in ln), "no critical path")
        log(f"[runtime] profile {path.name}: exit 0, "
            f"{len(proc.stdout.splitlines())} lines; {path_line}")
    bad = out_dir / "TRACE_malformed.json"
    bad.write_text('{"traceEvents": [')
    for path in (bad, out_dir / "TRACE_missing.json"):
        proc = cli(path)
        if proc.returncode != 1:
            raise AssertionError(f"profile {path.name} exited "
                                 f"{proc.returncode}, not 1")
        log(f"[runtime] profile {path.name}: exit 1 "
            f"({proc.stderr.strip().splitlines()[-1]})")


#: interleaved repeats of each ``bench_overhead`` median, of 20 000 calls
#: each (the CLI's default is the reference's 5): on the card's shared
#: host, slow spells of about twice the ns/call last several 100 ms
#: repeats, so a median of 5 crossed the 1.30 gate with the hot path
#: unchanged (ROADMAP C.13); 20 ms repeats spread each spell over every
#: configuration alike
OVERHEAD_REPEATS = 101


def phase_runtime(out_dir: Path, suite_traces):
    """The runtime's observability and QoS surface on ``cuda:0``:
    ``bench_multitenant`` at smoke and nightly depth (gates equal to
    ``benchmarks/baselines/`` and ``.../nightly/``, light chains bit-identical
    between the mix and solo runs, no light SLO violated and the heavy
    tenant's burn rate above 1, every task completed, one kernel launch
    per device task), ``bench_overhead`` at 20 000 calls and
    ``OVERHEAD_REPEATS`` repeats with its smoke asserts (host timings),
    and the profile CLI over every trace this phase and phase 10 wrote.  Records go to ``out_dir``."""
    from benchmarks_torch import bench_overhead, common

    out_dir.mkdir(parents=True, exist_ok=True)
    runs = {depth: _multitenant(depth, dims, baselines, out_dir)
            for depth, dims, baselines in MULTITENANT_DEPTHS}

    t0 = time.perf_counter()
    try:
        ov = bench_overhead.run(n_calls=20_000, smoke=True,
                                repeats=OVERHEAD_REPEATS)
    except AssertionError as e:
        raise AssertionError(
            f"[runtime] overhead gate: {e}. A crossing in only some "
            f"repeats, with no change to the flag-hit path, is the host "
            f"noise recorded as ROADMAP C.13; a regression of the hot "
            f"path moves every repeat") from e
    overhead = {
        "host_cpu": common.host_cpu(),
        "ns_per_call": {"baseline": ov["flag"]["baseline"],
                        "traced": ov["flag"]["traced"],
                        "paused": ov["flag"]["paused"],
                        "sampler_off": ov["sampled"]["off"],
                        "sampler_on": ov["sampled"]["on"]},
        "ns_per_event": ov["instant"],
        "ratios": {k: ov[f"ratio_{k}"]
                   for k in ("traced", "paused", "sampled")},
        "seconds": time.perf_counter() - t0}
    log("[runtime] overhead " + json.dumps(overhead))

    traces = sorted((out_dir / "traces").glob("TRACE_*.json"))
    _profile_cli(traces + list(suite_traces), out_dir)
    return {"multitenant": runs, "overhead": overhead,
            "launches": {k: sum(r["launches"][k] for r in runs.values())
                         for k in ("fft", "zip")}}


# ----------------------------------------------------- 12. recurrent path
#: phase 12's generation: arch, batch, prompt tokens, greedy decode steps
#: (recurrentgemma's prompt is longer than its 2048-token window)
RECURRENT = (("xlstm_350m", 2, 2048, 16), ("recurrentgemma_2b", 2, 3072, 16))
#: each model's hand-written kernel, the layer whose own inputs it is held
#: against its plain version on (the second of its kind), and the
#: tolerance there (phase 3's: mLSTM 2e-3, RG-LRU bit-equal)
RECURRENT_KERNEL = {"xlstm_350m": ("mlstm", 2, 2e-3),
                    "recurrentgemma_2b": ("rg_lru", 1, 0.0)}
#: float32 prefill <-> decode: |logits difference| <= RTOL * max|logit| +
#: ATOL, the reference's rtol = atol = 2e-3 (tests/test_models_smoke.py)
RECURRENT_TOL = 2e-3


def full_width_model(dev, arch, dtype=None, seed=0):
    """``arch`` at full width and depth with random weights from the
    port's ``Model.init`` and a seeded generator on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import leaves

    cfg = get_config(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    log(f"[{cfg.family}] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n / 1e9:.3f} B params in {cfg.dtype}, made in "
        f"{time.perf_counter() - t0:.1f}s")
    return cfg, model, params


def _prompt(cfg, batch, s, dev, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(1, cfg.vocab, size=(batch, s)),
                           device=dev)


def _generate(model, params, prefill, prompt, n_new, finite):
    """``prefill(model, params, prompt, max_len)`` (``Model.prefill``)
    then ``n_new`` greedy ``decode_step``s, each call's all-finite flag
    appended to ``finite``.  Raises if a decode step launched a kernel.  Returns the
    tokens (prefill's and each step's), the walls of the prefill and the
    decode loop, and what the loop ends with (caches, next token, next
    position) for more steps."""
    B, S = prompt.shape
    dev = prompt.device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(model, params, prompt, S + n_new + 8)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    finite.append(torch.isfinite(logits).all())
    tok = torch.argmax(logits, dim=-1)
    toks = [tok]
    before = read_counts()
    for i in range(n_new):
        logits, caches = model.decode_step(
            params, caches, tok, torch.full((B,), S + i, device=dev))
        finite.append(torch.isfinite(logits).all())
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if read_counts() != before:
        raise AssertionError(f"{model.cfg.name}: decode launched kernels "
                             f"{before} -> {read_counts()}")
    return (torch.stack(toks, dim=1), t1 - t0, t2 - t1,
            {"caches": caches, "tok": tok, "pos": S + n_new})


def _layer_input(model, params, prompt, li):
    """The residual stream that enters layer ``li`` in a prefill of
    ``prompt``."""
    from repro_torch.models.model_api import BLOCKS, layer_kinds

    kinds = layer_kinds(model.cfg)
    x = model._embed(params, {"tokens": prompt})
    for i in range(li):
        x, _ = BLOCKS[kinds[i]].apply(model.cfg, params["layers"][i], x,
                                      mode="prefill",
                                      extras={"max_len": prompt.shape[1]})
    return x


def _path_kernel_check(model, params, prompt, arch):
    """The model's kernel against its plain version on what its layer
    builds for it from the path's own activations: mLSTM h, C and n
    within 2e-3 (and h the same bits without the state), RG-LRU h_seq
    and h_final bit-equal.  Returns the largest error and the shape."""
    from repro_torch.kernels.mlstm import mlstm as ML
    from repro_torch.kernels.mlstm import ops as mlstm_ops
    from repro_torch.kernels.rg_lru import ops as rg_ops
    from repro_torch.kernels.rg_lru import rg_lru as RL
    from repro_torch.models.recurrent import MLSTMLayer, RGLRULayer

    kernel, li, tol = RECURRENT_KERNEL[arch]
    cfg = model.cfg
    x = _layer_input(model, params, prompt, li)
    what = f"{cfg.name} layer {li} {kernel}"
    if kernel == "mlstm":
        ins = MLSTMLayer.kernel_inputs(cfg, params["layers"][li], x)
        chunk = MLSTMLayer.prefill_chunk(cfg, prompt.shape[1])
        got = mlstm_ops.mlstm_chunkwise(*ins, chunk=chunk, return_state=True)
        want = ML.mlstm_plain(*ins, chunk=chunk, return_state=True)
        torch.cuda.synchronize()
        err = max(close(g, w, tol, tol, f"{what} {name} vs plain")
                  for g, w, name in zip(got, want, ("h", "C", "n")))
        if not torch.equal(got[0], mlstm_ops.mlstm_chunkwise(*ins,
                                                             chunk=chunk)):
            raise AssertionError(f"{what}: h differs with return_state")
        shape = f"B{ins[0].shape[0]} S{ins[0].shape[1]} H{ins[0].shape[2]} " \
                f"m{ins[0].shape[3]} chunk{chunk}"
    else:
        a, b = RGLRULayer.kernel_inputs(cfg, params["layers"][li], x)
        h0 = a.new_zeros((a.shape[0], a.shape[2]))
        got = rg_ops.rg_lru_scan(a, b, h0)
        want = RL.rg_lru_plain(a, b, h0)
        torch.cuda.synchronize()
        err = max(max_err(g, w) for g, w in zip(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{what}: not bit-equal to the plain scan "
                                 f"(max |err| {err:.3e})")
        shape = f"B{a.shape[0]} S{a.shape[1]} D{a.shape[2]}"
    log(f"[recurrent] {what} at {shape} on the path's activations: max|err| "
        f"vs plain {err:.3e} (tol {tol})")
    return err, shape


def _path_kernel_bound(arch, B, S, cfg):
    """The least time one call of the model's kernel could take at the
    path's shape (phase 4's bounds)."""
    from repro_torch.models.recurrent import MLSTMLayer

    if RECURRENT_KERNEL[arch][0] == "mlstm":
        H, m = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
        nbytes, products, _ = mlstm_work(B, S, H, m,
                                         MLSTMLayer.prefill_chunk(cfg, S))
        return _bound(nbytes, 3 * products, PEAK_TF32_PER_S)
    D = cfg.d_model
    return _bound(4.0 * (3 * B * S * D + 2 * B * D), 2.0 * B * S * D)


def phase_recurrent(dev):
    """Both recurrent families at full width and depth on ``cuda:0``:
    bf16 generation (prefill, 16 greedy decode steps; finite logits,
    tokens in range), a device-time profile of one prefill and five decode
    steps, each kernel against its plain version on its layer's own
    inputs, and float32 prefill <-> decode agreement.  The mLSTM launches
    once per mLSTM layer and prefill, the RG-LRU once per RG-LRU layer and
    prefill, neither in decode; launches made to compare a kernel with its
    plain version are taken out of the counts returned."""
    from repro_torch.models.model_api import layer_kinds

    reset_counts()
    prefills = collections.Counter()
    compare = collections.Counter()
    want = collections.Counter()
    records = {}

    def prefill(model, params, tokens, max_len):  # each one counted
        prefills[arch] += 1
        return model.prefill(params, {"tokens": tokens}, max_len=max_len)

    for arch, B, S, n_new in RECURRENT:
        kernel = RECURRENT_KERNEL[arch][0]
        cfg, model, params = full_width_model(dev, arch)
        finite = []
        # warm the path (allocator, cuBLAS) on a short prompt
        _generate(model, params, prefill, _prompt(cfg, B, 128, dev, 1), 2,
                  finite)
        prompt = _prompt(cfg, B, S, dev, 2)
        toks, prefill_s, decode_s, cont = _generate(
            model, params, prefill, prompt, n_new, finite)
        if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
            raise AssertionError(f"{cfg.name}: a token out of range")
        prof_prefill = _profile_steps(
            lambda: prefill(model, params, prompt, S + n_new + 8), 1,
            own=(kernel,))

        def step():
            logits, cont["caches"] = model.decode_step(
                params, cont["caches"], cont["tok"],
                torch.full((B,), cont["pos"], device=dev))
            finite.append(torch.isfinite(logits).all())
            cont["tok"], cont["pos"] = torch.argmax(logits, -1), \
                cont["pos"] + 1

        prof_decode = _profile_steps(step, 5, own=(kernel,))
        if not bool(torch.stack(finite).all()):
            raise AssertionError(f"{cfg.name}: NaN or Inf in the logits")
        before = read_counts()
        err, shape = _path_kernel_check(model, params, prompt, arch)
        compare.update({k: v - before[k] for k, v in read_counts().items()})
        per_prefill = layer_kinds(cfg).count(
            "mlstm" if kernel == "mlstm" else "rec")
        bound_ms, bound_by = _path_kernel_bound(arch, B, S, cfg)
        dev_ms = (None if prof_prefill is None else
                  prof_prefill["device_ms_per_step_by_kind"][kernel])
        records[arch] = {
            "kernel": kernel, "batch": B, "prompt": S, "new_tokens": n_new,
            "prefill_wall_ms": prefill_s * 1e3,
            "ms_per_decode_step": decode_s / n_new * 1e3,
            "prefill_device_ms": (None if prof_prefill is None else
                                  prof_prefill["device_ms_per_step"]),
            "prefill_busy_share": (
                None if prof_prefill is None else
                prof_prefill["device_ms_per_step"] / (prefill_s * 1e3)),
            "kernel_launches_per_prefill": per_prefill,
            "kernel_shape": shape, "kernel_max_abs_err": err,
            "kernel_device_ms_per_call": (None if dev_ms is None
                                          else dev_ms / per_prefill),
            "kernel_bound_ms": bound_ms, "kernel_bound_by": bound_by,
            "prefill_profile": prof_prefill, "decode_profile": prof_decode,
            "tokens_head": toks[0, :8].tolist()}
        log(f"[recurrent] {cfg.name} bf16 generation: " + json.dumps(
            {k: v for k, v in records[arch].items()
             if not k.endswith("_profile")}))
        log(f"[recurrent] {cfg.name} prefill profile: "
            + json.dumps(prof_prefill))
        log(f"[recurrent] {cfg.name} decode profile (five steps): "
            + json.dumps(prof_decode))
        del params, model, cont
        torch.cuda.empty_cache()

        # float32 prefill <-> decode at full width and depth
        cfg32, model32, params32 = full_width_model(dev, arch, "float32")
        prompt = _prompt(cfg32, B, S, dev, 3)
        full, _ = prefill(model32, params32, prompt, S + 8)
        _, caches = prefill(model32, params32, prompt[:, :-1], S + 8)
        before = read_counts()
        last, _ = model32.decode_step(params32, caches, prompt[:, -1],
                                      torch.full((B,), S - 1, device=dev))
        torch.cuda.synchronize()
        if read_counts() != before:
            raise AssertionError(f"{cfg.name}: decode launched a kernel")
        e = close(last, full, RECURRENT_TOL, RECURRENT_TOL,
                  f"{cfg.name} float32 prefill(prompt) vs prefill(prompt[:-1])"
                  f" + decode_step")
        records[arch]["f32_prefill_decode_max_abs_err"] = e
        records[arch]["f32_max_abs_logit"] = full.abs().max().item()
        log(f"[recurrent] {cfg.name} float32: prefill of {S} tokens against "
            f"prefill of {S - 1} + decode_step: max|err| {e:.3e} (limit "
            f"{RECURRENT_TOL} * (1 + max|logit| "
            f"{records[arch]['f32_max_abs_logit']:.4g}))")
        del params32, model32, caches
        torch.cuda.empty_cache()
        want[kernel] += per_prefill * prefills[arch]

    # one launch per layer of the kernel's kind and prefill (mLSTM 12,
    # RG-LRU 18 at full depth), none in decode nor of any other kernel
    counts = {k: v - compare[k] for k, v in read_counts().items()}
    if any(counts[k] != want[k] for k in counts):
        raise AssertionError(f"recurrent path launches {counts}, want "
                             f"{dict(want)} and no other kernel "
                             f"({dict(prefills)} prefills)")
    log(f"[recurrent] path launches {counts} for prefills "
        f"{dict(prefills)} (comparisons {dict(compare)} taken out)")
    return records, counts


# ------------------------------------------- 13. MoE, audio and training
#: (a), (b): arch, batch, prompt tokens, greedy decode steps
MOE_SERVE = ("granite_moe_3b_a800m", 2, 2048, 16)
AUDIO_SERVE = ("whisper_large_v3", 2, 64, 16)
#: the MoE layer held card against CPU in float32: the second layer, on
#: its normed input from the bf16 prefill; outputs within MOE_TOL * max|y|
MOE_CHECK_LAYER, MOE_TOL = 1, 1e-4
#: (c): train_4k's sequence, the batch cut from 256 to 1 for one card
TRAIN = dict(arch="granite_moe_3b_a800m", batch=1, seq=4096, steps=3)
#: the archs whose smoke() loss gradient phase 13 holds card against CPU
#: in float32, each leaf within TRAIN_GRAD_TOL * max|g| (the MoE and
#: audio blocks' backward; the loss's chunked recompute; per-layer remat);
#: phase 14 holds RECURRENT_TRAIN_ARCHS so, through the mLSTM and RG-LRU
#: backward kernels
TRAIN_GRAD_ARCHS = ("granite_moe_3b_a800m", "whisper_large_v3")
RECURRENT_TRAIN_ARCHS = ("xlstm_350m", "recurrentgemma_2b")
TRAIN_GRAD_TOL = 1e-4
#: bytes a parameter while training: float32 weights, gradients, m, v
TRAIN_BYTES_PER_PARAM = 16
#: GiB an earlier phase may leave allocated when training starts
TRAIN_LEFT_GIB = 1.0
#: the Trainer's step that runs under the profiler (a warm one, not the
#: last, whose wall gives tokens/s)
PROFILED_STEP = 2
#: phase 13's profiles split device time by these parts of kernel names
#: (first match): float32 products (attention's einsums), softmax, sorts,
#: gathers and scatters, dtype casts and copies, other elementwise,
#: reductions; then cuBLAS's bf16 products ("matmul") and the rest
P13_KINDS = ("gemm_f32f32", "softmax", "sort", "index", "copy",
             "elementwise", "reduce")


def _frames(cfg, batch, dev, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(
        (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32), device=dev)


def _served_generation(dev, arch, B, S, n_new, extra_batch=None):
    """``arch`` at full width and depth in bf16: a warm prefill and two
    steps on a short prompt, then a prefill of ``B`` x ``S`` and ``n_new``
    greedy decode steps (finite logits, tokens in range), and a
    device-time profile of one prefill.  ``extra_batch(cfg, batch)``
    gives the rest of a prefill's batch (the audio frames).  Returns the
    record, the model, its params and the prompt's batch."""
    cfg, model, params = full_width_model(dev, arch)
    made = {}  # the rest of the batch by batch size, made once

    def extra(b):
        if b not in made:
            made[b] = extra_batch(cfg, b) if extra_batch else {}
        return made[b]

    def prefill(model, params, tokens, max_len):
        batch = {"tokens": tokens, **extra(tokens.shape[0])}
        return model.prefill(params, batch, max_len=max_len)

    finite = []
    with torch.inference_mode():
        _generate(model, params, prefill, _prompt(cfg, B, 64, dev, 1), 2,
                  finite)
        prompt = _prompt(cfg, B, S, dev, 2)
        toks, prefill_s, decode_s, cont = _generate(model, params, prefill,
                                                    prompt, n_new, finite)
        prof = _profile_steps(lambda: prefill(model, params, prompt,
                                              S + n_new + 8), 1,
                              own=P13_KINDS)

        def step():
            logits, cont["caches"] = model.decode_step(
                params, cont["caches"], cont["tok"],
                torch.full((B,), cont["pos"], device=dev))
            finite.append(torch.isfinite(logits).all())
            cont["tok"], cont["pos"] = torch.argmax(logits, -1), \
                cont["pos"] + 1

        prof_decode = _profile_steps(step, 5, own=P13_KINDS)
    if not bool(torch.stack(finite).all()):
        raise AssertionError(f"{cfg.name}: NaN or Inf in the logits")
    if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"{cfg.name}: a token out of range")
    rec = {"arch": arch, "batch": B, "prompt": S, "new_tokens": n_new,
           "prefill_wall_ms": prefill_s * 1e3,
           "ms_per_decode_step": decode_s / n_new * 1e3,
           "prefill_device_ms": (None if prof is None
                                 else prof["device_ms_per_step"]),
           "prefill_busy_share": (None if prof is None else
                                  prof["device_ms_per_step"]
                                  / (prefill_s * 1e3)),
           "decode_busy_share": (None if prof_decode is None else
                                 prof_decode["device_ms_per_step"]
                                 / (decode_s / n_new * 1e3)),
           "prefill_profile": prof, "decode_profile": prof_decode,
           "tokens_head": toks[0, :8].tolist()}
    return rec, cfg, model, params, {"tokens": prompt, **extra(B)}


def _moe_prefill(cfg, model, params, batch, max_len):
    """A prefill of ``batch`` walked layer by layer, each MoE layer's
    routing read from ``moe_apply(..., return_routing=True)`` on the
    input its MoE gets; each step of the walk must give its layer's own
    output bit for bit.  Returns the share of (token, expert) slots
    dropped over capacity, over all MoE layers, and the input layer
    ``MOE_CHECK_LAYER``'s MoE got."""
    from repro_torch.models import blocks
    from repro_torch.models import layers as L

    kept = total = 0
    extras = {"max_len": max_len}
    with torch.inference_mode():
        x = model._embed(params, batch)
        for li, p in enumerate(params["layers"]):
            h = L.norm_apply(cfg, p["norm1"], x)
            attn, _ = blocks._self_attention(cfg, p["attn"], h,
                                             mode="prefill", cache=None,
                                             pos=None, extras=extras)
            mid = x + attn @ p["attn"]["wo"].to(x.dtype)
            h = L.norm_apply(cfg, p["norm2"], mid)
            y, routing = blocks.moe_apply(cfg, p["moe"], h,
                                          return_routing=True)
            want, _ = blocks.MoELayer.apply(cfg, p, x, mode="prefill",
                                            extras=extras)
            x = mid + y
            if not torch.equal(x, want):
                raise AssertionError(f"{cfg.name}: the walk's layer {li} "
                                     f"differs from MoELayer.apply")
            kept += int(routing["keep"].sum())
            total += routing["keep"].numel()
            if li == MOE_CHECK_LAYER:
                check_input = h
    return 1.0 - kept / total, check_input


def _moe_layer_check(cfg, params, x):
    """One MoE layer at full width in float32 on the card and on the
    CPU, the same input (``x``, what layer ``MOE_CHECK_LAYER``'s MoE got
    in the bf16 prefill, widened) and weights: the same expert ids and
    keep mask, outputs within MOE_TOL * max|y|, and the gradients of
    sum(y * r) (``r`` seeded) with respect to the input and to each
    weight within MOE_TOL * max|g| of the CPU's."""
    import dataclasses

    from repro_torch.models import blocks

    li = MOE_CHECK_LAYER
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    moe = params["layers"][li]["moe"]
    r = torch.as_tensor(np.random.default_rng(6).standard_normal(
        tuple(x.shape)).astype(np.float32))
    runs = {}
    for where in ("card", "cpu"):
        dev = x.device if where == "card" else torch.device("cpu")
        # fresh float32 leaves (x and its layer's weights were made
        # under inference_mode)
        ins = {k: torch.zeros(v.shape, device=dev).copy_(v)
               .requires_grad_(True)
               for k, v in {"x": x, **moe}.items()}
        w = {k: v for k, v in ins.items() if k != "x"}
        y, routing = blocks.moe_apply(cfg32, w, ins["x"],
                                      return_routing=True)
        grads = torch.autograd.grad((y * r.to(dev)).sum(),
                                    list(ins.values()))
        runs[where] = (y.detach().cpu(), routing,
                       {k: g.cpu() for k, g in zip(ins, grads)})
        if where == "card":
            torch.cuda.synchronize()
    (got, r_got, g_got), (want, r_want, g_want) = runs["card"], runs["cpu"]
    for key in ("experts", "keep"):
        if not torch.equal(r_got[key].cpu(), r_want[key]):
            n = int((r_got[key].cpu() != r_want[key]).sum())
            raise AssertionError(f"{cfg.name} MoE layer {li}: {key} differ "
                                 f"card vs CPU in {n} of "
                                 f"{r_want[key].numel()}")
    err = close(got, want, MOE_TOL, 0.0,
                f"{cfg.name} MoE layer {li} float32 card vs CPU")
    grad_err = {k: close(g_got[k], g, MOE_TOL, 0.0,
                         f"{cfg.name} MoE layer {li} float32 gradient of "
                         f"{k} card vs CPU")
                for k, g in g_want.items()}
    return {"layer": li, "tokens": x.shape[0] * x.shape[1],
            "capacity": r_want["capacity"],
            "dropped_share": 1.0 - float(r_want["keep"].float().mean()),
            "max_abs_err": err, "max_abs_y": want.abs().max().item(),
            "grad_max_abs_err": grad_err,
            "grad_max_abs": {k: g.abs().max().item()
                             for k, g in g_want.items()}}


def _audio_f32_check(dev, arch, B, S):
    """whisper in float32 at full width and depth: prefill(prompt)
    against prefill(prompt[:-1]) + decode_step, the encoder's keys and
    values read from the cache, within RECURRENT_TOL * (1 + max|logit|)."""
    cfg, model, params = full_width_model(dev, arch, "float32")
    prompt = _prompt(cfg, B, S, dev, 3)
    frames = _frames(cfg, B, dev, 4)
    with torch.inference_mode():
        full, _ = model.prefill(params, {"tokens": prompt, "frames": frames},
                                max_len=S + 8)
        _, caches = model.prefill(params, {"tokens": prompt[:, :-1],
                                           "frames": frames}, max_len=S + 8)
        last, _ = model.decode_step(params, caches, prompt[:, -1],
                                    torch.full((B,), S - 1, device=dev))
    torch.cuda.synchronize()
    err = close(last, full, RECURRENT_TOL, RECURRENT_TOL,
                f"{cfg.name} float32 prefill(prompt) vs prefill(prompt[:-1])"
                f" + decode_step")
    return err, full.abs().max().item()


def _prints(tree):
    """Each leaf's float64 sum and sum of squares: a leaf that moved
    changes one of them."""
    from repro_torch.tree import leaves

    return torch.stack([torch.stack([p.double().sum(),
                                     p.double().square().sum()])
                        for p in leaves(tree)])


def _train_grad_check(dev, archs):
    """The gradient of ``Model.loss`` (remat on) on the card against the
    CPU's, from the same float32 weights and batch, for each of ``archs``
    at ``smoke()`` size: the loss within TRAIN_GRAD_TOL
    relative, each leaf's gradient within TRAIN_GRAD_TOL * max|g| of the
    CPU's.  Returns the largest error relative to its leaf's max|g|."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, leaves_with_paths, map_tree

    out = {}
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        batch = TokenPipeline(cfg, 2, 32, seed=0).batch_at(0)
        runs = {}
        for where in ("card", "cpu"):
            d = dev if where == "card" else torch.device("cpu")
            p = map_tree(lambda t: t.to(d).requires_grad_(True), params)
            b = {k: torch.as_tensor(v, device=d) for k, v in batch.items()}
            loss = model.loss(p, b, remat=True)
            loss.backward()
            runs[where] = (loss.item(), [t.grad.cpu() if t.grad is not None
                                         else torch.zeros(t.shape)
                                         for t in leaves(p)])
        (l_got, g_got), (l_want, g_want) = runs["card"], runs["cpu"]
        if not abs(l_got - l_want) <= TRAIN_GRAD_TOL * abs(l_want):
            raise AssertionError(f"{arch} smoke loss card {l_got} vs CPU "
                                 f"{l_want}")
        worst = 0.0
        for (path, _), got, want in zip(leaves_with_paths(params), g_got,
                                        g_want):
            err = close(got, want, TRAIN_GRAD_TOL, 0.0,
                        f"{arch} smoke float32 gradient of "
                        f"{'/'.join(map(str, path))} card vs CPU")
            top = want.abs().max().item()
            worst = max(worst, err / top if top else err)
        out[arch] = {"loss": l_want, "leaves": len(g_want),
                     "max_rel_grad_err": worst}
    return out


def _train_full_width(dev, out_dir: Path, spec=TRAIN, own=P13_KINDS):
    """``spec["arch"]`` at full width and depth through the port's
    ``Trainer`` on ``cuda:0``: float32 master weights, bf16 compute, AdamW,
    per-layer remat, ``spec``'s batch x seq and steps, no checkpoint.  The
    record holds the kernel launches of the steps (forward, backward),
    counted over ``Trainer.run``, and the device time of the Trainer's own
    step PROFILED_STEP (its wall in ``sec_per_step`` includes the
    tracing; tokens/s and the busy share are read off the last step)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.loop import Trainer, TrainerConfig

    cfg = get_config(spec["arch"])
    n_params = build_model(cfg).param_counts()["total"]
    reckon_gib = n_params * TRAIN_BYTES_PER_PARAM / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, spec["batch"], spec["seq"], TrainerConfig(
        steps=spec["steps"], ckpt_every=10 ** 9, log_every=1,
        ckpt_dir=str(out_dir / "unused_ckpt")), device=dev)
    trainer.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    before = _prints(trainer.params)
    step_fn, calls, prof = trainer.step_fn, itertools.count(1), {}

    def traced(*args):
        if next(calls) != PROFILED_STEP:
            return step_fn(*args)
        out = []
        prof["step"] = _profile_steps(lambda: out.append(step_fn(*args)), 1,
                                      own=own)
        # the profiler failed before the step ran: run it untraced
        return out[0] if out else step_fn(*args)

    trainer.step_fn = traced
    fwd0, bwd0 = read_counts(), read_backward_counts()
    report = trainer.run()
    launches = {"forward": {k: v - fwd0[k] for k, v in read_counts().items()},
                "backward": {k: v - bwd0[k]
                             for k, v in read_backward_counts().items()}}
    peak = torch.cuda.max_memory_allocated()
    # every leaf some step gave a nonzero gradient (its first moment is
    # not 0) moved
    from repro_torch.tree import leaves, leaves_with_paths

    nonzero = torch.stack([(m != 0).any()
                           for m in leaves(trainer.opt_state["m"])])
    moved = (_prints(trainer.params) != before).any(dim=1)
    stuck = (nonzero & ~moved).cpu()
    if bool(stuck.any()):
        paths = [p for p, _ in leaves_with_paths(trainer.params)]
        raise AssertionError(
            "leaves with a nonzero gradient did not move: "
            + ", ".join("/".join(map(str, paths[i]))
                        for i in torch.nonzero(stuck).flatten()[:8]))
    update_check = {"leaves": len(nonzero),
                    "nonzero_grad": int(nonzero.sum()),
                    "moved": int(moved.sum())}
    metrics = report["metrics"]
    if [m["step"] for m in metrics] != list(range(1, spec["steps"] + 1)):
        raise AssertionError(f"training logged steps "
                             f"{[m['step'] for m in metrics]}")
    for m in metrics:
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"training step {m['step']}: loss "
                                 f"{m['loss']}, grad norm {m['grad_norm']}")
    # one host->device copy per batch leaf (tokens, labels) and step, of
    # the reference's bytes (int32 (batch, seq))
    tr = report["transfers"]
    want_copies = 2 * spec["steps"]
    want_bytes = want_copies * spec["batch"] * spec["seq"] * 4
    if (tr["total_copies"], tr["total_bytes"]) != (want_copies, want_bytes) \
            or tr["by_pair"] != {"host:cpu->device:gpu0": want_copies}:
        raise AssertionError(f"training ledger {tr['by_pair']}, "
                             f"{tr['total_bytes']} bytes; want "
                             f"{want_copies} host->device copies of "
                             f"{want_bytes} bytes")
    # the AdamW update alone (its gradients: the first moments, any
    # float32 tree)
    from repro_torch.optim.adamw import AdamWConfig, adamw_update

    prof_step = prof.get("step")
    prof_adamw = _profile_steps(lambda: adamw_update(
        AdamWConfig(), trainer.opt_state["m"], trainer.opt_state,
        trainer.params), 1, own=own)
    last = metrics[-1]["sec_per_step"]
    rec = {"arch": spec["arch"], "batch": spec["batch"],
           "seq": spec["seq"], "steps": spec["steps"],
           "params": n_params, "init_s": init_s,
           "sec_per_step": [m["sec_per_step"] for m in metrics],
           "tokens_per_s_last_step": spec["batch"] * spec["seq"] / last,
           "loss": [m["loss"] for m in metrics],
           "grad_norm": [m["grad_norm"] for m in metrics],
           "update_check": update_check,
           "max_memory_allocated_gib": peak / 2 ** 30,
           "reckoned_state_gib": reckon_gib,
           "ledger": {k: tr[k] for k in ("total_copies", "total_bytes",
                                         "by_pair")},
           "launches": launches,
           "profiled_step": PROFILED_STEP,
           "step_busy_share": (None if prof_step is None else
                               prof_step["device_ms_per_step"] / 1e3 / last),
           "step_profile": prof_step, "adamw_profile": prof_adamw}
    del trainer
    return rec


def _lifecycle(dev, out_dir: Path):
    """``tests/test_system.py``'s train-then-serve on the card:
    llama3-8b ``smoke()`` in float32 trains 3 steps, checkpoints,
    restores bit for bit, then ``ServeEngine`` serves one request (the
    paged-attention kernel), with the tokens ``ServeEngine`` on the CPU
    (the plain version) gives.  Returns the record and the launches."""
    import dataclasses
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.checkpoint import restore_checkpoint
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.tree import leaves, map_tree

    cfg = dataclasses.replace(get_config("llama3_8b").smoke(),
                              dtype="float32")
    ckpt = out_dir / "lifecycle_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    trainer = Trainer(cfg, batch_size=2, seq_len=16, tcfg=TrainerConfig(
        steps=3, ckpt_every=3, ckpt_dir=str(ckpt)), device=dev)
    report = trainer.run()
    if report["final_step"] != 3:
        raise AssertionError(f"lifecycle trained {report['final_step']} "
                             f"steps, want 3")
    like = {"params": trainer.params, "opt": trainer.opt_state}
    restored, step, _ = restore_checkpoint(ckpt, like)
    if step != 3 or not all(a.device == b.device and torch.equal(a, b)
                            for a, b in zip(leaves(restored), leaves(like))):
        raise AssertionError("lifecycle: the restored state differs from "
                             "the trained one")
    before = read_counts()["paged_attention"]
    eng = ServeEngine(cfg, restored["params"], max_batch=2)
    req = eng.submit([1, 2, 3], max_new_tokens=3)
    eng.run()
    torch.cuda.synchronize()
    launches = read_counts()["paged_attention"] - before
    if not (req.done and len(req.generated) == 3
            and all(0 <= t < cfg.vocab for t in req.generated)):
        raise AssertionError(f"lifecycle: request {req.generated}, done "
                             f"{req.done}")
    if launches <= 0:
        raise AssertionError("lifecycle: the paged-attention kernel never "
                             "ran")
    # the same request served on the CPU, through the plain version
    cpu = ServeEngine(cfg, map_tree(lambda t: t.cpu(), restored["params"]),
                      max_batch=2, device="cpu")
    want = cpu.submit([1, 2, 3], max_new_tokens=3)
    cpu.run()
    if req.generated != want.generated:
        raise AssertionError(f"lifecycle: the card served {req.generated}, "
                             f"the CPU {want.generated}")
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"final_step": 3, "restored_bit_for_bit": True,
            "generated": req.generated, "losses": [
                m["loss"] for m in report["metrics"]],
            "paged_attention_launches": launches}, launches


def phase_moe_audio_train(dev, out_dir: Path):
    """Phase 13: granite-moe-3b-a800m and whisper-large-v3 at full width
    and depth (bf16 generation, device-time profiles, the MoE layer held
    card against CPU, whisper's float32 prefill <-> decode), granite's
    training at full width and depth, and the train -> checkpoint ->
    serve lifecycle at smoke size.  (a)-(c) reach no hand-written kernel
    (the MoE, encoder and cross blocks and the loss are plain torch, as
    they are plain XLA in the reference); (d) launches the paged kernel.
    Returns the records and the launches of the phase."""
    import gc

    from repro_torch.kernels.flash_attention import ops as flash_ops

    out_dir.mkdir(parents=True, exist_ok=True)
    records = {}
    reset_counts()
    t0 = time.perf_counter()
    # (a) granite-moe-3b-a800m
    arch, B, S, n_new = MOE_SERVE
    rec, cfg, model, params, batch = _served_generation(dev, arch, B, S,
                                                        n_new)
    rec["dropped_share"], x = _moe_prefill(cfg, model, params, batch,
                                           S + n_new + 8)
    rec["moe_layer_check"] = _moe_layer_check(cfg, params, x)
    log(f"[moe] {cfg.name} bf16: " + json.dumps(
        {k: v for k, v in rec.items() if not k.endswith("_profile")}))
    for what in ("prefill", "decode"):
        log(f"[moe] {cfg.name} {what} profile: "
            + json.dumps(rec[what + "_profile"]))
    records["moe"] = rec
    del model, params, batch, x
    # (b) whisper-large-v3
    arch, B, S, n_new = AUDIO_SERVE
    rec, cfg, model, params, _ = _served_generation(
        dev, arch, B, S, n_new,
        extra_batch=lambda cfg, b: {"frames": _frames(cfg, b, dev, 5)})
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    err, top = _audio_f32_check(dev, arch, B, S)
    rec["f32_prefill_decode_max_abs_err"] = err
    rec["f32_max_abs_logit"] = top
    log(f"[audio] {cfg.name} bf16: " + json.dumps(
        {k: v for k, v in rec.items() if not k.endswith("_profile")}))
    for what in ("prefill", "decode"):
        log(f"[audio] {cfg.name} {what} profile: "
            + json.dumps(rec[what + "_profile"]))
    log(f"[audio] {cfg.name} float32: prefill of {S} tokens against "
        f"prefill of {S - 1} + decode_step: max|err| {err:.3e} (limit "
        f"{RECURRENT_TOL} * (1 + max|logit| {top:.4g}))")
    records["audio"] = rec
    serve_s = time.perf_counter() - t0
    # (c) training at full width: nothing of (a), (b) or phase 12 left
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2 ** 30
    log(f"[train] device memory before training {left:.3f} GiB")
    if left > TRAIN_LEFT_GIB:  # the peak below is training's alone
        raise AssertionError(f"{left:.3f} GiB still allocated before "
                             f"training: an earlier phase left tensors on "
                             f"the card")
    t1 = time.perf_counter()
    rec = _train_full_width(dev, out_dir)
    rec["phase_s"] = time.perf_counter() - t1
    # a CUDA kernel wrapper with no backward, given an input that
    # requires grad, raises
    q = torch.zeros((1, 64, 2, 64), device=dev, requires_grad=True)
    try:
        flash_ops.flash_attention(q, q.detach(), q.detach())
    except NotImplementedError as e:
        rec["grad_refusal"] = str(e)
    else:
        raise AssertionError("flash_attention returned an output under grad")
    log(f"[train] {rec['arch']} full width, batch {rec['batch']} x "
        f"{rec['seq']}: " + json.dumps(
            {k: v for k, v in rec.items() if not k.endswith("_profile")}))
    for what in ("step", "adamw"):
        log(f"[train] {what} profile: " + json.dumps(rec[what + "_profile"]))
    log(f"[train] peak device memory {rec['max_memory_allocated_gib']:.2f} "
        f"GiB against {rec['reckoned_state_gib']:.2f} GiB reckoned for "
        f"{rec['params'] / 1e9:.3f} B parameters x "
        f"{TRAIN_BYTES_PER_PARAM} bytes (weights, grads, m, v) plus "
        f"activations")
    records["train"] = rec
    gc.collect()
    torch.cuda.empty_cache()
    records["train_grad_check"] = _train_grad_check(dev, TRAIN_GRAD_ARCHS)
    log(f"[train] float32 smoke() loss gradients card vs CPU (each leaf "
        f"within {TRAIN_GRAD_TOL} * max|g|): "
        + json.dumps(records["train_grad_check"]))
    counts = read_counts()
    if any(counts.values()) or any(read_backward_counts().values()):
        raise AssertionError(f"the MoE, audio and training paths launched "
                             f"kernels {counts}; they reach none")
    # (d) the lifecycle at smoke size
    rec, launches = _lifecycle(dev, out_dir)
    log("[lifecycle] " + json.dumps(rec))
    records["lifecycle"] = rec
    counts = read_counts()
    if counts != {**{k: 0 for k in counts}, "paged_attention": launches}:
        raise AssertionError(f"phase 13 launches {counts}")
    records["serve_phases_s"] = serve_s
    return records, counts


# --------------------------------------------- 14. recurrent training
#: (a) the mLSTM backward kernel against autograd of mlstm_plain:
#: (B, S, H, m, chunk) and what the inputs stress; float32 gradients
#: within MLSTM_BWD_TOL[width] * max|g| each
MLSTM_BWD_CASES = (
    ((1, 4096, 4, 512, 64), {}),       # xlstm-350m width
    ((1, 4096, 4, 512, 128), {}),
    ((1, 4096, 4, 512, 256), {}),      # the reference's chunk
    ((1, 1024, 4, 512, 256), {}),      # the training path's (d)
    ((1, 400, 1, 40, 200), {}),        # a chunk past 128, not of 16
    ((1, 512, 2, 64, 256), {"state": True}),  # seeds dC, dn at 256
    ((2, 48, 3, 40, 16), {}),          # m, S not multiples of 16 or 32
    ((1, 64, 2, 64, 64), {}),          # one chunk
    ((1, 256, 2, 64, 32), {"state": True}),  # seeds dC, dn
    ((2, 96, 2, 48, 32), {"lf": 0.01}),      # log_f near 0
    ((2, 96, 2, 48, 32), {"lf": 2.5}),       # log_f strongly negative
    ((2, 96, 2, 48, 32), {"q": 16.0}),       # |den| mostly above 1
)
MLSTM_BWD_TOL = {"full": 1e-3, "small": 1e-4}
#: (a) an exact tie |den| = 1: (B, S, H, m, chunk) with q_0 = (sqrt(m),
#: 0, ...), k_0 = (1, 0, ...) and i_0 = 1 at batch 0, head 0, so den_0 =
#: q~_0 . k_0 i_0 = 1 in float32; the kernel against
#: mlstm_backward_plain there (JAX's rule: half the gradient reaches den)
MLSTM_TIE_CASE = (2, 64, 2, 16, 16)
#: (a) shapes at which two calls of the backward kernel give the same bits
MLSTM_BITS_CASES = ((1, 1024, 4, 512, 256), (1, 1024, 4, 512, 128),
                    (1, 96, 1, 200, 48))
#: the RG-LRU backward kernel: bit-equal to rg_lru_backward_plain and
#: across block_lanes, within RG_LRU_BWD_TOL * max|g| of autograd of
#: rg_lru_plain; nonzero h0 and dh_final
RG_LRU_BWD_CASES = ((1, 4096, 2560), (2, 3072, 2560), (2, 64, 200),
                    (2, 65, 200))
RG_LRU_BWD_TOL = 1e-5
#: (b) timed: the mLSTM forward + backward at xlstm-350m width (chunk 64
#: and the reference's 256) and at the training path's shape (chunk 256);
#: the RG-LRU backward at recurrentgemma-2b width
MLSTM_BWD_TIMED = ((1, 4096, 4, 512, 64), (1, 4096, 4, 512, 256),
                   (1, 1024, 4, 512, 256))
RG_LRU_BWD_TIMED = (1, 4096, 2560)
#: (d) full width and depth through Trainer, the batch cut from 256 to 1:
#: recurrentgemma-2b on train_4k's 4096 tokens, xlstm-350m on 1024 (its
#: sLSTM is a host loop over time, run twice forward and once backward a
#: remat step: ~20 s a step at 1 x 1024 on the H100, PERF.md)
RECURRENT_TRAIN = (dict(arch="recurrentgemma_2b", batch=1, seq=4096, steps=3),
                   dict(arch="xlstm_350m", batch=1, seq=1024, steps=3))
#: each recurrent arch's kernel and the layer kind that launches it
RECURRENT_TRAIN_KERNEL = {"xlstm_350m": ("mlstm", "mlstm"),
                          "recurrentgemma_2b": ("rg_lru", "rec")}
#: a training step's device time split: each kernel's backward, then its
#: forward, then phase 13's kinds
P14_KINDS = ("mlstm_bwd", "rg_lru_bwd", "mlstm", "rg_lru") + P13_KINDS


def mlstm_backward_work(B, S, H, m, c):
    """(bytes, flops) of one mLSTM backward: q, k, v, h, dh, the gates
    and den read once, the saved entering states once, dq, dk, dv, di and
    dlog_f written once; per chunk and head the masked scores and dA
    (2 triangles of depth m), the three intra products back (depth c, the
    triangle), the state terms C_in dnum, dC v, dC^T k and the walk's dC
    update (c m^2 each), all float32 multiply-adds; the bound counts each
    product three times at the TF32 peak, as split TF32 (the forward's
    scheme) would run it."""
    tri = c * (c + 1) / 2
    chunks = (S // c) * B * H
    flops = (5 * 2 * tri * m + 4 * 2 * c * m * m) * chunks
    nbytes = 4.0 * (8 * B * S * H * m + 6 * B * S * H
                    + chunks * (m * m + m))
    return nbytes, flops


def _grad_err(got, want, tol, what):
    """max |got - want| / max |want| over one gradient; raises past tol."""
    top = want.abs().max().item()
    err = (got - want).abs().max().item()
    if not (err <= tol * top):
        raise AssertionError(f"{what}: max|err| {err:.3e} > {tol} * "
                             f"max|g| {top:.4g}")
    return err, err / top if top else err


def _mlstm_bwd_check(inp, dims, opts):
    """One case of MLSTM_BWD_CASES through the wrapper (the forward and
    backward kernels) against ``torch.autograd.grad`` through
    ``mlstm_plain`` called explicitly; h the same bits as a forward
    without grad."""
    from repro_torch.kernels.mlstm import mlstm as ML
    from repro_torch.kernels.mlstm import ops as mlstm_ops

    B, S, H, m, c = dims
    q, k, v, i, lf = inp.mlstm(B, S, H, m)
    if "q" in opts:
        q = q * opts["q"]
    if "lf" in opts:
        lf = -inp.uniform(0.0, opts["lf"], B, S, H)
    state = opts.get("state", False)
    ins = (q, k, v, i, lf)
    tol = MLSTM_BWD_TOL["full" if m >= 512 else "small"]
    leaves = [t.clone().requires_grad_(True) for t in ins]
    out = mlstm_ops.mlstm_chunkwise(*leaves, chunk=c, return_state=state)
    outs = out if state else (out,)
    seeds = tuple(inp.normal(*o.shape) for o in outs)
    got = torch.autograd.grad(outs, leaves, seeds)
    with torch.no_grad():
        alone = ML.mlstm_kernel(*ins, chunk=c)
    if not torch.equal(alone, outs[0]):
        raise AssertionError(f"mLSTM {dims}: h under grad differs from h "
                             f"without")
    plain = [t.clone().requires_grad_(True) for t in ins]
    ref = ML.mlstm_plain(*plain, chunk=c, return_state=state)
    want = torch.autograd.grad(ref if state else (ref,), plain, seeds)
    _, _, _, den = ML.mlstm_plain(*ins, chunk=c, save=True)
    torch.cuda.synchronize()
    errs = {n: _grad_err(g, w, tol, f"mLSTM backward {dims} {opts} d{n}")
            for n, g, w in zip(("q", "k", "v", "i", "log_f"), got, want)}
    return {"kernel": "mlstm", "shape": list(dims), **opts, "tol": tol,
            "max_abs_err": max(e[0] for e in errs.values()),
            "max_rel_err": {n: e[1] for n, e in errs.items()},
            "den_above_1": (den.abs() > 1).float().mean().item()}


def _mlstm_tie_check(inp):
    """MLSTM_TIE_CASE: den_0 = 1 exactly in the forward kernel's saved
    den; the backward kernel within MLSTM_BWD_TOL["small"] of each
    gradient's max of ``mlstm_backward_plain`` on the same saved tensors
    (JAX's rule at the tie), and off autograd through ``mlstm_plain``
    (torch's ``clamp_min`` passes the whole gradient) by more than
    that."""
    from repro_torch.kernels.mlstm import mlstm as ML

    B, S, H, m, c = MLSTM_TIE_CASE
    q, k, v, i, lf = inp.mlstm(B, S, H, m)
    q[0, 0, 0] = 0.0
    q[0, 0, 0, 0] = math.sqrt(m)
    k[0, 0, 0] = 0.0
    k[0, 0, 0, 0] = 1.0
    i[0, 0, 0] = 1.0
    ins = (q, k, v, i, lf)
    with torch.no_grad():
        h, c_in, n_in, den = ML.mlstm_kernel(*ins, chunk=c, save=True)
    dh = inp.normal(B, S, H, m)
    got = ML.mlstm_backward_kernel(*ins, h, c_in, n_in, den, dh, chunk=c)
    want = ML.mlstm_backward_plain(*ins, h, c_in, n_in, den, dh, chunk=c)
    plain = [t.clone().requires_grad_(True) for t in ins]
    clamp = torch.autograd.grad(ML.mlstm_plain(*plain, chunk=c), plain, dh)
    torch.cuda.synchronize()
    if float(den[0, 0, 0]) != 1.0:
        raise AssertionError(f"mLSTM tie: den_0 = {float(den[0, 0, 0])!r}")
    tol = MLSTM_BWD_TOL["small"]
    names = ("q", "k", "v", "i", "log_f")
    errs = {n: _grad_err(g, w, tol, f"mLSTM backward at the tie d{n}")
            for n, g, w in zip(names, got, want)}
    off = max(float((t - w).abs().max()) / float(w.abs().max())
              for t, w in zip(clamp, want))
    if not off > tol:
        raise AssertionError(f"mLSTM tie: torch's rule is within {off:.3e} "
                             f"of JAX's, the case does not pin the tie")
    return {"kernel": "mlstm", "shape": list(MLSTM_TIE_CASE), "tol": tol,
            "den_0": float(den[0, 0, 0]),
            "max_abs_err": max(e[0] for e in errs.values()),
            "max_rel_err": {n: e[1] for n, e in errs.items()},
            "clamp_min_rule_rel_off": off}


def _mlstm_bits_check(inp, dims):
    """Two calls of the backward kernel on the same inputs (with seeds of
    the final state) give the same bits."""
    from repro_torch.kernels.mlstm import mlstm as ML

    B, S, H, m, c = dims
    ins = inp.mlstm(B, S, H, m)
    with torch.no_grad():
        saved = ML.mlstm_kernel(*ins, chunk=c, save=True)
    rest = (inp.normal(B, S, H, m), inp.normal(B, H, m, m),
            inp.normal(B, H, m))
    first = ML.mlstm_backward_kernel(*ins, *saved, *rest, chunk=c)
    again = ML.mlstm_backward_kernel(*ins, *saved, *rest, chunk=c)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError(f"mLSTM backward {dims}: two calls differ")
    return {"kernel": "mlstm", "shape": list(dims), "bits_equal": True}


def _rg_lru_bwd_check(inp, dims):
    """One case of RG_LRU_BWD_CASES through the wrapper at every
    ``block_lanes`` the clamp allows: bit-equal to
    ``rg_lru_backward_plain`` on the forward's own h_seq and across
    ``block_lanes``, and within RG_LRU_BWD_TOL of autograd through
    ``rg_lru_plain``."""
    from repro_torch.kernels.rg_lru import ops as rg_ops
    from repro_torch.kernels.rg_lru import rg_lru as RL

    B, S, D = dims
    a, b, h0 = inp.rg_lru(B, S, D)
    dhs, dhn = inp.normal(B, S, D), inp.normal(B, D)
    dp = D + (-D) % RL.LANES
    first = None
    for lanes in [x for x in range(RL.LANES, dp + 1, RL.LANES)
                  if dp % x == 0]:
        leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
        hs, hn = rg_ops.rg_lru_scan(*leaves, block_lanes=lanes)
        got = torch.autograd.grad((hs, hn), leaves, (dhs, dhn))
        if first is None:
            first = got
            plain = RL.rg_lru_backward_plain(a, hs.detach(), h0, dhs, dhn)
            if not all(torch.equal(x, y) for x, y in zip(got, plain)):
                raise AssertionError(f"RG-LRU backward {dims}: not bit-equal "
                                     f"to rg_lru_backward_plain")
        elif not all(torch.equal(x, y) for x, y in zip(got, first)):
            raise AssertionError(f"RG-LRU backward {dims}: block_lanes "
                                 f"{lanes} differs from {RL.LANES}")
    ref = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    want = torch.autograd.grad(RL.rg_lru_plain(*ref), ref, (dhs, dhn))
    torch.cuda.synchronize()
    errs = {n: _grad_err(g, w, RG_LRU_BWD_TOL,
                         f"RG-LRU backward {dims} d{n}")
            for n, g, w in zip(("a", "b", "h0"), first, want)}
    return {"kernel": "rg_lru", "shape": list(dims), "bit_equal_plain": True,
            "block_lanes_bit_identical": True,
            "max_abs_err": max(e[0] for e in errs.values()),
            "max_rel_err": {n: e[1] for n, e in errs.items()}}


def _backward_timing(inp):
    """(b): the mLSTM's forward + backward through the wrapper and its
    backward kernel alone at MLSTM_BWD_TIMED, the RG-LRU's backward at
    RG_LRU_BWD_TIMED: CUDA-event call time, device time summed over the
    kernels of a call (profiler, ``_device_ms``: a trace that drops some
    is taken again, then reported as not measured) and by kernel, the
    plain backward's time and the bound."""
    from repro_torch.kernels.mlstm import mlstm as ML
    from repro_torch.kernels.mlstm import ops as mlstm_ops
    from repro_torch.kernels.rg_lru import rg_lru as RL

    out = []
    for B, S, H, m, c in MLSTM_BWD_TIMED:
        ins = inp.mlstm(B, S, H, m)
        leaves = [t.clone().requires_grad_(True) for t in ins]
        dh = inp.normal(B, S, H, m)
        with torch.no_grad():
            h, c_in, n_in, den = ML.mlstm_kernel(*ins, chunk=c, save=True)

        def both():
            return torch.autograd.grad(
                mlstm_ops.mlstm_chunkwise(*leaves, chunk=c), leaves, dh)

        def bwd():
            return ML.mlstm_backward_kernel(*ins, h, c_in, n_in, den, dh,
                                            chunk=c)

        nbytes, flops = mlstm_backward_work(B, S, H, m, c)
        fb, fp, _ = mlstm_work(B, S, H, m, c)
        bound_ms, bound_by = _bound(nbytes, 3 * flops, PEAK_TF32_PER_S)
        fwd_bound = _bound(fb, 3 * fp, PEAK_TF32_PER_S)[0]
        # five kernels (prep, state, scores, grads, gates), two forward
        per_call = 5
        out.append({
            "kernel": "mlstm_backward", "shape": [B, S, H, m, c],
            "kernel_ms": _time_ms(bwd, 5, warmup=2),
            "kernel_device_ms": _device_ms(bwd, "mlstm_bwd", iters=5,
                                           per_call=per_call),
            "device_kernels_per_call": per_call,
            "device_ms_by_kernel": _device_ms_by_kernel(
                bwd, iters=3, per_call=per_call),
            "fwd_bwd_ms": _time_ms(both, 3, warmup=1),
            "fwd_bwd_device_ms": _device_ms(both, "mlstm", iters=3,
                                            per_call=per_call + 2),
            "plain_ms": _time_ms(lambda: ML.mlstm_backward_plain(
                *ins, h, c_in, n_in, den, dh, chunk=c), 2, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "fwd_bwd_bound_ms": bound_ms + fwd_bound, "library_ms": None})
        del ins, leaves, dh, h, c_in, n_in, den
    B, S, D = RG_LRU_BWD_TIMED
    a, b, h0 = inp.rg_lru(B, S, D)
    dhs, dhn = inp.normal(B, S, D), inp.normal(B, D)
    hs, _ = RL.rg_lru_kernel(a, b, h0)

    def rbwd():
        return RL.rg_lru_backward_kernel(a, hs, h0, dhs, dhn)

    # a, h_seq and dh_seq read once, da and db written once (h0, dh_final
    # and dh0 beside them); a multiply-add and a multiply an element
    bound_ms, bound_by = _bound(4.0 * (5 * B * S * D + 3 * B * D),
                                3.0 * B * S * D)
    per_call = 2 if S > RL.CHUNK else 1  # the summaries, the scan
    out.append({
        "kernel": "rg_lru_backward", "shape": [B, S, D],
        "kernel_ms": _time_ms(rbwd, 50, warmup=5),
        "kernel_device_ms": _device_ms(rbwd, "rg_lru_bwd", iters=20,
                                       per_call=per_call),
        "device_kernels_per_call": per_call,
        "device_ms_by_kernel": _device_ms_by_kernel(rbwd),
        "plain_ms": _time_ms(lambda: RL.rg_lru_backward_plain(
            a, hs, h0, dhs, dhn), 2, warmup=1),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    return out


def phase_recurrent_train(dev, out_dir: Path):
    """Phase 14: training of the recurrent families on the card.  (a) each
    backward kernel against autograd of its plain version (float32, the
    plain version called explicitly), the mLSTM's also against
    ``mlstm_backward_plain`` at an exact tie |den| = 1 and bit for bit
    across two calls; (b) their times; (c) the smoke()
    loss gradients of xlstm-350m and recurrentgemma-2b card against CPU;
    (d) both trained at full width and depth through ``Trainer`` with the
    launches of each kernel a step exact: forward twice a layer (the step
    and remat's recompute), backward once.  Returns the records and the
    training runs' launches (forward and backward, by kernel)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models.model_api import layer_kinds

    out_dir.mkdir(parents=True, exist_ok=True)
    records = {}
    inp = Inputs(dev, 14)
    t0 = time.perf_counter()
    # (a)
    records["mlstm_checks"] = [_mlstm_bwd_check(inp, d, o)
                               for d, o in MLSTM_BWD_CASES]
    shares = [r["den_above_1"] for r in records["mlstm_checks"]]
    if not min(shares) < 0.5 < max(shares):
        raise AssertionError(f"the mLSTM cases do not reach both sides of "
                             f"|den| = 1: {shares}")
    records["mlstm_tie"] = _mlstm_tie_check(inp)
    records["mlstm_bits"] = [_mlstm_bits_check(inp, d)
                             for d in MLSTM_BITS_CASES]
    log("[rec-train] backward at |den| = 1 " + json.dumps(
        records["mlstm_tie"]))
    log("[rec-train] backward bits across two calls " + json.dumps(
        records["mlstm_bits"]))
    records["rg_lru_checks"] = [_rg_lru_bwd_check(inp, d)
                                for d in RG_LRU_BWD_CASES]
    for r in records["mlstm_checks"] + records["rg_lru_checks"]:
        log("[rec-train] backward check " + json.dumps(r))
    records["checks_s"] = time.perf_counter() - t0
    # (b)
    t0 = time.perf_counter()
    records["timing"] = _backward_timing(inp)
    for r in records["timing"]:
        log("[rec-train] timing " + json.dumps(r))
    records["timing_s"] = time.perf_counter() - t0
    del inp
    # (c)
    t0 = time.perf_counter()
    records["train_grad_check"] = _train_grad_check(dev,
                                                    RECURRENT_TRAIN_ARCHS)
    log(f"[rec-train] float32 smoke() loss gradients card vs CPU (each "
        f"leaf within {TRAIN_GRAD_TOL} * max|g|): "
        + json.dumps(records["train_grad_check"]))
    records["grad_check_s"] = time.perf_counter() - t0
    # (d)
    train_counts = {"forward": collections.Counter(),
                    "backward": collections.Counter()}
    for spec in RECURRENT_TRAIN:
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() / 2 ** 30
        if left > TRAIN_LEFT_GIB:
            raise AssertionError(f"{left:.3f} GiB still allocated before "
                                 f"training {spec['arch']}")
        t1 = time.perf_counter()
        rec = _train_full_width(dev, out_dir, spec, own=P14_KINDS)
        rec["phase_s"] = time.perf_counter() - t1
        kernel, kind = RECURRENT_TRAIN_KERNEL[spec["arch"]]
        layers = layer_kinds(get_config(spec["arch"])).count(kind)
        want_fwd = {k: 0 for k in rec["launches"]["forward"]}
        want_fwd[kernel] = 2 * layers * spec["steps"]
        want_bwd = {k: 0 for k in rec["launches"]["backward"]}
        want_bwd[kernel] = layers * spec["steps"]
        if rec["launches"] != {"forward": want_fwd, "backward": want_bwd}:
            raise AssertionError(
                f"{spec['arch']} training launched {rec['launches']}, want "
                f"forward {want_fwd} and backward {want_bwd} ({layers} "
                f"layers x {spec['steps']} steps, remat)")
        rec["kernel_layers"] = layers
        train_counts["forward"].update(rec["launches"]["forward"])
        train_counts["backward"].update(rec["launches"]["backward"])
        log(f"[rec-train] {spec['arch']} full width, batch {spec['batch']} "
            f"x {spec['seq']}: " + json.dumps(
                {k: v for k, v in rec.items() if not k.endswith("_profile")}))
        for what in ("step", "adamw"):
            log(f"[rec-train] {spec['arch']} {what} profile: "
                + json.dumps(rec[what + "_profile"]))
        records[spec["arch"]] = rec
    return records, {k: dict(v) for k, v in train_counts.items()}


# ------------------------------------------------------------------ main
# ------------------------------------------------- 15. process backend
#: phase 15's mixed workload: the paper's chains at this length
PROCESS_N = 2048
#: the reference's own process smokes on an 8-CPU host (the JAX package's
#: bench_graph / bench_stream ``--smoke --backend process``) and the
#: committed baselines' recorded values: its wall gate fails there too
REFERENCE_WALL = {"graph": {"reference_8cpu": 0.0522, "baseline": 0.0200},
                  "stream": {"reference_8cpu": 0.0182, "baseline": 0.0186,
                             "nightly_baseline": 0.0133}}
#: bench_stream at the nightly workflow's depth (no --smoke)
STREAM_NIGHTLY = dict(clients=8, chains=8, n=1 << 14)
#: seconds close() may take to reap every worker
REAP_S = 10.0


def _process_workload(s, n):
    """The paper's 2FZF and 3ZIP chains at ``n`` and a 4-way fork-join
    through a Session with cpu0, cpu1 and gpu0, every task pinned so both
    backends place (and so compute) alike.  Returns output futures."""
    from repro_torch.apps.radar import _fill, submit_2fzf

    rng = np.random.default_rng(15)
    fzf = submit_2fzf(s, n, pins=("cpu0", "gpu0", "cpu1", "gpu0"), seed=1,
                      tag="_p15")
    outs = {"2fzf": fzf["out"]}
    ins = []
    for _ in range(4):
        buf = s.malloc((n,), np.complex64)
        _fill(buf.hete, rng)
        ins.append(buf)
    z0 = s.submit("zip", ins[:2], pin="cpu0", name="zip0_p15")
    z1 = s.submit("zip", ins[2:], pin="gpu0", name="zip1_p15")
    outs["3zip"] = s.submit("zip", [z0, z1], pin="cpu1", name="zip2_p15")
    src = s.malloc((n,), np.complex64)
    _fill(src.hete, rng)
    fsrc = s.submit("fft", [src], pin="gpu0", name="src_fft_p15")
    pes = ("cpu0", "gpu0", "cpu1", "gpu0")
    branches = []
    for w, pe in enumerate(pes):
        weight = s.malloc((n,), np.complex64)
        _fill(weight.hete, rng)
        cur = s.submit("zip", [fsrc, weight], pin=pe, name=f"fork{w}_p15")
        cur = s.submit("fft", [cur], pin=pe, name=f"branch{w}_fft_p15")
        branches.append(s.submit("ifft", [cur], pin=pes[(w + 1) % 4],
                                 name=f"branch{w}_ifft_p15"))
    j0 = s.submit("zip", branches[:2], pin="cpu0", name="join0_p15")
    j1 = s.submit("zip", branches[2:], pin="gpu0", name="join1_p15")
    outs["forkjoin"] = s.submit("zip", [j0, j1], pin="cpu1",
                                name="join2_p15")
    want = np.fft.ifft(np.fft.fft(fzf["a"].hete.data)
                       * np.fft.fft(fzf["b"].hete.data))
    return outs, want


def _mixed_run(backend, device, n, trace_dir=None):
    """One mixed Session (cpu0, cpu1, gpu0; round robin, every task
    pinned) on ``backend``: outputs, ledger, kernel launches, and for the
    process backend the workers' pids, start-up seconds and reports, and
    close()'s reap time."""
    from benchmarks_torch import common
    from repro_torch.apps.radar import make_session

    with common.tracing(trace_dir, f"process_mixed_{backend}"):
        s = make_session(policy="rimms", scheduler="round_robin", n_cpu=2,
                         accelerators=("gpu0",), backend=backend,
                         device=device)
        rec = {"backend": s.backend}
        if backend == "process":
            # spawn the workers up front: their start-up (one import of
            # torch each) lies outside every checked window
            pool = s.runtime._get_process_pool()
            t0 = time.perf_counter()
            for pe in ("cpu0", "cpu1"):
                pool.worker(pe)
            rec["worker_startup_s"] = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        futs, want = _process_workload(s, n)
        rec["outs"] = {k: np.array(f.result(timeout=600))
                       for k, f in futs.items()}
        # the chain's value: numpy's 2FZF (float64) within 1e-4 of its
        # largest magnitude
        err = float(np.max(np.abs(rec["outs"]["2fzf"] - want)))
        if not err <= 1e-4 * float(np.max(np.abs(want))):
            raise AssertionError(f"{backend} 2FZF off numpy by {err}")
        rec["2fzf_err"] = err
        s.barrier()
        rec["wall_s"] = time.perf_counter() - t0
        rec["launches"] = read_counts()
        rec["by_pair"] = s.ledger.snapshot()["by_pair"]
        rec["bytes"] = dict(s.ledger.bytes_moved)
        rec["report"] = {k: s.report()[k] for k in ("n_tasks", "n_completed",
                                                    "makespan_model")}
        s.close()
    if backend == "process":
        pool = s.runtime._process_pool
        rec["pids"] = pool.pids()
        rec["workers"] = {pe: pool.worker(pe).metrics_state()["worker"]
                          for pe in sorted(rec["pids"])}
        rec["worker_tasks"] = {
            k: v["value"] for k, v in s.metrics.snapshot().items()
            if k.startswith("worker/") and k.endswith("/tasks")}
        procs = pool.procs()
        t0 = time.perf_counter()
        s.runtime.close()
        while (any(p.is_alive() for p in procs)
               and time.perf_counter() - t0 < REAP_S + 5):
            time.sleep(0.02)
        rec["reap_s"] = time.perf_counter() - t0
        rec["alive_after_close"] = sum(p.is_alive() for p in procs)
    else:
        s.runtime.close()
    return rec


def _failures(device):
    """(b): ``die`` on cpu0 raises WorkerDied naming exit code 17 and a
    later task on cpu0 runs; ``boom`` on cpu0 propagates its error."""
    import repro_torch.apps.elemwise  # noqa: F401  (scale, boom, die)
    from repro_torch.core.api import Session
    from repro_torch.core.pworker import WorkerDied

    s = Session.emulated(policy="rimms", scheduler="round_robin", n_cpu=1,
                         accelerators=("gpu0",), backend="process",
                         device=device)
    out = {}
    try:
        a = s.malloc((64,), np.float64)
        a.data[:] = np.arange(64)
        try:
            s.submit("die", [a], pin="cpu0").result(timeout=300)
            raise AssertionError("die on cpu0 returned")
        except WorkerDied as e:
            if "exit code 17" not in str(e):
                raise AssertionError(f"WorkerDied without exit code 17: {e}")
            out["died"] = str(e)
        later = np.asarray(s.submit("scale", [a], factor=2.0,
                                    pin="cpu0").result(timeout=300))
        if not np.array_equal(later, 2.0 * np.arange(64)):
            raise AssertionError("the task after the worker's death is wrong")
        try:
            s.submit("boom", [a], pin="cpu0").result(timeout=300)
            raise AssertionError("boom on cpu0 returned")
        except RuntimeError as e:
            if "boom kernel always fails" not in str(e):
                raise AssertionError(f"boom raised something else: {e}")
            out["boom"] = str(e).splitlines()[0]
        out["pids"] = s.runtime._process_pool.pids()
    finally:
        s.close()
        s.runtime.close()
    return out


def _calibrate_process(out_dir: Path):
    """``python -m repro_torch.calibrate run --backend process`` on one
    rung (cpu0 and cpu1 measured on their workers, gpu0 in-process on the
    card), then ``show``: a gpu winner for every tuned op, and cpu rows."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    path = out_dir / "calib_process.json"
    t0 = time.perf_counter()
    for argv in (["run", "--out", str(path), "--ladder", "64KiB",
                  "--backend", "process"], ["show", str(path)]):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.calibrate", *argv],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            raise AssertionError(f"calibrate {argv[0]} --backend process "
                                 f"exited {out.returncode}:\n{out.stderr}")
    table = json.loads(path.read_text())
    if table["meta"]["cli"]["backend"] != "process":
        raise AssertionError(f"calibrate run wrote {table['meta']['cli']}")
    for op in TUNED_KERNEL:
        for kind in ("gpu", "cpu"):
            if f"| {op} | {kind} |" not in out.stdout:
                raise AssertionError(f"calibrate show --backend process: "
                                     f"no {kind} winner for {op}")
    seconds = time.perf_counter() - t0
    log(f"[process] calibrate run --backend process + show in "
        f"{seconds:.1f}s; {len(out.stdout.splitlines())} lines shown")
    return seconds


def _arena_alloc_ms(capacity: int, n: int = 40, nbytes: int = 16 << 10):
    """Host ms per allocation from a shared host arena of ``capacity``
    bytes (the reference's bitset over 64-byte blocks), ``n`` allocations
    of ``nbytes`` held at once, as a session holds its buffers."""
    from repro_torch.core.shm import SharedHostArena

    arena = SharedHostArena(capacity)
    try:
        held = []
        t0 = time.perf_counter()
        for _ in range(n):
            held.append(arena.zeros((nbytes,), np.uint8))
        return (time.perf_counter() - t0) / n * 1e3
    finally:
        del held
        arena.destroy()


def _process_gates(records, baselines: Path, what: str):
    """The port's check_regression over the process records: its whole
    table printed; every modeled row held exactly equal to the baseline;
    the wall rows (``wall_speedup_vs_serial``, direction min, floor 1.0)
    reported beside the reference's own figures, not held (the reference
    fails that gate on an 8-CPU host too)."""
    import contextlib
    import io

    from benchmarks_torch import check_regression

    cmp_json = records[0].parent / f"check_{what}.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = check_regression.main([str(p) for p in records]
                                   + ["--baselines", str(baselines),
                                      "--json", str(cmp_json)])
    for line in buf.getvalue().splitlines():
        log(f"[process] check_regression {what}: {line}")
    result = json.loads(cmp_json.read_text())
    walls = {}
    for res in result["results"]:
        for row in res["rows"]:
            if row["metric"] == "wall_speedup_vs_serial":
                walls[res["name"]] = row
            elif row["status"] != "ok":
                raise AssertionError(f"{what} {res['name']}: modeled row "
                                     f"{row} not ok")
        if not res["rows"]:
            raise AssertionError(f"{what} {res['name']}: {res['failures']}")
    for path in records:
        rec = json.loads(path.read_text())
        base = json.loads((baselines / path.name).read_text())
        modeled = {k: v for k, v in rec["gate"].items()
                   if k != "wall_speedup_vs_serial"}
        want = {k: v for k, v in base["gate"].items()
                if k != "wall_speedup_vs_serial"}
        if modeled != want:
            raise AssertionError(f"{what} {path.name}: modeled gate "
                                 f"{modeled} != baseline {want}")
        log(f"[process] {what} {path.name}: modeled gate {modeled} equals "
            f"the baseline exactly")
    other = [f for f in result["failures"]
             if "wall_speedup_vs_serial" not in f]
    if other:
        raise AssertionError(f"{what}: check_regression failures {other}")
    return rc, walls


def phase_process_backend(dev, out_dir: Path, smi: str):
    """Phase 15: the process backend beside the card.  (a) a mixed
    Session (cpu0 and cpu1 in spawned workers, gpu0 in-process on
    ``cuda:0``) runs 2FZF, 3ZIP and a 4-way fork-join at ``PROCESS_N``,
    every task pinned: outputs bit-identical to the thread backend's,
    equal ledgers and FFT/ZIP launches, worker pids apart from this
    process, no worker with CUDA initialised, every worker reaped by
    close() within ``REAP_S``; traced, linted, and read by the profile
    CLI.  (b) ``die`` and ``boom`` on cpu0, and on the card the
    calibration CLI's ``run --backend process`` and ``show``.  (c)
    bench_graph and bench_stream ``--backend process`` at smoke and
    bench_stream at the nightly workflow's depth: modeled gates equal to
    the baselines, bit-identical to the thread backend, compute
    divergence cells; the wall rows reported beside the reference's.
    The benches build their sessions with ``n_cpu=0``, so on the card
    (c) spawns no worker: it holds the process backend's set-up (the
    shared host arena, the card's PEs kept in-process) and its modeled
    gates, and its bit identity and ledgers hold by construction there.
    Workers are held by (a) and (b) here and by
    ``tests/test_torch_backend.py`` on the CPU.  Returns the records and
    (a)'s kernel launches."""
    from benchmarks_torch import bench_graph, bench_stream, common

    out_dir.mkdir(parents=True, exist_ok=True)
    t_phase = time.perf_counter()
    device = None if dev.type == "cuda" else dev
    rec = {}
    # (a): a warm-up (first launches, numpy's plans), then the thread
    # run and the process run, each counted
    _mixed_run("thread", device, PROCESS_N)
    thread = _mixed_run("thread", device, PROCESS_N)
    proc = _mixed_run("process", device, PROCESS_N,
                      trace_dir=str(out_dir / "traces"))
    for k in thread["outs"]:
        if not np.array_equal(thread["outs"][k], proc["outs"][k]):
            raise AssertionError(f"process {k} output differs from thread")
        if not np.all(np.isfinite(proc["outs"][k])):
            raise AssertionError(f"process {k} output not finite")
    if (thread["by_pair"], thread["bytes"]) != (proc["by_pair"],
                                                proc["bytes"]):
        raise AssertionError(f"ledgers differ: thread {thread['by_pair']} "
                             f"process {proc['by_pair']}")
    if thread["launches"] != proc["launches"]:
        raise AssertionError(f"launches differ: thread {thread['launches']} "
                             f"process {proc['launches']}")
    if dev.type == "cuda" and (proc["launches"]["fft"] <= 0
                               or proc["launches"]["zip"] <= 0):
        raise AssertionError(f"gpu0 launched no kernel: {proc['launches']}")
    if proc["report"]["n_completed"] != proc["report"]["n_tasks"]:
        raise AssertionError(f"process run: {proc['report']}")
    # a PE on the card keeps in-process dispatch: only cpu PEs get a
    # worker there (on the CPU, gpu0's space is host-format: it gets one)
    pes = ["cpu0", "cpu1"] + (["gpu0"] if dev.type == "cpu" else [])
    if sorted(proc["pids"]) != pes:
        raise AssertionError(f"workers {proc['pids']}, expected {pes}")
    if (os.getpid() in proc["pids"].values()
            or len(set(proc["pids"].values())) != len(pes)):
        raise AssertionError(f"worker pids {proc['pids']} (parent "
                             f"{os.getpid()})")
    for pe, info in proc["workers"].items():
        if info["cuda_initialized"]:
            raise AssertionError(f"worker {pe} initialised CUDA: {info}")
    if not all(proc["worker_tasks"].get(f"worker/{pe}/tasks", 0) > 0
               for pe in ("cpu0", "cpu1")):
        raise AssertionError(f"worker tasks {proc['worker_tasks']}")
    if proc["alive_after_close"] or proc["reap_s"] > REAP_S:
        raise AssertionError(f"close() left {proc['alive_after_close']} "
                             f"workers after {proc['reap_s']:.2f}s")
    trace = out_dir / "traces" / "TRACE_process_mixed_process.json"
    doc = json.loads(trace.read_text())
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"
             and (e.get("args") or {}).get("backend") == "process"]
    if not spans:
        raise AssertionError("no forwarded worker span in the process trace")
    _profile_cli([trace], out_dir)
    rec["mixed"] = {
        "n": PROCESS_N, "by_pair": proc["by_pair"],
        "launches": proc["launches"], "pids": proc["pids"],
        "workers": proc["workers"], "worker_tasks": proc["worker_tasks"],
        "worker_startup_s": proc["worker_startup_s"],
        "reap_s": proc["reap_s"], "2fzf_err_vs_numpy": proc["2fzf_err"],
        "wall_s": {"thread": thread["wall_s"],
                                             "process": proc["wall_s"]},
        "makespan_model": proc["report"]["makespan_model"],
        "worker_spans": len(spans)}
    log("[process] (a) mixed " + json.dumps(rec["mixed"]))

    # (b)
    rec["failures"] = _failures(device)
    log("[process] (b) " + json.dumps(rec["failures"]))
    if dev.type == "cuda":  # the CLI measures on the card only
        rec["calibrate_s"] = _calibrate_process(out_dir)
    # what a process Session pays per host buffer (ROADMAP C.17)
    from repro_torch.core.shm import default_arena_bytes

    rec["arena_alloc_ms"] = {
        f"{cap >> 20}MiB": _arena_alloc_ms(cap)
        for cap in sorted({64 << 20, default_arena_bytes()})}
    log("[process] shared-arena allocation, host ms each: "
        + json.dumps(rec["arena_alloc_ms"]))

    # (c): the process smokes and the nightly stream (no cpu PE, so no
    # worker on the card)
    kw = {} if device is None else {"device": device}
    smoke_dir, nightly_dir = out_dir / "smoke", out_dir / "nightly"
    smoke_dir.mkdir(exist_ok=True)
    nightly_dir.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    bench_graph.smoke(str(smoke_dir / "BENCH_graph_process.json"),
                      backend="process", **kw)
    with common.tracing(str(out_dir / "traces"), "stream_process",
                        metrics_dir=str(out_dir / "metrics")):
        bench_stream.run_stream(
            clients=4, chains=6, n=bench_stream.N_PROCESS,
            json_path=str(smoke_dir / "BENCH_stream_process.json"),
            smoke=True, backend="process", **kw)
    bench_stream.run_stream(
        **STREAM_NIGHTLY,
        json_path=str(nightly_dir / "BENCH_stream_process.json"),
        smoke=False, backend="process", **kw)
    (nightly_dir / "BENCH_graph_process.json").write_text(
        (smoke_dir / "BENCH_graph_process.json").read_text())
    rec["benches_s"] = time.perf_counter() - t0
    walls = {}
    for depth, d, base in (("smoke", smoke_dir, BASELINES),
                           ("nightly", nightly_dir, BASELINES / "nightly")):
        paths = [d / "BENCH_graph_process.json",
                 d / "BENCH_stream_process.json"]
        _, rows = _process_gates(paths, base, depth)
        for path in paths:
            r = json.loads(path.read_text())
            if r["backend"] != "process":
                raise AssertionError(f"{path}: backend {r['backend']}")
            if r["bench"] == "stream":
                if not (r["bit_identical_vs_thread"] and r["bit_identical"]
                        and r["copies_match"]):
                    raise AssertionError(f"{depth} stream: not identical "
                                         f"to the thread backend / batch")
                cells = [c["ema_ratio"] for c in r["divergence"].values()
                         if c["kind"] == "compute" and c["count"] > 0]
                if not any(x is not None and x > 0 and math.isfinite(x)
                           for x in cells):
                    raise AssertionError(f"{depth} stream: no compute "
                                         f"divergence cell")
            walls[f"{depth}_{r['bench']}"] = {
                "wall_speedup_vs_serial": r["wall_speedup_vs_serial"],
                "wall_speedup_vs_thread": r.get("wall_speedup_vs_thread"),
                "gated": "wall_speedup_vs_serial" in r["gate"],
                "check_regression": (rows.get(path.name) or {}).get(
                    "status", "SKIP"),
                "reference": REFERENCE_WALL[r["bench"]]}
    for k, v in walls.items():
        log(f"[process] wall {k}: " + json.dumps(v) + f" ({smi})")
    rec["walls"] = walls
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[process] phase {rec['phase_s']:.1f}s, workers' start-up "
        f"{proc['worker_startup_s']:.2f}s, mixed wall thread "
        f"{thread['wall_s']:.4f}s process {proc['wall_s']:.4f}s, benches "
        f"{rec['benches_s']:.1f}s ({smi})")
    return rec, proc["launches"]


# ------------------------------------------ 16. sharding and launch tools
#: the dry-run's cells: the reference test's, and a dense training cell
DRYRUN_CELLS = (("xlstm-350m", "decode_32k"), ("llama3-8b", "train_4k"))
#: the label of the dry-run of the cells held to the JAX package's
#: records (``--held``), which exits 1 when one misses a bound: the misses
#: are named from its records (:func:`_held_results`)
HELD = ("held", "p1")
DRYRUN_WAIT_S = 900  # the longest the wait for the dry-runs may take
LAUNCH_TRAIN = dict(arch="recurrentgemma_2b", batch=1, seq=4096, steps=2)


def start_dryruns(out_dir: Path, log_dir: Path):
    """The dry-run CLI on each of DRYRUN_CELLS (single-pod, with its
    probes), one subprocess a cell, and on the held cells (``--held``,
    one subprocess, records beside ``out_dir`` in ``<name>_held``), all
    started together; none sees the card, and any still running when
    the script exits is killed.  Returns [(cell, Popen, log path)]."""
    import atexit
    import shutil

    shutil.rmtree(out_dir, ignore_errors=True)
    log_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    procs = []
    commands = [((arch, shape), ["--arch", arch, "--shape", shape,
                                 "--mesh", "single", "--probes", "--out",
                                 str(out_dir), "--no-skip-existing"])
                for arch, shape in DRYRUN_CELLS]
    shutil.rmtree(_held_dir(out_dir), ignore_errors=True)
    commands.append((HELD, ["--held", "--out", str(_held_dir(out_dir))]))
    for cell, argv in commands:
        path = log_dir / f"{cell[0]}__{cell[1]}.log"
        with open(path, "w") as f:
            procs.append((cell, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun"] + argv,
                cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT),
                path))
    atexit.register(stop_dryruns, procs)
    return procs


def _held_dir(out_dir: Path) -> Path:
    return out_dir.parent / (out_dir.name + "_held")


def stop_dryruns(procs) -> None:
    for _, proc, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def wait_dryruns(procs) -> float:
    """Wait for the dry-runs (each must exit 0); the seconds waited."""
    t0 = time.perf_counter()
    for (arch, shape), proc, path in procs:
        try:
            rc = proc.wait(timeout=max(1.0, DRYRUN_WAIT_S
                                       - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"the dry-run of {arch} {shape} ran past "
                                 f"{DRYRUN_WAIT_S} s") from None
        if rc != 0 and not ((arch, shape) == HELD and rc == 1):
            raise AssertionError(f"the dry-run of {arch} {shape} exited "
                                 f"{rc}: {path.read_text()[-2000:]}")
    return time.perf_counter() - t0


def _dryrun_results(out_dir: Path):
    """Hold each dry-run record as the reference's test holds it and
    print what each counted; then the roofline CLI over them."""
    records = {}
    for arch, shape in DRYRUN_CELLS:
        for sfx in ("", "__p1", "__p2"):
            name = f"{arch.replace('-', '_')}__{shape}__single{sfx}"
            rec = json.loads((out_dir / f"{name}.json").read_text())
            if "error" in rec:
                raise AssertionError(f"dry-run {name}: {rec['error']}")
            if not (rec["n_devices"] == 256 and rec["cost"]["flops"] > 0
                    and rec["memory"]["per_device_total"] > 0
                    and rec["collectives"]["algorithm_bytes"] >= 0):
                raise AssertionError(f"dry-run {name}: n_devices "
                                     f"{rec['n_devices']}, {rec['cost']}, "
                                     f"{rec['memory']}")
            records[name] = {
                "seconds": rec["lower_s"] + rec["compile_s"],
                "flops_per_device": rec["cost"]["flops"],
                "bytes_accessed_per_device": rec["cost"]["bytes_accessed"],
                "per_device_total_gib":
                    rec["memory"]["per_device_total"] / 2 ** 30,
                "collective_algorithm_bytes_by_op":
                    rec["collectives"]["by_op"],
                "collective_counts": rec["collectives"]["counts"],
                "microbatches": rec.get("microbatches"),
                "model_flops": rec["model_flops"]}
            log(f"[sharding] dry-run {name} " + json.dumps(records[name]))
    roof = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline"], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=300)
    if roof.returncode != 0:
        raise AssertionError(f"roofline exited {roof.returncode}: "
                             f"{roof.stderr[-2000:]}")
    rows = [line for line in roof.stdout.splitlines()
            if line.startswith("| ") and not line.startswith("| arch")]
    for arch, shape in DRYRUN_CELLS:
        if not any(f"| {arch.replace('-', '_')} | {shape} |" in r
                   for r in rows):
            raise AssertionError(f"no roofline row for {arch} {shape}: "
                                 f"{roof.stdout[-2000:]}")
    for r in rows:
        log(f"[sharding] roofline (computed, 256 ranks, H100 constants) {r}")
    return records, rows


def _held_results(held_dir: Path):
    """Each held cell's record against the JAX package's
    (``dryrun.against_reference``): one line a cell with its four ratios
    and this machine's torch; raises naming every bound a cell misses."""
    from repro_torch.launch import dryrun

    held, misses = {}, []
    for name, ref in dryrun.reference_records().items():
        rec = json.loads((held_dir / f"{name}.json").read_text())
        if "error" in rec:
            raise AssertionError(f"dry-run {name}: {rec['error']}")
        held[name] = {"ratios": dryrun.ratios(rec, ref),
                      "misses": dryrun.against_reference(rec, ref),
                      "alias_size_in_bytes":
                          rec["memory"]["alias_size_in_bytes"],
                      "torch": torch.__version__}
        misses += [f"{name}: {m}" for m in held[name]["misses"]]
        log(f"[sharding] held {name} (computed, 256 ranks) "
            + json.dumps(held[name]))
    if misses:
        raise AssertionError("dry-run cells outside the bounds of the JAX "
                             "package's records: " + "; ".join(misses))
    return held


def _launch_train(dev, out_dir: Path, distributed: bool):
    """``repro_torch.launch.train.main`` on LAUNCH_TRAIN at full width,
    every step logged; its metrics, RG-LRU launches and peak memory."""
    import functools
    import gc
    import shutil

    from repro_torch.launch import train

    ckpt = out_dir / ("ckpt_dist" if distributed else "ckpt_plain")
    shutil.rmtree(ckpt, ignore_errors=True)
    spec = LAUNCH_TRAIN
    argv = ["--arch", spec["arch"], "--batch", str(spec["batch"]),
            "--seq", str(spec["seq"]), "--steps", str(spec["steps"]),
            "--ckpt-dir", str(ckpt)] + (["--distributed"] if distributed
                                        else [])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fwd0, bwd0 = read_counts(), read_backward_counts()
    config = train.TrainerConfig
    # every step's loss in the report (the Trainer logs step 1, then
    # every 10th)
    train.TrainerConfig = functools.partial(config, log_every=1)
    try:
        t0 = time.perf_counter()
        report = train.main(argv)
        wall = time.perf_counter() - t0
    finally:
        train.TrainerConfig = config
    torch.cuda.synchronize()
    return {"metrics": report["metrics"], "wall_s": wall,
            "forward_launches": read_counts()["rg_lru"] - fwd0["rg_lru"],
            "backward_launches": (read_backward_counts()["rg_lru"]
                                  - bwd0["rg_lru"]),
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30}


def _mfu_lines(smi: str, recurrent, moe_audio, rec_train):
    """Model FLOPs (``Model.model_flops`` at each step's own shape) over
    the step's seconds times the bf16 peak, for every step phases 12-14
    timed."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import build_model

    rows = []

    def one(phase, arch, kind, seq, batch, seconds):
        mf = build_model(get_config(arch)).model_flops(
            ShapeSpec(f"{kind}_{seq}", kind, seq, batch))
        rows.append({"phase": phase, "arch": arch, "kind": kind,
                     "batch": batch, "seq": seq, "seconds": seconds,
                     "model_flops": mf,
                     "model_flops_share": mf / (seconds * PEAK_BF16_PER_S),
                     "card": smi})

    serving = [(12, arch, r) for arch, r in recurrent.items()] + [
        (13, moe_audio[k]["arch"], moe_audio[k]) for k in ("moe", "audio")]
    for phase, arch, r in serving:
        one(phase, arch, "prefill", r["prompt"], r["batch"],
            r["prefill_wall_ms"] / 1e3)
        one(phase, arch, "decode", r["prompt"], r["batch"],
            r["ms_per_decode_step"] / 1e3)
    trained = [(13, moe_audio["train"])] + [
        (14, r) for r in rec_train.values()
        if isinstance(r, dict) and "sec_per_step" in r]
    for phase, r in trained:
        one(phase, r["arch"], "train", r["seq"], r["batch"],
            r["sec_per_step"][-1])
    for row in rows:
        log("[sharding] mfu (diagnostic) " + json.dumps(row))
    return rows


def phase_sharding(dev, smi: str, recurrent, moe_audio, rec_train):
    """Phase 16: the launcher's ``--distributed`` on the card (b), the
    model-FLOPs share of phases 12-14's steps (c), then the records of
    the dry-runs (a, :func:`start_dryruns`, run on the host beside
    phases 12-14) and the roofline CLI over them.  Returns the record
    and the RG-LRU launches of (b)'s two runs."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_api import layer_kinds

    out_dir = ROOT / "build" / "sharding"
    plain = _launch_train(dev, out_dir, distributed=False)
    with socket.socket() as sock:  # a free port for the group's store
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
           "RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        dist = _launch_train(dev, out_dir, distributed=True)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    steps = LAUNCH_TRAIN["steps"]
    n_rec = layer_kinds(get_config(LAUNCH_TRAIN["arch"])).count("rec")
    for what, run in (("plain", plain), ("distributed", dist)):
        if [m["step"] for m in run["metrics"]] != list(
                range(1, steps + 1)):
            raise AssertionError(f"launch.train {what}: logged steps "
                                 f"{[m['step'] for m in run['metrics']]}")
        if (run["forward_launches"], run["backward_launches"]) != (
                2 * n_rec * steps, n_rec * steps):
            raise AssertionError(
                f"launch.train {what}: RG-LRU launches forward "
                f"{run['forward_launches']}, backward "
                f"{run['backward_launches']}; want "
                f"{2 * n_rec * steps}, {n_rec * steps}")
    got = [(m["loss"], m["grad_norm"]) for m in dist["metrics"]]
    want = [(m["loss"], m["grad_norm"]) for m in plain["metrics"]]
    if got != want or not all(math.isfinite(x) for p in got for x in p):
        raise AssertionError(f"launch.train --distributed {got} != "
                             f"without the flag {want}")
    launcher = {"plain": plain, "distributed": dist}
    log("[sharding] launch.train " + json.dumps(launcher))
    mfu = _mfu_lines(smi, recurrent, moe_audio, rec_train)
    dryrun, roofline = _dryrun_results(ROOT / "build" / "dryrun")
    held = _held_results(_held_dir(ROOT / "build" / "dryrun"))
    return ({"launcher": launcher, "mfu": mfu, "dryrun": dryrun,
             "held": held,
             "roofline": roofline},
            {"forward": plain["forward_launches"] + dist["forward_launches"],
             "backward": (plain["backward_launches"]
                          + dist["backward_launches"])})


def main() -> int:
    t_start = time.perf_counter()
    smi, name = phase_card()
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
               any_sizes=(1000,), any_chains=1, reps=1)
    # Bluestein's tables of the path's lengths (one FFT launch each when
    # built) are built outside the counted run, as the twiddles are
    from repro_torch.kernels.fft import bluestein
    for n in (1000, 3000):
        for inverse in (False, True):
            bluestein.tables(n, inverse, dev)
    reset_counts()
    t0 = time.perf_counter()
    results, counter = phase_main(None)
    main_s = time.perf_counter() - t0
    launches = read_counts()
    log(f"[main] {len(results)} configurations in {main_s:.1f}s; "
        f"device tasks fft/ifft {counter.fft} (of them at lengths that are "
        f"not powers of two {counter.fft_bluestein}), zip {counter.zip}; "
        f"kernel launches {launches}")
    if launches["fft"] <= 0 or launches["zip"] <= 0:
        raise AssertionError(f"a kernel never ran on the main path: {launches}")
    if counter.fft_bluestein <= 0:
        raise AssertionError("no FFT task at a length that is not a power of "
                             "two ran on the main path")
    want = counter.launches()
    if (launches["fft"], launches["zip"]) != (want["fft"], want["zip"]):
        raise AssertionError(
            f"launch counts {launches} != what the device tasks launch "
            f"{want} (fft/ifft tasks {counter.fft}, {counter.fft_bluestein} "
            f"of them through Bluestein; zip tasks {counter.zip})")

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

    t0 = time.perf_counter()
    runtime = phase_runtime(ROOT / "build" / "runtime", suite["traces"])
    log(f"[runtime] phase in {time.perf_counter() - t0:.1f}s; multitenant "
        f"kernel launches {runtime['launches']}")

    # phase 16's dry-runs (host only) run from here on, beside 12-14
    dryruns = start_dryruns(ROOT / "build" / "dryrun",
                            ROOT / "build" / "sharding" / "logs")
    t0 = time.perf_counter()
    recurrent, rec_counts = phase_recurrent(dev)
    log(f"[recurrent] phase in {time.perf_counter() - t0:.1f}s")
    for r in recurrent.values():
        errs[r["kernel"]] = max(errs[r["kernel"]], r["kernel_max_abs_err"])

    t0 = time.perf_counter()
    moe_audio, p13_counts = phase_moe_audio_train(
        dev, ROOT / "build" / "moe_audio_train")
    p13_s = time.perf_counter() - t0
    log(f"[moe/audio/train] phase in {p13_s:.1f}s; kernel launches "
        f"{p13_counts}")

    t0 = time.perf_counter()
    rec_train, p14_counts = phase_recurrent_train(
        dev, ROOT / "build" / "recurrent_train")
    p14_s = time.perf_counter() - t0
    log(f"[rec-train] phase in {p14_s:.1f}s; training launches "
        f"{p14_counts}")
    bwd_timing = {r["kernel"].split("_backward")[0]: r
                  for r in rec_train["timing"]}

    # phase 15's wall rows and traces want a quiet host: the dry-runs end
    # first
    dryrun_wait_s = wait_dryruns(dryruns)
    log(f"[sharding] waited {dryrun_wait_s:.1f}s for the dry-runs")

    t0 = time.perf_counter()
    process, p15_counts = phase_process_backend(
        dev, ROOT / "build" / "process_backend", smi)
    log(f"[process] phase in {time.perf_counter() - t0:.1f}s; gpu0 kernel "
        f"launches beside the workers {p15_counts}")

    t0 = time.perf_counter()
    sharding, p16_counts = phase_sharding(dev, smi, recurrent, moe_audio,
                                          rec_train)
    sharding["dryrun_wait_s"] = dryrun_wait_s
    p16_s = time.perf_counter() - t0
    log(f"[sharding] phase in {p16_s:.1f}s; RG-LRU launches of the "
        f"launcher's runs {p16_counts}")

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
        # the recurrent path's own shapes (phase 12's prefills)
        ("mlstm", pick("mlstm", "dims", list(MLSTM_TIMED[-1][:4])),
         "src/repro/kernels/mlstm/mlstm.py:28", None),
        ("rg_lru", pick("rg_lru", "dims", list(RG_LRU_TIMED[-1])),
         "src/repro/kernels/rg_lru/rg_lru.py:24", None),
        ("paged_attention", pick("paged_attention", "case", "decode_4096"),
         "src/repro/kernels/paged_attention/paged_attention.py:31", None),
    ):
        # the radar path for FFT and ZIP, the serving path for paged
        # attention, the recurrent path for mLSTM and RG-LRU, the
        # autotuning path for the kernel only it runs
        # FFT and ZIP: the radar path's and phase 15's gpu0 PE, launched
        # in-process beside the process backend's workers
        path_launches = (launches[kname] + p15_counts[kname]
                         if kname in ("fft", "zip") else
                         serve_counts[kname] if kname == "paged_attention"
                         else rec_counts[kname] if kname in ("mlstm", "rg_lru")
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
                for r in timing if r["kernel"] == kname],
                "recurrent_path": next(
                    {k: rec[k] for k in (
                        "kernel_shape", "kernel_max_abs_err",
                        "kernel_device_ms_per_call", "kernel_bound_ms",
                        "kernel_bound_by", "kernel_launches_per_prefill",
                        "prefill_wall_ms", "ms_per_decode_step",
                        "prefill_busy_share")}
                    for rec in recurrent.values() if rec["kernel"] == kname)}
               if kname in ("mlstm", "rg_lru") else {}),
            # flash attention: every timed width and type
            **({"timed_shapes": [
                {k: r.get(k) for k in (
                    "shape", "dtype", "d", "padded_d", "kernel_ms",
                    "kernel_device_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by")}
                for r in timing if r["kernel"] == kname]}
               if kname == "flash_attention" else {}),
            # FFT: every timed shape, one launch up to 8192 and the
            # four-step's two past it; FFT and ZIP: the paper suite's
            # launches (phase 10)
            **({"timed_shapes": [
                {k: r.get(k) for k in (
                    "rows", "n", "route", "inner_n", "launches_per_call",
                    "workspace_bytes", "kernel_ms", "kernel_sync_ms",
                    "kernel_device_ms", "library_ms", "library_device_ms",
                    "plain_ms", "bound_ms", "bound_by", "bound_two_pass_ms",
                    "bound_two_pass_twiddles_ms")}
                for r in timing if r["kernel"] == "fft"]}
               if kname == "fft" else {}),
            # mLSTM and RG-LRU: training's launches (phase 14: forward,
            # twice a layer and step under remat, and backward) and the
            # backward kernel's check and times
            **({"train_launches": p14_counts["forward"][kname],
                "backward_launches": p14_counts["backward"][kname],
                "backward": {
                    "source": f"src/repro_torch/csrc/{kname}_bwd.cu",
                    "replaces": None,
                    "max_abs_err": max(
                        r["max_abs_err"] for r in rec_train["mlstm_checks"]
                        + rec_train["rg_lru_checks"]
                        if r["kernel"] == kname),
                    **{k: bwd_timing[kname][k] for k in (
                        "shape", "kernel_ms", "kernel_device_ms",
                        "device_kernels_per_call", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")},
                    **({k: bwd_timing[kname][k] for k in (
                        "fwd_bwd_ms", "fwd_bwd_device_ms",
                        "fwd_bwd_bound_ms")} if kname == "mlstm" else {})}}
               if kname in ("mlstm", "rg_lru") else {}),
            # paged attention: the train -> checkpoint -> serve
            # lifecycle's launches (phase 13)
            **({"lifecycle_launches": p13_counts[kname]}
               if kname == "paged_attention" else {}),
            # RG-LRU: the training launcher's two runs (phase 16)
            **({"launcher_launches": p16_counts}
               if kname == "rg_lru" else {}),
            **({"process_backend_launches": p15_counts[kname],
                "paper_suite_launches": suite["launches"][kname],
                "multitenant_launches": runtime["launches"][kname],
                "multitenant_launches_by_depth": {
                    d: r["launches"][kname]
                    for d, r in runtime["multitenant"].items()}}
               if kname in ("fft", "zip") else {}),
            # FFT and ZIP: what a runtime task pays (one call then a
            # synchronise), the host's share, the library's device time
            **{k: t[k] for k in ("kernel_sync_ms", "kernel_enqueue_ms",
                                 "library_sync_ms", "library_enqueue_ms",
                                 "library_device_ms") if k in t},
        })
    log("[serve] summary " + json.dumps({"engines": serving,
                                         "step_profiles": step_profile}))
    log("[recurrent] summary " + json.dumps(
        {arch: {k: v for k, v in r.items() if not k.endswith("_profile")}
         for arch, r in recurrent.items()}))
    log("[moe/audio/train] summary " + json.dumps(
        {k: ({kk: vv for kk, vv in v.items()
              if not kk.endswith("_profile")}
             if isinstance(v, dict) else v)
         for k, v in moe_audio.items()} | {"phase_s": p13_s}))
    log("[rec-train] summary " + json.dumps(
        {k: ({kk: vv for kk, vv in v.items()
              if not kk.endswith("_profile")}
             if isinstance(v, dict) else v)
         for k, v in rec_train.items()} | {"phase_s": p14_s}))
    log("[process] summary " + json.dumps(process))
    log("[sharding] summary " + json.dumps(
        {k: v for k, v in sharding.items() if k != "mfu"}
        | {"phase_s": p16_s}))
    log(f"[done] {time.perf_counter() - t_start:.1f}s in all")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
