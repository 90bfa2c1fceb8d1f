"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into an
object, all of them at once, and the objects are linked into one shared
library with a plain C interface, loaded with :mod:`ctypes`.  The
library goes to ``build/repro_torch/`` at the repository root, keyed by
a hash of the sources and flags, so a rebuilt checkout reuses it and an
edited source rebuilds.  The first use builds, under a lock: callers
that time kernels (the runtime's cost model, ``chip_smoke.py``) load the
library before they time anything.

Every wrapper launches through :func:`launch`, which hands the C entry
point the raw ``cudaStream_t`` of the tensor's device's current stream
(no ``torch.cuda.Stream`` object) and enters a device guard only when
that device is not the current one.

Nothing here runs at import: this module imports on a machine without
``nvcc`` or a GPU, and only :func:`library` and :func:`launch` need
them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

__all__ = ["library", "check", "launch", "raw_stream", "refuse_grad", "CSRC",
           "BUILD_DIR", "ARCH_FLAGS", "build_seconds", "build_log"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last :func:`library` call spent compiling (0.0 when the
#: library was already built)
build_seconds = 0.0
#: the compiler's output of the last build (``-Xptxas -v``: registers,
#: shared memory and spills per kernel)
build_log = ""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda): the CUDA kernels of repro_torch cannot be built")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _key(srcs) -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Start every command at once; raise with the compiler's stderr if
    any fails.  Returns the combined output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc build failed:\n" + "\n".join(failed))
    return "".join(logs)


def _build(srcs, target: Path) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (p.stem + ".o") for p in srcs]
        log = _run_all([[nvcc, *COMPILE_FLAGS, "-c", str(p), "-o", str(o)]
                        for p, o in zip(srcs, objs)])
        tmp_lib = Path(tmp) / target.name
        log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                          *map(str, objs)]])
        os.replace(tmp_lib, target)  # atomic: concurrent builders agree
    return log


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f32 = ctypes.c_float
    lib.rimms_fft_c64.argtypes = [p, p, p, p]
    lib.rimms_fft4_c64.argtypes = [p, p, p, p, p]
    lib.rimms_zip_c64.argtypes = [p, p, p, i64, i32, p]
    lib.rimms_rg_lru_f32.argtypes = [p] * 6 + [i32] * 5 + [p]
    lib.rimms_rg_lru_bwd_f32.argtypes = [p] * 9 + [i32] * 5 + [p]
    lib.rimms_flash_attention.argtypes = [p, p, p, p] + [i32] * 9 + [f32, p]
    lib.rimms_mlstm_f32.argtypes = [p] * 12 + [i32] * 5 + [f32, p]
    lib.rimms_mlstm_bwd_f32.argtypes = [p] * 18 + [i32] * 5 + [f32, p]
    lib.rimms_paged_attention.argtypes = [p] * 8 + [i32] * 10 + [f32, p]
    for fn in (lib.rimms_fft_c64, lib.rimms_fft4_c64, lib.rimms_zip_c64,
               lib.rimms_rg_lru_f32, lib.rimms_rg_lru_bwd_f32,
               lib.rimms_flash_attention, lib.rimms_mlstm_f32,
               lib.rimms_mlstm_bwd_f32, lib.rimms_paged_attention):
        fn.restype = i32
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (thread-safe)."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            srcs = _sources()
            target = BUILD_DIR / f"librimms_kernels_{_key(srcs)}.so"
            t0 = time.perf_counter()
            if not target.exists():
                build_log = _build(srcs, target)
            build_seconds = time.perf_counter() - t0
            _lib = _bind(ctypes.CDLL(str(target)))
    return _lib


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise :class:`NotImplementedError` when autograd would record a
    call of ``kernel`` on ``tensors`` (grad mode on and any of them
    requiring grad).  The FFT, ZIP, flash-attention and paged-attention
    kernels have no backward (ROADMAP C.15: neither package trains
    through them): a ctypes launch returns an output with no
    ``grad_fn``, so a ``loss.backward()`` through it would silently drop
    every gradient beneath.  Their wrappers call this on their CUDA
    branch only; the plain versions on the CPU are differentiable torch.
    The mLSTM and RG-LRU wrappers have backward kernels instead (ROADMAP
    A12) and never call it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel}: the CUDA kernel has no backward (ROADMAP C.15; A12 "
            f"gave backward kernels to the mLSTM and the RG-LRU only); call "
            f"it under torch.no_grad() or torch.inference_mode(), or on CPU "
            f"tensors, whose plain version is differentiable")


def check(status: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {status}")


def raw_stream(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of the current stream on CUDA tensor
    ``t``'s device, as PyTorch's own generated launchers read it (no
    ``torch.cuda.Stream`` object is built)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def launch(fn, t: torch.Tensor, *args) -> int:
    """Call the C entry point ``fn(*args, stream)`` with ``stream`` the
    :func:`raw_stream` of CUDA tensor ``t``'s device, under a device guard
    only when that device is not the current one (a kernel launches on
    the current device).  Returns ``fn``'s status for :func:`check`."""
    index = t.get_device()
    if index == torch._C._cuda_getDevice():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
