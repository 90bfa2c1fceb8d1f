"""Process-backed PE workers.

Each eligible PE gets one subprocess (spawned lazily on first use) that
executes registered ``@rimms.op`` kernels against host payloads.  Arrays
whose bytes live in a :class:`~repro_torch.core.shm.SharedHostArena` cross
the process boundary as zero-copy handles; everything else is sent
inline.  Kernels are shipped once per ``(op, pe kind)`` by *reference*
(standard pickle of a module-level function), so the worker imports
exactly the module that defined the kernel.

Eligible PEs are those whose memory space holds host-format payloads
(:attr:`~repro_torch.core.hete.MemorySpace.proc_exec`): every ``cpu`` PE,
and accelerator PEs only when their spaces live on the CPU.  A PE whose
space holds CUDA tensors keeps in-process dispatch, so a worker never
touches the card.  The worker hands a kernel what the thread backend
hands it on that PE: numpy arrays for a host PE, and for an accelerator
PE CPU tensors made zero-copy over the same bytes (``torch.from_numpy``);
outputs come back as numpy through the worker's scratch segment.

Workers start with ``spawn`` (a forked child of a process that has
initialised CUDA cannot use it, and these never need it).  Each pays one
``import torch`` when the pool first reaches it, and runs torch's CPU
ops on :data:`WORKER_TORCH_THREADS` intra-op threads, so a pool of
workers beside the parent does not oversubscribe the host's cores.

The pool deliberately changes nothing about scheduling or the memory
model: staging, flag checks, the transfer ledger and the modeled replay
all run in the parent exactly as under the thread backend — only the
kernel call itself moves out of the GIL.  Per-PE serialization is
preserved (one pipe per worker, one executing thread per PE), which is
also what keeps forwarded worker spans non-overlapping on their tracks.

Failure model: a worker that dies mid-call surfaces as
:class:`WorkerDied` (with the exit code) from the task that was running
on it — a clean per-task error through the session's existing failure
paths, never a hang.  ``shutdown()`` asks workers to exit, then joins
and finally kills stragglers, so ``Runtime.close()`` reaps every
subprocess.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import shm as shm_mod
from .trace import MetricsRegistry

__all__ = ["WorkerDied", "ProcessWorker", "ProcessWorkerPool", "worker_main",
           "WORKER_TORCH_THREADS"]

# Scratch segment each worker allocates for its outputs (grown on demand).
_SCRATCH_START = 8 << 20

#: torch intra-op threads in each worker (``torch.set_num_threads``)
WORKER_TORCH_THREADS = 1


class WorkerDied(RuntimeError):
    """A PE worker subprocess exited while (or before) running a task."""


# ---------------------------------------------------------------------------
# Worker side (runs in the subprocess)
# ---------------------------------------------------------------------------


def _resolve_payloads(handles: List[Tuple[str, Any]],
                      as_tensor: bool = False) -> List[Any]:
    """Inputs as the kernel takes them: numpy views (read-only over the
    shared pages), or with ``as_tensor`` CPU tensors over the same bytes,
    as an accelerator space on the CPU holds them."""
    out = []
    for kind, payload in handles:
        if kind == "shm":
            value = shm_mod.resolve_handle(payload, writable=as_tensor)
        else:  # "inline"
            value = payload
        if as_tensor:
            value = torch.from_numpy(np.ascontiguousarray(value))
        out.append(value)
    return out


class _Scratch:
    """Bump allocator over the worker's own shared segment for outputs.

    Reset every task: the parent copies results out before it sends the
    next task on this pipe, so reuse is safe.
    """

    def __init__(self) -> None:
        self.shm = None
        self.size = 0
        self.off = 0

    def _ensure(self, nbytes: int) -> None:
        if self.shm is not None and self.off + nbytes <= self.size:
            return
        need = max(self.size * 2, self.off + nbytes, _SCRATCH_START)
        old = self.shm
        from multiprocessing import shared_memory

        self.shm = shared_memory.SharedMemory(create=True, size=need)
        self.size = need
        self.off = 0
        if old is not None:
            old.close()
            old.unlink()

    def place(self, arr: np.ndarray) -> Tuple[str, Any]:
        """Copy ``arr`` into scratch, return a handle (or inline on any
        shared-memory failure)."""
        arr = np.ascontiguousarray(arr)
        try:
            self._ensure(arr.nbytes)
        except Exception:  # pragma: no cover - /dev/shm exhausted
            return ("inline", arr)
        off = self.off
        view = np.ndarray(arr.shape, dtype=arr.dtype, buffer=self.shm.buf,
                          offset=off)
        np.copyto(view, arr)
        # 64-byte align the next placement (matches SharedHostArena).
        self.off = off + ((arr.nbytes + 63) & ~63)
        return ("shm", (self.shm.name, off, arr.shape, arr.dtype.str))

    def reset(self) -> None:
        self.off = 0

    def destroy(self) -> None:
        if self.shm is not None:
            try:
                self.shm.close()
                self.shm.unlink()
            except Exception:  # pragma: no cover
                pass
            self.shm = None


def _to_host(value: Any) -> np.ndarray:
    """Worker-side egress: kernels may return CPU tensors; ship numpy."""
    if isinstance(value, np.ndarray):
        return value
    if isinstance(value, torch.Tensor):  # on the CPU: never CUDA here
        return value.detach().numpy()
    return np.asarray(value)


def worker_main(conn, pe_name: str) -> None:
    """Subprocess entry point: serve kernel calls over ``conn``.

    Protocol (parent → worker / worker → parent):

    * ``("init",)`` → ``("ready", pid, perf_counter)`` — the clock reply
      is the offset handshake trace forwarding uses.
    * ``("reg", key, fn_bytes, as_tensor)`` → ``("ok",)`` |
      ``("err", msg)``; ``as_tensor`` hands the kernel CPU tensors.
    * ``("run", key, handles, params)`` →
      ``("ok", out_handles, t0, t1)`` | ``("err", msg)`` where t0/t1 are
      the kernel interval on the *worker's* clock.
    * ``("metrics",)`` → ``("ok", state)`` — drain the worker-local
      metrics registry (counters + histograms accumulated since the last
      drain) for cross-process aggregation; ``state["worker"]`` adds the
      pid, ``cuda_initialized`` and the torch thread count.
    * ``("exit",)`` → worker cleans up and leaves.
    """
    import os

    torch.set_num_threads(WORKER_TORCH_THREADS)
    kernels: Dict[tuple, Tuple[Any, bool]] = {}
    scratch = _Scratch()
    # Worker-local metrics: accumulated here without any IPC on the hot
    # path, merged into the parent registry on drain.
    metrics = MetricsRegistry()
    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):  # parent died
                break
            cmd = msg[0]
            if cmd == "exit":
                conn.send(("bye",))
                break
            if cmd == "init":
                conn.send(("ready", os.getpid(), time.perf_counter()))
                continue
            if cmd == "reg":
                _, key, fn_bytes, as_tensor = msg
                try:
                    kernels[tuple(key)] = (pickle.loads(fn_bytes),
                                           bool(as_tensor))
                    conn.send(("ok",))
                except BaseException:
                    conn.send(("err", traceback.format_exc()))
                continue
            if cmd == "run":
                _, key, handles, params = msg
                try:
                    fn, as_tensor = kernels[tuple(key)]
                    ins = _resolve_payloads(handles, as_tensor)
                    t0 = time.perf_counter()
                    outs = fn(ins, **params)
                    if not isinstance(outs, tuple):
                        outs = (outs,)
                    outs = tuple(_to_host(o) for o in outs)
                    t1 = time.perf_counter()
                    scratch.reset()
                    out_handles = [scratch.place(o) for o in outs]
                    metrics.counter(f"worker/{pe_name}/tasks").inc()
                    metrics.histogram(
                        f"worker/{pe_name}/kernel_s").record(t1 - t0)
                    conn.send(("ok", out_handles, t0, t1))
                except BaseException:
                    metrics.counter(f"worker/{pe_name}/errors").inc()
                    conn.send(("err", traceback.format_exc()))
                continue
            if cmd == "metrics":
                # Drain semantics: each reply carries only the delta
                # since the previous drain, so the parent can merge at
                # every session close without double counting.
                state = metrics.state()
                state["worker"] = {
                    "pid": os.getpid(),
                    "cuda_initialized": torch.cuda.is_initialized(),
                    "torch_threads": torch.get_num_threads(),
                }
                conn.send(("ok", state))
                metrics = MetricsRegistry()
                continue
            conn.send(("err", f"unknown command {cmd!r}"))  # pragma: no cover
    finally:
        scratch.destroy()
        shm_mod.detach_all()
        try:
            conn.close()
        except Exception:  # pragma: no cover
            pass


# ---------------------------------------------------------------------------
# Parent side
# ---------------------------------------------------------------------------


class ProcessWorker:
    """Parent handle for one PE's subprocess: pipe, clock offset, cache
    of which kernels were already shipped."""

    def __init__(self, pe_name: str, ctx: Optional[mp.context.BaseContext] = None) -> None:
        ctx = ctx or mp.get_context("spawn")
        self.pe_name = pe_name
        self.conn, child = ctx.Pipe(duplex=True)
        self.proc = ctx.Process(
            target=worker_main, args=(child, pe_name),
            name=f"rimms-pe-{pe_name}", daemon=True,
        )
        self.proc.start()
        child.close()
        self._sent: set = set()
        self._scratch_names: set = set()
        self._lock = threading.Lock()
        # Clock-offset handshake: worker perf_counter + offset ≈ parent
        # perf_counter (midpoint estimate; forwarded spans are clamped to
        # the parent-observed call window anyway).
        t_a = time.perf_counter()
        reply = self._rpc(("init",))
        t_b = time.perf_counter()
        self.pid = reply[1]
        self.clock_offset = (t_a + t_b) / 2 - reply[2]

    def _rpc(self, msg: tuple) -> tuple:
        try:
            self.conn.send(msg)
            reply = self.conn.recv()
        except (EOFError, OSError, BrokenPipeError) as e:
            self.proc.join(timeout=1.0)
            raise WorkerDied(
                f"PE worker {self.pe_name!r} (pid {self.proc.pid}) died "
                f"with exit code {self.proc.exitcode} during {msg[0]!r}"
            ) from e
        if reply[0] == "err":
            raise RuntimeError(
                f"kernel error on PE worker {self.pe_name!r}:\n{reply[1]}")
        return reply

    def ensure_kernel(self, key: tuple, fn: Any,
                      as_tensor: bool = False) -> None:
        """Ship ``fn`` under ``key`` once; ``as_tensor`` makes the worker
        hand it CPU tensors (an accelerator PE on the CPU)."""
        if key in self._sent:
            return
        try:
            fn_bytes = pickle.dumps(fn)
        except Exception as e:
            raise RuntimeError(
                f"kernel {key} is not picklable ({e}); the process backend "
                f"needs module-level kernel functions — use backend='thread' "
                f"for closures/lambdas") from e
        self._rpc(("reg", key, fn_bytes, bool(as_tensor)))
        self._sent.add(key)

    def run(self, key: tuple, ins: List[Any], params: Dict[str, Any]
            ) -> Tuple[tuple, float, float, float, float]:
        """Execute; returns (outputs, wall call window in parent clock
        w0..w1, kernel interval in parent clock k0..k1)."""
        handles: List[Tuple[str, Any]] = []
        for v in ins:
            h = shm_mod.describe_array(v)
            handles.append(("shm", h) if h is not None
                           else ("inline", np.asarray(v)))
        with self._lock:
            w0 = time.perf_counter()
            reply = self._rpc(("run", key, handles, params))
            w1 = time.perf_counter()
            _, out_handles, t0_w, t1_w = reply
            for kind, p in out_handles:
                if kind == "shm":
                    self._scratch_names.add(p[0])
            # Copy results out of the worker's scratch before the next
            # task reuses it (one copy; inputs were zero-copy).
            outs = tuple(
                np.array(shm_mod.resolve_handle(p)) if kind == "shm" else p
                for kind, p in out_handles
            )
        k0 = min(max(t0_w + self.clock_offset, w0), w1)
        k1 = min(max(t1_w + self.clock_offset, k0), w1)
        return outs, w0, w1, k0, k1

    def metrics_state(self) -> Dict[str, Any]:
        """Drain the worker's local metrics registry: returns a
        :meth:`~repro_torch.core.trace.MetricsRegistry.state` dict (plus
        ``"worker"``: pid, ``cuda_initialized``, torch threads) and resets
        the worker-side accumulators."""
        with self._lock:
            reply = self._rpc(("metrics",))
        return reply[1]

    @property
    def alive(self) -> bool:
        return self.proc.is_alive()

    def shutdown(self, timeout: float = 5.0) -> None:
        try:
            self.conn.send(("exit",))
        except (OSError, BrokenPipeError):
            pass
        self.proc.join(timeout=timeout)
        if self.proc.is_alive():  # pragma: no cover - stuck worker
            self.proc.kill()
            self.proc.join(timeout=1.0)
        try:
            self.conn.close()
        except Exception:  # pragma: no cover
            pass
        # A clean worker unlinks its own scratch; one that died hard
        # leaves it registered with the (shared) resource tracker until
        # interpreter exit.  Reap it here so worker death never leaks a
        # segment or a shutdown warning.
        from multiprocessing import shared_memory

        for name in self._scratch_names:
            try:
                seg = shared_memory.SharedMemory(name=name)
            except (FileNotFoundError, OSError):
                continue
            try:
                seg.close()
                seg.unlink()
            except Exception:  # pragma: no cover
                pass


class ProcessWorkerPool:
    """Lazy per-PE subprocess registry; thread-safe get-or-spawn."""

    def __init__(self) -> None:
        self._workers: Dict[str, ProcessWorker] = {}
        self._lock = threading.Lock()
        self._ctx = mp.get_context("spawn")
        self.closed = False

    def worker(self, pe_name: str) -> ProcessWorker:
        with self._lock:
            if self.closed:
                raise WorkerDied("process worker pool is shut down")
            w = self._workers.get(pe_name)
            if w is not None and not w.alive:
                # Died outside a call (e.g. killed externally): replace so
                # later tasks get a live worker; the task that *observed*
                # the death already got its WorkerDied.
                w.shutdown(timeout=0.1)
                w = None
            if w is None:
                w = ProcessWorker(pe_name, self._ctx)
                self._workers[pe_name] = w
            return w

    def pids(self) -> Dict[str, int]:
        with self._lock:
            return {n: w.pid for n, w in self._workers.items()}

    def collect_metrics(self, registry: MetricsRegistry) -> int:
        """Drain every live worker's local metrics into ``registry``
        (cross-process aggregation).  Dead workers are skipped —
        their un-drained deltas are lost, which is the documented
        trade-off for a lock-free worker hot path.  Returns the number
        of workers merged."""
        with self._lock:
            workers = list(self._workers.values())
        merged = 0
        for w in workers:
            try:
                registry.merge_state(w.metrics_state())
                merged += 1
            except (WorkerDied, RuntimeError):
                continue
        return merged

    def procs(self) -> List[mp.Process]:
        with self._lock:
            return [w.proc for w in self._workers.values()]

    def shutdown(self) -> None:
        with self._lock:
            if self.closed:
                return
            self.closed = True
            workers = list(self._workers.values())
            self._workers.clear()
        for w in workers:
            w.shutdown()
