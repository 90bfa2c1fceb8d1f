"""Shared-memory host arenas — pickling-free buffer handles.

The process PE backend executes registered kernels in subprocess workers.
Shipping numpy payloads through a pipe costs one serialize + one copy per
array per task; RIMMS's whole point is that the runtime *knows* where
bytes live, so it can do better.  :class:`SharedHostArena` carves host
buffers out of one ``multiprocessing.shared_memory`` segment managed by
the same extent allocators that already run the modeled device arenas
(:mod:`repro_torch.core.allocator`).  Any array whose bytes live inside a
registered arena travels to a worker as a 4-tuple *handle* —
``(segment name, byte offset, shape, dtype)`` — and the worker maps the
same physical pages: zero-copy host↔worker, exactly the "resource
pointer" discipline of ``hete_Data`` extended across process boundaries.

Lifecycle is garbage-collection driven: every array handed out holds the
segment's buffer alive, and a ``weakref.finalize`` on the array returns
its extent to the allocator when the last reference drops.  Callers
therefore never pair mallocs with frees, and an arena that fills up
degrades gracefully — :meth:`SharedHostArena.zeros` / :meth:`copy_in`
return ``None`` and the caller falls back to ordinary heap numpy (whose
handles are sent inline instead).

Nothing here imports torch: the module is numpy and
``multiprocessing.shared_memory`` only.  (A worker subprocess still pays
one ``import torch`` through the package it lives in, once per pool.)
"""

from __future__ import annotations

import os
import threading
import weakref
from multiprocessing import shared_memory
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .allocator import AllocError, make_allocator

__all__ = [
    "SharedHostArena",
    "attach_segment",
    "describe_array",
    "resolve_handle",
]

# Alignment for every extent we hand out.  64 bytes covers any numpy
# dtype and keeps views cache-line aligned for the workers.
_ALIGN = 64

# Registry of live arenas in THIS process, keyed by segment name — the
# lookup :func:`describe_array` scans to turn an array into a handle.
_ARENAS: Dict[str, "SharedHostArena"] = {}
_ARENAS_LOCK = threading.Lock()


class SharedHostArena:
    """One shared-memory segment + extent allocator for host buffers.

    ``alloc`` hands out 64-byte-aligned extents via the block-aligned
    :class:`~repro_torch.core.allocator.BitsetAllocator` (block size =
    alignment, so offsets are aligned by construction); arrays are numpy
    views over the segment with a GC finalizer returning the extent.
    """

    def __init__(self, capacity: int) -> None:
        capacity = max(int(capacity), _ALIGN)
        self.shm = shared_memory.SharedMemory(create=True, size=capacity)
        self.name = self.shm.name
        self.capacity = capacity
        self.arena = make_allocator("bitset", capacity, _ALIGN)
        self._lock = threading.Lock()
        self._closed = False
        # Base address of the mapping in this process — describe_array
        # turns array data pointers into segment offsets against it.
        self.base = np.frombuffer(self.shm.buf, dtype=np.uint8)
        self._base_addr = self.base.__array_interface__["data"][0]
        with _ARENAS_LOCK:
            _ARENAS[self.name] = self
        # Last-resort cleanup if the owner never calls destroy().
        self._finalizer = weakref.finalize(
            self, SharedHostArena._destroy_raw, self.shm, self.name)

    # -- allocation ---------------------------------------------------------
    def _free_extent(self, ext) -> None:
        with self._lock:
            if not self._closed:
                self.arena.free(ext)

    def empty(self, shape, dtype) -> Optional[np.ndarray]:
        """An uninitialised array inside the segment, or ``None`` when
        the arena can't fit it (caller falls back to heap numpy)."""
        shape = (int(shape),) if isinstance(shape, (int, np.integer)) \
            else tuple(int(s) for s in shape)
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        with self._lock:
            if self._closed:
                return None
            try:
                ext = self.arena.alloc(max(nbytes, 1))
            except AllocError:
                return None
        arr = np.ndarray(shape, dtype=dtype, buffer=self.shm.buf,
                         offset=ext.offset)
        weakref.finalize(arr, self._free_extent, ext)
        return arr

    def zeros(self, shape, dtype) -> Optional[np.ndarray]:
        arr = self.empty(shape, dtype)
        if arr is not None:
            arr.fill(0)
        return arr

    def copy_in(self, value: np.ndarray) -> Optional[np.ndarray]:
        """A fresh arena-backed copy of ``value`` (or ``None`` if full)."""
        value = np.asarray(value)
        arr = self.empty(value.shape, value.dtype)
        if arr is not None:
            np.copyto(arr, value)
        return arr

    # -- handle mapping -----------------------------------------------------
    def describe(self, arr: np.ndarray) -> Optional[Tuple[str, int, tuple, str]]:
        """Handle for ``arr`` if its bytes live in this segment."""
        if not (isinstance(arr, np.ndarray) and arr.flags["C_CONTIGUOUS"]):
            return None
        addr = arr.__array_interface__["data"][0]
        off = addr - self._base_addr
        if 0 <= off and off + arr.nbytes <= self.capacity:
            return (self.name, off, arr.shape, arr.dtype.str)
        return None

    # -- stats / lifecycle --------------------------------------------------
    def used_bytes(self) -> int:
        with self._lock:
            return int(self.arena.used_bytes)

    @staticmethod
    def _destroy_raw(shm: shared_memory.SharedMemory, name: str) -> None:
        with _ARENAS_LOCK:
            _ARENAS.pop(name, None)
        try:
            shm.close()
        except Exception:  # pragma: no cover - interpreter teardown
            pass
        try:
            shm.unlink()
        except Exception:
            pass

    def destroy(self) -> None:
        """Close + unlink the segment (idempotent).  Outstanding views
        keep their pages mapped until they are collected; new allocations
        are refused."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self.base = None
        self._finalizer.detach()
        self._destroy_raw(self.shm, self.name)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"SharedHostArena({self.name!r}, {self.used_bytes()}/"
                f"{self.capacity} bytes)")


# ---------------------------------------------------------------------------
# Module-level handle plumbing (used by both parent and workers)
# ---------------------------------------------------------------------------


def describe_array(arr: Any) -> Optional[Tuple[str, int, tuple, str]]:
    """Zero-copy handle for ``arr`` if it lives in any registered arena
    of this process, else ``None`` (send it inline)."""
    if not isinstance(arr, np.ndarray):
        return None
    with _ARENAS_LOCK:
        arenas = list(_ARENAS.values())
    for arena in arenas:
        h = arena.describe(arr)
        if h is not None:
            return h
    return None


# Worker-side cache of attached segments: name -> SharedMemory.  The
# parent's own segments resolve through _ARENAS without re-attaching.
_ATTACHED: Dict[str, shared_memory.SharedMemory] = {}
_ATTACHED_LOCK = threading.Lock()


def attach_segment(name: str) -> shared_memory.SharedMemory:
    """Attach (once) to the named segment created by another process.

    Attaching re-registers the name with the resource tracker, but
    spawned workers *share* the parent's tracker process, so that add is
    idempotent — the one ``unlink`` by whoever destroys the segment
    balances it.  (Per-process trackers would need ``track=False`` /
    manual unregistering here; shared-tracker semantics make that both
    unnecessary and wrong.)"""
    with _ATTACHED_LOCK:
        shm = _ATTACHED.get(name)
        if shm is None:
            shm = shared_memory.SharedMemory(name=name)
            _ATTACHED[name] = shm
        return shm


def resolve_handle(handle: Tuple[str, int, tuple, str],
                   *, writable: bool = False) -> np.ndarray:
    """Map a ``(name, offset, shape, dtype)`` handle to a numpy view of
    the shared pages (read-only unless ``writable``)."""
    name, off, shape, dtype = handle
    with _ARENAS_LOCK:
        own = _ARENAS.get(name)
    buf = own.shm.buf if own is not None else attach_segment(name).buf
    arr = np.ndarray(tuple(shape), dtype=np.dtype(dtype), buffer=buf,
                     offset=int(off))
    if not writable:
        arr.flags.writeable = False
    return arr


def detach_all() -> None:
    """Drop every worker-side attachment (called at worker exit)."""
    with _ATTACHED_LOCK:
        for shm in _ATTACHED.values():
            try:
                shm.close()
            except Exception:  # pragma: no cover
                pass
        _ATTACHED.clear()


def default_arena_bytes() -> int:
    """Default host-arena capacity: a quarter of /dev/shm (if knowable)
    clamped to [64 MiB, 1 GiB]."""
    try:
        st = os.statvfs("/dev/shm")
        quarter = st.f_frsize * st.f_blocks // 4
    except OSError:  # pragma: no cover - non-Linux
        quarter = 256 << 20
    return int(min(max(quarter, 64 << 20), 1 << 30))
