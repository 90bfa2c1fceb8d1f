"""ZIP: pointwise complex multiply (the paper's ZIP accelerator, §4.1).

Two versions of one function over complex64 tensors of one shape:

* :func:`zip_kernel` launches the hand-written CUDA kernel
  (``csrc/zip.cu``): a grid-stride loop over interleaved complex64, two
  elements a thread with 16-byte loads and stores, views at any element
  handled inside the kernel, no padding;
* :func:`zip_plain` writes the product out in re/im form in torch ops —
  what a CPU tensor runs, and what the kernel is held against on the
  card.
"""

from __future__ import annotations

import threading

import torch

from .._build import check, launch, library

__all__ = ["BLOCK_ROWS", "zip_kernel", "zip_plain", "launches"]

#: elements a thread block covers per step of its loop, at least 512 (a
#: pure launch parameter: the op is elementwise, so every value gives
#: bit-identical output)
BLOCK_ROWS = 256

#: kernel launches since the count was last set to 0
launches = 0
_count_lock = threading.Lock()


def zip_kernel(a: torch.Tensor, b: torch.Tensor, *,
               block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """a, b: contiguous complex64 CUDA tensors of one shape → a * b in
    a fresh tensor.  The caller has validated them; this launches on
    the current stream and does not wait."""
    global launches
    out = torch.empty_like(a)
    n = a.numel()
    if n == 0:
        return out
    check(launch(library().rimms_zip_c64, a, a.data_ptr(), b.data_ptr(),
                 out.data_ptr(), n, block_rows), "zip")
    with _count_lock:
        launches += 1
    return out


def zip_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in torch ops:
    (ar*br - ai*bi) + i (ar*bi + ai*br)."""
    ar, ai = a.real, a.imag
    br, bi = b.real, b.imag
    return torch.complex(ar * br - ai * bi, ar * bi + ai * br)
