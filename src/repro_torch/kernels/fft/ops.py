"""Public FFT op: complex64 tensors, forward/inverse, along the last axis."""

from __future__ import annotations

import torch

from .fft import BLOCK_ROWS, MAX_N, fft_kernel, fft_plain


def fft(x: torch.Tensor, forward: bool = True, *,
        block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """FFT (or, with ``forward=False``, inverse FFT) along the last axis.

    A CUDA tensor goes to the hand-written kernel; a CPU tensor to the
    plain torch version; anything else raises.  ``block_rows`` tunes the
    kernel's rows per thread block (bit-identical across values).
    Never writes ``x``: the output is a fresh tensor."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"fft takes a torch.Tensor, got {type(x).__name__}")
    if x.dtype != torch.complex64:
        raise TypeError(f"fft takes complex64, got {x.dtype}")
    if x.dim() < 1:
        raise ValueError("fft needs at least one dimension")
    n = x.shape[-1]
    if n < 2 or n > MAX_N or n & (n - 1):
        raise ValueError(
            f"fft length {n} unsupported: a power of two from 2 to {MAX_N}")
    if not x.is_contiguous():
        raise ValueError("fft takes a contiguous tensor")
    if int(block_rows) < 1:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    rows = x.numel() // n
    xf = x.reshape(rows, n)
    if x.is_cuda:
        out = fft_kernel(xf, inverse=not forward, block_rows=int(block_rows))
    elif x.device.type == "cpu":
        out = fft_plain(xf, inverse=not forward)
    else:
        raise ValueError(f"fft has no kernel for device {x.device}")
    return out.reshape(x.shape)
