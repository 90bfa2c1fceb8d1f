"""Public FFT op: complex64 tensors, forward/inverse, along the last axis."""

from __future__ import annotations

import torch

from .._build import refuse_dtensor, refuse_grad
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
    br = int(block_rows)
    if br < 1:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    if x.is_cuda:  # the kernel takes x's shape as it is: no reshape
        refuse_dtensor("fft", x)
        refuse_grad("fft", x)
        return fft_kernel(x, inverse=not forward, block_rows=br)
    if x.device.type == "cpu":
        out = fft_plain(x.reshape(x.numel() // n, n), inverse=not forward)
        return out.reshape(x.shape)
    raise ValueError(f"fft has no kernel for device {x.device}")
