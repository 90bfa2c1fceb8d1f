"""Public FFT op: complex64 tensors, forward/inverse, along the last axis."""

from __future__ import annotations

import torch

from .._build import refuse_dtensor, refuse_grad
from .bluestein import bluestein_kernel, bluestein_plain
from .fft import BLOCK_ROWS, MAX_N, MAX_POW2, fft_kernel, fft_plain


def fft(x: torch.Tensor, forward: bool = True, *,
        block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """FFT (or, with ``forward=False``, inverse FFT) along the last axis,
    of any length N from 2 to :data:`MAX_N` (and 2**21): a power of two
    in one call of the FFT kernel, any other length by Bluestein's
    algorithm (:mod:`.bluestein`), on the card one call of the FFT
    kernel's Bluestein entry.

    A CUDA tensor goes to the hand-written kernels; a CPU tensor to their
    plain torch versions; anything else raises.  ``block_rows`` tunes the
    FFT kernel's rows per thread block (bit-identical across values).
    Never writes ``x``: the output is a fresh tensor."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"fft takes a torch.Tensor, got {type(x).__name__}")
    if x.dtype != torch.complex64:
        raise TypeError(f"fft takes complex64, got {x.dtype}")
    if x.dim() < 1:
        raise ValueError("fft needs at least one dimension")
    n = x.shape[-1]
    pow2 = n & (n - 1) == 0
    if n < 2 or (n > MAX_N and not (pow2 and n <= MAX_POW2)):
        raise ValueError(f"fft length {n} unsupported: any length from 2 "
                         f"to {MAX_N}, or {MAX_POW2}")
    if not x.is_contiguous():
        raise ValueError("fft takes a contiguous tensor")
    br = int(block_rows)
    if br < 1:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    rows = x.numel() // n
    if x.is_cuda:
        refuse_dtensor("fft", x)
        refuse_grad("fft", x)
        if pow2:  # the kernel takes x's shape as it is: no reshape
            return fft_kernel(x, inverse=not forward, block_rows=br)
        return bluestein_kernel(x.reshape(rows, n), inverse=not forward,
                                block_rows=br).reshape(x.shape)
    if x.device.type == "cpu":
        plain = fft_plain if pow2 else bluestein_plain
        return plain(x.reshape(rows, n), inverse=not forward).reshape(x.shape)
    raise ValueError(f"fft has no kernel for device {x.device}")
