"""Public ZIP op: pointwise complex multiply of complex64 tensors."""

from __future__ import annotations

import torch

from .._build import refuse_dtensor, refuse_grad
from .zip import BLOCK_ROWS, zip_kernel, zip_plain


def zip_mul(a: torch.Tensor, b: torch.Tensor, *,
            block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """Pointwise complex multiply.  CUDA tensors go to the hand-written
    kernel; CPU tensors to the plain torch version; anything else
    raises.  ``block_rows`` tunes the kernel's elements per thread block
    (bit-identical across values).  Never writes its inputs."""
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"zip_mul takes torch.Tensors, {name} is "
                            f"{type(t).__name__}")
        if t.dtype != torch.complex64:
            raise TypeError(f"zip_mul takes complex64, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"zip_mul takes contiguous tensors ({name})")
    if a.shape != b.shape:
        raise ValueError(f"zip_mul shapes differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    br = int(block_rows)
    if br < 1:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    if a.is_cuda and b.is_cuda and a.get_device() == b.get_device():
        refuse_dtensor("zip_mul", a, b)
        refuse_grad("zip_mul", a, b)
        return zip_kernel(a, b, block_rows=br)
    if a.device != b.device:
        raise ValueError(f"zip_mul devices differ: {a.device} vs {b.device}")
    if a.device.type == "cpu":
        return zip_plain(a, b)
    raise ValueError(f"zip_mul has no kernel for device {a.device}")
