"""Oracle: pointwise complex multiply."""

import torch


def zip_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: complex64 tensors of identical shape."""
    return a * b
