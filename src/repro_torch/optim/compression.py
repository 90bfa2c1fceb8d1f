"""Gradient compression with error feedback (distributed-optimization
trick for slow cross-node links), the JAX package's
``src/repro/optim/compression.py`` on torch tensors.

int8 block-quantized gradients: each contiguous block of ``BLOCK`` values
is scaled by its absmax and rounded to int8.  The quantization residual
is carried in a per-leaf error-feedback buffer and added back the next
step, so the compression is unbiased over time (Seide et al. / EF-SGD
style): 4× less payload than bf16 on the slow edge (int8 codes + fp32
scales per block).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import map_tree

__all__ = ["CompressionState", "compress_grads", "decompress_grads",
           "ef_compress_tree", "init_compression_state"]

BLOCK = 256


@dataclasses.dataclass
class CompressionState:
    error: Any  # tree of error-feedback buffers (same shapes as grads)


def init_compression_state(params) -> CompressionState:
    return CompressionState(error=map_tree(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _pad_to(x: torch.Tensor, mult: int):
    n = x.numel()
    return F.pad(x.reshape(-1), (0, (-n) % mult)), n


def compress_grads(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g → (int8 codes (n_blocks, BLOCK), fp32 scales per block)."""
    flat, _ = _pad_to(g.float(), BLOCK)
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return codes, scale[:, 0]


def decompress_grads(codes: torch.Tensor, scales: torch.Tensor,
                     shape) -> torch.Tensor:
    flat = (codes.float() * scales[:, None]).reshape(-1)
    n = math.prod(shape)
    return flat[:n].reshape(tuple(shape))


def ef_compress_tree(grads, state: CompressionState):
    """Apply error-feedback int8 compression to every gradient leaf;
    returns (quantized-and-dequantized grads, new state).  The round trip
    models what crosses the slow link; the residual stays local."""
    def one(g, e):
        target = g.float() + e
        codes, scales = compress_grads(target)
        deq = decompress_grads(codes, scales, g.shape)
        return deq.to(g.dtype), target - deq

    pairs = map_tree(one, grads, state.error)  # leaves: (sent, residual)
    new_g = map_tree(lambda g, pr: pr[0], grads, pairs)
    new_e = map_tree(lambda g, pr: pr[1], grads, pairs)
    return new_g, CompressionState(error=new_e)
