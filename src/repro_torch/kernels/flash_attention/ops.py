"""Public flash-attention op: (B, S, H, d) layout with grouped K/V heads."""

from __future__ import annotations

import torch

from .._build import refuse_dtensor, refuse_grad
from .flash_attention import (BLOCK_K, BLOCK_Q, MAX_BLOCK_K, MAX_HEAD_DIM,
                              flash_attention_kernel, flash_attention_plain)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = BLOCK_Q,
                    block_k: int = BLOCK_K) -> torch.Tensor:
    """q: (B, S, Hq, d); k, v: (B, S, Hkv, d) with Hq % Hkv == 0, all
    float32 or all bfloat16, d from 1 to 256.  Returns (B, S, Hq, d) in
    q's dtype.

    CUDA tensors go to the hand-written kernel; CPU tensors to the plain
    torch version; anything else raises.  ``block_q`` and ``block_k``
    are clamped to S, as the reference clamps them; ``block_q`` tunes
    query rows per thread block (bit-identical across values), and
    ``block_k`` is the online softmax's key tile (at most 512 after the
    clamp): the plain version's tile, and in the kernel the tile that
    its chunks of at most 64 keys never cross.  K/V are never repeated
    in device memory for GQA."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"flash_attention takes torch.Tensors, {name} "
                            f"is {type(t).__name__}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flash_attention takes float32 or bfloat16, "
                            f"{name} is {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention dtypes differ: {name} is "
                            f"{t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention takes contiguous tensors "
                             f"({name})")
        if t.device != q.device:
            raise ValueError(f"flash_attention devices differ: {name} on "
                             f"{t.device}, q on {q.device}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention takes (B, S, H, d) tensors, "
                             f"{name} has shape {tuple(t.shape)}")
    batch, s, hq, d = q.shape
    hkv = k.shape[2]
    if v.shape != k.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != d:
        raise ValueError(f"flash_attention shapes disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention needs Hq ({hq}) a multiple of "
                         f"Hkv ({hkv})")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention head width {d} unsupported: "
                         f"1 to {MAX_HEAD_DIM}")
    if int(block_q) < 1 or int(block_k) < 1:
        raise ValueError(f"block_q and block_k must be positive, got "
                         f"{block_q}, {block_k}")
    bq, bk = min(int(block_q), max(s, 1)), min(int(block_k), max(s, 1))
    if bk > MAX_BLOCK_K:
        raise ValueError(f"block_k {bk} is wider than {MAX_BLOCK_K}")
    if q.is_cuda:
        refuse_dtensor("flash_attention", q, k, v)
        refuse_grad("flash_attention", q, k, v)
        return flash_attention_kernel(q, k, v, causal=causal, block_q=bq,
                                      block_k=bk)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, block_k=bk)
    raise ValueError(f"flash_attention has no kernel for device {q.device}")
