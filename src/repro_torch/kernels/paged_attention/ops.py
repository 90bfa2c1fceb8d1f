"""Public paged-attention op (the kernel signature is already the
serving-engine-facing one): checks, then device dispatch."""

from __future__ import annotations

import torch

from .paged_attention import (MAX_GROUP_ELEMS, MAX_HEAD_DIM,
                              paged_attention_kernel, paged_attention_plain)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, d); k_pages, v_pages: (P, page, Hkv, d) with
    Hq % Hkv == 0, all float32 or all bfloat16, d a multiple of 8 and at
    most 256, (Hq / Hkv) * d at most 4096; block_table: (B, n_pages)
    int32 page ids in [0, P); lengths: (B,) int32.  Returns (B, Hq, d) in
    q's dtype.

    CUDA tensors go to the hand-written kernel; CPU tensors to the plain
    version (the oracle's dense gather); anything else raises."""
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("lengths", lengths)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"paged_attention takes torch.Tensors, {name} "
                            f"is {type(t).__name__}")
        if t.device != q.device:
            raise ValueError(f"paged_attention devices differ: {name} on "
                             f"{t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention takes contiguous tensors "
                             f"({name})")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_attention takes float32 or bfloat16, q is "
                        f"{q.dtype}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != q.dtype:
            raise TypeError(f"paged_attention dtypes differ: {name} is "
                            f"{t.dtype}, q is {q.dtype}")
    for name, t in (("block_table", block_table), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise TypeError(f"paged_attention takes an int32 {name}, got "
                            f"{t.dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or block_table.dim() != 2:
        raise ValueError(f"paged_attention takes q (B, Hq, d), pages "
                         f"(P, page, Hkv, d) and a (B, n_pages) table; got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(block_table.shape)}")
    batch, hq, d = q.shape
    hkv = k_pages.shape[2]
    if (v_pages.shape != k_pages.shape or k_pages.shape[3] != d
            or block_table.shape[0] != batch
            or tuple(lengths.shape) != (batch,)):
        raise ValueError(f"paged_attention shapes disagree: q "
                         f"{tuple(q.shape)}, k_pages {tuple(k_pages.shape)}, "
                         f"v_pages {tuple(v_pages.shape)}, block_table "
                         f"{tuple(block_table.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"paged_attention needs Hq ({hq}) a multiple of "
                         f"Hkv ({hkv})")
    if (d % 8 or d > MAX_HEAD_DIM
            or (hq // hkv) * d > MAX_GROUP_ELEMS):
        raise ValueError(f"paged_attention head width {d} with {hq // hkv} "
                         f"queries per KV head unsupported: d a multiple of "
                         f"8 and at most {MAX_HEAD_DIM}, (Hq / Hkv) * d at "
                         f"most {MAX_GROUP_ELEMS}")
    if k_pages.shape[0] < 1 or k_pages.shape[1] < 1:
        raise ValueError(f"paged_attention needs a non-empty pool, got "
                         f"{tuple(k_pages.shape)}")
    if q.is_cuda:
        if (k_pages.data_ptr() | v_pages.data_ptr()) % 16:
            raise ValueError("paged_attention reads the pages as 16-byte "
                             "vectors: their data must be 16-byte aligned")
        return paged_attention_kernel(q, k_pages, v_pages, block_table,
                                      lengths)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_table,
                                     lengths)
    raise ValueError(f"paged_attention has no kernel for device {q.device}")
