"""Oracle: paged decode attention via dense gather (torch ops).  It is
also the kernel's plain version (``paged_attention_plain``): what a CPU
tensor runs, and what the kernel is held against on the card."""

import math

import torch


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Same signature as the kernel; gathers pages densely."""
    B, hq, d = q.shape
    P, page, n_kv, _ = k_pages.shape
    group = hq // n_kv
    n_pages = block_table.shape[1]
    bt = block_table.long()
    k = k_pages[bt].reshape(B, n_pages * page, n_kv, d)
    v = v_pages[bt].reshape(B, n_pages * page, n_kv, d)
    qg = q.reshape(B, n_kv, group, d).float()
    s = torch.einsum("bhgd,bthd->bhgt", qg, k.float())
    s = s / math.sqrt(d)
    t = torch.arange(n_pages * page, device=q.device)
    mask = t[None] < lengths.to(q.device)[:, None]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgt,bthd->bhgd", p, v.float())
    return o.reshape(B, hq, d).to(q.dtype)
