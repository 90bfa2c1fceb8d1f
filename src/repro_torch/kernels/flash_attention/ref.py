"""Oracle: dense attention in float32 (used by the tests and
``chip_smoke.py`` only — never on the runtime's path)."""

import math

import torch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """q, k, v: (BH, S, d) → (BH, S, d) in q's dtype."""
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        n = q.shape[1]
        mask = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                     device=q.device))
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return (p @ v.float()).to(q.dtype)
