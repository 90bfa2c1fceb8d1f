"""Oracle: the RG-LRU recurrence as a sequential scan in float64 (used by
the tests and ``chip_smoke.py`` only — never on the runtime's path)."""

import torch


def rg_lru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """a, b: (B, S, D); h0: (B, D) → (h_seq, h_final) in a's dtype."""
    h = h0.double()
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t].double() * h + b[:, t].double()
        hs.append(h)
    seq = torch.stack(hs, dim=1) if hs else a.double()
    return seq.to(a.dtype), h.to(a.dtype)
