"""Oracle: the per-token mLSTM recurrence in float64 (used by the tests
and ``chip_smoke.py`` only — never on the runtime's path)."""

import torch


def mlstm_sequential(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     i_gate: torch.Tensor, log_f: torch.Tensor) -> torch.Tensor:
    """q, k, v: (BH, S, m) with q pre-scaled; gates (BH, S).
    h_t = (q_t C_t) / max(|q_t·n_t|, 1);
    C_t = f_t C_{t-1} + i_t k_t v_tᵀ;  n_t = f_t n_{t-1} + i_t k_t."""
    q, k, v = q.double(), k.double(), v.double()
    ii, f = i_gate.double(), torch.exp(log_f.double())
    bh, s, m = q.shape
    c_state = torch.zeros((bh, m, m), dtype=torch.float64, device=q.device)
    n_state = torch.zeros((bh, m), dtype=torch.float64, device=q.device)
    hs = []
    for t in range(s):
        ft, it = f[:, t, None], ii[:, t, None]
        c_state = (ft[..., None] * c_state
                   + it[..., None] * k[:, t, :, None] * v[:, t, None, :])
        n_state = ft * n_state + it * k[:, t]
        den = (q[:, t] * n_state).sum(-1, keepdim=True).abs().clamp_min(1.0)
        hs.append((q[:, t, None, :] @ c_state)[:, 0] / den)
    return torch.stack(hs, dim=1).float()
