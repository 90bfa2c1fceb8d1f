"""Public mLSTM op: (B, S, H, m) layout, q unscaled."""

from __future__ import annotations

import torch

from .._build import refuse_grad
from .mlstm import CHUNK, MAX_CHUNK, MAX_M, mlstm_kernel, mlstm_plain


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_gate: torch.Tensor, log_f: torch.Tensor, *,
                    chunk: int = CHUNK, return_state: bool = False):
    """q, k, v: (B, S, H, m), q unscaled; i_gate, log_f: (B, S, H); all
    float32.  Returns h (B, S, H, m), or with ``return_state`` (h, C, n):
    the state after the last token, C (B, H, m, m) in the reference's
    orientation C[a, e] = Σ w k_a v_e and n (B, H, m), float32.  h is
    the same with and without the state.

    CUDA tensors go to the hand-written kernel; CPU tensors to the plain
    torch version; anything else raises.  ``chunk`` is clamped to S, as
    the reference clamps it, must then divide S and be at most 128, and
    m is at most 1024.  Different chunks agree only to rounding."""
    named = (("q", q), ("k", k), ("v", v), ("i_gate", i_gate),
             ("log_f", log_f))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"mlstm_chunkwise takes torch.Tensors, {name} "
                            f"is {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"mlstm_chunkwise takes float32, {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"mlstm_chunkwise takes contiguous tensors "
                             f"({name})")
        if t.device != q.device:
            raise ValueError(f"mlstm_chunkwise devices differ: {name} on "
                             f"{t.device}, q on {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mlstm_chunkwise needs q, k, v of one (B, S, H, m) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    batch, s, h, m = q.shape
    for name, t in named[3:]:
        if tuple(t.shape) != (batch, s, h):
            raise ValueError(f"mlstm_chunkwise needs {name} of shape "
                             f"{(batch, s, h)}, got {tuple(t.shape)}")
    if int(chunk) < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    c = min(int(chunk), max(s, 1))
    if s % c:
        raise ValueError(f"chunk {c} does not divide the sequence length {s}")
    if c > MAX_CHUNK:
        raise ValueError(f"chunk {c} is larger than {MAX_CHUNK}")
    if m > MAX_M:
        raise ValueError(f"head width {m} is larger than {MAX_M}")
    if q.is_cuda:
        refuse_grad("mlstm_chunkwise", q, k, v, i_gate, log_f)
        return mlstm_kernel(q, k, v, i_gate, log_f, chunk=c,
                            return_state=return_state)
    if q.device.type == "cpu":
        return mlstm_plain(q, k, v, i_gate, log_f, chunk=c,
                           return_state=return_state)
    raise ValueError(f"mlstm_chunkwise has no kernel for device {q.device}")
