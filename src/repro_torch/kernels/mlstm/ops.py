"""Public mLSTM op: (B, S, H, m) layout, q unscaled."""

from __future__ import annotations

import torch

from .mlstm import (CHUNK, MAX_CHUNK, MAX_M, mlstm_backward_kernel,
                    mlstm_backward_plain, mlstm_kernel, mlstm_plain)


class _MLSTM(torch.autograd.Function):
    """The chunkwise mLSTM with its backward by device: a CUDA tensor's
    forward and backward launch the kernels, a CPU tensor's run the plain
    versions.  Under grad (``save``: the caller's grad mode on and an
    input requiring grad) the forward also keeps each chunk's entering
    state and den (33.5 MB at (1, 1024, 4, 512) with chunk 128) beside
    its inputs and h."""

    @staticmethod
    def forward(ctx, q, k, v, i_gate, log_f, chunk, return_state, save):
        fwd = mlstm_kernel if q.is_cuda else mlstm_plain
        out = fwd(q, k, v, i_gate, log_f, chunk=chunk,
                  return_state=return_state, save=save)
        out = out if isinstance(out, tuple) else (out,)
        if save:
            ctx.save_for_backward(q, k, v, i_gate, log_f, out[0], *out[-3:])
            out = out[:-3]
        ctx.chunk = chunk
        return out if return_state else out[0]

    @staticmethod
    def backward(ctx, dh, dc=None, dn=None):
        q, k, v, i_gate, log_f, h, c_in, n_in, den = ctx.saved_tensors
        dh = (torch.zeros_like(h) if dh is None
              else dh.to(torch.float32).contiguous())
        dc, dn = (None if x is None else x.to(torch.float32).contiguous()
                  for x in (dc, dn))
        bwd = mlstm_backward_kernel if q.is_cuda else mlstm_backward_plain
        grads = bwd(q, k, v, i_gate, log_f, h, c_in, n_in, den, dh, dc, dn,
                    chunk=ctx.chunk)
        return (*grads, None, None, None)


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_gate: torch.Tensor, log_f: torch.Tensor, *,
                    chunk: int = CHUNK, return_state: bool = False):
    """q, k, v: (B, S, H, m), q unscaled; i_gate, log_f: (B, S, H); all
    float32.  Returns h (B, S, H, m), or with ``return_state`` (h, C, n):
    the state after the last token, C (B, H, m, m) in the reference's
    orientation C[a, e] = Σ w k_a v_e and n (B, H, m), float32.  h is
    the same with and without the state.

    CUDA tensors go to the hand-written kernel; CPU tensors to the plain
    torch version; anything else raises.  Both are differentiable
    through an autograd ``Function`` whose backward goes the same way:
    the backward kernel, or its plain version on the CPU (the gradient
    of the final state seeds it).  ``chunk`` is clamped to S, as
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
    if q.is_cuda or q.device.type == "cpu":
        save = torch.is_grad_enabled() and any(t.requires_grad
                                               for _, t in named)
        return _MLSTM.apply(q, k, v, i_gate, log_f, c, bool(return_state),
                            save)
    raise ValueError(f"mlstm_chunkwise has no kernel for device {q.device}")
