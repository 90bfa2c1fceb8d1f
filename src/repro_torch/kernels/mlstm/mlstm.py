"""Chunkwise mLSTM (the xLSTM matrix-memory recurrence).

Two versions of one function over q, k, v (B, S, H, m) and the gates
i_gate, log_f (B, S, H), all float32, q unscaled (both divide it by
√m):

* :func:`mlstm_kernel` launches the hand-written CUDA kernel
  (``csrc/mlstm.cu``): per head, blocks own 16 columns of the m × m
  state C each and carry them, chunk by chunk in order, in shared
  memory within one launch;
* :func:`mlstm_plain` is the same chunkwise algorithm in torch ops, one
  chunk at a time over every head — what a CPU tensor runs, and what the
  kernel is held against on the card.

The chunk size changes the order of accumulation, so two chunk sizes
agree only to rounding (the reference says the same).
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from .._build import check, launch, library

__all__ = ["CHUNK", "MAX_CHUNK", "MAX_M", "mlstm_kernel", "mlstm_plain",
           "launches"]

CHUNK = 64
#: largest chunk the kernel takes (its c × c scores sit in shared memory)
MAX_CHUNK = 128
#: largest head width the kernel takes (16 columns of C, the normalizer
#: and a chunk's buffers fill the 227 KB of shared memory at 1024)
MAX_M = 1024

#: kernel launches since the count was last set to 0
launches = 0
_count_lock = threading.Lock()


def mlstm_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 i_gate: torch.Tensor, log_f: torch.Tensor, *,
                 chunk: int = CHUNK) -> torch.Tensor:
    """Contiguous float32 tensors on one CUDA device, ``chunk`` dividing
    S → h (B, S, H, m) in a fresh tensor.  The caller has validated
    them; this launches on the current stream and does not wait."""
    global launches
    batch, s, h, m = q.shape
    out = torch.empty_like(q)
    if batch == 0 or s == 0:
        return out
    check(launch(library().rimms_mlstm_f32, q, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), i_gate.data_ptr(), log_f.data_ptr(),
                 out.data_ptr(), batch, s, h, m, int(chunk),
                 ctypes.c_float(math.sqrt(m))), "mlstm")
    with _count_lock:
        launches += 1
    return out


def mlstm_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i_gate: torch.Tensor, log_f: torch.Tensor, *,
                chunk: int = CHUNK) -> torch.Tensor:
    """The kernel's chunkwise recurrence in torch ops.  Same shapes."""
    batch, s, h, m = q.shape
    bh = batch * h

    def heads(x):  # (B, S, H, m) -> (BH, S, m)
        return x.transpose(1, 2).reshape(bh, s, m)

    qh, kh, vh = heads(q / math.sqrt(m)), heads(k), heads(v)
    ih = i_gate.transpose(1, 2).reshape(bh, s)
    fh = log_f.transpose(1, 2).reshape(bh, s)
    c_state = torch.zeros((bh, m, m), device=q.device)
    n_state = torch.zeros((bh, m, 1), device=q.device)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    outs = []
    for t0 in range(0, s, chunk):
        sl = slice(t0, t0 + chunk)
        qc, kc, vc, ic = qh[:, sl], kh[:, sl], vh[:, sl], ih[:, sl]
        cum = torch.cumsum(fh[:, sl], dim=-1)                    # (BH, c)
        scores = qc @ kc.transpose(-1, -2)
        dlt = cum[:, :, None] - cum[:, None, :]
        a = torch.where(mask, scores * torch.exp(dlt) * ic[:, None, :],
                        torch.zeros((), device=q.device))
        ecum = torch.exp(cum)[..., None]
        num = a @ vc + ecum * (qc @ c_state)
        den = a.sum(dim=-1, keepdim=True) + ecum * (qc @ n_state)
        outs.append(num / den.abs().clamp_min(1.0))
        kw = kc * (torch.exp(cum[:, -1:] - cum) * ic)[..., None]
        decay = torch.exp(cum[:, -1])[:, None, None]
        c_state = decay * c_state + kw.transpose(-1, -2) @ vc
        n_state = decay * n_state + kw.sum(dim=1)[..., None]
    hs = torch.cat(outs, dim=1) if outs else qh
    return hs.reshape(batch, h, s, m).transpose(1, 2).contiguous()
