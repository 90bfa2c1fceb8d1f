"""Chunkwise mLSTM (the xLSTM matrix-memory recurrence).

Two versions of one function over q, k, v (B, S, H, m) and the gates
i_gate, log_f (B, S, H), all float32, q unscaled (both divide it by
√m), giving h (B, S, H, m) and, when asked, the state after the last
token: C (B, H, m, m) with C[a, e] = Σ_s w_s k_s[a] v_s[e], and n
(B, H, m):

* :func:`mlstm_kernel` launches the hand-written CUDA kernel
  (``csrc/mlstm.cu``) in two passes: one block per (head, chunk)
  computes the chunk's masked, decayed scores A once and A V on the
  tensor cores, then one block per (16 columns of the m × m state C,
  head) walks the chunks in order with its columns of C in shared
  memory (:func:`launch_plan` is its geometry);
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

__all__ = ["CHUNK", "MAX_CHUNK", "MAX_M", "launch_plan", "mlstm_kernel",
           "mlstm_plain", "launches"]

CHUNK = 64
#: largest chunk the kernel takes (its c × c scores sit in eight warps'
#: registers, 16 rows a warp)
MAX_CHUNK = 128
#: largest head width the kernel takes (the second pass keeps m × 16 of
#: C in shared memory beside a step's slices: 192 KB of the 227 KB at
#: 1024 with chunk 128)
MAX_M = 1024
#: the kernel's tiles (``csrc/mlstm.cu``): threads a block, depth slice,
#: columns of C a block of the second pass, shared-memory row strides
THREADS, SLICE, COLS = 256, 32, 16
QS, KS, VS = SLICE + 8, SLICE + 4, COLS + 4

#: kernel launches since the count was last set to 0
launches = 0
_count_lock = threading.Lock()


def launch_plan(batch: int, s: int, h: int, m: int, chunk: int) -> dict:
    """The kernel's geometry for one call: the chunk padded to a
    multiple of 16 (``cp``), each pass's grid and shared memory, the
    second pass's steps a chunk (slices of m, at least two) and the
    workspace's float32 elements (A V in q's layout, then exp(cum), w,
    den and decay per head and chunk)."""
    cp = -(-chunk // 16) * 16
    nc = s // chunk
    nm = -(-m // SLICE)
    mp = nm * SLICE
    return {
        "cp": cp, "chunks": nc, "m_slices": nm, "steps": max(nm, 2),
        "intra_grid": (nc, batch * h),
        "intra_smem": 4 * (4 * cp * QS + cp * (cp + 8) + 2 * MAX_CHUNK),
        "inter_grid": (-(-m // COLS), batch * h),
        "inter_smem": 4 * (COLS * (mp + 8) + mp + 2 * cp * QS + 3 * cp * KS
                           + 2 * cp * VS + 2 * 4 * MAX_CHUNK + 2 * MAX_CHUNK),
        "work": batch * s * h * m + batch * h * nc * (3 * chunk + 1),
    }


def mlstm_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 i_gate: torch.Tensor, log_f: torch.Tensor, *,
                 chunk: int = CHUNK, return_state: bool = False):
    """Contiguous float32 tensors on one CUDA device, ``chunk`` dividing
    S → h (B, S, H, m) in a fresh tensor, or with ``return_state`` (h,
    C, n), the second pass writing the state it holds (h is the same
    bits either way).  The caller has validated them; this launches both
    passes on the current stream (one call, one count) and does not
    wait."""
    global launches
    batch, s, h, m = q.shape
    out = torch.empty_like(q)
    c_state = n_state = None
    if return_state:
        # zeros: the state of an empty sequence, which no launch writes
        make = torch.zeros if s == 0 else torch.empty
        c_state = make((batch, h, m, m), dtype=torch.float32,
                       device=q.device)
        n_state = make((batch, h, m), dtype=torch.float32, device=q.device)
    if batch and s:
        work = torch.empty(launch_plan(batch, s, h, m, chunk)["work"],
                           dtype=torch.float32, device=q.device)
        check(launch(library().rimms_mlstm_f32, q, q.data_ptr(),
                     k.data_ptr(), v.data_ptr(), i_gate.data_ptr(),
                     log_f.data_ptr(), out.data_ptr(),
                     c_state.data_ptr() if return_state else None,
                     n_state.data_ptr() if return_state else None,
                     work.data_ptr(), batch, s, h, m, int(chunk),
                     ctypes.c_float(1.0 / math.sqrt(m))), "mlstm")
        with _count_lock:
            launches += 1
    return (out, c_state, n_state) if return_state else out


def mlstm_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i_gate: torch.Tensor, log_f: torch.Tensor, *,
                chunk: int = CHUNK, return_state: bool = False):
    """The kernel's chunkwise recurrence in torch ops.  Same shapes and
    results."""
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
    hs = hs.reshape(batch, h, s, m).transpose(1, 2).contiguous()
    if not return_state:
        return hs
    return (hs, c_state.reshape(batch, h, m, m),
            n_state.reshape(batch, h, m))
