"""Online-softmax ("flash") attention, causal or not, with grouped K/V.

Two versions of one function over q (B, S, Hq, d) and k, v
(B, S, Hkv, d), float32 or bfloat16, accumulating in float32:

* :func:`flash_attention_kernel` launches the hand-written CUDA kernel
  (``csrc/flash_attention.cu``): the query rows in 64-row sub-tiles,
  each warp of a 4-warp block owning 16 rows, one block per (batch·head,
  ``block_q`` rows: ``ceil(block_q / 64)`` sub-tiles dealt in snake
  order, so causal blocks carry equal work); K/V chunks of at most 64
  keys come by ``cp.async`` into a 2-stage shared-memory ring, the kv
  head read as ``h // (Hq // Hkv)`` in place.  bf16 runs Q·Kᵀ and P·V
  on the tensor cores (``wgmma``, the 64-row sub-tile a warpgroup's
  tile, f32 accumulation); float32 runs them as float32 FMAs on the
  CUDA cores (TF32 would miss the 2e-4 tolerance).  Scores never leave
  registers.  A head width d runs at the compiled width of
  :data:`HEAD_DIMS` next above it, the tiles' columns past d filled with
  zeros as they are loaded and only d columns stored (no padded copy);
  the float32 path takes chunks of 32 keys above width 128.  One block
  per (batch·head, ``block_q`` rows) in the grid's x dimension, so B·Hq
  has no limit of its own;
* :func:`flash_attention_plain` is the same online softmax in torch ops
  over the same key tiles of ``block_k`` columns, all query rows at once
  — what a CPU tensor runs, and what the kernel is held against on the
  card.

Both keep the reference's ``NEG_INF = -1e30`` mask value and its
``max(l, 1e-30)`` floor, and neither depends on ``block_q`` for its
result: it only moves rows between thread blocks.  ``block_k`` is the
plain version's online-softmax tile; in the kernel it sets where the
key chunks break: each tile of ``block_k`` keys is cut into chunks of
64 from its start (the last one narrower), and the online-softmax step
runs once per chunk.  So the kernel and the plain version agree to
rounding (a max over 64 keys in place of ``block_k``), and ``block_k``
64 gives both the same tiles.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from .._build import check, launch, library

__all__ = ["BLOCK_Q", "BLOCK_K", "MAX_BLOCK_K", "HEAD_DIMS", "MAX_HEAD_DIM",
           "padded_width", "NEG_INF",
           "flash_attention_kernel", "flash_attention_plain", "launches"]

BLOCK_Q = 256
BLOCK_K = 256
#: widest key tile the kernel holds scores for in shared memory
MAX_BLOCK_K = 512
#: widths the kernel is built for: a head width d from 1 to
#: :data:`MAX_HEAD_DIM` runs at the first of them >= d
HEAD_DIMS = (64, 128, 192, 256)
MAX_HEAD_DIM = HEAD_DIMS[-1]
NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}



def padded_width(d: int) -> int:
    """The compiled width a head width ``d`` runs at (``csrc/
    flash_attention.cu`` ``rimms_flash_attention``)."""
    return next(w for w in HEAD_DIMS if w >= d)


#: kernel launches since the count was last set to 0
launches = 0
_count_lock = threading.Lock()


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, block_q: int = BLOCK_Q,
                           block_k: int = BLOCK_K) -> torch.Tensor:
    """q: (B, S, Hq, d), k, v: (B, S, Hkv, d), contiguous, one dtype, on
    one CUDA device → attention output (B, S, Hq, d) in q's dtype, in a
    fresh tensor.  ``block_q``/``block_k`` are already clamped to S.  The
    caller has validated them; this launches on the current stream and
    does not wait."""
    global launches
    batch, s, hq, d = q.shape
    out = torch.empty_like(q)
    if batch == 0 or s == 0:
        return out
    # the kernel copies 16-byte pieces: a view at an odd offset is copied
    # to fresh (aligned) storage first
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    check(launch(library().rimms_flash_attention, q, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), batch, s, hq,
                 k.shape[2], d, _DTYPE_CODE[q.dtype], int(causal),
                 int(block_q), int(block_k),
                 ctypes.c_float(1.0 / math.sqrt(d))), "flash_attention")
    with _count_lock:
        launches += 1
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          block_k: int = BLOCK_K) -> torch.Tensor:
    """The kernel's online softmax in torch ops, over key tiles of
    ``block_k`` columns (the last one narrower when it does not divide
    S), every query row at once.  Same shapes as the kernel."""
    batch, s, hq, d = q.shape
    group = hq // k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf = q.float().transpose(1, 2)                               # (B,Hq,S,d)
    kf = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    m = torch.full((batch, hq, s, 1), NEG_INF, device=q.device)
    l = torch.zeros((batch, hq, s, 1), device=q.device)
    acc = torch.zeros((batch, hq, s, d), device=q.device)
    qpos = torch.arange(s, device=q.device)[:, None]
    for k0 in range(0, s, block_k):
        k1 = min(k0 + block_k, s)
        sc = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
        if causal:
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            sc = sc.masked_fill(kpos > qpos, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vf[:, :, k0:k1]
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.to(q.dtype).transpose(1, 2).contiguous()
