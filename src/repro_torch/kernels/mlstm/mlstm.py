"""Chunkwise mLSTM (the xLSTM matrix-memory recurrence).

Two versions of one function over q, k, v (B, S, H, m) and the gates
i_gate, log_f (B, S, H), all float32, q unscaled (both divide it by
√m), giving h (B, S, H, m) and, when asked, the state after the last
token: C (B, H, m, m) with C[a, e] = Σ_s w_s k_s[a] v_s[e], and n
(B, H, m):

* :func:`mlstm_kernel` launches the hand-written CUDA kernel
  (``csrc/mlstm.cu``) in two passes: one block per (head, chunk)
  computes the chunk's masked, decayed scores A once and A V on the
  tensor cores (a chunk above 128 in blocks of 128 query rows, each
  against its keys to the diagonal, one key block of 128 at a time),
  then one block per (16 columns of the m × m state C,
  head) walks the chunks in order with its columns of C in shared
  memory (:func:`launch_plan` is its geometry);
* :func:`mlstm_plain` is the same chunkwise algorithm in torch ops, one
  chunk at a time over every head — what a CPU tensor runs, and what the
  kernel is held against on the card.

The chunk size changes the order of accumulation, so two chunk sizes
agree only to rounding (the reference says the same).

The backward has the same two versions: :func:`mlstm_backward_kernel`
launches ``csrc/mlstm_bwd.cu`` (a walk over the chunks from the last,
in parallel over 64 x 64 tiles of the state, carries the state's
gradient with each chunk's own update; then parallel passes per (head,
chunk) on the tensor cores; :func:`backward_plan` is its geometry), and
:func:`mlstm_backward_plain` is its algorithm in torch ops, held against
autograd of :func:`mlstm_plain`.  Both read what the forward saves under
grad (``save``): each chunk's entering state and den.  At a tie |den| =
1 both take JAX's gradient of the reference's ``maximum(|den|, 1)``
(half of it reaches den), where autograd of :func:`mlstm_plain`'s
``clamp_min`` passes all of it.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from .._build import check, launch, library

__all__ = ["CHUNK", "MAX_CHUNK", "ROW_BLOCK", "MAX_M", "launch_plan",
           "backward_plan",
           "backward_work",
           "mlstm_kernel", "mlstm_plain", "mlstm_backward_kernel",
           "mlstm_backward_plain", "launches", "backward_launches"]

CHUNK = 64
#: largest chunk the kernel takes (the reference's ``rec_chunk`` of 256):
#: the intra pass takes a chunk's rows in blocks of :data:`ROW_BLOCK`
MAX_CHUNK = 256
#: query rows of an intra block (eight warps of 16), and keys of a key
#: block (a warp's 16 tiles of 8 in registers)
ROW_BLOCK = 128
#: largest head width the kernel takes (the second pass keeps m × 16 of
#: C in shared memory beside a step's slices: 192 KB of the 227 KB at
#: 1024 with chunk 128)
MAX_M = 1024
#: the kernel's tiles (``csrc/mlstm.cu``): threads a block, depth slice,
#: columns of C a block of the second pass, shared-memory row strides
THREADS, SLICE, COLS = 256, 32, 16
QS, KS, VS = SLICE + 8, SLICE + 4, COLS + 4
#: the backward kernel's tiles (``csrc/mlstm_bwd.cu``): columns of m a
#: grads block owns (and the side of a state tile and of a scores tile),
#: the grads and scores rings' depth slice, the state ring's token slice,
#: the row strides of row-read and of column-read tiles, one B slot of
#: the grads ring, the state and scores rings' stages
BWD_COLS, BWD_DEPTH, BWD_TOK = 64, 16, 32
LDA, LDK = BWD_DEPTH + 8, BWD_COLS + 4
BSLOT = max(BWD_COLS * LDA, BWD_DEPTH * LDK)
STATE_STAGES = SCORE_STAGES = 3

#: kernel launches since the count was last set to 0
launches = 0
#: backward kernel launches (five kernels each) since the count was last
#: set to 0
backward_launches = 0
_count_lock = threading.Lock()


def launch_plan(batch: int, s: int, h: int, m: int, chunk: int) -> dict:
    """The kernel's geometry for one call: the chunk padded to a
    multiple of 16 (``cp``); the instance (chunks of 128 or less, or up
    to 256: ``max_chunk``, the second pass's depth ``slice``, 32 or 16,
    and the row tiles each of its warps 4-7 owns); the first pass's row
    blocks of :data:`ROW_BLOCK`; each pass's grid and shared memory, the
    second pass's steps a chunk (slices of m, at least two) and the
    workspace's float32 elements (A V in q's layout, then exp(cum), w,
    den and decay per head and chunk)."""
    cp = -(-chunk // 16) * 16
    nc = s // chunk
    big = cp > 128
    maxc, sl = (MAX_CHUNK, SLICE // 2) if big else (128, SLICE)
    nm = -(-m // sl)
    mp = nm * sl
    rcap, nrb = min(cp, ROW_BLOCK), -(-cp // ROW_BLOCK)
    vec_pad = 3 * maxc + 4
    return {
        "cp": cp, "chunks": nc, "m_slices": nm, "steps": max(nm, 2),
        "max_chunk": maxc, "slice": sl, "row_tiles_per_warp": maxc // 64,
        "row_blocks": nrb,
        "intra_grid": (nc * nrb, batch * h),
        "intra_smem": 4 * (4 * rcap * QS + rcap * (cp + 8) + 2 * maxc),
        "inter_grid": (-(-m // COLS), batch * h),
        "inter_smem": 4 * (COLS * (mp + 8) + mp + 2 * cp * (sl + 8)
                           + 3 * cp * (sl + 4) + 2 * cp * VS + 2 * vec_pad
                           + 2 * maxc),
        "work": batch * s * h * m + batch * h * nc * (3 * chunk + 1),
    }


def _ptr(t):
    """A tensor's data pointer, or NULL for None."""
    return None if t is None else t.data_ptr()


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def backward_work(batch: int, s: int, h: int, m: int, chunk: int) -> int:
    """float32 elements of the backward kernel's workspace: cum, 1 / D,
    dden and exp(cum) per token; the gradient reaching each chunk's end
    state (dC, dn); A^T, dS, dS^T and dA S D per chunk, padded to cp x cp;
    the per-column-tile shares; each part's start rounded up to 4."""
    bh, nc = batch * h, s // chunk
    cp = -(-chunk // 16) * 16
    return (_up4(4 * bh * s) + _up4(bh * nc * m * m) + _up4(bh * nc * m)
            + _up4(4 * bh * nc * cp * cp)
            + bh * nc * -(-m // BWD_COLS) * (2 * chunk + 1))


def backward_plan(batch: int, s: int, h: int, m: int, chunk: int) -> dict:
    """The backward kernel's geometry for one call: the chunk padded to a
    multiple of 16 (``cp``), the grads kernel's row blocks of
    :data:`ROW_BLOCK` token rows (one up to a chunk of 128) and the
    16-row tiles of one, 64-column tiles of m;
    each kernel's grid and shared memory; the grads kernel's column
    tiles of 8 a warp (``nt``: 8 / row tiles, rounded to a power of two),
    warp tasks (row tile x column group), ring stages (two when ``nt`` <=
    4, so two blocks share an SM, else four) and steps (16 of m, then 16
    of the chunk); the state kernel's walk steps (32 tokens of chunks
    nc-1..1); and the workspace's float32 elements.  The scores and grads
    grids run a chunk's tiles next to each other (x = chunk * tiles +
    tile), so they share its rows in the L2 cache."""
    cp = -(-chunk // 16) * 16
    nc = s // chunk
    bh = batch * h
    col_tiles = -(-m // BWD_COLS)
    rcap, nrb = min(cp, ROW_BLOCK), -(-cp // ROW_BLOCK)
    nrt = rcap // 16
    nt = 1 if nrt == 1 else 2 if nrt == 2 else 4 if nrt <= 4 else 8
    stages = 2 if nt <= 4 else 4
    score_tiles = -(-cp // BWD_COLS)
    extra = 4 * MAX_CHUNK + 2 * MAX_CHUNK + THREADS // 32
    return {
        "cp": cp, "chunks": nc, "col_tiles": col_tiles, "row_tiles": nrt,
        "row_blocks": nrb,
        "nt": nt, "col_groups": 8 // nt, "tasks": nrt * (8 // nt),
        "grads_stages": stages,
        "grads_steps": -(-m // BWD_DEPTH) + cp // BWD_DEPTH,
        "state_steps": max(nc - 1, 0) * -(-chunk // BWD_TOK),
        "prep_grid": (nc, bh, -(-chunk // BWD_TOK)),
        "state_grid": (col_tiles * col_tiles, bh),
        "scores_grid": (nc * score_tiles * score_tiles, bh),
        "grads_grid": (nc * nrb * col_tiles, bh),
        "gates_grid": (nc, bh),
        "state_smem": 4 * (STATE_STAGES * (2 * BWD_TOK * LDK + 3 * BWD_TOK
                                           + 4) + BWD_COLS * LDK),
        "scores_smem": 4 * (SCORE_STAGES * 4 * BWD_COLS * LDA
                            + 4 * MAX_CHUNK),
        "grads_smem": 4 * (stages * (3 * rcap * LDA + 3 * BSLOT) + extra),
        "work": backward_work(batch, s, h, m, chunk),
    }


def mlstm_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 i_gate: torch.Tensor, log_f: torch.Tensor, *,
                 chunk: int = CHUNK, return_state: bool = False,
                 save: bool = False):
    """Contiguous float32 tensors on one CUDA device, ``chunk`` dividing
    S → h (B, S, H, m) in a fresh tensor, or with ``return_state`` (h,
    C, n), the second pass writing the state it holds (h is the same
    bits either way); with ``save`` also, after the rest, what the
    backward reads: C_in (B, H, S/c, m, m), n_in (B, H, S/c, m) and den
    (B, H, S), as :func:`mlstm_plain`'s.  The caller has validated them;
    this launches both passes on the current stream (one call, one
    count) and does not wait."""
    global launches
    batch, s, h, m = q.shape
    out = torch.empty_like(q)

    def make(*shape):  # zeros: an empty sequence's, which no launch writes
        return (torch.zeros if s == 0 else torch.empty)(
            shape, dtype=torch.float32, device=q.device)

    c_state = n_state = c_in = n_in = den = None
    if return_state:
        c_state, n_state = make(batch, h, m, m), make(batch, h, m)
    if save:
        nc = s // chunk
        c_in, n_in = make(batch, h, nc, m, m), make(batch, h, nc, m)
        den = make(batch, h, s)
    if batch and s:
        work = torch.empty(launch_plan(batch, s, h, m, chunk)["work"],
                           dtype=torch.float32, device=q.device)
        check(launch(library().rimms_mlstm_f32, q, q.data_ptr(),
                     k.data_ptr(), v.data_ptr(), i_gate.data_ptr(),
                     log_f.data_ptr(), out.data_ptr(), _ptr(c_state),
                     _ptr(n_state), _ptr(c_in), _ptr(n_in), _ptr(den),
                     work.data_ptr(), batch, s, h, m, int(chunk),
                     ctypes.c_float(1.0 / math.sqrt(m))), "mlstm")
        with _count_lock:
            launches += 1
    res = (out,)
    if return_state:
        res += (c_state, n_state)
    if save:
        res += (c_in, n_in, den)
    return res if len(res) > 1 else out


def mlstm_backward_kernel(q, k, v, i_gate, log_f, h, c_in, n_in, den, dh,
                          dc=None, dn=None, *, chunk: int = CHUNK):
    """:func:`mlstm_backward_plain` on the card: the same arguments,
    contiguous float32 on one CUDA device (``dc``, ``dn`` None for
    zeros).  Returns (dq, dk, dv, di, dlog_f) in fresh tensors.  The
    caller has validated them; this launches the five kernels on the
    current stream (one call, one count) and does not wait."""
    global backward_launches
    batch, s, hh, m = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    di, dlf = torch.empty_like(i_gate), torch.empty_like(log_f)
    if batch == 0 or s == 0:
        return dq, dk, dv, di, dlf
    work = torch.empty(backward_work(batch, s, hh, m, chunk),
                       dtype=torch.float32, device=q.device)
    check(launch(library().rimms_mlstm_bwd_f32, q, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), i_gate.data_ptr(),
                 log_f.data_ptr(), h.data_ptr(), c_in.data_ptr(),
                 n_in.data_ptr(), den.data_ptr(), dh.data_ptr(), _ptr(dc),
                 _ptr(dn), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 di.data_ptr(), dlf.data_ptr(), work.data_ptr(), batch, s,
                 hh, m, int(chunk), ctypes.c_float(1.0 / math.sqrt(m))),
          "mlstm backward")
    with _count_lock:
        backward_launches += 1
    return dq, dk, dv, di, dlf


def mlstm_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i_gate: torch.Tensor, log_f: torch.Tensor, *,
                chunk: int = CHUNK, return_state: bool = False,
                save: bool = False):
    """The kernel's chunkwise recurrence in torch ops.  Same shapes and
    results (and float64 for float64 inputs).  With ``save`` it also returns what the backward reads,
    after the rest: each chunk's entering state C_in (B, H, S/c, m, m),
    n_in (B, H, S/c, m) and den (B, H, S) before its clamp."""
    batch, s, h, m = q.shape
    bh = batch * h

    def heads(x, sl):  # (B, S, H, ...) -> (BH, c, ...), one chunk's
        x = x[:, sl].transpose(1, 2)
        return x.reshape((bh,) + tuple(x.shape[2:]))

    c_state = torch.zeros((bh, m, m), dtype=q.dtype, device=q.device)
    n_state = torch.zeros((bh, m, 1), dtype=q.dtype, device=q.device)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    # h in q's layout, each chunk written into it (a chunk at a time, so
    # nothing of the whole sequence is held twice)
    hs = torch.empty_like(q)
    c_ins, n_ins, dens = [], [], []
    for t0 in range(0, s, chunk):
        sl = slice(t0, t0 + chunk)
        qc, kc, vc = heads(q, sl) / math.sqrt(m), heads(k, sl), heads(v, sl)
        ic = heads(i_gate, sl)
        cum = torch.cumsum(heads(log_f, sl), dim=-1)            # (BH, c)
        scores = qc @ kc.transpose(-1, -2)
        # the decay masked before its exp: above the diagonal cum_t - cum_s
        # is positive and, over a long chunk, overflows, and autograd of a
        # masked inf is inf * 0 = nan (the same values below it)
        dlt = torch.where(mask, cum[:, :, None] - cum[:, None, :], -math.inf)
        a = torch.where(mask, scores * torch.exp(dlt) * ic[:, None, :],
                        torch.zeros((), dtype=q.dtype, device=q.device))
        ecum = torch.exp(cum)[..., None]
        num = a @ vc + ecum * (qc @ c_state)
        den = a.sum(dim=-1, keepdim=True) + ecum * (qc @ n_state)
        hs[:, sl].copy_((num / den.abs().clamp_min(1.0)).reshape(
            batch, h, chunk, m).transpose(1, 2))
        if save:
            c_ins.append(c_state)
            n_ins.append(n_state[..., 0])
            dens.append(den[..., 0])
        kw = kc * (torch.exp(cum[:, -1:] - cum) * ic)[..., None]
        decay = torch.exp(cum[:, -1])[:, None, None]
        c_state = decay * c_state + kw.transpose(-1, -2) @ vc
        n_state = decay * n_state + kw.sum(dim=1)[..., None]
    if not s:
        hs = q.contiguous()
    out = (hs,)
    if return_state:
        out += (c_state.reshape(batch, h, m, m), n_state.reshape(batch, h, m))
    if save:
        nc = len(c_ins)
        out += (torch.stack(c_ins, 1).reshape(batch, h, nc, m, m)
                if nc else q.new_zeros((batch, h, 0, m, m)),
                torch.stack(n_ins, 1).reshape(batch, h, nc, m)
                if nc else q.new_zeros((batch, h, 0, m)),
                torch.cat(dens, 1).reshape(batch, h, s)
                if nc else q.new_zeros((batch, h, 0)))
    return out if len(out) > 1 else hs


def mlstm_backward_plain(q, k, v, i_gate, log_f, h, c_in, n_in, den, dh,
                         dc=None, dn=None, *, chunk: int = CHUNK):
    """The gradients (dq, dk, dv, di, dlog_f) of :func:`mlstm_plain`'s h
    (and, with ``return_state``, its final C and n) given theirs: dh
    (B, S, H, m) and the seeds dc (B, H, m, m), dn (B, H, m) or None.
    Reads the forward's inputs, its h and what ``save`` returned: each
    chunk's entering state c_in, n_in and den.  The chunkwise backward in
    torch ops, as the backward kernel computes it: a walk over the chunks
    from the last carries the gradient reaching each chunk's end state,
    dC <- e^{cum_last} dC + Σ_t e^{cum_t} q̃_t ⊗ dnum_t (dn likewise),
    and each chunk then takes its terms from its scores, its entering
    state and that gradient; d cum_t sums to dlog_f in reverse order.
    With D_t = max(|den_t|, 1), dnum_t = dh_t / D_t and dden_t =
    -sgn(den_t) W_t (dh_t . h_t) / D_t, W_t = 1 where |den_t| > 1, 1/2
    where |den_t| = 1 and 0 below: JAX's gradient of the reference's
    ``jnp.maximum(jnp.abs(den), 1.0)``, which splits a tie evenly (torch's
    ``clamp_min``, in :func:`mlstm_plain`, passes all of it)."""
    batch, s, hh, m = q.shape
    bh = batch * hh
    nc = s // chunk if s else 0

    def heads(x):  # (B, S, H, m) -> (BH, S, m)
        return x.transpose(1, 2).reshape(bh, s, m)

    def unheads(x):  # (BH, S, m) -> (B, S, H, m)
        return x.reshape(batch, hh, s, m).transpose(1, 2).contiguous()

    qh, kh, vh = heads(q / math.sqrt(m)), heads(k), heads(v)
    hd, gh = heads(h), heads(dh)
    ih = i_gate.transpose(1, 2).reshape(bh, s)
    fh = log_f.transpose(1, 2).reshape(bh, s)
    deh = den.reshape(bh, s)
    cin = c_in.reshape(bh, nc, m, m)
    nin = n_in.reshape(bh, nc, m)
    d_c = (torch.zeros((bh, m, m), dtype=q.dtype, device=q.device)
           if dc is None else dc.reshape(bh, m, m).clone())
    d_n = (torch.zeros((bh, m), dtype=q.dtype, device=q.device)
           if dn is None else dn.reshape(bh, m).clone())
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    dq, dk, dv = (torch.empty_like(qh) for _ in range(3))
    di, dlf = torch.empty_like(ih), torch.empty_like(fh)
    for j in reversed(range(nc)):
        sl = slice(j * chunk, (j + 1) * chunk)
        qc, kc, vc, ic = qh[:, sl], kh[:, sl], vh[:, sl], ih[:, sl]
        cum = torch.cumsum(fh[:, sl], dim=-1)                    # (BH, c)
        last = cum[:, -1:]
        ecum, decay = torch.exp(cum), torch.exp(last)
        w = torch.exp(last - cum) * ic
        dj = deh[:, sl]
        big = dj.abs().clamp_min(1.0)
        dnum = gh[:, sl] / big[..., None]
        tie = (dj.abs() > 1.0).to(dj.dtype) + 0.5 * (dj.abs() == 1.0).to(
            dj.dtype)
        dden = -torch.sign(dj) * tie * ((gh[:, sl] * hd[:, sl]).sum(-1)
                                        / big)
        c0, n0 = cin[:, j], nin[:, j]
        # the chunk's scores, decays and A, the masked entries exactly 0
        scores = qc @ kc.transpose(-1, -2)
        dm = torch.exp(torch.where(mask, cum[:, :, None] - cum[:, None, :],
                                   -math.inf))
        a = scores * dm * ic[:, None, :]
        da = torch.where(mask, dnum @ vc.transpose(-1, -2)
                         + dden[..., None], 0.0)
        ds = da * dm * ic[:, None, :]
        # through the entering state (h's q̃ C_in and q̃ . n_in terms)
        z = dnum @ c0.transpose(-1, -2) + dden[..., None] * n0[:, None, :]
        # through the end state C_out = e^{cum_last} C_in + Σ w k ⊗ v
        y = vc @ d_c.transpose(-1, -2) + d_n[:, None, :]
        dw = (kc * y).sum(-1)
        dq[:, sl] = (ds @ kc + ecum[..., None] * z) / math.sqrt(m)
        dk[:, sl] = ds.transpose(-1, -2) @ qc + w[..., None] * y
        dv[:, sl] = (a.transpose(-1, -2) @ dnum
                     + w[..., None] * (kc @ d_c))
        q_ = da * scores * dm                                  # dA S D
        di[:, sl] = q_.sum(-2) + dw * torch.exp(last - cum)
        p = q_ * ic[:, None, :]                                # dA A
        dcum = (p.sum(-1) - p.sum(-2) + (qc * z).sum(-1) * ecum - dw * w)
        ddecay = (d_c * c0).sum((-1, -2)) + (d_n * n0).sum(-1)
        dcum[:, -1] += (dw * w).sum(-1) + ddecay * decay[:, 0]
        dlf[:, sl] = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1),
                                (-1,))
        # the gradient reaching the previous chunk's end state
        eq = qc * ecum[..., None]
        d_c = decay[..., None] * d_c + eq.transpose(-1, -2) @ dnum
        d_n = decay * d_n + (eq * dden[..., None]).sum(1)
    def gates(x):  # (BH, S) -> (B, S, H)
        return x.reshape(batch, hh, s).transpose(1, 2).contiguous()

    return unheads(dq), unheads(dk), unheads(dv), gates(di), gates(dlf)
