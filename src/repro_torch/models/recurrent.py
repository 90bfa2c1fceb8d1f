"""Recurrent sequence mixers on torch: mLSTM + sLSTM (xLSTM) and RG-LRU
(Griffin / RecurrentGemma), the JAX package's
``src/repro/models/recurrent.py`` on the port's block protocol
(:mod:`repro_torch.models.blocks`).

Where the reference's prefill runs its own chunkwise einsums and
``associative_scan``, the port's reaches the hand-written kernels:

* **mLSTM** prefill is one call of
  :func:`repro_torch.kernels.mlstm.ops.mlstm_chunkwise`, which also
  returns the final state (C, n) the prefill cache holds.  Its chunk is
  the reference's ``divisor_chunk(S, rec_chunk)`` (the full configs ask
  for 256, the kernel's :data:`~repro_torch.kernels.mlstm.mlstm.MAX_CHUNK`).
  The kernel takes q unscaled and divides it by √m in float32, where the
  reference divides in the compute dtype; decode keeps the reference's
  one-step update, scaled q and all, in torch ops.
* **sLSTM** has a true nonlinear recurrence and no kernel in either
  package: a torch loop over time, one step at a time (:func:`time_loop`),
  writing each step's states into buffers of the whole sequence.
* **RG-LRU** prefill is one call of
  :func:`repro_torch.kernels.rg_lru.ops.rg_lru_scan` from h = 0, whose
  ``h_final`` is the prefill cache's h; decode is the one-step update.

Train mode is prefill without the cache.  It reaches the same kernel
calls, which are differentiable on both devices: each wrapper is an
autograd ``Function`` whose backward launches a hand-written backward
kernel on the card (``csrc/mlstm_bwd.cu``, ``csrc/rg_lru_bwd.cu``) and
runs its plain version on the CPU.  Under per-layer remat a training
step runs each kernel forward twice (the step, then the recompute) and
backward once.  The sLSTM's loop is an autograd ``Function`` too
(:class:`_SLSTMScan`): its backward is the reverse loop of autograd's
rules for one step, every step the same ops on the same shapes, and the
recurrent weights' gradient one product over all steps after it.

Every layer casts to float32 where the reference does, and the kernels
get contiguous float32.  The leaves a block names in ``FLOAT32`` are ones
the reference reads in float32 at every use (the sLSTM's recurrent
weights and bias, the RG-LRU's λ): the model holds them in float32 and
every other leaf in the compute dtype.  ``shard(...)`` marks where the
reference constrains a layout; without a mesh it returns its input.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import P, current_rules, shard
from repro_torch.kernels.mlstm import ops as mlstm_ops
from repro_torch.kernels.rg_lru import ops as rg_lru_ops

from . import layers as L
from .blocks import donated

# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

#: what :func:`time_loop` runs instead of its loop where set:
#: ``TIME_LOOP(steps, body)``.  The dry-run sets one that runs the first
#: steps and counts the last of them for every other (each step runs the
#: same ops on the same shapes and layouts); None runs every step.
TIME_LOOP = None


def time_loop(steps: int, body) -> None:
    """``body(i)`` for i = 0 … steps - 1, or :data:`TIME_LOOP`'s run."""
    if TIME_LOOP is not None:
        TIME_LOOP(steps, body)
        return
    for i in range(steps):
        body(i)


def _causal_conv(x, kernel, buf=None):
    """Depthwise causal conv. x: (B,S,D); kernel: (W,D); buf: (B,W-1,D)
    carry-in for decode (None → zero history).  Returns (y, new_buf),
    new_buf a tensor of its own."""
    B, S, D = x.shape
    W = kernel.shape[0]
    hist = x.new_zeros((B, W - 1, D)) if buf is None else buf.to(x.dtype)
    xp = torch.cat([hist, x], dim=1)  # (B, S+W-1, D)
    y = sum(xp[:, i:i + S] * kernel[i].to(x.dtype)[None, None, :]
            for i in range(W))
    return y, xp[:, -(W - 1):].clone()


def _split_product(x, w, n, mode):
    """``x @ w``'s first ``n`` columns and the rest.  On a mesh, outside
    decode, each is a product of its own, its weight's columns over the
    model axis (``"ff"``): the whole product's columns lie there in
    shards that do not split at ``n``, and slicing it would gather it.
    Otherwise (a decode step's few tokens: the weight would move), the
    product sliced."""
    if current_rules().mesh is None or mode == "decode":
        y = x @ w
        return y[..., :n], y[..., n:]
    return tuple(x @ shard(part, "fsdp", "ff")
                 for part in (w[:, :n], w[:, n:]))


def _f32(*ts):
    """Contiguous float32 copies (or the tensors themselves), as the
    kernels take them."""
    return tuple(t.float().contiguous() for t in ts)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block)
# ---------------------------------------------------------------------------


class MLSTMLayer:
    """Pre-norm mLSTM block: up-proj (pf=2) → conv → q,k,v + scalar head
    gates → chunkwise matrix-memory recurrence → gated output → down-proj.
    Carries its own expansion (cfg.d_ff == 0 for xlstm)."""

    FLOAT32 = ()

    @staticmethod
    def _dims(cfg):
        M = 2 * cfg.d_model
        return M, cfg.n_heads, M // cfg.n_heads

    @staticmethod
    def init(cfg, gen: torch.Generator):
        D = cfg.d_model
        M, H, _ = MLSTMLayer._dims(cfg)
        return {
            "norm": L.norm_init(cfg, gen),
            "w_up": L.dense_init(gen, (D, 2 * M)),
            "conv": L.dense_init(gen, (cfg.conv_width, M)),
            "wq": L.dense_init(gen, (M, M)),
            "wk": L.dense_init(gen, (M, M)),
            "wv": L.dense_init(gen, (M, M)),
            "w_gates": L.dense_init(gen, (M, 2 * H)),
            "w_down": L.dense_init(gen, (M, D)),
            "out_scale": torch.ones((M,), dtype=L.pdtype(cfg),
                                    device=gen.device),
        }

    @staticmethod
    def spec(cfg):
        return {
            "norm": L.norm_spec(cfg),
            "w_up": P("fsdp", "ff"),
            "conv": P(None, "ff"),
            "wq": P("fsdp", "ff"),
            "wk": P("fsdp", "ff"),
            "wv": P("fsdp", "ff"),
            "w_gates": P("fsdp", None),
            "w_down": P("ff", "fsdp"),
            "out_scale": P("ff"),
        }

    @staticmethod
    def cache_spec(cfg):
        return {
            "C": P("batch", None, None, "ff"),
            "n": P("batch", None, None),
            "conv": P("batch", None, "ff"),
        }

    @staticmethod
    def init_cache(cfg, batch, max_len, device=None):
        M, H, m = MLSTMLayer._dims(cfg)
        f32 = dict(dtype=torch.float32, device=device)
        return {
            "C": torch.zeros((batch, H, m, m), **f32),
            "n": torch.zeros((batch, H, m), **f32),
            "conv": torch.zeros((batch, cfg.conv_width - 1, M),
                                dtype=L.cdtype(cfg), device=device),
        }

    @staticmethod
    def prefill_chunk(cfg, s: int) -> int:
        """The kernel's chunk for a prefill of ``s`` tokens: the
        reference's ``divisor_chunk(s, rec_chunk)``."""
        return L.divisor_chunk(s, cfg.rec_chunk)

    @staticmethod
    def _up(cfg, params, x, mode):
        M = 2 * cfg.d_model
        h_in = L.norm_apply(cfg, params["norm"], x)
        xm, z = _split_product(h_in, params["w_up"].to(x.dtype), M, mode)
        return shard(xm, "batch", "seq", "ff"), z

    @staticmethod
    def _qkv_gates(cfg, params, xm, conv_buf):
        """q (unscaled), k, v (B,S,H,m) in the compute dtype, the gates
        i, log f (B,S,H) in float32, and the new conv buffer."""
        M, H, m = MLSTMLayer._dims(cfg)
        dt = xm.dtype
        u, new_buf = _causal_conv(xm, params["conv"], conv_buf)
        u = F.silu(u)
        B, S = xm.shape[:2]
        q = (u @ params["wq"].to(dt)).reshape(B, S, H, m)
        k = (u @ params["wk"].to(dt)).reshape(B, S, H, m)
        v = (xm @ params["wv"].to(dt)).reshape(B, S, H, m)
        gates = (xm @ params["w_gates"].to(dt)).float().reshape(B, S, H, 2)
        i = torch.sigmoid(gates[..., 0])
        lf = F.logsigmoid(gates[..., 1])
        return q, k, v, i, lf, new_buf

    @staticmethod
    def kernel_inputs(cfg, params, x):
        """What a prefill of layer input ``x`` (B,S,d) hands
        ``mlstm_chunkwise``: q (unscaled), k, v (B,S,H,m) and i_gate,
        log_f (B,S,H), contiguous float32."""
        xm, _ = MLSTMLayer._up(cfg, params, x, "prefill")
        return _f32(*MLSTMLayer._qkv_gates(cfg, params, xm, None)[:5])

    @staticmethod
    def apply(cfg, params, x, *, mode, cache=None, pos=None, extras=None):
        M, H, m = MLSTMLayer._dims(cfg)
        dt = x.dtype
        B, S = x.shape[:2]
        xm, z = MLSTMLayer._up(cfg, params, x, mode)
        if mode == "decode":
            q, k, v, i, lf, new_buf = MLSTMLayer._qkv_gates(
                cfg, params, xm, cache["conv"])
            q = q / math.sqrt(m)  # in the compute dtype, as the reference
            q1, k1, v1 = (t[:, 0].float() for t in (q, k, v))
            # laid out as the cache's columns (GSPMD propagates C's)
            v1 = shard(v1, "batch", None, "ff")
            i1, f1 = i[:, 0], torch.exp(lf[:, 0])  # (B,H)
            kv = i1[..., None, None] * k1[..., :, None] * v1[..., None, :]
            if donated(extras):
                C = cache["C"].mul_(f1[..., None, None]).add_(kv)
                nv = cache["n"].mul_(f1[..., None]).add_(i1[..., None] * k1)
                new_buf = cache["conv"].copy_(new_buf)
            else:
                C = cache["C"] * f1[..., None, None] + kv
                nv = cache["n"] * f1[..., None] + i1[..., None] * k1
            num = torch.einsum("zha,zhae->zhe", q1, C)
            den = torch.clamp_min(
                torch.abs(torch.einsum("zha,zha->zh", q1, nv)), 1.0)
            # (on a mesh: the value dim whole before heads and it merge,
            # a strided layout whose every later op DTensor plans slowly)
            num = shard(num, "batch", None, None)
            h = (num / den[..., None]).reshape(B, 1, M).to(dt)
            new_cache = {"C": C, "n": nv, "conv": new_buf}
        elif mode in ("prefill", "train"):
            q, k, v, i, lf, new_buf = MLSTMLayer._qkv_gates(
                cfg, params, xm, None)
            # on a mesh: each rank's batch, its heads whole where the
            # model axis does not divide them (the chunks then run on
            # every rank of it)
            ins = _f32(*(shard(t, "batch", "seq", "heads", None)
                         for t in (q, k, v)),
                       *(shard(t, "batch", "seq", "heads") for t in (i, lf)))
            del q, k, v, i, lf  # the compute dtype's copies
            out = mlstm_ops.mlstm_chunkwise(
                *ins, chunk=MLSTMLayer.prefill_chunk(cfg, S),
                return_state=mode == "prefill")
            del ins
            if mode == "prefill":
                h, C, n = out
                new_cache = {"C": C, "n": n, "conv": new_buf}
            else:
                h, new_cache = out, None
            h = h.reshape(B, S, M).to(dt)
        else:
            raise ValueError(f"MLSTMLayer mode {mode!r}: train, prefill or "
                             f"decode")
        h = L.rms_norm(h, params["out_scale"])
        h = h * F.silu(z)
        out = h @ params["w_down"].to(dt)
        return shard(x + out, "batch", "res_seq", "dmodel"), new_cache


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory block)
# ---------------------------------------------------------------------------


class SLSTMLayer:
    """Pre-norm sLSTM with per-head block-diagonal recurrence + gated FFN
    (pf=4/3).  The time recurrence is inherently sequential: a torch loop
    over time, as the reference's ``lax.scan``."""

    FLOAT32 = ("r_gates", "b_gates")

    @staticmethod
    def _dims(cfg):
        D = cfg.d_model
        H = cfg.n_heads
        f = int(round(D * 4 / 3 / 32)) * 32
        return D, H, D // H, f

    @staticmethod
    def init(cfg, gen: torch.Generator):
        D, H, hd, f = SLSTMLayer._dims(cfg)
        return {
            "norm": L.norm_init(cfg, gen),
            "w_gates": L.dense_init(gen, (D, 4 * D)),
            "r_gates": L.dense_init(gen, (4, H, hd, hd), in_axis=2),
            "b_gates": torch.zeros((4 * D,), dtype=L.pdtype(cfg),
                                   device=gen.device),
            "w_up": L.dense_init(gen, (D, 2 * f)),
            "w_down": L.dense_init(gen, (f, D)),
            "out_scale": torch.ones((D,), dtype=L.pdtype(cfg),
                                    device=gen.device),
        }

    @staticmethod
    def spec(cfg):
        return {
            "norm": L.norm_spec(cfg),
            "w_gates": P("fsdp", None),
            "r_gates": P(None, "heads", None, None),
            "b_gates": P(None),
            "w_up": P("fsdp", "ff"),
            "w_down": P("ff", "fsdp"),
            "out_scale": P(None),
        }

    @staticmethod
    def cache_spec(cfg):
        s = P("batch", None)
        return {"c": s, "h": s, "n": s}

    @staticmethod
    def recurrent_flops(cfg, batch: int, seq: int) -> float:
        """Analytic FLOPs of the sequential recurrence, the reference's
        roofline correction for XLA counting a loop body once (the port
        runs and counts every step, so its roofline adds none)."""
        D, H, hd, _ = SLSTMLayer._dims(cfg)
        per_step = 4 * H * hd * hd * 2 * batch  # block-diag recurrent matvec
        elementwise = 12 * D * batch
        return seq * (per_step + elementwise)

    @staticmethod
    def init_cache(cfg, batch, max_len, device=None):
        # three tensors of their own: a donated decode step writes each
        return {k: torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                               device=device) for k in ("c", "h", "n")}

    @staticmethod
    def _recurrence(cfg, params, mode=None):
        """The recurrent weights as one batched product over heads, R
        (H, hd, 4 hd) with R[h, d, g hd + e] = r_gates[g, h, d, e], and
        the bias in the same layout (H, 1, 4 hd); float32.  On a mesh, a
        decode step takes R with its rows (d) over the model axis: each
        rank copies and multiplies its part, and the product's sum is
        reduced."""
        D, H, hd, _ = SLSTMLayer._dims(cfg)
        rg = params["r_gates"]
        if mode == "decode":
            rg = shard(rg, None, None, "ff", None)
        r = rg.float().permute(1, 2, 0, 3).reshape(H, hd, 4 * hd)
        bias = params["b_gates"].float().reshape(4, H, hd).permute(
            1, 0, 2).reshape(H, 1, 4 * hd)
        return r, bias

    @staticmethod
    def _step(r, bias, pre_t, c, n, h):
        """One step of the recurrence, heads first: pre_t (H,B,4hd) fp32
        input preactivations, states c, n, h (H,B,hd); ``r``, ``bias``
        from :meth:`_recurrence`.  Returns the new (c, n, h)."""
        H, B, hd = h.shape
        # the reference's "bhd,ghde->gbhe" (pre + rec) + b, gate-major
        g = (pre_t + torch.bmm(h, r) + bias).view(H, B, 4, hd)
        z = torch.tanh(g[:, :, 0])
        i, f, o = torch.sigmoid(g[:, :, 1:]).unbind(2)
        c = f * c + i * z
        n = f * n + i
        h = o * c / torch.clamp_min(n, 1e-6)
        return c, n, h

    @staticmethod
    def scan(r, bias, pre, c, n, h, keep: bool = False):
        """The time loop over ``pre`` (S,H,B,4hd) from states c, n, h
        (H,B,hd).  Each step's h is written into a buffer of the whole
        sequence, hs (S,H,B,hd); with ``keep`` the buffers hold every
        state c, n, h, the initial ones first, (S+1,H,B,hd) each.
        Returns (hs or the three buffers, the final (c, n, h))."""
        S = pre.shape[0]
        o = 1 if keep else 0
        # laid out as h (``new_empty`` would give a DTensor replicated)
        bufs = [torch.empty_like(h.expand((S + o,) + tuple(h.shape)),
                                 memory_format=torch.contiguous_format)
                for _ in range(3 if keep else 1)]
        if keep:
            for b, v in zip(bufs, (c, n, h)):
                b[0].copy_(v)
        state = [c, n, h]

        def body(t):
            state[:] = SLSTMLayer._step(r, bias, pre[t], *state)
            for b, v in zip(bufs, state if keep else state[2:]):
                b[t + o].copy_(v)

        time_loop(S, body)
        return (bufs if keep else bufs[0]), tuple(state)

    @staticmethod
    def apply(cfg, params, x, *, mode, cache=None, pos=None, extras=None):
        """The time loop runs heads first, (H,B,hd), so a step is a few
        launches and no copies but its h into the sequence's buffer: the
        preactivations are laid out so once, the states are taken from and
        given back to the cache's (B,D)."""
        D, H, hd, f = SLSTMLayer._dims(cfg)
        dt = x.dtype
        B, S = x.shape[:2]
        hin = L.norm_apply(cfg, params["norm"], x)
        # on a mesh, outside decode: the product's columns over the model
        # axis (else every rank of it would compute all of them), then
        # gathered whole
        w = params["w_gates"].to(dt)
        if mode != "decode":
            w = shard(w, "fsdp", "ff")
        pre = shard(hin @ w, "batch", "seq", None).float()
        pre = pre.reshape(B, S, 4, H, hd).permute(1, 3, 0, 2, 4).reshape(
            S, H, B, 4 * hd)
        if mode == "decode":
            c, n, h = (cache[k].reshape(B, H, hd).transpose(0, 1)
                       for k in ("c", "n", "h"))
        elif mode in ("prefill", "train"):
            # laid out as a step's preactivations
            c = n = h = torch.zeros_like(pre[0, :, :, :hd])
        else:
            raise ValueError(f"SLSTMLayer mode {mode!r}: train, prefill or "
                             f"decode")
        r, bias = SLSTMLayer._recurrence(cfg, params, mode)
        if mode == "train" and torch.is_grad_enabled():
            hs = _SLSTMScan.apply(r, bias, pre, c, n, h)
        else:
            hs, (c, n, h) = SLSTMLayer.scan(r, bias, pre, c, n, h)
        # (S,H,B,hd) → (B,S,D)
        h_seq = hs.permute(2, 0, 1, 3).reshape(B, S, D).to(dt)
        h_seq = L.rms_norm(h_seq, params["out_scale"])
        gate, val = _split_product(h_seq, params["w_up"].to(dt), f, mode)
        out = (L._gelu(gate) * val) @ params["w_down"].to(dt)
        x = shard(x + out, "batch", "res_seq", "dmodel")
        if mode == "train":
            return x, None
        state = {k: v.transpose(0, 1).reshape(B, D)
                 for k, v in (("c", c), ("h", h), ("n", n))}
        if mode == "decode" and donated(extras):
            state = {k: cache[k].copy_(v) for k, v in state.items()}
        return x, state


class _SLSTMScan(torch.autograd.Function):
    """:meth:`SLSTMLayer.scan` differentiated: the forward keeps every
    state (three (S+1,H,B,hd) buffers); the backward runs the loop in
    reverse, each step recomputing its gates from the saved states and
    applying autograd's rule for each op of :meth:`SLSTMLayer._step`, the
    preactivations' gradient written into a buffer of the whole sequence.
    The recurrent weights' and the bias's gradients are one product and
    one sum over all steps after the loop."""

    @staticmethod
    def forward(ctx, r, bias, pre, c, n, h):
        (cs, ns, hs), _ = SLSTMLayer.scan(r, bias, pre, c, n, h, keep=True)
        ctx.save_for_backward(r, bias, pre, cs, ns, hs)
        return hs[1:]

    @staticmethod
    def backward(ctx, dhs):
        aten = torch.ops.aten
        r, bias, pre, cs, ns, hs = ctx.saved_tensors
        S, H, B, hd = dhs.shape
        dpre = torch.empty_like(pre)
        rt = r.transpose(1, 2)
        zero = torch.zeros_like(dhs[0])
        carry = [zero, zero, zero]  # dh, dc, dn from step t + 1

        def body(i):
            t = S - 1 - i
            dh_next, dc_next, dn_next = carry
            g = (pre[t] + torch.bmm(hs[t], r) + bias).view(H, B, 4, hd)
            z = torch.tanh(g[:, :, 0])
            sg = torch.sigmoid(g[:, :, 1:])
            i_, f_, o_ = sg.unbind(2)
            c, n = cs[t + 1], ns[t + 1]
            d = torch.clamp_min(n, 1e-6)
            a = o_ * c
            dh = dhs[t] + dh_next
            da = dh / d
            dd = -dh * a / (d * d)
            dc = dc_next + da * o_
            dn = dn_next + dd * (n >= 1e-6)
            di = dc * z + dn
            df = dc * cs[t] + dn * ns[t]
            do = da * c
            dz = aten.tanh_backward(dc * i_, z)
            dsg = aten.sigmoid_backward(torch.stack((di, df, do), 2), sg)
            dg = torch.cat((dz[:, :, None], dsg), 2).view(H, B, 4 * hd)
            dpre[t].copy_(dg)
            carry[:] = torch.bmm(dg, rt), dc * f_, dn * f_

        time_loop(S, body)
        # Σ over steps and batch: h_{t-1}ᵀ dg_t, and dg_t
        hp = hs[:-1].permute(1, 2, 0, 3).reshape(H, B * S, hd)
        dgp = dpre.permute(1, 2, 0, 3).reshape(H, B * S, 4 * hd)
        dr = torch.bmm(hp.transpose(1, 2), dgp)
        dbias = dgp.sum(1, keepdim=True)
        return dr, dbias, dpre, None, None, None


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------


class RGLRULayer:
    """Pre-norm Griffin recurrent block (conv + RG-LRU, gated) + GeGLU MLP."""

    C_FACTOR = 8.0
    FLOAT32 = ("lam",)

    @staticmethod
    def init(cfg, gen: torch.Generator):
        D = cfg.d_model
        return {
            "norm1": L.norm_init(cfg, gen),
            "w_x": L.dense_init(gen, (D, D)),
            "w_g": L.dense_init(gen, (D, D)),
            "conv": L.dense_init(gen, (cfg.conv_width, D)),
            "w_r": L.dense_init(gen, (D, D)),
            "w_i": L.dense_init(gen, (D, D)),
            "lam": torch.full((D,), 2.0, dtype=L.pdtype(cfg),
                              device=gen.device),  # softplus ≈ 2.1
            "w_o": L.dense_init(gen, (D, D)),
            "norm2": L.norm_init(cfg, gen),
            "mlp": L.mlp_init(cfg, gen),
        }

    @staticmethod
    def spec(cfg):
        return {
            "norm1": L.norm_spec(cfg),
            "w_x": P("fsdp", "ff"),
            "w_g": P("fsdp", "ff"),
            "conv": P(None, "ff"),
            "w_r": P("fsdp", "ff"),
            "w_i": P("fsdp", "ff"),
            "lam": P("ff"),
            "w_o": P("ff", "fsdp"),
            "norm2": L.norm_spec(cfg),
            "mlp": L.mlp_spec(cfg),
        }

    @staticmethod
    def cache_spec(cfg):
        return {"h": P("batch", "ff"), "conv": P("batch", None, "ff")}

    @staticmethod
    def init_cache(cfg, batch, max_len, device=None):
        D = cfg.d_model
        return {
            "h": torch.zeros((batch, D), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, D),
                                dtype=L.cdtype(cfg), device=device),
        }

    @staticmethod
    def _scan_inputs(cfg, params, hin, conv_buf):
        """a, b (B,S,D) float32 of h_t = a_t h_{t-1} + b_t, and the new
        conv buffer, from the normed input ``hin``."""
        dt = hin.dtype
        xb = hin @ params["w_x"].to(dt)
        u, new_buf = _causal_conv(xb, params["conv"], conv_buf)
        u = shard(u, "batch", "seq", "ff")
        # on a mesh: u whole on the model axis for the gates' products,
        # whose columns lie in its shards (GSPMD gathers u there; DTensor
        # might leave a pending sum, and a pointwise op then gathers the
        # product whole on every rank)
        uw = shard(u, "batch", "seq", None)
        r = torch.sigmoid((uw @ params["w_r"].to(dt)).float())
        i = torch.sigmoid((uw @ params["w_i"].to(dt)).float())
        log_a = -RGLRULayer.C_FACTOR * F.softplus(
            params["lam"].float()) * r  # (B,S,D)
        a = torch.exp(log_a)
        b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                       1e-12)) * (i * u.float())
        return a, b, new_buf

    @staticmethod
    def kernel_inputs(cfg, params, x):
        """What a prefill of layer input ``x`` (B,S,d) hands
        ``rg_lru_scan`` besides h0 = 0: a and b (B,S,D), contiguous
        float32."""
        hin = L.norm_apply(cfg, params["norm1"], x)
        return _f32(*RGLRULayer._scan_inputs(cfg, params, hin, None)[:2])

    @staticmethod
    def apply(cfg, params, x, *, mode, cache=None, pos=None, extras=None):
        dt = x.dtype
        hin = L.norm_apply(cfg, params["norm1"], x)
        gate = L._gelu(hin @ params["w_g"].to(dt))
        if mode == "decode":
            a, b, new_buf = RGLRULayer._scan_inputs(cfg, params, hin,
                                                    cache["conv"])
            if donated(extras):
                h_new = cache["h"].mul_(a[:, 0]).add_(b[:, 0])
                new_buf = cache["conv"].copy_(new_buf)
            else:
                h_new = a[:, 0] * cache["h"] + b[:, 0]  # (B,D)
            hs = h_new[:, None]
        elif mode in ("prefill", "train"):
            a, b, new_buf = RGLRULayer._scan_inputs(cfg, params, hin, None)
            a, b = _f32(a, b)
            hs, h_new = rg_lru_ops.rg_lru_scan(
                a, b, a.new_zeros((a.shape[0], a.shape[2])))
        else:
            raise ValueError(f"RGLRULayer mode {mode!r}: train, prefill or "
                             f"decode")
        mix = (hs.to(dt) * gate) @ params["w_o"].to(dt)
        x = shard(x + mix, "batch", "res_seq", "dmodel")
        h2 = L.norm_apply(cfg, params["norm2"], x)
        x = shard(x + L.mlp_apply(cfg, params["mlp"], h2),
                  "batch", "res_seq", "dmodel")
        if mode == "train":
            return x, None
        return x, {"h": h_new, "conv": new_buf}
