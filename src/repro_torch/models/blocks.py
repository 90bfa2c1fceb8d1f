"""Transformer layer blocks on torch: the KV-cache helpers and the dense
GQA decoder layer (llama / yi / command-r / qwen, and the VLM backbone).

Block protocol (the JAX package's, ``src/repro/models/blocks.py``): a
block is a namespace of functions

  init(cfg, gen) -> params            one layer's params (float32)
  init_cache(cfg, batch, max_len, device) -> cache dict
  apply(cfg, params, x, *, mode, cache, pos, extras) -> (x, new_cache)

``mode`` ∈ {"prefill", "decode"}; ``pos`` is (B,) — the position being
generated in decode.  Caches are returned as new tensors (the reference
threads functional arrays); nothing is updated in place here.
"""

from __future__ import annotations

import torch

from . import layers as L

# ---------------------------------------------------------------------------
# KV cache helpers
# ---------------------------------------------------------------------------


def kv_cache_init(cfg, batch: int, max_len: int, device=None):
    dims = L.attn_dims(cfg)
    length = min(max_len, cfg.window) if cfg.window > 0 else max_len
    shape = (batch, length, dims.n_kv, dims.head_dim)
    return {"k": torch.zeros(shape, dtype=L.cdtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=L.cdtype(cfg), device=device)}


def _ring_fill(x, w):
    """Fill a ring buffer of length w from a full sequence (B,S,...):
    slot s gets the *last* position p < S with p % w == s."""
    S = x.shape[1]
    slot = torch.arange(w, device=x.device)
    p = slot + w * torch.div(S - 1 - slot, w, rounding_mode="floor")
    p = torch.clamp(p, 0, S - 1)
    return x[:, p]


def build_prefill_cache(cfg, k, v, max_len):
    """A fresh KV cache from full-sequence K/V."""
    dt = L.cdtype(cfg)
    S = k.shape[1]
    if cfg.window > 0:
        w = min(cfg.window, max_len)
        return {"k": _ring_fill(k, w).to(dt), "v": _ring_fill(v, w).to(dt)}
    if S == max_len:
        return {"k": k.to(dt), "v": v.to(dt)}
    B = k.shape[0]
    shape = (B, max_len) + tuple(k.shape[2:])
    kc = torch.zeros(shape, dtype=dt, device=k.device)
    vc = torch.zeros(shape, dtype=dt, device=k.device)
    kc[:, :S] = k.to(dt)
    vc[:, :S] = v.to(dt)
    return {"k": kc, "v": vc}


def _cache_write_token(cfg, cache, k_new, v_new, pos):
    """Write one token at pos (B,) — rolling ring buffer if windowed."""
    pos = pos.long()
    slot = pos % cache["k"].shape[1] if cfg.window > 0 else pos
    b = torch.arange(k_new.shape[0], device=k_new.device)
    k = cache["k"].clone()
    v = cache["v"].clone()
    k[b, slot] = k_new[:, 0].to(k.dtype)
    v[b, slot] = v_new[:, 0].to(v.dtype)
    return {"k": k, "v": v}


def _decode_self_attention(cfg, q, cache, pos):
    """Self-attention against the cache.  Windowed archs use a ring
    buffer: every stored slot is inside the window by construction, so
    only validity is masked."""
    kv_len = pos + 1  # tokens written so far
    if cfg.window > 0:
        win = cache["k"].shape[1]
        valid = torch.clamp(kv_len, max=win)
        return L.decode_attention(cfg, q, cache["k"], cache["v"], valid,
                                  apply_window=False)
    return L.decode_attention(cfg, q, cache["k"], cache["v"], kv_len)


# ---------------------------------------------------------------------------
# Dense decoder layer (attn + MLP) — llama/yi/command-r/qwen + VLM backbone
# ---------------------------------------------------------------------------


class DenseLayer:
    #: leaves held in float32 whatever the compute dtype (none here;
    #: see :mod:`repro_torch.models.recurrent`)
    FLOAT32 = ()

    @staticmethod
    def init(cfg, gen: torch.Generator):
        return {
            "norm1": L.norm_init(cfg, gen),
            "attn": L.attention_init(cfg, gen),
            "norm2": L.norm_init(cfg, gen),
            "mlp": L.mlp_init(cfg, gen),
        }

    @staticmethod
    def init_cache(cfg, batch, max_len, device=None):
        return kv_cache_init(cfg, batch, max_len, device)

    @staticmethod
    def apply(cfg, params, x, *, mode, cache=None, pos=None, extras=None):
        h = L.norm_apply(cfg, params["norm1"], x)
        if mode == "decode":
            q, k, v = L._project_qkv(cfg, params["attn"], h, pos[:, None])
            cache = _cache_write_token(cfg, cache, k, v, pos)
            attn = _decode_self_attention(cfg, q, cache, pos)
        elif mode == "prefill":
            S = x.shape[1]
            positions = torch.arange(S, device=x.device)[None, :]
            q, k, v = L._project_qkv(cfg, params["attn"], h, positions)
            cache = build_prefill_cache(cfg, k, v, extras["max_len"])
            attn = L.full_attention(cfg, q, k, v)
        else:
            raise ValueError(f"DenseLayer mode {mode!r} is not ported: "
                             f"prefill or decode")
        x = x + attn @ params["attn"]["wo"].to(x.dtype)
        h = L.norm_apply(cfg, params["norm2"], x)
        x = x + L.mlp_apply(cfg, params["mlp"], h)
        return x, cache
