"""Model assembly on torch: block stacks → Model (init / loss / prefill /
decode), the JAX package's ``src/repro/models/model_api.py``.

Params are a plain dict::

    {"embed": {"table", "head"[, "pos"]}, "final_norm": {"scale"[, "bias"]},
     "layers": [one block's dict per layer, in the plan's order]
     [, "enc_layers": [...], "enc_norm": {...}, "enc_pos": (enc_seq, d)]}

(the last three for the audio family's encoder), every tensor in one
dtype: the compute dtype (``cfg.dtype``) for serving, float32 master
weights for training (:meth:`Model.init`'s ``dtype``), but for the
leaves a block names in ``FLOAT32`` (read in float32 by the reference),
which stay float32.  The reference keeps ``param_dtype`` float32 and
casts at every use; the layers here cast at every use too, so both
holdings run the same arithmetic.  The reference stacks each group
pattern's layers on a leading axis for ``lax.scan``; eager torch walks a
flat list, groups in order and each group's pattern in order
(:func:`layer_kinds`; :func:`repro_torch.models.convert.params_from_jax`
flattens the stacked tree the same way).  :meth:`Model.param_specs` and
:meth:`Model.cache_specs` follow the flat layout: a layer's leaf takes
the reference's stacked spec without its leading ``None``.

Families → stack plans:
  dense / vlm      [("dense",) × L]
  moe              [("moe",) × L]
  audio (whisper)  encoder [("enc",) × L_enc] + decoder [("cross",) × L]
  ssm (xlstm)      [("mlstm","slstm") × L/2]
  hybrid (rg)      [("rec","rec","attn") × 8, ("rec","rec") × 1]
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed.sharding import P, shard
from repro_torch.tree import leaves_with_paths

from . import layers as L
from .blocks import CrossLayer, DenseLayer, EncoderLayer, MoELayer
from .recurrent import MLSTMLayer, RGLRULayer, SLSTMLayer

BLOCKS = {
    "dense": DenseLayer,
    "moe": MoELayer,
    "enc": EncoderLayer,
    "cross": CrossLayer,
    "mlstm": MLSTMLayer,
    "slstm": SLSTMLayer,
    "rec": RGLRULayer,
    "attn": DenseLayer,
}


def stack_plan(cfg: ArchConfig) -> List[Tuple[Tuple[str, ...], int]]:
    if cfg.family in ("dense", "vlm"):
        pattern: Tuple[str, ...] = ("dense",)
    elif cfg.family == "moe":
        pattern = ("moe",)
    elif cfg.family == "audio":
        pattern = ("cross",)
    elif cfg.family in ("ssm", "hybrid"):
        pattern = cfg.block_pattern
    else:
        raise ValueError(f"unknown family {cfg.family}")
    k = len(pattern)
    full, rest = divmod(cfg.n_layers, k)
    plan = [(pattern, full)]
    if rest:
        plan.append((pattern[:rest], 1))
    return plan


def layer_kinds(cfg: ArchConfig) -> List[str]:
    """The block kind of every (decoder) layer, in the order the model
    runs them."""
    return [kind for pattern, groups in stack_plan(cfg)
            for _ in range(groups) for kind in pattern]


def _cast(tree, dtype, keep=()):
    """Every leaf of ``tree`` in ``dtype``, but the top-level leaves
    named in ``keep``, which go to float32."""
    return {k: (_cast(v, dtype) if isinstance(v, dict)
                else v.to(torch.float32 if k in keep else dtype))
            for k, v in tree.items()}


def _apply_layer(block, cfg, params, x, *, remat, **kw):
    """One layer; in train mode with ``remat`` and grad on, its
    activations are recomputed in the backward pass rather than kept
    (the reference's ``jax.checkpoint`` of a group)."""
    if remat and kw["mode"] == "train" and torch.is_grad_enabled():
        return checkpoint(lambda h: block.apply(cfg, params, h, **kw), x,
                          use_reentrant=False)
    return block.apply(cfg, params, x, **kw)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # ---- init ----------------------------------------------------------------
    def init(self, generator: torch.Generator, dtype=None) -> Dict[str, Any]:
        """Random weights from ``generator``, on its device: uniform in
        ±1/√fan_in for every matrix, the embedding table scaled by
        0.02·√d, norm scales 1 (the reference's distributions, not its
        bits).  Each tensor is made in ``param_dtype`` and cast to
        ``dtype`` (default the compute dtype; float32 for training's
        master weights) at once, table by table and layer by layer, so a
        full-width init holds one of them in float32 at a time."""
        cfg = self.cfg
        dt = L.cdtype(cfg) if dtype is None else L.torch_dtype(dtype)
        params: Dict[str, Any] = {
            "embed": L.embed_init(cfg, generator, dt),
            "final_norm": _cast(L.norm_init(cfg, generator), dt),
        }
        params["layers"] = [_cast(BLOCKS[k].init(cfg, generator), dt,
                                  BLOCKS[k].FLOAT32)
                            for k in layer_kinds(cfg)]
        if cfg.family == "audio":
            params["enc_layers"] = [
                _cast(EncoderLayer.init(cfg, generator), dt)
                for _ in range(cfg.n_enc_layers)]
            params["enc_norm"] = _cast(L.norm_init(cfg, generator), dt)
            params["enc_pos"] = (L.dense_init(generator, (cfg.enc_seq,
                                                          cfg.d_model))
                                 * 0.02).to(dt)
        return params

    def param_specs(self) -> Dict[str, Any]:
        """Logical partition specs of :meth:`init`'s tree."""
        cfg = self.cfg
        specs: Dict[str, Any] = {
            "embed": L.embed_spec(cfg),
            "final_norm": L.norm_spec(cfg),
            "layers": [BLOCKS[k].spec(cfg) for k in layer_kinds(cfg)],
        }
        if cfg.family == "audio":
            specs["enc_layers"] = [EncoderLayer.spec(cfg)
                                   for _ in range(cfg.n_enc_layers)]
            specs["enc_norm"] = L.norm_spec(cfg)
            specs["enc_pos"] = P(None, "fsdp")
        return specs

    # ---- caches ----------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device=None):
        from repro_torch.core.runtime import resolve_device

        dev = resolve_device(device)
        return [BLOCKS[k].init_cache(self.cfg, batch, max_len, dev)
                for k in layer_kinds(self.cfg)]

    def cache_specs(self):
        return [BLOCKS[k].cache_spec(self.cfg) for k in layer_kinds(self.cfg)]

    # ---- forward ---------------------------------------------------------------
    def _embed(self, params, batch):
        cfg = self.cfg
        tokens = batch["tokens"]
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        x = L.embed_tokens(cfg, params["embed"], tokens,
                           pos if cfg.pos_embed == "learned" else None)
        if cfg.family == "vlm":
            patches = batch["patch_embeds"].to(x.dtype)
            x = torch.cat([patches, x], dim=1)
            x = shard(x, "batch", "res_seq", "dmodel")
        return x

    def _encode(self, params, frames, *, remat: bool = True):
        """The audio encoder over frame embeddings (B, enc_seq, d)."""
        cfg = self.cfg
        x = frames.to(L.cdtype(cfg))
        x = x + params["enc_pos"].to(x.dtype)[None]
        x = shard(x, "batch", "res_seq", "dmodel")
        for p in params["enc_layers"]:
            x, _ = _apply_layer(EncoderLayer, cfg, p, x, remat=remat,
                                mode="train", cache=None, pos=None,
                                extras=None)
        return L.norm_apply(cfg, params["enc_norm"], x)

    def _backbone(self, params, x, *, mode, caches, pos, extras,
                  remat: bool = False):
        new_caches = []
        for li, kind in enumerate(layer_kinds(self.cfg)):
            c = caches[li] if caches is not None else None
            x, nc = _apply_layer(BLOCKS[kind], self.cfg, params["layers"][li],
                                 x, remat=remat, mode=mode, cache=c, pos=pos,
                                 extras=extras)
            new_caches.append(nc)
        return L.norm_apply(self.cfg, params["final_norm"], x), new_caches

    def loss(self, params, batch, *, remat: bool = True,
             probe: bool = False):
        """Mean next-token cross-entropy of ``batch`` (``tokens``,
        ``labels`` (B, S) with -100 ignored; plus ``patch_embeds`` for
        the VLM family, whose loss covers the text positions only, or
        ``frames`` (B, enc_seq, d) for the audio family).  ``remat``
        recomputes each layer's activations in the backward pass.
        ``probe`` (the dry-run's roofline probes) keeps every activation,
        each layer's and each loss chunk's, as the reference's probes
        run unrolled with no checkpoint."""
        remat = remat and not probe
        cfg = self.cfg
        x = self._embed(params, batch)
        extras = None
        if cfg.family == "audio":
            extras = {"enc": self._encode(params, batch["frames"],
                                          remat=remat)}
        x, _ = self._backbone(params, x, mode="train", caches=None, pos=None,
                              extras=extras, remat=remat)
        labels = batch["labels"]
        if cfg.family == "vlm":  # loss only over text positions
            x = x[:, -labels.shape[1]:]
        return L.xent_loss(cfg, params["embed"], x, labels,
                           remat=not probe)

    def prefill(self, params, batch, max_len: int):
        """Run the full prompt, returning (last-token logits, caches).
        ``batch``: ``{"tokens": (B, S) int}`` (plus ``"patch_embeds"``
        (B, n_patches, d) for the VLM family, a prefix of the sequence,
        or ``"frames"`` (B, enc_seq, d) for the audio family, which the
        encoder reads and every decoder layer's cache keeps as keys and
        values)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        extras = {"max_len": max_len}
        if cfg.family == "audio":
            extras["enc"] = self._encode(params, batch["frames"])
        x, caches = self._backbone(params, x, mode="prefill", caches=None,
                                   pos=None, extras=extras)
        logits = L.lm_logits(cfg, params["embed"], x[:, -1:])
        return logits[:, 0], caches

    def decode_step(self, params, caches, token, pos, *,
                    donate: bool = False):
        """token: (B,) int; pos: (B,) int positions being generated.
        ``donate`` writes the new token's keys and values, and the
        recurrent states, into ``caches`` in place and returns them (the
        reference's serve step donates its caches); otherwise the caches
        given are left as they were."""
        cfg = self.cfg
        x = L.embed_tokens(
            cfg, params["embed"], token[:, None],
            pos[:, None] if cfg.pos_embed == "learned" else None)
        x, caches = self._backbone(params, x, mode="decode", caches=caches,
                                   pos=pos,
                                   extras={"donate": True} if donate
                                   else None)
        logits = L.lm_logits(cfg, params["embed"], x)
        return logits[:, 0], caches

    # ---- accounting -----------------------------------------------------------
    def param_shapes(self) -> Dict[str, Any]:
        """The params' tree with shape-only tensors (no storage): the
        reference's ``jax.eval_shape(self.init, ...)``."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        gen = torch.Generator()
        with FakeTensorMode():
            return self.init(gen)

    def param_counts(self) -> Dict[str, float]:
        """total / active / embedding parameter counts (analytic, from
        shape-only init; the reference's rule: embeddings are the table,
        head and positions, and an expert matrix counts top_k/n_experts
        of itself as active)."""
        total = active = embed = 0.0
        cfg = self.cfg
        k_over_e = cfg.top_k / cfg.n_experts if cfg.is_moe else 1.0
        for path, leaf in leaves_with_paths(self.param_shapes()):
            n = float(leaf.numel())
            total += n
            if any(k in ("table", "head", "pos", "enc_pos") for k in path):
                embed += n
                continue
            is_expert = "moe" in path and any(
                k in ("w_in", "w_gate", "w_out") for k in path)
            active += n * (k_over_e if is_expert else 1.0)
        return {"total": total, "active": active, "embed": embed}

    def model_flops(self, shape: ShapeSpec) -> float:
        """MODEL_FLOPS per step: 6·N_active·tokens (train) or
        2·N_active·tokens (decode/prefill fwd-only), N excl. embeddings
        but incl. the LM head matmul."""
        n = self.param_counts()["active"]
        head = 0.0 if self.cfg.family == "audio" \
            else self.cfg.d_model * self.cfg.vocab
        n = n + head
        if shape.kind == "train":
            return 6.0 * n * shape.seq_len * shape.global_batch
        if shape.kind == "prefill":
            return 2.0 * n * shape.seq_len * shape.global_batch
        return 2.0 * n * shape.global_batch  # decode: one token / seq

    def recurrent_correction_flops(self, shape: ShapeSpec) -> float:
        """Analytic FLOPs of the sLSTM's sequential recurrence, which
        the reference adds to its probe-derived XLA counts (XLA counts a
        loop body once).  The port's count covers every step already; the
        dry-run records this for the same tables and its roofline does
        not add it."""
        cfg = self.cfg
        if cfg.family != "ssm" or shape.kind == "decode":
            return 0.0
        n_slstm = sum(pattern.count("slstm") * G
                      for pattern, G in stack_plan(cfg))
        f = SLSTMLayer.recurrent_flops(cfg, shape.global_batch,
                                       shape.seq_len)
        mult = 3.0 if shape.kind == "train" else 1.0  # fwd+bwd≈2x +remat fwd
        return n_slstm * f * mult


def build_model(cfg: ArchConfig) -> Model:
    stack_plan(cfg)
    return Model(cfg)


# ---------------------------------------------------------------------------
# batch shape specs (abstract inputs for the dry-run)
# ---------------------------------------------------------------------------


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Shape-only model inputs (meta-device tensors) for an (arch, shape)
    cell."""
    B, S = shape.global_batch, shape.seq_len

    def t(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            s_txt = S - cfg.n_patches
            d = {"tokens": t((B, s_txt)), "labels": t((B, s_txt)),
                 "patch_embeds": t((B, cfg.n_patches, cfg.d_model),
                                   L.cdtype(cfg))}
        elif cfg.family == "audio":
            d = {"tokens": t((B, S)), "labels": t((B, S)),
                 "frames": t((B, cfg.enc_seq, cfg.d_model), L.cdtype(cfg))}
        else:
            d = {"tokens": t((B, S)), "labels": t((B, S))}
        if shape.kind == "prefill":
            d.pop("labels")
        return d
    # decode: one token; the KV/state cache is a separate argument
    return {"token": t((B,)), "pos": t((B,))}


def batch_sharding_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, P]:
    if shape.kind in ("train", "prefill"):
        out = {"tokens": P("batch", None)}
        if shape.kind == "train":
            out["labels"] = P("batch", None)
        if cfg.family == "vlm":
            out["patch_embeds"] = P("batch", None, None)
        if cfg.family == "audio":
            out["frames"] = P("batch", None, None)
        return out
    return {"token": P("batch"), "pos": P("batch")}
