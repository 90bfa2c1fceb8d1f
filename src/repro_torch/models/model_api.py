"""Model assembly on torch: block stacks → Model (init / prefill /
decode), the JAX package's ``src/repro/models/model_api.py`` for the
families that are ported.

Params are a plain dict::

    {"embed": {"table", "head"[, "pos"]}, "final_norm": {"scale"[, "bias"]},
     "layers": [one block's dict per layer, in the plan's order]}

with every tensor in the compute dtype (``cfg.dtype``), but for the
leaves a block names in ``FLOAT32`` (read in float32 by the reference).
The reference stacks each group pattern's layers on a leading axis for
``lax.scan``; eager torch walks a flat list, groups in order and each
group's pattern in order (:func:`layer_kinds`;
:func:`repro_torch.models.convert.params_from_jax` flattens the stacked
tree the same way).

Families → stack plans (the ported ones):
  dense / vlm      [("dense",) × L]
  ssm (xlstm)      [("mlstm","slstm") × L/2]
  hybrid (rg)      [("rec","rec","attn") × 8, ("rec","rec") × 1]
MoE and audio raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ArchConfig

from . import layers as L
from .blocks import DenseLayer
from .recurrent import MLSTMLayer, RGLRULayer, SLSTMLayer

_NOT_PORTED = ("moe", "audio")

BLOCKS = {
    "dense": DenseLayer,
    "mlstm": MLSTMLayer,
    "slstm": SLSTMLayer,
    "rec": RGLRULayer,
    "attn": DenseLayer,
}


def stack_plan(cfg: ArchConfig) -> List[Tuple[Tuple[str, ...], int]]:
    if cfg.family in ("dense", "vlm"):
        pattern: Tuple[str, ...] = ("dense",)
    elif cfg.family in ("ssm", "hybrid"):
        pattern = cfg.block_pattern
    elif cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported to repro_torch yet: "
            f"dense, vlm, ssm and hybrid are")
    else:
        raise ValueError(f"unknown family {cfg.family}")
    k = len(pattern)
    full, rest = divmod(cfg.n_layers, k)
    plan = [(pattern, full)]
    if rest:
        plan.append((pattern[:rest], 1))
    return plan


def layer_kinds(cfg: ArchConfig) -> List[str]:
    """The block kind of every layer, in the order the model runs them."""
    return [kind for pattern, groups in stack_plan(cfg)
            for _ in range(groups) for kind in pattern]


def _cast(tree, dtype, keep=()):
    """Every leaf of ``tree`` in ``dtype``, but the top-level leaves
    named in ``keep``, which go to float32."""
    return {k: (_cast(v, dtype) if isinstance(v, dict)
                else v.to(torch.float32 if k in keep else dtype))
            for k, v in tree.items()}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # ---- init ----------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random weights from ``generator``, on its device: uniform in
        ±1/√fan_in for every matrix, the embedding table scaled by
        0.02·√d, norm scales 1 (the reference's distributions, not its
        bits).  Each tensor is made in ``param_dtype`` and cast to the
        compute dtype at once, table by table and layer by layer, so a
        full-width init holds one of them in float32 at a time."""
        cfg = self.cfg
        kinds = layer_kinds(cfg)
        dt = L.cdtype(cfg)
        params: Dict[str, Any] = {
            "embed": L.embed_init(cfg, generator, dt),
            "final_norm": _cast(L.norm_init(cfg, generator), dt),
        }
        params["layers"] = [_cast(BLOCKS[k].init(cfg, generator), dt,
                                  BLOCKS[k].FLOAT32)
                            for k in kinds]
        return params

    # ---- caches ----------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device=None):
        from repro_torch.core.runtime import resolve_device

        dev = resolve_device(device)
        return [BLOCKS[k].init_cache(self.cfg, batch, max_len, dev)
                for k in layer_kinds(self.cfg)]

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
        return x

    def _backbone(self, params, x, *, mode, caches, pos, extras):
        new_caches = []
        for li, kind in enumerate(layer_kinds(self.cfg)):
            c = caches[li] if caches is not None else None
            x, nc = BLOCKS[kind].apply(self.cfg, params["layers"][li], x,
                                       mode=mode, cache=c, pos=pos,
                                       extras=extras)
            new_caches.append(nc)
        return L.norm_apply(self.cfg, params["final_norm"], x), new_caches

    def prefill(self, params, batch, max_len: int):
        """Run the full prompt, returning (last-token logits, caches).
        ``batch``: ``{"tokens": (B, S) int}`` (plus ``"patch_embeds"``
        (B, n_patches, d) for the VLM family, a prefix of the sequence)."""
        x = self._embed(params, batch)
        x, caches = self._backbone(params, x, mode="prefill", caches=None,
                                   pos=None, extras={"max_len": max_len})
        logits = L.lm_logits(self.cfg, params["embed"], x[:, -1:])
        return logits[:, 0], caches

    def decode_step(self, params, caches, token, pos):
        """token: (B,) int; pos: (B,) int positions being generated."""
        cfg = self.cfg
        x = L.embed_tokens(
            cfg, params["embed"], token[:, None],
            pos[:, None] if cfg.pos_embed == "learned" else None)
        x, caches = self._backbone(params, x, mode="decode", caches=caches,
                                   pos=pos, extras=None)
        logits = L.lm_logits(cfg, params["embed"], x)
        return logits[:, 0], caches


def build_model(cfg: ArchConfig) -> Model:
    stack_plan(cfg)
    return Model(cfg)
