"""Carry the JAX package's parameter tree into the port's model.

The JAX package stacks a model's layers by its stack plan
(``{"embed", "final_norm", "stacks": [...]}``): stack ``si`` repeats a
group pattern ``G`` times, and ``stacks[si][f"b{i}"]`` holds the
pattern's i-th block with every leaf shaped (G, ...); the audio
family's encoder is ``enc_stack["b0"]`` with leaves (L_enc, ...), beside
``enc_norm`` and ``enc_pos``.  Given that tree as numpy arrays
(``jax.tree.map(np.asarray, params)``), :func:`params_from_jax` builds
the port's params — one dict per layer, groups in order and each group's
pattern in order, every tensor in ``dtype`` (default the compute dtype)
but a block's ``FLOAT32`` leaves, as :meth:`Model.init` makes them — so
the tests can run both packages on the same weights.  An AdamW moment
tree (``m`` or ``v``) has the params' structure and converts the same
way; :func:`train_state_from_jax` converts a whole training state.
Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import layers as L
from .model_api import BLOCKS, stack_plan


def _tensors(tree, dtype, device, index=None, keep=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _tensors(v, dtype, device, index)
        else:
            a = np.asarray(v, dtype=np.float32)
            if index is not None:
                a = a[index]
            out[k] = torch.from_numpy(a.copy()).to(
                device=device, dtype=torch.float32 if k in keep else dtype)
    return out


def params_from_jax(cfg, tree: Dict[str, Any], device=None,
                    dtype=None) -> Dict[str, Any]:
    """The port's params from the JAX package's tree of arrays (float32,
    the reference's ``param_dtype``), in ``dtype`` (default the compute
    dtype; float32 for training).  ``device=None`` is CUDA (raising
    without it), as for every entry point of the port."""
    from repro_torch.core.runtime import resolve_device

    plan = stack_plan(cfg)
    dev = resolve_device(device)
    dt = L.cdtype(cfg) if dtype is None else L.torch_dtype(dtype)
    stacks = tree["stacks"]
    if len(stacks) != len(plan):
        raise ValueError(f"expected {len(plan)} stacks for the plan "
                         f"{plan}, got {len(stacks)}")
    layers = []
    for (pattern, groups), stack in zip(plan, stacks):
        for g in range(groups):
            for i, kind in enumerate(pattern):
                keep = BLOCKS[kind].FLOAT32
                layers.append(_tensors(stack[f"b{i}"], dt, dev, g, keep))
    out = {
        "embed": _tensors(tree["embed"], dt, dev),
        "final_norm": _tensors(tree["final_norm"], dt, dev),
        "layers": layers,
    }
    if cfg.family == "audio":
        enc = tree["enc_stack"]["b0"]
        out["enc_layers"] = [_tensors(enc, dt, dev, g)
                             for g in range(cfg.n_enc_layers)]
        out["enc_norm"] = _tensors(tree["enc_norm"], dt, dev)
        out["enc_pos"] = torch.from_numpy(
            np.asarray(tree["enc_pos"], np.float32).copy()).to(dev, dt)
    return out


def train_state_from_jax(cfg, tree: Dict[str, Any], device=None):
    """The port's training state ``{"params", "opt": {"m", "v", "step"}}``
    from the JAX package's (a ``Trainer``'s ``{"params", "opt"}`` as
    arrays), every leaf float32 as the reference holds it, the step an
    int32 scalar."""
    from repro_torch.core.runtime import resolve_device

    dev = resolve_device(device)
    opt = tree["opt"]
    return {
        "params": params_from_jax(cfg, tree["params"], dev, torch.float32),
        "opt": {"m": params_from_jax(cfg, opt["m"], dev, torch.float32),
                "v": params_from_jax(cfg, opt["v"], dev, torch.float32),
                "step": torch.tensor(int(np.asarray(opt["step"])),
                                     dtype=torch.int32, device=dev)},
    }
