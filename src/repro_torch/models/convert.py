"""Carry the JAX package's parameter tree into the port's model.

The JAX package stacks a model's layers by its stack plan
(``{"embed", "final_norm", "stacks": [...]}``): stack ``si`` repeats a
group pattern ``G`` times, and ``stacks[si][f"b{i}"]`` holds the
pattern's i-th block with every leaf shaped (G, ...).  Given that tree
as numpy arrays (``jax.tree.map(np.asarray, params)``),
:func:`params_from_jax` builds the port's params — one dict per layer,
groups in order and each group's pattern in order, every tensor in the
compute dtype but a block's ``FLOAT32`` leaves, as :meth:`Model.init`
makes them — so the tests can run both packages on the same weights.
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


def params_from_jax(cfg, tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The port's params from the JAX package's tree of arrays (float32,
    the reference's ``param_dtype``).  ``device=None`` is CUDA (raising
    without it), as for every entry point of the port."""
    from repro_torch.core.runtime import resolve_device

    plan = stack_plan(cfg)
    dev = resolve_device(device)
    dt = L.cdtype(cfg)
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
    return {
        "embed": _tensors(tree["embed"], dt, dev),
        "final_norm": _tensors(tree["final_norm"], dt, dev),
        "layers": layers,
    }
