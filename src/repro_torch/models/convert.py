"""Carry the JAX package's parameter tree into the port's model.

The JAX package stacks a dense model's layers on a leading axis
(``{"embed", "final_norm", "stacks": [{"b0": {...}}]}``, every leaf of
``stacks[0]`` shaped (n_layers, ...)).  Given that tree as numpy arrays
(``jax.tree.map(np.asarray, params)``), :func:`params_from_jax` builds
the port's params — one dict per layer, every tensor in the compute
dtype, as :meth:`Model.init` makes them — so the tests can run both
packages on the same weights.  Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import layers as L
from .model_api import stack_plan


def _tensors(tree, dtype, device, index=None):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _tensors(v, dtype, device, index)
        else:
            a = np.asarray(v, dtype=np.float32)
            if index is not None:
                a = a[index]
            out[k] = torch.from_numpy(a.copy()).to(device=device, dtype=dtype)
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
    if len(stacks) != len(plan) or plan[0][0] != ("dense",):
        raise ValueError(f"expected one dense stack, got {len(stacks)}")
    layer_tree = stacks[0]["b0"]
    return {
        "embed": _tensors(tree["embed"], dt, dev),
        "final_norm": _tensors(tree["final_norm"], dt, dev),
        "layers": [_tensors(layer_tree, dt, dev, i)
                   for i in range(cfg.n_layers)],
    }
