"""Abstract input specs + shardings for every (arch × shape) cell, the
JAX package's ``src/repro/launch/specs.py`` on torch.

``input_specs(cfg, shape)`` returns shape-only tensors (fake tensors, no
storage) for every input of the step — nothing is allocated:

* train:   (params, opt_state, batch)
* prefill: (params, batch)
* decode:  (params, caches, token, pos)

Params are float32, the reference's ``param_dtype`` (the layers cast
them to the compute dtype at every use, as the reference's do).
``input_shardings`` gives :class:`NamedSharding` trees of the same
structure; the dry-run turns each into DTensor placements.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed.sharding import AxisRules, resolve_spec_tree
from repro_torch.models import layers as L
from repro_torch.models.model_api import (Model, batch_sharding_specs,
                                          batch_specs, build_model)
from repro_torch.optim.adamw import adamw_init, opt_state_specs

__all__ = ["input_specs", "input_shardings", "abstract_params"]


def _shape_only():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def abstract_params(model: Model):
    with _shape_only():
        return model.init(torch.Generator(), dtype=L.pdtype(model.cfg))


def _abstract_opt(params):
    with _shape_only():
        return adamw_init(params)


def _abstract_caches(model: Model, shape: ShapeSpec):
    with _shape_only():
        return model.init_cache(shape.global_batch, shape.seq_len,
                                device="cpu")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[Any, ...]:
    model = build_model(cfg)
    params = abstract_params(model)
    batch = batch_specs(cfg, shape)
    if shape.kind == "train":
        return (params, _abstract_opt(params), batch)
    if shape.kind == "prefill":
        return (params, batch)
    return (params, _abstract_caches(model, shape), batch["token"],
            batch["pos"])


def input_shardings(cfg: ArchConfig, shape: ShapeSpec, rules: AxisRules):
    """NamedShardings matching input_specs' structure (dim-aware)."""
    model = build_model(cfg)
    params = abstract_params(model)
    p_sh = resolve_spec_tree(model.param_specs(), rules, params)
    b_specs = batch_specs(cfg, shape)
    b_sh = resolve_spec_tree(batch_sharding_specs(cfg, shape), rules,
                             b_specs)
    if shape.kind == "train":
        o_sh = resolve_spec_tree(opt_state_specs(model.param_specs()),
                                 rules, _abstract_opt(params))
        return (p_sh, o_sh, b_sh)
    if shape.kind == "prefill":
        return (p_sh, b_sh)
    c_sh = resolve_spec_tree(model.cache_specs(), rules,
                             _abstract_caches(model, shape))
    return (p_sh, c_sh, b_sh["token"], b_sh["pos"])
