"""Mesh construction over the current process group: the JAX package's
``src/repro/launch/mesh.py`` (and its ``distributed/compat.make_mesh``)
on ``torch.distributed.device_mesh``.  The production meshes are 16×16
(256 ranks) or 2×16×16 (512); the dry-run fakes those ranks with torch's
``fake`` process-group backend."""

from __future__ import annotations

from typing import Sequence

from repro_torch.distributed.sharding import (
    MULTI_POD_RULES,
    SINGLE_POD_RULES,
    AxisRules,
)

__all__ = ["make_mesh", "make_production_mesh", "rules_for_mesh",
           "make_local_mesh"]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device_type: str = None):
    """A ``DeviceMesh`` of ``shape`` with named dims over the current
    process group (whose world size must be the product of ``shape``);
    ``device_type`` defaults to ``"cuda"`` when the group's backend is
    NCCL, else ``"cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16×16 single-pod (256 ranks) or 2×16×16 two-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_local_mesh(data: int = 1, model: int = 1, device_type=None):
    """A small ``("data", "model")`` mesh (tests, one card)."""
    return make_mesh((data, model), ("data", "model"), device_type)


def rules_for_mesh(mesh, overrides=None) -> AxisRules:
    base = MULTI_POD_RULES if "pod" in mesh.mesh_dim_names \
        else SINGLE_POD_RULES
    rules = dict(base)
    if overrides:
        rules.update(overrides)
    return AxisRules(rules, mesh=mesh)
