"""``tests/test_checkpoint.py`` on the port (``repro_torch.train.checkpoint``):
the roundtrip, atomicity and retention cases, with the on-disk layout
held against the JAX package's in both directions (either package
restores the other's files, the manifests' keys and shapes equal), and
the elastic restore onto a mesh (a one-rank gloo group)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as JC
from repro_torch.train.checkpoint import (latest_step, read_checkpoint,
                                          restore_checkpoint, save_checkpoint)
from repro_torch.tree import leaves

torch.set_num_threads(1)


def tree():
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones((4,)),
                   "layers": [{"s": torch.full((2,), 0.5)},
                              {"s": torch.full((2,), 2.5)}]},
        "opt": {"m": torch.zeros((3, 4)),
                "step": torch.tensor(5, dtype=torch.int32)},
    }


def jtree():
    return {
        "params": {"w": jnp.arange(12.0).reshape(3, 4), "b": jnp.ones((4,)),
                   "layers": [{"s": jnp.full((2,), 0.5)},
                              {"s": jnp.full((2,), 2.5)}]},
        "opt": {"m": jnp.zeros((3, 4)), "step": jnp.asarray(5)},
    }


def test_roundtrip(tmp_path):
    t = tree()
    save_checkpoint(tmp_path, 7, t, extra={"note": "x"})
    restored, step, extra = restore_checkpoint(tmp_path, t)
    assert step == 7 and extra["note"] == "x"
    for a, b in zip(leaves(t), leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_atomicity_ignores_partial_tmp(tmp_path):
    t = tree()
    save_checkpoint(tmp_path, 1, t)
    # simulate a crash mid-write of step 2
    broken = tmp_path / "step_00000002.tmp"
    (broken / "arrays").mkdir(parents=True)
    assert latest_step(tmp_path) == 1
    restored, step, _ = restore_checkpoint(tmp_path, t)
    assert step == 1
    # next save garbage-collects the stale tmp
    save_checkpoint(tmp_path, 3, t)
    assert not broken.exists()


def test_retention(tmp_path):
    t = tree()
    for s in range(1, 6):
        save_checkpoint(tmp_path, s, t, keep=2)
    kept = sorted(p.name for p in tmp_path.iterdir())
    assert kept == ["step_00000004", "step_00000005"]


def test_layout_matches_reference(tmp_path):
    """The port writes the reference's keys, file names and shapes, and
    each package restores the other's checkpoint."""
    t = tree()
    save_checkpoint(tmp_path / "port", 4, t, extra={"a": 1})
    JC.save_checkpoint(tmp_path / "jax", 4, jtree(), extra={"a": 1})
    man = [json.loads((tmp_path / d / "step_00000004" / "manifest.json")
                      .read_text()) for d in ("port", "jax")]
    assert man[0] == man[1]
    # the JAX package restores the port's files, and the port the JAX's
    jrestored, step, extra = JC.restore_checkpoint(tmp_path / "port", jtree())
    assert step == 4 and extra == {"a": 1}
    for a, b in zip(jax.tree.leaves(jrestored), jax.tree.leaves(jtree())):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    restored, step, _ = restore_checkpoint(tmp_path / "jax", t)
    for a, b in zip(leaves(restored), leaves(t)):
        assert torch.equal(a, b)
    # read_checkpoint rebuilds the nested tree (lists from numeric keys)
    raw, step, _ = read_checkpoint(tmp_path / "jax")
    assert isinstance(raw["params"]["layers"], list)
    np.testing.assert_array_equal(raw["params"]["layers"][1]["s"],
                                  np.full((2,), 2.5, np.float32))
    assert int(raw["opt"]["step"]) == 5



@pytest.fixture
def one_rank_gloo():
    """A gloo process group of this process alone, destroyed after."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_elastic_restore_onto_mesh(tmp_path, one_rank_gloo):
    """Checkpoints store global logical arrays → restore onto any mesh:
    each leaf a DTensor of its sharding's placements."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.tree import map_tree

    t = tree()
    save_checkpoint(tmp_path, 2, t)
    mesh = make_mesh((1,), ("data",))
    sh = map_tree(lambda _: NamedSharding(mesh, P()), t)
    restored, step, _ = restore_checkpoint(tmp_path, t, shardings=sh)
    assert step == 2
    w = restored["params"]["w"]
    assert isinstance(w, DTensor)
    assert w.device_mesh == mesh and tuple(w.placements) == (Replicate(),)
    assert torch.equal(w.full_tensor(), t["params"]["w"])
    assert restored["opt"]["step"].to_local().dtype == torch.int32
