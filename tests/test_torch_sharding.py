"""``tests/test_sharding.py`` on the port (``repro_torch.distributed``),
and the port's specs and rule-dependent choices held against the JAX
package's on the CPU: every arch's param and cache specs under both rule
sets (a 16-wide axis stubbed in, as ``test_divisibility_guard_replicates``
does), the dropped shardings, the GQA repeat, the MoE dispatch groups,
the analytic FLOP and parameter counts of every cell, and the shapes and
dtypes of the dry-run's inputs.  The port's meshes are DeviceMeshes over
a ``fake`` process group of 16 ranks (this process rank 0)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import base as JCB
from repro.distributed import sharding as JS
from repro.distributed.compat import make_mesh as jax_make_mesh
from repro.launch import specs as JSP
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import model_api as JM
from repro_torch.configs.base import ARCH_IDS, SHAPES, cells_for, get_config
from repro_torch.distributed.sharding import (MULTI_POD_RULES,
                                              SINGLE_POD_RULES, AxisRules,
                                              NamedSharding, P, placements,
                                              resolve_spec, resolve_spec_tree,
                                              shard, use_rules)
from repro_torch.launch import specs as TSP
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import model_api as TM
from repro_torch.tree import leaves_with_paths

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fake16():
    """A ``fake`` process group of 16 ranks, destroyed after the module."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_4x4(fake16):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh((4, 4), ("data", "model"), "cpu")


# ---------------------------------------------------------------------------
# the reference's six cases
# ---------------------------------------------------------------------------


def test_spec_resolution_basic():
    rules = AxisRules(dict(SINGLE_POD_RULES), mesh=None)
    assert rules.spec("batch", None, "heads") == P(("data",), None,
                                                   ("model",))


def test_divisibility_guard_replicates(mesh_4x4):
    rules16 = AxisRules(dict(SINGLE_POD_RULES), mesh=mesh_4x4)
    # fake a 16-wide axis by checking the arithmetic path directly
    rules16.mesh_size = lambda axes: 16
    assert rules16.entry("heads", 40) is None  # 40 % 16 != 0 → replicate
    assert rules16.entry("heads", 32) is not None
    assert ("heads", 40, ("model",)) in rules16.dropped


def test_multi_pod_batch_axes():
    rules = AxisRules(dict(MULTI_POD_RULES), mesh=None)
    assert rules.axes_for("batch") == ("pod", "data")


def test_resolve_spec_with_dims(mesh_4x4):
    rules = AxisRules(dict(SINGLE_POD_RULES), mesh=mesh_4x4)
    p = resolve_spec(P("batch", "vocab"), rules, (8, 100))
    assert p == P(("data",), ("model",))
    assert p == rules.spec("batch", "vocab", dims=(8, 100))


def test_unknown_logical_axis_raises():
    rules = AxisRules(dict(SINGLE_POD_RULES), mesh=None)
    with pytest.raises(KeyError):
        rules.axes_for("bogus")


def test_shard_noop_without_mesh():
    x = torch.ones((4, 4))
    assert shard(x, "batch", None) is x


# ---------------------------------------------------------------------------
# specs → DTensor placements
# ---------------------------------------------------------------------------


def test_placements_of_resolved_specs(fake16):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_mesh

    m2 = make_mesh((4, 4), ("data", "model"), "cpu")
    m3 = make_mesh((2, 2, 4), ("pod", "data", "model"), "cpu")
    assert placements(P(("data",), None, ("model",)), m2) == (
        Shard(0), Shard(2))
    assert placements(P(None, ("model",)), m2) == (Replicate(), Shard(1))
    assert placements(P(), m2) == (Replicate(), Replicate())
    # ("pod", "data") on one dim: pod-major, as JAX shards it
    assert placements(P(("pod", "data"), ("model",)), m3) == (
        Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="mesh's dim order"):
        placements(P(("data", "pod")), m3)
    with pytest.raises(ValueError, match="used twice"):
        placements(P(("model",), ("model",)), m2)
    assert NamedSharding(m2, P(("data",))).placements == (Shard(0),
                                                          Replicate())


def test_shard_redistributes_a_dtensor(mesh_4x4):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = distribute_tensor(torch.arange(32.0).reshape(8, 4), mesh_4x4,
                          [Replicate(), Replicate()])
    with use_rules(AxisRules(dict(SINGLE_POD_RULES), mesh=mesh_4x4)):
        y = shard(x, "batch", "heads")
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert tuple(y.to_local().shape) == (2, 1)  # rank 0's shard
        z = shard(x, "batch", None)
        assert tuple(z.placements) == (Shard(0), Replicate())
        # a plain tensor under a mesh is returned as it is
        t = torch.ones(8, 4)
        assert shard(t, "batch", None) is t


def test_refuse_dtensor_on_a_kernel(mesh_4x4):
    """A DTensor never reaches a CUDA kernel: the wrappers' CUDA branch
    refuses it (here the check alone, on a CPU DTensor)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels._build import refuse_dtensor

    x = distribute_tensor(torch.ones(4, 4), mesh_4x4,
                          [Replicate(), Replicate()])
    with pytest.raises(TypeError, match="not DTensors"):
        refuse_dtensor("rg_lru", torch.ones(2), x)
    refuse_dtensor("rg_lru", torch.ones(2))


# ---------------------------------------------------------------------------
# every arch's specs against the reference's (a 16-wide axis stubbed in)
# ---------------------------------------------------------------------------


def _rules_pair(multi: bool, width: int):
    """Both packages' rules on meshes of the rule set's axes, every mesh
    size stubbed to ``width``."""
    from repro_torch.launch.mesh import make_mesh

    axes = ("pod", "data", "model") if multi else ("data", "model")
    base_j = JS.MULTI_POD_RULES if multi else JS.SINGLE_POD_RULES
    base_t = MULTI_POD_RULES if multi else SINGLE_POD_RULES
    jr = JS.AxisRules(dict(base_j),
                      mesh=jax_make_mesh((1,) * len(axes), axes))
    tr = AxisRules(dict(base_t),
                   mesh=make_mesh((2, 2, 4) if multi else (4, 4), axes,
                                  "cpu"))
    jr.mesh_size = lambda axes: width
    tr.mesh_size = lambda axes: width
    return jr, tr


def _unstack(cfg, ref_tree, per_leaf):
    """The reference's stacked tree → the port's flat layout: each layer
    takes its group's leaves through ``per_leaf`` (dropping the leading
    group entry or dim); the encoder's likewise."""
    layers = []
    for (pattern, groups), stack in zip(TM.stack_plan(cfg),
                                        ref_tree["stacks"]):
        for _ in range(groups):
            for i in range(len(pattern)):
                layers.append(jax.tree.map(per_leaf, stack[f"b{i}"],
                                           is_leaf=_is_leaf))
    out = {k: v for k, v in ref_tree.items()
           if k not in ("stacks", "enc_stack")}
    out["layers"] = layers
    if "enc_stack" in ref_tree:
        out["enc_layers"] = [
            jax.tree.map(per_leaf, ref_tree["enc_stack"]["b0"],
                         is_leaf=_is_leaf)
            for _ in range(cfg.n_enc_layers)]
    return out


def _is_leaf(x):
    return isinstance(x, (JP, jax.sharding.NamedSharding,
                          jax.ShapeDtypeStruct))


def _flat(tree):
    """{path string: leaf} of a nested dict/list tree."""
    out = {}
    for path, leaf in leaves_with_paths(tree):
        out["/".join(map(str, path))] = leaf
    return out


def _ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_leaf)
    out = {}
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = leaf
    return out


def _canon(spec):
    """A spec's entries in one form (a jax PartitionSpec may hold a
    one-name entry as the bare name)."""
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_specs_match_reference(arch, multi, fake16):
    cfg = get_config(arch)
    jcfg = JCB.get_config(arch)
    jr, tr = _rules_pair(multi, 16)
    with JS.use_rules(jr):
        jm = JM.build_model(jcfg)
        jshapes = jax.eval_shape(jm.init, jax.random.key(0))
        jp = JS.resolve_spec_tree(jm.param_specs(), jr, jshapes)
        jcache = jax.eval_shape(lambda: jm.init_cache(8, 64))
        jc = JS.resolve_spec_tree(jm.cache_specs(), jr, jcache)
    with use_rules(tr):
        tm = TM.build_model(cfg)
        tp = resolve_spec_tree(tm.param_specs(), tr,
                               TSP.abstract_params(tm))
        tcache = TSP._abstract_caches(tm, dataclasses.replace(
            SHAPES["decode_32k"], global_batch=8, seq_len=64))
        tc = resolve_spec_tree(tm.cache_specs(), tr, tcache)

    drop = lambda s: JP(*tuple(s.spec)[1:])  # noqa: E731  stacked axis
    spec = lambda v: _canon(v if isinstance(v, JP) else v.spec)  # noqa: E731
    want = {k: spec(v) for k, v in _ref_flat(_unstack(cfg, jp, drop)).items()}
    got = {k: _canon(v.spec) for k, v in _flat(tp).items()}
    assert got == want
    want_c = {k: spec(v) for k, v in _ref_flat(
        _unstack(cfg, {"stacks": jc}, drop)["layers"]).items()}
    got_c = {k: _canon(v.spec) for k, v in _flat(tc).items()}
    assert got_c == want_c
    assert set(tr.dropped) == set(jr.dropped)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_kv_repeat_and_attn_dims_at_tp16(arch, fake16):
    cfg, jcfg = get_config(arch), JCB.get_config(arch)
    jr, tr = _rules_pair(False, 16)
    with JS.use_rules(jr):
        want = (JL.kv_repeat_factor(jcfg), JL.attn_dims(jcfg),
                JL.kv_heads_shardable(jcfg))
    with use_rules(tr):
        got = (TL.kv_repeat_factor(cfg), TL.attn_dims(cfg),
               TL.kv_heads_shardable(cfg))
    assert got[0] == want[0]
    assert dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
    assert got[2] == want[2]
    # without a mesh every choice is 1
    assert TL.kv_repeat_factor(cfg) == 1


@pytest.mark.parametrize("arch", ["yi_9b", "llama3_8b"])
def test_gqa_repeat_gives_the_same_attention(arch):
    """A repeated KV head is a copy: the smoke model's loss is the same
    with a model axis as wide as the heads stubbed in (repeat > 1) as
    without."""
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    model = TM.build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
    batch = {"tokens": tok, "labels": tok}
    base = model.loss(params, batch, remat=False)
    rules = AxisRules(dict(SINGLE_POD_RULES), mesh=None)
    rules.mesh_size = lambda axes: cfg.n_heads
    with use_rules(rules):
        assert TL.kv_repeat_factor(cfg) > 1
        rep = model.loss(params, batch, remat=False)
    np.testing.assert_allclose(rep.item(), base.item(), rtol=1e-6)


def test_moe_apply_in_four_groups_matches_reference():
    cfg = dataclasses.replace(get_config("granite_moe_3b_a800m").smoke(),
                              dtype="float32")
    jcfg = dataclasses.replace(JCB.get_config("granite_moe_3b_a800m")
                               .smoke(), dtype="float32")
    jp = JB.moe_init(jcfg, jax.random.key(3))
    x = np.random.default_rng(3).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    jr = JS.AxisRules(dict(JS.SINGLE_POD_RULES), mesh=None)
    tr = AxisRules(dict(SINGLE_POD_RULES), mesh=None)
    jr.mesh_size = lambda axes: 4
    tr.mesh_size = lambda axes: 4
    with JS.use_rules(jr):
        assert JB._moe_groups(64) == 4
        want = np.asarray(JB.moe_apply(jcfg, jp, jnp.asarray(x)))
    with use_rules(tr):
        assert TB._moe_groups(64) == 4
        got, routing = TB.moe_apply(
            cfg, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()},
            torch.from_numpy(x), return_routing=True)
    assert routing["capacity"] == TB.moe_capacity(cfg, 16)
    err = np.max(np.abs(got.numpy() - want))
    assert err <= 1e-5 * max(1.0, np.max(np.abs(want))), err


# ---------------------------------------------------------------------------
# analytic counts and the dry-run's inputs
# ---------------------------------------------------------------------------

CELLS = [(a, s) for a in ARCH_IDS for s in cells_for(a)]


def test_there_are_32_cells():
    assert len(CELLS) == 32


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_flop_and_param_counts_match_reference(arch):
    tm = TM.build_model(get_config(arch))
    jm = JM.build_model(JCB.get_config(arch))
    assert tm.param_counts() == jm.param_counts()
    for shape in cells_for(arch):
        assert tm.model_flops(SHAPES[shape]) == jm.model_flops(
            JCB.SHAPES[shape]), shape
        assert (tm.recurrent_correction_flops(SHAPES[shape])
                == jm.recurrent_correction_flops(JCB.SHAPES[shape])), shape


def _sd(t):
    """(shape, dtype name) of a tensor or ShapeDtypeStruct."""
    if isinstance(t, torch.Tensor):
        return tuple(t.shape), str(t.dtype).replace("torch.", "")
    return tuple(t.shape), jnp.dtype(t.dtype).name


@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_and_input_specs_match_reference(arch, shape):
    cfg, jcfg = get_config(arch), JCB.get_config(arch)
    tb = TM.batch_specs(cfg, SHAPES[shape])
    jb = JM.batch_specs(jcfg, JCB.SHAPES[shape])
    assert {k: _sd(v) for k, v in tb.items()} == {
        k: _sd(v) for k, v in jb.items()}
    assert {k: _canon(v) for k, v in TM.batch_sharding_specs(
        cfg, SHAPES[shape]).items()} == {
        k: _canon(v) for k, v in JM.batch_sharding_specs(
            jcfg, JCB.SHAPES[shape]).items()}
    got = TSP.input_specs(cfg, SHAPES[shape])
    want = JSP.input_specs(jcfg, JCB.SHAPES[shape])
    assert len(got) == len(want)
    drop = lambda s: jax.ShapeDtypeStruct(s.shape[1:], s.dtype)  # noqa: E731
    params_w = _ref_flat(_unstack(cfg, want[0], drop))
    assert {k: _sd(v) for k, v in _flat(got[0]).items()} == {
        k: _sd(v) for k, v in params_w.items()}
    kind = SHAPES[shape].kind
    if kind == "train":
        for part in ("m", "v"):
            assert {k: _sd(v) for k, v in _flat(got[1][part]).items()} == {
                k: _sd(v) for k, v in _ref_flat(
                    _unstack(cfg, want[1][part], drop)).items()}
        assert _sd(got[1]["step"]) == _sd(want[1]["step"])
    elif kind == "decode":
        caches_w = _ref_flat(_unstack(cfg, {"stacks": want[1]},
                                      drop)["layers"])
        assert {k: _sd(v) for k, v in _flat(got[1]).items()} == {
            k: _sd(v) for k, v in caches_w.items()}
        assert _sd(got[2]) == _sd(want[2]) and _sd(got[3]) == _sd(want[3])
