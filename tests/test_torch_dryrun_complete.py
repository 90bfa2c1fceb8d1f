"""What the port's dry-run counts, held to what its steps must compute,
on the CPU:

* the one-device count (``dryrun.count_world1``: the cell's one-group
  step on fake tensors with no mesh, through the dry-run's own
  ``_LocalCost``) within 10 % of an analytic count of the step's
  products: the projections, the attention scores and values over the
  keys ``full_attention`` or ``decode_attention`` compute, the MoE
  router and the experts at capacity (one dispatch group without a
  mesh), the recurrent blocks' products, the LM head (prefill's last
  token, training's every token) — times 3 for a training step (forward
  and the two products of each backward; a one-group probe recomputes
  nothing, as the reference's probes);
* the decode step that donates its caches (``Model.decode_step(...,
  donate=True)``, what the serve step runs) writing the caches it was
  given and returning them, with the logits and caches of the step that
  leaves them alone, for every family of the eight cells and the audio
  one, in float32."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from held_cells import FIRST_CELLS as CELLS
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.models.blocks import moe_capacity
from repro_torch.models.layers import divisor_chunk
from repro_torch.models.model_api import layer_kinds
from repro_torch.models.recurrent import MLSTMLayer, SLSTMLayer
from repro_torch.tree import leaves

torch.set_num_threads(1)

#: the one-device count against the products
PRODUCTS_TOL = 0.10


def _attention_products(cfg, shape):
    """Scores and P·V over the keys each query chunk (or the decode
    token) is computed against."""
    B, S, hd, Hq = shape.global_batch, shape.seq_len, cfg.head_dim_, \
        cfg.n_heads
    if shape.kind == "decode":
        keys = min(S, cfg.window) if cfg.window > 0 else S
        return 2 * 2 * B * Hq * keys * hd
    C = divisor_chunk(S, cfg.q_chunk)
    total = 0
    for i in range(S // C):
        keys = S
        if cfg.window > 0 and cfg.window % C == 0 and S > cfg.window:
            k0 = max(i * C - cfg.window, 0)
            keys = min(cfg.window + C, S - k0)
        total += 2 * 2 * B * Hq * C * keys * hd
    return total


def _layer_products(cfg, kind, shape):
    B = shape.global_batch
    T = B if shape.kind == "decode" else B * shape.seq_len
    d = cfg.d_model
    if kind in ("dense", "attn", "moe"):
        hd = cfg.head_dim_
        f = 2 * T * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
        f += _attention_products(cfg, shape)
        if kind == "moe":
            E = cfg.n_experts
            f += 2 * T * d * E  # the router
            f += 3 * 2 * E * moe_capacity(cfg, T) * d * cfg.d_ff
        else:
            n_mats = 3 if cfg.act in ("swiglu", "geglu") else 2
            f += n_mats * 2 * T * d * cfg.d_ff
        return f
    if kind == "rec":  # w_x, w_g, w_r, w_i, w_o and the GeGLU MLP
        return 5 * 2 * T * d * d + 3 * 2 * T * d * cfg.d_ff
    assert shape.kind == "decode", kind
    if kind == "mlstm":
        M, H, m = MLSTMLayer._dims(cfg)
        return (2 * T * d * 2 * M + 3 * 2 * T * M * M + 2 * T * M * 2 * H
                + 2 * T * M * d + 2 * B * H * m * m + 2 * B * H * m)
    if kind == "slstm":
        _, H, hd, f = SLSTMLayer._dims(cfg)
        return (2 * T * d * 4 * d + 2 * B * H * hd * 4 * hd
                + 2 * T * d * 2 * f + 2 * T * f * d)
    raise AssertionError(kind)


def analytic_flops(arch: str, shape_name: str) -> float:
    """The products of the cell's one-group step (module docstring)."""
    cfg = dryrun._probe_cfg(get_config(arch), 1)
    shape = SHAPES[shape_name]
    f = sum(_layer_products(cfg, k, shape) for k in layer_kinds(cfg))
    head_tokens = shape.global_batch * (shape.seq_len if shape.kind == "train"
                                        else 1)
    f += 2 * head_tokens * cfg.d_model * cfg.vocab
    return float(3 * f if shape.kind == "train" else f)


@pytest.mark.parametrize("cell", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_world1_count_matches_the_products(cell):
    whole = dryrun.count_world1(*cell, probe_groups=1)["flops"]
    want = analytic_flops(*cell)
    assert abs(whole - want) <= PRODUCTS_TOL * want, (whole, want)


# ---------------------------------------------------------------------------
# the donated decode step
# ---------------------------------------------------------------------------

#: one arch of each family of the held cells, and the audio family
DONATE_ARCHS = ["llama3_8b", "granite_moe_3b_a800m", "xlstm_350m",
                "recurrentgemma_2b", "whisper_large_v3"]


@pytest.mark.parametrize("arch", DONATE_ARCHS)
def test_donated_decode_step_writes_the_caches_it_was_given(arch):
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = TokenPipeline(cfg, 2, 12, seed=3).batch_at(0)
    batch.pop("labels")
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in batch.items()}
    _, caches = model.prefill(params, batch, max_len=24)
    copies = [{k: v.clone() for k, v in c.items()} for c in caches]
    before = [{k: v.clone() for k, v in c.items()} for c in caches]
    tok = torch.tensor([3, 7], dtype=torch.int32)
    pos = torch.full((2,), 12 + cfg.n_patches, dtype=torch.int32)
    want, want_caches = model.decode_step(params, copies, tok, pos)
    for c, b in zip(copies, before):  # left as they were
        assert all(torch.equal(c[k], b[k]) for k in c)
    got, got_caches = model.decode_step(params, caches, tok, pos,
                                        donate=True)
    assert torch.equal(got, want)
    for given, new, w in zip(caches, got_caches, want_caches):
        assert set(new) == set(w)
        for k in new:
            assert torch.equal(new[k], w[k]), (arch, k)
            if k in given:  # written in place, the same tensor returned
                assert new[k] is given[k], (arch, k)
    n_state = sum(len(c) for c in got_caches)
    assert n_state == len(leaves(want_caches)) > 0
    assert math.isfinite(float(got.abs().max()))
