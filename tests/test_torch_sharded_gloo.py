"""The port's sharded steps compute what its one-device steps compute:
four processes on a gloo group of the CPU, a 2 × 2 ("data", "model")
mesh, the dry-run's partitioning (the model's shard points, its work on
each rank's shards, and ``dryrun._GspmdLike``), at smoke width in
float32.  The dry-run itself runs on fake ranks and moves no data, so
this is where its plan is held to numbers.

For each case, every rank builds the same weights and batch, runs the
one-device prefill, decode step and (attention families) training loss
and gradients on plain tensors, then the same on DTensors laid out by
the model's specs, and compares the gathered results: prefill logits,
the donated decode step's logits and caches (written in place), the
loss and every gradient, each within ``TOL`` of its largest value.  The
cases cover what the held cells partition: attention on head shards and
on sequence shards (a KV head count the model axis does not divide, with
and without a ring-buffer window, and a window shorter than a shard,
where a rank scores only the keys of a chunk's span), the MoE with its
experts sharded over the model axis and with them whole on every rank,
the mLSTM, sLSTM and RG-LRU decode states and, in training, the sLSTM's
loop and the mLSTM's chunks on each rank's batch; a head count the
model axis does not divide in training under sequence parallelism (the
loss's chunks on each rank's sequence shard), cross attention with its
queries split over the model axis, the vision-language model's text
positions, and a batch of one (the argmax over vocabulary shards).

Run as a script, this file is one rank of that run."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
TOL = 1e-4
#: the prefill fills its caches (the dry-run's cells do), and the decode
#: step writes the last slot
B, S, MAX_LEN = 2, 16, 16


def _cases():
    from repro_torch.configs import get_config

    def smoke(arch, **kw):
        return dataclasses.replace(get_config(arch).smoke(), dtype="float32",
                                   **kw)

    sp = {"res_seq": ("model",)}  # sequence parallelism
    return {
        "dense_head_shards": (smoke("llama3_8b"), True),
        "dense_seq_shards": (smoke("llama3_8b", n_heads=3, n_kv_heads=3),
                             True),
        "moe_experts_sharded": (smoke("granite_moe_3b_a800m"), True),
        "moe_experts_whole": (smoke("granite_moe_3b_a800m", n_experts=3),
                              True),
        "xlstm": (smoke("xlstm_350m"), False),
        "hybrid_window_seq_shards": (smoke("recurrentgemma_2b", n_heads=3),
                                     False),
        "window_shorter_than_a_shard": (smoke(
            "recurrentgemma_2b", n_heads=3, window=4, q_chunk=4), True),
        "xlstm_train": (smoke("xlstm_350m"), True),
        "heads_undivided_seq_parallel_train": (smoke(
            "llama3_8b", n_heads=3, n_kv_heads=3), True, sp),
        "cross_attention_queries_split": (smoke(
            "whisper_large_v3", n_heads=3, n_kv_heads=3), True),
        "vlm_text_positions": (smoke("internvl2_26b"), True, sp),
        "batch_of_one": (smoke("xlstm_350m"), False, None, 1),
    }


def _err(got, want) -> float:
    """max |got - want| over (1 + max |want|)."""
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / (1.0 + want.abs().max()))


def _case(cfg, train, mesh, rules, B=B):
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.sharding import (P, resolve_spec_tree,
                                                  use_rules)
    from repro_torch.launch.dryrun import _GspmdLike
    from repro_torch.models import build_model
    from repro_torch.models.model_api import batch_sharding_specs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.tree import leaves, map_tree

    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    data = TokenPipeline(cfg, B, S, seed=1).batch_at(0)
    batch = {k: torch.from_numpy(v.copy()) for k, v in data.items()}
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    tok = torch.tensor([5, 9][:B], dtype=torch.int32)
    pos = torch.full((B,), S - 1, dtype=torch.int32)

    with torch.no_grad():
        want_logits, want_caches = model.prefill(params, prompt, MAX_LEN)
        given = [{k: v.clone() for k, v in c.items()} for c in want_caches]
        want_dec, want_dec_caches = model.decode_step(params, given, tok, pos)
    if train:
        for p in leaves(params):
            p.requires_grad_(True)
        want_loss = model.loss(params, batch, remat=False, probe=True)
        want_grads = torch.autograd.grad(want_loss, leaves(params))
        for p in leaves(params):
            p.requires_grad_(False)

    errs = {}
    with use_rules(rules):
        def laid_out(tree, specs):
            sh = resolve_spec_tree(specs, rules, tree)
            return map_tree(lambda t, s: distribute_tensor(
                t.detach().clone(), mesh, s.placements), tree, sh)

        dparams = laid_out(params, model.param_specs())
        shape = ShapeSpec("gloo", "train", S, B)
        dbatch = laid_out(batch, batch_sharding_specs(cfg, shape))
        dtok, dpos = laid_out({"t": tok, "p": pos},
                              {"t": P("batch"), "p": P("batch")}).values()
        with implicit_replication(), _GspmdLike():
            with torch.no_grad():
                logits, _ = model.prefill(dparams, {
                    k: v for k, v in dbatch.items() if k != "labels"},
                    MAX_LEN)
                errs["prefill_logits"] = _err(logits, want_logits)
                dcaches = laid_out(want_caches, model.cache_specs())
                dec, dec_caches = model.decode_step(dparams, dcaches, dtok,
                                                    dpos, donate=True)
            errs["decode_logits"] = _err(dec, want_dec)
            for i, (got_c, given_c, want_c) in enumerate(
                    zip(dec_caches, dcaches, want_dec_caches)):
                for k in want_c:
                    errs[f"cache{i}.{k}"] = _err(got_c[k], want_c[k])
                    if k in given_c:
                        errs[f"cache{i}.{k}.in_place"] = float(
                            got_c[k] is not given_c[k])
            if train:
                flat = leaves(dparams)
                for p in flat:
                    p.requires_grad_(True)
                loss = model.loss(dparams, dbatch, remat=False, probe=True)
                grads = torch.autograd.grad(loss, flat)
                errs["loss"] = _err(loss, want_loss)
                for i, (g, w) in enumerate(zip(grads, want_grads)):
                    errs[f"grad{i}"] = _err(g, w)
    return errs


def _rank_main(rank: int, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh, rules_for_mesh

    torch.set_num_threads(1)
    # a file in the run's own directory meets the ranks: no port to race
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_local_mesh(2, 2, "cpu")
        res = {}
        for name, (cfg, train, *more) in _cases().items():
            overrides = more[0] if more else None
            res[name] = _case(cfg, train, mesh,
                              rules_for_mesh(mesh, overrides=overrides),
                              *more[1:])
    finally:
        dist.destroy_process_group()
    Path(out, f"rank{rank}.json").write_text(json.dumps(res))


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Each rank's {case: {result: error}} of one run on four ranks."""
    tmp_path = tmp_path_factory.mktemp("gloo")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(tmp_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=420)[0])
        finally:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(WORLD)]


def test_sharded_steps_equal_one_device_steps(gloo_run):
    for r, res in enumerate(gloo_run):
        assert set(res) == set(_cases())
        for case, errs in res.items():
            assert errs and all(e <= TOL for e in errs.values()), (
                r, case, {k: e for k, e in errs.items() if e > TOL})


@pytest.mark.parametrize("case", list(_cases()))
def test_case_equals_one_device(gloo_run, case):
    """One case on every rank, each result within ``TOL``."""
    for r, res in enumerate(gloo_run):
        errs = res[case]
        assert errs and all(e <= TOL for e in errs.values()), (
            r, case, {k: e for k, e in errs.items() if e > TOL})


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2])
