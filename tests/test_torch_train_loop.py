"""``tests/test_train_loop.py`` on the port (``repro_torch.train.loop``):
checkpoint/restart determinism (bit for bit), preemption safety,
straggler detection, pipeline resume, on the CPU.  Cross-package: the
port's pipeline gives the reference's batches bit for bit, and its
Trainer stages them through ``HeteContext`` with the reference Trainer's
ledger counts and bytes (the device space is ``device:gpu0`` here,
``device:tpu0`` there)."""

import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.train.loop import Trainer as JTrainer
from repro.train.loop import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.train.checkpoint import latest_step
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.tree import leaves

torch.set_num_threads(1)

CFG = get_config("llama3_8b").smoke()
CPU = "cpu"


def make_trainer(tmp_path, steps=6, ckpt_every=3, seed=0):
    return Trainer(
        CFG, batch_size=2, seq_len=16,
        tcfg=TrainerConfig(steps=steps, ckpt_every=ckpt_every,
                           ckpt_dir=str(tmp_path / "ckpt"), log_every=1,
                           seed=seed),
        device=CPU)


def test_pipeline_deterministic_resume():
    p = TokenPipeline(CFG, 2, 16, seed=7)
    b0, b1 = next(p), next(p)
    q = TokenPipeline(CFG, 2, 16, seed=7)
    q.restore(p.state())  # state points at batch 2
    next(p)
    # a fresh pipeline restored from state produces the same stream
    r = TokenPipeline(CFG, 2, 16, seed=7)
    np.testing.assert_array_equal(r.batch_at(0)["tokens"], b0["tokens"])
    np.testing.assert_array_equal(r.batch_at(1)["tokens"], b1["tokens"])
    # the reference's batches, bit for bit, for every family's leaves
    for arch in ("llama3_8b", "internvl2_26b", "whisper_large_v3"):
        mine = TokenPipeline(get_config(arch).smoke(), 2, 16, seed=7)
        ref = JTokenPipeline(jget_config(arch).smoke(), 2, 16, seed=7)
        for i in (0, 3):
            a, b = mine.batch_at(i), ref.batch_at(i)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_train_runs_and_logs(tmp_path):
    t = make_trainer(tmp_path, steps=4, ckpt_every=10)
    report = t.run()
    assert report["final_step"] == 4
    losses = [m["loss"] for m in report["metrics"]]
    assert all(np.isfinite(l) for l in losses)
    # RIMMS ledger saw exactly one host→device ingest per batch leaf
    assert report["transfers"]["total_copies"] == 4 * 2  # tokens+labels
    # ... as the reference Trainer's ledger, counts and bytes per pair
    jt = JTrainer(jget_config("llama3_8b").smoke(), batch_size=2, seq_len=16,
                  tcfg=JTrainerConfig(steps=4, ckpt_every=10,
                                      ckpt_dir=str(tmp_path / "jckpt"),
                                      log_every=1))
    jrep = jt.run()["transfers"]
    got = report["transfers"]
    for key in ("total_copies", "total_bytes", "flag_checks"):
        assert got[key] == jrep[key], key
    assert got["by_pair"] == {k.replace("tpu0", "gpu0"): v
                              for k, v in jrep["by_pair"].items()}
    assert got["total_bytes"] == 4 * 2 * (2 * 16 * 4)  # int32 (2, 16)


def test_checkpoint_restart_bitwise_resume(tmp_path):
    # run 6 steps straight
    t1 = make_trainer(tmp_path / "a", steps=6, ckpt_every=100)
    r1 = t1.run()
    # run 3 steps, "crash", restart a fresh trainer, run to 6
    t2 = make_trainer(tmp_path / "b", steps=3, ckpt_every=3)
    t2.run()
    t3 = make_trainer(tmp_path / "b", steps=6, ckpt_every=3)
    assert t3.maybe_restore()
    assert t3.step == 3
    r3 = t3.run()
    l1 = [m for m in r1["metrics"] if m["step"] == 6][0]["loss"]
    l3 = [m for m in r3["metrics"] if m["step"] == 6][0]["loss"]
    assert l1 == l3  # bit for bit
    for a, b in zip(leaves({"p": t1.params, "o": t1.opt_state}),
                    leaves({"p": t3.params, "o": t3.opt_state})):
        assert torch.equal(a, b)


def test_preemption_checkpoints_and_exits(tmp_path):
    t = make_trainer(tmp_path, steps=100, ckpt_every=1000)
    calls = []

    def stop_after_two(step, dt, med):
        calls.append(step)

    t.on_straggler = stop_after_two
    # preempt via the signal-handler flag after 2 steps
    real_stage = t._stage_batch

    def staged(b):
        if t.step >= 2:
            t.request_preemption()
        return real_stage(b)

    t._stage_batch = staged
    report = t.run()
    assert report["preempted"]
    assert report["final_step"] < 100
    assert latest_step(t.tcfg.ckpt_dir) == report["final_step"]


def test_straggler_detection(tmp_path):
    t = Trainer(CFG, 2, 16, tcfg=TrainerConfig(steps=8, ckpt_every=100,
                                               ckpt_dir=str(tmp_path / "ck"),
                                               straggler_factor=0.0),
                device=CPU)
    # factor 0 → every step after the 5th is a "straggler"
    report = t.run()
    assert report["straggler_events"] > 0
