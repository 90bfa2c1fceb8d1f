"""The framework workflow on the port (pipeline → train → checkpoint →
serve), ``tests/test_system.py::test_framework_end_to_end_train_then_serve``
on the CPU, and a checkpoint of the JAX package's ``Trainer`` continued by
the port's: the next step's loss, grad-norm-driven update and every
parameter within ``STEP_TOL`` = 1e-4 of the JAX Trainer's own next step
(float32 compute in both; relative, plus 1e-4 of the leaf's largest
value)."""

import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.train.loop import Trainer as JTrainer
from repro.train.loop import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.tree import leaves, leaves_with_paths

torch.set_num_threads(1)

CPU = "cpu"
STEP_TOL = 1e-4


def test_framework_end_to_end_train_then_serve(tmp_path):
    """Train a tiny LM for a few steps (checkpointed), restore the params
    and serve a request with the paged engine — full lifecycle."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.checkpoint import restore_checkpoint
    from repro_torch.train.loop import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config("llama3_8b").smoke(),
                              dtype="float32")
    trainer = Trainer(cfg, batch_size=2, seq_len=16,
                      tcfg=TrainerConfig(steps=3, ckpt_every=3,
                                         ckpt_dir=str(tmp_path)),
                      device=CPU)
    report = trainer.run()
    assert report["final_step"] == 3

    like = {"params": trainer.params, "opt": trainer.opt_state}
    restored, step, _ = restore_checkpoint(tmp_path, like)
    assert step == 3
    for a, b in zip(leaves(restored), leaves(like)):
        assert torch.equal(a, b)
    eng = ServeEngine(cfg, restored["params"], max_batch=2, device=CPU)
    req = eng.submit([1, 2, 3], max_new_tokens=3)
    eng.run()
    assert req.done and len(req.generated) == 3
    assert all(0 <= t < cfg.vocab for t in req.generated)


def test_reference_checkpoint_continues_in_the_port(tmp_path):
    """The JAX Trainer trains 3 steps and checkpoints; it restarts and
    takes step 4.  The port's Trainer adopts the same checkpoint (params,
    AdamW moments, step, pipeline position) and takes step 4 too."""
    from repro_torch.train.loop import Trainer, TrainerConfig

    jcfg = dataclasses.replace(jget_config("llama3_8b").smoke(),
                               dtype="float32")
    ck = str(tmp_path / "jax")
    JTrainer(jcfg, 2, 16, tcfg=JTrainerConfig(steps=3, ckpt_every=3,
                                              ckpt_dir=ck)).run()
    jt = JTrainer(jcfg, 2, 16, tcfg=JTrainerConfig(steps=4, ckpt_every=100,
                                                   ckpt_dir=ck, log_every=1))
    jrep = jt.run()
    assert jrep["final_step"] == 4

    cfg = dataclasses.replace(get_config("llama3_8b").smoke(),
                              dtype="float32")
    t = Trainer(cfg, 2, 16, tcfg=TrainerConfig(
        steps=4, ckpt_every=100, ckpt_dir=str(tmp_path / "port"),
        log_every=1), device=CPU)
    assert t.adopt_reference_checkpoint(ck) == 3
    assert t.pipeline.next_index == 3 and int(t.opt_state["step"]) == 3
    rep = t.run()
    assert rep["final_step"] == 4
    got, want = rep["metrics"][-1], jrep["metrics"][-1]
    assert got["step"] == want["step"] == 4
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=STEP_TOL,
                                   err_msg=key)
    ref = params_from_jax(cfg, jax.tree.map(np.asarray, jt.params),
                          device=CPU, dtype=torch.float32)
    for (path, a), b in zip(leaves_with_paths(t.params), leaves(ref)):
        np.testing.assert_allclose(
            a.numpy(), b.numpy(), rtol=STEP_TOL,
            atol=STEP_TOL * float(b.abs().max()),
            err_msg="/".join(map(str, path)))


def test_launcher_and_example_train_on_cpu(tmp_path):
    """``python -m repro_torch.launch.train`` (an MoE arch, smoke) and
    ``examples_torch/train_lm.py`` run on the CPU from Python, as their
    ``--device cpu`` runs do."""
    import importlib.util
    import signal
    from pathlib import Path

    from repro_torch.launch import train as launch_train

    # both install SIGTERM/SIGINT handlers: give the test process its own
    # back afterwards
    saved = {sig: signal.getsignal(sig)
             for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        rep = launch_train.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                                 "--steps", "2", "--microbatches", "2",
                                 "--ckpt-dir", str(tmp_path / "launch")],
                                device=CPU)
        assert rep["final_step"] == 2
        assert rep["transfers"]["total_copies"] == 2 * 2
        path = Path(__file__).resolve().parents[1] / "examples_torch" / \
            "train_lm.py"
        spec = importlib.util.spec_from_file_location("train_lm_example",
                                                      path)
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        rep = example.main(["--steps", "10", "--device", "cpu",
                            "--ckpt-dir", str(tmp_path / "example")])
        assert rep["final_step"] == 10
    finally:
        for sig, handler in saved.items():
            signal.signal(sig, handler)


def test_kernel_wrappers_differentiate_on_cpu_and_refuse_grad_rule():
    """On CPU tensors the wrappers run the plain versions, which autograd
    differentiates (the recurrent families train on the CPU); the rule
    the CUDA branches apply raises under grad and passes without it."""
    import pytest

    from repro_torch.kernels._build import refuse_grad
    from repro_torch.kernels.mlstm import ops as mlstm_ops
    from repro_torch.kernels.rg_lru import ops as rg_ops

    rng = np.random.default_rng(0)

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).requires_grad_(True)

    q, k, v = leaf(1, 16, 2, 8), leaf(1, 16, 2, 8), leaf(1, 16, 2, 8)
    i = torch.sigmoid(leaf(1, 16, 2))
    lf = torch.nn.functional.logsigmoid(leaf(1, 16, 2))
    mlstm_ops.mlstm_chunkwise(q, k, v, i, lf, chunk=8).sum().backward()
    a = torch.sigmoid(leaf(1, 8, 128))
    b = leaf(1, 8, 128)
    h, _ = rg_ops.rg_lru_scan(a, b, torch.zeros(1, 128))
    h.sum().backward()
    for t in (q, k, v, b):
        assert t.grad is not None and torch.isfinite(t.grad).all()
    with pytest.raises(NotImplementedError, match="mlstm_chunkwise.*A12"):
        refuse_grad("mlstm_chunkwise", q.detach(), k)
    refuse_grad("mlstm_chunkwise", q.detach())
    with torch.no_grad():
        refuse_grad("mlstm_chunkwise", q, k)
