"""Fault-tolerant training loop, the JAX package's
``src/repro/train/loop.py`` on torch and one device:

* **checkpoint/restart** — atomic checkpoints every ``ckpt_every`` steps
  including optimizer + data-pipeline state; startup auto-resumes from
  the newest complete checkpoint, bit for bit.
* **preemption safety** — SIGTERM/SIGINT set a flag; the loop finishes
  the in-flight step, checkpoints, and exits cleanly.
* **straggler detection** — per-step wall times in a ring buffer; steps
  slower than ``straggler_factor ×`` the running median fire a hook.
* **RIMMS batch staging** — each host-produced batch leaf is a
  ``HeteData`` made by ``hete.malloc`` and ``ensure``d onto the device's
  ``MemorySpace`` (``device:gpu0``, tensors on ``device``): the ledger
  shows one host→device copy per batch leaf and step.

Weights are float32 masters (the reference's ``param_dtype``), computed
in ``cfg.dtype``.  :meth:`Trainer.adopt_reference_checkpoint` continues
from a checkpoint the JAX package's ``Trainer`` wrote.
"""

from __future__ import annotations

import dataclasses
import signal
import statistics
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.hete import (HeteContext, MemorySpace, tensor_egress,
                                   tensor_ingest)
from repro_torch.core.locations import HOST, Location
from repro_torch.core.runtime import resolve_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.convert import train_state_from_jax
from repro_torch.models.model_api import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.checkpoint import (latest_step, read_checkpoint,
                                          restore_checkpoint, save_checkpoint)
from repro_torch.train.step import build_train_step

__all__ = ["Trainer", "TrainerConfig"]


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = "checkpoints"
    log_every: int = 10
    microbatches: int = 1
    remat: bool = True
    straggler_factor: float = 3.0
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ArchConfig, batch_size: int, seq_len: int,
                 tcfg: TrainerConfig = TrainerConfig(),
                 opt_cfg: AdamWConfig = AdamWConfig(),
                 hete: Optional[HeteContext] = None, *, device=None):
        """``device``: ``None`` is CUDA (raising without it); the tests
        pass ``"cpu"``."""
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        self.pipeline = TokenPipeline(cfg, batch_size, seq_len, seed=tcfg.seed)
        self.step_fn = build_train_step(self.model, opt_cfg, remat=tcfg.remat,
                                        microbatches=tcfg.microbatches)
        self.hete = hete or HeteContext()
        self.device_loc = Location("device", "gpu0")
        if self.device_loc not in self.hete.spaces:
            self.hete.register_space(MemorySpace(
                self.device_loc, ingest=tensor_ingest(self.device),
                egress=tensor_egress))
        self.step = 0
        self.metrics_log: List[Dict] = []
        self.straggler_events = 0
        self._preempted = False
        self._step_times: List[float] = []

    # -- preemption ------------------------------------------------------
    def install_signal_handlers(self):
        def handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    def request_preemption(self):  # tests / fault injection
        self._preempted = True

    # -- checkpointing -----------------------------------------------------
    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def save(self):
        save_checkpoint(
            self.tcfg.ckpt_dir, self.step, self._state_tree(),
            extra={"pipeline": self.pipeline.state(), "step": self.step},
        )

    def maybe_restore(self) -> bool:
        if latest_step(self.tcfg.ckpt_dir) is None:
            return False
        if not hasattr(self, "params"):
            # structure-only stand-in (no storage) for the tree's keys
            shapes = self.model.param_shapes()
            like = {"params": shapes,
                    "opt": {"m": shapes, "v": shapes, "step": None}}
        else:
            like = self._state_tree()
        tree, _, extra = restore_checkpoint(self.tcfg.ckpt_dir, like,
                                            device=self.device)
        self._adopt(tree, extra)
        return True

    def adopt_reference_checkpoint(self, ckpt_dir, step: Optional[int] = None
                                   ) -> int:
        """Continue from a checkpoint of the JAX package's ``Trainer``
        (its stacked params and AdamW moments, converted by
        :func:`~repro_torch.models.convert.train_state_from_jax`).
        Returns the step it holds."""
        tree, _, extra = read_checkpoint(ckpt_dir, step)
        self._adopt(train_state_from_jax(self.cfg, tree, self.device), extra)
        return self.step

    def _adopt(self, tree, extra):
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.step = extra["step"]
        self.pipeline.restore(extra["pipeline"])

    # -- batch staging through RIMMS ------------------------------------------
    def _stage_batch(self, np_batch: Dict[str, np.ndarray]) -> Dict:
        staged = {}
        for k, a in np_batch.items():
            hd = self.hete.malloc(a.shape, a.dtype)
            hd.copies[HOST][...] = a
            staged[k] = self.hete.ensure(hd, self.device_loc)
            self.hete.free(hd)
        return staged

    # -- main loop ---------------------------------------------------------------
    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        self.params = self.model.init(gen, dtype=torch.float32)
        self.opt_state = adamw_init(self.params)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> Dict[str, Any]:
        if not hasattr(self, "params"):
            if not self.maybe_restore():
                self.init_state()
        t_loop = time.time()
        while self.step < self.tcfg.steps and not self._preempted:
            batch = self._stage_batch(next(self.pipeline))
            t0 = time.time()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            self._sync()
            dt = time.time() - t0
            self._step_times.append(dt)
            if len(self._step_times) > 50:
                self._step_times.pop(0)
            med = statistics.median(self._step_times)
            if len(self._step_times) >= 5 and dt > self.tcfg.straggler_factor * med:
                self.straggler_events += 1
                self.on_straggler(self.step, dt, med)
            self.step += 1
            if self.step % self.tcfg.log_every == 0 or self.step == 1:
                self.metrics_log.append(
                    {"step": self.step, "loss": float(metrics["loss"]),
                     "grad_norm": float(metrics["grad_norm"]),
                     "sec_per_step": dt})
            if self.step % self.tcfg.ckpt_every == 0:
                self.save()
        if self._preempted:
            self.save()
        return {
            "final_step": self.step,
            "preempted": self._preempted,
            "straggler_events": self.straggler_events,
            "wall_s": time.time() - t_loop,
            "metrics": self.metrics_log,
            "transfers": self.hete.ledger.snapshot(),
        }

    # hook — override / monkeypatch in deployments
    def on_straggler(self, step: int, dt: float, median: float) -> None:
        print(f"[straggler] step {step}: {dt:.3f}s vs median {median:.3f}s")
