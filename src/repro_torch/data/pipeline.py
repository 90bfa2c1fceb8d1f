"""Deterministic, resumable synthetic data pipeline (host-side producer).

In RIMMS terms the pipeline is the CPU PE producing batches into host
memory; the training loop tracks each batch as a ``HeteData`` so device
ingestion happens exactly once and repeated consumers (eval replays,
repeated Computation regions à la the paper's PD app) hit the tracked
device copy instead of re-staging from host.

Determinism + resume: batch ``i`` is a pure function of (seed, i) — the
checkpoint stores only ``next_index``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig

__all__ = ["TokenPipeline"]


@dataclasses.dataclass
class TokenPipeline:
    cfg: ArchConfig
    batch_size: int
    seq_len: int
    seed: int = 0
    next_index: int = 0

    def state(self) -> Dict:
        return {"seed": self.seed, "next_index": self.next_index}

    def restore(self, state: Dict) -> None:
        self.seed = int(state["seed"])
        self.next_index = int(state["next_index"])

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, index])
        )

    def batch_at(self, index: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, index) — the resume contract."""
        cfg = self.cfg
        rng = self._rng(index)
        B, S = self.batch_size, self.seq_len
        if cfg.family == "vlm":
            s_txt = S - cfg.n_patches
            tokens = rng.integers(0, cfg.vocab, (B, s_txt + 1), dtype=np.int32)
            out = {
                "tokens": tokens[:, :-1],
                "labels": tokens[:, 1:],
                "patch_embeds": rng.normal(
                    size=(B, cfg.n_patches, cfg.d_model)
                ).astype(np.float32),
            }
        elif cfg.family == "audio":
            tokens = rng.integers(0, cfg.vocab, (B, S + 1), dtype=np.int32)
            out = {
                "tokens": tokens[:, :-1],
                "labels": tokens[:, 1:],
                "frames": rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(
                    np.float32
                ),
            }
        else:
            tokens = rng.integers(0, cfg.vocab, (B, S + 1), dtype=np.int32)
            out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        return out

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.next_index)
        self.next_index += 1
        return b

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self
