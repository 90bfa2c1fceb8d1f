"""Architecture + shape configuration schema and registry."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "get_config", "list_archs", "cells_for"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # attention / embeddings
    head_dim: int = 0  # 0 → d_model // n_heads
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | geglu | gelu
    pos_embed: str = "rope"  # rope | learned
    tie_embeddings: bool = False
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # encoder-decoder (whisper): n_layers counts DECODER layers
    n_enc_layers: int = 0
    enc_seq: int = 0
    # vlm stub frontend
    n_patches: int = 0
    # hybrid / ssm block structure; () → all attention blocks
    block_pattern: Tuple[str, ...] = ()
    window: int = 0  # local-attention window (0 = full causal)
    conv_width: int = 4
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # chunk sizes for chunked attention / chunkwise recurrence
    q_chunk: int = 512
    rec_chunk: int = 256

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """True if long_500k decode is tractable (no full-attention KV)."""
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid" and self.window > 0:
            return True
        return False

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2, len(self.block_pattern) or 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 1,
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            # drop-free at smoke scale so prefill ≡ decode exactly
            capacity_factor=4.0 if self.n_experts else self.capacity_factor,
            n_enc_layers=2 if self.n_enc_layers else 0,
            enc_seq=16 if self.enc_seq else 0,
            n_patches=8 if self.n_patches else 0,
            window=16 if self.window else 0,
            q_chunk=16,
            rec_chunk=8,
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    def smoke(self) -> "ShapeSpec":
        return ShapeSpec(self.name + "-smoke", self.kind, 32, 2)


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

ARCH_IDS = [
    "llama3_8b",
    "yi_9b",
    "command_r_plus_104b",
    "qwen1_5_32b",
    "granite_moe_3b_a800m",
    "qwen3_moe_235b_a22b",
    "internvl2_26b",
    "whisper_large_v3",
    "xlstm_350m",
    "recurrentgemma_2b",
]


def get_config(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(ARCH_IDS)


def cells_for(arch_id: str) -> List[str]:
    """Shape names applicable to an arch (skips per DESIGN.md §4)."""
    cfg = get_config(arch_id)
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")  # full-attention archs skip (quadratic KV)
    return out
