"""qwen3-moe-235b-a22b: MoE 128 experts top-8 [hf:Qwen/Qwen3-235B-A22B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, head_dim=128, rope_theta=1_000_000.0,
    n_experts=128, top_k=8,
)
