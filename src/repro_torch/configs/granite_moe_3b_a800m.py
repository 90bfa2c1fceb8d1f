"""granite-moe-3b-a800m: MoE 40 experts top-8 [hf:ibm-granite].

Note: the assignment's inline comment says "32 experts" but the config
field says "MoE 40e top-8"; we take the config field (40) as
authoritative (matches ibm-granite/granite-3.0-3b-a800m-base).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155, head_dim=64, rope_theta=10_000.0,
    n_experts=40, top_k=8,
)
