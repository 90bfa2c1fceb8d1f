"""recurrentgemma-2b: RG-LRU + local attention 1:2 [arXiv:2402.19427].

26 layers = 8 × (rec, rec, local-attn) + (rec, rec). MQA (kv=1),
window 2048, GeGLU d_ff=7680.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, head_dim=256, rope_theta=10_000.0,
    act="geglu", block_pattern=("rec", "rec", "attn"), window=2048,
)
