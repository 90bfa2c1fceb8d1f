"""internvl2-26b: InternViT + InternLM2 backbone [arXiv:2404.16821].

Backbone-only per the assignment: the vision frontend is a stub —
input_specs() provides precomputed patch embeddings occupying the first
n_patches positions of the sequence.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553, head_dim=128, rope_theta=1_000_000.0,
    n_patches=256,
)
