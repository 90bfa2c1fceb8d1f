"""llama3-8b: dense GQA, 128k vocab [arXiv:2407.21783]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, head_dim=128, rope_theta=500_000.0,
)
