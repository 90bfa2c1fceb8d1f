"""command-r-plus-104b: dense GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab=256000, head_dim=128, rope_theta=75_000.0,
    tie_embeddings=True,
)
