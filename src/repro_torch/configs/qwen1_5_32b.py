"""qwen1.5-32b: dense, QKV bias [hf:Qwen/Qwen1.5-32B]. kv=40 => MHA."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab=152064, head_dim=128, rope_theta=1_000_000.0,
    qkv_bias=True,
)
