"""whisper-large-v3: enc-dec, conv frontend stub [arXiv:2212.04356].

n_layers counts decoder layers (32) + 32 encoder layers, matching
whisper-large. The conv frontend is a stub: input_specs() provides
precomputed frame embeddings (B, 1500, d_model). decode_32k follows the
assigned shape (32k self-KV) even though upstream whisper caps decoder
context at 448 — learned positions are sized to the assigned shape.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, head_dim=64,
    norm="layernorm", act="gelu", pos_embed="learned",
    n_enc_layers=32, enc_seq=1500,
)
