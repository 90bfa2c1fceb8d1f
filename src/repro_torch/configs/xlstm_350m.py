"""xlstm-350m: alternating mLSTM/sLSTM blocks [arXiv:2405.04517].

d_ff=0 per the assignment: blocks carry their own up/down projections
(mLSTM pf=2, sLSTM pf=4/3-style gated FFN). See models/recurrent.py for
the simplifications recorded in DESIGN.md (sigmoid gating for numeric
stability; chunkwise-parallel mLSTM).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, head_dim=256,
    block_pattern=("mlstm", "slstm"),
)
