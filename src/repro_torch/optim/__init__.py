from .adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                    opt_state_specs)
from .compression import CompressionState, compress_grads, decompress_grads
from .schedule import cosine_schedule

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "global_norm",
    "opt_state_specs",
    "cosine_schedule", "compress_grads", "decompress_grads", "CompressionState",
]
