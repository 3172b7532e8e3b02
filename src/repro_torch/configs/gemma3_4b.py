"""gemma3-4b — 34L dense GQA, 5:1 local:global interleaving, 128k context
[hf:google/gemma-3-*-pt; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab=262144,
    sliding_window=1024,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    rope_theta=1000000.0,
)
