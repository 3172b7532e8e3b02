"""h2o-danube-1.8b — 24L dense GQA, llama+mistral mix with sliding-window
attention [arXiv:2401.16818; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
    d_ff=6912, vocab=32000,
    sliding_window=4096,            # uniform SWA (mistral-style)
    rope_theta=10000.0,
)
