"""yi-34b — 60L dense llama-arch GQA [arXiv:2403.04652; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000,
    rope_theta=5000000.0, fsdp=True,
    skip_shapes=("long_500k",),
    skip_reason="pure full attention, no sub-quadratic mechanism (DESIGN §5)",
)
