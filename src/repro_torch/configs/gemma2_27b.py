"""gemma2-27b — 46L dense GQA, alternating local/global attention with logit
soft-capping [arXiv:2408.00118; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256000,
    sliding_window=4096, layer_pattern=("local", "global"),
    attn_softcap=50.0, final_softcap=30.0,
    rope_theta=10000.0, fsdp=True,
)
