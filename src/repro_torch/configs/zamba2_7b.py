"""zamba2-7b — 81L Mamba2 backbone with a shared attention block applied
every 6th layer [arXiv:2411.15242; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64,
    shared_attn_every=6,
    rope_theta=10000.0, fsdp=True,
)
