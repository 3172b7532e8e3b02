"""deepseek-moe-16b — 28L fine-grained MoE: 2 shared + 64 routed top-6
[arXiv:2401.06066; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=102400,
    n_experts=64, n_shared_experts=2, top_k=6,
    rope_theta=10000.0, fsdp=True,
    skip_shapes=("long_500k",),
    skip_reason="pure full attention, no sub-quadratic mechanism (DESIGN §5)",
)
