"""granite-moe-3b-a800m — 32L MoE, 40 experts top-8, fine-grained experts
[hf:ibm-granite/granite-3.0-*; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155,
    n_experts=40, top_k=8,
    rope_theta=10000.0,
    skip_shapes=("long_500k",),
    skip_reason="pure full attention, no sub-quadratic mechanism (DESIGN §5)",
)
