"""llama-3.2-vision-11b — 40L dense GQA with cross-attention image layers
every 5th layer; patch-embedding frontend stubbed per assignment
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256,
    cross_attn_every=5, n_image_tokens=1601,
    rope_theta=500000.0, fsdp=True,
    skip_shapes=("long_500k",),
    skip_reason="pure full attention, no sub-quadratic mechanism (DESIGN §5)",
)
