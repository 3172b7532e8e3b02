"""hubert-xlarge — 48L encoder-only transformer (w2v2 arch); framewise
frontend stubbed per assignment [arXiv:2106.07447; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504,
    causal=False, audio_frontend=True, fsdp=True,
    skip_shapes=("decode_32k", "long_500k"),
    skip_reason="encoder-only: no decode step (DESIGN §5)",
)
