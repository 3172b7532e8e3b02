"""Architecture config system — a copy of ``repro/configs/base.py``.

One ``ArchConfig`` per assigned architecture (exact public-literature values
in the per-arch modules).  ``reduced()`` yields a same-family micro config
for CPU tests.  The port imports nothing of the JAX package, so it carries
this copy; ``tests/test_torch_configs.py`` holds it equal to the reference
field by field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# Input-shape grid shared by all LM-family architectures (assignment spec).
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                   # 0 for attention-free
    n_kv_heads: int
    d_ff: int                      # dense FFN width (expert width for MoE)
    vocab: int
    head_dim: int = 0              # 0 → d_model // n_heads

    # attention variants
    sliding_window: int = 0        # 0 = full attention
    # per-layer window pattern: e.g. ("local",)*5 + ("global",) repeating.
    # Empty = uniform (all sliding_window if set, else all global).
    layer_pattern: Tuple[str, ...] = ()
    attn_softcap: float = 0.0      # gemma2 logit soft-capping
    final_softcap: float = 0.0
    causal: bool = True            # False = encoder-only (hubert)
    rope_theta: float = 10000.0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    # hybrid: every k-th layer also applies the shared attention block
    shared_attn_every: int = 0

    # VLM: every k-th layer is cross-attention to image embeddings
    cross_attn_every: int = 0
    n_image_tokens: int = 1601     # stubbed patch-embedding frontend
    # audio: stubbed frame-embedding frontend (encoder input is frames)
    audio_frontend: bool = False

    # distribution hints
    fsdp: bool = False             # shard params/optimizer over the data axis
    remat: bool = True
    # Megatron-style sequence-parallel residual stream (activations sharded
    # over "model" between layers); enabled by the dry-run for train/prefill.
    seq_parallel: bool = False

    # which assigned shapes are runnable (DESIGN.md § 5 skip rules)
    skip_shapes: Tuple[str, ...] = ()
    skip_reason: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    def window_for_layer(self, i: int) -> int:
        """Effective attention window of layer i (0 = full)."""
        if not self.layer_pattern:
            return self.sliding_window
        kind = self.layer_pattern[i % len(self.layer_pattern)]
        return self.sliding_window if kind == "local" else 0

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, v = self.d_model, self.vocab
        n = 2 * v * d  # embed + untied head
        per_layer = 0
        if self.family in ("dense", "vlm", "audio", "moe"):
            attn = d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd \
                + self.n_heads * self.hd * d
            per_layer += attn + 2 * d
        if self.family in ("dense", "vlm", "audio"):
            per_layer += 3 * d * self.d_ff
        if self.family == "moe":
            per_layer += d * self.n_experts  # router
            per_layer += self.n_experts * 3 * d * self.d_ff
            per_layer += self.n_shared_experts * 3 * d * self.d_ff
        if self.family in ("ssm", "hybrid"):
            di, st, nh = self.d_inner, self.ssm_state, self.ssm_nheads
            per_layer += d * (2 * di + 2 * st + nh)  # in_proj (g=1)
            per_layer += self.ssm_conv * (di + 2 * st) + 2 * nh + di
            per_layer += di * d + d  # out_proj + norm
        n += self.n_layers * per_layer
        if self.family == "vlm" and self.cross_attn_every:
            ncross = self.n_layers // self.cross_attn_every
            n += ncross * (2 * (d * self.n_heads * self.hd
                                + d * self.n_kv_heads * self.hd) + d)
        if self.family == "hybrid" and self.shared_attn_every:
            attn = d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd \
                + self.n_heads * self.hd * d
            n += attn + 3 * d * self.d_ff + 2 * d  # one shared attn+MLP block
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        inactive = self.n_layers * (self.n_experts - self.top_k) * 3 * d * self.d_ff
        return full - inactive

    def reduced(self) -> "ArchConfig":
        """Same-family micro config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if not self.layer_pattern
                         else len(self.layer_pattern)),
            d_model=128,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32 if self.n_heads else 0,
            d_ff=256,
            vocab=512,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=32 if self.ssm_state else 64,
            n_image_tokens=16,
            shared_attn_every=min(self.shared_attn_every, 2),
            cross_attn_every=min(self.cross_attn_every, 2),
            fsdp=False,
        )
