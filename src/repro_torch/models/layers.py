"""Core transformer layers, functional style — the PyTorch twin of
``repro/models/layers.py``.

Params are plain dicts of tensors with the reference tree's keys and
shapes.  One attention code path covers GQA, sliding windows (a plain int
per layer: the layers run in a Python loop), logit soft-capping and
bidirectional masks.  Long prompts (at least ``FLASH_MIN_SEQ`` keys, no
cache) take the flash path, which launches the B7 kernel
(``kernels/flash_attn.py``) on the card; everything else takes the
grouped dense path in plain PyTorch, as the reference computes it outside
any kernel.  Cross-attention (the vlm family) and the mesh sharding
specs are not ported.

Numerics follow the reference: ``rms_norm`` and ``rope`` compute in
float32 and cast back, the dense path rounds the q . k product to the
activations' dtype before it scales it, and the softmax weights are cast
to the activations' dtype before the weighted sum.  A decode cache is
updated in place (the reference returns a new one); the returned tuple
holds the same tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attn import flash_attention

Params = Dict[str, torch.Tensor]

FLASH_BLOCK_Q = 512
FLASH_BLOCK_K = 512
FLASH_MIN_SEQ = 2048  # use the blocked path above this many keys


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _dense(gen: torch.Generator, shape, scale_axis: int = 0,
           dtype=torch.bfloat16, lead=()) -> torch.Tensor:
    """Normal weights scaled by 1/sqrt(shape[scale_axis]); ``lead`` adds
    leading dimensions (the stacked layers) that do not enter the
    scale."""
    scale = 1.0 / (shape[scale_axis] ** 0.5)
    w = torch.randn(tuple(lead) + tuple(shape), generator=gen,
                    device=gen.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., seq, heads, hd); positions: (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    # log(theta) in float32, as jnp.log computes it
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (log_theta.to(x.device) / half))
    ang = positions[..., None].float() * freqs          # (..., seq, half)
    cos = torch.cos(ang)[..., None, :]                  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attn_params(gen: torch.Generator, cfg: ArchConfig, lead=()) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": _dense(gen, (d, h * hd), lead=lead),
        "wk": _dense(gen, (d, kv * hd), lead=lead),
        "wv": _dense(gen, (d, kv * hd), lead=lead),
        "wo": _dense(gen, (h * hd, d), lead=lead),
    }


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
               causal: bool) -> torch.Tensor:
    """Additive mask: causal + optional sliding window (0 = full)."""
    ok = torch.ones(q_pos.shape[-1], k_pos.shape[-1], dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - max(window, 1))
    return torch.where(ok, 0.0, -1e30)


def _flash_attention(q, k, v, cfg: ArchConfig, window: int):
    """Blocked online-softmax attention over the model's (B, S, H, hd)
    activations: the B7 kernel on the card, its plain version on the CPU
    (``kernels.flash_attention`` picks by device).  The kernel reads the
    (B, H, S, hd) views through their strides, so nothing is copied.
    Forward only: the reference's flash backward comes with training."""
    b, sq, h, hd = q.shape
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=cfg.causal,
                          window=int(window),
                          softcap_val=float(cfg.attn_softcap),
                          bq=FLASH_BLOCK_Q, bk=FLASH_BLOCK_K)
    return out.transpose(1, 2).reshape(b, sq, h * hd)


def attention(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
              positions: torch.Tensor, window: int,
              cache: Optional[Tuple] = None):
    """x: (B, S, d).  cache: (k, v, cur_len) for decode, k/v (B, Sc, kv,
    hd) and ``cur_len`` an int.  Returns (out, new_cache).  Without a
    cache, new_cache is this call's roped (k, v), each (B, S, kv, hd),
    which a prefill keeps as its cache (the reference returns None and
    its prefill computes them again)."""
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    window = int(window)
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, kv, hd)
    v = (x @ p["wv"]).reshape(b, s, kv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is not None:
        ck, cv, cur = cache
        cur = int(cur)
        sc = ck.shape[1]
        # Ring-buffer write at cur % Sc (window caches are sized Sc ==
        # window and wrap; full caches have Sc >= max len).  The start is
        # clamped so the update fits, as dynamic_update_slice does.
        start = min(cur % sc, sc - s)
        ck[:, start:start + s] = k.to(ck.dtype)
        cv[:, start:start + s] = v.to(cv.dtype)
        k, v = ck, cv
        new_cache = (ck, cv, cur + s)
        # slot j holds the most recent token p <= cur with p = j (mod Sc);
        # torch's % is a floor modulo, as jnp's is
        slot = torch.arange(sc, dtype=torch.int32, device=x.device)
        kpos = cur - ((cur - slot) % sc)
        bias = _mask_bias(positions, kpos, window, cfg.causal)
        bias = torch.where(kpos[None, :] >= 0, bias, -1e30)  # unwritten
    else:
        new_cache = (k, v)
        sk = k.shape[1]
        if (sk >= FLASH_MIN_SEQ and s % min(FLASH_BLOCK_Q, s) == 0
                and sk % min(FLASH_BLOCK_K, sk) == 0):
            out = _flash_attention(q, k, v, cfg, window)
            return out @ p["wo"], new_cache
        bias = _mask_bias(positions, positions, window, cfg.causal)
    # dense path (short sequences / decode) — grouped GQA einsums (no
    # materialized kv repeat)
    rep = h // kv
    qg = q.reshape(b, s, kv, rep, hd)
    # a float32 query against a bfloat16 cache computes in float32, as
    # jnp.einsum promotes
    dt = torch.promote_types(q.dtype, k.dtype)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(dt), k.to(dt)).float()
    logits = logits / (hd ** 0.5)
    logits = softcap(logits, cfg.attn_softcap)
    logits = logits + bias[None, None, None, :, :]
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    dt = torch.promote_types(w.dtype, v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w.to(dt),
                       v.to(dt)).reshape(b, s, h * hd)
    return out @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_params(gen: torch.Generator, d: int, ff: int, lead=()) -> Params:
    return {
        "w_gate": _dense(gen, (d, ff), lead=lead),
        "w_up": _dense(gen, (d, ff), lead=lead),
        "w_down": _dense(gen, (ff, d), scale_axis=0, lead=lead),
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ p["w_gate"])
            * (x @ p["w_up"])) @ p["w_down"]
