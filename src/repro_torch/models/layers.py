"""Core transformer layers, functional style — the PyTorch twin of
``repro/models/layers.py``.

Params are plain dicts of tensors with the reference tree's keys and
shapes.  One attention code path covers GQA, sliding windows (a plain int
per layer: the layers run in a Python loop), logit soft-capping,
bidirectional masks and cross-attention (the vlm family's ``c``-prefixed
weights over ``kv_override``: no rope, no mask).  Long prompts (at least
``FLASH_MIN_SEQ`` keys, no cache, not a cross call) take the flash path,
which launches the B7 kernel (``kernels/flash_attn.py``) on the card, and
its flash backward when a gradient is needed; everything else takes the
grouped dense path in plain PyTorch (differentiated by autograd), as the
reference computes it outside any kernel.  ``attn_specs`` and
``mlp_specs`` give the reference's PartitionSpecs (``distributed.
sharding.P``), which the sharded train step lays over the data axis; the
"model" axis's pins (``_pin``, ``_q_block_spec``, ``_kv_stack_spec``)
change no number on a mesh whose "model" is 1 and are not ported.

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
from ..distributed.sharding import P
from ..kernels.flash_attn import flash_attention, flash_attention_train

Params = Dict[str, torch.Tensor]

FLASH_BLOCK_Q = 512
FLASH_BLOCK_K = 512
FLASH_MIN_SEQ = 2048  # use the blocked path above this many keys
#: elements of the largest temporary of a row-wise op (``by_rows``): 1 GiB
#: in float32
ROW_SLAB = 2 ** 28


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


class NoDraws:
    """What ``init_params(device="meta")`` passes for a generator: the
    device alone.  The parameters are then shapes only."""
    device = torch.device("meta")


def _dense(gen: torch.Generator, shape, scale_axis: int = 0,
           dtype=torch.bfloat16, lead=()) -> torch.Tensor:
    """Normal weights scaled by 1/sqrt(shape[scale_axis]); ``lead`` adds
    leading dimensions (the stacked layers) that do not enter the scale.
    A stacked leaf is drawn one layer at a time: each float32 draw is
    one layer's, scaled in place and written into the ``dtype`` leaf.
    (Drawing the whole leaf in float32 and scaling a copy of it took two
    35 GB temporaries for yi-34b's FFN leaves, (60, 7,168, 20,480), and
    two 31 GB ones for gemma2-27b's.)  On ``meta`` nothing is drawn.
    ``gen`` may carry a rank's blocks (``block``, see
    ``transformer.init_params_block``): the leaf is then allocated as the
    rank's block and each layer's draw narrowed to it along dimension k."""
    lead, shape = tuple(lead), tuple(shape)
    if hasattr(gen, "block"):
        out, k, rank = gen.block(lead, shape, dtype)
        gen = gen.gen
    else:
        out = torch.empty(lead + shape, dtype=dtype, device=gen.device)
        k = rank = None
    if out.device.type == "meta":
        return out
    scale = 1.0 / (shape[scale_axis] ** 0.5)
    for layer in out.view((-1,) + out.shape[len(lead):]):
        w = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        if k is not None:
            w = w.narrow(k, rank * layer.shape[k], layer.shape[k])
        layer.copy_(w.mul_(scale))
    return out


def by_rows(fn, x: torch.Tensor, width: int, *more) -> torch.Tensor:
    """``fn(x, *more)`` for a function of each row (the last axis) alone,
    whose largest temporary is ``width`` wide: in slabs of rows that keep
    that temporary within ``ROW_SLAB`` elements, each written into the
    output, when x has more rows than one slab (a 524,288-token prompt:
    gemma2-27b's FFN intermediates are 39 GB each in one piece).
    ``more`` are tensors with x's rows, sliced with it.  Each row's
    numbers are the ones the whole call gives."""
    rows = x.shape[:-1].numel()
    step = max(1, ROW_SLAB // max(int(width), 1))
    if rows <= step:
        return fn(x, *more)
    flat = [t.reshape(rows, t.shape[-1]) for t in (x,) + more]
    first = fn(*(t[:step] for t in flat))
    out = first.new_empty((rows, first.shape[-1]))
    out[:step] = first
    del first
    for i in range(step, rows, step):
        out[i:i + step] = fn(*(t[i:i + step] for t in flat))
    return out.reshape(x.shape[:-1] + out.shape[-1:])


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    return by_rows(lambda r: _rms_norm(r, w, eps), x, x.shape[-1])


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., seq, heads, hd); positions: (..., seq).  With one row of
    positions, in slabs of positions that keep each float32 temporary
    within ``ROW_SLAB`` elements (each position's numbers are the ones the
    whole call gives)."""
    s = x.shape[-3]
    step = max(1, ROW_SLAB * s // max(x.numel(), 1))
    if positions.dim() != 1 or s <= step:
        return _rope(x, positions, theta)
    out = torch.empty_like(x)
    for i in range(0, s, step):
        out[..., i:i + step, :, :] = _rope(x[..., i:i + step, :, :],
                                           positions[i:i + step], theta)
    return out


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
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


def attn_params(gen: torch.Generator, cfg: ArchConfig, lead=(),
                cross: bool = False, dtype=torch.bfloat16) -> Params:
    """q, k, v and output projections; ``cross`` names them ``cwq`` ...
    ``cwo`` (a vlm layer's cross-attention)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pfx = "c" if cross else ""
    return {
        f"{pfx}wq": _dense(gen, (d, h * hd), dtype=dtype, lead=lead),
        f"{pfx}wk": _dense(gen, (d, kv * hd), dtype=dtype, lead=lead),
        f"{pfx}wv": _dense(gen, (d, kv * hd), dtype=dtype, lead=lead),
        f"{pfx}wo": _dense(gen, (h * hd, d), dtype=dtype, lead=lead),
    }


def attn_specs(cfg: ArchConfig, cross: bool = False, fsdp_axis=None):
    f = fsdp_axis
    pfx = "c" if cross else ""
    return {
        f"{pfx}wq": P(f, "model"),
        f"{pfx}wk": P(f, "model"),
        f"{pfx}wv": P(f, "model"),
        f"{pfx}wo": P("model", f),
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
    When a gradient is needed, ``flash_attention_train`` runs instead: B7
    with its row log-sum-exp, and the flash backward (the reference's
    custom_vjp ``_flash_core``), which recomputes each logits tile."""
    b, sq, h, hd = q.shape
    attend = (flash_attention_train if torch.is_grad_enabled()
              and (q.requires_grad or k.requires_grad or v.requires_grad)
              else flash_attention)
    out = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal=cfg.causal, window=int(window),
                 softcap_val=float(cfg.attn_softcap), bq=FLASH_BLOCK_Q,
                 bk=FLASH_BLOCK_K)
    return out.transpose(1, 2).reshape(b, sq, h * hd)


def attention(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
              positions: torch.Tensor, window: int, kv_override=None,
              cache: Optional[Tuple] = None, cross: bool = False):
    """x: (B, S, d).  kv_override: (B, Skv, d), the source of K and V in
    place of x (the vlm family's image tokens).  cache: (k, v, cur_len)
    for decode, k/v (B, Sc, kv, hd) and ``cur_len`` an int.  ``cross``
    takes the ``c``-prefixed weights, no rope and no mask (a zero bias
    over every key), and never the flash path.  Returns (out,
    new_cache).  Without a cache, new_cache is this call's (k, v), each
    (B, Skv, kv, hd), roped unless ``cross``, which a prefill keeps as
    its cache (the reference returns None and its prefill computes them
    again)."""
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    window = int(window)
    pfx = "c" if cross else ""
    src = kv_override if kv_override is not None else x
    q = (x @ p[f"{pfx}wq"]).reshape(b, s, h, hd)
    k = (src @ p[f"{pfx}wk"]).reshape(b, src.shape[1], kv, hd)
    v = (src @ p[f"{pfx}wv"]).reshape(b, src.shape[1], kv, hd)
    if not cross:
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
        if (not cross and sk >= FLASH_MIN_SEQ
                and s % min(FLASH_BLOCK_Q, s) == 0
                and sk % min(FLASH_BLOCK_K, sk) == 0):
            out = _flash_attention(q, k, v, cfg, window)
            return out @ p[f"{pfx}wo"], new_cache
        if cross:
            bias = torch.zeros(s, sk, device=x.device)
        else:
            bias = _mask_bias(positions, positions, window, cfg.causal)
    # dense path (short sequences / decode / cross) — grouped GQA einsums
    # (no materialized kv repeat)
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
    return out @ p[f"{pfx}wo"], new_cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_params(gen: torch.Generator, d: int, ff: int, lead=(),
               dtype=torch.bfloat16) -> Params:
    return {
        "w_gate": _dense(gen, (d, ff), dtype=dtype, lead=lead),
        "w_up": _dense(gen, (d, ff), dtype=dtype, lead=lead),
        "w_down": _dense(gen, (ff, d), scale_axis=0, dtype=dtype,
                         lead=lead),
    }


def mlp_specs(fsdp_axis=None):
    f = fsdp_axis
    return {"w_gate": P(f, "model"), "w_up": P(f, "model"),
            "w_down": P("model", f)}


def _swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ p["w_gate"])
            * (x @ p["w_up"])) @ p["w_down"]


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return by_rows(lambda r: _swiglu(p, r), x, p["w_gate"].shape[-1])
