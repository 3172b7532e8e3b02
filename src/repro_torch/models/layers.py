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
sharding.P``), which the train and serve steps lay over the data and
model axes: ``attention(tp=)`` and ``mlp(tp=)`` are Megatron's column-
and row-parallel layers on a rank's blocks (``_tp_attention``), their
collectives issued by ``sharding.TensorParallel`` as autograd Functions
(the training backward's conjugates: the input's gradient all-reduced or
reduce-scattered, the cut projections' gradients reduce-scattered).  The
reference's pins (``_pin``, ``_q_block_spec``, ``_kv_stack_spec``) are
layouts GSPMD reads; the port's fast path is the layout they ask for (kv
heads over "model" when M divides them).

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
from ..distributed.sharding import P, model_dim
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
    rank's block and each layer's draw narrowed to it along each cut
    dimension k (the data axes' and the model axis')."""
    lead, shape = tuple(lead), tuple(shape)
    if hasattr(gen, "block"):
        out, cuts = gen.block(lead, shape, dtype)
        gen = gen.gen
    else:
        out = torch.empty(lead + shape, dtype=dtype, device=gen.device)
        cuts = ()
    if out.device.type == "meta":
        return out
    scale = 1.0 / (shape[scale_axis] ** 0.5)
    for layer in out.view((-1,) + out.shape[len(lead):]):
        w = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        for k, i in cuts:
            w = w.narrow(k, i * layer.shape[k], layer.shape[k])
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
              cache: Optional[Tuple] = None, cross: bool = False, tp=None):
    """x: (B, S, d).  kv_override: (B, Skv, d), the source of K and V in
    place of x (the vlm family's image tokens).  cache: (k, v, cur_len)
    for decode, k/v (B, Sc, kv, hd) and ``cur_len`` an int.  ``cross``
    takes the ``c``-prefixed weights, no rope and no mask (a zero bias
    over every key), and never the flash path.  Returns (out,
    new_cache).  Without a cache, new_cache is this call's (k, v), each
    (B, Skv, kv, hd), roped unless ``cross``, which a prefill keeps as
    its cache (the reference returns None and its prefill computes them
    again).  ``tp`` (a ``distributed.sharding.TensorParallel``): ``p``
    holds this rank's column blocks of wq, wk, wv and row block of wo
    and the cache this rank's block (``_tp_attention``)."""
    if tp is not None and tp.model > 1:
        if cross or kv_override is not None:
            raise ValueError("attention: cross-attention over \"model\" is "
                             "not ported")
        return _tp_attention(p, x, cfg, positions, int(window), cache, tp)
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pfx = "c" if cross else ""
    src = kv_override if kv_override is not None else x
    q = (x @ p[f"{pfx}wq"]).reshape(b, s, h, hd)
    k = (src @ p[f"{pfx}wk"]).reshape(b, src.shape[1], kv, hd)
    v = (src @ p[f"{pfx}wv"]).reshape(b, src.shape[1], kv, hd)
    if not cross:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out, new_cache = _attend(q, k, v, cfg, positions, int(window), cache,
                             cross=cross)
    return out @ p[f"{pfx}wo"], new_cache


def _ring_write(cache, k, v, positions, window, cfg, heads=None):
    """Write this step's K and V into a decode ring cache (k, v, cur) at
    cur % Sc (window caches are sized Sc == window and wrap; full caches
    have Sc >= max len; the start is clamped so the update fits, as
    dynamic_update_slice does).  Returns (k, v of the cache, new_cache,
    the additive bias over its slots); ``heads`` = (g0, g1) attends to
    those kv heads of the cache only."""
    ck, cv, cur = cache
    cur = int(cur)
    s, sc = k.shape[1], ck.shape[1]
    start = min(cur % sc, sc - s)
    ck[:, start:start + s] = k.to(ck.dtype)
    cv[:, start:start + s] = v.to(cv.dtype)
    # slot j holds the most recent token p <= cur with p = j (mod Sc);
    # torch's % is a floor modulo, as jnp's is
    slot = torch.arange(sc, dtype=torch.int32, device=k.device)
    kpos = cur - ((cur - slot) % sc)
    bias = _mask_bias(positions, kpos, window, cfg.causal)
    bias = torch.where(kpos[None, :] >= 0, bias, -1e30)  # unwritten
    kk, vv = ck, cv
    if heads is not None:
        kk, vv = ck[:, :, heads[0]:heads[1]], cv[:, :, heads[0]:heads[1]]
    return kk, vv, (ck, cv, cur + s), bias


def _attend(q, k, v, cfg: ArchConfig, positions, window: int, cache,
            cross: bool = False, heads=None):
    """Attention of roped q (B, S, H, hd) over k / v (B, Skv, KV, hd),
    H a whole number of GQA groups of KV heads: through the decode
    ``cache`` (``_ring_write``; ``heads`` its kv heads to attend to),
    the flash path for long prompts, or the grouped dense path.  Returns
    (out (B, S, H·hd), new_cache)."""
    b, s, h, hd = q.shape
    if cache is not None:
        k, v, new_cache, bias = _ring_write(cache, k, v, positions, window,
                                            cfg, heads)
    else:
        new_cache = (k, v)
        sk = k.shape[1]
        if (not cross and sk >= FLASH_MIN_SEQ
                and s % min(FLASH_BLOCK_Q, s) == 0
                and sk % min(FLASH_BLOCK_K, sk) == 0):
            return _flash_attention(q, k, v, cfg, window), new_cache
        if cross:
            bias = torch.zeros(s, sk, device=q.device)
        else:
            bias = _mask_bias(positions, positions, window, cfg.causal)
    # dense path (short sequences / decode / cross) — grouped GQA einsums
    # (no materialized kv repeat)
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    # a float32 query against a bfloat16 cache computes in float32, as
    # jnp.einsum promotes
    dt = torch.promote_types(q.dtype, k.dtype)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(dt), k.to(dt)).float()
    w = _softmax(logits, bias, cfg, hd, q.dtype)
    dt = torch.promote_types(w.dtype, v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w.to(dt),
                       v.to(dt)).reshape(b, s, h * hd)
    return out, new_cache


def _softmax(logits, bias, cfg: ArchConfig, hd: int, dtype):
    """Scaled, soft-capped and masked float32 logits -> the softmax
    weights in the activations' ``dtype``."""
    logits = logits / (hd ** 0.5)
    logits = softcap(logits, cfg.attn_softcap)
    logits = logits + bias[None, None, None, :, :]
    return torch.softmax(logits, dim=-1).to(dtype)


def kv_layout(spec: P, mesh) -> str:
    """How a rank's decode cache holds a layer's K and V (B, S, kv, hd)
    under their sanitized ``spec`` (``launch.steps.kv_pspec``): "heads"
    (its kv heads over "model"), "hd" (every kv head's slice of hd) or
    "whole"."""
    return {None: "whole", 2: "heads", 3: "hd"}[model_dim(spec, mesh)]


def layer_cut(tp, name: str) -> bool:
    """Whether ``tp``'s specs cut a layer's leaf ``name`` over "model"
    (False for a leaf the layers lack)."""
    spec = tp.specs["layers"].get(name)
    return spec is not None and tp.split(spec)


def _tp_attention(p: Params, x, cfg: ArchConfig, positions, window: int,
                  cache, tp):
    """Attention on a rank of the model axis: ``x`` whole (B, S, d) on
    every rank, ``p`` the rank's column blocks of wq, wk and wv (those
    the specs cut) and its row block of wo.

    * The fast path (``kv_layout`` "heads": M divides the kv
      heads): the rank's columns are whole q heads and their whole kv
      heads, so attention is local (B7 on the rank's heads in a long
      prefill), and its cache holds its kv heads.
    * The general path: a column block may split a head or a GQA group,
      so the cut projections are all-gathered (one collective), and the
      rank computes the whole GQA groups that its wo rows cover, then
      takes the slice of their output those rows read.  Its cache holds
      every kv head ("whole"), or every kv head's slice of hd ("hd"),
      for which a decode's logits are partial sums over hd, all-reduced
      before the softmax, and its output slices are all-gathered.

    wo's partial products are summed over "model" (``tp.finish``: an
    all-reduce, or under ``tp.sp`` a reduce-scatter along the sequence);
    a wo the specs left whole gives the whole output."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    M, rep = tp.model, h // kv
    split = {n: layer_cut(tp, n) for n in ("wq", "wk", "wv", "wo")}
    theta = cfg.rope_theta
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    layout = kv_layout(tp.kv_spec, tp.mesh)
    if layout == "heads":
        if not (split["wq"] and split["wk"] and split["wo"]):
            raise ValueError("attention: kv heads divide \"model\" but the "
                             "specs do not cut wq, wk and wo")
        q = rope(q.reshape(b, s, h // M, hd), positions, theta)
        k = rope(k.reshape(b, s, kv // M, hd), positions, theta)
        out, new_cache = _attend(q, k, v.reshape(b, s, kv // M, hd), cfg,
                                 positions, window, cache)
        return tp.finish(partial=out @ p["wo"]), new_cache
    cut = [n for n in ("wq", "wk", "wv") if split[n]]
    if cut:
        got = dict(zip(cut, tp.all_gather([dict(wq=q, wk=k, wv=v)[n]
                                           for n in cut], [2] * len(cut))))
        q, k, v = (got.get(n, t) for n, t in (("wq", q), ("wk", k),
                                              ("wv", v)))
    q = rope(q.reshape(b, s, h, hd), positions, theta)
    k = rope(k.reshape(b, s, kv, hd), positions, theta)
    v = v.reshape(b, s, kv, hd)
    # wo's rows [lo, lo + rows) of the (h·hd) output; the GQA groups
    # [g0, g1) whose heads cover them
    rows = h * hd // M if split["wo"] else h * hd
    lo = tp.m * rows if split["wo"] else 0
    g0, g1 = lo // (hd * rep), -(-(lo + rows) // (hd * rep))
    c = hd // M
    c0 = tp.m * c
    if cache is None:
        new_cache = ((k[..., c0:c0 + c], v[..., c0:c0 + c]) if layout == "hd"
                     else (k, v))
        out, _ = _attend(q[:, :, g0 * rep:g1 * rep], k[:, :, g0:g1],
                         v[:, :, g0:g1], cfg, positions, window, None)
    elif layout == "hd":
        ck, cv, new_cache, bias = _ring_write(
            cache, k[..., c0:c0 + c], v[..., c0:c0 + c], positions, window,
            cfg)
        g0 = 0
        qg = q.reshape(b, s, kv, rep, hd)[..., c0:c0 + c]
        dt = torch.promote_types(q.dtype, ck.dtype)
        part = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), ck.float())
        logits = tp.all_reduce(part).to(dt).float()
        w = _softmax(logits, bias, cfg, hd, x.dtype)
        dt = torch.promote_types(w.dtype, cv.dtype)
        o = torch.einsum("bgrqk,bkgd->bqgrd", w.to(dt), cv.to(dt))
        out = tp.all_gather([o], [4])[0].reshape(b, s, h * hd)
    else:
        out, new_cache = _attend(q[:, :, g0 * rep:g1 * rep], k, v, cfg,
                                 positions, window, cache, heads=(g0, g1))
    y = out[..., lo - g0 * rep * hd:lo - g0 * rep * hd + rows] @ p["wo"]
    if split["wo"]:
        return tp.finish(partial=y), new_cache
    return tp.finish(whole=y), new_cache


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


def mlp(p: Params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """SwiGLU.  ``tp``: ``p`` holds this rank's column blocks of w_gate
    and w_up and row block of w_down (where the specs cut them), so the
    product is a partial sum over "model" (``tp.finish``)."""
    y = by_rows(lambda r: _swiglu(p, r), x, p["w_gate"].shape[-1])
    if tp is None or tp.model == 1:
        return y
    if layer_cut(tp, "w_down"):
        return tp.finish(partial=y)
    return tp.finish(whole=y)
