"""The LM: one functional transformer — the PyTorch twin of
``repro/models/transformer.py`` for the ``dense``, ``moe`` and ``ssm``
families.

Dense covers GQA, sliding windows, alternating local/global layers and
soft-capping; moe adds fine-grained routed experts and shared experts;
ssm is Mamba2 (``models/ssm.py``: chunked SSD, O(1) decode state).  The
``hybrid``, ``vlm`` and ``audio`` families raise ``NotImplementedError``
(ROADMAP Queue A10b).

Execution paths:

* ``forward`` / ``loss_fn`` — logits for every position, and the
  training loss over them.  With ``cfg.remat`` and autograd recording,
  each layer is recomputed in the backward
  (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` with
  ``nothing_saveable``): only the residual stream between layers is
  kept.  Attention that needs a gradient takes the flash kernels with
  their backward (``kernels.flash_attention_train``).
* ``prefill`` — ``forward`` over the prompt that also returns every
  layer's roped K and V, stacked (L, B, S, kv, hd), or for the ssm family
  every layer's final conv and SSM states, and only the last position's
  logits.
* ``decode_step`` — one token through per-layer ring caches sized to each
  layer's attention window, or the SSM layers' O(1) states
  (``init_decode_cache``).

The reference scans over the stacked layers; here a Python loop walks
them, so each layer's window is a plain int.  Parameters keep the
reference tree's keys and shapes (``layers`` stacked with a leading L),
so ``interop.params_from_numpy`` copies the reference's parameters leaf
by leaf.  Random parameters come from a ``torch.Generator`` on the
target device: the same seed gives other numbers than ``jax.random``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..kernels._build import resolve_device
from .layers import (_dense, attention, attn_params, mlp, mlp_params,
                     rms_norm, rope, softcap)
from .moe import moe_forward, moe_params
from .ssm import ssm_forward, ssm_params

Params = Dict[str, Any]

PORTED_FAMILIES = ("dense", "moe", "ssm")


def _require_family(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the "
            f"port has {PORTED_FAMILIES} (ROADMAP Queue A10b: hybrid, vlm "
            f"and audio)")


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator] = None, *,
                device="cuda") -> Params:
    """Random parameters in the reference's tree.  ``gen`` is a
    ``torch.Generator`` on ``device``; without one, a generator seeded
    with 0 is made there."""
    _require_family(cfg)
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    if gen.device.type != dev.type:
        raise ValueError(f"the generator is on {gen.device}, not {dev}")
    d, lead = cfg.d_model, (cfg.n_layers,)
    zeros = dict(dtype=torch.bfloat16, device=dev)
    layers: Params = {"ln1": torch.zeros(cfg.n_layers, d, **zeros)}
    if cfg.family == "ssm":
        layers.update(ssm_params(gen, cfg, lead=lead))
        return {"embed": _dense(gen, (cfg.vocab, d)),
                "lm_head": _dense(gen, (d, cfg.vocab)),
                "final_norm": torch.zeros(d, **zeros), "layers": layers}
    layers.update(attn_params(gen, cfg, lead=lead))
    layers["ln2"] = torch.zeros(cfg.n_layers, d, **zeros)
    if cfg.family == "moe":
        layers.update(moe_params(gen, cfg, lead=lead))
    else:
        layers.update(mlp_params(gen, d, cfg.d_ff, lead=lead))
    return {
        "embed": _dense(gen, (cfg.vocab, d)),
        "lm_head": _dense(gen, (d, cfg.vocab)),
        "final_norm": torch.zeros(d, **zeros),
        "layers": layers,
    }


def layer_flags(cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """Per-layer flags, as the reference's ``layer_flags``: each layer's
    attention window, and whether it is a cross-attention or
    shared-block layer (int32, on the CPU)."""
    L = cfg.n_layers
    window = [cfg.window_for_layer(i) for i in range(L)]
    is_cross = [1 if (cfg.cross_attn_every
                      and (i + 1) % cfg.cross_attn_every == 0) else 0
                for i in range(L)]
    use_shared = [1 if (cfg.shared_attn_every
                        and (i + 1) % cfg.shared_attn_every == 0) else 0
                  for i in range(L)]
    return {k: torch.tensor(v, dtype=torch.int32) for k, v in
            (("window", window), ("is_cross", is_cross),
             ("use_shared", use_shared))}


def _layer(params: Params, i: int) -> Params:
    """Layer i's parameters: views into the stacked tensors."""
    return {k: v[i] for k, v in params["layers"].items()}


def _embed(params: Params, tokens: torch.Tensor, cfg: ArchConfig):
    """Token embedding times sqrt(d) rounded to bfloat16 first, as the
    reference does (sqrt(1536) = 39.19 becomes 39.25)."""
    scale = torch.tensor(math.sqrt(float(cfg.d_model)), dtype=torch.bfloat16)
    return params["embed"][tokens] * scale


def _block(p: Params, x: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor, window: int):
    """One layer.  Returns (x, aux): an attention layer's roped (K, V),
    an SSM layer's final (conv, ssm) states."""
    if cfg.family == "ssm":
        out, st = ssm_forward(p, rms_norm(x, p["ln1"]), cfg)
        return x + out, st
    a, kv = attention(p, rms_norm(x, p["ln1"]), cfg, positions=positions,
                      window=window)
    h = x + a
    inner = rms_norm(h, p["ln2"])
    if cfg.family == "moe":
        return h + moe_forward(p, inner, cfg), kv
    return h + mlp(p, inner), kv


def _head(params: Params, x: torch.Tensor, cfg: ArchConfig):
    x = rms_norm(x, params["final_norm"])
    return softcap((x @ params["lm_head"]).float(), cfg.final_softcap)


# ---------------------------------------------------------------------------
# forward, prefill and decode
# ---------------------------------------------------------------------------


def forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig):
    """tokens (B, S) int.  Returns float32 logits (B, S, V).  With
    ``cfg.remat`` and autograd recording, each layer keeps only its input
    for the backward and runs again there."""
    _require_family(cfg)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp, window = _layer(params, i), cfg.window_for_layer(i)

        def body(h, lp=lp, window=window):
            return _block(lp, h, cfg, positions, window)[0]
        x = checkpoint(body, x, use_reentrant=False) if remat else body(x)
    return _head(params, x, cfg)


def loss_fn(params: Params, batch: Dict[str, Any],
            cfg: ArchConfig) -> torch.Tensor:
    """Mean next-token cross-entropy over the labels >= 0: logsumexp of
    the logits minus the label's logit, as the reference computes it (no
    log-softmax materialised).  ``batch`` holds ``tokens`` and ``labels``
    (B, S) integer tensors.  Returns a float32 0-dim tensor."""
    logits = forward(params, batch["tokens"], cfg)
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = lse - ll
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig):
    """Forward over the prompt.  Returns (last-token logits (B, 1, V),
    {"k", "v"}: each layer's roped K and V, stacked (L, B, S, kv, hd)) —
    for the ssm family {"conv" (L, B, d_conv - 1, d_conv_in), "ssm" (L,
    B, nh, hd, state) float32}: each layer's final states."""
    _require_family(cfg)
    x = _embed(params, tokens, cfg)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    if cfg.family == "ssm":
        convs, ssms = [], []
        for i in range(cfg.n_layers):
            x, (conv, st) = _block(_layer(params, i), x, cfg, positions, 0)
            convs.append(conv)
            ssms.append(st)
        return _head(params, x[:, -1:, :], cfg), {
            "ssm": torch.stack(ssms), "conv": torch.stack(convs)}
    kv, hd = cfg.n_kv_heads, cfg.hd
    ks = torch.empty(cfg.n_layers, b, s, kv, hd, dtype=x.dtype,
                     device=x.device)
    vs = torch.empty_like(ks)
    for i in range(cfg.n_layers):
        x, (k, v) = _block(_layer(params, i), x, cfg, positions,
                           cfg.window_for_layer(i))
        ks[i], vs[i] = k, v
    return _head(params, x[:, -1:, :], cfg), {"k": ks, "v": vs}


def init_decode_cache(cfg: ArchConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, *, device="cuda") -> List:
    """Per-layer ring caches: local layers hold min(window, max_seq)
    positions, global layers max_seq; SSM layers their O(1) conv state
    (in ``dtype``) and SSM state (float32)."""
    _require_family(cfg)
    dev = resolve_device(device)
    cache: List = []
    if cfg.family == "ssm":
        return [{"conv": torch.zeros(batch, cfg.ssm_conv - 1,
                                     cfg.d_inner + 2 * cfg.ssm_state,
                                     dtype=dtype, device=dev),
                 "ssm": torch.zeros(batch, cfg.ssm_nheads, cfg.ssm_headdim,
                                    cfg.ssm_state, dtype=torch.float32,
                                    device=dev)}
                for _ in range(cfg.n_layers)]
    for i in range(cfg.n_layers):
        w = cfg.window_for_layer(i)
        sc = min(w, max_seq) if w else max_seq
        shape = (batch, sc, cfg.n_kv_heads, cfg.hd)
        cache.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                      "v": torch.zeros(shape, dtype=dtype, device=dev)})
    return cache


def decode_step(params: Params, cache: List, token: torch.Tensor, cur: int,
                cfg: ArchConfig):
    """One decode step.  token (B, 1) int; cur the current length, an int
    (all rows share it).  Returns (logits (B, 1, V), new_cache): the
    attention caches are updated in place and returned, the SSM states
    replaced by new ones."""
    _require_family(cfg)
    cur = int(cur)
    x = _embed(params, token, cfg)
    positions = torch.tensor([cur], dtype=torch.int32, device=x.device)
    new_cache: List = []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        c = cache[i]
        if cfg.family == "ssm":
            out, st = ssm_forward(lp, rms_norm(x, lp["ln1"]), cfg,
                                  state=(c["conv"], c["ssm"]))
            x = x + out
            new_cache.append({"conv": st[0], "ssm": st[1]})
            continue
        a, kvc = attention(lp, rms_norm(x, lp["ln1"]), cfg,
                           positions=positions,
                           window=cfg.window_for_layer(i),
                           cache=(c["k"], c["v"], cur))
        x = x + a
        new_cache.append({"k": kvc[0], "v": kvc[1]})
        inner = rms_norm(x, lp["ln2"])
        if cfg.family == "moe":
            x = x + moe_forward(lp, inner, cfg)
        else:
            x = x + mlp(lp, inner)
    return _head(params, x, cfg), new_cache
