"""The LM: one functional transformer — the PyTorch twin of
``repro/models/transformer.py`` for all six families.

Dense covers GQA, sliding windows, alternating local/global layers and
soft-capping; moe adds fine-grained routed experts and shared experts;
ssm is Mamba2 (``models/ssm.py``: chunked SSD, O(1) decode state);
hybrid is Mamba2 layers with one shared attention block (attention and
MLP, one parameter set, ``params["shared_attn"]``) applied after every
``shared_attn_every``-th layer; vlm is dense layers of which every
``cross_attn_every``-th attends to the image tokens ``img`` (B, Sv, d)
with its ``c``-prefixed weights instead of attending to itself; audio is
a bidirectional encoder over pre-embedded ``frames`` (B, S, d), cast to
bfloat16, in place of tokens.

Execution paths:

* ``forward`` / ``loss_fn`` — logits for every position, and the
  training loss over them.  With ``cfg.remat`` and autograd recording,
  each layer (a hybrid layer with its shared block) is recomputed in the
  backward (``torch.utils.checkpoint``, the reference's
  ``jax.checkpoint`` with ``nothing_saveable``): only the residual
  stream between layers is kept.  Attention that needs a gradient takes
  the flash kernels with their backward
  (``kernels.flash_attention_train``).
* ``prefill`` — ``forward`` over the prompt that also returns every
  layer's roped K and V, stacked (L, B, S, kv, hd) (a vlm cross layer's
  too: its ``ln1``-normed input through ``wk``/``wv``, as the reference
  emits though the layer never attends to itself), or for the ssm and
  hybrid families every layer's final conv and SSM states (the shared
  block's K/V are not emitted, as in the reference), and only the last
  position's logits.
* ``decode_step`` — one token through per-layer ring caches sized to each
  layer's attention window, the SSM layers' O(1) states and the hybrid's
  shared-block caches (``init_decode_cache``).  A vlm cross layer reads
  ``img`` and leaves its cache entry as it is.

The reference scans over the stacked layers; here a Python loop walks
them, so each layer's window and role (cross, shared) is a plain int.
Parameters keep the reference tree's keys and shapes (``layers`` stacked
with a leading L, a vlm layer's cross weights on every layer as the
reference stacks them), so ``interop.params_from_numpy`` copies the
reference's parameters leaf by leaf.  Random parameters come from a
``torch.Generator`` on the target device: the same seed gives other
numbers than ``jax.random``.

``param_specs`` gives the reference's PartitionSpecs of the tree (the
"model" axis for tensor parallelism, FSDP over "data" for the configs
with ``fsdp``).  ``forward`` and ``loss_terms`` take ``dp=`` (a
``distributed.sharding.DataParallel``): the parameter tree then holds
this rank's blocks, ``embed``, ``lm_head``, ``final_norm`` and the
hybrid's ``shared_attn`` are gathered whole once before the layers, and
each layer's sharded leaves inside the layer's checkpointed body, so
that the backward's recomputation gathers them again (the reference's
ZeRO-3 all-gather per layer inside its scan); each gather's backward
reduce-scatters the gradients.  They take ``tp=`` (a
``TensorParallel``; dense and moe) for the train step over ("data",
"model"): the same gathers over "data", Megatron's column- and
row-parallel layers over "model", experts and the vocabulary cut over
it, and with ``cfg.seq_parallel`` the residual stream between layers
the rank's (B, S/M, d) block (the reference's ``_seq_shard``); the loss
over a cut vocabulary is computed on the rank's columns
(``_VocabNLL``).  ``model_partial`` names the leaves whole over "model"
whose gradient is a part of a sum over it.  ``init_params_block`` draws
a rank's blocks of the parameters ``init_params`` draws, a layer at a
time.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..distributed.sharding import (DataParallel, P, TensorParallel,
                                    all_reduce_, block_cuts, gather_tree,
                                    model_dim, shard)
from ..kernels._build import resolve_device
from ..tree import flatten_with_paths, tree_map
from .layers import (NoDraws, _dense, attention, attn_params, attn_specs,
                     kv_layout, mlp, mlp_params, mlp_specs, rms_norm, rope,
                     softcap)
from .moe import moe_forward, moe_params, moe_specs
from .ssm import ssm_forward, ssm_params, ssm_specs

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator] = None, *,
                device="cuda", dtype=torch.bfloat16) -> Params:
    """Random parameters in the reference's tree.  ``gen`` is a
    ``torch.Generator`` on ``device``; without one, a generator seeded
    with 0 is made there.  On ``device="meta"`` the tree holds shapes
    only (no generator, nothing drawn).  ``dtype`` is the type of every
    leaf the reference keeps in bfloat16 (float32: the weights drawn and
    kept in float32, for checks in float32 without a cast copy)."""
    dev = resolve_device(device)
    if dev.type == "meta" and not hasattr(gen, "block"):
        gen = NoDraws()
    elif gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    if gen.device.type != dev.type:
        raise ValueError(f"the generator is on {gen.device}, not {dev}")
    d, lead = cfg.d_model, (cfg.n_layers,)
    zeros = dict(dtype=dtype, device=dev)
    kw = dict(lead=lead, dtype=dtype)
    layers: Params = {"ln1": torch.zeros(cfg.n_layers, d, **zeros)}
    if cfg.family in ("ssm", "hybrid"):
        layers.update(ssm_params(gen, cfg, **kw))
    else:
        layers.update(attn_params(gen, cfg, **kw))
        layers["ln2"] = torch.zeros(cfg.n_layers, d, **zeros)
        if cfg.family == "moe":
            layers.update(moe_params(gen, cfg, **kw))
        else:
            layers.update(mlp_params(gen, d, cfg.d_ff, **kw))
        if cfg.family == "vlm":
            layers.update(attn_params(gen, cfg, cross=True, **kw))
            layers["cln"] = torch.zeros(cfg.n_layers, d, **zeros)
    params: Params = {
        "embed": _dense(gen, (cfg.vocab, d), dtype=dtype),
        "lm_head": _dense(gen, (d, cfg.vocab), dtype=dtype),
        "final_norm": torch.zeros(d, **zeros),
        "layers": layers,
    }
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        shared: Params = {"ln1": torch.zeros(d, **zeros),
                          "ln2": torch.zeros(d, **zeros)}
        shared.update(attn_params(gen, cfg, dtype=dtype))
        shared.update(mlp_params(gen, d, cfg.d_ff, dtype=dtype))
        params["shared_attn"] = shared
    return params


def _layer_specs(cfg: ArchConfig, f) -> Params:
    sp: Params = {"ln1": P(None)}
    if cfg.family in ("ssm", "hybrid"):
        sp.update(ssm_specs(cfg, f))
        return sp
    sp.update(attn_specs(cfg))
    sp["ln2"] = P(None)
    if cfg.family == "moe":
        sp.update(moe_specs(cfg, f))
    else:
        sp.update(mlp_specs(f))
    if cfg.family == "vlm":
        sp.update(attn_specs(cfg, cross=True, fsdp_axis=f))
        sp["cln"] = P(None)
    # FSDP-shard the attention/mlp matrices' non-model axis
    if f is not None:
        for k in ("wq", "wk", "wv", "cwq", "cwk", "cwv", "w_gate", "w_up"):
            if k in sp:
                sp[k] = P(f, "model")
        for k in ("wo", "cwo", "w_down"):
            if k in sp:
                sp[k] = P("model", f)
    return sp


def param_specs(cfg: ArchConfig, *, fsdp: Optional[bool] = None) -> Params:
    """The parameter tree's PartitionSpecs: TP over "model", FSDP over
    "data" when ``fsdp`` (``cfg.fsdp`` by default); the stacked layers
    add a leading unsharded axis."""
    f = "data" if (cfg.fsdp if fsdp is None else fsdp) else None
    lsp = _layer_specs(cfg, f)
    specs: Params = {
        "embed": P("model", f),        # vocab-parallel embedding
        "lm_head": P(f, "model"),
        "final_norm": P(None),
        "layers": {k: P(None, *s) for k, s in lsp.items()},
    }
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        ssp = {"ln1": P(None), "ln2": P(None)}
        ssp.update(attn_specs(cfg, fsdp_axis=f))
        ssp.update(mlp_specs(f))
        specs["shared_attn"] = ssp
    return specs


class _BlockDraws:
    """``_dense``'s draws for a rank (``block``): each leaf allocated as
    this rank's block (``cuts``: each draw's [(sharded dimension of the
    whole leaf, shards, this rank's index)], over the data axes and
    "model"), each layer drawn whole from ``gen`` and narrowed to it.
    With no ``gen`` the leaves are whole on ``meta`` and nothing is
    drawn.  ``leaves``: the leaves in the order drawn."""

    def __init__(self, gen: Optional[torch.Generator] = None, cuts=()):
        self.gen = gen
        self.device = torch.device("meta") if gen is None else gen.device
        self.cuts = iter(cuts)
        self.leaves: List[torch.Tensor] = []

    def block(self, lead, shape, dtype):
        kept, out_cuts = list(shape), []
        for d, n, i in ([] if self.gen is None else next(self.cuts)):
            k = d - len(lead)
            if k < 0:
                raise ValueError("a spec shards the stacked layers' axis")
            kept[k] //= n
            out_cuts.append((k, i))
        out = torch.empty(lead + tuple(kept), dtype=dtype,
                          device=self.device)
        self.leaves.append(out)
        return out, out_cuts


def init_params_block(cfg: ArchConfig, specs: Params, mesh,
                      gen: Optional[torch.Generator] = None, *,
                      device="cuda", dtype=torch.bfloat16) -> Params:
    """This rank's blocks (``mesh.rank``) of ``init_params(cfg, gen,
    device=device, dtype=dtype)`` under the sanitized ``specs``, over the
    data axes and "model": the same numbers, drawn in the same order,
    but a leaf is never held whole beyond one layer's float32 draw (the
    constant leaves, norms and the SSM's A_log, D and dt_bias, are made
    whole and cut)."""
    order = _BlockDraws()
    meta = init_params(cfg, order, device="meta", dtype=dtype)
    path_of = {id(t): k for k, t in flatten_with_paths(meta)}
    spec_of = dict(flatten_with_paths(specs))
    cuts = [block_cuts(spec_of[path_of[id(t)]], mesh, mesh.rank)
            for t in order.leaves]
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    draws = _BlockDraws(gen, cuts)
    params = init_params(cfg, draws, device=dev, dtype=dtype)
    drawn = {id(x) for x in draws.leaves}
    return tree_map(lambda x, s: x if id(x) in drawn
                    else shard(x, s, mesh).clone(), params, specs)


def _is_cross(cfg: ArchConfig, i: int) -> bool:
    return bool(cfg.cross_attn_every and (i + 1) % cfg.cross_attn_every == 0)


def _use_shared(cfg: ArchConfig, i: int) -> bool:
    return bool(cfg.shared_attn_every
                and (i + 1) % cfg.shared_attn_every == 0)


def layer_flags(cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """Per-layer flags, as the reference's ``layer_flags``: each layer's
    attention window, and whether it is a cross-attention or
    shared-block layer (int32, on the CPU)."""
    L = range(cfg.n_layers)
    return {"window": torch.tensor([cfg.window_for_layer(i) for i in L],
                                   dtype=torch.int32),
            "is_cross": torch.tensor([int(_is_cross(cfg, i)) for i in L],
                                     dtype=torch.int32),
            "use_shared": torch.tensor([int(_use_shared(cfg, i)) for i in L],
                                       dtype=torch.int32)}


def _layer(params: Params, i: int) -> Params:
    """Layer i's parameters: views into the stacked tensors."""
    return {k: v[i] for k, v in params["layers"].items()}


def _embed(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
           tp: Optional[TensorParallel] = None):
    """Token embedding times sqrt(d) rounded to bfloat16 first, as the
    reference does (sqrt(1536) = 39.19 becomes 39.25).  Under ``tp`` with
    the vocabulary cut over "model" (``P("model", f)``) each rank looks
    up the tokens in its rows and zeroes the others, and the ranks' terms
    are summed (``tp.finish``: one nonzero term a token, so the sum is
    exact; the backward touches the rank's rows only); a whole ``embed``
    is looked up on every rank (under ``tp.sp`` its positions only)."""
    scale = torch.tensor(math.sqrt(float(cfg.d_model)), dtype=torch.bfloat16)
    emb = params["embed"]
    if tp is None or tp.model == 1:
        return emb[tokens] * scale
    if not tp.split(tp.specs["embed"]):
        x = emb[tokens] * scale
        return tp.seq_block(x) if tp.sp else x
    rows = emb.shape[0]
    local = tokens.long() - tp.m * rows
    mine = (local >= 0) & (local < rows)
    x = emb[local.clamp(0, rows - 1)] * scale
    return tp.finish(partial=torch.where(mine[..., None], x, 0.0).to(
        x.dtype))


def _inputs(params: Params, cfg: ArchConfig, tokens, frames, img):
    """The first layer's input: the audio family's ``frames`` cast to
    bfloat16, as the reference casts them, else the tokens' embedding.
    A vlm ``img`` must be in that input's dtype: the reference's layer
    scan takes the cross branch and the self branch under one
    ``lax.cond``, which refuses two output types."""
    if cfg.audio_frontend:
        if frames is None:
            raise ValueError(f"{cfg.name}: the audio family takes frames "
                             f"(B, S, d), not tokens")
        x = frames.to(torch.bfloat16)
    else:
        x = _embed(params, tokens, cfg)
    if img is not None and img.dtype != x.dtype:
        raise ValueError(f"{cfg.name}: img is {img.dtype}, the activations "
                         f"{x.dtype}; pass img in the activations' dtype")
    return x


def _shared_block(shared: Params, x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor, cache=None):
    """The hybrid's shared block: full causal attention (window 0), then
    its MLP, each with a residual.  Returns (x, the attention's new
    cache or K/V)."""
    a, kv = attention(shared, rms_norm(x, shared["ln1"]), cfg,
                      positions=positions, window=0, cache=cache)
    g = x + a
    return g + mlp(shared, rms_norm(g, shared["ln2"])), kv


def _block(p: Params, x: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor, i: int, *, img=None, shared=None,
           route=None):
    """Layer i (a hybrid layer with its shared block where it has one).
    Returns (x, aux): a self-attention layer's roped (K, V), None after
    a vlm cross layer, an SSM layer's final (conv, ssm) states.
    ``route``: ``moe_forward``'s ``groups`` and ``mesh``."""
    if cfg.family in ("ssm", "hybrid"):
        out, st = ssm_forward(p, rms_norm(x, p["ln1"]), cfg)
        x = x + out
        if shared is not None and _use_shared(cfg, i):
            x = _shared_block(shared, x, cfg, positions)[0]
        return x, st
    window = cfg.window_for_layer(i)
    if cfg.family == "vlm" and _is_cross(cfg, i):
        a, _ = attention(p, rms_norm(x, p["cln"]), cfg, positions=positions,
                         window=window, kv_override=img, cross=True)
        kv = None
    else:
        a, kv = attention(p, rms_norm(x, p["ln1"]), cfg,
                          positions=positions, window=window)
    h = x + a
    inner = rms_norm(h, p["ln2"])
    if cfg.family == "moe":
        return h + moe_forward(p, inner, cfg, **(route or {})), kv
    return h + mlp(p, inner), kv


def _tp_block(p: Params, x: torch.Tensor, cfg: ArchConfig,
              positions: torch.Tensor, i: int, route, tp: TensorParallel,
              cache=None):
    """A dense or moe layer on a rank of the serve steps' mesh: under
    ``tp.sp`` ``x`` is the rank's (B, S/M, d) block of the residual
    stream, its normed inputs all-gathered along the sequence before
    attention and before the MLP; the layer's outputs come back summed
    over "model" (and under ``tp.sp`` cut to the rank's block).  Returns
    (x, this layer's K/V block or new cache)."""
    window = cfg.window_for_layer(i)
    a, kv = attention(p, tp.seq_gather(rms_norm(x, p["ln1"])), cfg,
                      positions=positions, window=window, cache=cache, tp=tp)
    h = x + a
    inner = tp.seq_gather(rms_norm(h, p["ln2"]))
    if cfg.family == "moe":
        return h + moe_forward(p, inner, cfg, tp=tp, **route), kv
    return h + mlp(p, inner, tp=tp), kv


def _head(params: Params, x: torch.Tensor, cfg: ArchConfig,
          tp: Optional[TensorParallel] = None):
    """Final norm, vocabulary projection and soft-cap, in float32.  Under
    ``tp`` with ``lm_head`` cut over "model" (``P(f, "model")``) each
    rank computes its vocabulary columns and the logits are
    all-gathered."""
    x = rms_norm(x, params["final_norm"])
    logits = softcap((x @ params["lm_head"]).float(), cfg.final_softcap)
    if tp is not None and tp.model > 1 and tp.split(tp.specs["lm_head"]):
        logits = tp.all_gather([logits], [logits.dim() - 1])[0]
    return logits


# ---------------------------------------------------------------------------
# forward, prefill and decode
# ---------------------------------------------------------------------------


def _route(groups: int, dp: Optional[DataParallel]) -> Dict[str, Any]:
    """``moe_forward``'s dispatch groups: ``groups`` shards on one card;
    on a rank, its share of a batch split over the ranks, or, when every
    rank holds the whole batch, the ranks' count of groups in it."""
    if dp is None:
        return {"groups": groups}
    if dp.batch_sharded:
        return {"mesh": dp.mesh}
    return {"groups": dp.size}


def forward(params: Params, tokens: Optional[torch.Tensor],
            cfg: ArchConfig, *, img: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None, groups: int = 1,
            dp: Optional[DataParallel] = None,
            tp: Optional[TensorParallel] = None):
    """tokens (B, S) int — or, for the audio family, ``frames`` (B, S, d)
    pre-embedded; ``img`` (B, Sv, d) the vlm family's image tokens (None:
    a cross layer attends to its own input, as the reference's does).
    Returns float32 logits (B, S, V).  With ``cfg.remat`` and autograd
    recording, each layer keeps only its input for the backward and runs
    again there.  ``groups``: the MoE's dispatch groups on one card (the
    reference's data-parallel degree).  ``dp``: ``params`` holds this
    rank's blocks under ``dp.specs`` (see the module doc).  ``tp`` (dense
    and moe): ``params`` holds this rank's blocks under ``tp.specs`` and
    ``tokens`` its rows; returns this rank's logits: its vocabulary
    columns (B, S, V/M) of every position where ``lm_head`` is cut over
    "model", else every column of its positions ((B, S/M, V) under
    sequence parallelism)."""
    if tp is not None:
        x, outer, tp = _forward_tp(params, tokens, cfg, tp)
        return _tp_logits(outer, x, cfg, tp)
    blocks = params
    if dp is not None:
        outer = {k: v for k, v in params.items() if k != "layers"}
        params = dict(gather_tree(outer, {k: dp.specs[k] for k in outer},
                                  dp.mesh, dp.batch_sharded),
                      layers=params["layers"])
    x = _inputs(params, cfg, tokens, frames, img)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    shared = params.get("shared_attn")
    route = _route(groups, dp)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = _layer(blocks, i)

        def body(h, lp=lp, i=i):
            if dp is not None:         # ZeRO-3: gathered in the body
                lp = gather_tree(lp, dp.specs["layers"], dp.mesh,
                                 dp.batch_sharded, lead=1)
            return _block(lp, h, cfg, positions, i, img=img,
                          shared=shared, route=route)[0]
        x = checkpoint(body, x, use_reentrant=False) if remat else body(x)
    return _head(params, x, cfg)


class _TokenNLL(torch.autograd.Function):
    """Each position's logsumexp of the float32 logits minus its label's
    logit.  The backward writes the gradient, g (softmax - one-hot), into
    the saved logits in place: a (B, S, V) float32 tensor then exists
    once, where autograd's logsumexp and gather backward make three (8.6
    GB each for gemma3-4b's 262,144-token vocabulary at 2 x 4,096
    tokens).  So the graph can be differentiated once only."""

    @staticmethod
    def forward(ctx, logits, labels):
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
        ctx.save_for_backward(logits, lse, labels)
        ctx.used = False
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        if ctx.used:
            raise RuntimeError("loss_fn: its gradient overwrites the logits "
                               "and can be taken once")
        ctx.used = True
        logits, lse, labels = ctx.saved_tensors
        grad = logits.sub_(lse[..., None]).exp_()
        grad.scatter_add_(-1, labels[..., None],
                          torch.full_like(lse, -1.0)[..., None])
        return grad.mul_(g[..., None]), None


class _VocabNLL(torch.autograd.Function):
    """``_TokenNLL`` over a vocabulary cut over "model": ``logits`` is
    this rank's (B, S, V/M) float32 block, columns [lo, lo + V/M).  The
    row maximum is all-reduced (max), then each row's sum of exp and its
    label's logit (from the rank that holds the label; zero elsewhere)
    in one all-reduce, so every rank of "model" returns the same
    cross-entropy and no rank holds (B, S, V).  The backward writes
    softmax - one-hot over the rank's columns into the saved block in
    place, once."""

    @staticmethod
    def forward(ctx, logits, labels, lo, mesh):
        mx = logits.amax(-1)
        all_reduce_(mx, mesh, kind="tp_reduce", op=dist.ReduceOp.MAX)
        local = labels - lo
        mine = (local >= 0) & (local < logits.shape[-1])
        local = local.clamp(0, logits.shape[-1] - 1)
        ll = torch.gather(logits, -1, local[..., None])[..., 0]
        sums = torch.stack([torch.exp(logits - mx[..., None]).sum(-1),
                            torch.where(mine, ll, 0.0)])
        all_reduce_(sums, mesh, kind="tp_reduce")
        lse = mx + torch.log(sums[0])
        ctx.save_for_backward(logits, lse, local, mine)
        ctx.used = False
        return lse - sums[1]

    @staticmethod
    def backward(ctx, g):
        if ctx.used:
            raise RuntimeError("loss_fn: its gradient overwrites the logits "
                               "and can be taken once")
        ctx.used = True
        logits, lse, local, mine = ctx.saved_tensors
        grad = logits.sub_(lse[..., None]).exp_()
        grad.scatter_add_(-1, local[..., None], -mine[..., None].to(
            grad.dtype))
        return grad.mul_(g[..., None]), None, None, None


def _forward_tp(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
                tp: TensorParallel):
    """The layers of the train forward on a rank of ``tp``: the outer
    leaves gathered over "data" once, each layer's inside its
    checkpointed body (so the remat backward gathers again), the
    residual stream between layers the rank's (B, S/M, d) block under
    ``cfg.seq_parallel`` where M divides S (``_seq_shard``).  Returns
    (the last layer's output, the outer leaves, ``tp`` with its ``sp``
    set)."""
    s = tokens.shape[1]
    tp = tp.with_sp(cfg.seq_parallel and s % tp.model == 0)
    outer = _outer(params, tp)
    x = _embed(outer, tokens, cfg, tp)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    route = tp.route()
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = _layer(params, i)

        def body(h, lp=lp, i=i):
            lp = tp.gather_data(lp, tp.specs["layers"], lead=1)
            return _tp_block(lp, h, cfg, positions, i, route, tp)[0]
        x = checkpoint(body, x, use_reentrant=False) if remat else body(x)
    return x, outer, tp


def _tp_logits(outer: Params, x: torch.Tensor, cfg: ArchConfig,
               tp: TensorParallel) -> torch.Tensor:
    """The final norm, the vocabulary projection and the soft-cap on a
    rank: its columns of every position where ``lm_head`` is cut (the
    normed stream gathered along the sequence under ``tp.sp``), else
    every column of the rank's positions."""
    x = rms_norm(x, outer["final_norm"])
    if tp.split(tp.specs["lm_head"]):
        x = tp.seq_gather(x)
    return softcap((x @ outer["lm_head"]).float(), cfg.final_softcap)


def model_partial(specs: Params, mesh, sp: bool) -> List[bool]:
    """For each leaf of the parameter tree (``tree_leaves`` order of
    ``specs``, sanitized), whether a rank's gradient of it is one term of
    a sum over "model": a leaf the specs leave whole over "model" that
    the rank uses after a layer's column-parallel input (every layer
    leaf but the norms ``ln1`` and ``ln2``), or, under sequence
    parallelism (``sp``), any such leaf (each rank's positions give a
    term).  The norms and the outer leaves are otherwise used on the
    same whole inputs by every rank, whose gradients are then the whole
    one."""
    if mesh.shape.get("model", 1) <= 1:
        return [False for _ in flatten_with_paths(specs)]
    return [model_dim(spec, mesh) is None and (
        sp or (path.startswith("layers/")
               and path.rsplit("/", 1)[-1] not in ("ln1", "ln2")))
        for path, spec in flatten_with_paths(specs)]


def _loss_terms_tp(params: Params, batch: Dict[str, Any], cfg: ArchConfig,
                   tp: TensorParallel):
    x, outer, tp = _forward_tp(params, batch["tokens"], cfg, tp)
    logits = _tp_logits(outer, x, cfg, tp)
    labels = batch["labels"].long()
    if tp.split(tp.specs["lm_head"]):       # the vocabulary-parallel loss
        nll = _VocabNLL.apply(logits, labels.clamp(min=0),
                              tp.m * logits.shape[-1], tp.model_mesh)
        mask = (labels >= 0).float()
        return torch.sum(nll * mask), torch.sum(mask)
    if tp.sp:                                # the rank's positions
        labels = tp.seq_block(labels)
    nll = _TokenNLL.apply(logits, labels.clamp(min=0))
    mask = (labels >= 0).float()
    total, count = torch.sum(nll * mask), torch.sum(mask)
    if tp.sp:        # the ranks' terms summed; each term's gradient whole
        sums = tp.all_reduce(torch.stack([total, count]))
        total, count = sums[0], sums[1]
    return total, count


def loss_terms(params: Params, batch: Dict[str, Any], cfg: ArchConfig, *,
               groups: int = 1, dp: Optional[DataParallel] = None,
               tp: Optional[TensorParallel] = None):
    """The sum of the next-token cross-entropy over the labels >= 0 and
    their count (float32 0-dim tensors): ``loss_fn`` is their quotient.
    A rank of the sharded step sums its terms with the other ranks'
    before the backward, so its loss is the global mean.  Under ``tp``
    (``batch`` the rank's rows) both are its data index's, equal on
    every rank of "model": the vocabulary-parallel cross-entropy
    (``_VocabNLL``) where ``lm_head`` is cut, else each rank's positions'
    terms summed over "model" under sequence parallelism, or the whole
    rows' on every rank."""
    if tp is not None:
        return _loss_terms_tp(params, batch, cfg, tp)
    logits = forward(params, batch.get("tokens"), cfg, img=batch.get("img"),
                     frames=batch.get("frames"), groups=groups, dp=dp)
    labels = batch["labels"].long()
    nll = _TokenNLL.apply(logits, labels.clamp(min=0))
    mask = (labels >= 0).float()
    return torch.sum(nll * mask), torch.sum(mask)


def loss_fn(params: Params, batch: Dict[str, Any], cfg: ArchConfig, *,
            groups: int = 1) -> torch.Tensor:
    """Mean next-token cross-entropy over the labels >= 0: logsumexp of
    the logits minus the label's logit, as the reference computes it (no
    log-softmax materialised; ``_TokenNLL``, whose gradient reuses the
    logits' memory).  ``batch`` holds ``labels`` (B, S) and ``tokens``
    (B, S) or the audio family's ``frames`` (B, S, d), and the vlm
    family's ``img``.  ``groups``: the MoE's dispatch groups.  Returns a
    float32 0-dim tensor."""
    total, count = loss_terms(params, batch, cfg, groups=groups)
    return total / torch.clamp(count, min=1.0)


def prefill(params: Params, tokens: Optional[torch.Tensor],
            cfg: ArchConfig, *, img: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            tp: Optional[TensorParallel] = None, into: Optional[List] = None):
    """Forward over the prompt.  Returns (last-token logits (B, 1, V),
    {"k", "v"}: each layer's roped K and V, stacked (L, B, S, kv, hd)) —
    for the ssm and hybrid families {"conv" (L, B, d_conv - 1,
    d_conv_in), "ssm" (L, B, nh, hd, state) float32}: each layer's final
    states.  A vlm cross layer's K and V are its ``ln1``-normed input
    through ``wk`` and ``wv``, roped, as the reference emits them.

    ``tp`` (a ``distributed.sharding.TensorParallel``; dense and moe):
    ``params`` holds this rank's blocks and ``tokens`` its rows; the
    leaves cut over the data axes (FSDP) are gathered, the outer ones
    once and each layer's where it runs; with ``cfg.seq_parallel`` (and
    S a multiple of M) the residual stream between layers is the rank's
    (B, S/M, d) block (``_seq_shard``).  K and V come back as the rank's
    cache blocks (``layers.kv_layout``); the logits whole.  ``into``
    (under ``tp``): the rank's decode ring caches (``init_decode_cache(
    specs=, mesh=)``), into which each layer's K and V are written (the
    last min(Sc, S) positions, position p at slot p % Sc) in place of
    the stacked (L, B, S, ...) ones, which are not made; they are
    returned as the second value."""
    if tp is not None:
        return _prefill_tp(params, tokens, cfg, tp, into)
    if into is not None:
        raise ValueError("prefill: into= is the serve step's (tp=)")
    x = _inputs(params, cfg, tokens, frames, img)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    shared = params.get("shared_attn")
    if cfg.family in ("ssm", "hybrid"):
        convs, ssms = [], []
        for i in range(cfg.n_layers):
            x, (conv, st) = _block(_layer(params, i), x, cfg, positions, i,
                                   shared=shared)
            convs.append(conv)
            ssms.append(st)
        return _head(params, x[:, -1:, :], cfg), {
            "ssm": torch.stack(ssms), "conv": torch.stack(convs)}
    kv, hd = cfg.n_kv_heads, cfg.hd
    ks = torch.empty(cfg.n_layers, b, s, kv, hd, dtype=x.dtype,
                     device=x.device)
    vs = torch.empty_like(ks)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        if cfg.family == "vlm" and _is_cross(cfg, i):
            inner = rms_norm(x, lp["ln1"])
            ks[i] = rope((inner @ lp["wk"]).reshape(b, s, kv, hd), positions,
                         cfg.rope_theta)
            vs[i] = (inner @ lp["wv"]).reshape(b, s, kv, hd)
            x = _block(lp, x, cfg, positions, i, img=img)[0]
        else:
            x, (ks[i], vs[i]) = _block(lp, x, cfg, positions, i, img=img)
    return _head(params, x[:, -1:, :], cfg), {"k": ks, "v": vs}


def _outer(params: Params, tp: TensorParallel) -> Params:
    """The leaves outside the layers, whole along the data axes."""
    outer = {k: v for k, v in params.items() if k != "layers"}
    return tp.gather_data(outer, {k: tp.specs[k] for k in outer})


def fill_rings(cache: List, i: int, k: torch.Tensor, v: torch.Tensor):
    """Write a prompt's K and V (B, S, ...) into layer i's decode ring
    cache: the last min(Sc, S) positions, position p at slot p % Sc (as
    the decode's ring writes put them)."""
    s, sc = k.shape[1], cache[i]["k"].shape[1]
    n = min(sc, s)
    slots = torch.arange(s - n, s, device=k.device) % sc
    cache[i]["k"][:, slots] = k[:, s - n:].to(cache[i]["k"].dtype)
    cache[i]["v"][:, slots] = v[:, s - n:].to(cache[i]["v"].dtype)


def _prefill_tp(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
                tp: TensorParallel, into: Optional[List] = None):
    b, s = tokens.shape
    tp = tp.with_sp(cfg.seq_parallel and s % tp.model == 0)
    outer = _outer(params, tp)
    x = _embed(outer, tokens, cfg, tp)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    kv, hd = cfg.n_kv_heads, cfg.hd
    layout = kv_layout(tp.kv_spec, tp.mesh)
    if layout == "heads":
        kv //= tp.model
    elif layout == "hd":
        hd //= tp.model
    if into is None:
        ks = torch.empty(cfg.n_layers, b, s, kv, hd, dtype=x.dtype,
                         device=x.device)
        vs = torch.empty_like(ks)
    route = tp.route()
    for i in range(cfg.n_layers):
        lp = tp.gather_data(_layer(params, i), tp.specs["layers"], lead=1)
        x, (k, v) = _tp_block(lp, x, cfg, positions, i, route, tp)
        if into is None:
            ks[i], vs[i] = k, v
        else:
            fill_rings(into, i, k, v)
        del k, v
    if tp.sp:             # the last position lies in the last rank's block
        last = x[:, -1:] if tp.m == tp.model - 1 else torch.zeros_like(
            x[:, -1:])
        last = tp.all_reduce(last)
    else:
        last = x[:, -1:]
    return _head(outer, last, cfg, tp), (into if into is not None
                                         else {"k": ks, "v": vs})


def init_decode_cache(cfg: ArchConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, *, device="cuda", specs=None,
                      mesh=None) -> List:
    """Per-layer ring caches: local layers hold min(window, max_seq)
    positions, global layers max_seq; SSM layers their O(1) conv state
    (in ``dtype``) and SSM state (float32), and on a hybrid's shared-block
    layers also K and V of max_seq positions for the shared block.  With
    ``specs`` (``launch.steps.cache_pspecs``, sanitized) and a
    group-bound ``mesh`` only this rank's blocks are allocated;
    ``cache_pspecs``' sequence-sharded branch (a batch the data axes do
    not divide) is refused by name."""
    if specs is not None:
        for sp in specs:
            if any(d == 1 for n in ("k", "v") if n in sp
                   for d, _, _ in block_cuts(sp[n], mesh, 0)):
                raise ValueError(
                    f"cache spec {sp!r}: cache_pspecs' sequence-sharded "
                    f"branch (a batch the data axes do not divide) is not "
                    f"ported")
        whole = init_decode_cache(cfg, batch, max_seq, dtype, device="meta")
        dev = resolve_device(device)
        return [{k: torch.zeros(shard(v, sp[k], mesh).shape, dtype=v.dtype,
                                device=dev) for k, v in e.items()}
                for e, sp in zip(whole, specs)]
    dev = resolve_device(device)
    kv_shape = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    cache: List = []
    for i in range(cfg.n_layers):
        if cfg.family in ("ssm", "hybrid"):
            entry = {"conv": torch.zeros(batch, cfg.ssm_conv - 1,
                                         cfg.d_inner + 2 * cfg.ssm_state,
                                         dtype=dtype, device=dev),
                     "ssm": torch.zeros(batch, cfg.ssm_nheads,
                                        cfg.ssm_headdim, cfg.ssm_state,
                                        dtype=torch.float32, device=dev)}
            if cfg.family == "hybrid" and _use_shared(cfg, i):
                entry["k"] = torch.zeros(kv_shape, dtype=dtype, device=dev)
                entry["v"] = torch.zeros(kv_shape, dtype=dtype, device=dev)
            cache.append(entry)
            continue
        w = cfg.window_for_layer(i)
        sc = min(w, max_seq) if w else max_seq
        shape = (batch, sc, cfg.n_kv_heads, cfg.hd)
        cache.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                      "v": torch.zeros(shape, dtype=dtype, device=dev)})
    return cache


def decode_step(params: Params, cache: List, token: torch.Tensor, cur: int,
                cfg: ArchConfig, *, img: Optional[torch.Tensor] = None,
                tp: Optional[TensorParallel] = None):
    """One decode step.  token (B, 1) int; cur the current length, an int
    (all rows share it); ``img`` the vlm family's image tokens (None: a
    cross layer attends to the token itself, as the reference's does).
    Returns (logits (B, 1, V), new_cache): the attention caches are
    updated in place and returned, the SSM states replaced by new ones,
    a vlm cross layer's entry returned as it is.  ``tp``: ``params``,
    ``cache`` and ``token`` are this rank's blocks (dense and moe; see
    ``prefill``), the logits whole."""
    cur = int(cur)
    if tp is not None:
        tp = tp.with_sp(False)
        outer = _outer(params, tp)
        x = _embed(outer, token, cfg, tp)
        positions = torch.tensor([cur], dtype=torch.int32, device=x.device)
        route, new_cache = tp.route(), []
        for i in range(cfg.n_layers):
            lp = tp.gather_data(_layer(params, i), tp.specs["layers"],
                                lead=1)
            c = cache[i]
            x, kvc = _tp_block(lp, x, cfg, positions, i, route, tp,
                               cache=(c["k"], c["v"], cur))
            new_cache.append({"k": kvc[0], "v": kvc[1]})
        return _head(outer, x, cfg, tp), new_cache
    x = _inputs(params, cfg, token, None, img)
    positions = torch.tensor([cur], dtype=torch.int32, device=x.device)
    shared = params.get("shared_attn")
    new_cache: List = []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        c = cache[i]
        if cfg.family in ("ssm", "hybrid"):
            out, st = ssm_forward(lp, rms_norm(x, lp["ln1"]), cfg,
                                  state=(c["conv"], c["ssm"]))
            x = x + out
            nc = {"conv": st[0], "ssm": st[1]}
            if "k" in c:                      # the hybrid's shared block
                x, kvc = _shared_block(shared, x, cfg, positions,
                                       cache=(c["k"], c["v"], cur))
                nc["k"], nc["v"] = kvc[0], kvc[1]
            new_cache.append(nc)
            continue
        w = cfg.window_for_layer(i)
        if cfg.family == "vlm" and _is_cross(cfg, i):
            a, _ = attention(lp, rms_norm(x, lp["cln"]), cfg,
                             positions=positions, window=w,
                             kv_override=img, cross=True)
            new_cache.append(c)
        else:
            a, kvc = attention(lp, rms_norm(x, lp["ln1"]), cfg,
                               positions=positions, window=w,
                               cache=(c["k"], c["v"], cur))
            new_cache.append({"k": kvc[0], "v": kvc[1]})
        x = x + a
        inner = rms_norm(x, lp["ln2"])
        if cfg.family == "moe":
            x = x + moe_forward(lp, inner, cfg)
        else:
            x = x + mlp(lp, inner)
    return _head(params, x, cfg), new_cache
