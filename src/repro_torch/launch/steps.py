"""Step builders: train_step / prefill_step / serve_step, their inputs
and their PartitionSpecs for any (architecture x input shape x mesh)
cell — the PyTorch twin of ``repro/launch/steps.py``.

``make_train_step``, ``make_prefill_step`` and ``make_serve_step`` return
a cell's step as a function of its inputs, over ``launch/train.py:
train_step``, ``models.prefill`` and ``models.decode_step``.
``batch_struct``, ``cache_struct``, ``params_struct`` and ``state_struct``
give those inputs as tensors on the ``meta`` device, the reference's
``jax.ShapeDtypeStruct`` stand-ins: shapes and dtypes, nothing
allocated.  ``batch_struct``'s ``batch`` and ``seq`` override the
shape's (``launch/dryrun.py`` sizes a cell's cut with them).

``batch_pspecs``, ``state_pspecs``, ``cache_pspecs`` and
``token_pspecs`` are the reference's PartitionSpecs (``distributed.
sharding.P``) of those inputs over a mesh (``launch/mesh.py``: the
production 16 x 16 and 2 x 16 x 16 meshes are sizes alone), and
``sanitize_pspecs`` replicates a dimension the mesh does not divide, as
the reference does.  ``make_train_step(pspecs=, mesh=)`` trains over the
ranks of a group-bound mesh with them: DP over "data", and FSDP (ZeRO-3:
the master, m and v sharded, each layer's weights gathered where they
are used) for the configs with ``fsdp``; over a "model" axis above 1
(dense and moe) Megatron tensor parallelism with its backward (heads,
FFN columns, experts and the vocabulary over "model", the loss over the
rank's vocabulary columns) and, with ``cfg.seq_parallel``, the residual
stream split along the sequence.  ``make_prefill_step(pspecs=, mesh=)``
and ``make_serve_step(pspecs=, mesh=)`` run the dense and moe families
over a ("data", "model") mesh as the reference's dry run lowers them:
the batch over "data", the same tensor parallelism over "model", FSDP
gathers over "data", and for a prefill with ``cfg.seq_parallel`` the
residual stream split along the sequence
(``distributed.sharding.TensorParallel``); ``train_collectives`` and
``serve_collectives`` count what one such step issues.  The other
families over "model" and ``cache_pspecs``' sequence-sharded branch (a
batch the data axes do not divide) are refused by name.  ``init_state``
draws a rank's blocks of the initial state a layer at a time, over both
axes.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import SHAPES, ArchConfig
from ..distributed.collectives import Mesh
from ..distributed.sharding import (DataParallel, P, TensorParallel,
                                    data_dim, is_spec, leaf_dims,
                                    model_dim, model_size, shard)
from ..models import (decode_step, init_decode_cache, init_params,
                      init_params_block, param_specs, prefill)
from ..models.layers import kv_layout
from ..models.moe import dp_groups
from ..optim import adamw
from ..tree import tree_leaves, tree_map
from .mesh import dp_axes, dp_size
from .train import grad_sums, train_step

META = torch.device("meta")


def sanitize_pspecs(spec_tree, struct_tree, mesh: Mesh):
    """Drop shardings whose mesh-axis product does not divide the
    dimension (e.g. a 50,280-entry vocab cannot be 16-way sharded;
    granite's 40 experts cannot split over 16): those dimensions are
    replicated.  ``struct_tree`` holds tensors (``meta`` ones will do)
    of the spec tree's structure."""
    def fix(spec, st):
        if not is_spec(spec):
            return spec
        dims = st.shape
        new = []
        for i, ax in enumerate(spec):
            if ax is None or i >= len(dims):
                new.append(None)
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            size = 1
            for a in axes:
                size *= mesh.shape[a]
            new.append(ax if dims[i] % size == 0 else None)
        return P(*new)

    return tree_map(fix, spec_tree, struct_tree)


def batch_struct(cfg: ArchConfig, shape_name: str, *,
                 batch: Optional[int] = None,
                 seq: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The cell's batch: ``tokens`` (B, S) int32, or the audio family's
    ``frames`` (B, S, d) bfloat16; ``labels`` (B, S) int32; the vlm
    family's ``img`` (B, n_image_tokens, d) bfloat16."""
    sh = SHAPES[shape_name]
    b = sh["global_batch"] if batch is None else batch
    s = sh["seq_len"] if seq is None else seq
    out: Dict[str, torch.Tensor] = {}
    if cfg.audio_frontend:
        out["frames"] = torch.empty(b, s, cfg.d_model, dtype=torch.bfloat16,
                                    device=META)
    else:
        out["tokens"] = torch.empty(b, s, dtype=torch.int32, device=META)
    out["labels"] = torch.empty(b, s, dtype=torch.int32, device=META)
    if cfg.family == "vlm":
        out["img"] = torch.empty(b, cfg.n_image_tokens, cfg.d_model,
                                 dtype=torch.bfloat16, device=META)
    return out


def batch_pspecs(cfg: ArchConfig, shape_name: str, mesh: Mesh, *,
                 batch: Optional[int] = None) -> Dict[str, P]:
    """The batch split over the data-parallel axes when they divide the
    global batch (``batch`` overrides the shape's), else replicated."""
    dp = dp_axes(mesh)
    b = SHAPES[shape_name]["global_batch"] if batch is None else batch
    bs = dp if b % max(dp_size(mesh), 1) == 0 else ()
    out: Dict[str, P] = {}
    if cfg.audio_frontend:
        out["frames"] = P(bs, None, None)
    else:
        out["tokens"] = P(bs, None)
    out["labels"] = P(bs, None)
    if cfg.family == "vlm":
        out["img"] = P(bs, None, None)
    return out


def make_train_step(cfg: ArchConfig,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    pspecs=None, *, mesh: Optional[Mesh] = None,
                    batch_specs: Optional[Dict[str, P]] = None,
                    groups: int = 1):
    """``step(state, batch) -> (state, metrics)``: the loss, its gradient
    and AdamW (``launch/train.py: train_step``).  On one card (no
    ``mesh``) ``pspecs`` changes nothing, as on one device in the
    reference, and ``groups`` is the MoE's dispatch groups.  With a
    group-bound ``mesh``, ``pspecs`` (the sanitized specs of the master
    tree, ``state_pspecs(cfg).master``) lay the state over its ranks: the
    step takes this rank's blocks of the state (``init_state``) and its
    rows of the batch under ``batch_specs`` (``batch_pspecs``, sanitized;
    split over the ranks when None).  A "model" axis above 1 (dense and
    moe) trains with Megatron's tensor parallelism over it, experts and
    the vocabulary cut over it, and with ``cfg.seq_parallel`` the
    residual stream split along the sequence between layers
    (``distributed.sharding.TensorParallel``, ``step.tp``); the other
    families over "model" are refused by name."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    dp = tp = None
    if mesh is not None and model_size(mesh) > 1:
        tp = _tensor_parallel(cfg, pspecs, mesh, None if batch_specs is None
                              else batch_specs["labels"], "make_train_step")
    elif mesh is not None:
        if pspecs is None:
            raise ValueError("make_train_step: a mesh needs the state's "
                             "pspecs")
        sharded = (batch_specs is None
                   or data_dim(batch_specs["labels"], mesh) == 0)
        dp = DataParallel(mesh, pspecs, sharded)    # checks the mesh

    def step(state: adamw.OptState, batch: Dict[str, torch.Tensor]):
        return train_step(cfg, opt_cfg, state, batch, groups=groups, dp=dp,
                          tp=tp)
    step.tp = tp
    return step


def params_struct(cfg: ArchConfig):
    """The parameter tree on ``meta``."""
    return init_params(cfg, device=META)


def _buckets(nbytes, bucket_bytes: int = 1 << 25) -> int:
    """``bucketed_psum``'s all-reduces for leaves of ``nbytes`` (one
    dtype)."""
    n, size, pending = 0, 0, False
    for b in sorted(nbytes):
        size, pending = size + b, True
        if size >= bucket_bytes:
            n, size, pending = n + 1, 0, False
    return n + pending


def train_collectives(cfg: ArchConfig, pspecs, mesh: Mesh, tokens: int,
                      batch_sharded: bool = True, *,
                      seq: Optional[int] = None) -> Dict[str, int]:
    """The collectives one sharded step issues (``distributed.COLLECTIVES``
    kinds) for the sanitized master ``pspecs`` and ``tokens`` tokens of
    global batch: the gathers of the outer leaves (once) and of each
    layer's (again in the remat backward), a reduce-scatter a gather, the
    loss's all-reduce, the replicated gradients' buckets (float32) and
    the norm's all-reduce when a leaf is sharded, and the MoE's exchange
    of counts in a layer (and its recomputation) when its dispatch falls
    back to one group over the ranks.  Over "model" (``seq`` the
    sequence length, which decides the sequence parallelism) see
    ``_tp_train_collectives``."""
    if model_size(mesh) > 1:
        return _tp_train_collectives(cfg, pspecs, mesh, tokens,
                                     batch_sharded, seq)
    struct = params_struct(cfg)
    rest = {k: v for k, v in struct.items() if k != "layers"}
    outer = int(any(d is not None for d in leaf_dims(rest, pspecs, mesh)))
    layer = int(any(d is not None for d in leaf_dims(
        struct["layers"], pspecs["layers"], mesh)))
    passes = 2 if cfg.remat else 1
    plan = {"all_gather": outer + cfg.n_layers * passes * layer,
            "reduce_scatter": 0, "reduce": int(outer or layer),
            "exchange": 0}
    if batch_sharded:
        whole = [x for x, d in zip(tree_leaves(struct),
                                   leaf_dims(struct, pspecs, mesh))
                 if d is None]
        plan["reduce_scatter"] = outer + cfg.n_layers * layer
        plan["reduce"] += 1 + _buckets([4 * x.numel() for x in whole])
        s = dp_size(mesh)
        if cfg.family == "moe" and dp_groups(tokens, s) != s:
            plan["exchange"] = cfg.n_layers * passes
    return plan


def _tp_train_collectives(cfg: ArchConfig, pspecs, mesh: Mesh, tokens: int,
                          batch_sharded: bool, seq: Optional[int]):
    """``train_collectives`` over a ("data", "model") mesh: as over
    "data" for the FSDP gathers, their reduce-scatters, the loss and the
    norm; per layer forward the sequence's two all-gathers (under
    sequence parallelism), the general attention path's all-gather of
    its cut projections and a sum over "model" after attention and after
    the MLP or MoE (an all-reduce, or a reduce-scatter along the
    sequence), the remat pass the same but its last sum (the recompute
    stops at the layer's last saved tensor), and the backward the
    conjugates: the inputs' all-reduces (or reduce-scatters), the cut
    projections' reduce-scatter, and under sequence parallelism the
    sums' all-gathers.  Outside the layers: the cut embedding's sum and
    its conjugate, the head's input and its conjugate and the
    vocabulary-parallel loss's two all-reduces (or, with the vocabulary
    whole under sequence parallelism, the loss terms' all-reduce), and
    the gradients summed over the mesh, its data or its model sub-group
    (``launch.train.grad_sums``; "reduce", in buckets)."""
    m, n = model_size(mesh), dp_size(mesh)
    L, passes = cfg.n_layers, 2 if cfg.remat else 1
    sp = int(bool(cfg.seq_parallel and seq is not None and seq % m == 0))
    cut = lambda sp_: model_dim(sp_, mesh) is not None  # noqa: E731
    data = lambda sp_: data_dim(sp_, mesh) is not None  # noqa: E731
    lsp = pspecs["layers"]
    split_data = batch_sharded and n > 1
    outer = int(any(data(v) for k, v in pspecs.items() if k != "layers"))
    layer = int(any(data(v) for v in lsp.values()))
    plan = {"all_gather": outer + L * passes * layer,
            "reduce_scatter": (outer + L * layer) if split_data else 0,
            "reduce": int(split_data), "exchange": 0, "tp_reduce": 0,
            "tp_gather": 0, "tp_scatter": 0}
    total = "tp_scatter" if sp else "tp_reduce"
    general = int(kv_layout(kv_pspec(cfg, mesh), mesh) != "heads" and any(
        cut(lsp[k]) for k in ("wq", "wk", "wv")))
    attn = int(cut(lsp["wo"]))
    if cfg.family == "moe":
        ffn = int(cut(lsp["e_gate"]) or bool(cfg.n_shared_experts
                                             and cut(lsp["s_down"])))
    else:
        ffn = int(cut(lsp["w_down"]))
    # a layer's forward and remat pass (which stops before its last sum),
    # then its backward's conjugates
    plan["tp_gather"] += L * passes * (2 * sp + general)
    plan[total] += L * (attn + ffn + (passes - 1) * attn)
    plan["tp_scatter" if sp else "tp_reduce"] += L * 2
    plan["tp_scatter"] += L * general
    plan["tp_gather"] += L * sp * (attn + ffn)
    if cut(pspecs["embed"]):
        plan[total] += 1
        plan["tp_gather"] += int(sp)
    if cut(pspecs["lm_head"]):
        plan["tp_gather"] += int(sp)
        plan["tp_scatter" if sp else "tp_reduce"] += 1
        plan["tp_reduce"] += 2
    elif sp:
        plan["tp_reduce"] += 1
    struct = params_struct(cfg)
    blocks = [shard(x, s, mesh, 0) for x, s in zip(
        tree_leaves(struct), tree_leaves(pspecs))]
    for idx in grad_sums(pspecs, mesh, sp, split_data).values():
        plan["reduce"] += _buckets([4 * blocks[i].numel() for i in idx])
    plan["reduce"] += int(any(data(s) or cut(s) for s in tree_leaves(pspecs)))
    if cfg.family == "moe" and split_data and dp_groups(tokens, n) != n:
        plan["exchange"] = L * passes
    return plan


def state_struct(cfg: ArchConfig) -> adamw.OptState:
    """The optimizer state on ``meta``: float32 master, m and v."""
    return adamw.init(params_struct(cfg))


def state_pspecs(cfg: ArchConfig) -> adamw.OptState:
    """The state's specs: master, m and v each the parameters'
    (``param_specs``), the step replicated."""
    specs = param_specs(cfg)
    return adamw.OptState(master=specs, m=tree_map(lambda s: s, specs),
                          v=tree_map(lambda s: s, specs), step=P())


def init_state(cfg: ArchConfig, pspecs, mesh: Mesh,
               gen: Optional[torch.Generator] = None, *,
               device="cuda") -> adamw.OptState:
    """This rank's blocks of ``adamw.init(init_params(cfg, gen))`` under
    the sanitized master ``pspecs``: the same numbers, but no leaf is
    held whole beyond one layer (``models.init_params_block``)."""
    return adamw.init(init_params_block(cfg, pspecs, mesh, gen,
                                        device=device))


def _tensor_parallel(cfg: ArchConfig, pspecs, mesh: Optional[Mesh],
                     batch_specs, name: str):
    if mesh is None:
        return None
    if pspecs is None:
        raise ValueError(f"{name}: a mesh needs the parameters' pspecs "
                         f"(param_specs, sanitized)")
    sharded = (batch_specs is None
               or data_dim(batch_specs, mesh) == 0)
    return TensorParallel(mesh, cfg, pspecs, kv_pspec(cfg, mesh),
                          batch_sharded=sharded)


def make_prefill_step(cfg: ArchConfig, pspecs=None, *,
                      mesh: Optional[Mesh] = None, batch_specs=None):
    """``step(params, batch) -> (last-token logits, K/V or states)``.
    With a group-bound ("data", "model") ``mesh`` and the sanitized
    parameter ``pspecs`` the step takes this rank's parameter blocks
    (``models.init_params_block``) and its rows of the batch
    (``batch_specs``: the sanitized ``batch_pspecs["tokens"]``; split
    over the data axes when None) and returns the whole last-token
    logits and its cache blocks of K and V (dense and moe; see
    ``models.prefill``), or with ``into`` (its decode ring caches) those
    caches filled.  Without a mesh ``pspecs`` changes nothing."""
    tp = _tensor_parallel(cfg, pspecs, mesh, batch_specs,
                          "make_prefill_step")

    def step(params, batch, into=None):
        if tp is not None:
            return prefill(params, batch["tokens"], cfg, tp=tp, into=into)
        return prefill(params, batch.get("tokens"), cfg,
                       img=batch.get("img"), frames=batch.get("frames"))
    step.tp = tp
    return step


def make_serve_step(cfg: ArchConfig, pspecs=None, *,
                    mesh: Optional[Mesh] = None):
    """``step(params, cache, token, cur, img=None) -> (logits, cache)``:
    one decode step (``cur`` a Python int).  With a group-bound
    ("data", "model") ``mesh`` and the sanitized parameter ``pspecs`` the
    step takes this rank's parameter blocks, its cache blocks
    (``models.init_decode_cache(specs=, mesh=)`` or a prefill's) and its
    rows of the tokens, and returns the whole logits (dense and moe)."""
    tp = _tensor_parallel(cfg, pspecs, mesh, None, "make_serve_step")

    def step(params, cache, token, cur, img=None):
        return decode_step(params, cache, token, cur, cfg, img=img, tp=tp)
    step.tp = tp
    return step


def serve_collectives(cfg: ArchConfig, pspecs, mesh: Mesh, tokens: int, *,
                      decode: bool = False, seq: Optional[int] = None,
                      batch_sharded: bool = True) -> Dict[str, int]:
    """The collectives one prefill (or with ``decode`` one decode step)
    over ``mesh`` issues, by ``distributed.COLLECTIVES`` kind, for the
    sanitized parameter ``pspecs`` and ``tokens`` tokens of global batch
    (``seq`` of them a row; a decode's rows hold one): the FSDP gathers
    over "data" (the outer leaves once, each layer's once), the
    embedding's and every row-parallel layer's sum over "model" (an
    all-reduce, or under sequence parallelism a reduce-scatter along the
    sequence), the general attention path's all-gather of its cut
    projections, the hd-sharded decode's logits all-reduce and output
    all-gather, the sequence's all-gathers before attention and the MLP,
    the last position's all-reduce, the logits' all-gather, and the
    MoE's exchange of counts when its dispatch falls back to one group
    over the data ranks."""
    from ..models.moe import dp_groups
    m, n = model_size(mesh), 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    cut = lambda sp: model_dim(sp, mesh) is not None  # noqa: E731
    data = lambda sp: data_dim(sp, mesh) is not None  # noqa: E731
    lsp = pspecs["layers"]
    plan = {"all_gather": 0, "exchange": 0, "tp_reduce": 0, "tp_gather": 0,
            "tp_scatter": 0}
    plan["all_gather"] = (int(any(data(v) for k, v in pspecs.items()
                                  if k != "layers"))
                          + cfg.n_layers * int(any(data(v)
                                                   for v in lsp.values())))
    layout = kv_layout(kv_pspec(cfg, mesh), mesh)
    sp = (m > 1 and not decode and cfg.seq_parallel and seq is not None
          and seq % m == 0)
    total = "tp_scatter" if sp else "tp_reduce"
    if m > 1:
        if cut(pspecs["embed"]):
            plan[total] += 1
        per = 2 * int(sp)                          # the sequence gathers
        if layout != "heads" and any(cut(lsp[k])
                                     for k in ("wq", "wk", "wv")):
            per += 1                               # the cut projections
        if decode and layout == "hd":
            plan["tp_reduce"] += cfg.n_layers      # the logits over hd
            per += 1                               # the output slices
        plan["tp_gather"] += cfg.n_layers * per
        sums = int(cut(lsp["wo"]))
        if cfg.family == "moe":
            sums += int(cut(lsp["e_gate"]) or (cfg.n_shared_experts
                                               and cut(lsp["s_down"])))
        else:
            sums += int(cut(lsp["w_down"]))
        plan[total] += cfg.n_layers * sums
        plan["tp_reduce"] += int(sp)               # the last position
        plan["tp_gather"] += int(cut(pspecs["lm_head"]))
    if cfg.family == "moe" and n > 1 and batch_sharded and \
            dp_groups(tokens, n) != n:
        plan["exchange"] = cfg.n_layers
    return plan


def cache_struct(cfg: ArchConfig, shape_name: str):
    """The decode cache of the cell's batch over its sequence, on
    ``meta``."""
    sh = SHAPES[shape_name]
    return init_decode_cache(cfg, sh["global_batch"], sh["seq_len"],
                             device=META)


def kv_pspec(cfg: ArchConfig, mesh: Mesh, batch_ok: bool = True) -> P:
    """``cache_pspecs``' spec of a layer's K and V (B, S, kv, hd): while
    the batch covers the DP axes (``batch_ok``) never S (the decode's
    ring write is at a position a step), kv heads on "model", else
    head_dim, else replicated; for batch 1 (long context)
    sequence-sharded over the whole mesh.  Its "model" entry needs no
    sanitizing: it names "model" only where M divides the dimension."""
    dp, model = dp_axes(mesh), mesh.shape.get("model", 1)
    if batch_ok:
        if cfg.n_kv_heads and cfg.n_kv_heads % model == 0:
            return P(dp, None, "model", None)
        if cfg.hd % model == 0:
            return P(dp, None, None, "model")
        return P(dp, None, None, None)
    return P(None, tuple(mesh.axis_names), None, None)


def cache_pspecs(cfg: ArchConfig, shape_name: str, mesh: Mesh):
    """Batch-sharded when possible; else sequence-sharded over all axes."""
    sh = SHAPES[shape_name]
    b = sh["global_batch"]
    dp = dp_axes(mesh)
    batch_ok = b % max(dp_size(mesh), 1) == 0
    model = mesh.shape.get("model", 1)

    def entry_specs(entry):
        sp = {}
        for k in entry:
            if k in ("k", "v"):
                sp[k] = kv_pspec(cfg, mesh, batch_ok)
            elif k == "ssm":  # (B, nh, hd, st)
                nh = cfg.ssm_nheads
                head = "model" if nh % model == 0 else None
                sp[k] = P(dp if batch_ok else None, head, None, None)
            else:  # conv state (B, K-1, C)
                sp[k] = P(dp, None, None) if batch_ok else P(None, None, None)
        return sp

    return [entry_specs(e) for e in cache_struct(cfg, shape_name)]


def token_pspecs(cfg: ArchConfig, shape_name: str, mesh: Mesh) -> P:
    """The decode step's (B, 1) tokens: split over the data-parallel axes
    when they divide the batch."""
    b = SHAPES[shape_name]["global_batch"]
    bs = dp_axes(mesh) if b % max(dp_size(mesh), 1) == 0 else ()
    return P(bs, None)
