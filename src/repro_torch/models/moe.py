"""Mixture-of-Experts layer with ring-ticket dispatch — the PyTorch twin
of ``repro/models/moe.py``.

Token-to-expert routing is the paper's bounded-ring admission problem:
each routed (token, choice) pair claims a slot in its expert's
capacity-bounded buffer by ticket reservation; over-capacity pairs take
the RETRY path (dropped, weight zeroed), exactly as a full bounded ring
rejects an enqueue.  The reference computes the tickets inline (an
exclusive cumsum of the one-hot) so that XLA can shard it over a mesh;
the port routes through ``kernels.moe_route``, whose ticket step is the
B6 kernel (``kernels.expert_tickets``) and computes the same function.

Dispatch groups follow the reference's ``_dp_groups``: under a mesh of g
data-parallel shards the T tokens are dispatched in g groups (group i is
tokens [i·T/g, (i+1)·T/g) of the flattened (B, S)), each with its own
tickets and a capacity from its own tokens, when T divides by g and a
group holds at least 256 tokens; otherwise in one group (``dp_groups``).
``moe_forward(groups=g)`` computes that on one card, one B6 call a
group.  On a rank of a group-bound mesh (``mesh=``) whose batch rows are
its shard, a group is the rank's own tokens, so the grouped dispatch is
the ungrouped one on them; in the one-group fallback a rank holds only
its tokens of the global group, and its slots are its own tickets plus
each expert's count on the earlier ranks (one exchange of the (E,)
counts, ``mesh_round_gather``), held against the global capacity: the
ticket reservation across shards.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ArchConfig
from ..distributed.collectives import mesh_round_gather
from ..distributed.sharding import P, dp_size
from ..kernels.moe_route import expert_tickets, moe_route, top_k_stable
from .layers import _dense, layer_cut

Params = Dict[str, torch.Tensor]


def moe_params(gen: torch.Generator, cfg: ArchConfig, lead=(),
               dtype=torch.bfloat16) -> Params:
    d, fe, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": _dense(gen, (d, e), dtype=torch.float32, lead=lead),
        "e_gate": _dense(gen, (e, d, fe), dtype=dtype, lead=lead),
        "e_up": _dense(gen, (e, d, fe), dtype=dtype, lead=lead),
        "e_down": _dense(gen, (e, fe, d), dtype=dtype, lead=lead),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * fe
        p["s_gate"] = _dense(gen, (d, fs), dtype=dtype, lead=lead)
        p["s_up"] = _dense(gen, (d, fs), dtype=dtype, lead=lead)
        p["s_down"] = _dense(gen, (fs, d), dtype=dtype, lead=lead)
    return p


def moe_specs(cfg: ArchConfig, fsdp_axis=None):
    f = fsdp_axis
    sp = {
        "router": P(None, None),
        "e_gate": P("model", f, None),   # EP: experts sharded over "model"
        "e_up": P("model", f, None),
        "e_down": P("model", f, None),
    }
    if cfg.n_shared_experts:
        sp["s_gate"] = P(f, "model")
        sp["s_up"] = P(f, "model")
        sp["s_down"] = P("model", f)
    return sp


def dp_groups(t: int, g: int) -> int:
    """Dispatch groups of ``t`` tokens under ``g`` data-parallel shards
    (the reference's ``_dp_groups``): g when g > 1, t divides by g and a
    group keeps at least 256 tokens, else 1."""
    return g if g > 1 and t % g == 0 and t // g >= 256 else 1


def moe_capacity(tokens: int, cfg: ArchConfig) -> int:
    """Per-expert capacity C = int(T·k/E · capacity_factor) + 1, rounded
    up to a multiple of 32 (the reference's shardable C)."""
    c = int((tokens * cfg.top_k) / cfg.n_experts * cfg.capacity_factor) + 1
    return -(-c // 32) * 32


def _route_global(gates: torch.Tensor, k: int, capacity: int, mesh):
    """This rank's pairs of one dispatch group spread over the ranks:
    top-k, tickets among its own pairs (B6, nothing dropped), plus each
    expert's pair count on the earlier ranks, against the group's
    ``capacity``."""
    t, e = gates.shape
    top_g, top_e = top_k_stable(gates, k)
    ids = top_e.reshape(t * k).int()
    own = expert_tickets(ids, num_experts=e, capacity=t * k)
    counts = torch.bincount(ids.long(), minlength=e).int()
    (rows,) = mesh_round_gather((counts,), mesh)
    base = rows[:mesh.rank].sum(0, dtype=torch.int32)
    slot = own + base[ids.long()]
    dispatch = torch.where(slot < capacity, slot, -1).reshape(t, k)
    combine = torch.where(dispatch >= 0, torch.softmax(top_g, dim=-1), 0.0)
    return dispatch, top_e, combine


def route(gates: torch.Tensor, cfg: ArchConfig, groups: int = 1,
          mesh=None):
    """Top-k gating, combine weights and slots of ``gates`` (T, E) in the
    dispatch groups of ``moe_forward``: (dispatch (T, k) int32 slot
    within the pair's group or -1, expert ids (T, k), combine (T, k),
    capacity, group count)."""
    t, k = gates.shape[0], cfg.top_k
    if mesh is not None and mesh.group is not None:
        s = dp_size(mesh)
        if dp_groups(t * s, s) == s:          # this rank's tokens: a group
            cap = moe_capacity(t, cfg)
            return (*moe_route(gates, k, cap), cap, 1)
        cap = moe_capacity(t * s, cfg)        # one group over the ranks
        return (*_route_global(gates, k, cap, mesh), cap, 1)
    g = dp_groups(t, groups)
    cap = moe_capacity(t // g, cfg)
    parts = [moe_route(part, k, cap) for part in gates.chunk(g)]
    return (*(torch.cat(x) for x in zip(*parts)), cap, g)


def moe_forward(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                groups: int = 1, mesh=None, tp=None):
    """x: (B, S, d) -> (B, S, d).  Top-k dispatch with per-expert capacity
    ``moe_capacity`` of a dispatch group's tokens (``groups`` data-parallel
    shards on one card, or this rank's share of a group-bound ``mesh``;
    see the module doc); over-capacity pairs are dropped.

    ``tp`` (a ``distributed.sharding.TensorParallel``): ``x`` is whole on
    every rank of the model axis, so every rank routes all of its data
    shard's tokens (B6) to the same slots.  Where the specs cut the
    experts over "model" (M divides E), ``p`` holds this rank's E / M
    experts, which run only the pairs routed to them; the shared experts
    are column- and row-parallel like the MLP.  The ranks' partial sums
    are combined by ONE collective (``tp.finish``); experts the specs
    leave whole run on every rank and their sum crosses no rank (in
    training one rank takes their gradient, so the input's all-reduce
    counts it once).  The router, whole on every rank, gets a part of its
    gradient on each (``transformer.model_partial``)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)
    # float32 gates; a bfloat16 router (training's cast_params) is
    # promoted, as jnp promotes it
    gates = xt.float() @ p["router"].float()                 # (T, E)
    # top-k, softmax combine weights and the ring-ticket reservation per
    # expert (the B6 kernel on the card); slot -1 is the RETRY path: drop
    dispatch, top_e, combine, capacity, g = route(gates, cfg, groups, mesh)
    flat_e = top_e.reshape(t * k)
    slot = dispatch.reshape(t * k)
    keep = dispatch >= 0                                     # (T, k)
    tp = tp if tp is not None and tp.model > 1 else None
    e_split = tp is not None and layer_cut(tp, "e_gate")
    if e_split:                 # this rank's experts [e0, e0 + E / M)
        e = p["e_gate"].shape[0]
        mine = (flat_e >= tp.m * e) & (flat_e < (tp.m + 1) * e)
        keep = keep & mine.reshape(t, k)
        flat_e = torch.where(mine, flat_e - tp.m * e, 0)
        slot = torch.where(mine, slot, -1)
    grp = torch.arange(g, device=x.device).repeat_interleave(t * k // g)

    # dispatch into (E, g, C + 1, d) buffers, dropped pairs into bin C;
    # the expert products run over the g groups' C rows at once
    s_flat = torch.where(slot >= 0, slot, capacity).long()
    src = xt.repeat_interleave(k, dim=0)                     # (T·k, d)
    buf = torch.zeros(e, g, capacity + 1, d, dtype=x.dtype, device=x.device)
    buf.index_put_((flat_e, grp, s_flat), src, accumulate=True)
    xin = buf[:, :, :capacity].reshape(e, g * capacity, d)   # (E, g·C, d)
    hg = torch.bmm(xin, p["e_gate"])
    hu = torch.bmm(xin, p["e_up"])
    hout = torch.bmm(torch.nn.functional.silu(hg) * hu, p["e_down"])
    gathered = hout[flat_e, grp * capacity
                    + torch.clamp(s_flat, max=capacity - 1)]
    gathered = gathered * keep.reshape(t * k, 1).to(x.dtype)
    yt = torch.sum(gathered.reshape(t, k, d)
                   * combine[..., None].to(x.dtype), dim=1)  # (T, d)
    ys = None
    if cfg.n_shared_experts:
        ys = (torch.nn.functional.silu(xt @ p["s_gate"])
              * (xt @ p["s_up"])) @ p["s_down"]
    if tp is None:
        return (yt if ys is None else yt + ys).reshape(b, s, d)
    parts = {True: None, False: None}       # cut over "model" or whole
    for y, cut in ((yt, e_split), (ys, layer_cut(tp, "s_down"))):
        if y is not None:
            y = y.reshape(b, s, d)
            parts[bool(cut)] = y if parts[bool(cut)] is None else \
                parts[bool(cut)] + y
    return tp.finish(partial=parts[True], whole=parts[False])
