"""Mixture-of-Experts layer with ring-ticket dispatch — the PyTorch twin
of ``repro/models/moe.py``.

Token-to-expert routing is the paper's bounded-ring admission problem:
each routed (token, choice) pair claims a slot in its expert's
capacity-bounded buffer by ticket reservation; over-capacity pairs take
the RETRY path (dropped, weight zeroed), exactly as a full bounded ring
rejects an enqueue.  The reference computes the tickets inline (an
exclusive cumsum of the one-hot) so that XLA can shard it over a mesh;
the port runs on one card, so it routes through ``kernels.moe_route``,
whose ticket step is the B6 kernel (``kernels.expert_tickets``) and
computes the same function.  There
is one dispatch group (the reference's off-mesh case).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ArchConfig
from ..kernels.moe_route import moe_route
from .layers import _dense

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


def moe_capacity(tokens: int, cfg: ArchConfig) -> int:
    """Per-expert capacity C = int(T·k/E · capacity_factor) + 1, rounded
    up to a multiple of 32 (the reference's shardable C)."""
    c = int((tokens * cfg.top_k) / cfg.n_experts * cfg.capacity_factor) + 1
    return -(-c // 32) * 32


def moe_forward(p: Params, x: torch.Tensor, cfg: ArchConfig):
    """x: (B, S, d) -> (B, S, d).  Top-k dispatch with per-expert capacity
    ``moe_capacity(B·S)``; over-capacity pairs are dropped."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)
    # float32 gates; a bfloat16 router (training's cast_params) is
    # promoted, as jnp promotes it
    gates = xt.float() @ p["router"].float()                 # (T, E)
    capacity = moe_capacity(t, cfg)
    # top-k, softmax combine weights and the ring-ticket reservation per
    # expert (the B6 kernel on the card); slot -1 is the RETRY path: drop
    dispatch, top_e, combine = moe_route(gates, k, capacity)
    flat_e = top_e.reshape(t * k)
    slot = dispatch.reshape(t * k)
    keep = dispatch >= 0                                     # (T, k)

    # dispatch into (E, C + 1, d) buffers, dropped pairs into bin C
    s_flat = torch.where(slot >= 0, slot, capacity).long()
    src = xt.repeat_interleave(k, dim=0)                     # (T·k, d)
    buf = torch.zeros(e, capacity + 1, d, dtype=x.dtype, device=x.device)
    buf.index_put_((flat_e, s_flat), src, accumulate=True)
    xin = buf[:, :capacity]                                  # (E, C, d)
    hg = torch.bmm(xin, p["e_gate"])
    hu = torch.bmm(xin, p["e_up"])
    hout = torch.bmm(torch.nn.functional.silu(hg) * hu, p["e_down"])
    gathered = hout[flat_e, torch.clamp(s_flat, max=capacity - 1)]
    gathered = gathered * keep.reshape(t * k, 1).to(x.dtype)
    yt = torch.sum(gathered.reshape(t, k, d)
                   * combine[..., None].to(x.dtype), dim=1)  # (T, d)
    if cfg.n_shared_experts:
        yt = yt + (torch.nn.functional.silu(xt @ p["s_gate"])
                   * (xt @ p["s_up"])) @ p["s_down"]
    return yt.reshape(b, s, d)
