"""Mamba2 — SSD (state-space duality) layer in chunked matmul form — the
PyTorch twin of ``repro/models/ssm.py``.

The sequence is split into chunks of ``CHUNK``: within a chunk the
recurrence is computed in its quadratic, attention-like matmul form, and
the chunk-boundary states are carried from chunk to chunk.  The
reference's ``lax.scan`` over chunks becomes batched products over all
chunks and a Python loop for the state alone, with the reference's
types: the decay and gate chain and the carried state in
float32, the products of bfloat16 activations in bfloat16, and
``-exp(A_log)`` in the parameter's own type (bfloat16 in training, where
``cast_params`` casts every float32 leaf).  No Pallas
kernel is involved (the reference computes SSD in XLA), so this is plain
PyTorch on both devices.  The reference's sharding pins (``_ssd_axis``,
``ssm_specs``) have no meaning on one card and are left out.

Decode keeps O(1) state per layer: (conv_state (B, d_conv - 1,
d_conv_in), ssm_state (B, nh, hd, state) in float32).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from .layers import _dense, rms_norm

CHUNK = 256


def ssm_params(gen: torch.Generator, cfg: ArchConfig, lead=()) -> Dict:
    d, di, st, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    conv_in = di + 2 * st  # x, B, C share the conv (n_groups = 1)
    dev = gen.device
    return {
        "in_proj": _dense(gen, (d, 2 * di + 2 * st + nh), lead=lead),
        "conv_w": _dense(gen, (cfg.ssm_conv, conv_in), lead=lead),
        "A_log": torch.zeros(tuple(lead) + (nh,), dtype=torch.float32,
                             device=dev),
        "D": torch.ones(tuple(lead) + (nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(tuple(lead) + (nh,), dtype=torch.float32,
                               device=dev),
        "ssm_norm": torch.zeros(tuple(lead) + (di,), dtype=torch.bfloat16,
                                device=dev),
        "out_proj": _dense(gen, (di, d), lead=lead),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    di, st = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * st]
    dt = zxbcdt[..., di + di + 2 * st:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  xbc (B, S, C), w (K, C).
    Returns (silu(out), new_state (B, K-1, C))."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros(xbc.shape[0], k - 1, xbc.shape[2], dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    out = xp[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * w[i][None, None, :]
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    return torch.nn.functional.silu(out), new_state


def ssd_chunked(x, dt, A, B, C, init_state):
    """Chunked SSD.  x (b, s, nh, hd); dt (b, s, nh); A (nh,);
    B, C (b, s, st); init_state (b, nh, hd, st).
    Returns (y (b, s, nh, hd), final_state (b, nh, hd, st) float32).

    The reference's scan body, with every term that does not depend on
    the carried state computed for all chunks at once: the intra-chunk
    quadratic form (O(b nc ck^2 nh) transient memory), each chunk's
    contribution to the state and its decay.  Only the state recurrence
    h_c = h_{c-1} exp(sum dA_c) + contrib_c runs chunk by chunk, in
    float32; each chunk's y_inter then reads the state it started
    from."""
    b, s, nh, hd = x.shape
    st = B.shape[-1]
    ck = min(CHUNK, s)
    nc = s // ck
    if s % ck:
        raise ValueError(f"ssd_chunked: the sequence ({s}) must be shorter "
                         f"than the chunk ({CHUNK}) or a multiple of it")
    negA = -torch.exp(A)                                     # (nh,) < 0
    f32, xdt = torch.float32, x.dtype
    xc = x.reshape(b, nc, ck, nh, hd)
    dtc = dt.reshape(b, nc, ck, nh)
    Bc, Cc = B.reshape(b, nc, ck, st), C.reshape(b, nc, ck, st)
    dA = dtc * negA                                          # (b,c,ck,nh) <= 0
    seg = torch.cumsum(dA, dim=2)
    # intra-chunk:  y[t] = sum_{u<=t} C_t.B_u exp(seg_t-seg_u) dt_u x_u
    mask = torch.tril(torch.ones(ck, ck, dtype=torch.bool, device=x.device))
    gate = seg[:, :, :, None, :] - seg[:, :, None, :, :]     # (b,c,t,u,nh)
    gate = torch.where(mask[:, :, None], gate, float("-inf"))
    cb = torch.einsum("bcts,bcus->bctu", Cc, Bc)
    w = cb[..., None] * torch.exp(gate)
    # the reference's three-operand einsum: w and dt x in x's dtype
    y_intra = torch.einsum("bctuh,bcuhd->bcthd", w.to(xdt),
                           dtc.to(xdt)[..., None] * xc)
    # each chunk's share of the state it hands on:
    # sum_u exp(seg_last - seg_u) dt_u B_u x_u
    decay_last = torch.exp(seg[:, :, -1:, :] - seg)
    contrib = torch.einsum("bcuh,bcuhd,bcus->bchds", decay_last * dtc.to(f32),
                           xc.to(f32), Bc.to(f32))
    decay = torch.exp(torch.sum(dA, dim=2))                  # (b,c,nh)
    h = init_state.to(f32)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * decay[:, c, :, None, None] + contrib[:, c]
    # inter-chunk:  y[t] += exp(seg_t) . C_t . h_in
    y_inter = torch.einsum("bcts,bchds,bcth->bcthd", Cc.to(f32),
                           torch.stack(h_in, dim=1),
                           torch.exp(seg)).to(xdt)
    return (y_intra + y_inter).reshape(b, s, nh, hd), h


def ssm_forward(p: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                state: Optional[Tuple] = None):
    """x (B, S, d).  state = (conv_state, ssm_state) for decode.
    Returns (out (B, S, d), new_state (conv_state, ssm_state))."""
    b, s, d = x.shape
    di, st, nh, hd = (cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads,
                      cfg.ssm_headdim)
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    conv_state = state[0] if state is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], conv_state)
    xs = xbc[..., :di].reshape(b, s, nh, hd)
    B = xbc[..., di:di + st]
    C = xbc[..., di + st:]
    dt = torch.nn.functional.softplus(dt.float()
                                      + p["dt_bias"][None, None, :])
    f32 = torch.float32
    init = (state[1] if state is not None
            else torch.zeros(b, nh, hd, st, dtype=f32, device=x.device))
    if s == 1:
        # decode: a single recurrence step
        dA = torch.exp(dt[:, 0, :] * (-torch.exp(p["A_log"]))[None])
        h = init.to(f32) * dA[:, :, None, None] + torch.einsum(
            "bh,bhd,bs->bhds", dt[:, 0].to(f32), xs[:, 0].to(f32),
            B[:, 0].to(f32))
        y = torch.einsum("bs,bhds->bhd", C[:, 0].to(f32),
                         h).to(x.dtype).reshape(b, 1, nh, hd)
        final = h
    else:
        y, final = ssd_chunked(xs, dt, p["A_log"], B, C, init)
    y = y + xs * p["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(b, s, di)
    y = rms_norm(y * torch.nn.functional.silu(z), p["ssm_norm"])
    out = y @ p["out_proj"]
    return out, (new_conv, final)
