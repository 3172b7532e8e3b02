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
PyTorch on both devices.  ``ssm_specs`` gives the reference's
PartitionSpecs; its "model" pin (``_ssd_axis``) changes no number on a
mesh whose "model" is 1 and is left out.

Decode keeps O(1) state per layer: (conv_state (B, d_conv - 1,
d_conv_in), ssm_state (B, nh, hd, state) in float32).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..distributed.sharding import P
from . import layers
from .layers import _dense, _rms_norm, by_rows

CHUNK = 256
#: elements of ``ssd_chunked``'s largest float32 temporaries, (b, chunks,
#: CHUNK, CHUNK, nh), above which it walks the chunks in groups (2 GiB;
#: mamba2-130m's were 13 GB each at 524,288 tokens, zamba2-7b's 60 GB)
SSD_SLAB = 2 ** 29


def ssm_params(gen: torch.Generator, cfg: ArchConfig, lead=(),
               dtype=torch.bfloat16) -> Dict:
    d, di, st, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    conv_in = di + 2 * st  # x, B, C share the conv (n_groups = 1)
    dev = gen.device
    return {
        "in_proj": _dense(gen, (d, 2 * di + 2 * st + nh), dtype=dtype,
                          lead=lead),
        "conv_w": _dense(gen, (cfg.ssm_conv, conv_in), dtype=dtype,
                         lead=lead),
        "A_log": torch.zeros(tuple(lead) + (nh,), dtype=torch.float32,
                             device=dev),
        "D": torch.ones(tuple(lead) + (nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(tuple(lead) + (nh,), dtype=torch.float32,
                               device=dev),
        "ssm_norm": torch.zeros(tuple(lead) + (di,), dtype=dtype,
                                device=dev),
        "out_proj": _dense(gen, (di, d), dtype=dtype, lead=lead),
    }


def ssm_specs(cfg: ArchConfig, fsdp_axis=None):
    f = fsdp_axis
    return {
        "in_proj": P(f, "model"),
        "conv_w": P(None, "model"),
        "A_log": P(None), "D": P(None), "dt_bias": P(None),
        "ssm_norm": P("model"),
        "out_proj": P("model", f),
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
    Returns (silu(out), new_state (B, K-1, C)).  A sequence of more than
    ``layers.ROW_SLAB`` elements runs in slabs of positions, each with the
    K - 1 positions before it (a 524,288-token prompt: zamba2-7b's
    padded copy and its partial sums were 7.6 GB each)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros(xbc.shape[0], k - 1, xbc.shape[2], dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    s = xbc.shape[1]
    step = max(k, layers.ROW_SLAB // max(xbc.shape[0] * xbc.shape[2], 1))
    if s > step:
        out = torch.empty_like(xbc)
        for i in range(0, s, step):
            head = pad if i == 0 else xbc[:, i - (k - 1):i]
            out[:, i:i + step] = _causal_conv(xbc[:, i:i + step], w,
                                              head)[0]
        return out, torch.cat([pad, xbc[:, -(k - 1):]], dim=1)[:, -(k - 1):]
    xp = torch.cat([pad, xbc], dim=1)
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
    the carried state computed for a group of chunks at once: the
    intra-chunk quadratic form (O(b g ck^2 nh) transient memory for g
    chunks, ``SSD_SLAB``), each chunk's contribution to the state and
    its decay.  Only the state recurrence
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
    mask = torch.tril(torch.ones(ck, ck, dtype=torch.bool, device=x.device))
    # chunks a group: each group's (b, c, t, u, nh) float32 terms within
    # SSD_SLAB elements (one group at every training and 32k shape)
    per = max(1, SSD_SLAB // (b * ck * ck * nh))
    h = init_state.to(f32)
    y = (torch.empty(b, nc, ck, nh, hd, dtype=xdt, device=x.device)
         if per < nc else None)
    for c0 in range(0, nc, per):
        g = slice(c0, min(c0 + per, nc))
        xg, dtg, Bg, Cg, segg = xc[:, g], dtc[:, g], Bc[:, g], Cc[:, g], \
            seg[:, g]
        # intra-chunk:  y[t] = sum_{u<=t} C_t.B_u exp(seg_t-seg_u) dt_u x_u
        gate = segg[:, :, :, None, :] - segg[:, :, None, :, :]  # (b,c,t,u,nh)
        gate = torch.where(mask[:, :, None], gate, float("-inf"))
        cb = torch.einsum("bcts,bcus->bctu", Cg, Bg)
        w = cb[..., None] * torch.exp(gate)
        del gate, cb
        # the reference's three-operand einsum: w and dt x in x's dtype
        y_intra = torch.einsum("bctuh,bcuhd->bcthd", w.to(xdt),
                               dtg.to(xdt)[..., None] * xg)
        del w
        # each chunk's share of the state it hands on:
        # sum_u exp(seg_last - seg_u) dt_u B_u x_u
        decay_last = torch.exp(segg[:, :, -1:, :] - segg)
        contrib = torch.einsum("bcuh,bcuhd,bcus->bchds",
                               decay_last * dtg.to(f32), xg.to(f32),
                               Bg.to(f32))
        decay = torch.exp(torch.sum(dA[:, g], dim=2))        # (b,c,nh)
        h_in = []
        for dc, cc in zip(decay[..., None, None].unbind(1),
                          contrib.unbind(1)):
            h_in.append(h)
            h = h * dc + cc
        # inter-chunk:  y[t] += exp(seg_t) . C_t . h_in
        y_inter = torch.einsum("bcts,bchds,bcth->bcthd", Cg.to(f32),
                               torch.stack(h_in, dim=1),
                               torch.exp(segg)).to(xdt)
        if y is None:
            y = y_intra + y_inter
        else:
            y[:, g] = y_intra + y_inter
    return y.reshape(b, s, nh, hd), h


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
    elif s > CHUNK and s % CHUNK:
        # a ragged prompt: the last chunk padded with positions of dt = 0,
        # which neither decay the state nor add to it (the reference takes
        # whole chunks only)
        pad = CHUNK - s % CHUNK
        y, final = ssd_chunked(*(torch.nn.functional.pad(
            t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (xs, dt)),
            p["A_log"], *(torch.nn.functional.pad(t, (0, 0, 0, pad))
                          for t in (B, C)), init)
        y = y[:, :s]
    else:
        y, final = ssd_chunked(xs, dt, p["A_log"], B, C, init)
    # the skip, the gate and the norm, a slab of positions at a time
    d_skip = p["D"].to(x.dtype).repeat_interleave(hd)        # (di,)

    def tail(y, xs, z):
        return _rms_norm((y + xs * d_skip) * torch.nn.functional.silu(z),
                         p["ssm_norm"], 1e-6)
    y = by_rows(tail, y.reshape(b, s, di), 2 * di, xs.reshape(b, s, di), z)
    out = y @ p["out_proj"]
    return out, (new_conv, final)
