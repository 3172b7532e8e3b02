"""Sequential oracles for the ported kernels — the PyTorch twin of
``repro/kernels/ref.py``: ``wavefaa_ref``, ``ring_enqueue_ref``,
``ring_dequeue_ref``, ``frontier_expand_ref``, ``moe_route_ref`` and
``flash_attention_ref``.

The integer oracles apply their wave one lane at a time in lane (=
ticket) order, the linearization order, on host integers with explicit
32-bit wraparound.  ``flash_attention_ref`` is plain masked softmax
attention over the whole key axis.  They share no code with the kernels
or their plain versions, which is what makes them oracles.  Inputs are
CPU tensors; outputs are new tensors (the inputs are not changed).
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def _i32(x: int) -> int:
    x &= _U32
    return x - (1 << 32) if x >= 1 << 31 else x


def _cycle_lt(a: int, b: int, s: int) -> bool:
    return _i32((b - a) << s) > 0


def wavefaa_ref(active: torch.Tensor, counter: torch.Tensor):
    """tickets[i] = counter + (active lanes before i) for active lanes,
    -1 otherwise; new_counter = counter + popcount (paper Alg. 1 WAVEFAA,
    Lemma III.1)."""
    ctr = int(counter.reshape(-1)[0])
    out = []
    for a in active.tolist():
        if a > 0:
            out.append(_i32(ctr))
            ctr += 1
        else:
            out.append(-1)
    return (torch.tensor(out, dtype=torch.int32),
            torch.tensor([_i32(ctr)], dtype=torch.int32))


def ring_enqueue_ref(cycles, safes, enqs, idxs, tickets, values, head,
                     nslots_log2: int, idx_bot: int):
    """G-LFQ fast-path installs (paper Alg. 1 TRYENQ) applied in ticket
    order.  Returns (cycles, safes, enqs, idxs, ok (B,) bool)."""
    cyc, saf, enq, idx = (p.tolist() for p in (cycles, safes, enqs, idxs))
    h = int(torch.as_tensor(head).reshape(-1)[0])
    mask = (1 << nslots_log2) - 1
    ok = []
    for t, v in zip(tickets.tolist(), values.tolist()):
        can = False
        if t >= 0:
            j, c = t & mask, (t & _U32) >> nslots_log2
            empty = idx[j] in (idx_bot, idx_bot - 1)
            can = (_cycle_lt(cyc[j], c, nslots_log2) and empty
                   and (saf[j] == 1 or _i32(t - h) >= 0))
            if can:
                cyc[j], saf[j], enq[j], idx[j] = c, 1, 1, v
        ok.append(can)
    return (*(torch.tensor(p, dtype=torch.int32)
              for p in (cyc, saf, enq, idx)),
            torch.tensor(ok, dtype=torch.bool))


def ring_dequeue_ref(cycles, safes, enqs, idxs, tickets, nslots_log2: int,
                     idx_bot: int):
    """G-LFQ fast-path consumes (paper Alg. 1 TRYDEQ match branch) in
    ticket order: consume on a cycle match, advance stale empty slots,
    mark stale live slots unsafe.  Returns (cycles, safes, enqs, idxs,
    vals (B,) int32 with -1 on a miss, ok (B,) bool)."""
    cyc, saf, enq, idx = (p.tolist() for p in (cycles, safes, enqs, idxs))
    mask = (1 << nslots_log2) - 1
    vals, ok = [], []
    for t in tickets.tolist():
        v, hit = -1, False
        if t >= 0:
            j, c = t & mask, (t & _U32) >> nslots_log2
            empty = idx[j] in (idx_bot, idx_bot - 1)
            hit = cyc[j] == c and not empty and enq[j] == 1
            if hit:
                v, idx[j] = idx[j], idx_bot - 1
            elif _cycle_lt(cyc[j], c, nslots_log2):
                if empty:
                    cyc[j] = c
                else:
                    saf[j] = 0
        vals.append(v)
        ok.append(hit)
    return (*(torch.tensor(p, dtype=torch.int32)
              for p in (cyc, saf, enq, idx)),
            torch.tensor(vals, dtype=torch.int32),
            torch.tensor(ok, dtype=torch.bool))


def frontier_expand_ref(row_ptr, col_idx, frontier, frontier_len, visited,
                        max_out: int):
    """Level-synchronous BFS frontier expansion (paper § V-B-a): for each
    frontier vertex in order (-1 slots skipped), scan its CSR neighbours;
    each unvisited one is marked and takes ticket = running count in the
    next frontier.  A ticket >= ``max_out`` is DROPPED (the reference
    oracle's out-of-range scatter), where the Pallas kernel and
    ``kernels.frontier`` clamp it to the last slot.  ``frontier_len`` is
    ignored, as in the reference.  Returns (next_frontier (max_out,)
    padded -1, count (0-d int32), visited')."""
    rp, col = row_ptr.tolist(), col_idx.tolist()
    vis = visited.tolist()
    out = [-1] * max_out
    cnt = 0
    for u in frontier.tolist():
        if u < 0:
            continue
        for k in range(rp[u], rp[u + 1]):
            v = col[k]
            if vis[v] == 0:
                if cnt < max_out:
                    out[cnt] = v
                cnt += 1
            vis[v] = 1
    return (torch.tensor(out, dtype=torch.int32),
            torch.tensor(cnt, dtype=torch.int32),
            torch.tensor(vis, dtype=torch.int32))


def moe_route_ref(gates: torch.Tensor, k: int, capacity: int):
    """Capacity-bounded top-k MoE dispatch by per-expert ticket
    reservation, one (token, choice) pair at a time in token order, as a
    per-pair FAA on the expert's tail would hand them out; pairs past an
    expert's capacity are dropped (the bounded ring's RETRY path).  Top-k
    picks the largest gates, equal gates in index order.  Returns
    (dispatch (T, k) int32 slot or -1, expert ids (T, k) int32, combine
    (T, k) float32: the softmax of the top-k gates, 0 where dropped)."""
    rows = gates.tolist()
    tail = [0] * gates.shape[1]
    dispatch, experts, combine = [], [], []
    for row in rows:
        order = sorted(range(len(row)), key=lambda e: (-row[e], e))[:k]
        top = torch.tensor([row[e] for e in order], dtype=gates.dtype)
        probs = torch.softmax(top.float(), 0).tolist()
        d, c = [], []
        for e, pr in zip(order, probs):
            slot = tail[e]
            tail[e] += 1
            ok = slot < capacity
            d.append(slot if ok else -1)
            c.append(pr if ok else 0.0)
        dispatch.append(d)
        experts.append(order)
        combine.append(c)
    return (torch.tensor(dispatch, dtype=torch.int32),
            torch.tensor(experts, dtype=torch.int32),
            torch.tensor(combine, dtype=torch.float32))


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap_val=0.0):
    """Oracle for ``kernels.flash_attn``: plain masked softmax attention
    over the whole key axis, with the kv heads repeated for GQA.
    q (B, H, Sq, hd); k/v (B, KV, Sk, hd)."""
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    rep = h // kvh
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() / (hd ** 0.5)
    if softcap_val:
        s = softcap_val * torch.tanh(s / softcap_val)
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    ok = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        ok = ok & (kpos <= qpos)
    if window:
        ok = ok & (kpos > qpos - window)
    s = torch.where(ok, s, -1e30)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)
