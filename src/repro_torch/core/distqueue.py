"""The distributed (mesh-level) bounded queues — the PyTorch twin of
``repro/core/distqueue.py``: the FIFO ring (replicated and sharded) and
the priority planes of the priority mesh.

The reference runs one shard per device: each function takes one
shard's ``(B,)`` requests inside ``shard_map`` and one psum gathers the
round.  On one card the shard axis is a tensor dimension: every function
here takes the stacked ``(S, B)`` requests of all shards (row i = shard
i) and returns every shard's slice, ``(S, B)`` granted, values and ok.
The gathered grid is the rows flattened shard-major, so the tickets and
the ring states are the reference's, bit for bit.  Given ``mesh=`` a
group-bound mesh (``distributed.make_mesh(..., group=)``), they take
this rank's ``(B,)`` requests and return this rank's slice, as the
reference's do inside ``shard_map``: the gather is one ``all_reduce``,
replicated state is held whole and identical on every rank, and the
sharded functions take this rank's ring only.

The replicated ring (``DistQueueState``) is held once: four (2n,) int32
field planes and 0-d head/tail tickets.  The sharded rings
(``DistShardedQueueState``) are (S, 2n_l) planes, one ring a row, with
(S,) heads and tails.

Two application engines (bit-identical planes), as in the reference:

* ``engine="planes"`` (default): the round's ops go through
  ``kernels.ring_slots.enq_planes`` / ``deq_planes`` in sub-waves of 2n
  consecutive tickets, each lane's activity an explicit mask.  On the
  card these launch the ring waves' masked instance (``ring_enqueue`` /
  ``ring_dequeue`` with ``active``), so tickets past 2^31 are live.
* ``engine="scan"``: the serial reference, one op at a time through the
  same faces in ticket order (sorted by rank with an ``INT32_MAX``
  sentinel for inactive lanes).

Tickets are unsigned mod-2^32 counters carried in int32; the arithmetic
here takes int64 and wraps with explicit 32-bit masks.  The mesh round
engines (``runtime.meshrounds``) run a round's claim and publish as one
kernel launch each (``ring_dequeue_wave``, ``ring_enqueue_wave`` over
the S-shard lane grid) and hold the same contracts as these
functions.

The priority planes (``DistHeapState``) are the chip heap's key/val
planes: one heap a shard stacked ``(S, cap)`` with ``(S,)`` sizes (the
relaxed mesh) or one heap held once (the strict mesh).
``dist_priority_publish_round`` is the priority round's exchange: every
shard's ``(S, W)`` child rows and its ``(hint, size)`` meta words (and,
with telemetry, its popped-key extrema), gathered as the stacked rows,
with the children's ranks shard-major; the compact form passes each
row through ``wave_compact`` (B3) first.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..distributed.collectives import (  # noqa: F401  (re-exported)
    mesh_round_gather, mesh_ticket_base)
from ..kernels._build import resolve_device
from ..kernels.compact import wave_compact
from ..kernels.heap_batch import KEY_INF
from ..kernels.ring_slots import (  # noqa: F401  (the schedules re-exported)
    claim_schedule, deq_planes, enq_planes, priority_claim_schedule)
from ..kernels.wavefaa import _i32

IDX_BOT = 2 ** 31 - 1
IDX_BOTC = 2 ** 31 - 2
_SENTINEL = 2 ** 31 - 1      # order-safe: sorts after any live rank


class DistQueueState(NamedTuple):
    """The replicated ring: the chip ring's four (2n,) int32 field planes
    and 0-d int32 tail/head tickets (unsigned mod 2^32)."""
    cycles: torch.Tensor
    safes: torch.Tensor
    enqs: torch.Tensor
    idxs: torch.Tensor
    tail: torch.Tensor
    head: torch.Tensor

    @property
    def occupancy(self):
        return _i32(torch.as_tensor(self.tail).long()
                    - torch.as_tensor(self.head).long())


def _signed(u: int) -> int:
    u %= 2 ** 32
    return u - 2 ** 32 if u >= 2 ** 31 else u


def dist_queue_init(capacity: int, *, start: int = None,
                    device="cuda") -> DistQueueState:
    """Ring with logical capacity rounded up to a power of two (2n slots)
    on ``device``.  ``start`` overrides the first head/tail ticket (a
    multiple of 2n; tests start near the int32 boundary)."""
    dev = resolve_device(device)
    cap = 1 << max(int(capacity) - 1, 1).bit_length()
    n2 = 2 * cap
    if start is None:
        start = n2                     # first tickets: cycle 1 over cycle 0
    if start % n2:
        raise ValueError(f"start {start} must be a multiple of 2n={n2}")
    start_u = int(start) % (2 ** 32)
    # empty slots carry the cycle before the start ticket's (wrapped), or
    # the first installs would be rejected as stale
    lg = n2.bit_length() - 1
    cyc0 = _signed(((start_u >> lg) - 1) % (2 ** (32 - lg)))
    i32 = dict(dtype=torch.int32, device=dev)
    return DistQueueState(
        cycles=torch.full((n2,), cyc0, **i32),
        safes=torch.ones((n2,), **i32),
        enqs=torch.zeros((n2,), **i32),
        idxs=torch.full((n2,), IDX_BOT, **i32),
        tail=torch.tensor(_signed(start_u), **i32),
        head=torch.tensor(_signed(start_u), **i32))


def _nslots_log2(state) -> int:
    n2 = state.cycles.shape[-1]
    lg = n2.bit_length() - 1
    assert (1 << lg) == n2, "slot count must be a power of two"
    return lg


def _planes(state):
    return (state.cycles, state.safes, state.enqs, state.idxs)


def _subwaves(total_ops: int, n2: int) -> int:
    """How many waves of at most 2n consecutive tickets a round of
    ``total_ops`` needs, so each wave hits distinct slots (Lemma III.1)."""
    return -(-total_ops // n2)


def _apply_enqueue(planes, head, tickets, values, active, ranks, *,
                   nslots_log2: int, engine: str, max_rank: int = None,
                   births=None, birth_round=None):
    """Apply a round's gathered enqueue ops (reference
    ``_apply_enqueue``): ``tickets`` = tail + rank, ``ranks`` in [0,
    total) for active ops, ``max_rank`` a bound on the active ranks.
    Returns (planes, ok (n,) int32) in gathered op order, and with a
    ``births`` plane (CPU only) the new plane last."""
    n2 = 1 << nslots_log2
    nops = tickets.shape[0]
    kw = dict(nslots_log2=nslots_log2, idx_bot=IDX_BOT,
              birth_round=birth_round)
    if engine == "planes":
        ok = torch.zeros(nops, dtype=torch.int32, device=tickets.device)
        for w in range(_subwaves(min(nops, max_rank or nops), n2)):
            wave = active & (ranks >= w * n2) & (ranks < (w + 1) * n2)
            out = enq_planes(*planes, tickets, values, head, active=wave,
                             births=births, **kw)
            planes = out[:4]
            if births is not None:
                births = out[5]
            ok = ok | out[4]
        return (planes, ok) if births is None else (planes, ok, births)
    if engine != "scan":
        raise ValueError(f"unknown engine {engine!r} (planes|scan)")
    order = torch.argsort(torch.where(active, ranks.long(), _SENTINEL),
                          stable=True)
    oks = []
    for i in range(nops):
        o = order[i:i + 1]
        out = enq_planes(*planes, tickets[o], values[o], head,
                         active=active[o], births=births, **kw)
        planes = out[:4]
        if births is not None:
            births = out[5]
        oks.append(out[4])
    ok = _unsort(oks, order, tickets)
    return (planes, ok) if births is None else (planes, ok, births)


def _unsort(parts, order, like):
    """Results made in ``order`` back in op order."""
    if not parts:
        return torch.zeros(0, dtype=torch.int32, device=like.device)
    return torch.cat(parts)[torch.argsort(order)]


def _apply_dequeue(planes, tickets, active, ranks, *, nslots_log2: int,
                   engine: str, births=None):
    """Apply a round's gathered dequeue ops (reference ``_apply_dequeue``).
    Returns (planes, vals, ok) in gathered op order, and with a
    ``births`` plane (CPU only) the consumed slots' births last (-1 on a
    miss)."""
    n2 = 1 << nslots_log2
    nops = tickets.shape[0]
    kw = dict(nslots_log2=nslots_log2, idx_bot=IDX_BOT, births=births)
    if engine == "planes":
        dev = tickets.device
        ok = torch.zeros(nops, dtype=torch.int32, device=dev)
        vals = torch.full((nops,), -1, dtype=torch.int32, device=dev)
        bvals = None if births is None else vals.clone()
        for w in range(_subwaves(nops, n2)):
            wave = active & (ranks >= w * n2) & (ranks < (w + 1) * n2)
            out = deq_planes(*planes, tickets, active=wave, **kw)
            planes = out[:4]
            ok = ok | out[5]
            vals = torch.where(wave, out[4], vals)
            if births is not None:
                bvals = torch.where(wave, out[6], bvals)
        return ((planes, vals, ok) if births is None
                else (planes, vals, ok, bvals))
    if engine != "scan":
        raise ValueError(f"unknown engine {engine!r} (planes|scan)")
    order = torch.argsort(torch.where(active, ranks.long(), _SENTINEL),
                          stable=True)
    ys = [[] for _ in range(2 if births is None else 3)]
    for i in range(nops):
        o = order[i:i + 1]
        out = deq_planes(*planes, tickets[o], active=active[o], **kw)
        planes = out[:4]
        for y, x in zip(ys, out[4:]):
            y.append(x)
    return (planes, *(_unsort(y, order, tickets) for y in ys))


def _rank(mesh):
    """This rank's shard on a group-bound mesh, else None (one card)."""
    return None if mesh is None else mesh.rank


def _local(x, s: int, b: int, me):
    """The gathered (S * B,) ``x`` as the caller's rows: (S, B), or this
    rank's (B,) row on a group-bound mesh."""
    x = x.reshape(s, b)
    return x if me is None else x[me]


def _gathered_round(values, mask, mesh=None):
    """The round's exchange: the (S, B) requests (this rank's (B,) on a
    group-bound mesh) flattened shard-major to (S * B,) gathered
    (values, active, ranks, total); ranks are the exclusive prefix over
    the gathered mask (the per-shard FAA bases' ticket order)."""
    mask_i = (mask > 0).to(torch.int32)
    gv, gm = mesh_round_gather((values.to(torch.int32), mask_i), mesh)
    gv, gm = gv.reshape(-1), gm.reshape(-1).long()
    ranks = torch.cumsum(gm, 0) - gm
    return gv, gm > 0, ranks, _i32(gm.sum())


def _wrap_add(a, b):
    return _i32(torch.as_tensor(a).long() + torch.as_tensor(b).long())


def dist_enqueue_round(state: DistQueueState, values, mask, *,
                       engine: str = "planes", mesh=None):
    """One enqueue round: ``values``/``mask`` (S, B), shard i's requests
    in row i (this rank's (B,) on a group-bound ``mesh``).  Returns
    (new_state, granted (S, B) bool, or this rank's (B,))."""
    me = _rank(mesh)
    s, b = values.shape if me is None else (mesh.size, values.shape[0])
    gv, active, ranks, total = _gathered_round(values, mask, mesh)
    tickets = _wrap_add(state.tail, ranks)
    planes, ok = _apply_enqueue(_planes(state), state.head, tickets, gv,
                                active, ranks,
                                nslots_log2=_nslots_log2(state),
                                engine=engine)
    new = DistQueueState(*planes, tail=_wrap_add(state.tail, total),
                         head=state.head)
    return new, (_local(ok, s, b, me) > 0) & (mask > 0)


def dist_dequeue_round(state: DistQueueState, want, *,
                       engine: str = "planes", mesh=None):
    """One dequeue round: ``want`` (S, B) request masks (this rank's (B,)
    on a group-bound ``mesh``).  Every request takes a ticket; those past
    the occupancy burn it on an empty slot (⊥-advance) and return
    ok=False.  Returns (new_state, values, ok), (S, B) or this rank's
    (B,)."""
    me = _rank(mesh)
    s, b = want.shape if me is None else (mesh.size, want.shape[0])
    _, active, ranks, total = _gathered_round(want, want, mesh)
    tickets = _wrap_add(state.head, ranks)
    planes, vals, ok = _apply_dequeue(_planes(state), tickets, active, ranks,
                                      nslots_log2=_nslots_log2(state),
                                      engine=engine)
    new = DistQueueState(*planes, tail=state.tail,
                         head=_wrap_add(state.head, total))
    return (new, _local(vals, s, b, me),
            (_local(ok, s, b, me) > 0) & (want > 0))


def dist_publish_round(state: DistQueueState, values, mask, *,
                       capacity: int, engine: str = "planes",
                       with_counts: bool = False, births=None,
                       birth_round=None, mesh=None):
    """Enqueue round with overflow suppression over the whole round: when
    the round's total would push the occupancy past ``capacity`` NOTHING
    installs, tail stays, and ``over`` is True.  Returns (new_state,
    granted (S, B) (this rank's (B,) on a group-bound ``mesh``), total,
    over), then with ``with_counts`` each shard's published count (S,)
    (0 on overflow), then with ``births`` (a separate stamp plane, CPU
    only) the new births plane."""
    me = _rank(mesh)
    s, b = values.shape if me is None else (mesh.size, values.shape[0])
    lg = _nslots_log2(state)
    gv, active, ranks, total = _gathered_round(values, mask, mesh)
    over = _i32(state.occupancy.long() + total.long()) > capacity
    active = active & ~over
    tickets = _wrap_add(state.tail, ranks)
    # suppression bounds the active ranks by the capacity: one live wave
    out = _apply_enqueue(_planes(state), state.head, tickets, gv, active,
                         ranks, nslots_log2=lg, engine=engine,
                         max_rank=capacity, births=births,
                         birth_round=birth_round)
    planes, ok = out[0], out[1]
    total = torch.where(over, 0, total)
    new = DistQueueState(*planes, tail=_wrap_add(state.tail, total),
                         head=state.head)
    res = (new, (_local(ok, s, b, me) > 0) & (mask > 0), total, over)
    if with_counts:
        res = res + (active.reshape(s, b).sum(1, dtype=torch.int32),)
    if births is not None:
        res = res + (out[2],)
    return res


def _compact_grid(counts, width: int):
    """The gathered op grid from per-shard compact counts (reference
    ``_compact_grid``): shard i's dense lanes ``[0, min(count_i,
    width))`` take ranks ``exclusive_prefix(counts)[i] + lane``, the
    sparse gather's cumsum order.  Returns flattened (S * width,)
    (active, ranks)."""
    counts = torch.as_tensor(counts).long()
    base = torch.cumsum(counts, 0) - counts
    lane = torch.arange(width, dtype=torch.int64, device=counts.device)
    act2 = lane[None, :] < torch.clamp(counts, max=width)[:, None]
    ranks = torch.where(act2, base[:, None] + lane[None, :], 0)
    return act2.reshape(-1), ranks.reshape(-1)


def _compact_rows(values, mask, width: int, scratch=None):
    """Each shard's row of children compacted to ``width`` lanes
    (``wave_compact``, B3 on the card, on ``scratch`` when given): ((S,
    width) int32, (S,) int32 true popcounts).  ``values`` is one (S, N)
    plane, or a tuple of planes under the one mask (then the first item
    is the tuple of dense planes)."""
    planes = values if isinstance(values, tuple) else (values,)
    planes = tuple(p.to(torch.int32) for p in planes)
    dense, counts = [], []
    for i, m in enumerate(mask > 0):
        ds, c = wave_compact(m.contiguous(),
                             tuple(p[i].contiguous() for p in planes),
                             width=width, scratch=scratch)
        dense.append(ds)
        counts.append(c.reshape(1))
    out = tuple(torch.stack(d) for d in zip(*dense))
    return (out if isinstance(values, tuple) else out[0]), torch.cat(counts)


def dist_publish_compact_round(state: DistQueueState, values, mask, *,
                               capacity: int, width: int,
                               with_counts: bool = False, births=None,
                               birth_round=None, mesh=None):
    """``dist_publish_round`` under the dense-wave rule: each shard's row
    is compacted to ``width`` lanes before the exchange and the ranks are
    rebuilt from the true counts (``_compact_grid``), so the installs and
    the planes are the sparse round's.  Returns (new_state, None, total,
    over)[, counts (S,)][, births]."""
    lg = _nslots_log2(state)
    me = _rank(mesh)
    rows = (values, mask) if me is None else (values[None], mask[None])
    dv, count = _compact_rows(*rows, width)
    gv, gmeta = mesh_round_gather(
        (dv, count.reshape(-1, 1)) if me is None else (dv[0], count), mesh)
    counts = gmeta[:, 0]
    total = _i32(counts.long().sum())
    active, ranks = _compact_grid(counts, width)
    over = _i32(state.occupancy.long() + total.long()) > capacity
    active = active & ~over
    tickets = _wrap_add(state.tail, ranks)
    out = _apply_enqueue(_planes(state), state.head, tickets, gv.reshape(-1),
                         active, ranks, nslots_log2=lg, engine="planes",
                         max_rank=capacity, births=births,
                         birth_round=birth_round)
    total = torch.where(over, 0, total)
    new = DistQueueState(*out[0], tail=_wrap_add(state.tail, total),
                         head=state.head)
    res = (new, None, total, over)
    if with_counts:
        res = res + (torch.where(over, 0, counts),)
    if births is not None:
        res = res + (out[2],)
    return res


def dist_claim_round(state: DistQueueState, k, batch: int, shards: int, *,
                     engine: str = "planes", with_grid: bool = False,
                     births=None, mesh=None):
    """Claim ``k`` items (<= the occupancy) spread over ``shards`` shards
    by ``claim_schedule``, with no exchange: the tickets follow from the
    replicated head.  Returns (new_state, values (S, batch), ok (S,
    batch)), then with ``with_grid`` the flat grid ``(values (S *
    batch,), ok (S * batch,))``, then with ``births`` (CPU only) the
    consumed births (S, batch).  On a group-bound ``mesh`` (of ``shards``
    ranks) the values, ok and births are this rank's (batch,) row."""
    me = _rank(mesh)
    active, ranks = claim_schedule(k, shards, batch,
                                   device=state.cycles.device)
    tickets = _wrap_add(state.head, ranks)
    out = _apply_dequeue(_planes(state), tickets, active, ranks,
                         nslots_log2=_nslots_log2(state), engine=engine,
                         births=births)
    planes, vals, ok = out[0], out[1], out[2]
    k = torch.clamp(torch.as_tensor(k, device=state.cycles.device).long(),
                    max=shards * batch)
    new = DistQueueState(*planes, tail=state.tail,
                         head=_wrap_add(state.head, k))
    res = (new, _local(vals, shards, batch, me),
           _local(ok, shards, batch, me) > 0)
    if with_grid:
        res = res + ((vals, ok > 0),)
    if births is not None:
        res = res + (_local(out[3], shards, batch, me),)
    return res


# ---------------------------------------------------------------------------
# priority planes — the priority mesh's heaps and its one exchange
# ---------------------------------------------------------------------------


class DistHeapState(NamedTuple):
    """The priority mesh's heap planes, the chip heap's layout: one heap
    a shard, ``(S, cap)`` keys and vals with ``(S,)`` sizes (the relaxed
    mesh), or one heap, ``(cap,)`` planes and a 0-d size (the strict
    mesh).  ``KEY_INF`` marks empty slots, their vals are -1."""
    keys: torch.Tensor
    vals: torch.Tensor
    size: torch.Tensor

    @property
    def occupancy(self):
        return self.size


def dist_heap_init(capacity: int, *, shards: int = None,
                   device="cuda") -> DistHeapState:
    """Empty heap planes with capacity rounded up to a power of two, on
    ``device``: one heap, or ``shards`` heaps stacked."""
    cap = 1 << max(int(capacity) - 1, 1).bit_length()
    lead = () if shards is None else (shards,)
    i32 = dict(dtype=torch.int32, device=resolve_device(device))
    return DistHeapState(keys=torch.full(lead + (cap,), KEY_INF, **i32),
                         vals=torch.full(lead + (cap,), -1, **i32),
                         size=torch.zeros(lead, **i32))


def _priority_meta(local_hint, local_size, s, pop_meta, extra=()):
    """The meta block: (S, W) words on one card, or this rank's (W,) row
    (``s`` None)."""
    words = [local_hint, local_size, *extra]
    if pop_meta is not None:
        words += list(pop_meta)
    if s is None:
        return torch.stack([torch.as_tensor(w).to(torch.int32).reshape(())
                            for w in words])
    return torch.stack([torch.as_tensor(w).to(torch.int32).reshape(-1)
                        .expand(s) for w in words], 1)


def dist_priority_publish_round(ckeys, cvals, mask, local_hint, local_size,
                                pop_meta=None, aux=None, mesh=None):
    """The priority round's exchange (reference
    ``dist_priority_publish_round``): every shard's ``(S, W)`` child rows
    (keys, payloads and, in the split layout, ``aux``) under ``mask``,
    with each shard's post-pop ``local_hint`` and ``local_size`` ((S,),
    or one value every shard shares), gathered as the stacked rows.
    ``ranks`` are the exclusive prefix over the gathered mask,
    shard-major.  Returns ``(gkeys, gvals[, gaux], active, ranks, total,
    hints (S,), sizes (S,))`` with the g-planes flattened, and with
    ``pop_meta = (mins (S,), maxs (S,))`` (telemetry) ``(pop_mins,
    pop_maxs)`` last.  On a group-bound ``mesh`` the rows, hint, size and
    extrema are this rank's ((W,) rows, scalars)."""
    s = ckeys.shape[0] if _rank(mesh) is None else None
    mask_i = (mask > 0).to(torch.int32)
    blocks = (ckeys, cvals) + (() if aux is None else (aux,))
    g = mesh_round_gather(blocks + (mask_i, _priority_meta(
        local_hint, local_size, s, pop_meta)), mesh)
    gm, gmeta = g[-2].reshape(-1), g[-1]
    ranks = torch.cumsum(gm, 0, dtype=torch.int32) - gm
    out = tuple(b.reshape(-1) for b in g[:-2])
    out += (gm > 0, ranks, gm.sum(dtype=torch.int32), gmeta[:, 0],
            gmeta[:, 1])
    if pop_meta is not None:
        out += (gmeta[:, 2], gmeta[:, 3])
    return out


def dist_priority_publish_compact_round(ckeys, cvals, mask, local_hint,
                                        local_size, *, width: int,
                                        pop_meta=None, aux=None,
                                        scratch=None, mesh=None):
    """``dist_priority_publish_round`` under the dense-wave rule: each
    shard's child planes (keys, payloads[, aux]) compacted to ``width``
    lanes under the mask (``wave_compact``, B3 on the card, on
    ``scratch`` when given), the true counts beside the meta words and
    the ranks rebuilt from their exclusive prefix (``_compact_grid``), so
    the children and their ranks are the sparse round's.  Returns its
    layout (the g-planes ``(S * width,)``); on a group-bound ``mesh`` it
    takes this rank's rows and words."""
    one = _rank(mesh) is not None
    s = None if one else ckeys.shape[0]
    planes = (ckeys, cvals) + (() if aux is None else (aux,))
    if one:
        planes, mask = tuple(p[None] for p in planes), mask[None]
    dense, count = _compact_rows(planes, mask, width, scratch)
    if one:
        dense, count = tuple(d[0] for d in dense), count[0]
    g = mesh_round_gather(dense + (_priority_meta(
        local_hint, local_size, s, pop_meta, (count,)),), mesh)
    gmeta = g[-1]
    counts = gmeta[:, 2]
    active, ranks = _compact_grid(counts, width)
    out = tuple(b.reshape(-1) for b in g[:-1])
    out += (active, ranks.to(torch.int32), counts.sum(dtype=torch.int32),
            gmeta[:, 0], gmeta[:, 1])
    if pop_meta is not None:
        out += (gmeta[:, 3], gmeta[:, 4])
    return out


class DistShardedQueueState(NamedTuple):
    """Per-shard rings: (S, 2n_l) planes, one ring a row, and (S,) tail
    and head tickets."""
    cycles: torch.Tensor
    safes: torch.Tensor
    enqs: torch.Tensor
    idxs: torch.Tensor
    tails: torch.Tensor
    heads: torch.Tensor

    @property
    def occupancy(self):
        return _i32((self.tails.long() - self.heads.long()).sum())


def dist_sharded_queue_init(capacity: int, shards: int, *,
                            device="cuda", rank: int = None
                            ) -> DistShardedQueueState:
    """The global capacity rounded up to a power of two and split evenly
    over ``shards`` rings (a power of two no larger than it), each
    starting at head = tail = 2n_l.  With ``rank`` (a group-bound mesh)
    the planes are that shard's ring only, (1, 2n_l); heads and tails
    stay (S,)."""
    if shards < 1 or shards & (shards - 1):
        raise ValueError(f"shards {shards} must be a power of two")
    cap = 1 << max(int(capacity) - 1, 1).bit_length()
    if cap < shards:
        raise ValueError(f"capacity {cap} smaller than {shards} shards")
    n2 = 2 * (cap // shards)
    i32 = dict(dtype=torch.int32, device=resolve_device(device))
    rows = shards if rank is None else 1
    return DistShardedQueueState(
        cycles=torch.zeros((rows, n2), **i32),
        safes=torch.ones((rows, n2), **i32),
        enqs=torch.zeros((rows, n2), **i32),
        idxs=torch.full((rows, n2), IDX_BOT, **i32),
        tails=torch.full((shards,), n2, **i32),
        heads=torch.full((shards,), n2, **i32))


def dist_sharded_claim_round(planes, heads, tails, batch: int, *,
                             nslots_log2: int, mesh=None):
    """Claim up to ``S * batch`` items from the per-shard rings: the
    counts are ``priority_claim_schedule`` over the occupancies, fullest
    first, and shard i dequeues ``heads[i] + [0, counts[i])`` from its
    own ring.  Returns (planes, heads, vals (S, batch), ok (S, batch),
    counts (S,)).  On a group-bound ``mesh`` the planes are this rank's
    ring ((2n_l,) each) and vals and ok its (batch,) row, with no
    exchange."""
    n = heads.shape[0]
    occs = _i32(tails.long() - heads.long())
    k = torch.clamp(_i32(occs.long().sum()), max=n * batch)
    counts = priority_claim_schedule(k, n, batch, -occs, occs)
    lane = torch.arange(batch, dtype=torch.int64, device=heads.device)
    rows, vals, oks = [], [], []
    mine = range(n) if _rank(mesh) is None else (mesh.rank,)
    for me in mine:
        active = lane < counts[me]
        tickets = torch.where(active, _wrap_add(heads[me], lane), 0)
        pl, v, ok = _apply_dequeue(
            planes if _rank(mesh) is not None
            else tuple(p[me] for p in planes), tickets,
            active, lane, nslots_log2=nslots_log2, engine="planes")
        rows.append(pl)
        vals.append(v)
        oks.append(ok > 0)
    if _rank(mesh) is not None:
        return (rows[0], _wrap_add(heads, counts), vals[0], oks[0], counts)
    planes = tuple(torch.stack(r) for r in zip(*rows))
    return (planes, _wrap_add(heads, counts), torch.stack(vals),
            torch.stack(oks), counts)


def dist_sharded_publish_round(planes, heads, tails, values, mask, *,
                               nslots_log2: int, local_capacity: int,
                               width: int = None, pop_meta=None, mesh=None):
    """The sharded rings' publish: the (S, N) child rows (or their dense
    ``width``-lane compactions with true counts) ranked shard-major, the
    child of rank r sprayed to ring ``r % S`` at ``tails[r % S] + r //
    S``.  When any ring would pass ``local_capacity`` nothing installs
    anywhere and ``over`` holds.  ``pop_meta`` = (mins (S,), maxs (S,)),
    each shard's claim extrema, rides the exchange and is returned
    last.  Returns (planes, tails, total, over, assigned (S,)[, mins,
    maxs]).  On a group-bound ``mesh`` the planes are this rank's ring
    ((2n_l,) each), ``values``/``mask`` its (N,) row and ``pop_meta`` its
    two words, all in the one exchange."""
    n = heads.shape[0]
    me = _rank(mesh)
    meta = ()
    if me is not None and pop_meta is not None:
        meta = (torch.stack([torch.as_tensor(w).to(torch.int32).reshape(())
                             for w in pop_meta]),)
    if width is None:
        if me is None:
            gv, active, ranks, total = _gathered_round(values, mask)
        else:
            g = mesh_round_gather((values, (mask > 0).to(torch.int32))
                                  + meta, mesh)
            gv, gm = g[0].reshape(-1), g[1].reshape(-1).long()
            ranks = torch.cumsum(gm, 0) - gm
            active, total = gm > 0, _i32(gm.sum())
    else:
        rows = (values, mask) if me is None else (values[None], mask[None])
        dv, count = _compact_rows(*rows, width)
        g = mesh_round_gather(
            (dv, count.reshape(-1, 1)) if me is None
            else (dv[0], count) + meta, mesh)
        gv, gmeta = g[0].reshape(-1), g[1]
        total = _i32(gmeta[:, 0].long().sum())
        active, ranks = _compact_grid(gmeta[:, 0], width)
    s_ix = torch.arange(n, dtype=torch.int64, device=heads.device)
    total_l = total.long()
    assigned = total_l // n + (s_ix < total_l % n).long()
    over = (_i32(tails.long() - heads.long()).long() + assigned
            > local_capacity).any()
    rows = []
    for r in (range(n) if me is None else (me,)):
        mine = active & (ranks % n == r) & ~over
        lrank = torch.where(mine, ranks // n, 0)
        tickets = torch.where(mine, _wrap_add(tails[r], lrank), 0)
        pl, _ = _apply_enqueue(planes if me is not None
                               else tuple(p[r] for p in planes), heads[r],
                               tickets, gv, mine, lrank,
                               nslots_log2=nslots_log2, engine="planes",
                               max_rank=local_capacity)
        rows.append(pl)
    planes = (rows[0] if me is not None
              else tuple(torch.stack(r) for r in zip(*rows)))
    assigned = torch.where(over, 0, assigned).to(torch.int32)
    res = (planes, _wrap_add(tails, assigned), torch.where(over, 0, total),
           over, assigned)
    if pop_meta is not None and me is not None:
        gmeta = g[-1].reshape(n, -1)
        return res + (gmeta[:, -2], gmeta[:, -1])
    if pop_meta is not None:
        res = res + (torch.as_tensor(pop_meta[0]).to(torch.int32),
                     torch.as_tensor(pop_meta[1]).to(torch.int32))
    return res
