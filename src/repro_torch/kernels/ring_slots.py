"""Batched bounded-ring slot operations (paper Alg. 1 fast path) — the
PyTorch twin of ``repro/kernels/ring_slots.py``.

The ring's packed entry word is four parallel int32 planes of 2n slots
(cycle / safe / enq / idx).  Exact tickets within a wave hit pairwise
distinct slots (any wave spans < 2n tickets, Lemma III.1), so a wave
needs no serial order: gather each lane's slot, test, and write back the
lanes that succeed.

Three faces of one wave:

* ``ring_enqueue`` / ``ring_dequeue`` — the wrappers.  A CPU tensor goes
  to the plain version; a CUDA tensor launches the hand-written kernel
  in ``csrc/ring_slots.cu`` or raises.  There is no fallback.  A lane is
  live where its ticket is >= 0, or where an explicit ``active`` mask
  says so (the kernels' masked instance, whatever the ticket's sign).
* ``ring_enqueue_plain`` / ``ring_dequeue_plain`` — plain PyTorch with the
  kernels' contract, the CPU path and the kernels' oracle on the card.
* ``enq_planes`` / ``deq_planes`` — functional forms (new planes, ``ok``
  as int32, optional ``active`` mask) matching the reference's names: the
  plain version on copies for a CPU tensor, the masked kernel on copies
  for a CUDA tensor.

A round's queue side comes as two more wrappers, each one launch on the
card, each beside its plain version (``*_plain``, the round's
elementwise chain built on the plain faces above), over an S-shard lane
grid: the mesh's round (``runtime.meshrounds``) on one replicated ring
or on S rings, one a row, and the single ring's (``RingEngine``) at S =
1:

* ``ring_dequeue_wave`` — the claim ``k = live ? min(occupancy, S *
  batch) : 0``, split over the shards (the reference's
  ``claim_schedule``, or ``priority_claim_schedule`` on S rings), the
  claimed tickets consumed, ``head += k`` in place.
* ``ring_enqueue_wave`` — the children's tickets from the spawn-mask
  ballot over the shards' rows (or from the rows compacted by
  ``wave_compact`` and their counts), the overflow test for the whole
  round, the installs unless it overflows, and ``tail`` advanced in
  place.

They take each lane's activity from that arithmetic (the claim's
split, the ballot bit), not from the ticket's sign, so tickets past
2^31 move like any other; below 2^31, where every run of the round
engine stays, they give what the reference round's -1-sentinel tickets
give.

Both the kernels and the plain versions update the planes IN PLACE and
return them.  The Pallas kernel copies all four (2n,) planes per wave; in
place a wave costs O(B) instead of O(2n) — on a 2^24-slot ring that is
about 256 MB of traffic per wave avoided.

Tickets are unsigned mod-2^32 counters carried in int32.  PyTorch's int32
``>>`` is arithmetic and int32 ``<<`` overflow is not defined behaviour to
rely on, so the plain versions compute in int64 with explicit 32-bit
masks.

Birth stamps (the span layer, ``obs.spans``) come in the reference's two
layouts.  Packed: an install writes ``(birth_round << 1) | 1`` into the
enq-flag plane instead of 1, a consume tests the low bit and returns the
stamp ``enq >> 1``; seeds installed unpacked carry flag 1, birth 0, and
``enqs & 1`` gives back the unpacked plane.  The stamp keeps the flag
word positive only below ``SPAN_ROUND_CAP`` = 2^30 (``enq_planes``
refuses a round past it; the engine core stops a spanned run before
it).  Separate: a (2n,) ``births`` plane beside the four, written and
read at the same slots.  The round's wave kernels carry the packed
layout on the replicated ring (``ring_enqueue_wave(birth_round=)``,
``ring_dequeue_wave(birth_packed=True)``, instances of their own in
``csrc/ring_slots.cu``); the functional faces carry both.
"""

from __future__ import annotations

import torch

from . import _build
from .wavefaa import _i32, wavefaa_plain

_U32 = 0xFFFFFFFF
_SIGN = 1 << 31

#: Round-clock ceiling of the packed birth stamp ``(birth << 1) | 1``: a
#: round of 2^30 or more would reach the flag word's sign bit
SPAN_ROUND_CAP = 1 << 30


def ticket_cycle(tickets: torch.Tensor, nslots_log2: int) -> torch.Tensor:
    """A ticket's ring cycle: the LOGICAL right shift of the unsigned
    32-bit ticket, as int32."""
    c = (tickets.long() & _U32) >> nslots_log2
    return (((c + _SIGN) & _U32) - _SIGN).int()


def cycle_lt(a: torch.Tensor, b: torch.Tensor,
             nslots_log2: int) -> torch.Tensor:
    """Wrap-safe cycle comparison a < b: the int32 value of
    ``(b - a) << nslots_log2`` is positive (reference ``cycle_lt``)."""
    d = ((b.long() - a.long()) << nslots_log2) & _U32
    return (d > 0) & (d < _SIGN)


def _ticket_ge(t: torch.Tensor, head) -> torch.Tensor:
    """int32 ``(t - head) >= 0`` with wraparound."""
    return (((t.long() - head.long()) & _U32) < _SIGN)


def _slots(tickets, nslots_log2, active):
    if active is None:
        active = tickets >= 0
    j = torch.where(active, tickets.long() & ((1 << nslots_log2) - 1), 0)
    c = torch.where(active, ticket_cycle(tickets, nslots_log2), 0)
    return active, j, c


def _packed_flag(birth_round, device) -> torch.Tensor:
    """``(birth_round << 1) | 1`` as int32, computed in int64."""
    r = torch.as_tensor(birth_round, device=device).long().reshape(())
    return _i32(((r << 1) | 1) & _U32)


def ring_enqueue_plain(cycles, safes, enqs, idxs, tickets, values, head, *,
                       nslots_log2: int, idx_bot: int, active=None,
                       births=None, birth_round=None):
    """One TRYENQ wave in plain PyTorch, in place: a lane installs its
    value where the slot's cycle is behind the ticket's, the slot is
    empty, and the slot is safe or ``head <= ticket``.  ``active``
    defaults to ``tickets >= 0``.  Returns (cycles, safes, enqs, idxs,
    ok (B,) bool).

    Birth stamps: with a ``births`` plane an install also writes
    ``birth_round`` there (and the tuple ends with ``births``); with
    ``birth_round`` alone the flag written is the packed
    ``(birth_round << 1) | 1``."""
    active, j, c = _slots(tickets, nslots_log2, active)
    head = torch.as_tensor(head, dtype=torch.int32,
                           device=tickets.device).reshape(-1)[0]
    e_c, e_s, e_i = cycles[j], safes[j], idxs[j]
    empty = (e_i == idx_bot) | (e_i == idx_bot - 1)
    can = (active & cycle_lt(e_c, c, nslots_log2) & empty
           & ((e_s == 1) | _ticket_ge(tickets, head)))
    w = j[can]
    cycles[w] = c[can]
    safes[w] = 1
    packed = births is None and birth_round is not None
    enqs[w] = _packed_flag(birth_round, enqs.device) if packed else 1
    idxs[w] = values.to(torch.int32)[can]
    if births is None:
        return cycles, safes, enqs, idxs, can
    births[w] = torch.as_tensor(birth_round, device=births.device).to(
        torch.int32)
    return cycles, safes, enqs, idxs, can, births


def ring_dequeue_plain(cycles, safes, enqs, idxs, tickets, *,
                       nslots_log2: int, idx_bot: int, active=None,
                       births=None, birth_packed: bool = False):
    """One TRYDEQ wave in plain PyTorch, in place: consume on a cycle
    match, advance stale empty slots to the ticket's cycle, mark stale
    live slots unsafe.  Returns (cycles, safes, enqs, idxs, vals (B,)
    int32 with -1 on a miss, ok (B,) bool).

    Birth stamps: ``birth_packed`` tests the flag's low bit and reads the
    stamp from its high bits, ``births`` reads it from that plane; either
    appends the consumed lanes' births ((B,) int32, -1 on a miss)."""
    active, j, c = _slots(tickets, nslots_log2, active)
    e_c, e_e, e_i = cycles[j], enqs[j], idxs[j]
    empty = (e_i == idx_bot) | (e_i == idx_bot - 1)
    flag = (e_e & 1) if birth_packed else e_e
    hit = active & (e_c == c) & ~empty & (flag == 1)
    behind = active & ~hit & cycle_lt(e_c, c, nslots_log2)
    adv, uns = behind & empty, behind & ~empty
    idxs[j[hit]] = idx_bot - 1
    cycles[j[adv]] = c[adv]
    safes[j[uns]] = 0
    vals = torch.where(hit, e_i, -1)
    if birth_packed:
        return cycles, safes, enqs, idxs, vals, hit, torch.where(
            hit, e_e >> 1, -1)
    if births is None:
        return cycles, safes, enqs, idxs, vals, hit
    return cycles, safes, enqs, idxs, vals, hit, torch.where(
        hit, births[j], -1)


def enq_planes(cycles, safes, enqs, idxs, tickets, values, head, *,
               nslots_log2: int, idx_bot: int, active=None, births=None,
               birth_round=None):
    """Functional TRYENQ wave (reference ``enq_planes``): new planes,
    ``ok`` as int32, and with ``births`` the new births plane last.
    ``active`` (B,) marks the live lanes whatever their tickets' sign
    (default: ``tickets >= 0``).  A CPU tensor runs the plain version on
    copies; a CUDA tensor copies the planes and launches ``ring_enqueue``
    (the masked instance with ``active``), or raises: birth stamps
    (``births``, ``birth_round``) are the plain version's only, the
    round's wave kernels carry packed stamps on the card.  A packed
    ``birth_round`` (no ``births``) given as an int or a CPU tensor must
    lie below ``SPAN_ROUND_CAP``."""
    if births is None and birth_round is not None:
        concrete = (not isinstance(birth_round, torch.Tensor)
                    or birth_round.device.type == "cpu")
        if concrete and int(birth_round) >= SPAN_ROUND_CAP:
            raise ValueError(
                f"birth_round {int(birth_round)} exceeds the packed "
                f"birth-stamp cap SPAN_ROUND_CAP={SPAN_ROUND_CAP}: the "
                f"(birth << 1) | 1 layout caps the round clock at 2^30 "
                f"(use the separate births plane for longer clocks)")
    planes = [p.clone() for p in (cycles, safes, enqs, idxs)]
    if tickets.device.type != "cpu":
        if births is not None or birth_round is not None:
            raise ValueError("enq_planes: birth stamps (births=, "
                             "birth_round=) run on the CPU only; on the "
                             "card the round's wave kernels carry packed "
                             "stamps")
        out = ring_enqueue(*planes, tickets, values, head,
                           nslots_log2=nslots_log2, idx_bot=idx_bot,
                           active=active)
        return (*out[:4], out[4].int())
    if births is not None:
        births = births.clone()
    out = ring_enqueue_plain(*planes, tickets, values, head,
                             nslots_log2=nslots_log2, idx_bot=idx_bot,
                             active=active, births=births,
                             birth_round=birth_round)
    return (*out[:4], out[4].int(), *out[5:])


def deq_planes(cycles, safes, enqs, idxs, tickets, *, nslots_log2: int,
               idx_bot: int, active=None, births=None,
               birth_packed: bool = False):
    """Functional TRYDEQ wave (reference ``deq_planes``): new planes,
    values, ``ok`` as int32, and with ``births`` or ``birth_packed`` the
    consumed lanes' births last.  ``active`` as in ``enq_planes``.  A CUDA
    tensor copies the planes and launches ``ring_dequeue`` (the masked
    instance with ``active``), or raises for birth stamps (the plain
    version's only)."""
    planes = [p.clone() for p in (cycles, safes, enqs, idxs)]
    if tickets.device.type != "cpu":
        if births is not None or birth_packed:
            raise ValueError("deq_planes: birth stamps (births=, "
                             "birth_packed=) run on the CPU only; on the "
                             "card the round's wave kernels carry packed "
                             "stamps")
        out = ring_dequeue(*planes, tickets, nslots_log2=nslots_log2,
                           idx_bot=idx_bot, active=active)
        return (*out[:5], out[5].int())
    out = ring_dequeue_plain(*planes, tickets, nslots_log2=nslots_log2,
                             idx_bot=idx_bot, active=active, births=births,
                             birth_packed=birth_packed)
    return (*out[:5], out[5].int(), *out[6:])


def ring_enqueue(cycles, safes, enqs, idxs, tickets, values, head, *,
                 nslots_log2: int, idx_bot: int, active=None):
    """Apply a wave of TRYENQ installs in place.  Planes are (2n,) int32,
    ``tickets``/``values`` (B,) int32, ``head`` a scalar.  A lane is live
    where ``active`` (B,) bool holds, or, without it, where its ticket is
    >= 0 (ticket -1 = inactive).  ``active`` takes the kernel's masked
    instance, counted as ``ring_enqueue_masked``.  Returns (cycles, safes,
    enqs, idxs, ok (B,) bool)."""
    if tickets.device.type == "cpu":
        return ring_enqueue_plain(cycles, safes, enqs, idxs, tickets, values,
                                  head, nslots_log2=nslots_log2,
                                  idx_bot=idx_bot, active=active)
    head = torch.as_tensor(head, dtype=torch.int32,
                           device=tickets.device).reshape(1)
    _check_wave("ring_enqueue", (cycles, safes, enqs, idxs), nslots_log2,
                tickets, values, head)
    act = _check_active("ring_enqueue", active, tickets)
    b = tickets.shape[0]
    ok = torch.empty(b, dtype=torch.bool, device=tickets.device)
    name = "ring_enqueue" if active is None else "ring_enqueue_masked"
    if b:
        lib = _build.library("ring_slots")
        _build.check(lib.repro_ring_enqueue(
            cycles.data_ptr(), safes.data_ptr(), enqs.data_ptr(),
            idxs.data_ptr(), tickets.data_ptr(), act, values.data_ptr(),
            head.data_ptr(), ok.data_ptr(), b, nslots_log2, idx_bot,
            _build.stream_of(tickets)), name)
        _build.LAUNCHES[name] += 1
    return cycles, safes, enqs, idxs, ok


def ring_dequeue(cycles, safes, enqs, idxs, tickets, *, nslots_log2: int,
                 idx_bot: int, active=None):
    """Apply a wave of TRYDEQ consumes in place; lanes live as in
    ``ring_enqueue`` (``active`` counted as ``ring_dequeue_masked``).
    Returns (cycles, safes, enqs, idxs, values (B,) int32, ok (B,)
    bool)."""
    if tickets.device.type == "cpu":
        return ring_dequeue_plain(cycles, safes, enqs, idxs, tickets,
                                  nslots_log2=nslots_log2, idx_bot=idx_bot,
                                  active=active)
    _check_wave("ring_dequeue", (cycles, safes, enqs, idxs), nslots_log2,
                tickets)
    act = _check_active("ring_dequeue", active, tickets)
    b = tickets.shape[0]
    vals = torch.empty(b, dtype=torch.int32, device=tickets.device)
    ok = torch.empty(b, dtype=torch.bool, device=tickets.device)
    name = "ring_dequeue" if active is None else "ring_dequeue_masked"
    if b:
        lib = _build.library("ring_slots")
        _build.check(lib.repro_ring_dequeue(
            cycles.data_ptr(), safes.data_ptr(), enqs.data_ptr(),
            idxs.data_ptr(), tickets.data_ptr(), act, vals.data_ptr(),
            ok.data_ptr(), b, nslots_log2, idx_bot,
            _build.stream_of(tickets)), name)
        _build.LAUNCHES[name] += 1
    return cycles, safes, enqs, idxs, vals, ok


def _check_active(name, active, tickets) -> int:
    """The masked instance's ``active``: a contiguous (B,) bool beside the
    tickets (its pointer), or 0 for the sign rule."""
    if active is None:
        return 0
    if (active.dtype != torch.bool or active.shape != tickets.shape
            or not active.is_contiguous()
            or active.device != tickets.device):
        raise ValueError(f"{name}: active must be a contiguous (B,) bool "
                         f"on the tickets' card")
    return active.data_ptr()


# ---------------------------------------------------------------------------
# a round's waves over an S-shard lane grid
# ---------------------------------------------------------------------------
#
# The reference's mesh (``repro/core/distqueue.py``) runs one shard per
# device.  Here the shard axis is the leading dimension of the lanes: a
# dequeue wave is an (S, batch) grid, an enqueue wave an (S, n) grid of
# children.  The ring is either replicated (planes (2n,), 0-d head and
# tail) or sharded (planes (S, 2n_l), one ring a row, (S,) heads and
# tails); the layout follows from the planes' shape.  The single ring's
# round (``RingEngine``) is the replicated grid at S = 1.  ``ring=r``
# (the sharded mesh across processes, one ring a rank) gives the sharded
# waves ring r alone, as planes (1, 2n_l) beside all S heads and tails:
# the schedule, ranks and overflow test are the whole mesh's, the
# consumes and installs ring r's, and heads and tails advance for all.


def claim_schedule(k, n: int, batch: int, *, device=None):
    """Split a claim budget ``k`` evenly over ``n`` shards, the remainder
    to the lowest indices, each shard at most ``batch`` (reference
    ``claim_schedule``; the replicated dequeue wave's split).  Runs on
    ``k``'s device when ``k`` is a tensor, else on ``device`` ("cuda" by
    default: it raises without a card unless the caller asks for "cpu").
    Returns (active (n * batch,) bool, ranks (n * batch,) int64) over the
    grid, shard-major."""
    if device is not None or not isinstance(k, torch.Tensor):
        device = _build.resolve_device("cuda" if device is None else device)
    else:
        device = k.device
    k = torch.clamp(torch.as_tensor(k, device=device).long(), max=n * batch)
    share, rem = k // n, k % n
    i = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    lane = torch.arange(batch, dtype=torch.int64, device=device)[None, :]
    active = lane < share + (i < rem).long()
    ranks = i * share + torch.minimum(i, rem) + lane
    return active.reshape(-1), torch.where(active, ranks, 0).reshape(-1)


def priority_claim_schedule(k, n: int, batch: int, hints, sizes, *,
                            device=None):
    """The hint-ordered claim schedule (reference
    ``priority_claim_schedule``; the sharded dequeue wave's schedule with
    hints = -occupancy): ``k`` (clamped to the sizes' sum and to ``n *
    batch``) split evenly, the remainder to the lowest ``hints`` (ties by
    index), each share clamped to its shard's size and to ``batch``.  Runs
    on ``sizes``' device when it is a tensor, else on ``device`` ("cuda"
    by default, as ``claim_schedule``).  Returns (n,) int32 counts."""
    if device is not None or not isinstance(sizes, torch.Tensor):
        device = _build.resolve_device("cuda" if device is None else device)
    else:
        device = sizes.device
    sizes = torch.as_tensor(sizes, device=device).to(torch.int32)
    hints = torch.as_tensor(hints, device=device).to(torch.int32)
    k = torch.as_tensor(k, device=device).to(torch.int32).reshape(())
    k = torch.minimum(k, torch.clamp(_i32(sizes.long().sum()),
                                     max=n * batch))
    share, rem = k // n, k % n
    order = torch.argsort(hints, stable=True)
    pos = torch.argsort(order, stable=True)
    budget = share + (pos < rem).int()
    return torch.minimum(budget, torch.clamp(sizes, max=batch)).int()


#: most shards a wave takes (``kMaxShards`` in ``csrc/ring_slots.cu``)
MAX_SHARDS = 1024


def _layout(name, planes, nslots_log2, heads, tails, shards, ring=None):
    """(sharded, S) of a wave's ring: sharded planes are (S, 2^s) with
    (S,) heads and tails, a replicated ring's (2^s,) with 0-d ones and S
    given (1, the single ring, when it is not).  With ``ring`` the planes
    are that one ring of S, (1, 2^s), and S is the heads' length."""
    sharded = planes[0].dim() == 2
    if ring is not None:
        s = heads.shape[0] if heads.dim() == 1 else 0
        if not sharded or not 0 <= ring < s:
            raise ValueError(f"{name}: ring={ring} takes (1, 2^s) planes "
                             f"and (S,) heads and tails with 0 <= ring < "
                             f"S")
        if shards is not None and shards != s:
            raise ValueError(f"{name}: shards={shards} but the heads hold "
                             f"{s} rings")
        shards = s
        want, ticket_shape = (1, 1 << nslots_log2), (s,)
    elif sharded:
        s = planes[0].shape[0]
        if shards is not None and shards != s:
            raise ValueError(f"{name}: shards={shards} but the planes hold "
                             f"{s} rings")
        shards = s
        want, ticket_shape = (s, 1 << nslots_log2), (s,)
    else:
        shards = 1 if shards is None else shards
        want, ticket_shape = (1 << nslots_log2,), ()
    if not 1 <= shards <= MAX_SHARDS:
        raise ValueError(f"{name}: shards={shards} out of range [1, "
                         f"{MAX_SHARDS}]")
    if not 0 < nslots_log2 < 32:
        raise ValueError(f"{name}: nslots_log2={nslots_log2} out of range")
    for p in planes:
        if tuple(p.shape) != want:
            raise ValueError(f"{name}: planes must be {want}, got "
                             f"{tuple(p.shape)}")
    if (tuple(heads.shape) != ticket_shape
            or tuple(tails.shape) != ticket_shape):
        raise ValueError(f"{name}: heads and tails must be {ticket_shape}")
    return sharded, shards


def ring_dequeue_wave_plain(cycles, safes, enqs, idxs, heads, tails, live,
                            *, batch: int, nslots_log2: int, idx_bot: int,
                            shards: int = None, birth_packed: bool = False,
                            ring: int = None):
    """Plain PyTorch ``ring_dequeue_wave`` on ``ring_dequeue_plain``, in
    place (see the kernel face)."""
    sharded, shards = _layout("ring_dequeue_wave",
                              (cycles, safes, enqs, idxs), nslots_log2,
                              heads, tails, shards, ring)
    dev = heads.device
    lane = torch.arange(batch, dtype=torch.int64, device=dev)[None, :]
    planes = (cycles, safes, enqs, idxs)
    kw = dict(nslots_log2=nslots_log2, idx_bot=idx_bot,
              birth_packed=birth_packed)
    if not sharded:
        occ = _i32(tails.long() - heads.long())
        k = torch.where(live, torch.clamp(occ, max=shards * batch), 0)
        active, ranks = claim_schedule(k, shards, batch)
        out = ring_dequeue_plain(*planes, _i32(heads.long() + ranks),
                                 active=active, **kw)
        heads.copy_(_i32(heads.long() + k))
        pops = active.reshape(shards, batch).sum(1, dtype=torch.int32)
        res = [out[4], out[5]] + list(out[6:])
    else:
        occ = _i32(tails.long() - heads.long())
        k = torch.where(live, torch.clamp(_i32(occ.long().sum()),
                                          max=shards * batch), 0)
        pops = priority_claim_schedule(k, shards, batch, -occ, occ)
        active = lane < pops[:, None].long()
        tickets = _i32(heads.long()[:, None] + lane)
        res = [[] for _ in range(3 if birth_packed else 2)]
        for r in range(shards) if ring is None else (ring,):
            row = r if ring is None else 0
            out = ring_dequeue_plain(*(p[row] for p in planes), tickets[r],
                                     active=active[r], **kw)
            for acc, x in zip(res, out[4:]):
                acc.append(x)
        res = [torch.cat(x) for x in res]
        heads.copy_(_i32(heads.long() + pops))
        k = pops.sum(dtype=torch.int32)
    res = [x.reshape(-1, batch) for x in res]
    return (res[0], res[1], k.to(torch.int32).reshape(()), pops, *res[2:])


def ring_dequeue_wave(cycles, safes, enqs, idxs, heads, tails, live, *,
                      batch: int, nslots_log2: int, idx_bot: int,
                      shards: int = None, birth_packed: bool = False,
                      ring: int = None):
    """A round's dequeue side over an S x ``batch`` lane grid in one
    launch (``RingEngine``'s round at S = 1; reference
    ``dist_claim_round`` / ``dist_sharded_claim_round``).

    Replicated ring (planes (2n,), ``heads``/``tails`` 0-d, ``shards``
    given or 1): ``k = live ? min(tail - head, S * batch) : 0`` split by
    ``claim_schedule``, shard i's lanes consuming tickets ``head + i *
    share + min(i, rem) + [0, share + (i < rem))``; ``head += k``.
    Sharded rings (planes (S, 2n_l), ``heads``/``tails`` (S,)): the
    counts of ``priority_claim_schedule`` over the occupancies (fullest
    first), shard i consuming ``heads[i] + [0, counts[i])`` from its own
    ring; ``heads += counts``.  The planes and heads are updated in place.
    Returns (vals (S, batch) int32 with -1 on a miss, ok (S, batch) bool,
    k 0-d int32, pops (S,) int32), and with ``birth_packed`` (replicated
    only: the packed instance, which takes the enq flag's low bit as the
    flag) the consumed stamps ``enq >> 1`` (S, batch) last, -1 on a
    miss.  ``ring=r`` (sharded only): the planes are ring r's (1, 2n_l),
    the schedule, k and pops the whole mesh's, vals and ok ring r's (1,
    batch), and every head advances."""
    if heads.device.type == "cpu":
        return ring_dequeue_wave_plain(cycles, safes, enqs, idxs, heads,
                                       tails, live, batch=batch,
                                       nslots_log2=nslots_log2,
                                       idx_bot=idx_bot, shards=shards,
                                       birth_packed=birth_packed, ring=ring)
    planes = (cycles, safes, enqs, idxs)
    sharded, shards = _layout("ring_dequeue_wave", planes, nslots_log2,
                              heads, tails, shards, ring)
    _check_round("ring_dequeue_wave", planes, heads, tails, live)
    if batch < 0 or shards * batch >= 1 << 31:
        raise ValueError(f"ring_dequeue_wave: batch={batch} out of range")
    if sharded and birth_packed:
        raise ValueError("ring_dequeue_wave: the sharded rings keep no "
                         "birth stamps (spans need the replicated ring)")
    dev = heads.device
    rows = shards if ring is None else 1
    vals = torch.empty((rows, batch), dtype=torch.int32, device=dev)
    ok = torch.empty((rows, batch), dtype=torch.bool, device=dev)
    pops = torch.empty(shards, dtype=torch.int32, device=dev)
    k = torch.empty((), dtype=torch.int32, device=dev)
    births = (torch.empty((shards, batch), dtype=torch.int32, device=dev)
              if birth_packed else None)
    name = ("ring_dequeue_wave_sharded" if sharded else
            "ring_dequeue_wave_packed" if birth_packed
            else "ring_dequeue_wave")
    lib = _build.library("ring_slots")
    _build.check(lib.repro_ring_dequeue_wave(
        *(p.data_ptr() for p in planes), heads.data_ptr(), tails.data_ptr(),
        live.data_ptr(), vals.data_ptr(), ok.data_ptr(), pops.data_ptr(),
        k.data_ptr(), births.data_ptr() if birth_packed else 0, shards,
        batch, int(sharded), nslots_log2, idx_bot,
        -1 if ring is None else ring, _build.stream_of(heads)), name)
    _build.LAUNCHES[name] += 1
    out = (vals, ok, k, pops)
    return out if births is None else out + (births,)


def _enqueue_ranks(values, live, shards, mask, counts):
    """The grid's children in rank order: (active, ranks) over the lanes
    of ``values``, the children's total and each shard's count."""
    dev = values.device
    if mask is not None:
        m = (mask & live).long()
        ranks = torch.cumsum(m, 0) - m
        per = m.reshape(shards, -1).sum(1)
        return m > 0, ranks, m.sum(), per
    n = values.shape[1]
    c = torch.where(live, counts.long(), 0)
    base = torch.cumsum(c, 0) - c
    lane = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    active = lane < c[:, None]
    return (active.reshape(-1), (base[:, None] + lane).reshape(-1), c.sum(),
            c)


def ring_enqueue_wave_plain(cycles, safes, enqs, idxs, heads, tails, values,
                            live, *, capacity: int, nslots_log2: int,
                            idx_bot: int, shards: int = None, mask=None,
                            counts=None, birth_round=None, ring: int = None):
    """Plain PyTorch ``ring_enqueue_wave`` on ``ring_enqueue_plain``, in
    place (see the kernel face)."""
    sharded, shards = _layout("ring_enqueue_wave",
                              (cycles, safes, enqs, idxs), nslots_log2,
                              heads, tails, shards, ring)
    _wave_mode("ring_enqueue_wave", values, shards, mask, counts)
    planes = (cycles, safes, enqs, idxs)
    active, ranks, total, per = _enqueue_ranks(values, live, shards, mask,
                                               counts)
    vals = values.reshape(-1)
    kw = dict(nslots_log2=nslots_log2, idx_bot=idx_bot,
              birth_round=birth_round)
    if not sharded:
        over = _i32(tails.long() + total - heads.long()) > capacity
        ring_enqueue_plain(*planes, _i32(tails.long() + ranks), vals, heads,
                           active=active & ~over, **kw)
        tails.copy_(torch.where(over, tails, _i32(tails.long() + total)))
        pushes = torch.where(over, 0, per).int()
    else:
        s_ix = torch.arange(shards, dtype=torch.int64, device=heads.device)
        assigned = total // shards + (s_ix < total % shards).long()
        over = (_i32(tails.long() - heads.long()).long() + assigned
                > capacity).any()
        dest = ranks % shards
        tickets = _i32(tails.long()[dest] + ranks // shards)
        for r in range(shards) if ring is None else (ring,):
            row = r if ring is None else 0
            ring_enqueue_plain(*(p[row] for p in planes), tickets, vals,
                               heads[r], active=active & (dest == r) & ~over,
                               **kw)
        tails.copy_(torch.where(over, tails,
                                _i32(tails.long() + assigned)))
        pushes = torch.where(over, 0, assigned).int()
    total = torch.where(over, 0, total).to(torch.int32).reshape(())
    return total, over.reshape(()), pushes


def ring_enqueue_wave(cycles, safes, enqs, idxs, heads, tails, values, live,
                      *, capacity: int, nslots_log2: int, idx_bot: int,
                      shards: int = None, mask=None, counts=None,
                      birth_round=None, ring: int = None):
    """A round's enqueue side over an S-shard child grid in one launch
    (``RingEngine``'s round at S = 1; reference ``dist_publish_round``,
    ``dist_publish_compact_round``, ``dist_sharded_publish_round``).

    Ballot mode: ``values`` and ``mask`` (S * n,) (the shards' child rows
    back to back); the children are the set lanes of ``mask & live``,
    ranked in lane order.  Dense mode: ``values`` (S, n), each row a
    shard's children compacted by ``wave_compact``, and ``counts`` (S,)
    int32 their true popcounts; the children are lanes ``j < counts[i]``
    when ``live``, ranked ``exclusive_prefix(counts)[i] + j``.

    Replicated ring: ``over = tail + total - head > capacity`` (int32,
    wrapping); unless it holds, child r installs at ticket ``tail + r``
    and ``tail += total``; pushes[i] = shard i's children.  Sharded rings
    (``capacity`` one ring's): ``assigned[i] = total // S + (i < total %
    S)``, ``over`` when any ring's ``tails - heads + assigned`` exceeds
    it; unless it holds, child r installs on ring ``r % S`` at
    ``tails[r % S] + r // S`` and ``tails += assigned``; pushes =
    assigned.  On overflow nothing installs.  ``birth_round`` (a 0-d
    int32 on the ring's card, read there; replicated only) takes the
    packed instance, whose flag written is ``(birth_round << 1) | 1``.
    The planes and tails are updated in place.  Returns (total 0-d int32,
    0 when over; over 0-d bool; pushes (S,) int32, 0 when over).
    ``ring=r`` (sharded only): the planes are ring r's (1, 2n_l), the
    children every shard's, and only those of rank r mod S install; the
    totals, the overflow test and the tails are the whole mesh's."""
    if heads.device.type == "cpu":
        return ring_enqueue_wave_plain(cycles, safes, enqs, idxs, heads,
                                       tails, values, live, capacity=capacity,
                                       nslots_log2=nslots_log2,
                                       idx_bot=idx_bot, shards=shards,
                                       mask=mask, counts=counts,
                                       birth_round=birth_round, ring=ring)
    planes = (cycles, safes, enqs, idxs)
    sharded, shards = _layout("ring_enqueue_wave", planes, nslots_log2,
                              heads, tails, shards, ring)
    n = _wave_mode("ring_enqueue_wave", values, shards, mask, counts)
    _check_round("ring_enqueue_wave", planes, heads, tails, live, values,
                 *(() if counts is None else (counts,)))
    if not 0 <= capacity < 1 << 31:
        raise ValueError(f"ring_enqueue_wave: capacity={capacity} out of "
                         f"range")
    if mask is not None and (mask.device != heads.device
                             or not mask.is_contiguous()):
        raise ValueError("ring_enqueue_wave: mask must be contiguous, on "
                         "the ring's card")
    birth_ptr = 0
    if birth_round is not None:
        if sharded:
            raise ValueError("ring_enqueue_wave: the sharded rings keep no "
                             "birth stamps (spans need the replicated "
                             "ring)")
        _build.require_cuda("ring_enqueue_wave", birth_round)
        if birth_round.numel() != 1 or birth_round.device != heads.device:
            raise ValueError("ring_enqueue_wave: birth_round must be one "
                             "int32 on the ring's card")
        birth_ptr = birth_round.data_ptr()
    dev = heads.device
    total = torch.empty((), dtype=torch.int32, device=dev)
    over = torch.empty((), dtype=torch.bool, device=dev)
    pushes = torch.empty(shards, dtype=torch.int32, device=dev)
    name = ("ring_enqueue_wave_sharded" if sharded else
            "ring_enqueue_wave_packed" if birth_round is not None
            else "ring_enqueue_wave")
    lib = _build.library("ring_slots")
    _build.check(lib.repro_ring_enqueue_wave(
        *(p.data_ptr() for p in planes), heads.data_ptr(), tails.data_ptr(),
        live.data_ptr(), values.data_ptr(),
        0 if mask is None else mask.data_ptr(),
        0 if counts is None else counts.data_ptr(), birth_ptr,
        total.data_ptr(), over.data_ptr(), pushes.data_ptr(), n, shards,
        int(sharded), capacity, nslots_log2, idx_bot,
        -1 if ring is None else ring, _build.stream_of(heads)), name)
    _build.LAUNCHES[name] += 1
    return total, over, pushes


def _wave_mode(name, values, shards, mask, counts) -> int:
    """Exactly one of ballot mode (``mask`` as wide as the flat
    ``values``) and dense mode ((S, n) ``values`` with (S,) int32
    ``counts``); returns n, the lanes a shard."""
    if (mask is None) == (counts is None):
        raise ValueError(f"{name}: pass mask (ballot mode) or counts "
                         f"(dense mode), not both or neither")
    if mask is not None:
        if (values.dim() != 1 or mask.dtype != torch.bool
                or mask.shape != values.shape
                or values.shape[0] % shards):
            raise ValueError(f"{name}: ballot mode takes (S * n,) values "
                             f"and a bool mask as wide as values")
        return values.shape[0] // shards
    if (values.dim() != 2 or values.shape[0] != shards
            or tuple(counts.shape) != (shards,)
            or counts.dtype != torch.int32):
        raise ValueError(f"{name}: dense mode takes (S, n) values and "
                         f"(S,) int32 counts")
    return values.shape[1]


def _check_round(name, planes, heads, tails, live, *rest):
    """A wave kernel's inputs on the current card: int32 planes, heads,
    tails and the rest, contiguous, and a 0-d bool ``live`` there too."""
    _build.require_cuda(name, *planes, heads, tails, *rest)
    if (live.dtype != torch.bool or live.dim()
            or live.device != heads.device):
        raise ValueError(f"{name}: live must be a 0-d bool on the ring's "
                         f"card")


def _check_planes(name, planes, nslots_log2):
    if not 0 < nslots_log2 < 32:
        raise ValueError(f"{name}: nslots_log2={nslots_log2} out of range")
    for p in planes:
        if p.shape != (1 << nslots_log2,):
            raise ValueError(f"{name}: planes must be (2^{nslots_log2},), "
                             f"got {tuple(p.shape)}")


def _check_wave(name, planes, nslots_log2, tickets, *rest):
    _build.require_cuda(name, *planes, tickets, *rest)
    _check_planes(name, planes, nslots_log2)
    for t in (tickets,) + rest[:1]:
        if t.dim() != 1 or t.shape[0] != tickets.shape[0]:
            raise ValueError(f"{name}: tickets/values must be (B,)")
