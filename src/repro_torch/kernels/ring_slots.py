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
  in ``csrc/ring_slots.cu`` or raises.  There is no fallback.
* ``ring_enqueue_plain`` / ``ring_dequeue_plain`` — plain PyTorch with the
  kernels' contract, the CPU path and the kernels' oracle on the card.
* ``enq_planes`` / ``deq_planes`` — functional forms (new planes, ``ok``
  as int32, optional ``active`` mask) matching the reference's names.

A ring round's queue side comes as two more wrappers, each one launch on
the card, each beside its plain version (``*_plain``, the round
engine's elementwise chain built on the plain faces above):

* ``ring_dequeue_wave`` — ``k = live ? min(tail - head, batch) : 0``,
  tickets ``head + [0, k)`` consumed, ``head += k`` in place.
* ``ring_enqueue_wave`` — the children's tickets from the spawn-mask
  ballot (or ``tail + [0, count)`` for a wave compacted by
  ``wave_compact``), the overflow test ``tail + n_child - head >
  capacity`` for the whole wave, the installs unless it overflows, and
  ``tail += n_child`` in place.

They take each lane's activity from that arithmetic (``lane < k``, the
ballot bit), not from the ticket's sign, so tickets past 2^31 move like
any other; below 2^31, where every run of the round engine stays, they
give what the reference round's -1-sentinel tickets give.

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
layout (``ring_enqueue_wave(birth_round=)``, ``ring_dequeue_wave(
birth_packed=True)``, instances of their own in ``csrc/ring_slots.cu``);
the functional faces carry both.
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
    ``ok`` as int32, and with ``births`` the new births plane last.  A
    packed ``birth_round`` (no ``births``) given as an int or a CPU
    tensor must lie below ``SPAN_ROUND_CAP``."""
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
    consumed lanes' births last."""
    planes = [p.clone() for p in (cycles, safes, enqs, idxs)]
    out = ring_dequeue_plain(*planes, tickets, nslots_log2=nslots_log2,
                             idx_bot=idx_bot, active=active, births=births,
                             birth_packed=birth_packed)
    return (*out[:5], out[5].int(), *out[6:])


def ring_enqueue(cycles, safes, enqs, idxs, tickets, values, head, *,
                 nslots_log2: int, idx_bot: int):
    """Apply a wave of TRYENQ installs in place.  Planes are (2n,) int32,
    ``tickets``/``values`` (B,) int32 (ticket -1 = inactive), ``head`` a
    scalar.  Returns (cycles, safes, enqs, idxs, ok (B,) bool)."""
    if tickets.device.type == "cpu":
        return ring_enqueue_plain(cycles, safes, enqs, idxs, tickets, values,
                                  head, nslots_log2=nslots_log2,
                                  idx_bot=idx_bot)
    head = torch.as_tensor(head, dtype=torch.int32,
                           device=tickets.device).reshape(1)
    _check_wave("ring_enqueue", (cycles, safes, enqs, idxs), nslots_log2,
                tickets, values, head)
    b = tickets.shape[0]
    ok = torch.empty(b, dtype=torch.bool, device=tickets.device)
    if b:
        lib = _build.library("ring_slots")
        _build.check(lib.repro_ring_enqueue(
            cycles.data_ptr(), safes.data_ptr(), enqs.data_ptr(),
            idxs.data_ptr(), tickets.data_ptr(), values.data_ptr(),
            head.data_ptr(), ok.data_ptr(), b, nslots_log2, idx_bot,
            _build.stream_of(tickets)), "ring_enqueue")
        _build.LAUNCHES["ring_enqueue"] += 1
    return cycles, safes, enqs, idxs, ok


def ring_dequeue(cycles, safes, enqs, idxs, tickets, *, nslots_log2: int,
                 idx_bot: int):
    """Apply a wave of TRYDEQ consumes in place.  Returns (cycles, safes,
    enqs, idxs, values (B,) int32, ok (B,) bool)."""
    if tickets.device.type == "cpu":
        return ring_dequeue_plain(cycles, safes, enqs, idxs, tickets,
                                  nslots_log2=nslots_log2, idx_bot=idx_bot)
    _check_wave("ring_dequeue", (cycles, safes, enqs, idxs), nslots_log2,
                tickets)
    b = tickets.shape[0]
    vals = torch.empty(b, dtype=torch.int32, device=tickets.device)
    ok = torch.empty(b, dtype=torch.bool, device=tickets.device)
    if b:
        lib = _build.library("ring_slots")
        _build.check(lib.repro_ring_dequeue(
            cycles.data_ptr(), safes.data_ptr(), enqs.data_ptr(),
            idxs.data_ptr(), tickets.data_ptr(), vals.data_ptr(),
            ok.data_ptr(), b, nslots_log2, idx_bot,
            _build.stream_of(tickets)), "ring_dequeue")
        _build.LAUNCHES["ring_dequeue"] += 1
    return cycles, safes, enqs, idxs, vals, ok


def ring_dequeue_wave_plain(cycles, safes, enqs, idxs, head, tail, live, *,
                            batch: int, nslots_log2: int, idx_bot: int,
                            birth_packed: bool = False):
    """Plain PyTorch ``ring_dequeue_wave``: the round's dequeue chain on
    ``ring_dequeue_plain``.  Updates the planes and ``head`` in place;
    returns (vals (batch,) int32, ok (batch,) bool, k 0-d int32), and
    with ``birth_packed`` the births (batch,) int32 last."""
    lane = torch.arange(batch, dtype=torch.int32, device=head.device)
    k = torch.where(live, torch.clamp(_i32(tail.long() - head.long()),
                                      max=batch), 0)
    active = lane < k
    tickets = torch.where(active, _i32(head.long() + lane), -1)
    out = ring_dequeue_plain(cycles, safes, enqs, idxs, tickets,
                             nslots_log2=nslots_log2, idx_bot=idx_bot,
                             active=active, birth_packed=birth_packed)
    head.copy_(_i32(head.long() + k))
    return (out[4], out[5], k, *out[6:])


def ring_enqueue_wave_plain(cycles, safes, enqs, idxs, head, tail, values,
                            live, *, capacity: int, nslots_log2: int,
                            idx_bot: int, mask=None, count=None,
                            birth_round=None):
    """Plain PyTorch ``ring_enqueue_wave``: the round's enqueue chain on
    ``wavefaa_plain`` and ``ring_enqueue_plain`` (packed stamps with
    ``birth_round``).  Updates the planes and ``tail`` in place; returns
    (total 0-d int32, over 0-d bool)."""
    _wave_mode("ring_enqueue_wave", values, mask, count)
    if mask is not None:
        active = mask & live
        tickets, newctr = wavefaa_plain(active, tail.reshape(1))
        n_child = _i32(newctr[0].long() - tail.long())
    else:
        n_child = torch.where(live, count.reshape(()), 0)
        lane = torch.arange(values.shape[0], dtype=torch.int32,
                            device=tail.device)
        active = lane < n_child
        tickets = _i32(tail.long() + lane)
    over = _i32(tail.long() + n_child.long() - head.long()) > capacity
    ring_enqueue_plain(cycles, safes, enqs, idxs, tickets, values, head,
                       nslots_log2=nslots_log2, idx_bot=idx_bot,
                       active=active & ~over, birth_round=birth_round)
    tail.copy_(torch.where(over, tail, _i32(tail.long() + n_child)))
    return torch.where(over, 0, n_child), over


def ring_dequeue_wave(cycles, safes, enqs, idxs, head, tail, live, *,
                      batch: int, nslots_log2: int, idx_bot: int,
                      birth_packed: bool = False):
    """A ring round's dequeue side in one launch.  Planes (2n,) int32,
    ``head``/``tail`` 0-d int32, ``live`` 0-d bool: ``k = live ? min(tail
    - head, batch) : 0`` lanes consume tickets ``head + [0, k)``; the
    planes and ``head`` (advanced by ``k``) are updated in place.  Returns
    (vals (batch,) int32 with -1 on a miss, ok (batch,) bool, k 0-d
    int32).  ``birth_packed`` (the kernel's packed instance) takes the
    enq flag's low bit as the flag and appends the consumed lanes' birth
    stamps ``enq >> 1`` ((batch,) int32, -1 on a miss)."""
    if head.device.type == "cpu":
        return ring_dequeue_wave_plain(cycles, safes, enqs, idxs, head, tail,
                                       live, batch=batch,
                                       nslots_log2=nslots_log2,
                                       idx_bot=idx_bot,
                                       birth_packed=birth_packed)
    planes = (cycles, safes, enqs, idxs)
    _check_round("ring_dequeue_wave", planes, nslots_log2, head, tail, live)
    if batch < 0:
        raise ValueError(f"ring_dequeue_wave: batch={batch} must be >= 0")
    dev = head.device
    vals = torch.empty(batch, dtype=torch.int32, device=dev)
    ok = torch.empty(batch, dtype=torch.bool, device=dev)
    k = torch.empty((), dtype=torch.int32, device=dev)
    births = (torch.empty(batch, dtype=torch.int32, device=dev)
              if birth_packed else None)
    name = "ring_dequeue_wave_packed" if birth_packed else "ring_dequeue_wave"
    lib = _build.library("ring_slots")
    _build.check(lib.repro_ring_dequeue_wave(
        *(p.data_ptr() for p in planes), head.data_ptr(), tail.data_ptr(),
        live.data_ptr(), vals.data_ptr(), ok.data_ptr(), k.data_ptr(),
        births.data_ptr() if birth_packed else 0, batch, nslots_log2,
        idx_bot, _build.stream_of(head)), name)
    _build.LAUNCHES[name] += 1
    return (vals, ok, k) if births is None else (vals, ok, k, births)


def ring_enqueue_wave(cycles, safes, enqs, idxs, head, tail, values, live, *,
                      capacity: int, nslots_log2: int, idx_bot: int,
                      mask=None, count=None, birth_round=None):
    """A ring round's enqueue side in one launch.  ``values`` (N,) int32
    are the children.  Ballot mode (``mask``, (N,) bool): the children
    are the set lanes of ``mask & live``, ranked in lane order.
    Dense mode (``count``, the 0-d int32 true popcount ``wave_compact``
    returns with ``values`` as its dense wave): the children are lanes
    ``[0, count)`` when ``live``.  ``over = tail + n_child - head >
    capacity`` (int32, wrapping); unless it holds, child r installs with
    ticket ``tail + r`` and ``tail`` advances by ``n_child``, in place.
    ``birth_round`` (a 0-d int32 tensor on the ring's card, read there;
    the kernel's packed instance) makes the flag written ``(birth_round
    << 1) | 1``.  Returns (total 0-d int32, 0 when over; over 0-d
    bool)."""
    if head.device.type == "cpu":
        return ring_enqueue_wave_plain(cycles, safes, enqs, idxs, head, tail,
                                       values, live, capacity=capacity,
                                       nslots_log2=nslots_log2,
                                       idx_bot=idx_bot, mask=mask,
                                       count=count, birth_round=birth_round)
    planes = (cycles, safes, enqs, idxs)
    _check_round("ring_enqueue_wave", planes, nslots_log2, head, tail, live,
                 values)
    _wave_mode("ring_enqueue_wave", values, mask, count)
    if not 0 <= capacity < 1 << 31:
        raise ValueError(f"ring_enqueue_wave: capacity={capacity} out of "
                         f"range")
    mask_ptr = count_ptr = 0
    if mask is not None:
        if mask.device != head.device or not mask.is_contiguous():
            raise ValueError("ring_enqueue_wave: mask must be contiguous, "
                             "on the ring's card")
        mask_ptr = mask.data_ptr()
    else:
        _build.require_cuda("ring_enqueue_wave", count)
        count_ptr = count.data_ptr()
    birth_ptr = 0
    if birth_round is not None:
        _build.require_cuda("ring_enqueue_wave", birth_round)
        if birth_round.numel() != 1 or birth_round.device != head.device:
            raise ValueError("ring_enqueue_wave: birth_round must be one "
                             "int32 on the ring's card")
        birth_ptr = birth_round.data_ptr()
    dev = head.device
    total = torch.empty((), dtype=torch.int32, device=dev)
    over = torch.empty((), dtype=torch.bool, device=dev)
    name = ("ring_enqueue_wave" if birth_round is None
            else "ring_enqueue_wave_packed")
    lib = _build.library("ring_slots")
    _build.check(lib.repro_ring_enqueue_wave(
        *(p.data_ptr() for p in planes), head.data_ptr(), tail.data_ptr(),
        live.data_ptr(), values.data_ptr(), mask_ptr, count_ptr, birth_ptr,
        total.data_ptr(), over.data_ptr(), values.shape[0], capacity,
        nslots_log2, idx_bot, _build.stream_of(head)), name)
    _build.LAUNCHES[name] += 1
    return total, over


def _wave_mode(name, values, mask, count):
    """Exactly one of ballot mode (``mask``, as wide as ``values``) and
    dense mode (``count``, one int)."""
    if (mask is None) == (count is None):
        raise ValueError(f"{name}: pass mask (ballot mode) or count (dense "
                         f"mode), not both or neither")
    if values.dim() != 1:
        raise ValueError(f"{name}: values must be (N,)")
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape != values.shape:
            raise ValueError(f"{name}: mask must be a bool (N,) as wide as "
                             f"values")
    elif count.numel() != 1 or count.dtype != torch.int32:
        raise ValueError(f"{name}: count must be one int32")


def _check_round(name, planes, nslots_log2, head, tail, live, *rest):
    """A wave kernel's inputs: the ring on the current card, 0-d int32
    head and tail and a 0-d bool live flag there too."""
    _build.require_cuda(name, *planes, head, tail, *rest)
    _check_planes(name, planes, nslots_log2)
    if head.dim() or tail.dim():
        raise ValueError(f"{name}: head and tail must be 0-d")
    if (live.dtype != torch.bool or live.dim()
            or live.device != head.device):
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
