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
masks.  The packed birth-stamp span modes of the reference wait for the
observability slice.
"""

from __future__ import annotations

import torch

from . import _build
from .wavefaa import _i32, wavefaa_plain

_U32 = 0xFFFFFFFF
_SIGN = 1 << 31


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


def ring_enqueue_plain(cycles, safes, enqs, idxs, tickets, values, head, *,
                       nslots_log2: int, idx_bot: int, active=None):
    """One TRYENQ wave in plain PyTorch, in place: a lane installs its
    value where the slot's cycle is behind the ticket's, the slot is
    empty, and the slot is safe or ``head <= ticket``.  ``active``
    defaults to ``tickets >= 0``.  Returns (cycles, safes, enqs, idxs,
    ok (B,) bool)."""
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
    enqs[w] = 1
    idxs[w] = values.to(torch.int32)[can]
    return cycles, safes, enqs, idxs, can


def ring_dequeue_plain(cycles, safes, enqs, idxs, tickets, *,
                       nslots_log2: int, idx_bot: int, active=None):
    """One TRYDEQ wave in plain PyTorch, in place: consume on a cycle
    match, advance stale empty slots to the ticket's cycle, mark stale
    live slots unsafe.  Returns (cycles, safes, enqs, idxs, vals (B,)
    int32 with -1 on a miss, ok (B,) bool)."""
    active, j, c = _slots(tickets, nslots_log2, active)
    e_c, e_e, e_i = cycles[j], enqs[j], idxs[j]
    empty = (e_i == idx_bot) | (e_i == idx_bot - 1)
    hit = active & (e_c == c) & ~empty & (e_e == 1)
    behind = active & ~hit & cycle_lt(e_c, c, nslots_log2)
    adv, uns = behind & empty, behind & ~empty
    idxs[j[hit]] = idx_bot - 1
    cycles[j[adv]] = c[adv]
    safes[j[uns]] = 0
    vals = torch.where(hit, e_i, -1)
    return cycles, safes, enqs, idxs, vals, hit


def enq_planes(cycles, safes, enqs, idxs, tickets, values, head, *,
               nslots_log2: int, idx_bot: int, active=None):
    """Functional TRYENQ wave (reference ``enq_planes`` without the span
    modes): new planes, ``ok`` as int32."""
    planes = [p.clone() for p in (cycles, safes, enqs, idxs)]
    *planes, ok = ring_enqueue_plain(*planes, tickets, values, head,
                                     nslots_log2=nslots_log2,
                                     idx_bot=idx_bot, active=active)
    return (*planes, ok.int())


def deq_planes(cycles, safes, enqs, idxs, tickets, *, nslots_log2: int,
               idx_bot: int, active=None):
    """Functional TRYDEQ wave (reference ``deq_planes`` without the span
    modes): new planes, values, ``ok`` as int32."""
    planes = [p.clone() for p in (cycles, safes, enqs, idxs)]
    *planes, vals, ok = ring_dequeue_plain(*planes, tickets,
                                           nslots_log2=nslots_log2,
                                           idx_bot=idx_bot, active=active)
    return (*planes, vals, ok.int())


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
                            batch: int, nslots_log2: int, idx_bot: int):
    """Plain PyTorch ``ring_dequeue_wave``: the round's dequeue chain on
    ``ring_dequeue_plain``.  Updates the planes and ``head`` in place;
    returns (vals (batch,) int32, ok (batch,) bool, k 0-d int32)."""
    lane = torch.arange(batch, dtype=torch.int32, device=head.device)
    k = torch.where(live, torch.clamp(_i32(tail.long() - head.long()),
                                      max=batch), 0)
    active = lane < k
    tickets = torch.where(active, _i32(head.long() + lane), -1)
    *_, vals, ok = ring_dequeue_plain(cycles, safes, enqs, idxs, tickets,
                                      nslots_log2=nslots_log2,
                                      idx_bot=idx_bot, active=active)
    head.copy_(_i32(head.long() + k))
    return vals, ok, k


def ring_enqueue_wave_plain(cycles, safes, enqs, idxs, head, tail, values,
                            live, *, capacity: int, nslots_log2: int,
                            idx_bot: int, mask=None, count=None):
    """Plain PyTorch ``ring_enqueue_wave``: the round's enqueue chain on
    ``wavefaa_plain`` and ``ring_enqueue_plain``.  Updates the planes and
    ``tail`` in place; returns (total 0-d int32, over 0-d bool)."""
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
                       active=active & ~over)
    tail.copy_(torch.where(over, tail, _i32(tail.long() + n_child)))
    return torch.where(over, 0, n_child), over


def ring_dequeue_wave(cycles, safes, enqs, idxs, head, tail, live, *,
                      batch: int, nslots_log2: int, idx_bot: int):
    """A ring round's dequeue side in one launch.  Planes (2n,) int32,
    ``head``/``tail`` 0-d int32, ``live`` 0-d bool: ``k = live ? min(tail
    - head, batch) : 0`` lanes consume tickets ``head + [0, k)``; the
    planes and ``head`` (advanced by ``k``) are updated in place.  Returns
    (vals (batch,) int32 with -1 on a miss, ok (batch,) bool, k 0-d
    int32)."""
    if head.device.type == "cpu":
        return ring_dequeue_wave_plain(cycles, safes, enqs, idxs, head, tail,
                                       live, batch=batch,
                                       nslots_log2=nslots_log2,
                                       idx_bot=idx_bot)
    planes = (cycles, safes, enqs, idxs)
    _check_round("ring_dequeue_wave", planes, nslots_log2, head, tail, live)
    if batch < 0:
        raise ValueError(f"ring_dequeue_wave: batch={batch} must be >= 0")
    dev = head.device
    vals = torch.empty(batch, dtype=torch.int32, device=dev)
    ok = torch.empty(batch, dtype=torch.bool, device=dev)
    k = torch.empty((), dtype=torch.int32, device=dev)
    lib = _build.library("ring_slots")
    _build.check(lib.repro_ring_dequeue_wave(
        *(p.data_ptr() for p in planes), head.data_ptr(), tail.data_ptr(),
        live.data_ptr(), vals.data_ptr(), ok.data_ptr(), k.data_ptr(), batch,
        nslots_log2, idx_bot, _build.stream_of(head)), "ring_dequeue_wave")
    _build.LAUNCHES["ring_dequeue_wave"] += 1
    return vals, ok, k


def ring_enqueue_wave(cycles, safes, enqs, idxs, head, tail, values, live, *,
                      capacity: int, nslots_log2: int, idx_bot: int,
                      mask=None, count=None):
    """A ring round's enqueue side in one launch.  ``values`` (N,) int32
    are the children.  Ballot mode (``mask``, (N,) bool): the children
    are the set lanes of ``mask & live``, ranked in lane order.
    Dense mode (``count``, the 0-d int32 true popcount ``wave_compact``
    returns with ``values`` as its dense wave): the children are lanes
    ``[0, count)`` when ``live``.  ``over = tail + n_child - head >
    capacity`` (int32, wrapping); unless it holds, child r installs with
    ticket ``tail + r`` and ``tail`` advances by ``n_child``, in place.
    Returns (total 0-d int32, 0 when over; over 0-d bool)."""
    if head.device.type == "cpu":
        return ring_enqueue_wave_plain(cycles, safes, enqs, idxs, head, tail,
                                       values, live, capacity=capacity,
                                       nslots_log2=nslots_log2,
                                       idx_bot=idx_bot, mask=mask,
                                       count=count)
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
    dev = head.device
    total = torch.empty((), dtype=torch.int32, device=dev)
    over = torch.empty((), dtype=torch.bool, device=dev)
    lib = _build.library("ring_slots")
    _build.check(lib.repro_ring_enqueue_wave(
        *(p.data_ptr() for p in planes), head.data_ptr(), tail.data_ptr(),
        live.data_ptr(), values.data_ptr(), mask_ptr, count_ptr,
        total.data_ptr(), over.data_ptr(), values.shape[0], capacity,
        nslots_log2, idx_bot, _build.stream_of(head)), "ring_enqueue_wave")
    _build.LAUNCHES["ring_enqueue_wave"] += 1
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
