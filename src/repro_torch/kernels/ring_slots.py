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


def _check_wave(name, planes, nslots_log2, tickets, *rest):
    _build.require_cuda(name, *planes, tickets, *rest)
    if not 0 < nslots_log2 < 32:
        raise ValueError(f"{name}: nslots_log2={nslots_log2} out of range")
    for p in planes:
        if p.shape != (1 << nslots_log2,):
            raise ValueError(f"{name}: planes must be (2^{nslots_log2},), "
                             f"got {tuple(p.shape)}")
    for t in (tickets,) + rest[:1]:
        if t.dim() != 1 or t.shape[0] != tickets.shape[0]:
            raise ValueError(f"{name}: tickets/values must be (B,)")
