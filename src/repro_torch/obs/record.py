"""A round's observability record in one call: the trace row and the span
histogram update of a fused round engine.

``obs_record`` is what the reference's round does with its planes after
the counters (``repro/runtime/enginecore.py: fused_loop`` calls
``trace_record``; ``repro/runtime/fusedrounds.py`` calls ``span_record``
and ``span_tick``), on the engine's kept planes IN PLACE:

* trace plane: the extrema of ``keys`` over ``valid`` lanes
  (``masked_min_max``) and the row ``(count, 0, min, max, over)`` with
  ``(k, total, occ)`` at slot ``count % C``, then ``count += 1``: the
  round index recorded is the plane's count, as the reference's loop
  passes it;
* span plane: each valid lane's sojourn ``round - births`` into its class
  row (``cls``, class 0 when None) of the lane-major histogram, lane 0's
  flow exemplar, and the round clock's tick.

Either plane may be None.  A CPU tensor goes to ``obs_record_plain``,
the functional faces' torch ops applied in place; a CUDA tensor
launches ``csrc/obs_record.cu``, one block over the wave, or raises.
Nothing is read back, so the call sits inside the captured round.  Only
one-shard trace planes have the kernel (the chip engines').
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import _build
from .spans import SpanPlane, span_record_, span_tick_
from .trace import TracePlane, masked_min_max, trace_record_

__all__ = ["obs_record", "obs_record_plain"]


def obs_record_plain(tp: Optional[TracePlane], sp: Optional[SpanPlane], *,
                     keys, valid, ref=None, births=None, cls=None, k=None,
                     total=None, occ=None, over=None) -> None:
    """``obs_record`` in torch ops, in place (see the module doc)."""
    if tp is not None:
        mn, mx = masked_min_max(keys, valid)
        trace_record_(tp, tp.count, k, total, occ, mn, mx, over)
    if sp is not None:
        if cls is None:
            cls = torch.zeros_like(births)
        span_record_(sp, cls, sp.round - births, valid, ref)
        span_tick_(sp)


def obs_record(tp: Optional[TracePlane], sp: Optional[SpanPlane], *,
               keys, valid, ref=None, births=None, cls=None, k=None,
               total=None, occ=None, over=None) -> None:
    """Record one round into ``tp`` and ``sp`` in place.  ``valid`` (B,)
    bool marks the wave's claiming lanes; ``keys`` (B,) int32 are the
    keys (or payloads) whose extrema the trace row holds; ``k``,
    ``total``, ``occ`` (0-d int32) and ``over`` (0-d bool) are the
    round's claims, installed children, occupancy after it and overflow
    flag (trace plane).  ``births`` (B,) int32 are the claimed items'
    birth rounds, ``ref`` (B,) int32 their payloads and ``cls`` (B,)
    int32 their class rows (span plane; B = the plane's lanes)."""
    if valid.device.type == "cpu":
        return obs_record_plain(tp, sp, keys=keys, valid=valid, ref=ref,
                                births=births, cls=cls, k=k, total=total,
                                occ=occ, over=over)
    if tp is None and sp is None:
        return None
    b = valid.shape[0] if valid.dim() == 1 else 0
    if b < 1:
        raise ValueError("obs_record: valid must be a non-empty (B,) bool")
    lanes = [("valid", valid, torch.bool)]
    words = []
    ptrs = [0] * 16
    capacity = classes = buckets = flows = 1
    if tp is not None:
        if tp.shards != 1:
            raise ValueError(f"obs_record: the kernel records one shard, "
                             f"the plane has {tp.shards}")
        lanes.append(("keys", keys, torch.int32))
        words += [("k", k, torch.int32), ("total", total, torch.int32),
                  ("occ", occ, torch.int32), ("over", over, torch.bool),
                  ("count", tp.count, torch.int32)]
        capacity = tp.capacity
    if sp is not None:
        if sp.lanes != b:
            raise ValueError(f"span_record wave has {b} lanes but the "
                             f"plane was built for {sp.lanes}")
        lanes += [("ref", ref, torch.int32), ("births", births, torch.int32)]
        if cls is not None:
            lanes.append(("cls", cls, torch.int32))
        words += [("fcount", sp.fcount, torch.int32),
                  ("round", sp.round, torch.int32)]
        classes, buckets, flows = sp.classes, sp.buckets, sp.flow_capacity
    _check_record(b, lanes, words, tp, sp)
    t = {name: x for name, x, _ in lanes}
    ptrs[:5] = [t[n].data_ptr() if n in t else 0
                for n in ("keys", "valid", "ref", "births", "cls")]
    if tp is not None:
        ptrs[5:12] = [x.data_ptr() for x in (k, total, occ, over, *tp)]
    if sp is not None:
        ptrs[12:16] = [x.data_ptr() for x in sp]
    lib = _build.library("obs_record")
    _build.check(lib.repro_obs_record(
        *ptrs, b, capacity, classes, buckets, flows,
        _build.stream_of(valid)), "obs_record")
    _build.LAUNCHES["obs_record"] += 1
    return None


def _check_record(b, lanes, words, tp, sp):
    """What the kernel reads as raw memory: every lane tensor a contiguous
    (B,) of its type (bool ``valid``, int32 otherwise), every round word
    and cursor one element of its type, the planes int32 and contiguous,
    all on the current card.  Checked before the devices, so a wrong type
    is named as such anywhere."""
    for name, x, dtype in lanes + words:
        if x is None:
            raise ValueError(f"obs_record: {name} is required")
        if x.dtype != dtype:
            raise ValueError(f"obs_record: {name} must be {dtype}, got "
                             f"{x.dtype}")
    for name, x, _ in lanes:
        if x.shape != (b,) or not x.is_contiguous():
            raise ValueError(f"obs_record: {name} must be a contiguous "
                             f"(B,) like valid, got {tuple(x.shape)}")
    for name, x, _ in words:
        if x.numel() != 1:
            raise ValueError(f"obs_record: {name} must be one element")
    planes = [*(tp or ()), *(sp or ())]
    _build.require_cuda("obs_record", *planes,
                        *(x for _, x, d in lanes + words
                          if d == torch.int32))
    for name, x, _ in lanes + words:
        if x.device != planes[0].device:
            raise ValueError(f"obs_record: {name} must be on the planes' "
                             f"card, got {x.device}")
