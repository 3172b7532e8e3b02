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
Nothing is read back, so the call sits inside the captured round.

The mesh engines record S shards in the same one call (``shards=S``):
the wave is their claim grid flattened shard-major (S * B lanes), ``k``,
``total`` and ``occ`` are (S,) vectors (each shard's pops, pushes and
occupancy; the row's imbalance is max - min of the pops), and the span
plane is stacked, one (B, K, NB + 1) histogram, flow ring, cursor and
clock a shard (``span_init`` under a leading shard axis), each shard's
lanes recording into its own (reference ``meshrounds.py``).  Its
launches count as ``obs_record_mesh``.
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
                     total=None, occ=None, over=None,
                     shards: Optional[int] = None) -> None:
    """``obs_record`` in torch ops, in place (see the module doc)."""
    if tp is not None:
        mn, mx = masked_min_max(keys, valid)
        trace_record_(tp, tp.count, k, total, occ, mn, mx, over)
    if sp is None:
        return
    if cls is None:
        cls = torch.zeros_like(births)
    if shards is None:
        span_record_(sp, cls, sp.round - births, valid, ref)
        span_tick_(sp)
        return
    rows = [x.reshape(shards, -1) for x in (cls, births, valid, ref)]
    for s in range(shards):
        one = SpanPlane(*(t[s] for t in sp))       # views: updates land
        span_record_(one, rows[0][s], one.round - rows[1][s], rows[2][s],
                     rows[3][s])
    span_tick_(sp)


def obs_record(tp: Optional[TracePlane], sp: Optional[SpanPlane], *,
               keys, valid, ref=None, births=None, cls=None, k=None,
               total=None, occ=None, over=None,
               shards: Optional[int] = None) -> None:
    """Record one round into ``tp`` and ``sp`` in place.  ``valid`` (B,)
    bool marks the wave's claiming lanes; ``keys`` (B,) int32 are the
    keys (or payloads) whose extrema the trace row holds; ``k``,
    ``total``, ``occ`` (0-d int32) and ``over`` (0-d bool) are the
    round's claims, installed children, occupancy after it and overflow
    flag (trace plane).  ``births`` (B,) int32 are the claimed items'
    birth rounds, ``ref`` (B,) int32 their payloads and ``cls`` (B,)
    int32 their class rows (span plane; B = the plane's lanes).  With
    ``shards=S`` (the mesh engines) the lanes are S * B, ``k``, ``total``
    and ``occ`` (S,) and the span plane stacked (see the module doc)."""
    if valid.device.type == "cpu":
        return obs_record_plain(tp, sp, keys=keys, valid=valid, ref=ref,
                                births=births, cls=cls, k=k, total=total,
                                occ=occ, over=over, shards=shards)
    if tp is None and sp is None:
        return None
    s = 1 if shards is None else int(shards)
    if not 1 <= s <= 1024:
        raise ValueError(f"obs_record: shards={shards} out of range [1, "
                         f"1024]")
    n = valid.shape[0] if valid.dim() == 1 else 0
    if n < s or n % s:
        raise ValueError("obs_record: valid must be a non-empty (B,) bool, "
                         "S * B lanes with shards=S")
    b = n // s
    lanes = [("valid", valid, torch.bool)]
    words = []
    vectors = []
    ptrs = [0] * 16
    capacity = classes = buckets = flows = 1
    if tp is not None:
        if tp.shards != s:
            raise ValueError(f"obs_record: the wave has {s} shard(s), the "
                             f"trace plane {tp.shards}")
        lanes.append(("keys", keys, torch.int32))
        words += [("over", over, torch.bool),
                  ("count", tp.count, torch.int32)]
        vectors += [("k", k), ("total", total), ("occ", occ)]
        capacity = tp.capacity
    if sp is not None:
        stacked = sp.hist.dim() == 4
        if stacked != (shards is not None) or (
                stacked and sp.hist.shape[0] != s):
            raise ValueError(f"obs_record: a span plane of shape "
                             f"{tuple(sp.hist.shape)} for {s} shard(s): "
                             f"the mesh's plane is stacked, one a shard")
        if sp.lanes != b:
            raise ValueError(f"span_record wave has {b} lanes but the "
                             f"plane was built for {sp.lanes}")
        lanes += [("ref", ref, torch.int32), ("births", births, torch.int32)]
        if cls is not None:
            lanes.append(("cls", cls, torch.int32))
        vectors += [("fcount", sp.fcount), ("round", sp.round)]
        classes, buckets, flows = sp.classes, sp.buckets, sp.flow_capacity
    _check_record(n, s, lanes, words, vectors, tp, sp)
    t = {name: x for name, x, _ in lanes}
    ptrs[:5] = [t[nm].data_ptr() if nm in t else 0
                for nm in ("keys", "valid", "ref", "births", "cls")]
    if tp is not None:
        ptrs[5:12] = [x.data_ptr() for x in (k, total, occ, over, *tp)]
    if sp is not None:
        ptrs[12:16] = [x.data_ptr() for x in sp]
    name = "obs_record" if shards is None else "obs_record_mesh"
    lib = _build.library("obs_record")
    _build.check(lib.repro_obs_record(
        *ptrs, b, s, capacity, classes, buckets, flows,
        _build.stream_of(valid)), name)
    _build.LAUNCHES[name] += 1
    return None


def _check_record(n, shards, lanes, words, vectors, tp, sp):
    """What the kernel reads as raw memory: every lane tensor a contiguous
    (n,) of its type (bool ``valid``, int32 otherwise), every round word
    one element of its type, every per-shard vector (the pops, pushes and
    occupancies, the span cursors and clocks) ``shards`` contiguous int32
    elements, the planes int32 and contiguous, all on the current card.
    Checked before the devices, so a wrong type is named as such
    anywhere."""
    vec = [(name, x, torch.int32) for name, x in vectors]
    for name, x, dtype in lanes + words + vec:
        if x is None:
            raise ValueError(f"obs_record: {name} is required")
        if x.dtype != dtype:
            raise ValueError(f"obs_record: {name} must be {dtype}, got "
                             f"{x.dtype}")
    for name, x, _ in lanes:
        if x.shape != (n,) or not x.is_contiguous():
            raise ValueError(f"obs_record: {name} must be a contiguous "
                             f"(B,) like valid, got {tuple(x.shape)}")
    for name, x, _ in words:
        if x.numel() != 1:
            raise ValueError(f"obs_record: {name} must be one element")
    for name, x, _ in vec:
        if x.numel() != shards or not x.is_contiguous():
            raise ValueError(f"obs_record: {name} must hold one "
                             f"contiguous int32 a shard ({shards})")
    planes = [*(tp or ()), *(sp or ())]
    for p in planes:
        if not p.is_contiguous():
            raise ValueError("obs_record: the planes must be contiguous")
    _build.require_cuda("obs_record", *planes,
                        *(x for _, x, d in lanes + words + vec
                          if d == torch.int32))
    for name, x, _ in lanes + words + vec:
        if x.device != planes[0].device:
            raise ValueError(f"obs_record: {name} must be on the planes' "
                             f"card, got {x.device}")
