"""Batched d-ary heap operations — the PyTorch twin of
``repro/kernels/heap_batch.py``, the device face of G-PQ.

The heap is two parallel int32 field planes of 2^cap_log2 slots, keys
and vals (empty slots ``KEY_INF`` / -1), plus its size.  One call applies
a batch of ``(op, key, val)`` in batch-index order, which is the
linearization order: ``OP_INSERT`` sifts up (rejected when full),
``OP_DELMIN`` takes the root out and sifts the last node down into the
hole, then scrubs the vacated slot (rejected when empty), anything else
(``OP_NOP``) is inert padding.  Sift-up moves while ``parent > key``,
the child scan takes a child only when it is strictly smaller (ties go
to the lowest child, a ``KEY_INF`` child is never taken), and sift-down
moves while ``best child < last``: exactly the Pallas body, so the
planes agree bit for bit.  Keys compare as signed int32.

Faces:

* ``heap_apply`` — the wrapper.  A CPU tensor goes to the plain version;
  a CUDA tensor launches the hand-written kernel in
  ``csrc/heap_batch.cu`` or raises.  ``size`` goes in as a device tensor
  and the new size comes back as a 0-d device tensor: nothing is read
  back, so the round engine's predicated rounds stay on the card.  An
  optional ``rider`` plane moves in lockstep with ``vals`` through every
  sift (the span layer's birth stamps): INSERT lanes install
  ``oprider``, DELETE-MIN lanes return the popped rider.  On the card
  it is the kernel's rider instance.
* ``heap_apply_plain`` — the same batch applied one op at a time on the
  host (a CUDA heap is copied off the card and back).  It is the CPU
  path and the kernel's oracle on the card.
* ``heap_planes`` — functional form (new planes, the inputs unchanged),
  and ``heap_pop_count`` / ``heap_insert_masked`` on top of it: the
  reference's partial waves, one heap at a time.  They run
  ``heap_apply`` on copies, so a CUDA tensor launches the kernel.
* ``heap_apply_grid`` — one wave on S heaps stacked ``(S, 2^c)`` with
  ``(S,)`` sizes, IN PLACE: a pop wave of ``counts[s]`` DELETE-MINs on
  heap s (``heap_pop_count`` on every shard), or one gathered insert
  wave whose lane i goes to heap ``dest[i]`` (``heap_insert_masked`` on
  every shard with the mask ``dest == s``).  The priority mesh rounds
  run on it.  On the card it is one launch of S blocks of the kernel
  above; ``heap_apply_grid_plain`` runs ``_apply_serial`` shard by
  shard.

``heap_apply`` and ``heap_apply_plain`` update ``keys``/``vals`` IN
PLACE and return them, as the ring wrappers do; the Pallas kernel copies
both planes per batch.  The card's kernel is one launch of one block
that applies the batch serially with the heap's top levels (up to 21,845
nodes 4-ary, 16,383 binary, 4,681 8-ary) and a window around its last
leaf held in up to 227 KB of shared memory, and writes them back at the
end.  The plain faces and the kernel take any ``arity_log2 >= 1``: at 1,
2 and 3 through instances with the shared-memory top above, past 3
(16-ary and wider, as the reference takes them) through one instance
whose arity is a launch argument and whose serial thread works on the
planes in device memory.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import _build

KEY_INF = 2 ** 31 - 1    # empty-slot / inactive-lane key sentinel

OP_INSERT, OP_DELMIN, OP_NOP = 0, 1, -1

#: arities with an instance of their own and a shared-memory top (d =
#: 2^arity_log2); any other ``arity_log2 >= 1`` runs on the runtime-arity
#: instance
TOP_ARITY_LOG2 = (1, 2, 3)


def max_depth(cap_log2: int, arity_log2: int) -> int:
    """The Pallas loops' fixed trip count: levels needed to cover 2^cap_log2
    nodes with arity 2^arity_log2, plus one."""
    return -(-cap_log2 // arity_log2) + 1


def heap_resident_max(arity_log2: int, rider: bool = False) -> int:
    """Nodes of the kernel's shared-memory top (whole levels) at
    ``arity_log2``, for the rider instance or the rider-less one, as
    ``csrc/heap_batch.cu`` defines them: 0 past ``TOP_ARITY_LOG2`` (the
    runtime-arity instance keeps none).  Builds the kernel on first use:
    a card's machine only."""
    if arity_log2 < 1:
        raise ValueError(f"heap_resident_max: arity_log2={arity_log2} must "
                         f"be >= 1")
    return _build.library("heap_batch").repro_heap_resident_max(
        arity_log2, int(rider))


def _apply_serial(keys: np.ndarray, vplanes: Sequence[np.ndarray], size: int,
                  ops: List[int], opkeys: List[int],
                  opvals: Sequence[List[int]], cap_log2: int,
                  arity_log2: int):
    """Apply the batch one op at a time to numpy planes, in place.  Each
    loop ends early where the Pallas loop's moving flag drops, and never
    runs more than its trip count.  Returns (size, out_keys, out_vals per
    value plane, ok)."""
    cap, a = 1 << cap_log2, arity_log2
    d, depth = 1 << a, max_depth(cap_log2, arity_log2)
    b = len(ops)
    outk = [KEY_INF] * b
    outv = [[-1] * b for _ in vplanes]
    ok = [False] * b
    for i in range(b):
        op = ops[i]
        if op == OP_INSERT and size < cap:
            key, j = opkeys[i], size
            for _ in range(depth):
                if j <= 0:
                    break
                p = (j - 1) >> a
                pk = int(keys[p])
                if not pk > key:
                    break
                keys[j] = pk
                for v in vplanes:
                    v[j] = v[p]
                j = p
            keys[j] = key
            for v, ov in zip(vplanes, opvals):
                v[j] = ov[i]
            size += 1
            ok[i] = True
        elif op == OP_DELMIN and size > 0:
            outk[i] = int(keys[0])
            for v, out in zip(vplanes, outv):
                out[i] = int(v[0])
            nsize = size - 1
            lk = int(keys[nsize])
            lvs = [int(v[nsize]) for v in vplanes]
            if nsize > 0:
                j = 0
                for _ in range(depth):
                    base = (j << a) + 1
                    bk, bj = KEY_INF, -1
                    for cj in range(base, min(base + d, nsize)):
                        ck = int(keys[cj])
                        if ck < bk:
                            bk, bj = ck, cj
                    if bj < 0 or not bk < lk:
                        break
                    keys[j] = bk
                    for v in vplanes:
                        v[j] = v[bj]
                    j = bj
                keys[j] = lk
                for v, lv in zip(vplanes, lvs):
                    v[j] = lv
            # scrub the vacated tail slot so stale keys can't resurface
            keys[nsize] = KEY_INF
            for v in vplanes:
                v[nsize] = -1
            size = nsize
            ok[i] = True
    return size, outk, outv, ok


def _check_planes(name, keys, planes, ops, opkeys, opvals, cap_log2,
                  arity_log2):
    if arity_log2 < 1:
        raise ValueError(f"{name}: arity_log2={arity_log2} must be >= 1 "
                         f"(the heap's levels divide by it)")
    if not 0 < cap_log2 <= 30:
        raise ValueError(f"{name}: cap_log2={cap_log2} out of range")
    for p in (keys,) + tuple(planes):
        if p.shape != (1 << cap_log2,):
            raise ValueError(f"{name}: planes must be (2^{cap_log2},), got "
                             f"{tuple(p.shape)}")
    for t in (opkeys, opvals):
        if t.dim() != 1 or t.shape != ops.shape:
            raise ValueError(f"{name}: ops/keys/vals must be (B,)")


def _host_apply(name, keys, vplanes, size, ops, opkeys, opvals_t, *,
                cap_log2, arity_log2):
    """Run ``_apply_serial`` on host copies (views, for CPU tensors) of
    the planes and write them back in place."""
    _check_planes(name, keys, vplanes, ops, opkeys, opvals_t[0], cap_log2,
                  arity_log2)
    dev = keys.device
    host = [p if p.device.type == "cpu" else p.cpu()
            for p in (keys,) + tuple(vplanes)]
    arrays = [h.numpy() for h in host]
    size = int(torch.as_tensor(size).reshape(-1)[0])
    nsize, outk, outv, ok = _apply_serial(
        arrays[0], arrays[1:], size, ops.tolist(), opkeys.tolist(),
        [o.tolist() for o in opvals_t], cap_log2, arity_log2)
    for p, h in zip((keys,) + tuple(vplanes), host):
        if p is not h:
            p.copy_(h)
    i32 = dict(dtype=torch.int32, device=dev)
    return (torch.tensor(nsize, **i32), torch.tensor(outk, **i32),
            [torch.tensor(o, **i32) for o in outv],
            torch.tensor(ok, dtype=torch.bool, device=dev))


def _oprider(oprider, ops) -> torch.Tensor:
    """The riders INSERT lanes install: ``oprider`` (one value or (B,))
    as int32 on the ops' device; 0 when omitted."""
    if oprider is None:
        return torch.zeros((), dtype=torch.int32, device=ops.device)
    return torch.as_tensor(oprider, device=ops.device).to(torch.int32)


def heap_apply_plain(keys, vals, size, ops, opkeys, opvals, *, cap_log2: int,
                     arity_log2: int = 2, rider=None, oprider=None):
    """Plain ``heap_apply``: the batch applied one op at a time, in place.
    Returns ``(keys, vals, new_size (0-d int32), out_keys, out_vals, ok
    (B,) bool)``, and with a ``rider`` also ``(rider, out_rider)``."""
    vplanes, opvals_t = (vals,), (opvals,)
    if rider is not None:
        vplanes += (rider,)
        opvals_t += (torch.broadcast_to(_oprider(oprider, ops), ops.shape),)
    nsize, outk, outvs, ok = _host_apply(
        "heap_apply", keys, vplanes, size, ops, opkeys, opvals_t,
        cap_log2=cap_log2, arity_log2=arity_log2)
    if rider is None:
        return keys, vals, nsize, outk, outvs[0], ok
    return keys, vals, nsize, outk, outvs[0], ok, rider, outvs[1]


def heap_apply(keys, vals, size, ops, opkeys, opvals, *, cap_log2: int,
               arity_log2: int = 2, rider=None, oprider=None):
    """Apply a batch of heap ops in batch order, IN PLACE.  ``keys``/
    ``vals`` are (2^cap_log2,) int32 planes, ``size`` a one-element int32
    tensor (or an int), ``ops``/``opkeys``/``opvals`` (B,) int32.  Returns
    ``(keys, vals, new_size, out_keys, out_vals, ok)``: ``new_size`` a
    0-d int32 tensor on the planes' device, ``out_*[i]`` the DELETE-MIN
    results (``KEY_INF`` / -1 elsewhere), ``ok[i]`` (bool) whether op i
    applied.  On the card nothing is read back.

    ``rider`` (a third (2^cap_log2,) int32 plane, updated in place) moves
    with ``vals``; INSERT lanes install ``oprider`` (one int32 or (B,),
    a tensor on the planes' device to keep the call free of copies; 0
    when omitted) and the tuple grows to ``(..., ok, rider, out_rider)``,
    ``out_rider[i]`` the popped rider (-1 off DELETE-MIN lanes)."""
    if keys.device.type == "cpu":
        return heap_apply_plain(keys, vals, size, ops, opkeys, opvals,
                                cap_log2=cap_log2, arity_log2=arity_log2,
                                rider=rider, oprider=oprider)
    size = torch.as_tensor(size, dtype=torch.int32,
                           device=keys.device).reshape(1)
    vplanes = (vals,) if rider is None else (vals, rider)
    _build.require_cuda("heap_apply", keys, *vplanes, size, ops, opkeys,
                        opvals)
    _check_planes("heap_apply", keys, vplanes, ops, opkeys, opvals,
                  cap_log2, arity_log2)
    b = ops.shape[0]
    dev = keys.device
    outk = torch.empty(b, dtype=torch.int32, device=dev)
    outv = torch.empty(b, dtype=torch.int32, device=dev)
    ok = torch.empty(b, dtype=torch.bool, device=dev)
    nsize = torch.empty((), dtype=torch.int32, device=dev)
    out = (keys, vals, nsize, outk, outv, ok)
    if rider is not None:
        opr = _oprider(oprider, ops)
        _build.require_cuda("heap_apply", opr)
        if opr.numel() not in (1, b):
            raise ValueError("heap_apply: oprider must be one int32 or "
                             "(B,)")
        out += (rider, torch.empty(b, dtype=torch.int32, device=dev))
    if b == 0:
        nsize.copy_(size.reshape(()))
        return out
    lib = _build.library("heap_batch")
    common = (ops.data_ptr(), opkeys.data_ptr(), opvals.data_ptr())
    if rider is None:
        _build.check(lib.repro_heap_apply(
            keys.data_ptr(), vals.data_ptr(), size.data_ptr(), *common,
            outk.data_ptr(), outv.data_ptr(), ok.data_ptr(),
            nsize.data_ptr(), b, cap_log2, arity_log2,
            max_depth(cap_log2, arity_log2), _build.stream_of(keys)),
            "heap_apply")
        _build.LAUNCHES["heap_apply"] += 1
    else:
        _build.check(lib.repro_heap_apply_rider(
            keys.data_ptr(), vals.data_ptr(), rider.data_ptr(),
            size.data_ptr(), *common, opr.data_ptr(), outk.data_ptr(),
            outv.data_ptr(), out[7].data_ptr(), ok.data_ptr(),
            nsize.data_ptr(), b, cap_log2, arity_log2,
            max_depth(cap_log2, arity_log2), int(opr.numel() != 1),
            _build.stream_of(keys)), "heap_apply (rider)")
        _build.LAUNCHES["heap_apply_rider"] += 1
    return out


# ---------------------------------------------------------------------------
# functional face with a rider plane — the mesh engines' partial waves
# ---------------------------------------------------------------------------


def heap_planes(keys, vals, size, ops, opkeys, opvals, *, cap_log2: int,
                arity_log2: int = 2, rider=None, oprider=None):
    """Apply a batch of heap ops in batch order on NEW planes (the inputs
    are not changed): ``heap_apply`` on copies, so a CUDA tensor launches
    the kernel.  Returns ``(keys, vals, new_size, out_keys, out_vals,
    ok)``.

    ``rider`` is an optional second (cap,) value plane that moves in
    lockstep with ``vals`` through every sift (the span layer's
    birth-stamp plane); ``oprider`` is the rider value INSERT lanes
    install (scalar or (B,); 0 when omitted).  With a rider the tuple
    grows to ``(..., ok, rider, out_rider)``."""
    dev = keys.device
    ops, opkeys, opvals = (torch.as_tensor(x, device=dev).to(torch.int32)
                           for x in (ops, opkeys, opvals))
    return heap_apply(keys.clone(), vals.clone(), size, ops, opkeys, opvals,
                      cap_log2=cap_log2, arity_log2=arity_log2,
                      rider=None if rider is None else rider.clone(),
                      oprider=oprider)


def heap_pop_count(keys, vals, size, count, *, batch: int, cap_log2: int,
                   arity_log2: int = 2, rider=None):
    """Pop the ``count`` smallest (key, val) pairs through a ``batch``-wide
    wave whose lanes ``>= count`` are ``OP_NOP``.  Returns the
    ``heap_planes`` tuple; ``ok[i] = i < min(count, size)``."""
    lane = torch.arange(batch, dtype=torch.int32, device=keys.device)
    count = torch.as_tensor(count, dtype=torch.int32, device=keys.device)
    ops = torch.where(lane < count, OP_DELMIN, OP_NOP).int()
    pad = torch.full((batch,), KEY_INF, dtype=torch.int32,
                     device=keys.device)
    return heap_planes(keys, vals, size, ops, pad, pad, cap_log2=cap_log2,
                       arity_log2=arity_log2, rider=rider)


def heap_insert_masked(keys, vals, size, inkeys, invals, mask, *,
                       cap_log2: int, arity_log2: int = 2, rider=None,
                       oprider=None) -> Tuple[torch.Tensor, ...]:
    """Install the masked subset of a (key, val) wave in lane order
    (masked-out lanes are ``OP_NOP``).  Returns the ``heap_planes``
    tuple; with a rider, applied lanes install ``oprider``."""
    ops = torch.where(torch.as_tensor(mask).bool(), OP_INSERT, OP_NOP).int()
    return heap_planes(keys, vals, size, ops, inkeys, invals,
                       cap_log2=cap_log2, arity_log2=arity_log2,
                       rider=rider, oprider=oprider)


# ---------------------------------------------------------------------------
# the shard grid — S heaps, one wave, the priority mesh rounds' waves
# ---------------------------------------------------------------------------

_POP_COUNT, _MASKED_INSERT = 1, 2       # modes of csrc/heap_batch.cu's grid


def _grid_mode(name, keys, vals, sizes, counts, batch, opkeys, opvals, dest,
               cap_log2, arity_log2, rider):
    """Check a grid call and return its mode and shard count."""
    pop = counts is not None
    if pop == (dest is not None) or pop == (opkeys is not None):
        raise ValueError(f"{name}: give counts= and batch= (a pop wave) or "
                         f"opkeys=, opvals= and dest= (an insert wave)")
    if arity_log2 < 1:
        raise ValueError(f"{name}: arity_log2={arity_log2} must be >= 1 "
                         f"(the heap's levels divide by it)")
    if not 0 < cap_log2 <= 30:
        raise ValueError(f"{name}: cap_log2={cap_log2} out of range")
    s = keys.shape[0] if keys.dim() == 2 else -1
    for p in (keys, vals) + (() if rider is None else (rider,)):
        if p.shape != (s, 1 << cap_log2):
            raise ValueError(f"{name}: planes must be (S, 2^{cap_log2}), "
                             f"got {tuple(p.shape)}")
    if sizes.shape != (s,):
        raise ValueError(f"{name}: sizes must be ({s},), got "
                         f"{tuple(sizes.shape)}")
    if pop:
        if counts.shape != (s,) or batch is None or batch < 0:
            raise ValueError(f"{name}: a pop wave takes counts ({s},) and "
                             f"batch >= 0")
    else:
        for t in (opvals, dest):
            if t is None or t.dim() != 1 or t.shape != opkeys.shape:
                raise ValueError(f"{name}: opkeys/opvals/dest must be (N,)")
    return (_POP_COUNT if pop else _MASKED_INSERT), s


def heap_apply_grid_plain(keys, vals, sizes, *, counts=None, batch=None,
                          opkeys=None, opvals=None, dest=None,
                          cap_log2: int, arity_log2: int = 2, rider=None,
                          oprider=None):
    """Plain ``heap_apply_grid``: ``_apply_serial`` on each shard's heap in
    shard order, on host copies (views, for CPU tensors) written back in
    place.  The return tuples are ``heap_apply_grid``'s."""
    mode, s = _grid_mode("heap_apply_grid", keys, vals, sizes, counts,
                         batch, opkeys, opvals, dest, cap_log2, arity_log2,
                         rider)
    dev = keys.device
    planes = (keys, vals) + (() if rider is None else (rider,))
    host = [p if p.device.type == "cpu" else p.cpu() for p in planes]
    arrays = [h.numpy() for h in host]
    size_l = sizes.tolist()
    i32 = dict(dtype=torch.int32, device=dev)
    if mode == _POP_COUNT:
        outs = [[], [], [], []]
        for sh, c in enumerate(counts.tolist()):
            ops = [OP_DELMIN if i < c else OP_NOP for i in range(batch)]
            pad = [KEY_INF] * batch
            size_l[sh], outk, outv, ok = _apply_serial(
                arrays[0][sh], [a[sh] for a in arrays[1:]], size_l[sh], ops,
                pad, [pad] * len(arrays[1:]), cap_log2, arity_log2)
            for o, x in zip(outs, [outk, outv[0], ok]
                            + ([outv[1]] if rider is not None else [])):
                o.append(x)
    else:
        d = dest.tolist()
        keys_l, vals_l = opkeys.tolist(), opvals.tolist()
        opr = torch.broadcast_to(_oprider(oprider, opkeys),
                                 opkeys.shape).tolist()
        for sh in range(s):
            lanes = [i for i, x in enumerate(d) if x == sh]
            opv = [[vals_l[i] for i in lanes]]
            if rider is not None:
                opv.append([opr[i] for i in lanes])
            size_l[sh] = _apply_serial(
                arrays[0][sh], [a[sh] for a in arrays[1:]], size_l[sh],
                [OP_INSERT] * len(lanes), [keys_l[i] for i in lanes], opv,
                cap_log2, arity_log2)[0]
    for p, h in zip(planes, host):
        if p is not h:
            p.copy_(h)
    sizes.copy_(torch.tensor(size_l, dtype=torch.int32))
    if mode == _MASKED_INSERT:
        return (keys, vals, sizes) + (() if rider is None else (rider,))
    outk, outv, ok = (torch.tensor(o, **i32).reshape(s, batch)
                      for o in outs[:3])
    out = (keys, vals, sizes, outk, outv, ok.bool())
    if rider is None:
        return out
    return out + (rider, torch.tensor(outs[3], **i32).reshape(s, batch))


def heap_apply_grid(keys, vals, sizes, *, counts=None, batch=None,
                    opkeys=None, opvals=None, dest=None, cap_log2: int,
                    arity_log2: int = 2, rider=None, oprider=None):
    """One wave on S heaps, IN PLACE: ``keys``/``vals`` (and ``rider``)
    are (S, 2^cap_log2) int32 planes, heap s in row s, and ``sizes`` (S,)
    int32 their sizes, updated in place.

    * Pop wave (``counts`` (S,) int32, ``batch``): heap s takes
      ``min(counts[s], sizes[s])`` DELETE-MINs (reference
      ``heap_pop_count`` on each shard).  Returns ``(keys, vals, sizes,
      out_keys, out_vals, ok)``, the outputs ``(S, batch)``, with a rider
      also ``(rider, out_rider)``.
    * Insert wave (``opkeys``/``opvals``/``dest`` (N,) int32): heap s
      installs, in lane order, the lanes whose ``dest`` is s (-1 goes
      nowhere; reference ``heap_insert_masked`` with the mask ``dest ==
      s``); with a rider the lanes install ``oprider`` (one int32, a 0-d
      device tensor to keep the call free of copies, or (N,)).  Returns
      ``(keys, vals, sizes)``, with a rider also ``rider``.

    A CPU tensor goes to ``heap_apply_grid_plain``; a CUDA tensor launches
    ``csrc/heap_batch.cu``'s grid (one block a heap) or raises.  Nothing
    is read back.  Arities as ``heap_apply``: any ``arity_log2 >= 1``."""
    kw = dict(counts=counts, batch=batch, opkeys=opkeys, opvals=opvals,
              dest=dest, cap_log2=cap_log2, arity_log2=arity_log2,
              rider=rider, oprider=oprider)
    if keys.device.type == "cpu":
        return heap_apply_grid_plain(keys, vals, sizes, **kw)
    lanes = ((counts,) if counts is not None
             else tuple(t for t in (opkeys, opvals, dest) if t is not None))
    _build.require_cuda("heap_apply_grid", keys, vals, sizes, *lanes,
                        *(() if rider is None else (rider,)))
    mode, s = _grid_mode("heap_apply_grid", keys, vals, sizes, counts,
                         batch, opkeys, opvals, dest, cap_log2, arity_log2,
                         rider)
    dev = keys.device
    b = batch if mode == _POP_COUNT else opkeys.shape[0]
    out = (keys, vals, sizes)
    opr, stride = None, 0
    if mode == _POP_COUNT:
        outs = [torch.empty((s, b), dtype=torch.int32, device=dev)
                for _ in range(2 + (rider is not None))] + [None]
        okm = torch.empty((s, b), dtype=torch.bool, device=dev)
        out += (outs[0], outs[1], okm)
        if rider is not None:
            out += (rider, outs[2])
        sel = counts
    else:
        outs, okm, sel = [None] * 3, None, dest
        if rider is not None:
            opr = _oprider(oprider, opkeys)
            _build.require_cuda("heap_apply_grid", opr)
            if opr.numel() not in (1, b):
                raise ValueError("heap_apply_grid: oprider must be one int32 "
                                 "or (N,)")
            stride = int(opr.numel() != 1)
            out += (rider,)
    if b == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.check(_build.library("heap_batch").repro_heap_apply_grid(
        keys.data_ptr(), vals.data_ptr(), ptr(rider), sizes.data_ptr(),
        sel.data_ptr(), ptr(opkeys), ptr(opvals), ptr(opr), ptr(outs[0]),
        ptr(outs[1]), ptr(outs[2]), ptr(okm), s, b, cap_log2, arity_log2,
        max_depth(cap_log2, arity_log2), mode, stride,
        _build.stream_of(keys)), "heap_apply_grid")
    _build.LAUNCHES["heap_apply_grid" if rider is None
                    else "heap_apply_grid_rider"] += 1
    return out
