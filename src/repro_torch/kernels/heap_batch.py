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
  back, so the round engine's predicated rounds stay on the card.
* ``heap_apply_plain`` — the same batch applied one op at a time on the
  host (a CUDA heap is copied off the card and back).  It is the CPU
  path and the kernel's oracle on the card.
* ``heap_planes`` — functional form (new planes) with an optional
  ``rider`` value plane that moves in lockstep with ``vals``, and
  ``heap_pop_count`` / ``heap_insert_masked`` on top of it: the partial
  waves of the priority mesh rounds.  Plain only, and for CPU tensors
  only: they have no kernel yet, and a CUDA tensor raises rather than
  going through the host.

``heap_apply`` and ``heap_apply_plain`` update ``keys``/``vals`` IN
PLACE and return them, as the ring wrappers do; the Pallas kernel copies
both planes per batch.  The card's kernel is one launch of one block
that applies the batch serially with the heap's top levels (up to 21,845
nodes 4-ary, 16,383 binary, 4,681 8-ary) and a window around its last
leaf held in up to 227 KB of shared memory, and writes them back at the
end.  The plain faces take any ``arity_log2 >= 1``; the kernel is built
for arity_log2 1, 2 and 3 and refuses the others by name.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import _build

KEY_INF = 2 ** 31 - 1    # empty-slot / inactive-lane key sentinel

OP_INSERT, OP_DELMIN, OP_NOP = 0, 1, -1

#: arities the kernel is built for and checked at (d = 2^arity_log2); the
#: plain faces take any ``arity_log2 >= 1``
ARITY_LOG2 = (1, 2, 3)


def max_depth(cap_log2: int, arity_log2: int) -> int:
    """The Pallas loops' fixed trip count: levels needed to cover 2^cap_log2
    nodes with arity 2^arity_log2, plus one."""
    return -(-cap_log2 // arity_log2) + 1


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


def _require_cpu(name, *tensors) -> None:
    """The functional faces run on the host only: refuse other devices."""
    for t in tensors:
        if t is not None and torch.as_tensor(t).device.type != "cpu":
            raise ValueError(f"{name}: has no kernel yet and takes CPU "
                             f"tensors only, got {torch.as_tensor(t).device}")


def heap_apply_plain(keys, vals, size, ops, opkeys, opvals, *, cap_log2: int,
                     arity_log2: int = 2):
    """Plain ``heap_apply``: the batch applied one op at a time, in place.
    Returns ``(keys, vals, new_size (0-d int32), out_keys, out_vals, ok
    (B,) bool)``."""
    nsize, outk, (outv,), ok = _host_apply(
        "heap_apply", keys, (vals,), size, ops, opkeys, (opvals,),
        cap_log2=cap_log2, arity_log2=arity_log2)
    return keys, vals, nsize, outk, outv, ok


def heap_apply(keys, vals, size, ops, opkeys, opvals, *, cap_log2: int,
               arity_log2: int = 2):
    """Apply a batch of heap ops in batch order, IN PLACE.  ``keys``/
    ``vals`` are (2^cap_log2,) int32 planes, ``size`` a one-element int32
    tensor (or an int), ``ops``/``opkeys``/``opvals`` (B,) int32.  Returns
    ``(keys, vals, new_size, out_keys, out_vals, ok)``: ``new_size`` a
    0-d int32 tensor on the planes' device, ``out_*[i]`` the DELETE-MIN
    results (``KEY_INF`` / -1 elsewhere), ``ok[i]`` (bool) whether op i
    applied.  On the card nothing is read back."""
    if keys.device.type == "cpu":
        return heap_apply_plain(keys, vals, size, ops, opkeys, opvals,
                                cap_log2=cap_log2, arity_log2=arity_log2)
    size = torch.as_tensor(size, dtype=torch.int32,
                           device=keys.device).reshape(1)
    _build.require_cuda("heap_apply", keys, vals, size, ops, opkeys, opvals)
    _check_planes("heap_apply", keys, (vals,), ops, opkeys, opvals,
                  cap_log2, arity_log2)
    if arity_log2 not in ARITY_LOG2:
        raise ValueError(f"heap_apply: the kernel is built for arity_log2 "
                         f"in {ARITY_LOG2}, got arity_log2={arity_log2} "
                         f"(a {1 << arity_log2}-ary heap)")
    b = ops.shape[0]
    dev = keys.device
    outk = torch.empty(b, dtype=torch.int32, device=dev)
    outv = torch.empty(b, dtype=torch.int32, device=dev)
    ok = torch.empty(b, dtype=torch.bool, device=dev)
    nsize = torch.empty((), dtype=torch.int32, device=dev)
    if b == 0:
        nsize.copy_(size.reshape(()))
        return keys, vals, nsize, outk, outv, ok
    lib = _build.library("heap_batch")
    _build.check(lib.repro_heap_apply(
        keys.data_ptr(), vals.data_ptr(), size.data_ptr(), ops.data_ptr(),
        opkeys.data_ptr(), opvals.data_ptr(), outk.data_ptr(),
        outv.data_ptr(), ok.data_ptr(), nsize.data_ptr(), b, cap_log2,
        arity_log2, max_depth(cap_log2, arity_log2),
        _build.stream_of(keys)), "heap_apply")
    _build.LAUNCHES["heap_apply"] += 1
    return keys, vals, nsize, outk, outv, ok


# ---------------------------------------------------------------------------
# functional face with a rider plane — the mesh engines' partial waves
# ---------------------------------------------------------------------------


def heap_planes(keys, vals, size, ops, opkeys, opvals, *, cap_log2: int,
                arity_log2: int = 2, rider=None, oprider=None):
    """Apply a batch of heap ops in batch order on NEW planes (the inputs
    are not changed).  Same results as ``heap_apply``.  Returns ``(keys,
    vals, new_size, out_keys, out_vals, ok)``.

    ``rider`` is an optional second (cap,) value plane that moves in
    lockstep with ``vals`` through every sift (the span layer's
    birth-stamp plane); ``oprider`` is the rider value INSERT lanes
    install (scalar or (B,); 0 when omitted).  With a rider the tuple
    grows to ``(..., ok, rider, out_rider)``.  CPU tensors only."""
    _require_cpu("heap_planes", keys, vals, size, ops, opkeys, opvals, rider,
                 oprider)
    ops = torch.as_tensor(ops).to(torch.int32)
    vplanes = [vals.clone()]
    opvals_t = [torch.as_tensor(opvals).to(torch.int32)]
    if rider is not None:
        vplanes.append(rider.clone())
        opr = (torch.zeros_like(ops) if oprider is None
               else torch.broadcast_to(torch.as_tensor(
                   oprider, dtype=torch.int32, device=ops.device),
                   ops.shape))
        opvals_t.append(opr)
    keys = keys.clone()
    nsize, outk, outvs, ok = _host_apply(
        "heap_planes", keys, vplanes, size, ops,
        torch.as_tensor(opkeys).to(torch.int32), opvals_t,
        cap_log2=cap_log2, arity_log2=arity_log2)
    if rider is None:
        return keys, vplanes[0], nsize, outk, outvs[0], ok
    return (keys, vplanes[0], nsize, outk, outvs[0], ok, vplanes[1],
            outvs[1])


def heap_pop_count(keys, vals, size, count, *, batch: int, cap_log2: int,
                   arity_log2: int = 2, rider=None):
    """Pop the ``count`` smallest (key, val) pairs through a ``batch``-wide
    wave whose lanes ``>= count`` are ``OP_NOP``.  Returns the
    ``heap_planes`` tuple; ``ok[i] = i < min(count, size)``.  CPU tensors
    only."""
    _require_cpu("heap_pop_count", keys, vals, size, count, rider)
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
    tuple; with a rider, applied lanes install ``oprider``.  CPU tensors
    only."""
    _require_cpu("heap_insert_masked", keys, vals, size, inkeys, invals,
                 mask, rider, oprider)
    ops = torch.where(torch.as_tensor(mask).bool(), OP_INSERT, OP_NOP).int()
    return heap_planes(keys, vals, size, ops, inkeys, invals,
                       cap_log2=cap_log2, arity_log2=arity_log2,
                       rider=rider, oprider=oprider)
