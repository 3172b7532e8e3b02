"""BFS frontier expansion (paper § V-B-a) — the PyTorch twin of
``repro/kernels/frontier.py`` and of ``frontier_expand`` in
``repro/kernels/ops.py``.

One level of level-synchronous BFS: for each frontier vertex in order
(slots of -1 are skipped), scan its CSR neighbours in CSR order; every
scanned neighbour is marked visited, and each one that was unvisited
takes the next ticket of the next frontier (discovery order).  The
semantics are the Pallas kernel's, including its overflow rule: a fresh
vertex whose ticket is ``>= max_out - 1`` is written to the last slot,
so the last fresh vertex of the level wins it, and the count is the true
count.  (``ref.frontier_expand_ref`` follows the reference oracle, which
drops those tickets instead.)

* ``frontier_expand`` — the wrapper.  A CPU tensor goes to the plain
  version; a CUDA tensor launches the kernels of ``csrc/frontier.cu`` or
  raises.  There is no ``use_kernel`` switch: the device decides.
* ``frontier_expand_plain`` — the same level in vectorised PyTorch.
* ``frontier_level`` — ``frontier_expand`` that also returns the number
  of edges the level scanned, as a host int: both faces know it on the
  host already (the card's wrapper reads it back to size its grid).

Both update ``visited`` IN PLACE and return it; the Pallas kernel copies
the (n,) map every level.  The card's version keeps the sequential
discovery order with a parallel design: a scan of the frontier's
degrees numbers every scanned edge by its place p in the sequential
(frontier order, CSR order) stream; an ``atomicMin`` per unvisited
target leaves the first p of each vertex in an (n,) scratch plane; the
edge whose p it is is fresh; a block-ordered scan of the fresh flags
ranks them.  The wrapper reads back one integer per call, the level's
edge count, to size the edge grid.
"""

from __future__ import annotations

import torch

from . import _build

INT_MAX = 2 ** 31 - 1


def frontier_scratch(n: int, device) -> torch.Tensor:
    """The kernel's (n,) int32 workspace, all ``INT_MAX``.  Every call
    leaves it so, so a caller that expands many levels of one graph
    allocates it once and passes it as ``scratch=``."""
    return torch.full((n,), INT_MAX, dtype=torch.int32, device=device)


def _check(name, row_ptr, col_idx, frontier, visited, max_out):
    for t in (row_ptr, col_idx, frontier, visited):
        if t.dim() != 1:
            raise ValueError(f"{name}: every array must be 1-D")
    if row_ptr.shape[0] != visited.shape[0] + 1:
        raise ValueError(f"{name}: row_ptr must be (n+1,) for visited (n,)")
    if max_out < 1:
        raise ValueError(f"{name}: max_out={max_out} must be positive")


def _plain_level(row_ptr, col_idx, frontier, visited, max_out):
    """Plain PyTorch level: gather the frontier's edges in stream order,
    keep the first unvisited occurrence of each target (scatter-min of the
    stream position), rank the fresh edges with a cumsum and scatter them,
    the overflow ones to the last slot.  Returns ``frontier_level``'s
    tuple."""
    _check("frontier_expand", row_ptr, col_idx, frontier, visited, max_out)
    dev, n = visited.device, visited.shape[0]
    f = frontier.long()
    valid = f >= 0
    fu = f.clamp(min=0)
    start = torch.where(valid, row_ptr.long()[fu], 0)
    deg = torch.where(valid, row_ptr.long()[fu + 1] - start, 0)
    e = int(deg.sum())
    out = torch.full((max_out,), -1, dtype=torch.int32, device=dev)
    if e == 0:
        return out, torch.zeros(1, dtype=torch.int32, device=dev), visited, 0
    p = torch.arange(e, device=dev)
    slot_start = torch.repeat_interleave(torch.cumsum(deg, 0) - deg, deg)
    v = col_idx.long()[torch.repeat_interleave(start, deg) + p - slot_start]
    unvisited = visited[v] == 0
    first = torch.full((n,), e, dtype=torch.long, device=dev)
    first.scatter_reduce_(0, v, torch.where(unvisited, p, e), "amin")
    fresh = unvisited & (first[v] == p)
    rank = torch.cumsum(fresh.long(), 0) - fresh.long()
    count = fresh.sum()
    keep = fresh & ((rank < max_out - 1) | (rank == count - 1))
    pos = torch.clamp(rank, max=max_out - 1)
    out[pos[keep]] = v[keep].int()
    visited[v] = 1
    return out, count.reshape(1).int(), visited, e


def frontier_expand_plain(row_ptr, col_idx, frontier, visited, *,
                          max_out: int):
    """Plain PyTorch ``frontier_expand``."""
    return _plain_level(row_ptr, col_idx, frontier, visited, max_out)[:3]


def frontier_expand(row_ptr, col_idx, frontier, visited, *, max_out: int,
                    scratch=None):
    """One BFS level.  ``row_ptr`` (n+1,), ``col_idx`` (E,), ``frontier``
    (F,) with -1 slots skipped, ``visited`` (n,) int32 0/1, all int32.
    Returns ``(next_frontier (max_out,) padded -1, count (1,) int32,
    visited)`` with ``visited`` updated IN PLACE.  ``scratch`` is the
    kernel's (n,) workspace from ``frontier_scratch`` (allocated here when
    omitted; the plain version needs none)."""
    return frontier_level(row_ptr, col_idx, frontier, visited,
                          max_out=max_out, scratch=scratch)[:3]


def frontier_level(row_ptr, col_idx, frontier, visited, *, max_out: int,
                   scratch=None):
    """``frontier_expand`` plus the number of edges the level scanned, a
    host int: ``(next_frontier, count, visited, edges)``."""
    if frontier.device.type == "cpu":
        return _plain_level(row_ptr, col_idx, frontier, visited, max_out)
    _build.require_cuda("frontier_expand", row_ptr, col_idx, frontier,
                        visited)
    _check("frontier_expand", row_ptr, col_idx, frontier, visited, max_out)
    dev, n, f = visited.device, visited.shape[0], frontier.shape[0]
    if scratch is None:
        scratch = frontier_scratch(n, dev)
    _build.require_cuda("frontier_expand", scratch)
    if scratch.shape != (n,):
        raise ValueError("frontier_expand: scratch must be (n,)")
    out = torch.full((max_out,), -1, dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    if f == 0:
        return out, count, visited, 0
    lib = _build.library("frontier")
    stream = _build.stream_of(visited)
    dcounts = torch.empty(-(-f // _build.BLOCK), dtype=torch.int32,
                          device=dev)
    offsets = torch.empty(f + 1, dtype=torch.int32, device=dev)
    _build.check(lib.repro_frontier_offsets(
        row_ptr.data_ptr(), frontier.data_ptr(), dcounts.data_ptr(),
        offsets.data_ptr(), f, stream), "frontier_expand")
    _build.LAUNCHES["frontier_expand"] += 1
    edges = int(offsets[f])          # sizes the edge grid: one readback
    if edges < 0:
        raise ValueError("frontier_expand: the level scans 2^31 edges or "
                         "more")
    if edges:
        fcounts = torch.empty(-(-edges // _build.BLOCK), dtype=torch.int32,
                              device=dev)
        _build.check(lib.repro_frontier_expand(
            row_ptr.data_ptr(), col_idx.data_ptr(), frontier.data_ptr(),
            offsets.data_ptr(), visited.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), count.data_ptr(), fcounts.data_ptr(), f, edges,
            max_out, stream), "frontier_expand")
    return out, count, visited, edges
