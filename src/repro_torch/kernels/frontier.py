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
* ``frontier_level`` / ``frontier_level_plain`` — the same two that also
  return the number of edges the level scanned, as a (1,) int32 tensor
  on the frontier's device: nothing is read back.

Both update ``visited`` IN PLACE and return it; the Pallas kernel copies
the (n,) map every level.  The card's version keeps the sequential
discovery order with a parallel design in three launches: a look-back
scan of the frontier's degrees numbers every scanned edge by its place p
in the sequential (frontier order, CSR order) stream; an ``atomicMin``
per unvisited target (one per warp and target) leaves the first p of
each vertex in an (n,) scratch plane; the edge whose p it is is fresh,
and a look-back scan of the fresh flags ranks and writes them.  The edge
grid is sized from the card and reads the level's edge count from device
memory, so the wrapper reads nothing back.

A caller that expands many levels keeps two things across them: the
kernel's scratch (``frontier_scratch``), which every call leaves ready
for the next, and output buffers (``frontier_buffer``): (max_out + 1,)
int32, -1 but for the prefix the buffer's last use wrote, whose length
its last word holds.  A call resets that prefix and writes the new one,
so a kept buffer costs no O(max_out) fill per level; the frontier it
returns is the buffer's first ``max_out`` words, -1-padded as the
contract says.  The frontier handed in must not lie in the output
buffer.
"""

from __future__ import annotations

import torch

from . import _build

INT_MAX = 2 ** 31 - 1
#: frontier slots per tile of the offsets launch (``kOffTile``)
OFF_TILE = 2048
#: status words of the emit launch (``kEmitTiles``)
EMIT_TILES = 32768
#: int32 words of ``FrontierState`` before its status words
STATE_WORDS = 12


def _state_offset(n: int) -> int:
    return n + (n & 1)                 # 8-byte aligned after first[]


def frontier_scratch(n: int, device, max_frontier=None) -> torch.Tensor:
    """The kernel's int32 workspace for a graph of ``n`` vertices and
    frontiers of up to ``max_frontier`` slots (``n`` when omitted): an
    (n,) plane of ``INT_MAX``, then counters and look-back status words,
    all zero.  Every call leaves it so, so a caller that expands many
    levels of one graph allocates it once and passes it as
    ``scratch=``."""
    f = max(n if max_frontier is None else int(max_frontier), 1)
    words = (_state_offset(n) + STATE_WORDS
             + 2 * (EMIT_TILES + -(-f // OFF_TILE)))
    t = torch.zeros(words, dtype=torch.int32, device=device)
    t[:n] = INT_MAX
    return t


def frontier_buffer(max_out: int, device) -> torch.Tensor:
    """A kept output buffer: (max_out + 1,) int32, all -1 but its last
    word, the length of the prefix a call wrote (0 here)."""
    t = torch.full((max_out + 1,), -1, dtype=torch.int32, device=device)
    t[max_out] = 0
    return t


def _check(name, row_ptr, col_idx, frontier, visited, max_out):
    for t in (row_ptr, col_idx, frontier, visited):
        if t.dim() != 1:
            raise ValueError(f"{name}: every array must be 1-D")
    if row_ptr.shape[0] != visited.shape[0] + 1:
        raise ValueError(f"{name}: row_ptr must be (n+1,) for visited (n,)")
    if max_out < 1:
        raise ValueError(f"{name}: max_out={max_out} must be positive")


def _check_buffer(out, max_out):
    if out.dim() != 1 or out.shape[0] != max_out + 1:
        raise ValueError(f"frontier_expand: out must be frontier_buffer("
                         f"{max_out}), (max_out + 1,), got "
                         f"{tuple(out.shape)}")


def _plain_level(row_ptr, col_idx, frontier, visited, max_out, out=None):
    """Plain PyTorch level: gather the frontier's edges in stream order,
    keep the first unvisited occurrence of each target (scatter-min of the
    stream position), rank the fresh edges with a cumsum and scatter them,
    the overflow ones to the last slot.  Writes ``out`` (a kept buffer,
    or a new one) as the kernel does.  Returns ``frontier_level``'s
    tuple."""
    _check("frontier_expand", row_ptr, col_idx, frontier, visited, max_out)
    dev, n = visited.device, visited.shape[0]
    if out is None:
        out = frontier_buffer(max_out, dev)
    _check_buffer(out, max_out)
    out[:int(out[max_out])] = -1       # the prefix the last use wrote
    nxt = out[:max_out]
    f = frontier.long()
    valid = f >= 0
    fu = f.clamp(min=0)
    start = torch.where(valid, row_ptr.long()[fu], 0)
    deg = torch.where(valid, row_ptr.long()[fu + 1] - start, 0)
    e = int(deg.sum())
    edges = torch.tensor([e], dtype=torch.int32, device=dev)
    if e == 0:
        out[max_out] = 0
        return (nxt, torch.zeros(1, dtype=torch.int32, device=dev), visited,
                edges)
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
    nxt[pos[keep]] = v[keep].int()
    out[max_out] = min(int(count), max_out)
    visited[v] = 1
    return nxt, count.reshape(1).int(), visited, edges


def frontier_expand_plain(row_ptr, col_idx, frontier, visited, *,
                          max_out: int, out=None):
    """Plain PyTorch ``frontier_expand``."""
    return _plain_level(row_ptr, col_idx, frontier, visited, max_out,
                        out)[:3]


def frontier_level_plain(row_ptr, col_idx, frontier, visited, *,
                         max_out: int, out=None):
    """Plain PyTorch ``frontier_level``."""
    return _plain_level(row_ptr, col_idx, frontier, visited, max_out, out)


def frontier_expand(row_ptr, col_idx, frontier, visited, *, max_out: int,
                    scratch=None, out=None):
    """One BFS level.  ``row_ptr`` (n+1,), ``col_idx`` (E,), ``frontier``
    (F,) with -1 slots skipped, ``visited`` (n,) int32 0/1, all int32.
    Returns ``(next_frontier (max_out,) padded -1, count (1,) int32,
    visited)`` with ``visited`` updated IN PLACE.  ``scratch`` is the
    kernel's workspace from ``frontier_scratch`` and ``out`` a kept
    output buffer from ``frontier_buffer``; each is allocated here when
    omitted (the plain version needs no scratch)."""
    return frontier_level(row_ptr, col_idx, frontier, visited,
                          max_out=max_out, scratch=scratch, out=out)[:3]


def frontier_level(row_ptr, col_idx, frontier, visited, *, max_out: int,
                   scratch=None, out=None):
    """``frontier_expand`` plus the number of edges the level scanned, a
    (1,) int32 tensor on the frontier's device: ``(next_frontier, count,
    visited, edges)``.  On the card: three launches, nothing read back."""
    if frontier.device.type == "cpu":
        return _plain_level(row_ptr, col_idx, frontier, visited, max_out,
                            out)
    _build.require_cuda("frontier_expand", row_ptr, col_idx, frontier,
                        visited)
    _check("frontier_expand", row_ptr, col_idx, frontier, visited, max_out)
    dev, n, f = visited.device, visited.shape[0], frontier.shape[0]
    if scratch is None:
        scratch = frontier_scratch(n, dev, max_frontier=f)
    if out is None:
        out = frontier_buffer(max_out, dev)
    _build.require_cuda("frontier_expand", scratch, out)
    _check_buffer(out, max_out)
    off = _state_offset(n)
    tiles1 = (scratch.shape[0] - off - STATE_WORDS) // 2 - EMIT_TILES
    if scratch.dim() != 1 or tiles1 * OFF_TILE < max(f, 1):
        raise ValueError(f"frontier_expand: scratch must be frontier_scratch"
                         f"(n, device, max_frontier >= {f}) for n = {n}")
    count = torch.empty(1, dtype=torch.int32, device=dev)
    edges = torch.empty(1, dtype=torch.int32, device=dev)
    if f == 0:
        out.fill_(-1)
        out[max_out] = 0
        count.zero_()
        edges.zero_()
        return out[:max_out], count, visited, edges
    work = torch.empty(2 * f, dtype=torch.int32, device=dev)
    _build.check(_build.library("frontier").repro_frontier_level(
        row_ptr.data_ptr(), col_idx.data_ptr(), frontier.data_ptr(),
        visited.data_ptr(), scratch.data_ptr(),
        scratch.data_ptr() + 4 * off,
        work.data_ptr(), out.data_ptr(), count.data_ptr(), edges.data_ptr(),
        f, max_out, tiles1, _build.stream_of(visited)), "frontier_expand")
    _build.LAUNCHES["frontier_expand"] += 1
    return out[:max_out], count, visited, edges
