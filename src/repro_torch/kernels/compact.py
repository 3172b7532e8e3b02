"""Device-side wave compaction — the PyTorch twin of
``repro/kernels/compact.py``.

The round engine builds each round's child wave ``batch × max_fanout``
lanes wide.  On power-law graphs almost every lane is masked out, so the
engine packs the live lanes densely, in lane order, before the install:

    rank   = exclusive prefix sum of the spawn mask
    dense[rank[i]] = plane[i]   for every active lane i with rank < width

The ranks are exactly ``wavefaa``'s ticket ranks, so the dense wave
installs with contiguous tickets ``tail + [0, count)``.  The count
returned is the TRUE popcount, not the clamped one: a wave whose live
children exceed the width must overflow its engine, and the true count
keeps that check exact.

``wave_compact`` launches the CUDA kernel in ``csrc/compact.cu`` for CUDA
tensors and runs the plain ``compact_planes`` for CPU tensors.  The kernel
ranks in one launch with a decoupled look-back over a small scratch of
per-tile status words (``compact_scratch``), which every call leaves zero:
a caller that compacts every round allocates it once and passes it.
"""

from __future__ import annotations

import torch

from . import _build
from .wavefaa import _check_mask


#: lanes per tile of the CUDA kernel (``kTileLanes`` in ``csrc/compact.cu``)
TILE_LANES = 8192


def compact_scratch_words(n: int) -> int:
    """int32 words of scratch for a wave of ``n`` lanes: a ticket and a
    done counter (and two spare words), then one 64-bit status word per
    tile."""
    return 4 + 2 * max(-(-int(n) // TILE_LANES), 1)


def compact_scratch(n: int, device) -> torch.Tensor:
    """The kernel's zeroed scratch for waves of up to ``n`` lanes.  Every
    call leaves it zero; calls that may run at once need their own."""
    return torch.zeros(compact_scratch_words(n), dtype=torch.int32,
                       device=device)


def compact_width(nlanes: int, bound: int, mode=None):
    """The dense-wave rule: the compact width for an ``nlanes``-wide
    sparse child wave on an engine that installs at most ``bound`` live
    children per round, or ``None`` when compaction should not engage.
    ``mode=False`` forces it off, ``mode=None`` (auto) engages only when
    the sparse wave is wider than the bound, ``mode=True`` forces it on
    with ``width = min(nlanes, bound)``."""
    if mode is False or nlanes == 0:
        return None
    w = min(int(nlanes), int(bound))
    if mode is None and int(nlanes) <= w:
        return None
    return max(w, 1)


def compact_planes(mask, planes, *, width: int):
    """Plain PyTorch ``wave_compact``.  ``mask``: (N,) bool or int32;
    ``planes``: tuple of (N,) int32.  Returns ``(dense, count)``: a tuple
    of (width,) int32 planes and the true popcount as a 0-d int32
    tensor."""
    _check_mask("compact_planes", mask)
    m = mask > 0
    rank = torch.cumsum(m.long(), 0) - m.long()
    keep = m & (rank < width)
    dst = rank[keep]
    dense = []
    for p in planes:
        d = torch.zeros(width, dtype=torch.int32, device=mask.device)
        d[dst] = p.to(torch.int32)[keep]
        dense.append(d)
    return tuple(dense), m.sum().to(torch.int32)


def wave_compact(mask, planes, *, width: int, scratch=None):
    """Ballot-compact ``planes`` by ``mask`` into (width,) dense waves.
    Same contract and results as ``compact_planes`` (rank >= width drops,
    TRUE popcount returned as a 0-d int32 device tensor).  Any N.  The
    kernel reads a bool mask: an int32 mask on the card is turned into
    ``mask > 0`` first.  ``scratch``: from ``compact_scratch`` for at
    least N lanes (allocated here, one memset, when None)."""
    if mask.device.type == "cpu":
        return compact_planes(mask, planes, width=width)
    _check_mask("wave_compact", mask)
    width = int(width)
    if width <= 0:
        raise ValueError(f"wave_compact: width={width} must be positive")
    n, k = mask.shape[0], len(planes)
    stacked = (planes[0].reshape(1, n) if k == 1
               else torch.stack(list(planes)))
    if scratch is None:
        scratch = compact_scratch(n, mask.device)
    _build.require_cuda("wave_compact", stacked, scratch)
    if (not mask.is_contiguous() or mask.device != stacked.device
            or stacked.shape != (k, n) or scratch.device != mask.device):
        raise ValueError("wave_compact: mask and planes must be contiguous "
                         "(N,) tensors on one card, with the scratch")
    if (scratch.dim() != 1 or scratch.data_ptr() % 8
            or scratch.numel() < compact_scratch_words(n)):
        raise ValueError(f"wave_compact: scratch must be compact_scratch(n) "
                         f"for n >= {n}")
    if mask.dtype != torch.bool:
        mask = mask > 0              # the kernel takes a bool mask
    dense = torch.empty((k, width), dtype=torch.int32, device=mask.device)
    count = torch.empty(1, dtype=torch.int32, device=mask.device)
    if n == 0:
        dense.zero_()
        count.zero_()
    else:
        lib = _build.library("compact")
        _build.check(lib.repro_wave_compact(
            mask.data_ptr(), stacked.data_ptr(), dense.data_ptr(),
            count.data_ptr(), scratch.data_ptr(), n, k, width,
            _build.stream_of(mask)),
            "wave_compact")
        _build.LAUNCHES["wave_compact"] += 1
    return tuple(dense.unbind(0)), count.reshape(())
