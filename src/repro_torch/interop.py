"""Carrying state between the JAX reference and the port as numpy arrays.

A test builds a ring, a heap or a graph on either side, hands it over as numpy
arrays, and drives both packages from the same state.  Nothing here
imports JAX: the reference's arrays arrive as ``np.asarray(...)``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .apps.bfs import CSRGraph
from .kernels._build import resolve_device
from .runtime.fusedrounds import HeapState, RingState


def ring_state_from_numpy(cycles, safes, enqs, idxs, head, tail, *,
                          device="cuda") -> RingState:
    """A ``RingState`` on ``device`` from four (2n,) int32 planes and the
    head/tail tickets."""
    dev = resolve_device(device)
    planes = [torch.tensor(np.asarray(p, np.int32), device=dev)
              for p in (cycles, safes, enqs, idxs)]
    if len({p.shape for p in planes}) != 1 or planes[0].dim() != 1:
        raise ValueError("ring planes must be four (2n,) arrays")
    return RingState(*planes, int(head), int(tail))


def ring_state_to_numpy(st: RingState) -> Tuple[np.ndarray, ...]:
    """(cycles, safes, enqs, idxs, head, tail) with numpy int32 planes and
    int head/tail — the inverse of ``ring_state_from_numpy``."""
    planes = tuple(p.cpu().numpy() for p in st[:4])
    return (*planes, int(st.head), int(st.tail))


def heap_state_from_numpy(keys, vals, size, *, device="cuda") -> HeapState:
    """A ``HeapState`` on ``device`` from two (2^c,) int32 planes and the
    size."""
    dev = resolve_device(device)
    planes = [torch.tensor(np.asarray(p, np.int32), device=dev)
              for p in (keys, vals)]
    if planes[0].shape != planes[1].shape or planes[0].dim() != 1:
        raise ValueError("heap planes must be two (2^c,) arrays")
    return HeapState(*planes, int(size))


def heap_state_to_numpy(st: HeapState) -> Tuple[np.ndarray, np.ndarray, int]:
    """(keys, vals, size) with numpy int32 planes and an int size — the
    inverse of ``heap_state_from_numpy``."""
    return st.keys.cpu().numpy(), st.vals.cpu().numpy(), int(st.size)


def csr_from_arrays(row_ptr, col_idx, name: str = "g") -> CSRGraph:
    """A port ``CSRGraph`` from CSR arrays (int32 copies)."""
    return CSRGraph(np.array(row_ptr, np.int32), np.array(col_idx, np.int32),
                    name)
