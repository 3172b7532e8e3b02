"""Carrying state between the JAX reference and the port as numpy arrays.

A test builds a ring, a heap, a graph or a model's parameters on either
side, hands it over as numpy arrays, and drives both packages from the
same state.  Nothing here imports JAX: the reference's arrays arrive as
``np.asarray(...)``.
"""

from __future__ import annotations

from typing import Any, Tuple

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


def _leaf_to_torch(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: same bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(dev)


def params_from_numpy(tree: Any, *, device="cuda") -> Any:
    """The reference's parameter tree (nested dicts and lists of numpy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``) as the port's: the
    same keys and shapes, each leaf a tensor on ``device``.  bfloat16
    leaves keep their bits."""
    dev = resolve_device(device)

    def go(node):
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(go(v) for v in node)
        return _leaf_to_torch(node, dev)
    return go(tree)


def params_to_numpy(tree: Any) -> Any:
    """The inverse of ``params_from_numpy``: every tensor to a numpy array
    on the host.  bfloat16 tensors become ``ml_dtypes.bfloat16`` arrays
    (the type JAX hands out), which needs the ``ml_dtypes`` package."""
    def go(node):
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(go(v) for v in node)
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return go(tree)
