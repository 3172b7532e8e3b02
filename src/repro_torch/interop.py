"""Carrying state between the JAX reference and the port as numpy arrays.

A test builds a ring, a heap, a graph, a model's parameters or an
optimizer state on either side, hands it over as numpy arrays, and
drives both packages from the same state.  Nothing here imports JAX: the
reference's arrays arrive as ``np.asarray(...)``.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .apps.bfs import CSRGraph
from .core.distqueue import DistHeapState
from .distributed.sharding import shard
from .kernels._build import resolve_device
from .optim.adamw import OptState
from .runtime.fusedrounds import HeapState, RingState
from .tree import tree_leaves, tree_map


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


def dist_heap_state_from_numpy(keys, vals, size, *,
                               device="cuda") -> DistHeapState:
    """A ``DistHeapState`` on ``device`` from the reference's priority mesh
    planes: stacked ``(S, cap)`` keys and vals with ``(S,)`` sizes (the
    relaxed mesh, one heap a shard) or one ``(cap,)`` heap and its size
    (the strict mesh)."""
    dev = resolve_device(device)
    k, v = (torch.tensor(np.asarray(p, np.int32), device=dev)
            for p in (keys, vals))
    sz = torch.tensor(np.asarray(size, np.int32), device=dev)
    if k.shape != v.shape or k.dim() not in (1, 2) or \
            tuple(sz.shape) != tuple(k.shape[:-1]):
        raise ValueError("heap planes must be two (cap,) arrays and a size, "
                         "or two (S, cap) arrays and (S,) sizes")
    return DistHeapState(k, v, sz)


def dist_heap_state_to_numpy(st: DistHeapState):
    """(keys, vals, size, hints) as numpy int32 — the inverse of
    ``dist_heap_state_from_numpy`` plus the relaxed claim schedule's
    hints: each shard's least key (``KEY_INF`` when empty), which is what
    the relaxed engines carry between rounds; None for one heap."""
    keys, vals = st.keys.cpu().numpy(), st.vals.cpu().numpy()
    size = np.asarray(st.size.cpu().numpy() if isinstance(
        st.size, torch.Tensor) else st.size, np.int32)
    hints = keys.min(axis=1) if keys.ndim == 2 else None
    return keys, vals, size, hints


def csr_from_arrays(row_ptr, col_idx, name: str = "g") -> CSRGraph:
    """A port ``CSRGraph`` from CSR arrays (int32 copies)."""
    return CSRGraph(np.array(row_ptr, np.int32), np.array(col_idx, np.int32),
                    name)


def _leaf_to_torch(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    # (np.ascontiguousarray makes a 0-dim array 1-dim: reshape it back)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: same bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).reshape(a.shape).to(dev)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).reshape(
        a.shape).to(dev)


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


def opt_state_from_numpy(state: Any, *, device="cuda") -> OptState:
    """The reference's ``OptState`` (``jax.tree.map(np.asarray, state)``:
    master, m and v trees of float32 arrays and a 0-dim int32 step) as the
    port's, leaf by leaf on ``device``, each leaf in its own dtype."""
    master, m, v, step = state
    dev = resolve_device(device)
    trees = (params_from_numpy(t, device=dev) for t in (master, m, v))
    return OptState(*trees,
                    step=_leaf_to_torch(np.asarray(step, np.int32), dev))


def opt_state_to_numpy(state: OptState) -> Tuple[Any, Any, Any, np.ndarray]:
    """(master, m, v, step) as numpy trees and a 0-dim int32 array — the
    inverse of ``opt_state_from_numpy``; build the reference's state with
    ``OptState(*opt_state_to_numpy(s))`` on its side."""
    return (params_to_numpy(state.master), params_to_numpy(state.m),
            params_to_numpy(state.v), state.step.detach().cpu().numpy())


def opt_state_block_from_numpy(state: Any, specs: OptState, mesh, *,
                               rank=None, device="cuda") -> OptState:
    """Rank ``rank``'s blocks (this process's rank of the group-bound
    ``mesh`` by default) of the reference's ``OptState`` (as
    ``opt_state_from_numpy`` takes it) under the sanitized state specs
    ``specs`` (``launch.steps.state_pspecs``), over the data axes and
    "model" (a block cut on two dimensions under FSDP): each leaf cut on
    the host and copied to ``device``."""
    dev = resolve_device(device)
    whole = opt_state_from_numpy(state, device="cpu")
    leaves = [shard(x, sp, mesh, rank).clone().to(dev)
              for x, sp in zip(tree_leaves(whole), tree_leaves(specs))]
    it = iter(leaves)
    return tree_map(lambda x: next(it), whole)


def params_block_from_numpy(tree: Any, specs: Any, mesh, *, rank=None,
                            device="cuda") -> Any:
    """Rank ``rank``'s blocks (this process's rank of the group-bound
    ``mesh`` by default) of the reference's whole parameter tree (as
    ``params_from_numpy`` takes it) under the sanitized parameter specs
    (``models.param_specs`` through ``launch.steps.sanitize_pspecs``),
    over the data axes and "model": each leaf cut on the host and copied
    to ``device``."""
    dev = resolve_device(device)
    whole = params_from_numpy(tree, device="cpu")
    return tree_map(lambda x, sp: shard(x, sp, mesh, rank).clone().to(dev),
                    whole, specs)


def cache_block_from_numpy(cache: Any, specs: Any, mesh, *, rank=None,
                           device="cuda") -> Any:
    """Rank ``rank``'s blocks of the reference's decode cache (a list of
    per-layer {"k", "v"} numpy arrays, ``init_decode_cache``'s layout)
    under the sanitized ``launch.steps.cache_pspecs``."""
    dev = resolve_device(device)
    return [{k: shard(_leaf_to_torch(v, torch.device("cpu")), sp[k], mesh,
                      rank).clone().to(dev) for k, v in e.items()}
            for e, sp in zip(cache, specs)]
