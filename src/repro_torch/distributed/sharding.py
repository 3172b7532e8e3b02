"""The data axis across ranks: what GSPMD does for the reference's
sharded train step, written out for the port.

The reference lays parameters, optimizer state and batches over a
``jax`` mesh by PartitionSpecs (``repro/models/*: *_specs``,
``repro/launch/steps.py``) and leaves the collectives to GSPMD.  The port
runs one rank a shard of the data-parallel axes (``make_mesh(...,
group=)``, ``"pod"`` and ``"data"``) and issues them itself:

* ``P`` — the port's PartitionSpec: one entry a dimension (None, an axis
  name or a tuple of names), normalised as ``jax.sharding.PartitionSpec``
  normalises (a one-name tuple becomes the name, an empty one None).  It
  is not a tuple, so ``repro_torch.tree`` takes it as a leaf.
* ``data_dim`` — the dimension a (sanitized) spec shards over the
  data-parallel axes, or None for a leaf every rank holds whole.  A
  ``"model"`` axis above 1 (tensor, expert and sequence parallelism) is
  refused by name.
* ``shard`` — rank r's block of a leaf; ``unshard_tree`` — a tree of
  blocks whole again on every rank, in one collective (``gather_rows``).
* ``gather`` — every rank's blocks of some leaves into whole leaves, as an
  autograd Function: one all-gather in the forward, and in the backward
  one reduce-scatter: each rank sends rank j the j-th block of its
  gradients of the whole leaves (one all-to-all) and sums the blocks it
  gets.  When every rank holds the whole batch (``summed=False``) each
  rank's gradient is already the whole one, and the backward takes its
  block with no collective.
* ``all_reduce_`` — the sum over the ranks in place (replicated leaves'
  gradients, the loss and the norm).

The gradients are reduced in float32: the ranks' terms travel in the
leaf's own type (bfloat16 in training), a rank adds the S terms of its
block in float32 on its device and rounds the sum once back to the
leaf's type; a replicated leaf's gradient is cast to float32 and
all-reduced (``launch.train``).  The gathers and the all-to-alls move
bytes, so nothing is rounded on the way.  Over NCCL the buffers stay on
the card; over gloo each goes through the host, as
``collectives._reduce`` does.  ``COLLECTIVES`` counts ``all_gather``,
``reduce_scatter`` and ``reduce`` (an all-reduce).  Importing this
module starts no process group.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_map
from .collectives import (COLLECTIVES, Mesh, gather_rows, host_copy,
                          host_empty)

#: the mesh axes the batch and the FSDP shards are laid over
DP_AXES = ("pod", "data")


def _norm(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


class P:
    """PartitionSpec: ``P(None, "data")`` shards dimension 1 over
    ``"data"``; ``P(("pod", "data"), None)`` dimension 0 over both.
    Equal to another ``P`` or a tuple with the same entries."""
    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(_norm(p) for p in parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self):
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other):
        if isinstance(other, P):
            return self._parts == other._parts
        if isinstance(other, tuple):
            return self._parts == tuple(_norm(p) for p in other)
        return NotImplemented

    def __hash__(self):
        return hash(self._parts)

    def __repr__(self):
        return f"P{self._parts!r}" if len(self) != 1 else \
            f"P({self._parts[0]!r})"


def is_spec(x) -> bool:
    return isinstance(x, P)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def data_dim(spec: P, mesh: Mesh) -> Optional[int]:
    """The dimension ``spec`` shards over the mesh's data-parallel axes
    (None when it names none of size above 1).  Raises on a ``"model"``
    axis above 1, which the port does not shard over."""
    sizes = mesh.shape
    dim = None
    for i, entry in enumerate(spec):
        for a in _axes(entry):
            if a not in sizes:
                raise ValueError(f"spec {spec!r} names axis {a!r}, which the "
                                 f"mesh {sizes} does not have")
            if sizes[a] <= 1:
                continue
            if a not in DP_AXES:
                raise ValueError(
                    f"spec {spec!r} shards over {a!r} of size {sizes[a]}: "
                    f"the port shards over the data axis only (tensor, "
                    f"expert and sequence parallelism over \"model\" are "
                    f"not ported)")
            if dim is not None and dim != i:
                raise ValueError(f"spec {spec!r} shards two dimensions over "
                                 f"the data axis")
            dim = i
    return dim


def leaf_dims(tree: Any, specs: Any, mesh: Mesh) -> list:
    """``data_dim`` of each leaf of ``tree`` (in ``tree_leaves`` order),
    its spec found by key in ``specs``."""
    return tree_leaves(tree_map(lambda x, s: data_dim(s, mesh), tree,
                                specs))


def dp_size(mesh: Mesh) -> int:
    """Shards of the data-parallel axes."""
    n = 1
    for a in DP_AXES:
        n *= mesh.shape.get(a, 1)
    return n


def check_mesh(mesh: Mesh) -> None:
    """A mesh the port trains over: its ranks are the data-parallel
    shards, and no other axis has more than one."""
    for a, s in mesh.shape.items():
        if a not in DP_AXES and s > 1:
            raise ValueError(
                f"mesh {mesh.shape}: axis {a!r} has {s} shards; the port "
                f"shards over the data axis only (tensor, expert and "
                f"sequence parallelism over \"model\" are not ported)")


def _rank(mesh: Mesh) -> int:
    r = mesh.rank
    if r is None:
        raise ValueError("the mesh has no process group: a shard is a rank "
                         "of make_mesh(..., group=)")
    return r


def shard(x: torch.Tensor, spec: P, mesh: Mesh, rank: Optional[int] = None):
    """Rank ``rank``'s block of ``x`` under ``spec`` (this process's rank
    by default): a view, or ``x`` itself for a replicated leaf."""
    dim = data_dim(spec, mesh)
    if dim is None:
        return x
    n = dp_size(mesh)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split "
                         f"into {n} shards: sanitize the spec first")
    r = _rank(mesh) if rank is None else rank
    blk = x.shape[dim] // n
    return x.narrow(dim, r * blk, blk)


def unshard_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """Every rank's blocks of ``tree`` back into whole leaves, on every
    rank: one collective (``gather_rows``) for the sharded leaves; a
    replicated leaf is this rank's own."""
    leaves, dims = tree_leaves(tree), leaf_dims(tree, specs, mesh)
    sharded = [x for x, d in zip(leaves, dims) if d is not None]
    rows = iter(gather_rows(sharded, mesh)) if sharded else iter(())
    whole = [x if d is None else next(rows).movedim(0, d).flatten(d, d + 1)
             for x, d in zip(leaves, dims)]
    it = iter(whole)
    return tree_map(lambda x: next(it), tree)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _gloo(mesh: Mesh) -> bool:
    return dist.get_backend(mesh.group) == "gloo"


def all_reduce_(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the ranks, in place (through the host over
    gloo); returns ``x``."""
    if _gloo(mesh) and x.device.type != "cpu":
        host = host_copy(x)
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=mesh.group)
        x.copy_(host)
    else:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    COLLECTIVES["reduce"] += 1
    return x


def _all_gather_bytes(flat: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's (n,) uint8 buffer -> every rank's, (S, n)."""
    n, s = flat.numel(), mesh.size
    if _gloo(mesh):
        out = host_empty((s, n), flat.dtype, flat)
        dist.all_gather(list(out), host_copy(flat), group=mesh.group)
        out = out.to(flat.device)
    else:
        out = torch.empty((s, n), dtype=flat.dtype, device=flat.device)
        dist.all_gather_into_tensor(out, flat, group=mesh.group)
    COLLECTIVES["all_gather"] += 1
    return out


def _all_to_all_bytes(rows: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(S, n) uint8 rows on this rank, row j for rank j -> (S, n): row r
    what rank r sent this rank."""
    if _gloo(mesh):
        out = host_empty(rows.shape, rows.dtype, rows)
        dist.all_to_all_single(out, host_copy(rows), group=mesh.group)
        out = out.to(rows.device)
    else:
        out = torch.empty_like(rows)
        dist.all_to_all_single(out, rows, group=mesh.group)
    COLLECTIVES["reduce_scatter"] += 1
    return out


def _whole(blocks: Sequence[torch.Tensor], dims, mesh: Mesh):
    flat = torch.cat([b.contiguous().reshape(-1).view(torch.uint8)
                      for b in blocks])
    rows = _all_gather_bytes(flat, mesh)
    out, off = [], 0
    for b, d in zip(blocks, dims):
        nb = b.numel() * b.element_size()
        part = rows[:, off:off + nb].contiguous().view(b.dtype)
        part = part.reshape((mesh.size,) + tuple(b.shape))
        out.append(part.movedim(0, d).flatten(d, d + 1))
        off += nb
    return out


def _blocks(grads, blocks, dims, mesh: Mesh, summed: bool):
    s = mesh.size
    rows = torch.cat([g.to(b.dtype).unflatten(d, (s, g.shape[d] // s))
                      .movedim(d, 0).contiguous().reshape(s, -1)
                      .view(torch.uint8)
                      for g, b, d in zip(grads, blocks, dims)], dim=1)
    if summed:
        rows = _all_to_all_bytes(rows, mesh)
    else:
        rows = rows[_rank(mesh)][None]
    out, off = [], 0
    for b in blocks:
        nb = b.numel() * b.element_size()
        terms = rows[:, off:off + nb].contiguous().view(b.dtype)
        out.append(terms.float().sum(0).reshape(b.shape).to(b.dtype))
        off += nb
    return out


class _Gather(torch.autograd.Function):
    """Blocks -> whole leaves (all-gather); their gradients -> each
    rank's block of the sum (reduce-scatter)."""

    @staticmethod
    def forward(ctx, dims, mesh, summed, *blocks):
        ctx.dims, ctx.mesh, ctx.summed = dims, mesh, summed
        ctx.blocks = [torch.empty(b.shape, dtype=b.dtype, device="meta")
                      for b in blocks]
        return tuple(_whole(blocks, dims, mesh))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + tuple(
            _blocks(grads, ctx.blocks, ctx.dims, ctx.mesh, ctx.summed))


def gather(blocks: Sequence[torch.Tensor], dims: Sequence[int], mesh: Mesh,
           summed: bool = True):
    """This rank's ``blocks`` of some leaves (each split along its entry of
    ``dims``) as the whole leaves: ONE all-gather of their bytes.  Under
    autograd the backward is ONE reduce-scatter (``summed``: an
    all-to-all of the whole leaves' gradient blocks, each rank's block
    summed in float32), or, with ``summed=False`` (every rank holds the
    whole batch, so its gradient is already the whole one), this rank's
    block of them with no collective.  Returns a list."""
    if not blocks:
        return []
    return list(_Gather.apply(tuple(dims), mesh, summed, *blocks))


def gather_tree(tree: Any, specs: Any, mesh: Mesh, summed: bool = True,
                lead: int = 0) -> Any:
    """``tree`` (this rank's blocks) with every sharded leaf whole, in one
    ``gather``; ``specs`` are the leaves' specs with ``lead`` leading
    dimensions the leaves no longer have (a layer's slice of the stacked
    layers: 1)."""
    leaves, dims = tree_leaves(tree), leaf_dims(tree, specs, mesh)
    idx = [i for i, d in enumerate(dims) if d is not None]
    whole = gather([leaves[i] for i in idx], [dims[i] - lead for i in idx],
                   mesh, summed)
    for i, w in zip(idx, whole):
        leaves[i] = w
    it = iter(leaves)
    return tree_map(lambda x: next(it), tree)


class DataParallel:
    """A rank's place in the sharded train step: the group-bound ``mesh``,
    the sanitized PartitionSpecs ``specs`` of the parameter tree (whose
    leaves this rank holds blocks of), and whether the batch is split
    over the ranks (``batch_sharded``) or every rank holds it whole."""

    def __init__(self, mesh: Mesh, specs: Any, batch_sharded: bool = True):
        check_mesh(mesh)
        _rank(mesh)
        self.mesh, self.specs, self.batch_sharded = mesh, specs, batch_sharded

    @property
    def size(self) -> int:
        return dp_size(self.mesh)
