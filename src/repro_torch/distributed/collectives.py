"""The mesh's aggregation primitives and the gradient collectives — the
PyTorch twin of ``repro/distributed/collectives.py``.

In the reference each shard is a device and a round's exchange is one
psum over the mesh axis.  The port has two forms of a mesh:

* on one card (``make_mesh((S,), ("data",))``) a shard is a row: every
  shard's block is row ``i`` of an ``(S, B)`` tensor, so the gather in
  which each row has exactly one contributor is the stacked rows
  themselves, and a shard's ``axis_index`` is its row;
* across processes (``make_mesh((S,), ("data",), group=...)``) a shard is
  a rank of a ``torch.distributed`` process group, ``Mesh.rank`` its
  ``axis_index``, and the psum is one ``all_reduce(SUM)`` of an ``(S,
  W)`` int32 buffer that is zero but for this rank's row: one
  contributor a row, so the sum is the gather, bit for bit.

The group's backend picks the transport.  NCCL (one card a rank) reduces
the buffer on the card.  Gloo (the CPU, or ranks sharing a card) reduces
a host copy: the rank's row goes to the host, is reduced there and comes
back.  The engines issue a group-bound mesh's rounds from the host over
either backend (``runtime.enginecore``).

``COLLECTIVES`` counts the group form's calls: ``exchange`` one a
round's gather, ``gather`` one an end-of-run gather of per-rank state
(``gather_rows``), ``reduce`` one a gradient all-reduce,
``all_gather`` / ``reduce_scatter`` those of the sharded train step and
the serve steps' FSDP gathers, and ``tp_reduce`` / ``tp_gather`` /
``tp_scatter`` those of the serve steps over "model" (``sharding``).  Importing this module starts no process group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from ..kernels.wavefaa import _i32
from ..tree import tree_leaves, tree_map
from . import compression

#: collective calls of the group form, by kind (see the module doc)
COLLECTIVES: Dict[str, int] = {"exchange": 0, "gather": 0, "reduce": 0,
                               "all_gather": 0, "reduce_scatter": 0,
                               "tp_reduce": 0, "tp_gather": 0,
                               "tp_scatter": 0}


@dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes.  ``shape[axis]`` is the shard
    count the engines read, as from the reference's ``jax.sharding.Mesh``.
    Without ``group`` an axis is a tensor dimension on one card; with it
    the mesh's shards are the ranks of that process group."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def rank(self):
        """This process's shard (the reference's ``axis_index``); None on
        a one-card mesh."""
        return None if self.group is None else dist.get_rank(self.group)


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              group=None) -> Mesh:
    """The port's mesh: ``make_mesh((S,), ("data",))`` has ``S`` shards on
    axis ``"data"`` (reference ``repro.jaxcompat.make_mesh``), a tensor
    dimension on one card; with ``group`` (a ``torch.distributed``
    process group, or ``torch.distributed.group.WORLD``) the shards are
    its ranks, whose count must be the mesh's size."""
    sizes, names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    if len(sizes) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"make_mesh: {len(sizes)} sizes for axes {names}")
    if any(s < 1 for s in sizes):
        raise ValueError(f"make_mesh: axis sizes must be >= 1, got {sizes}")
    mesh = Mesh(names, sizes, group)
    if group is not None:
        n = dist.get_world_size(group)
        if n != mesh.size:
            raise ValueError(f"make_mesh: the process group has {n} ranks "
                             f"but the mesh {dict(zip(names, sizes))} has "
                             f"{mesh.size} shards")
    return mesh


def host_copy(x: torch.Tensor) -> torch.Tensor:
    """``x`` on the host for a gloo collective: ``x`` itself on the CPU,
    else a copy in pinned memory (the caching host allocator keeps the
    blocks, and a pinned copy moves at the link's rate)."""
    if x.device.type == "cpu":
        return x
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def host_empty(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    """A host buffer for a gloo collective's result bound for ``like``'s
    device: pinned when that is a card."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=like.device.type != "cpu")


def _reduce(row: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's ``row`` (W,) in an (S, W) buffer, zero but for row
    ``mesh.rank``, summed over the group in one ``all_reduce``; returned
    on ``row``'s device.  NCCL reduces the buffer there; gloo reduces a
    host buffer, the row brought over in one copy."""
    shape = (mesh.size, row.shape[0])
    if dist.get_backend(mesh.group) != "gloo":
        buf = torch.zeros(shape, dtype=row.dtype, device=row.device)
        buf[mesh.rank] = row
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
        return buf
    host = host_empty(shape, row.dtype, row)
    host.zero_()
    host[mesh.rank] = row
    dist.all_reduce(host, op=dist.ReduceOp.SUM, group=mesh.group)
    return host.to(row.device)


def mesh_ticket_base(counts: torch.Tensor, mesh: Mesh = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each shard's ticket base and the total (reference
    ``mesh_ticket_base``), int32 with wraparound.  On one card ``counts``
    is every shard's request count, an ``(S,)`` vector (the psum's result
    itself), and the bases are its exclusive prefix ``(S,)``; on a
    group-bound mesh ``counts`` is this rank's one count, and the base is
    this rank's, after one collective."""
    if mesh is None or mesh.group is None:
        c = torch.as_tensor(counts).to(torch.int64).reshape(-1)
        base = torch.cumsum(c, 0) - c
        return _i32(base), _i32(c.sum())
    c = torch.as_tensor(counts).to(torch.int32).reshape(1)
    (sums,) = mesh_round_gather((c,), mesh)
    sums = sums.reshape(-1).long()
    return _i32(sums[:mesh.rank].sum()), _i32(sums.sum())


def mesh_round_gather(blocks, mesh: Mesh = None):
    """The round's exchange of compact blocks (reference
    ``mesh_round_gather``), returned as int32, one ``(S, B_i)`` a block.
    On one card each block is ``(S, B_i)``, row ``i`` shard ``i``'s: the
    rows ARE the gathered buffer, so the reference's bit-exact integer
    psum is the identity.  On a group-bound mesh each block is this
    rank's ``(B_i,)`` row; they are written into this rank's row of one
    ``(S, sum B_i)`` zero buffer and summed by ONE ``all_reduce``."""
    if mesh is None or mesh.group is None:
        out = []
        for b in blocks:
            b = torch.as_tensor(b)
            if b.dim() != 2:
                raise ValueError(f"mesh_round_gather: blocks are (S, B_i) "
                                 f"rows, got {tuple(b.shape)}")
            out.append(b.to(torch.int32))
        return tuple(out)
    rows = [torch.as_tensor(b).to(torch.int32).reshape(-1) for b in blocks]
    widths = [r.shape[0] for r in rows]
    out = _reduce(torch.cat(rows), mesh)
    COLLECTIVES["exchange"] += 1
    return tuple(torch.split(out, widths, dim=1))


def gather_rows(tree, mesh: Mesh):
    """Every rank's ``tree`` (one structure and shape on every rank)
    stacked leaf by leaf under a leading ``(S,)`` axis, in ONE
    ``all_reduce`` of the leaves' bytes (one contributor a row, so any
    dtype comes back bit for bit).  Every rank returns the same."""
    leaves = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    if not leaves:
        return tree
    flat = [x.contiguous().reshape(-1).view(torch.uint8) for x in leaves]
    widths = [f.shape[0] for f in flat]
    out = torch.split(_reduce(torch.cat(flat), mesh), widths, dim=1)
    COLLECTIVES["gather"] += 1
    stacked = iter([o.contiguous().view(x.dtype).reshape((mesh.size,)
                                                         + x.shape)
                    for o, x in zip(out, leaves)])
    return tree_map(lambda x: next(stacked)
                    if isinstance(x, torch.Tensor) else x, tree)


# ---------------------------------------------------------------------------
# gradient all-reduce (data parallel)
# ---------------------------------------------------------------------------


def _sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The psum of ``x`` over the mesh: on one card ``x`` is stacked (S,
    ...) and every row gets the rows' sum; on a group-bound mesh one
    ``all_reduce`` of a copy (a host copy over gloo)."""
    if mesh.group is None:
        return x.sum(0, keepdim=True).expand_as(x).clone()
    if dist.get_backend(mesh.group) == "gloo":
        out = x.clone() if x.device.type == "cpu" else host_copy(x)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
        out = out.to(x.device)
    else:
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    COLLECTIVES["reduce"] += 1
    return out


def allreduce_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The pmean of ``x`` over the mesh (reference ``allreduce_mean``):
    the psum divided by the shard count."""
    return _sum(x, mesh) / mesh.size


def allreduce_compressed(g: torch.Tensor, err: torch.Tensor, mesh: Mesh):
    """Error-feedback int8 all-reduce (reference ``allreduce_compressed``):
    quantize ``g + err`` locally (``compression.compress_with_feedback``,
    the reference's codes and scales bit for bit), mean-reduce the
    dequantized payload.  Returns (reduced, new_err)."""
    if mesh.group is None:
        pairs = [compression.compress_with_feedback(g[i], err[i])
                 for i in range(g.shape[0])]
        deq = torch.stack([p[0] for p in pairs])
        return allreduce_mean(deq, mesh), torch.stack([p[1] for p in pairs])
    deq, new_err = compression.compress_with_feedback(g, err)
    return allreduce_mean(deq, mesh), new_err


def tree_allreduce_compressed(grads: Any, errs: Any, mesh: Mesh):
    """``allreduce_compressed`` leaf by leaf over matching trees: (reduced
    tree, new error tree)."""
    pairs = tree_map(lambda g, e: allreduce_compressed(g, e, mesh), grads,
                     errs)
    red = tree_map(lambda g, p: p[0], grads, pairs)
    new = tree_map(lambda g, p: p[1], grads, pairs)
    return red, new


def bucketed_psum(leaves, mesh: Mesh, bucket_bytes: int = 1 << 25):
    """The psum of every leaf, issued in buckets of about ``bucket_bytes``
    (smallest leaves first, reference ``bucketed_psum``): a group-bound
    mesh reduces each bucket's leaves flattened into one buffer per
    dtype, one ``all_reduce`` each.  Returns the reduced leaves in their
    order."""
    if mesh.group is None:                # one card: nothing to issue
        return [_sum(x, mesh) for x in leaves]
    order = sorted(range(len(leaves)), key=lambda i: leaves[i].numel())
    out = [None] * len(leaves)

    def flush(bucket):
        by_dtype: Dict[torch.dtype, list] = {}
        for j in bucket:
            by_dtype.setdefault(leaves[j].dtype, []).append(j)
        for idx in by_dtype.values():
            flat = _sum(torch.cat([leaves[j].reshape(-1) for j in idx]),
                        mesh)
            for j, r in zip(idx, torch.split(
                    flat, [leaves[j].numel() for j in idx])):
                out[j] = r.reshape(leaves[j].shape)

    bucket, size = [], 0
    for i in order:
        bucket.append(i)
        size += leaves[i].numel() * leaves[i].element_size()
        if size >= bucket_bytes:
            flush(bucket)
            bucket, size = [], 0
    if bucket:
        flush(bucket)
    return out
