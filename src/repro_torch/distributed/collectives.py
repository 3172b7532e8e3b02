"""The mesh's aggregation primitives on one card — the PyTorch twin of the
queue half of ``repro/distributed/collectives.py``.

In the reference each shard is a device and a round's exchange is one
psum over the mesh axis.  Here a shard is a row: every shard's block is
row ``i`` of an ``(S, B)`` tensor, so the gather in which each row has
exactly one contributor is the stacked rows themselves, and a shard's
``axis_index`` is its row.  A form across several cards (one process a
card, ``torch.distributed`` all-reduce as the psum) is not part of the
port yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch

from ..kernels.wavefaa import _i32


@dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes.  ``shape[axis]`` is the shard
    count the engines read, as from the reference's ``jax.sharding.Mesh``;
    on one card an axis is a tensor dimension, not a set of devices."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """The port's mesh: ``make_mesh((S,), ("data",))`` has ``S`` shards on
    axis ``"data"`` (reference ``repro.jaxcompat.make_mesh``)."""
    sizes, names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    if len(sizes) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"make_mesh: {len(sizes)} sizes for axes {names}")
    if any(s < 1 for s in sizes):
        raise ValueError(f"make_mesh: axis sizes must be >= 1, got {sizes}")
    return Mesh(names, sizes)


def mesh_ticket_base(counts: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every shard's request count (an ``(S,)`` vector, one a row) to
    ``(bases (S,), total)``: each shard's ticket base is the exclusive
    prefix of the counts (reference ``mesh_ticket_base``, whose psum is
    this vector), all int32 with wraparound."""
    c = torch.as_tensor(counts).to(torch.int64).reshape(-1)
    base = torch.cumsum(c, 0) - c
    return _i32(base), _i32(c.sum())


def mesh_round_gather(blocks):
    """The round's exchange of compact blocks (reference
    ``mesh_round_gather``): each block is ``(S, B_i)``, row ``i`` shard
    ``i``'s, and the gather returns them as int32, one ``(S, B_i)`` a
    block — the rows ARE the gathered buffer, each with one contributor,
    so the reference's bit-exact integer psum is the identity here."""
    out = []
    for b in blocks:
        b = torch.as_tensor(b)
        if b.dim() != 2:
            raise ValueError(f"mesh_round_gather: blocks are (S, B_i) rows, "
                             f"got {tuple(b.shape)}")
        out.append(b.to(torch.int32))
    return tuple(out)

