"""Meshes of the launch layer — the PyTorch twin of
``repro/launch/mesh.py``.

``make_production_mesh`` names the reference's production layouts (16 x
16 chips over ``("data", "model")``, 2 x 16 x 16 over ``("pod", "data",
"model")``) as sizes with no devices behind them: the port's ``dryrun``
plans one card, and these meshes say what the PartitionSpecs
(``launch/steps.py``) shard over.  ``make_local_mesh`` is a mesh over
the ranks of a started ``torch.distributed`` process group (one shard a
rank; the sharded train step's mesh), or over one shard when no group
is started.  Functions, not module constants:
importing this module starts no process group.
"""

from __future__ import annotations

import torch.distributed as dist

from ..distributed.collectives import Mesh, make_mesh

__all__ = ["dp_axes", "dp_size", "make_local_mesh", "make_production_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16 x 16 = 256 chips over ("data", "model").  Multi-pod:
    2 x 16 x 16 = 512 chips over ("pod", "data", "model").  Named sizes
    only (no process group)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_local_mesh(model: int = 1, *, group=None) -> Mesh:
    """A ("data", "model") mesh over the ranks of ``group`` (the default
    group when one is started and ``group`` is None): ``data = ranks //
    model``.  With no process group started it is a one-shard mesh."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    n = 1 if group is None else dist.get_world_size(group)
    data = max(n // model, 1)
    if group is not None and data * model != n:
        raise ValueError(f"make_local_mesh: {n} ranks do not split into "
                         f"model={model} columns")
    return make_mesh((data, model), ("data", "model"), group=group)


def dp_axes(mesh: Mesh) -> tuple:
    """The data-parallel axes of a mesh (pod+data when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh: Mesh) -> int:
    s = 1
    for a in dp_axes(mesh):
        s *= mesh.shape[a]
    return s
