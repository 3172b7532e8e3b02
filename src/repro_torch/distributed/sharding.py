"""The data and model axes across ranks: what GSPMD does for the
reference's sharded train, prefill and serve steps, written out for the
port.

The reference lays parameters, optimizer state and batches over a
``jax`` mesh by PartitionSpecs (``repro/models/*: *_specs``,
``repro/launch/steps.py``) and leaves the collectives to GSPMD.  The port
runs one rank a shard of a group-bound mesh (``make_mesh(...,
group=)``: the data-parallel axes ``"pod"`` and ``"data"``, and
``"model"``, the last axis) and issues them itself:

* ``P`` — the port's PartitionSpec: one entry a dimension (None, an axis
  name or a tuple of names), normalised as ``jax.sharding.PartitionSpec``
  normalises (a one-name tuple becomes the name, an empty one None).  It
  is not a tuple, so ``repro_torch.tree`` takes it as a leaf.
* ``data_dim`` — the dimension a (sanitized) spec shards over the
  data-parallel axes, or None for a leaf every rank holds whole;
  ``model_dim`` — the dimension it shards over ``"model"``.  A leaf may
  be sharded on two dimensions: ``P("data", "model")`` under FSDP; one
  dimension over both axes (``cache_pspecs``' sequence-sharded branch) is
  refused by name.  ``check_mesh`` refuses the ssm, hybrid, vlm and audio
  families over "model" by name.
* ``shard`` — rank r's block of a leaf (over both axes);
  ``unshard_tree`` — a tree of blocks whole again on every rank, in one
  collective (``gather_rows``).
* ``gather`` — every rank's blocks of some leaves into whole leaves, as an
  autograd Function: one all-gather in the forward, and in the backward
  one reduce-scatter: each rank sends rank j the j-th block of its
  gradients of the whole leaves (one all-to-all) and sums the blocks it
  gets.  When every rank holds the whole batch (``summed=False``) each
  rank's gradient is already the whole one, and the backward takes its
  block with no collective.
* ``all_reduce_`` — the sum over the ranks in place (replicated leaves'
  gradients, the loss and the norm).
* ``DataParallel`` — a rank's place in the train step over the data axes
  alone.
* ``TensorParallel`` — a rank's place in the train, prefill and serve
  steps over a ("data", "model") mesh: the sanitized specs, one sub-group
  a data index for the model axis and one a model index for the data
  axis, and the model axis's collectives (``all_reduce``,
  ``all_gather``, ``reduce_scatter``, ``seq_gather``, ``finish``, each
  over that axis's sub-group only), autograd Functions whose backward is
  the forward's conjugate (Megatron's f and g: an all-reduce's is the
  identity, an all-gather's a reduce-scatter, and the reverse).  Sums
  over "model" run in float32 and are rounded once to the tensors'
  type.

The gradients are reduced in float32: the ranks' terms travel in the
leaf's own type (bfloat16 in training), a rank adds the S terms of its
block in float32 on its device and rounds the sum once back to the
leaf's type; a replicated leaf's gradient is cast to float32 and
all-reduced (``launch.train``).  The gathers and the all-to-alls move
bytes, so nothing is rounded on the way.  Over NCCL the buffers stay on
the card; over gloo each goes through the host, as
``collectives._reduce`` does.  ``COLLECTIVES`` counts ``all_gather``,
``reduce_scatter`` and ``reduce`` (an all-reduce) over the data axes,
and ``tp_reduce``, ``tp_gather`` and ``tp_scatter`` over "model".
Importing this module starts no process group (``TensorParallel`` makes
its sub-groups, once a mesh).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_map
from .collectives import (COLLECTIVES, Mesh, gather_rows, host_copy,
                          host_empty, make_mesh)

#: the mesh axes the batch and the FSDP shards are laid over
DP_AXES = ("pod", "data")
#: the tensor-parallel axis (heads, FFN columns, experts, vocabulary)
MODEL = "model"
#: the families the serve steps run over "model"
TP_FAMILIES = ("dense", "moe")


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
    (None when it names none of size above 1).  A ``"model"`` entry is
    the model axis's (``model_dim``); a dimension sharded over the data
    and model axes at once (``cache_pspecs``' sequence-sharded branch) or
    two dimensions over the data axes are refused by name."""
    sizes = mesh.shape
    dim = None
    for i, entry in enumerate(spec):
        axes = _axes(entry)
        for a in axes:
            if a not in sizes:
                raise ValueError(f"spec {spec!r} names axis {a!r}, which the "
                                 f"mesh {sizes} does not have")
            if sizes[a] <= 1:
                continue
            if a not in DP_AXES:
                if a != MODEL:
                    raise ValueError(f"spec {spec!r} shards over {a!r}: the "
                                     f"port shards over the data and model "
                                     f"axes only")
                if any(b in DP_AXES and sizes[b] > 1 for b in axes):
                    raise ValueError(
                        f"spec {spec!r} shards dimension {i} over the "
                        f"data and model axes at once (cache_pspecs' "
                        f"sequence-sharded branch is not ported)")
                continue
            if dim is not None and dim != i:
                raise ValueError(f"spec {spec!r} shards two dimensions over "
                                 f"the data axis")
            dim = i
    return dim


def model_dim(spec: P, mesh: Mesh) -> Optional[int]:
    """The dimension ``spec`` shards over ``"model"`` (None when it does
    not, or the mesh's "model" is 1)."""
    if mesh.shape.get(MODEL, 1) <= 1:
        return None
    dim = None
    for i, entry in enumerate(spec):
        if MODEL in _axes(entry):
            if dim is not None:
                raise ValueError(f"spec {spec!r} shards two dimensions over "
                                 f"\"model\"")
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


def model_size(mesh: Mesh) -> int:
    """Shards of the "model" axis."""
    return mesh.shape.get(MODEL, 1)


def check_mesh(mesh: Mesh, cfg=None) -> None:
    """A mesh the port runs over: its data-parallel axes and "model", the
    last axis, which may have more than one shard for ``cfg``'s family if
    it is dense or moe (the ssm, hybrid, vlm and audio families over
    "model" are refused by name)."""
    for a, s in mesh.shape.items():
        if a in DP_AXES or s <= 1:
            continue
        if a != MODEL:
            raise ValueError(f"mesh {mesh.shape}: axis {a!r} has {s} "
                             f"shards; the port shards over the data and "
                             f"model axes only")
        if mesh.axis_names[-1] != MODEL:
            raise ValueError(f"mesh {mesh.axis_names}: \"model\" must be "
                             f"the last axis")
        if cfg is not None and cfg.family not in TP_FAMILIES:
            raise ValueError(
                f"{cfg.name}: the {cfg.family} family over \"model\" is "
                f"not ported (the train and serve steps run "
                f"{', '.join(TP_FAMILIES)} over it)")


def _rank(mesh: Mesh) -> int:
    r = mesh.rank
    if r is None:
        raise ValueError("the mesh has no process group: a shard is a rank "
                         "of make_mesh(..., group=)")
    return r


def coords(mesh: Mesh, rank: int) -> Tuple[int, int]:
    """(data-parallel index, model index) of ``rank``: the ranks lie
    row-major over the mesh's axes, as the reference's devices do."""
    idx, r = {}, rank
    for a, s in reversed(tuple(zip(mesh.axis_names, mesh.sizes))):
        idx[a], r = r % s, r // s
    d = 0
    for a in DP_AXES:
        if a in idx:
            d = d * mesh.shape[a] + idx[a]
    return d, idx.get(MODEL, 0)


def block_cuts(spec: P, mesh: Mesh, rank: int):
    """[(dimension, shards, this rank's index)] of ``spec``'s sharded
    dimensions: the data-parallel one and the model one."""
    d, m = coords(mesh, rank)
    cuts = []
    dd = data_dim(spec, mesh)
    if dd is not None:
        cuts.append((dd, dp_size(mesh), d))
    md = model_dim(spec, mesh)
    if md is not None:
        cuts.append((md, model_size(mesh), m))
    return cuts


def shard(x: torch.Tensor, spec: P, mesh: Mesh, rank: Optional[int] = None):
    """Rank ``rank``'s block of ``x`` under ``spec`` (this process's rank
    by default), over the data and the model axes: a view, or ``x``
    itself for a replicated leaf."""
    r = _rank(mesh) if rank is None and (
        data_dim(spec, mesh) is not None
        or model_dim(spec, mesh) is not None) else rank
    for dim, n, i in block_cuts(spec, mesh, r or 0):
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split into {n} shards: sanitize the spec "
                             f"first")
        blk = x.shape[dim] // n
        x = x.narrow(dim, i * blk, blk)
    return x


def _assemble(rows: torch.Tensor, dd, md, mesh: Mesh) -> torch.Tensor:
    """Every rank's block of one leaf, stacked (S, ...) in rank order,
    as the whole leaf: blocks along ``md`` over "model", along ``dd``
    over the data axes."""
    n, m = dp_size(mesh), model_size(mesh)
    if mesh.axis_names[-1] != MODEL and m > 1:
        raise ValueError("unshard_tree: \"model\" must be the last axis")
    t = rows.reshape((n, m) + tuple(rows.shape[1:]))
    t = t[:, 0] if md is None else t.movedim(1, 1 + md).flatten(1 + md,
                                                                2 + md)
    return t[0] if dd is None else t.movedim(0, dd).flatten(dd, dd + 1)


def unshard_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """Every rank's blocks of ``tree`` back into whole leaves, on every
    rank: one collective (``gather_rows``) for the sharded leaves; a
    replicated leaf is this rank's own."""
    leaves = tree_leaves(tree)
    dims = tree_leaves(tree_map(
        lambda x, s: (data_dim(s, mesh), model_dim(s, mesh)),
        tree, specs))
    dims = [dims[i:i + 2] for i in range(0, len(dims), 2)]
    sharded = [x for x, (dd, md) in zip(leaves, dims)
               if dd is not None or md is not None]
    rows = iter(gather_rows(sharded, mesh)) if sharded else iter(())
    whole = [x if dd is None and md is None
             else _assemble(next(rows), dd, md, mesh)
             for x, (dd, md) in zip(leaves, dims)]
    it = iter(whole)
    return tree_map(lambda x: next(it), tree)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _gloo(mesh: Mesh) -> bool:
    return dist.get_backend(mesh.group) == "gloo"


def all_reduce_(x: torch.Tensor, mesh: Mesh, *, kind: str = "reduce",
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` summed (or reduced by ``op``) over the ranks, in place
    (through the host over gloo), counted as ``kind``; returns ``x``."""
    if _gloo(mesh) and x.device.type != "cpu":
        host = host_copy(x)
        dist.all_reduce(host, op=op, group=mesh.group)
        x.copy_(host)
    else:
        dist.all_reduce(x, op=op, group=mesh.group)
    COLLECTIVES[kind] += 1
    return x


def _all_gather_bytes(flat: torch.Tensor, mesh: Mesh, *,
                      kind: str = "all_gather") -> torch.Tensor:
    """This rank's (n,) uint8 buffer -> every rank's, (S, n)."""
    n, s = flat.numel(), mesh.size
    if _gloo(mesh):
        out = host_empty((s, n), flat.dtype, flat)
        dist.all_gather(list(out), host_copy(flat), group=mesh.group)
        out = out.to(flat.device)
    else:
        out = torch.empty((s, n), dtype=flat.dtype, device=flat.device)
        dist.all_gather_into_tensor(out, flat, group=mesh.group)
    COLLECTIVES[kind] += 1
    return out


def _all_to_all_bytes(rows: torch.Tensor, mesh: Mesh, *,
                      kind: str = "reduce_scatter") -> torch.Tensor:
    """(S, n) uint8 rows on this rank, row j for rank j -> (S, n): row r
    what rank r sent this rank."""
    if _gloo(mesh):
        out = host_empty(rows.shape, rows.dtype, rows)
        dist.all_to_all_single(out, host_copy(rows), group=mesh.group)
        out = out.to(rows.device)
    else:
        out = torch.empty_like(rows)
        dist.all_to_all_single(out, rows, group=mesh.group)
    COLLECTIVES[kind] += 1
    return out


def _whole(blocks: Sequence[torch.Tensor], dims, mesh: Mesh, *,
           kind: str = "all_gather"):
    flat = torch.cat([b.contiguous().reshape(-1).view(torch.uint8)
                      for b in blocks])
    rows = _all_gather_bytes(flat, mesh, kind=kind)
    out, off = [], 0
    for b, d in zip(blocks, dims):
        nb = b.numel() * b.element_size()
        part = rows[:, off:off + nb].contiguous().view(b.dtype)
        part = part.reshape((mesh.size,) + tuple(b.shape))
        out.append(part.movedim(0, d).flatten(d, d + 1))
        off += nb
    return out


def _blocks(grads, blocks, dims, mesh: Mesh, summed: bool, *,
            kind: str = "reduce_scatter"):
    """Each rank's block (``blocks``: its shape and type) of the whole
    ``grads`` summed over the ranks: the blocks travel in their own type
    (one all-to-all, counted as ``kind``) and are summed in float32 on
    the receiving rank, rounded once; with ``summed=False`` this rank's
    block with no collective."""
    s = mesh.size
    rows = torch.cat([g.to(b.dtype).unflatten(d, (s, g.shape[d] // s))
                      .movedim(d, 0).contiguous().reshape(s, -1)
                      .view(torch.uint8)
                      for g, b, d in zip(grads, blocks, dims)], dim=1)
    if summed:
        rows = _all_to_all_bytes(rows, mesh, kind=kind)
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
    """A rank's place in the sharded train step over the data axes alone:
    the group-bound ``mesh``, the sanitized PartitionSpecs ``specs`` of
    the parameter tree (whose leaves this rank holds blocks of), and
    whether the batch is split over the ranks (``batch_sharded``) or
    every rank holds it whole.  A "model" axis above 1 is
    ``TensorParallel``'s."""

    def __init__(self, mesh: Mesh, specs: Any, batch_sharded: bool = True):
        check_mesh(mesh)
        if model_size(mesh) > 1:
            raise ValueError(f"mesh {mesh.shape}: DataParallel runs over the "
                             f"data axes; \"model\" above 1 takes "
                             f"TensorParallel")
        _rank(mesh)
        self.mesh, self.specs, self.batch_sharded = mesh, specs, batch_sharded

    @property
    def size(self) -> int:
        return dp_size(self.mesh)


# ---------------------------------------------------------------------------
# the model axis: Megatron's tensor and sequence parallelism
# ---------------------------------------------------------------------------

#: sub-groups made for a mesh: (group, sizes) -> (model groups, data groups)
_SUBGROUPS: Dict[Any, Tuple[list, list]] = {}


def _subgroups(mesh: Mesh):
    """One process group a data index over its model ranks and one a
    model index over its data ranks, each made once a mesh by every rank
    in the same order (a sub-group of one rank is None)."""
    key = (mesh.group, mesh.sizes)
    if key not in _SUBGROUPS:
        n, m = dp_size(mesh), model_size(mesh)
        world = [dist.get_global_rank(mesh.group, r) if mesh.group is not
                 dist.group.WORLD else r for r in range(mesh.size)]
        by = {}
        for r in range(mesh.size):
            by.setdefault(coords(mesh, r), world[r])
        model = [dist.new_group([by[(d, j)] for j in range(m)])
                 if m > 1 else None for d in range(n)]
        data = [dist.new_group([by[(d, j)] for d in range(n)])
                if n > 1 else None for j in range(m)]
        _SUBGROUPS[key] = (model, data)
    return _SUBGROUPS[key]


def _sum32(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over "model" in float32, rounded once to its
    type."""
    return all_reduce_(x.to(torch.float32, copy=True), mesh,
                       kind="tp_reduce").to(x.dtype)


def _scatter(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over "model", this rank's block of it along
    ``dim``: ONE all-to-all of the ranks' blocks in ``x``'s own type,
    summed in float32 on this rank and rounded once (``_blocks``)."""
    shape = list(x.shape)
    shape[dim] //= mesh.size
    blk = torch.empty(shape, dtype=x.dtype, device="meta")
    return _blocks([x], [blk], [dim], mesh, True, kind="tp_scatter")[0]


class _ModelReduce(torch.autograd.Function):
    """Row-parallel output: the sum over "model" (an all-reduce); its
    gradient, whole on every rank, is each term's (identity)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _sum32(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelCopy(torch.autograd.Function):
    """Column-parallel input: the same tensor on every rank of "model"
    (identity); its gradient the sum of the ranks' (an all-reduce)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum32(g, ctx.mesh), None


class _ModelGather(torch.autograd.Function):
    """Blocks cut over "model" -> whole tensors (one all-gather); their
    gradients -> each rank's block of the sum (one reduce-scatter)."""

    @staticmethod
    def forward(ctx, dims, mesh, *blocks):
        ctx.dims, ctx.mesh = dims, mesh
        ctx.blocks = [torch.empty(b.shape, dtype=b.dtype, device="meta")
                      for b in blocks]
        return tuple(_whole(blocks, dims, mesh, kind="tp_gather"))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(_blocks(
            grads, ctx.blocks, ctx.dims, ctx.mesh, True, kind="tp_scatter"))


class _ModelScatter(torch.autograd.Function):
    """Sequence-parallel row output: the sum over "model", this rank's
    block along ``dim`` (a reduce-scatter); its gradient every rank's
    block (an all-gather)."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _scatter(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return _whole([g], [ctx.dim], ctx.mesh, kind="tp_gather")[0], \
            None, None


class _ModelShare(torch.autograd.Function):
    """A term every rank of "model" computes whole, added to the ranks'
    sum: the same tensor (identity), whose gradient rank 0 takes and the
    others take as zero, so that the sum over the ranks counts it once."""

    @staticmethod
    def forward(ctx, x, first):
        ctx.first = first
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


class TensorParallel:
    """A rank's place in the train, prefill and serve steps over a
    group-bound ("data", "model") mesh: ``specs`` the sanitized parameter
    specs (this rank holds their blocks), ``kv_spec`` the sanitized spec
    of a layer's K and V (B, S, kv, hd) (its cache's, and the attention
    path's: ``layers.kv_layout``), ``model_mesh`` and ``data_mesh`` the
    meshes over this rank's sub-groups (None where the axis has one
    shard; ``data_mesh`` keeps the mesh's axis names, "model" of size
    1), ``m`` / ``d`` its model and data-parallel indices, ``sp`` whether
    the residual stream is split along the sequence over "model" between
    layers (``with_sp``: ``cfg.seq_parallel`` and M dividing S), and
    ``batch_sharded`` whether the batch rows are split over the data
    axes.

    The model axis's collectives are autograd Functions, Megatron's
    conjugate pairs: a layer's input (``seq_gather``) is the identity
    forward and an all-reduce backward, or under ``sp`` an all-gather
    along the sequence and a reduce-scatter; its output (``finish``) an
    all-reduce and the identity, or under ``sp`` a reduce-scatter and an
    all-gather; the cut projections' ``all_gather`` reduce-scatters
    their gradients.  Every sum over "model" runs in float32 and is
    rounded once to the tensors' type."""

    def __init__(self, mesh: Mesh, cfg, specs: Any, kv_spec: P, *,
                 batch_sharded: bool = True):
        check_mesh(mesh, cfg)
        rank = _rank(mesh)
        self.mesh, self.specs, self.kv_spec = mesh, specs, kv_spec
        self.model, self.data = model_size(mesh), dp_size(mesh)
        self.d, self.m = coords(mesh, rank)
        model, data = _subgroups(mesh)
        self.model_mesh = (None if self.model == 1 else
                           make_mesh((self.model,), (MODEL,),
                                     group=model[self.d]))
        self.data_mesh = (None if self.data == 1 else make_mesh(
            tuple(1 if a == MODEL else s for a, s in zip(mesh.axis_names,
                                                         mesh.sizes)),
            mesh.axis_names, group=data[self.m]))
        self.sp = False
        self.batch_sharded = batch_sharded

    def route(self) -> Dict[str, Any]:
        """``moe_forward``'s dispatch groups on this rank: the data
        sub-group's when the batch is split over it, its count of groups
        when every rank holds the batch, none on one data shard."""
        if self.data_mesh is None:
            return {}
        return ({"mesh": self.data_mesh} if self.batch_sharded
                else {"groups": self.data})

    def with_sp(self, sp: bool) -> "TensorParallel":
        """The same place with sequence parallelism on or off."""
        out = object.__new__(TensorParallel)
        out.__dict__.update(self.__dict__)
        out.sp = bool(sp) and self.model > 1
        return out

    def split(self, spec: P) -> bool:
        """Whether a leaf under ``spec`` is cut over "model"."""
        return model_dim(spec, self.mesh) is not None

    def gather_data(self, tree: Any, specs: Any, lead: int = 0) -> Any:
        """``tree`` (this rank's blocks) with every leaf cut over the data
        axes whole along it (FSDP): ``gather_tree`` over the data
        sub-group, whose backward reduce-scatters the gradients over it
        (or, with the batch whole on every data rank, takes the rank's
        block)."""
        if self.data_mesh is None:
            return tree
        return gather_tree(tree, specs, self.data_mesh, self.batch_sharded,
                           lead=lead)

    # -- the model axis's collectives ----------------------------------------

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over "model", in float32, rounded once to
        ``x``'s type; its gradient passes through (identity)."""
        return _ModelReduce.apply(x, self.model_mesh)

    def all_gather(self, xs: Sequence[torch.Tensor], dims: Sequence[int]):
        """This rank's blocks of some tensors, each cut along its entry of
        ``dims`` over "model", as the whole tensors: ONE all-gather of
        their bytes; the backward ONE reduce-scatter of their gradients
        (an all-to-all of the blocks, summed in float32)."""
        return list(_ModelGather.apply(tuple(dims), self.model_mesh, *xs))

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum of ``x`` over "model", this rank's block of it along
        ``dim``: ONE all-to-all of the ranks' blocks in ``x``'s own type
        (half a float32 reduce-scatter's bytes for bfloat16), summed in
        float32 on this rank and rounded once; the backward one
        all-gather."""
        return _ModelScatter.apply(x, dim, self.model_mesh)

    # -- the residual stream -------------------------------------------------

    def seq_block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole (B, S, ...) along the sequence."""
        return x.chunk(self.model, 1)[self.m]

    def seq_gather(self, x: torch.Tensor) -> torch.Tensor:
        """A column-parallel layer's input: under ``sp`` the rank's (B,
        S/M, d) block whole along the sequence (an all-gather; backward a
        reduce-scatter), else ``x`` itself (backward: the ranks'
        gradients all-reduced)."""
        if self.sp:
            return self.all_gather([x], [1])[0]
        return x if self.model == 1 else _ModelCopy.apply(x, self.model_mesh)

    def finish(self, partial: Optional[torch.Tensor] = None,
               whole: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A layer's output from a sum of per-rank terms over "model"
        (``partial``, a row-parallel product) and a term every rank holds
        whole (``whole``): the sum all-reduced, or under ``sp``
        reduce-scattered along the sequence (whole terms cut to the
        rank's block); each (B, S, d).  A whole term's gradient is taken
        once over the ranks (on rank 0, or under ``sp`` on each rank's
        block)."""
        out = None
        if partial is not None:
            out = (self.reduce_scatter(partial, 1) if self.sp
                   else self.all_reduce(partial))
        if whole is not None:
            whole = (self.seq_block(whole) if self.sp
                     else _ModelShare.apply(whole, self.m == 0))
            out = whole if out is None else out + whole
        return out
