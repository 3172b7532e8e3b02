"""Delta-stepping single-source shortest paths on the priority mesh — the
PyTorch twin of ``repro/apps/sssp.py``, through
``PriorityMeshRoundRunner`` with the shard axis a tensor dimension on one
card.

The queue carries ``(key, payload)`` pairs: the key is the
delta-stepping bucket ``d // delta``, so pops drain the lowest-distance
buckets first, and the payload packs the tentative distance claim as
``d * n + v`` (self-contained: a shard can relax a vertex it has never
seen).  With ``split_payload=True`` the payload is the bare vertex and
the exact distance rides the heap's rider plane, which lifts the packed
layout's cap of ``(max_d + max_w) * n + n < 2^31`` to distances below
2^31.  The step is label-correcting: a claim expands only if its
distance still improves (or matches) the shard's own label, children are
published only for strictly improving relaxations (one winner a target
per round, the least distance, then row-major order), and the per-shard
labels are min-combined at quiescence.  The distances are exact whatever
the pop order (strict or relaxed); the order only decides how much work
is repeated.  The run is bit-deterministic for a fixed (graph, source,
shards, batch, delta, relaxed), and ``fused=True`` / ``False`` give the
same labels, heap planes and stats.
"""

from __future__ import annotations

import heapq
from typing import Dict, Tuple

import numpy as np
import torch

from ..kernels._build import resolve_device
from .bfs import CSRGraph

BIG = np.iinfo(np.int32).max


def with_weights(g: CSRGraph, max_w: int = 8, seed: int = 0) -> np.ndarray:
    """Integer edge weights in ``[1, max_w]`` aligned with ``g.col_idx``
    (the reference's generator, so the same seed gives the same
    weights)."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, max_w + 1, g.m).astype(np.int32)


def dijkstra_reference(g: CSRGraph, weights: np.ndarray,
                       source: int = 0) -> np.ndarray:
    """Plain heapq Dijkstra oracle; -1 marks unreachable vertices."""
    dist = np.full(g.n, -1, np.int64)
    dist[source] = 0
    pq = [(0, source)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        for k in range(g.row_ptr[u], g.row_ptr[u + 1]):
            v = int(g.col_idx[k])
            nd = d + int(weights[k])
            if dist[v] < 0 or nd < dist[v]:
                dist[v] = nd
                heapq.heappush(pq, (nd, v))
    return dist.astype(np.int32)


def _scatter_min(n, index, src, device):
    """A ``(n + 1,)`` int32 vector of ``BIG`` with ``src`` scatter-minned
    at ``index`` (slot n takes the lanes that go nowhere)."""
    out = torch.full((n + 1,), BIG, dtype=torch.int32, device=device)
    return out.scatter_reduce_(0, index.long(), src, "amin")


def sssp_mesh_rounds_runner(g: CSRGraph, weights: np.ndarray, *, mesh=None,
                            shards: int = None, axis: str = "data",
                            batch: int = 64, delta: int = 4,
                            relaxed: bool = True, fused: bool = True,
                            sync_every: int = 0, capacity_log2: int = None,
                            trace: bool = False, telemetry=None,
                            spans=None, compact=None,
                            split_payload: bool = False, device="cuda"):
    """Build the priority-mesh SSSP runner for ``(g, weights)`` on
    ``device`` (reference ``sssp_mesh_rounds_runner``).  ``mesh``
    defaults to ``make_mesh((shards,), (axis,))`` with one shard.  Returns
    ``(runner, init_fn)``: ``init_fn(source)`` builds the label
    accumulator, and the source's seed is ``(key 0, payload source)``
    (split layout: ``runner.run([0], [source], ..., initial_aux=[0])``).

    ``relaxed=True`` pops each shard's own minima under the hint-ordered
    claim schedule; ``relaxed=False`` pops exact global bucket order from
    one heap.  Both are exact at quiescence.  ``split_payload=True``
    carries the distance on the heap's rider plane (mutually exclusive
    with ``spans``)."""
    from ..distributed import make_mesh
    from ..runtime import PriorityMeshRoundRunner

    dev = resolve_device(device)
    n = g.n
    if mesh is None:
        mesh = make_mesh((shards or 1,), (axis,))
    weights = np.asarray(weights, np.int32)
    assert weights.shape == (g.m,)
    max_w = int(weights.max()) if g.m else 1
    # any finite tentative distance is a real path length <= (n-1)*max_w
    max_d = (n - 1) * max_w
    if split_payload:
        # two-plane layout: only the raw distances must fit in int32
        if max_d + max_w >= 2 ** 31:
            raise ValueError(
                f"graph too large even for split payloads: n={n}, "
                f"max_w={max_w} needs (n-1)*max_w + max_w < 2^31")
    elif (max_d + max_w) * n + (n - 1) >= 2 ** 31:
        raise ValueError(
            f"graph too large for packed (d, v) payloads: n={n}, "
            f"max_w={max_w} needs ((n-1)*max_w + max_w)*n + n < 2^31 "
            f"(use split_payload=True for the two-plane layout)")
    if delta < 1:
        raise ValueError(f"delta must be >= 1, got {delta}")
    deg = np.diff(g.row_ptr).astype(np.int64)
    fan = max(int(deg.max()) if n else 0, 1)
    nbr = np.full((n, fan), -1, np.int32)
    wgt = np.zeros((n, fan), np.int32)
    rows = np.repeat(np.arange(n), deg)
    pos = np.arange(g.m) - np.repeat(g.row_ptr[:-1].astype(np.int64), deg)
    nbr[rows, pos] = g.col_idx
    wgt[rows, pos] = weights
    nbr_t = torch.from_numpy(nbr).to(dev)
    wgt_t = torch.from_numpy(wgt).to(dev)
    order = torch.arange(batch * fan, dtype=torch.int32, device=dev)

    def _relax(dist, v, d, valid):
        """The label-correcting core: claims (v, d) in, the winning child
        relaxations ``(dist, ck, wf, ndf, win, shape)`` out."""
        # expand unless the label already beats the claim (labels are real
        # path lengths >= the true distance; claims equal to the label
        # re-expand but spawn only improving children)
        fresh = valid & (d <= dist[v])
        dist = torch.cat([dist, dist.new_full((1,), BIG)]).scatter_reduce_(
            0, torch.where(fresh, v, n).long(), d, "amin")[:n]
        w = torch.where(fresh[:, None], nbr_t[v], -1)            # (B, F)
        wc = w.clamp(0, n - 1)
        nd = d[:, None] + wgt_t[v]
        elig = (w >= 0) & (nd < dist[wc])
        # in-batch winner per target: the least nd, then row-major order;
        # two scatter-mins, so no packed winner key to overflow
        ef, wf, ndf = elig.reshape(-1), w.reshape(-1), nd.reshape(-1)
        tgt = torch.where(ef, wf, n)
        claim_nd = _scatter_min(n, tgt, torch.where(ef, ndf, BIG), dev)
        tie = ef & (claim_nd[tgt] == ndf)
        ords = order[:ef.shape[0]]
        claim_ord = _scatter_min(n, tgt, torch.where(tie, ords, BIG), dev)
        win = tie & (claim_ord[tgt] == ords)
        dist = torch.cat([dist, dist.new_full((1,), BIG)]).scatter_reduce_(
            0, torch.where(win, wf, n).long(), ndf, "amin")[:n]
        ck = torch.where(win, ndf // delta, 0)
        return dist, ck, wf, ndf, win, w.shape

    def step(dist, keys, payloads, valid):
        p = torch.where(valid, payloads, 0)  # the bucket only orders pops
        dist, ck, wf, ndf, win, shape = _relax(dist, p % n, p // n, valid)
        cv = torch.where(win, ndf * n + wf.clamp(0, n - 1), 0)
        return (dist, ck.reshape(shape), cv.reshape(shape),
                win.reshape(shape))

    def step_split(dist, keys, payloads, aux, valid):
        v = torch.where(valid, payloads, 0)       # the bare vertex plane
        d = torch.where(valid, aux, 0)            # the exact distance rider
        dist, ck, wf, ndf, win, shape = _relax(dist, v, d, valid)
        cv = torch.where(win, wf.clamp(0, n - 1), 0)
        ca = torch.where(win, ndf, 0)
        return (dist, ck.reshape(shape), cv.reshape(shape),
                ca.reshape(shape), win.reshape(shape))

    def combine(stacked):                        # (shards, n) labels
        m = stacked.min(0).values
        return torch.where(m == BIG, -1, m)

    nshards = int(mesh.shape[axis])
    if capacity_log2 is None:
        per_shard = max(4 * n // max(nshards, 1), 4 * batch, 16)
        capacity_log2 = int(np.ceil(np.log2(per_shard)))
        if not relaxed:
            capacity_log2 = int(np.ceil(np.log2(
                max(4 * n, 4 * batch * nshards, 16))))
    runner = PriorityMeshRoundRunner(step_split if split_payload else step,
                                     mesh=mesh, axis=axis,
                                     capacity_log2=capacity_log2,
                                     batch=batch, relaxed=relaxed,
                                     fused=fused, sync_every=sync_every,
                                     combine=combine, trace=trace,
                                     telemetry=telemetry, spans=spans,
                                     compact=compact, split=split_payload,
                                     device=dev)

    def init_fn(source: int):
        # every label unvisited: the source's 0 arrives with its seed
        # claim (set here, it would make that claim non-improving)
        del source
        return torch.full((n,), BIG, dtype=torch.int32, device=dev)

    return runner, init_fn


def sssp_mesh_rounds(g: CSRGraph, weights: np.ndarray, source: int = 0, *,
                     mesh=None, shards: int = None, batch: int = 64,
                     delta: int = 4, relaxed: bool = True,
                     fused: bool = True, sync_every: int = 0,
                     compact=None, split_payload: bool = False,
                     max_rounds: int = 100_000, device="cuda"
                     ) -> Tuple[np.ndarray, Dict]:
    """Delta-stepping SSSP on the priority mesh over one or more shards,
    on ``device`` ("cuda" by default): exact Dijkstra distances at
    quiescence, one readback a drained run when ``fused=True``.  Returns
    (dist as numpy int32, -1 where unreachable, stats)."""
    runner, init_fn = sssp_mesh_rounds_runner(
        g, weights, mesh=mesh, shards=shards, batch=batch, delta=delta,
        relaxed=relaxed, fused=fused, sync_every=sync_every,
        compact=compact, split_payload=split_payload, device=device)
    kw = {"initial_aux": [0]} if split_payload else {}
    dist, _ = runner.run([0], [source], acc=init_fn(source),
                         max_rounds=max_rounds, **kw)
    return dist.cpu().numpy(), dict(runner.stats)
