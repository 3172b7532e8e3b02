"""BFS over CSR graphs — the PyTorch twin of the round-engine and
queue-kernel halves of ``repro/apps/bfs.py``.

The graph generators mirror the Table IV families (road-like, kron-like,
delaunay-like) and produce CSR arrays identical to the reference's.

* ``bfs_rounds`` runs BFS through ``RoundRunner``: the ring carries
  vertex ids, and one step relaxes a batch of vertices against a dense
  padded adjacency table and spawns the neighbours it newly claims.
* ``bfs_queue`` is the paper's level-synchronous design (§ V-B-a): two
  frontier queues alternate across levels, and ``frontier_expand``
  expands one into the other with ticket-ordered appends.
* ``bfs_baseline`` is the Gunrock-style comparison: a dense frontier mask
  swept over every edge each level, with no queue.

* ``bfs_mesh_rounds`` runs it through ``MeshRoundRunner``: the mesh's
  shards on one card, each relaxing its claimed slice of the round with
  packed (distance, vertex) payloads and its own labels, min-combined
  at quiescence.
* ``bfs_runtime`` runs it as dynamically spawned tasks on the host task
  runtime (``TaskFabric`` under ``TaskRuntime``): a simulation in plain
  Python over the simulated atomics, on no device.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ..kernels._build import resolve_device
from ..kernels.frontier import (frontier_buffer, frontier_level,
                                frontier_scratch)
from ..runtime import RoundRunner


@dataclass
class CSRGraph:
    row_ptr: np.ndarray  # (n+1,) int32
    col_idx: np.ndarray  # (m,) int32
    name: str = "g"

    @property
    def n(self) -> int:
        return len(self.row_ptr) - 1

    @property
    def m(self) -> int:
        return len(self.col_idx)


def road_like(n: int, seed: int = 0) -> CSRGraph:
    """Grid graph: low average degree, long diameter (road_usa family).
    Neighbours of each vertex come in the order (0,1), (1,0), (0,-1),
    (-1,0), as in the reference's loop."""
    side = int(np.sqrt(n))
    n = side * side
    v = np.arange(n, dtype=np.int64)
    r, c = v // side, v % side
    nbrs, ok = [], []
    for dr, dc in ((0, 1), (1, 0), (0, -1), (-1, 0)):
        rr, cc = r + dr, c + dc
        ok.append((rr >= 0) & (rr < side) & (cc >= 0) & (cc < side))
        nbrs.append(rr * side + cc)
    ok = np.stack(ok, 1).reshape(-1)          # vertex-major, direction-minor
    rows = np.repeat(v, 4)[ok]
    cols = np.stack(nbrs, 1).reshape(-1)[ok]
    return _to_csr(n, rows, cols, f"road_{n}")


def kron_like(n: int, avg_deg: int = 16, seed: int = 0) -> CSRGraph:
    """Power-law graph (kron_g500 / hollywood family)."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg
    w = 1.0 / np.arange(1, n + 1) ** 0.6
    p = w / w.sum()
    src = rng.choice(n, m, p=p)
    dst = rng.choice(n, m, p=p)
    keep = src != dst
    return _to_csr(n, src[keep], dst[keep], f"kron_{n}")


def delaunay_like(n: int, deg: int = 6, seed: int = 0) -> CSRGraph:
    """Constant-degree random graph (delaunay family)."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, n * deg)
    return _to_csr(n, src, dst, f"delaunay_{n}")


def _to_csr(n: int, rows, cols, name: str) -> CSRGraph:
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    order = np.argsort(rows, kind="stable")
    rows, cols = rows[order], cols[order]
    row_ptr = np.zeros(n + 1, np.int32)
    np.add.at(row_ptr, rows + 1, 1)
    row_ptr = np.cumsum(row_ptr).astype(np.int32)
    return CSRGraph(row_ptr, cols.astype(np.int32), name)


def bfs_runtime(g: CSRGraph, source: int = 0, *, algo: str = "glfq",
                shards: int = 4, workers: int = 16, steal: bool = True,
                policy: str = "gang", seed: int = 0
                ) -> Tuple[np.ndarray, Dict]:
    """Task-runtime BFS: frontier expansion as dynamically spawned tasks on
    the sharded fabric (DESIGN.md § 4.6).

    One task = relax one vertex; its handler scans the adjacency list
    (simulated cost = degree, so power-law graphs yield power-law task
    costs) and spawns a child for every neighbour whose tentative distance
    improves (the handler runs atomically between simulator instructions —
    the host stand-in for an atomic min on the distance array).  Unlike
    ``bfs_queue`` there is no level barrier: the fabric's interleaving may
    discover a vertex via a long path first, and the asynchronous relaxation
    re-spawns it when a shorter path arrives — distances are exact at
    quiescence (monotone label-correcting, Wang et al.'s dynamic
    load-balancing discipline), while the *fabric* still executes every
    spawned task exactly once.  A host simulation: it touches no device
    and takes no ``device``."""
    from ..runtime import ExecutorConfig, TaskFabric, TaskRuntime, TaskSpec

    dist = np.full(g.n, -1, np.int32)
    dist[source] = 0
    edges_scanned = 0

    def handler(rec):
        nonlocal edges_scanned
        v = rec.payload
        dv = int(dist[v])
        lo, hi = int(g.row_ptr[v]), int(g.row_ptr[v + 1])
        edges_scanned += hi - lo
        children = []
        for w in g.col_idx[lo:hi]:
            w = int(w)
            nd = dv + 1
            if dist[w] < 0 or nd < dist[w]:   # atomic relax (host = one step)
                dist[w] = nd
                deg_w = int(g.row_ptr[w + 1]) - int(g.row_ptr[w])
                children.append(TaskSpec(w, cost=max(deg_w, 1)))
        return children

    fabric = TaskFabric(algo=algo, shards=shards,
                        capacity_per_shard=max(2 * g.n // max(shards, 1), 64),
                        num_threads=workers + 1, steal=steal)
    rt = TaskRuntime(fabric, handler,
                     ExecutorConfig(workers=workers, policy=policy, seed=seed,
                                    max_steps=50_000_000))
    rt.add_task(source,
                cost=max(int(g.row_ptr[source + 1]) - int(g.row_ptr[source]), 1))
    metrics = rt.run()
    info = {"tasks": len(rt.executed), "edges_scanned": edges_scanned,
            "steal_rate": metrics["steal_rate"],
            "idle_steps": metrics["idle_steps"],
            "load_imbalance": metrics["load_imbalance"],
            "throughput_ops_per_kstep": metrics["throughput_ops_per_kstep"]}
    return dist, info


def bfs_rounds_runner(g: CSRGraph, *, batch: int = 64, fused: bool = True,
                      sync_every: int = 0, telemetry=None, spans=None,
                      compact=None, device="cuda"):
    """Build the round-engine BFS runner for ``g`` on ``device`` (see
    ``bfs_rounds``).  Returns ``(runner, init_fn)`` where
    ``init_fn(source)`` makes the distance accumulator — callers that run
    BFS repeatedly reuse the runner and its adjacency table.
    ``telemetry`` / ``spans`` (``repro_torch.obs`` collectors) go to the
    fused engine."""
    dev = resolve_device(device)
    n = g.n
    deg = np.diff(g.row_ptr).astype(np.int64)
    fan = max(int(deg.max()) if n else 0, 1)
    nbr = np.full((n, fan), -1, np.int32)
    rows = np.repeat(np.arange(n), deg)
    pos = np.arange(g.m) - np.repeat(g.row_ptr[:-1].astype(np.int64), deg)
    nbr[rows, pos] = g.col_idx
    nbr_t = torch.from_numpy(nbr).to(dev)
    big = np.iinfo(np.int32).max
    order = torch.arange(batch * fan, dtype=torch.int32, device=dev)

    def step(dist, vals, valid):
        v = torch.where(valid, vals, 0)
        dv = torch.where(valid, dist[v], 0)
        w = torch.where(valid[:, None], nbr_t[v], -1)           # (B, F)
        wc = w.clamp(0, n - 1)
        eligible = (w >= 0) & (dist[wc] < 0)
        b, f = w.shape
        wf = w.reshape(-1)
        elig_f = eligible.reshape(-1)
        tgt = torch.where(elig_f, wf, n).long()                 # n = trash slot
        # first parent wins: a scatter-min of the row-major lane order
        claim = torch.full((n + 1,), big, dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, tgt, order[:b * f], "amin")
        win = elig_f & (claim[tgt] == order[:b * f])
        ndist = (dv + 1).repeat_interleave(f)
        # losers write into the trash slot n, which is then cut off
        ext = torch.cat([dist, dist.new_full((1,), -1)])
        ext[torch.where(win, wf, n).long()] = ndist
        return ext[:n], wc, win.reshape(b, f)

    capacity_log2 = max(int(np.ceil(np.log2(max(n + 1, 2 * batch)))), 4)
    runner = RoundRunner(step, capacity_log2=capacity_log2, batch=batch,
                         fused=fused, sync_every=sync_every,
                         telemetry=telemetry, spans=spans, compact=compact,
                         device=dev)

    def init_fn(source: int):
        dist = torch.full((n,), -1, dtype=torch.int32, device=dev)
        dist[source] = 0
        return dist

    return runner, init_fn


def bfs_rounds(g: CSRGraph, source: int = 0, *, batch: int = 64,
               fused: bool = True, sync_every: int = 0,
               max_rounds: int = 100_000, telemetry=None, spans=None,
               device="cuda") -> Tuple[np.ndarray, Dict]:
    """BFS on the deterministic round engine, on ``device`` ("cuda" by
    default).  Within a batch, a vertex reached by several parents goes
    to the row-major-first parent (a scatter-min claim), the batched
    analogue of the sequential queue's first-visit rule, so distances are
    exact.  ``fused=True`` keeps the loop on the device with a readback
    per chunk of rounds; ``fused=False`` is the legacy per-round path.
    Both are bit-identical.  ``telemetry`` / ``spans`` collectors record
    the fused run.  Returns (dist as numpy int32, stats)."""
    runner, init_fn = bfs_rounds_runner(g, batch=batch, fused=fused,
                                        sync_every=sync_every,
                                        telemetry=telemetry, spans=spans,
                                        device=device)
    dist, _ = runner.run([source], acc=init_fn(source),
                         max_rounds=max_rounds)
    return dist.cpu().numpy(), dict(runner.stats)


def bfs_mesh_rounds_runner(g: CSRGraph, *, mesh=None, shards: int = None,
                           axis: str = "data", batch: int = 64,
                           fused: bool = True, sharded: bool = False,
                           sync_every: int = 0, capacity_log2: int = None,
                           telemetry=None, compact=None, device="cuda"):
    """Build the mesh BFS runner on ``device`` (reference
    ``bfs_mesh_rounds_runner``): frontier vertices flow through the mesh
    ring (replicated, or one ring a shard with ``sharded=True``), each
    shard steps its claimed slice of the round, and the children publish
    back in one launch.  ``mesh`` defaults to ``make_mesh((shards,),
    (axis,))`` with one shard.

    The payload packs ``(distance, vertex)`` as ``d * n + v``, so a claim
    is self-contained: a shard can relax a vertex it has never seen.  A
    claim expands only if its distance improves the shard's own label;
    the labels are min-combined at quiescence, which converges to exact
    BFS distances.  ``sharded=True`` is the port's own option (the
    reference's runner builds the replicated ring only): it runs the same
    search on ``ShardedMeshRingEngine`` and gives the same distances, but
    not the same totals, since the sharded claim drains the fullest rings
    first, so the claims arrive in another order and this
    label-correcting search re-expands other vertices.  Returns ``(runner, init_fn)``;
    ``init_fn(source)`` builds the label accumulator."""
    from ..distributed import make_mesh
    from ..runtime import MeshRoundRunner

    dev = resolve_device(device)
    n = g.n
    if mesh is None:
        mesh = make_mesh((shards or 1,), (axis,))
    nshards = int(mesh.shape[axis])
    if n * (n + 2) >= 2 ** 31:
        raise ValueError(f"graph too large for packed (d, v) payloads: "
                         f"n={n} needs n*(n+2) < 2^31")
    deg = np.diff(g.row_ptr).astype(np.int64)
    fan = max(int(deg.max()) if n else 0, 1)
    # the in-batch winner key is nd * (batch * fan) + order, nd <= n
    if (n + 1) * batch * fan >= 2 ** 31:
        raise ValueError(f"batch {batch} x max degree {fan} too wide for "
                         f"int32 winner keys on n={n}: needs "
                         f"(n+1)*batch*fan < 2^31")
    nbr = np.full((n, fan), -1, np.int32)
    rows = np.repeat(np.arange(n), deg)
    pos = np.arange(g.m) - np.repeat(g.row_ptr[:-1].astype(np.int64), deg)
    nbr[rows, pos] = g.col_idx
    nbr_t = torch.from_numpy(nbr).to(dev)
    big = np.iinfo(np.int32).max
    bf = batch * fan
    order = torch.arange(bf, dtype=torch.int32, device=dev)

    def step(dist, vals, valid):
        v = torch.where(valid, vals % n, 0)
        d = torch.where(valid, vals // n, 0)
        # expand unless the shard's label already beats the claim (labels
        # are real path lengths >= the true distance; claims equal to the
        # label re-expand but spawn only improving children)
        fresh = valid & (d <= dist[v])
        ext = torch.cat([dist, dist.new_full((1,), big)])   # n: dropped
        ext.scatter_reduce_(0, torch.where(fresh, v, n).long(), d, "amin")
        dist = ext[:n]
        w = torch.where(fresh[:, None], nbr_t[v], -1)          # (B, F)
        wc = w.clamp(0, n - 1)
        nd = torch.broadcast_to((d + 1)[:, None], w.shape)
        elig = (w >= 0) & (nd < dist[wc])
        # in-batch winner per target: the least nd, then row-major order
        key = nd.reshape(-1) * bf + order
        ef, wf, ndf = elig.reshape(-1), w.reshape(-1), nd.reshape(-1)
        tgt = torch.where(ef, wf, n).long()
        claim = torch.full((n + 1,), big, dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, tgt, torch.where(ef, key, big), "amin")
        win = ef & (claim[tgt] == key)
        ext = torch.cat([dist, dist.new_full((1,), big)])
        ext.scatter_reduce_(0, torch.where(win, wf, n).long(), ndf, "amin")
        cv = torch.where(win, ndf * n + wf.clamp(0, n - 1), 0)
        return ext[:n], cv.reshape(w.shape), win.reshape(w.shape)

    def combine(stacked):                              # (shards, n) labels
        m = stacked.min(0).values
        return torch.where(m == big, -1, m)

    if capacity_log2 is None:
        capacity_log2 = max(
            int(np.ceil(np.log2(max(2 * n * nshards, 4 * batch * nshards)))),
            4)
    runner = MeshRoundRunner(step, mesh=mesh, axis=axis,
                             capacity_log2=capacity_log2, batch=batch,
                             fused=fused, sharded=sharded,
                             sync_every=sync_every, combine=combine,
                             telemetry=telemetry, compact=compact,
                             device=dev)

    def init_fn(source: int):
        # every label unvisited: the source's 0 arrives with its seed
        # claim (set here, it would make that claim non-improving)
        del source
        return torch.full((n,), big, dtype=torch.int32, device=dev)

    return runner, init_fn


def bfs_mesh_rounds(g: CSRGraph, source: int = 0, *, mesh=None,
                    shards: int = None, batch: int = 64, fused: bool = True,
                    sharded: bool = False, sync_every: int = 0,
                    max_rounds: int = 100_000, device="cuda"
                    ) -> Tuple[np.ndarray, Dict]:
    """BFS on the mesh round engine over one or more shards, on
    ``device`` ("cuda" by default): exact distances at quiescence, one
    readback a drained run when ``fused=True``.  With ``sharded=True``
    the processed and spawned totals depend on the sharded claim's order
    (see ``bfs_mesh_rounds_runner``).  Returns (dist as numpy int32,
    stats)."""
    runner, init_fn = bfs_mesh_rounds_runner(g, mesh=mesh, shards=shards,
                                             batch=batch, fused=fused,
                                             sharded=sharded,
                                             sync_every=sync_every,
                                             device=device)
    dist, _ = runner.run([source], acc=init_fn(source),
                         max_rounds=max_rounds)
    return dist.cpu().numpy(), dict(runner.stats)


def bfs_queue(g: CSRGraph, source: int = 0, *, device="cuda"
              ) -> Tuple[np.ndarray, Dict]:
    """Queue-driven BFS on ``device`` ("cuda" by default): alternate two
    frontier queues across levels through ``frontier_expand``.  Each level
    hands the kernel the live prefix ``frontier[:count]`` of the last
    level's output (the reference hands it the whole -1-padded buffer,
    whose -1 slots are skipped, so the result is the same and a level's
    work follows the frontier, not n).  The two queues are kept output
    buffers (``frontier_buffer``), filled with -1 once: each level resets
    only the prefix its buffer held two levels before.  ``visited`` and
    the scanned-edge total stay on the device; the host reads one int per
    level, its fresh count, and the edge total once at the end.  Returns
    (dist as numpy int32, {"levels", "edges_scanned"}) — ``levels`` counts
    the last, empty expansion, as the reference does."""
    dev = resolve_device(device)
    n = g.n
    row_ptr = torch.from_numpy(g.row_ptr).to(dev)
    col_idx = torch.from_numpy(g.col_idx).to(dev)
    visited = torch.zeros(n, dtype=torch.int32, device=dev)
    visited[source] = 1
    dist = torch.full((n,), -1, dtype=torch.int32, device=dev)
    dist[source] = 0
    max_out = max(n, 16)
    scratch = frontier_scratch(n, dev)
    queues = [frontier_buffer(max_out, dev), frontier_buffer(max_out, dev)]
    edges = torch.zeros((), dtype=torch.int64, device=dev)
    frontier = torch.tensor([source], dtype=torch.int32, device=dev)
    level, flen = 0, 1
    while flen > 0:
        nxt, cnt, visited, scanned = frontier_level(
            row_ptr, col_idx, frontier, visited, max_out=max_out,
            scratch=scratch, out=queues[level % 2])
        edges += scanned[0]
        flen = int(cnt[0])
        level += 1
        frontier = nxt[:flen]
        dist[frontier.long()] = level
    return dist.cpu().numpy(), {"levels": level,
                                "edges_scanned": int(edges)}


def bfs_baseline(g: CSRGraph, source: int = 0, *, device="cuda"
                 ) -> Tuple[np.ndarray, Dict]:
    """Gunrock-style dense sweep on ``device`` ("cuda" by default): per
    level, gather the frontier mask at every edge's source and
    scatter-max it onto the edge's target (no queue, no compaction).
    Plain PyTorch; the host reads one flag per level.  Returns (dist as
    numpy int32, {"levels"}), with the reference's level count."""
    dev = resolve_device(device)
    n = g.n
    src = torch.repeat_interleave(
        torch.arange(n, device=dev),
        torch.from_numpy(np.diff(g.row_ptr).astype(np.int64)).to(dev))
    col = torch.from_numpy(g.col_idx).to(dev).long()
    front = torch.zeros(n, dtype=torch.bool, device=dev)
    front[source] = True
    visited = front.clone()
    dist = torch.full((n,), -1, dtype=torch.int32, device=dev)
    dist[source] = 0
    level = 0
    while True:
        touched = torch.zeros(n, dtype=torch.int32, device=dev)
        touched.scatter_reduce_(0, col, front[src].int(), "amax")
        front = (touched > 0) & ~visited
        visited |= front
        level += 1
        dist = torch.where(front & (dist == -1), level, dist)
        if not bool(front.any()):
            break
    return dist.cpu().numpy(), {"levels": level}


def bfs_reference(g: CSRGraph, source: int = 0) -> np.ndarray:
    """Plain numpy BFS oracle."""
    dist = np.full(g.n, -1, np.int32)
    dist[source] = 0
    dq = deque([source])
    while dq:
        u = dq.popleft()
        for k in range(g.row_ptr[u], g.row_ptr[u + 1]):
            v = g.col_idx[k]
            if dist[v] < 0:
                dist[v] = dist[u] + 1
                dq.append(v)
    return dist
