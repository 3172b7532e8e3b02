"""The port's BFS frontier kernel faces and queue-driven BFS on the CPU,
held bit-exact against the JAX package: ``frontier_expand`` against the
Pallas kernel (interpret mode) on ``tests/test_kernels.py:106``'s sweeps,
with -1 slots inside the frontier, duplicate neighbours and ``max_out``
overflow, where the port follows the kernel's clamp; ``ref.
frontier_expand_ref`` against the reference oracle, which drops instead;
and ``bfs_queue`` / ``bfs_baseline`` against ``repro.apps.bfs`` on road,
kron and delaunay graphs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.apps import bfs as jbfs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.frontier import frontier_expand as jfrontier  # noqa
from repro_torch.apps import bfs  # noqa: E402
from repro_torch.kernels import (frontier_buffer, frontier_expand,  # noqa
                                 frontier_level, frontier_level_plain,
                                 frontier_scratch, ref)

# the overflow case: vertex 0 -> 4, 5, 6; vertex 1 -> 5, 7; vertex 3 ->
# 1, 2, 3 (all but 1 and 3 fresh): five fresh vertices into three slots
OVERFLOW = dict(row_ptr=[0, 3, 6, 6, 8, 8, 8, 8, 8],
                col=[4, 5, 6, 5, 7, 1, 2, 3],
                frontier=[0, -1, 1, 3, -1, -1, -1, -1],
                visited=[1, 1, 0, 1, 0, 0, 0, 0])


def _graph(n, deg, seed, dup=False):
    rng = np.random.default_rng(seed)
    col, rp = [], [0]
    for _ in range(n):
        nb = (rng.integers(0, n, deg) if dup
              else rng.choice(n, size=deg, replace=False))
        col.extend(nb.tolist())
        rp.append(len(col))
    return np.asarray(rp, np.int32), np.asarray(col, np.int32)


def _cases():
    """(row_ptr, col, frontier, visited, max_out): the reference sweeps,
    then -1 slots inside the frontier, duplicate neighbours, repeated
    frontier vertices and max_out overflow."""
    out = []
    for n, deg in ((64, 4), (256, 8)):
        rp, col = _graph(n, deg, n)
        f0 = [0, n // 2, n - 1]
        vis = np.zeros(n, np.int32)
        vis[f0] = 1
        frontier = np.asarray(f0 + [-1] * (16 - len(f0)), np.int32)
        out.append((rp, col, frontier, vis, n))
    rng = np.random.default_rng(1)
    for n, deg, fl, max_out in ((64, 5, 12, 64), (128, 6, 20, 7),
                                (200, 3, 30, 1), (96, 8, 16, 40)):
        rp, col = _graph(n, deg, n + 1, dup=True)
        frontier = rng.integers(0, n, fl).astype(np.int32)
        frontier[rng.random(fl) < 0.3] = -1                  # inner -1 slots
        frontier[-1] = frontier[0]                         # a repeat
        vis = (rng.random(n) < 0.3).astype(np.int32)
        out.append((rp, col, frontier, vis, max_out))
    c = OVERFLOW
    for max_out in (3, 5, 8):
        out.append(tuple(np.asarray(c[k], np.int32) for k in
                         ("row_ptr", "col", "frontier", "visited"))
                   + (max_out,))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", range(len(CASES)))
def test_frontier_expand_matches_pallas_kernel(case):
    rp, col, frontier, vis, max_out = CASES[case]
    jout, jcnt, jvis = jfrontier(*map(jnp.asarray, (rp, col, frontier, vis)),
                                 max_out=max_out, interpret=True)
    visited = torch.from_numpy(vis.copy())
    out, cnt, vis2 = frontier_expand(
        *map(torch.from_numpy, (rp, col, frontier)), visited,
        max_out=max_out)
    assert vis2 is visited                      # updated in place
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(vis2.numpy(), np.asarray(jvis))
    assert cnt.shape == (1,) and cnt.dtype == torch.int32


@pytest.mark.parametrize("case", range(len(CASES)))
def test_frontier_level_counts_scanned_edges(case):
    """``frontier_level`` is ``frontier_expand`` plus the level's edge
    count: the degrees of the frontier's live slots, summed, as a (1,)
    int32 tensor on the frontier's device (the card reads nothing
    back)."""
    rp, col, frontier, vis, max_out = CASES[case]
    args = [torch.from_numpy(x) for x in (rp, col, frontier)]
    want = frontier_expand(*args, torch.from_numpy(vis.copy()),
                           max_out=max_out)
    *got, edges = frontier_level(*args, torch.from_numpy(vis.copy()),
                                 max_out=max_out)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    live = frontier[frontier >= 0]
    assert isinstance(edges, torch.Tensor)
    assert edges.shape == (1,) and edges.dtype == torch.int32
    assert edges.device == args[2].device
    assert int(edges[0]) == int((rp[live + 1] - rp[live]).sum())
    plain = frontier_level_plain(*args, torch.from_numpy(vis.copy()),
                                 max_out=max_out)
    for a, b in zip(plain, (*got, edges)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_frontier_ref_matches_reference_oracle(case):
    rp, col, frontier, vis, max_out = CASES[case]
    want = jref.frontier_expand_ref(*map(jnp.asarray, (rp, col, frontier)),
                                    None, jnp.asarray(vis), max_out)
    got = ref.frontier_expand_ref(*map(torch.from_numpy, (rp, col, frontier)),
                                  None, torch.from_numpy(vis), max_out)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_overflow_rules_differ_as_documented():
    """The kernel clamps overflow tickets to the last slot (the last fresh
    vertex wins it); the oracle drops them.  Both count all five."""
    c = {k: torch.tensor(v, dtype=torch.int32) for k, v in OVERFLOW.items()}
    out, cnt, _ = frontier_expand(c["row_ptr"], c["col"], c["frontier"],
                                  c["visited"].clone(), max_out=3)
    assert out.tolist() == [4, 5, 2] and cnt.tolist() == [5]
    rout, rcnt, _ = ref.frontier_expand_ref(c["row_ptr"], c["col"],
                                            c["frontier"], None,
                                            c["visited"], 3)
    assert rout.tolist() == [4, 5, 6] and int(rcnt) == 5


def test_buffer_and_scratch_layout():
    """A kept buffer is (max_out + 1,) of -1 with a zero written-prefix
    word; the scratch starts with the (n,) INT_MAX plane and is zero
    after it, sized for the frontiers it is asked for."""
    buf = frontier_buffer(5, "cpu")
    assert buf.tolist() == [-1] * 5 + [0] and buf.dtype == torch.int32
    scr = frontier_scratch(7, "cpu")
    assert (scr[:7] == 2 ** 31 - 1).all() and (scr[7:] == 0).all()
    assert (frontier_scratch(7, "cpu", max_frontier=5000).shape[0]
            > scr.shape[0])
    c = {k: torch.tensor(v, dtype=torch.int32) for k, v in OVERFLOW.items()}
    with pytest.raises(ValueError, match="max_out"):
        frontier_level(c["row_ptr"], c["col"], c["frontier"],
                       c["visited"].clone(), max_out=3, out=buf)


GRAPHS = {
    "road": lambda m: m.road_like(256),
    "road300": lambda m: m.road_like(300, seed=3),
    "kron": lambda m: m.kron_like(512, avg_deg=4, seed=1),
    "kron16": lambda m: m.kron_like(1024, seed=2),
    "delaunay": lambda m: m.delaunay_like(512),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfs_queue_and_baseline_match_reference(name):
    g, jg = GRAPHS[name](bfs), GRAPHS[name](jbfs)
    for source in (0, g.n // 3):
        dist, stats = bfs.bfs_queue(g, source, device="cpu")
        jdist, jstats = jbfs.bfs_queue(jg, source)
        np.testing.assert_array_equal(dist, jdist)
        assert stats == jstats
        assert dist.dtype == np.int32
        bdist, bstats = bfs.bfs_baseline(g, source, device="cpu")
        jbdist, jbstats = jbfs.bfs_baseline(jg, source)
        np.testing.assert_array_equal(bdist, jbdist)
        assert bstats == jbstats
        np.testing.assert_array_equal(dist, bfs.bfs_reference(g, source))
        np.testing.assert_array_equal(bdist, dist)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_kept_buffers_over_a_bfs_equal_fresh_ones(name):
    """A whole BFS through two kept output buffers, used in turn as
    ``bfs_queue`` does (each call resets only the prefix its buffer held
    before), gives at every level the same next frontier, count, visited
    map and edge count as fresh buffers; each kept buffer is -1 past the
    prefix its last word records."""
    g = GRAPHS[name](bfs)
    n, max_out = g.n, max(g.n, 16)
    rp, col = torch.from_numpy(g.row_ptr), torch.from_numpy(g.col_idx)
    bufs = [frontier_buffer(max_out, "cpu") for _ in range(2)]
    vk = torch.zeros(n, dtype=torch.int32)
    vk[0] = 1
    vf = vk.clone()
    frontier = torch.tensor([0], dtype=torch.int32)
    level, lens = 0, []
    while frontier.numel():
        got = frontier_level(rp, col, frontier, vk, max_out=max_out,
                             out=bufs[level % 2])
        want = frontier_level(rp, col, frontier, vf, max_out=max_out)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        buf, cnt = bufs[level % 2], int(got[1][0])
        assert int(buf[max_out]) == min(cnt, max_out)
        assert (buf[min(cnt, max_out):max_out] == -1).all()
        lens.append(cnt)
        frontier = got[0][:cnt].clone()
        level += 1
    assert len(set(lens)) > 2          # prefixes of several lengths reset


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfs_queue_edges_scanned(name):
    """``edges_scanned`` (summed on the device, read once) is every
    reached vertex's degree, counted once: each is in one frontier."""
    g = GRAPHS[name](bfs)
    dist, stats = bfs.bfs_queue(g, 0, device="cpu")
    deg = np.diff(g.row_ptr)
    assert stats["edges_scanned"] == int(deg[dist >= 0].sum())
    assert isinstance(stats["edges_scanned"], int)
