"""Round-engine BFS of the port (``repro_torch.apps.bfs``) on the CPU,
held bit-exact against ``repro.apps.bfs``: identical CSR arrays from the
generators, and identical distances, stats and final ring planes from
``bfs_rounds`` on road, kron (compaction engaged) and delaunay graphs at
batch 64 and 256, exact against the sequential BFS oracle."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.apps import bfs as jbfs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.apps import bfs  # noqa: E402
from repro_torch.runtime import fusedrounds  # noqa: E402

STATS = ("rounds", "processed", "spawned", "max_occupancy", "drained")

GRAPHS = {
    "road": lambda m: m.road_like(256),
    "kron": lambda m: m.kron_like(512, avg_deg=4, seed=1),
    "delaunay": lambda m: m.delaunay_like(512),
}


@pytest.mark.parametrize("make", [
    lambda m: m.road_like(256), lambda m: m.road_like(300, seed=3),
    lambda m: m.kron_like(512, avg_deg=4, seed=1), lambda m: m.kron_like(300),
    lambda m: m.delaunay_like(512), lambda m: m.delaunay_like(100, deg=3)],
    ids=["road256", "road300", "kron512", "kron300", "delaunay512",
         "delaunay100"])
def test_generators_match_reference(make):
    g, jg = make(bfs), make(jbfs)
    np.testing.assert_array_equal(g.row_ptr, jg.row_ptr)
    np.testing.assert_array_equal(g.col_idx, jg.col_idx)
    assert g.row_ptr.dtype == g.col_idx.dtype == np.int32
    assert g.name == jg.name


@pytest.mark.parametrize("batch", [64, 256])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfs_rounds_matches_reference(name, batch, monkeypatch):
    jg = GRAPHS[name](jbfs)
    g = interop.csr_from_arrays(jg.row_ptr, jg.col_idx, jg.name)
    compactions = []
    real = fusedrounds.wave_compact

    def counting(*a, **kw):
        compactions.append(kw["width"])
        return real(*a, **kw)

    monkeypatch.setattr(fusedrounds, "wave_compact", counting)
    runner, init_fn = bfs.bfs_rounds_runner(g, batch=batch, device="cpu")
    dist, st = runner.run([0], acc=init_fn(0))
    jrunner, jinit = jbfs.bfs_rounds_runner(jg, batch=batch)
    jdist, jst = jrunner.run([0], acc=jinit(0))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
    for a, b in zip(st[:4], jst[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (st.head, st.tail) == (int(jst.head), int(jst.tail))
    assert ([runner.stats[k] for k in STATS]
            == [jrunner.stats[k] for k in STATS])
    ref = bfs.bfs_reference(g, 0)
    np.testing.assert_array_equal(ref, jbfs.bfs_reference(jg, 0))
    np.testing.assert_array_equal(dist.numpy(), ref)
    # compaction engages when the child wave is wider than the ring: on
    # kron at both batches, on the others only at batch 256
    fan = int(np.diff(g.row_ptr).max())
    wide = batch * fan > runner.capacity
    assert wide == (name == "kron" or batch == 256)
    assert set(compactions) == ({runner.capacity} if wide else set())


def test_bfs_rounds_fused_matches_legacy():
    g = bfs.kron_like(300, avg_deg=6, seed=2)
    dist_f, stats_f = bfs.bfs_rounds(g, 0, batch=32, device="cpu")
    dist_l, stats_l = bfs.bfs_rounds(g, 0, batch=32, fused=False,
                                     device="cpu")
    np.testing.assert_array_equal(dist_f, dist_l)
    np.testing.assert_array_equal(dist_f, bfs.bfs_reference(g, 0))
    assert [stats_f[k] for k in STATS] == [stats_l[k] for k in STATS]
    assert stats_f["host_syncs"] < stats_l["host_syncs"]
