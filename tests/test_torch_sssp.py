"""The port's delta-stepping SSSP (``repro_torch.apps.sssp``) on the
priority mesh, on the CPU, held against the JAX package.

Mirrors ``tests/test_sssp.py``'s SSSP cases (exact against the Dijkstra
oracle, fused equal to legacy, the delta sweep, the packed-payload guard,
the split payload layout and the cap it lifts), and holds the distances
and every stat bit-identical to the reference's ``sssp_mesh_rounds`` on
road-like and kron-like graphs at 1, 2 and 4 shards, relaxed and strict,
in both payload layouts: one shard in this process, 2 and 4 shards in
one forced-device subprocess per shard count (run once per pytest
run)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.apps import bfs, sssp  # noqa: E402
from repro_torch.distributed import make_mesh  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
STAT_KEYS = ("rounds", "processed", "spawned", "max_occupancy", "drained",
             "host_syncs")
GRAPHS = ("road", "kron")
LAYOUTS = ("packed", "split")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One torch thread for this file's tests: the tier-1 run puts six
    test workers on the machine's cores, where a pool as wide as the cores
    in each only contends with the others; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(name, pkg):
    return (pkg.road_like(144) if name == "road"
            else pkg.kron_like(200, avg_deg=6, seed=2))


def _runs(s, port: bool):
    """Every (graph, relaxed, layout) run at ``s`` shards: {key: {dist,
    stats}}."""
    if port:
        gpkg, spkg = bfs, sssp
        kw = dict(mesh=make_mesh((s,), ("data",)), device="cpu")
    else:
        from repro.apps import bfs as jbfs
        from repro.apps import sssp as jsssp
        from repro.jaxcompat import make_mesh as jmesh
        gpkg, spkg = jbfs, jsssp
        kw = dict(mesh=jmesh((s,), ("data",)))
    out = {}
    for name in GRAPHS:
        g = _graph(name, gpkg)
        w = spkg.with_weights(g, max_w=8, seed=1)
        for relaxed in (True, False):
            for layout in LAYOUTS:
                dist, stats = spkg.sssp_mesh_rounds(
                    g, w, 0, batch=32, relaxed=relaxed,
                    split_payload=layout == "split", **kw)
                out[f"{name}/{relaxed}/{layout}"] = {
                    "dist": np.asarray(dist).tolist(),
                    "stats": [int(stats[k]) for k in STAT_KEYS]}
    return out


_CACHE = {}


def _forced_device_env(n):
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + f" --xla_force_host_platform_device_count={n}"
                        ).strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(REPO, "src"), env.get("PYTHONPATH"), REPO)
        if p)
    return env


def _results(s):
    """(reference, port) runs at ``s`` shards, once each."""
    if s not in _CACHE:
        if s == 1:
            ref = _runs(1, port=False)
        else:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 str(s)], capture_output=True, text=True, cwd=REPO,
                env=_forced_device_env(s), timeout=900)
            assert out.returncode == 0, out.stderr[-3000:]
            ref = json.loads(out.stdout.strip().splitlines()[-1])
        _CACHE[s] = (ref, _runs(s, port=True))
    return _CACHE[s]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("relaxed", (True, False))
@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("s", (1, 2, 4))
def test_bit_identical_to_reference(s, graph, relaxed, layout):
    """dist and every stat (rounds, processed, spawned, max_occupancy,
    drained, host_syncs) equal to the reference's run, and dist equal to
    the Dijkstra oracle."""
    ref, port = _results(s)
    key = f"{graph}/{relaxed}/{layout}"
    assert port[key] == ref[key]
    g = _graph(graph, bfs)
    want = sssp.dijkstra_reference(g, sssp.with_weights(g, max_w=8, seed=1))
    assert port[key]["dist"] == want.tolist()


@pytest.mark.parametrize("relaxed", (True, False))
def test_single_shard_exact_and_bit_identical(relaxed):
    """tests/test_sssp.py: exact against Dijkstra, fused and legacy with
    the same stats, the fused run one readback."""
    for g in (bfs.road_like(144), bfs.kron_like(200, avg_deg=6, seed=2)):
        w = sssp.with_weights(g, max_w=8, seed=1)
        ref = sssp.dijkstra_reference(g, w, 0)
        res = {}
        for fused in (True, False):
            dist, stats = sssp.sssp_mesh_rounds(g, w, 0, shards=1, batch=32,
                                                relaxed=relaxed, fused=fused,
                                                device="cpu")
            np.testing.assert_array_equal(dist, ref)
            res[fused] = stats
        for k in STAT_KEYS[:5]:
            assert res[True][k] == res[False][k], (g.name, k)
        assert res[True]["host_syncs"] == 1
        assert res[False]["host_syncs"] == res[False]["rounds"]


@pytest.mark.parametrize("s", (1, 2, 4))
def test_delta_sweep_stays_exact(s):
    """The bucket width trades rounds for re-relaxations, never
    exactness."""
    g = bfs.road_like(100)
    w = sssp.with_weights(g, max_w=6, seed=3)
    ref = sssp.dijkstra_reference(g, w, 0)
    for delta in (1, 4, 16):
        dist, stats = sssp.sssp_mesh_rounds(g, w, 0, shards=s, batch=16,
                                            delta=delta, device="cpu")
        np.testing.assert_array_equal(dist, ref)
        assert stats["drained"] == 1


def test_payload_guards_match_reference():
    """The packed guard, the split guard and the delta check: the
    reference's errors, word for word."""
    from repro.apps import bfs as jbfs
    from repro.apps import sssp as jsssp
    from repro.jaxcompat import make_mesh as jmesh
    jm = jmesh((1,), ("data",))
    cases = [(jbfs.road_like(144), np.full(528, 2 ** 20, np.int32), {}),
             (jbfs.road_like(144), np.full(528, 2 ** 27, np.int32),
              dict(split_payload=True)),
             (jbfs.road_like(144), np.ones(528, np.int32), dict(delta=0))]
    for g, w, kw in cases:
        assert g.m == len(w)
        msgs = []
        for fn in (lambda: sssp.sssp_mesh_rounds_runner(
                       bfs.road_like(144), w, device="cpu", **kw),
                   lambda: jsssp.sssp_mesh_rounds_runner(g, w, mesh=jm,
                                                         **kw)):
            with pytest.raises(ValueError) as e:
                fn()
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert "packed" in msgs[0] or "delta" in msgs[0]


@pytest.mark.parametrize("relaxed", (True, False))
def test_split_payload_parity(relaxed):
    """The two-plane layout: exact, and fused, legacy and compact with
    the same stats."""
    g = bfs.kron_like(150, avg_deg=5, seed=2)
    w = sssp.with_weights(g, max_w=8, seed=1)
    ref = sssp.dijkstra_reference(g, w, 0)
    res = {}
    for fused in (True, False):
        for compact in (None, True):
            dist, stats = sssp.sssp_mesh_rounds(
                g, w, 0, shards=1, batch=32, relaxed=relaxed, fused=fused,
                compact=compact, split_payload=True, device="cpu")
            np.testing.assert_array_equal(dist, ref)
            res[(fused, compact)] = stats
    for k in STAT_KEYS[:5]:
        assert len({v[k] for v in res.values()}) == 1, (k, res)


@pytest.mark.parametrize("s", (1, 2, 4))
def test_split_payload_lifts_packed_cap(s):
    """A graph whose (d * n + v) packing overflows int32 trips the packed
    guard but runs exact in the split layout."""
    g = bfs.road_like(49)
    w = np.full(g.m, 10 ** 6, np.int32)       # max_d about 48e6
    assert (((g.n - 1) * 10 ** 6 + 10 ** 6) * g.n + g.n - 1) >= 2 ** 31
    with pytest.raises(ValueError, match="packed"):
        sssp.sssp_mesh_rounds_runner(g, w, device="cpu")
    ref = sssp.dijkstra_reference(g, w, 0)
    dist, stats = sssp.sssp_mesh_rounds(g, w, 0, shards=s, batch=16,
                                        split_payload=True, device="cpu")
    np.testing.assert_array_equal(dist, ref)
    assert stats["drained"] == 1


def test_runner_defaults_and_capacity():
    """``shards=`` builds the mesh; the default capacities are the
    reference's (4n / S a shard relaxed, 4n strict)."""
    g = bfs.road_like(1024)
    w = sssp.with_weights(g)
    r, init = sssp.sssp_mesh_rounds_runner(g, w, shards=4, batch=64,
                                           device="cpu")
    assert r.shards == 4 and r.relaxed and r.capacity_log2 == 10
    r, _ = sssp.sssp_mesh_rounds_runner(g, w, shards=4, batch=64,
                                        relaxed=False, device="cpu")
    assert r.capacity_log2 == 12
    assert init(0).tolist() == [sssp.BIG] * g.n


if __name__ == "__main__":
    if "--worker" in sys.argv:
        s = int(sys.argv[sys.argv.index("--worker") + 1])
        print(json.dumps(_runs(s, port=False)))
