"""The port's host task runtime (``repro_torch.runtime``: ``TaskFabric``,
``PriorityFabric``, ``HostTaskPool``, ``TaskRuntime``), its functional
mesh round (``mesh_task_round``) and its consumers (``apps.bfs.
bfs_runtime``, ``apps.raytrace.render_runtime``) on the CPU, held against
the JAX package.

The fabrics and the executor are plain Python in both packages, so the
same seeded runs must give equal results: the executed order, the
metrics dict, every shard's history event by event and the queue waits
(``wait_stats``), and every shard's history is linearizable under the
port's own checker.  ``mesh_task_round`` is integer state throughout and
bit-exact against the reference's under ``shard_map``: at one shard in
this process, at 2 and 4 shards in one forced-device subprocess per
shard count (once per pytest run), from rings whose tickets start below
and across 2^31 and 2^32.  ``bfs_runtime`` gives the reference's ``dist``
and ``info``.  ``render_runtime`` equals the port's ``render_queue`` bit
for bit; against the reference it holds to the float bounds of
``tests/test_torch_raytrace.py`` (XLA contracts some trace products into
fused multiply-adds), with the ray and task counts equal on cornell."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as JC  # noqa: E402
import repro.runtime as JR  # noqa: E402
import repro_torch.core as TC  # noqa: E402
import repro_torch.runtime as TR  # noqa: E402
from repro_torch.core import check_linearizable  # noqa: E402
from repro_torch.sched import check_p_linearizable  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ALGOS = sorted(JC.QUEUE_CLASSES)
SCHEDULES = ("random", "gang", "rr")
PACKAGES = (JR, TR)


def _events(hist):
    return [dataclasses.astuple(e) for e in hist]


def _result(rt, fabric, metrics):
    """Everything a finished runtime exposes, as plain values."""
    return {"executed": list(rt.executed), "metrics": dict(metrics),
            "shard_history": {k: _events(h)
                              for k, h in fabric.shard_history.items()},
            "waits": fabric.wait_stats(),
            "steals": fabric.metrics.steals}


def _tree(rt_pkg, make_fabric, sched_policy, *, workers=8, depth=4,
          roots=2, seed=7):
    """tests/test_runtime.py's binary-tree spawn workload: every task of
    depth d > 0 spawns two children of depth d - 1."""
    def handler(rec):
        d = rec.payload
        if d <= 0:
            return []
        return [rt_pkg.TaskSpec(d - 1, cost=1, priority=1),
                rt_pkg.TaskSpec(d - 1, cost=1, priority=1)]

    fabric = make_fabric(rt_pkg)
    rt = rt_pkg.TaskRuntime(fabric, handler, rt_pkg.ExecutorConfig(
        workers=workers, policy=sched_policy, seed=seed))
    for _ in range(roots):
        rt.add_task(depth, cost=1)
    metrics = rt.run()
    return rt, fabric, metrics, roots * (2 ** (depth + 1) - 1)


@pytest.mark.parametrize("steal", (True, False), ids=("steal", "nosteal"))
@pytest.mark.parametrize("policy", SCHEDULES)
@pytest.mark.parametrize("algo", ALGOS)
def test_task_fabric_tree_equals_reference(algo, policy, steal):
    out = []
    for pkg in PACKAGES:
        rt, fabric, m, total = _tree(
            pkg, lambda p: p.TaskFabric(algo=algo, shards=2,
                                        capacity_per_shard=128,
                                        num_threads=9, steal=steal),
            policy)
        out.append(_result(rt, fabric, m))
    ref, got = out
    for key in ref:
        assert got[key] == ref[key], key
    assert got["metrics"]["completed"] == 1.0
    ids = [t for t, _ in got["executed"]]
    assert len(ids) == total and len(set(ids)) == total
    if not steal:
        assert got["metrics"]["steals"] == 0
    for key, hist in fabric.shard_history.items():
        res = check_linearizable(hist)
        assert res.ok, f"shard {key}: {res.reason}"


@pytest.mark.parametrize("sched_policy", SCHEDULES)
@pytest.mark.parametrize("policy", ("strict", "weighted", "edf"))
def test_priority_fabric_tree_equals_reference(policy, sched_policy):
    out = []
    for pkg in PACKAGES:
        rt, fabric, m, total = _tree(
            pkg, lambda p: p.PriorityFabric(policy=policy, shards=2,
                                            capacity_per_shard=128,
                                            num_threads=9),
            sched_policy)
        out.append(_result(rt, fabric, m))
    ref, got = out
    for key in ref:
        assert got[key] == ref[key], key
    ids = [t for t, _ in got["executed"]]
    assert len(ids) == total and len(set(ids)) == total
    for shard, hist in fabric.shard_history.items():
        res = check_p_linearizable(hist, k=0)   # strict shards: k = 0
        assert res.ok, f"shard {shard}: {res.reason}"


def _skew(pkg):
    fabric = pkg.TaskFabric(algo="glfq", shards=2, capacity_per_shard=128,
                            num_threads=17, steal=True)
    rt = pkg.TaskRuntime(fabric, lambda rec: [],
                         pkg.ExecutorConfig(workers=16, policy="gang",
                                            seed=0))
    for i in range(64):
        rt.add_task(i, cost=4, affinity=0)
    return rt, fabric, rt.run()


def _preempt(pkg):
    fabric = pkg.TaskFabric(algo="glfq", shards=1, capacity_per_shard=128,
                            num_threads=2, steal=False)
    rt = pkg.TaskRuntime(fabric, lambda rec: [],
                         pkg.ExecutorConfig(workers=1, policy="rr", seed=0))
    rt.add_task(("warmup", 0), priority=0, cost=2000)
    for i in range(12):
        rt.add_task(("lo", i), priority=1, cost=1)
    for i in range(12):
        rt.add_task(("hi", i), priority=0, cost=1)
    return rt, fabric, rt.run()


def _priority_steal(pkg):
    fabric = pkg.PriorityFabric(policy="strict", shards=2,
                                capacity_per_shard=64, num_threads=2)
    rt = pkg.TaskRuntime(fabric, lambda rec: [],
                         pkg.ExecutorConfig(workers=1, policy="rr", seed=0))
    rt.add_task(("warm",), priority=0, cost=800, affinity=0)
    for i in range(6):
        rt.add_task(("n", i), priority=1, cost=1, at_step=10, affinity=0)
    for i in range(6):
        rt.add_task(("u", i), priority=0, cost=1, at_step=10, affinity=1)
    return rt, fabric, rt.run()


@pytest.mark.parametrize("scenario", (_skew, _preempt, _priority_steal),
                         ids=("stealing_under_skew", "lane_preempts",
                              "priority_steals_first"))
def test_runtime_scenarios_equal_reference(scenario):
    """tests/test_runtime.py's and tests/test_sched.py's scenarios:
    stealing under affinity skew, the urgent lane pre-empting, and the
    priority fabric stealing highest-priority-first."""
    ref = _result(*scenario(JR))
    rt, fabric, m = scenario(TR)
    got = _result(rt, fabric, m)
    for key in ref:
        assert got[key] == ref[key], key
    assert m["completed"] == 1.0
    if scenario is _skew:
        assert m["steals"] > 0 and m["steal_rate"] > 0.02
    else:
        warm = "warmup" if scenario is _preempt else "warm"
        first = "hi" if scenario is _preempt else "u"
        n = 12 if scenario is _preempt else 6
        order = [fabric.tasks[t].payload[0] for t, _ in rt.executed
                 if fabric.tasks[t].payload[0] != warm]
        assert order[:n] == [first] * n, order


def test_register_rejects_out_of_range_priority():
    for pkg in PACKAGES:
        fabric = pkg.TaskFabric(algo="glfq", shards=1, lanes=2,
                                num_threads=2)
        for bad in (2, -1):
            with pytest.raises(ValueError):
                fabric.register("x", priority=bad)
        fabric.register("x", priority=1)
        pfabric = pkg.PriorityFabric(policy="edf", shards=1, num_threads=2)
        with pytest.raises(ValueError):
            pfabric.register("x", priority=5)


def test_executor_metrics_equal_reference():
    out = []
    for pkg in PACKAGES:
        _, _, m, _ = _tree(pkg, lambda p: p.TaskFabric(
            algo="gwfq", shards=2, capacity_per_shard=128, num_threads=9),
            "gang", seed=1)
        out.append(m)
    assert out[1] == out[0]
    for key in ("throughput_ops_per_kstep", "idle_steps", "steal_rate",
                "load_imbalance", "worker_imbalance", "tasks_executed",
                "steps_per_op", "stall_steps_per_op"):
        assert key in out[1], key


def _pool_run(pkg, seed):
    """A seeded mix of urgent and normal items through a small
    ``HostTaskPool`` (two shards, two lanes, two items a ring, so some
    enqueues are refused), dequeued from seeded affinities."""
    rng = np.random.default_rng(seed)
    pool = pkg.HostTaskPool(4, shards=2, lanes=2)
    log = []
    for i in range(40):
        if rng.random() < 0.7:
            pri = int(rng.integers(0, 2))
            log.append(("enq", i, pri, pool.enqueue((pri, i), timeout=0.0,
                                                    priority=pri)))
        else:
            log.append(("deq", pool.dequeue(timeout=0.0,
                                            affinity=int(rng.integers(2)))))
    drained = []
    while not pool.empty():
        drained.append(pool.dequeue(timeout=0.0, affinity=1))
    return log, drained, dict(pool.metrics), pool.capacity


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_host_task_pool_equals_reference(seed):
    """Strict lane order and stealing: the same items come back in the
    same order, with the same rejects and steals; every drained urgent
    item precedes every drained normal one."""
    ref, got = (_pool_run(pkg, seed) for pkg in PACKAGES)
    assert got == ref
    log, drained, metrics, _ = got
    lanes = [item[0] for item in drained]
    assert lanes == sorted(lanes)
    assert metrics["steals"] > 0 and metrics["rejects"] > 0


# -- mesh_task_round ----------------------------------------------------------

# tickets start below 2^31 and 2^32 (multiples of the ring's 2n = 32) and
# cross them within the rounds
STARTS = (None, 2 ** 31 - 32, 2 ** 32 - 32)
SHARDS = (1, 2, 4)
CAP, B, ROUNDS = 16, 4, 12


def _mtr_inputs(s, seed):
    rng = np.random.default_rng(seed)
    out = []
    for r in range(ROUNDS):
        d = {"vals": rng.integers(1, 10_000, (s, B)) + r * 10_000,
             "spawn": rng.random((s, B)) < 0.8,
             "claim": rng.random((s, B)) < 0.6}
        if r == 2:
            d["spawn"][:] = False
        if r == 3:
            d["claim"][-1] = False
        out.append({k: v.astype(np.int32) for k, v in d.items()})
    return out


def _put(res, key, **arrays):
    for name, a in arrays.items():
        res[f"{key}/{name}"] = np.asarray(a).astype(np.int64).tolist()


def _mtr_reference(s):
    """The scenario through ``repro.runtime.mesh_task_round`` under
    ``shard_map`` on ``s`` devices: {key: nested list}."""
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro.core.distqueue import dist_queue_init
    from repro.jaxcompat import make_mesh

    mesh = make_mesh((s,), ("data",))
    d, r_ = P("data"), P()
    f = jax.jit(shard_map(
        lambda st, v, sm, cm: JR.mesh_task_round(st, v, sm, cm, "data"),
        mesh=mesh, in_specs=(r_, d, d, d), out_specs=(r_, d, d, d)))
    res = {}
    for start in STARTS:
        st = dist_queue_init(CAP, start=start)
        for r, x in enumerate(_mtr_inputs(s, 11 + s)):
            st, g, v, ok = f(st, x["vals"].reshape(-1),
                             x["spawn"].reshape(-1), x["claim"].reshape(-1))
            _put(res, f"{start}/{r}", g=g, v=v, ok=ok, planes=st[:4],
                 ht=[st.tail, st.head])
    return res


def _mtr_port(s):
    res = {}
    for start in STARTS:
        st = TC.dist_queue_init(CAP, start=start, device="cpu")
        for r, x in enumerate(_mtr_inputs(s, 11 + s)):
            st, g, v, ok = TR.mesh_task_round(
                st, torch.as_tensor(x["vals"]), torch.as_tensor(x["spawn"]),
                torch.as_tensor(x["claim"]))
            assert g.shape == v.shape == ok.shape == (s, B)
            _put(res, f"{start}/{r}", g=g.reshape(-1), v=v.reshape(-1),
                 ok=ok.reshape(-1), planes=[p.numpy() for p in st[:4]],
                 ht=[int(st.tail), int(st.head)])
    return res


_MTR = {}


def _mtr_results(s):
    if s not in _MTR:
        if s == 1:
            ref = _mtr_reference(1)
        else:
            env = dict(os.environ)
            env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + f" --xla_force_"
                                f"host_platform_device_count={s}").strip()
            env["JAX_PLATFORMS"] = "cpu"
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (os.path.join(REPO, "src"),
                            env.get("PYTHONPATH"), REPO) if p)
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 str(s)], capture_output=True, text=True, cwd=REPO, env=env,
                timeout=600)
            assert out.returncode == 0, out.stderr[-3000:]
            ref = json.loads(out.stdout.strip().splitlines()[-1])
        _MTR[s] = (ref, _mtr_port(s))
    return _MTR[s]


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("s", SHARDS)
def test_mesh_task_round_bit_exact(s, start):
    """Publish then claim, round after round, with one round spawning
    nothing and one shard claiming nothing: every plane, head/tail,
    granted, claimed value and ok equal to the reference's at ``s``
    shards, from a ring whose tickets start at ``start``."""
    ref, port = _mtr_results(s)
    keys = sorted(k for k in ref if k.startswith(f"{start}/"))
    assert keys == sorted(k for k in port if k.startswith(f"{start}/"))
    for k in keys:
        assert port[k] == ref[k], k
    if start is not None:
        last = port[f"{start}/{ROUNDS - 1}/ht"]
        first = (start + 2 ** 31) % 2 ** 32 - 2 ** 31
        assert (last[0] - first) % 2 ** 32 > 32   # the tail crossed


def test_mesh_task_round_fifo_single_shard():
    """tests/test_runtime.py: one shard publishes four values and claims
    them back in order."""
    st = TC.dist_queue_init(16, device="cpu")
    vals = torch.tensor([[11, 12, 13, 14]], dtype=torch.int32)
    ones = torch.ones((1, 4), dtype=torch.int32)
    st, granted, got, ok = TR.mesh_task_round(st, vals, ones, ones)
    assert bool(granted.all()) and bool(ok.all())
    assert got.tolist() == vals.tolist()


# -- consumers ----------------------------------------------------------------


@pytest.mark.parametrize("algo", ("glfq", "sfq"))
def test_bfs_runtime_equals_reference(algo):
    from repro.apps import bfs as jbfs
    from repro_torch.apps import bfs as tbfs
    g = tbfs.kron_like(200, avg_deg=6, seed=2)
    jg = jbfs.kron_like(200, avg_deg=6, seed=2)
    assert np.array_equal(g.row_ptr, jg.row_ptr)
    assert np.array_equal(g.col_idx, jg.col_idx)
    kw = dict(algo=algo, shards=2, workers=8, policy="random", seed=5)
    dist, info = tbfs.bfs_runtime(g, 0, **kw)
    jdist, jinfo = jbfs.bfs_runtime(jg, 0, **kw)
    assert np.array_equal(dist, jdist)
    assert np.array_equal(dist, tbfs.bfs_reference(g, 0))
    assert info == jinfo
    assert info["tasks"] >= int((dist >= 0).sum()) - 1


@pytest.mark.parametrize("name", ("cornell", "complex"))
def test_render_runtime_equals_render_queue(name):
    """Inside the port the host fabric's render is ``render_queue``'s
    image bit for bit: each pixel takes the same adds in the same order,
    whatever the interleaving."""
    from repro_torch.apps import raytrace as T
    scene = getattr(T, f"{name}_scene")()
    img, info = T.render_runtime(scene, 64, 64, workers=4, shards=2, seed=1,
                                 device="cpu")
    qimg, qinfo = T.render_queue(scene, 64, 64, device="cpu")
    assert np.array_equal(img, qimg)
    assert info["rays"] == qinfo["rays"]
    assert info["tasks"] == info["waves"] > 0


@pytest.mark.parametrize("n", (16, 32))
@pytest.mark.parametrize("name", ("cornell", "complex"))
def test_render_runtime_matches_reference(name, n):
    """Against the reference's ``render_runtime``: cornell within 1e-4
    with equal rays, tasks, steal rate and idle steps; the complex scene
    with rays exact, at least 99 % of the pixels within 1e-4 and every
    pixel finite (``tests/test_torch_raytrace.py``'s bounds)."""
    from repro.apps import raytrace as R
    from repro_torch.apps import raytrace as T
    kw = dict(workers=4, shards=2, seed=1)
    img, info = T.render_runtime(getattr(T, f"{name}_scene")(), n, n,
                                 device="cpu", **kw)
    jimg, jinfo = R.render_runtime(getattr(R, f"{name}_scene")(), n, n, **kw)
    assert np.isfinite(img).all()
    assert info["rays"] == jinfo["rays"]
    assert set(info) == set(jinfo)
    if name == "cornell":
        for key in ("tasks", "steal_rate", "idle_steps", "waves"):
            assert info[key] == jinfo[key], key
        np.testing.assert_allclose(img, jimg, rtol=0, atol=1e-4)
    else:
        close = (np.abs(img - jimg) <= 1e-4).all(-1)
        assert close.mean() >= 0.99, close.mean()


def test_runtime_exports_the_reference_host_names():
    """Every public name of ``repro.runtime`` but the JAX engines'
    deprecated ``Fused*`` shims."""
    want = {n for n in JR.__all__ if not n.startswith("Fused")}
    assert want <= set(TR.__all__), sorted(want - set(TR.__all__))


if __name__ == "__main__":
    if "--worker" in sys.argv:
        print(json.dumps(_mtr_reference(int(sys.argv[sys.argv.index(
            "--worker") + 1]))))
