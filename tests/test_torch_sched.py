"""The port's G-PQ layer (``repro_torch.sched``: ``GPQ``, ``RelaxedGPQ``,
the priority-linearizability checker and ``mesh_relaxation_bound``) on
the CPU, held against the JAX package's ``repro.sched``.

Both packages are plain Python here, so everything must be equal:

* ``GPQ`` and ``RelaxedGPQ`` (one ring with lazy 0 and 3, three rings
  with lazy 2, four with lazy 0) under the ``random``, ``gang`` and
  ``rr`` schedules: the histories event by event, the scheduler's
  metrics, the memory words, and the verdicts (reason and node count
  included) of ``check_p_linearizable`` at k = 0 and at the queue's
  bound, and of ``check_p_linearizable_search`` on small runs;
* the checker fixtures of ``tests/test_sched.py``, positive and
  negative, at k = 0 and k = 1;
* ``mesh_relaxation_bound`` over a grid of (shards, batch, occupancy,
  lazy, rings, threads);
* the priority mesh's recorded history: ``PriorityMeshRoundRunner(
  trace=True)`` of the port at 2 shards through the port's
  ``mesh_trace_history`` equals the reference's history of the
  reference's own 2-shard run (a forced-device subprocess, once per
  pytest run), and the port's checker accepts it at
  ``mesh_relaxation_bound``."""

import dataclasses
import json
import os
import random
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro.core as JC  # noqa: E402
import repro.sched as JS  # noqa: E402
import repro_torch.core as TC  # noqa: E402
import repro_torch.sched as TS  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SCHEDULES = ("random", "gang", "rr")
SEEDS = (0, 1, 2)
RELAXED = ((1, 0), (1, 3), (3, 2), (4, 0))     # (rings, lazy)
PACKAGES = ((JC, JS), (TC, TS))


def _run_pq(core, pq, policy, seed, *, n_threads=12, ops=8, wave=4,
            p_ins=0.55, key_range=50):
    """tests/test_sched.py: _run_pq, on either package."""
    mem = core.AtomicMemory()
    sched = core.Scheduler(mem, wave_size=wave, policy=policy, seed=seed)
    pq.init(mem)

    def body(ctx, tid):
        rng = random.Random(seed * 1009 + tid)
        for k in range(ops):
            if rng.random() < p_ins:
                yield from pq.insert(ctx, tid, rng.randrange(key_range),
                                     tid * 1000 + k)
            else:
                yield from pq.delete_min(ctx, tid)

    for _ in range(n_threads):
        sched.spawn(body)
    assert sched.run(2_000_000), "simulation did not finish"
    return sched


def _state(sched):
    mem = sched.mem
    return {"history": [dataclasses.astuple(e) for e in sched.history],
            "metrics": sched.metrics(), "steps": sched.step_count,
            "memory": ({k: v.tolist() for k, v in mem._arrays.items()},
                       dict(mem.op_counts), dict(mem.rmw_traffic))}


def _verdicts(sched_pkg, hist, ks, search=False):
    out = {}
    for k in ks:
        out[f"pattern/{k}"] = dataclasses.astuple(
            sched_pkg.check_p_linearizable(hist, k=k))
        if search:
            out[f"search/{k}"] = dataclasses.astuple(
                sched_pkg.check_p_linearizable_search(hist, k=k))
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("policy", SCHEDULES)
def test_gpq_equals_reference(policy, seed):
    """Strict G-PQ: equal runs, and both histories priority-linearizable
    at k = 0."""
    res = []
    for core, sched_pkg in PACKAGES:
        s = _run_pq(core, sched_pkg.GPQ(64, 13, tag=f"g_{policy}_{seed}"),
                    policy, seed)
        res.append(dict(_state(s), **_verdicts(sched_pkg, s.history, (0,))))
    assert res[1] == res[0]
    assert res[1]["pattern/0"][0], res[1]["pattern/0"]


@pytest.mark.parametrize("policy", SCHEDULES)
def test_gpq_search_oracle_equals_reference(policy):
    """Small strict runs: the exact search and the pattern checker give
    the reference's verdicts (and accept) at k = 0."""
    for seed in range(4):
        res = []
        for core, sched_pkg in PACKAGES:
            s = _run_pq(core, sched_pkg.GPQ(8, 5, tag=f"gs_{policy}_{seed}"),
                        policy, seed, n_threads=4, ops=3)
            res.append(dict(_state(s), **_verdicts(
                sched_pkg, s.history, (0,), search=True)))
        assert res[1] == res[0], seed
        assert res[1]["search/0"][0] and res[1]["pattern/0"][0]


@pytest.mark.parametrize("rings,lazy", RELAXED,
                         ids=[f"r{r}_l{z}" for r, z in RELAXED])
@pytest.mark.parametrize("policy", SCHEDULES)
def test_relaxed_gpq_equals_reference(policy, rings, lazy):
    """k-relaxed G-PQ at two seeds: equal runs and bounds, and equal
    verdicts at k = 0 and at the queue's relaxation bound, which the
    port's history meets."""
    for seed in SEEDS[:2]:
        res = []
        for core, sched_pkg in PACKAGES:
            pq = sched_pkg.RelaxedGPQ(
                64, 13, tag=f"r_{rings}_{lazy}_{policy}_{seed}",
                rings=rings, lazy=lazy)
            s = _run_pq(core, pq, policy, seed)
            bound = pq.relaxation_bound()
            res.append(dict(_state(s), bound=bound, **_verdicts(
                sched_pkg, s.history, (0, bound))))
        assert res[1] == res[0], seed
        assert res[1][f"pattern/{res[1]['bound']}"][0]


@pytest.mark.parametrize("policy", SCHEDULES)
def test_cross_validation_equals_reference(policy):
    """tests/test_sched.py's cross-validation runs (two rings, lazy 1,
    four threads): the pattern checker and the exact search at k = 0, 2
    and 8 give the reference's verdicts, and the pattern check is sound
    against the search."""
    for seed in range(5):
        res = []
        for core, sched_pkg in PACKAGES:
            pq = sched_pkg.RelaxedGPQ(16, 5, tag=f"cv_{policy}_{seed}",
                                      rings=2, lazy=1)
            s = _run_pq(core, pq, policy, seed, n_threads=4, ops=3,
                        key_range=10)
            out = _state(s)
            for k in (0, 2, 8):
                out[f"pattern/{k}"] = dataclasses.astuple(
                    sched_pkg.check_p_linearizable(s.history, k=k))
                out[f"search/{k}"] = dataclasses.astuple(
                    sched_pkg.check_p_linearizable_search(
                        s.history, k=k, max_nodes=400_000))
            res.append(out)
        assert res[1] == res[0], seed
        for k in (0, 2, 8):
            if res[1][f"search/{k}"][0]:
                assert res[1][f"pattern/{k}"][0], (seed, k)


# -- checker fixtures (tests/test_sched.py) -----------------------------------

INS, DELMIN = JS.INS, JS.DELMIN
FIXTURES = {
    # positive
    "sequential": ([(0, INS, (5, 100), True, 1, 2),
                    (0, INS, (3, 101), True, 3, 4),
                    (0, DELMIN, None, (3, 101), 5, 6),
                    (0, DELMIN, None, (5, 100), 7, 8),
                    (0, DELMIN, None, None, 9, 10)], True),
    "concurrent_either": ([(0, INS, (5, 100), True, 1, 10),
                           (1, INS, (3, 101), True, 2, 9),
                           (2, DELMIN, None, (5, 100), 3, 8)], True),
    "empty_before_insert": ([(0, DELMIN, None, None, 1, 4),
                             (1, INS, (7, 100), True, 2, 6)], True),
    # negative
    "q3_smaller_pending": ([(0, INS, (3, 100), True, 1, 2),
                            (0, INS, (9, 101), True, 3, 4),
                            (1, DELMIN, None, (9, 101), 5, 6)], False),
    "q4_empty_while_pending": ([(0, INS, (3, 100), True, 1, 2),
                                (1, DELMIN, None, None, 3, 4)], False),
    "q1_twice": ([(0, INS, (3, 100), True, 1, 2),
                  (0, DELMIN, None, (3, 100), 3, 4),
                  (1, DELMIN, None, (3, 100), 5, 6)], False),
    "q1_never_inserted": ([(0, DELMIN, None, (3, 100), 1, 2)], False),
    "q2_before_insert": ([(0, DELMIN, None, (3, 100), 1, 2),
                          (1, INS, (3, 100), True, 5, 6)], False),
}


@pytest.mark.parametrize("case", sorted(FIXTURES))
def test_checker_fixtures_equal_reference(case):
    """Each fixture's verdicts (reason and node count included) at k = 0
    and k = 1 equal the reference's, pattern and search; k = 0 gives the
    fixture's expected verdict, and Q3's one smaller pending key passes
    at k = 1."""
    rows, legal = FIXTURES[case]
    res = []
    for core, sched_pkg in PACKAGES:
        hist = [core.HistoryEvent(*r) for r in rows]
        res.append(_verdicts(sched_pkg, hist, (0, 1), search=True))
    assert res[1] == res[0]
    assert res[1]["pattern/0"][0] == legal
    if legal or case in ("q3_smaller_pending", "q4_empty_while_pending"):
        assert res[1]["search/0"][0] == legal
    if case == "q3_smaller_pending":
        assert res[1]["pattern/1"][0] and res[1]["search/1"][0]


def test_mesh_relaxation_bound_equals_reference():
    for shards in (1, 2, 3, 4, 8):
        for batch in (1, 8, 1024):
            for occ in (0, 1, 7, 128, 10_000):
                for lazy in (0, 3):
                    for rings in (1, 4):
                        for threads in (1, 12):
                            kw = dict(lazy=lazy, rings=rings,
                                      num_threads=threads)
                            assert TS.mesh_relaxation_bound(
                                shards, batch, occ, **kw) == \
                                JS.mesh_relaxation_bound(shards, batch, occ,
                                                         **kw)


def test_sched_exports_the_reference_names():
    assert sorted(TS.__all__) == sorted(JS.__all__)
    for name in TS.__all__:
        obj = getattr(TS, name)
        if callable(obj):
            assert obj.__module__.startswith("repro_torch."), name
    assert (TS.INS, TS.DELMIN) == (JS.INS, JS.DELMIN)
    assert dataclasses.astuple(TS.NODE) == dataclasses.astuple(JS.NODE)


# -- the priority mesh's recorded history at two shards -----------------------

SEED_KEYS = [(7919 % 1000, 1)]


def _reference_history(shards):
    """The reference's 2-shard priority mesh (legacy loop, trace=True) on
    the binary tree of tests/test_torch_pmeshrounds.py, through its
    mesh_trace_history: [event tuples]."""
    import jax.numpy as jnp

    from repro import runtime as jrt
    from repro.jaxcompat import make_mesh as jmesh

    def step(acc, keys, vals, valid):
        acc = acc.at[jnp.where(valid, vals, 0)].add(valid.astype(jnp.int32))
        cv = jnp.stack([vals * 2, vals * 2 + 1], -1).astype(jnp.int32)
        ck = (cv * 7919) % 1000
        return acc, ck, cv, (valid & (vals < 64))[:, None]

    r = jrt.PriorityMeshRoundRunner(
        step, mesh=jmesh((shards,), ("data",)), capacity_log2=8, batch=8,
        fused=False, trace=True, combine=lambda a: a.sum(0))
    r.run([k for k, _ in SEED_KEYS], [v for _, v in SEED_KEYS],
          acc=jnp.zeros(200, jnp.int32))
    hist = JS.mesh_trace_history(r.trace, SEED_KEYS)
    return {"history": [list(dataclasses.astuple(e)) for e in hist],
            "max_occupancy": r.stats["max_occupancy"]}


def _jsonable(events):
    return json.loads(json.dumps(events))


def test_two_shard_mesh_history_equals_reference():
    from repro_torch.distributed import make_mesh
    from repro_torch.runtime import PriorityMeshRoundRunner

    def step(acc, keys, vals, valid):
        acc = acc.index_add(0, torch.where(valid, vals, 0), valid.int())
        cv = torch.stack([vals * 2, vals * 2 + 1], -1).int()
        ck = (cv * 7919) % 1000
        return acc, ck, cv, (valid & (vals < 64))[:, None]

    r = PriorityMeshRoundRunner(
        step, mesh=make_mesh((2,), ("data",)), capacity_log2=8, batch=8,
        fused=False, trace=True,
        combine=lambda a: a.sum(0, dtype=torch.int32), device="cpu")
    acc, _ = r.run([k for k, _ in SEED_KEYS], [v for _, v in SEED_KEYS],
                   acc=torch.zeros(200, dtype=torch.int32))
    assert acc[1:128].tolist() == [1] * 127
    hist = TS.mesh_trace_history(r.trace, SEED_KEYS)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=2").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(REPO, "src"), env.get("PYTHONPATH"), REPO)
        if p)
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--worker", "2"], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    got = _jsonable([list(dataclasses.astuple(e)) for e in hist])
    assert got == ref["history"]
    assert r.stats["max_occupancy"] == ref["max_occupancy"]
    k = TS.mesh_relaxation_bound(2, 8, r.stats["max_occupancy"])
    res = TS.check_p_linearizable(hist, k)
    assert res.ok, res.reason
    # the same history through the reference's checker: the same verdict
    jhist = [JC.HistoryEvent(*dataclasses.astuple(e)) for e in hist]
    assert dataclasses.astuple(JS.check_p_linearizable(jhist, k)) == \
        dataclasses.astuple(res)


if __name__ == "__main__":
    if "--worker" in sys.argv:
        print(json.dumps(_reference_history(int(sys.argv[sys.argv.index(
            "--worker") + 1]))))
