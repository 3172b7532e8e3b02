"""The port's priority mesh (``repro_torch.runtime.meshrounds``:
``PriorityMeshRoundRunner`` over ``MeshHeapEngine``, relaxed and strict)
on the CPU, held against the JAX package.

The shard axis is a tensor dimension here, so the port runs any shard
count in one process; the reference runs under ``shard_map``, at one
shard in this process and at 2 and 4 shards in one forced-device
subprocess per shard count (run once per pytest run).  Covered:

* the goldens of ``tests/test_enginecore.py`` (``pmesh_relaxed``,
  ``pmesh_strict`` and their ``GOLDEN_2SHARD`` rows: stats with
  ``host_syncs``, acc, planes, the ``tel`` digests), fused and legacy;
* live reference runs at 1, 2 and 4 shards, relaxed and strict: with
  telemetry, the split payload layout (the aux plane on the heap's
  rider), ``compact=True``, spans, and ``sync_every`` 0, 1 and 3 —
  planes, sizes, hints, acc, stats, sync logs and the obs digests
  bit-exact;
* fused equal to legacy; strict at S x batch equal to
  ``PriorityRoundRunner`` at S * batch bit for bit; the legacy
  ``trace=True`` history equal to the
  reference's at one shard and priority-linearizable under the
  reference's checker (k = 0 at one shard, ``mesh_relaxation_bound`` at
  two);
* the errors of ``tests/test_sssp.py`` and the constructors' word for
  word; the engine registry rows.

Integer state throughout, so every comparison is exact.  The grid
kernel runs only on the card, where ``chip_smoke.py`` holds it against
``heap_apply_grid_plain``."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.distributed import make_mesh  # noqa: E402
from repro_torch.interop import dist_heap_state_to_numpy  # noqa: E402
from repro_torch.runtime import (ENGINE_REGISTRY, MeshHeapEngine,  # noqa
                                 PriorityMeshRoundRunner)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
STATS = ("rounds", "processed", "spawned", "max_occupancy", "drained",
         "host_syncs")
# GOLDEN / GOLDEN_2SHARD of tests/test_enginecore.py
GOLDEN = {
    "pmesh_relaxed": {
        "stats": [19, 260, 258, 128, 1, 1], "acc": "cd729cf83f33eed5",
        "planes": "c5830eb454bd1761", "tel": "c24a2c5171ec130e"},
    "pmesh_strict": {
        "stats": [19, 260, 258, 128, 1, 1], "acc": "cd729cf83f33eed5",
        "planes": "c5830eb454bd1761", "tel": "c24a2c5171ec130e"},
    "pmesh_relaxed_2": {
        "stats": [12, 260, 258, 88, 1, 1], "acc": "cd729cf83f33eed5",
        "planes": "c822643452639513", "tel": "bd8f8645639ba8bc"},
    "pmesh_strict_2": {
        "stats": [12, 260, 258, 110, 1, 1], "acc": "cd729cf83f33eed5",
        "planes": "c5830eb454bd1761", "tel": "2455cb0b0971fae9"},
}
SCENARIOS = ("plain", "split", "compact", "spans", "sync1", "sync3")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One torch thread for this file's tests: the tier-1 run puts six
    test workers on the machine's cores, where a pool as wide as the cores
    in each only contends with the others; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(_np(a)).tobytes())
    return h.hexdigest()[:16]


def _tel_digest(tel):
    rows = [(r.round, r.imbalance, r.min_key, r.max_key, int(r.overflow),
             tuple(r.pops), tuple(r.pushes), tuple(r.occupancy))
            for r in tel.records]
    return hashlib.sha256(repr(rows).encode()).hexdigest()[:16]


def _stats(st):
    return [int(st[k]) for k in STATS]


def _sum32(a):
    return a.sum(0, dtype=torch.int32)


# -- the steps, one for each package ------------------------------------------


def pri_step(acc, keys, vals, valid):
    """The goldens' step (tests/test_enginecore.py: _pri_mesh_step)."""
    acc = acc.index_add(0, torch.where(valid, vals % 89, 0), valid.int())
    ck = torch.stack([keys + 2, keys + 5], -1).int()
    cv = torch.stack([(vals * 7919) % 1000, (vals * 104729) % 1000],
                     -1).int()
    return acc, ck, cv, (valid & (keys < 20))[:, None]


def jax_pri_step(acc, keys, vals, valid):
    acc = acc.at[jnp.where(valid, vals % 89, 0)].add(valid.astype(jnp.int32))
    ck = jnp.stack([keys + 2, keys + 5], -1).astype(jnp.int32)
    cv = jnp.stack([(vals * 7919) % 1000, (vals * 104729) % 1000],
                   -1).astype(jnp.int32)
    return acc, ck, cv, (valid & (keys < 20))[:, None]


def split_step(acc, keys, vals, aux, valid):
    """The split layout: the aux word (the item's depth) rides the rider
    plane and bounds the tree."""
    acc = acc.index_add(0, torch.where(valid, (vals + aux) % 89, 0),
                        valid.int())
    ck = torch.stack([keys + 2, keys + 5], -1).int()
    cv = torch.stack([(vals * 7919) % 1000, (vals * 104729) % 1000],
                     -1).int()
    ca = torch.stack([aux + 1, aux + 1], -1).int()
    return acc, ck, cv, ca, (valid & (aux < 6))[:, None]


def jax_split_step(acc, keys, vals, aux, valid):
    acc = acc.at[jnp.where(valid, (vals + aux) % 89, 0)].add(
        valid.astype(jnp.int32))
    ck = jnp.stack([keys + 2, keys + 5], -1).astype(jnp.int32)
    cv = jnp.stack([(vals * 7919) % 1000, (vals * 104729) % 1000],
                   -1).astype(jnp.int32)
    ca = jnp.stack([aux + 1, aux + 1], -1).astype(jnp.int32)
    return acc, ck, cv, ca, (valid & (aux < 6))[:, None]


def tree_step(limit=32):
    """tests/test_sssp.py: _tree_step (unique payloads: a binary tree)."""
    def step(acc, keys, vals, valid):
        acc = acc.index_add(0, torch.where(valid, vals, 0), valid.int())
        cv = torch.stack([vals * 2, vals * 2 + 1], -1).int()
        ck = (cv * 7919) % 1000
        return acc, ck, cv, (valid & (vals < limit))[:, None]
    return step


def jax_tree_step(limit=32):
    def step(acc, keys, vals, valid):
        acc = acc.at[jnp.where(valid, vals, 0)].add(valid.astype(jnp.int32))
        cv = jnp.stack([vals * 2, vals * 2 + 1], -1).astype(jnp.int32)
        ck = (cv * 7919) % 1000
        return acc, ck, cv, (valid & (vals < limit))[:, None]
    return step


def explode_step(acc, keys, vals, valid):
    cv = vals[:, None].expand(-1, 4) + 1
    return acc, cv.int(), cv.int(), valid[:, None].expand(-1, 4)


def jax_explode_step(acc, keys, vals, valid):
    cv = jnp.broadcast_to(vals[:, None], (vals.shape[0], 4)) + 1
    return (acc, cv.astype(jnp.int32), cv.astype(jnp.int32),
            jnp.broadcast_to(valid[:, None], cv.shape))


def immortal_step(acc, keys, vals, valid):
    return acc, keys[:, None], vals[:, None], valid[:, None]


def jax_immortal_step(acc, keys, vals, valid):
    return acc, keys[:, None], vals[:, None], valid[:, None]


# -- one scenario set, run by the reference and by the port ------------------


def _scenarios(s, port: bool):
    """The runs both packages make at ``s`` shards; returns {name: result
    dict of plain ints, lists and digests}."""
    if port:
        from repro_torch.obs import Spans, Telemetry
        mesh = make_mesh((s,), ("data",))
        runner, comb = PriorityMeshRoundRunner, _sum32
        steps = {False: pri_step, True: split_step}
        zeros = lambda: torch.zeros(89, dtype=torch.int32)  # noqa: E731
        kw = dict(device="cpu")
    else:
        from repro import runtime as jrt
        from repro.jaxcompat import make_mesh as jmesh
        from repro.obs import Spans, Telemetry
        mesh = jmesh((s,), ("data",))
        runner, comb = jrt.PriorityMeshRoundRunner, lambda a: a.sum(0)
        steps = {False: jax_pri_step, True: jax_split_step}
        zeros = lambda: jnp.zeros(89, jnp.int32)  # noqa: E731
        kw = {}
    out = {}
    seeds = ([3, 1, 9, 4, 4], [7, 11, 12, 5, 6])
    for relaxed in (True, False):
        for name in SCENARIOS:
            tel = Telemetry(capacity=256)
            sp = Spans(classes=1, buckets=8) if name == "spans" else None
            split = name == "split"
            r = runner(steps[split], mesh=mesh, capacity_log2=8, batch=4,
                       relaxed=relaxed, combine=comb, telemetry=tel,
                       spans=sp, split=split,
                       compact=True if name == "compact" else None,
                       sync_every={"sync1": 1, "sync3": 3}.get(name, 0),
                       **kw)
            run_kw = {"initial_aux": [0, 1, 0, 2, 0]} if split else {}
            acc, st = r.run(*seeds, acc=zeros(), **run_kw)
            if port:
                keys, vals, size, hints = dist_heap_state_to_numpy(st)
                hints = None if r.hints is None else _np(r.hints).tolist()
            else:
                keys, vals, size = (np.asarray(x) for x in st)
                # the reference carries min(keys) of each shard's heap
                hints = keys.min(1).tolist() if relaxed else None
            res = {"stats": _stats(r.stats), "acc": _digest(acc),
                   "planes": _digest(keys, vals),
                   "size": np.asarray(size).tolist(), "hints": hints,
                   "tel": _tel_digest(tel),
                   "sync_log": [(p.rounds, p.occupancy, p.host_syncs)
                                for p in r.sync_log]}
            if sp is not None:
                res["spans"] = _digest(sp.hist, sp.max_wait)
                res["flows"] = sp.flows
                res["p"] = [sp.percentile(q) for q in (0.5, 0.95, 0.99)]
            out[f"{'relaxed' if relaxed else 'strict'}/{name}"] = res
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
    """(reference, port) scenario results at ``s`` shards, once each."""
    if s not in _CACHE:
        if s == 1:
            ref = _scenarios(1, port=False)
        else:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 str(s)], capture_output=True, text=True, cwd=REPO,
                env=_forced_device_env(s), timeout=900)
            assert out.returncode == 0, out.stderr[-3000:]
            ref = json.loads(out.stdout.strip().splitlines()[-1])
        ref = json.loads(json.dumps(ref))            # tuples as lists
        port = json.loads(json.dumps(_scenarios(s, port=True)))
        _CACHE[s] = (ref, port)
    return _CACHE[s]


# -- goldens ------------------------------------------------------------------


def _golden_run(name, fused=True):
    s = 2 if name.endswith("_2") else 1
    tel = obs.Telemetry(capacity=512) if fused else None
    r = PriorityMeshRoundRunner(pri_step, mesh=make_mesh((s,), ("data",)),
                                capacity_log2=10, batch=16,
                                relaxed="relaxed" in name, fused=fused,
                                combine=_sum32, telemetry=tel, device="cpu")
    acc, st = r.run([3, 1], [7, 11], acc=torch.zeros(89, dtype=torch.int32))
    out = {"stats": _stats(r.stats), "acc": _digest(acc),
           "planes": _digest(st.keys, st.vals)}
    if fused:
        out["tel"] = _tel_digest(tel)
    return out


@pytest.mark.parametrize("name", list(GOLDEN))
def test_pmesh_goldens(name):
    assert _golden_run(name) == GOLDEN[name]


@pytest.mark.parametrize("name", list(GOLDEN))
def test_legacy_loop_gives_the_golden_state(name):
    """The legacy loop: the golden state, one readback a round."""
    got = _golden_run(name, fused=False)
    want = dict(GOLDEN[name])
    want.pop("tel")
    rounds = want["stats"][0]
    assert got.pop("stats") == want.pop("stats")[:5] + [rounds]
    assert got == want


# -- live reference runs at 1, 2 and 4 shards ---------------------------------


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("mode", ("relaxed", "strict"))
@pytest.mark.parametrize("s", (1, 2, 4))
def test_matches_reference_runs(s, mode, scenario):
    """Stats, acc, planes, sizes, hints (relaxed), the sync log, the
    telemetry digest and, with spans, the span digest, flow exemplars and
    percentiles: equal to the reference's run of the same scenario at
    ``s`` shards."""
    ref, port = _results(s)
    key = f"{mode}/{scenario}"
    assert port[key] == ref[key]


@pytest.mark.parametrize("s", (1, 2, 4))
@pytest.mark.parametrize("relaxed", (True, False))
def test_fused_equals_legacy(relaxed, s):
    """Acc, planes, sizes, hints and stats (but host_syncs) of the legacy
    loop equal the fused engine's; the fused run reads back once, the
    legacy run once a round."""
    runs = []
    for fused in (True, False):
        r = PriorityMeshRoundRunner(
            tree_step(), mesh=make_mesh((s,), ("data",)), capacity_log2=8,
            batch=16, relaxed=relaxed, fused=fused, combine=_sum32,
            device="cpu")
        acc, st = r.run([7919 % 1000], [1],
                        acc=torch.zeros(80, dtype=torch.int32))
        runs.append((acc.tolist(), st.keys.tolist(), st.vals.tolist(),
                     _np(st.size).tolist(),
                     None if r.hints is None else r.hints.tolist(),
                     _stats(r.stats)[:5], r.stats["host_syncs"]))
    assert runs[0][:6] == runs[1][:6]
    assert runs[0][6] == 1 and runs[1][6] == runs[1][5][0]
    assert runs[0][0][1:64] == [1] * 63        # tasks 1..63 once each


def test_mesh_heap_engine_is_the_fused_runner():
    mesh = make_mesh((2,), ("data",))
    e = MeshHeapEngine(pri_step, mesh=mesh, capacity_log2=10, batch=16,
                       combine=_sum32, device="cpu")
    acc, st = e.run([3, 1], [7, 11], acc=torch.zeros(89, dtype=torch.int32))
    want = GOLDEN["pmesh_relaxed_2"]
    assert _stats(e.stats) == want["stats"]
    assert _digest(acc) == want["acc"]
    assert _digest(st.keys, st.vals) == want["planes"]
    assert e.loop_carry_bytes() == (2 * 2 * 1024 * 4) // 2 + 2 * 2 * 4


@pytest.mark.parametrize("s", (2, 4))
def test_strict_mesh_equals_priority_round_runner(s):
    """The strict mesh at S x batch pops the S * batch least keys of its
    one heap and gives shard s the contiguous ranks of its
    ``claim_schedule`` slice, so its children come in the order of one
    engine's row-major wave: it equals ``PriorityRoundRunner`` at batch S
    x batch bit for bit (stats, summed acc, planes, size)."""
    from repro_torch.runtime import PriorityRoundRunner
    rng = np.random.default_rng(12)
    ik = rng.integers(0, 16, 300).astype(np.int32)
    iv = rng.integers(0, 2 ** 31 - 1, 300).astype(np.int32)

    def step(acc, keys, vals, valid):
        acc = acc.index_add(0, torch.where(valid, vals % 512, 0),
                            valid.int())
        h = (vals.long()[:, None] * 2654435761
             + torch.arange(2)[None, :] * 40503) % (1 << 31)
        ck = keys[:, None] + 1 + (h % 4).int()
        return acc, ck, (h >> 1).int(), (keys[:, None] < 10) & (
            h % 16 < 10) & valid[:, None]

    mesh = PriorityMeshRoundRunner(step, mesh=make_mesh((s,), ("data",)),
                                   capacity_log2=11, batch=16, relaxed=False,
                                   combine=_sum32, device="cpu")
    one = PriorityRoundRunner(step, capacity_log2=11, batch=16 * s,
                              device="cpu")
    runs = []
    for r in (mesh, one):
        acc, st = r.run(ik, iv, acc=torch.zeros(512, dtype=torch.int32))
        runs.append((_stats(r.stats), acc.tolist(), st.keys.tolist(),
                     st.vals.tolist(), int(st.size)))
    assert runs[0] == runs[1]
    assert runs[0][0][1] > 10 * s * 16          # many full rounds


# -- the recorded history -----------------------------------------------------


@pytest.mark.parametrize("relaxed", (True, False))
def test_single_shard_trace_equals_reference_and_is_exact(relaxed):
    """At one shard both orderings pop one heap in global min-key order:
    the recorded pops and pushes equal the reference's round by round,
    and the history is priority-linearizable at k = 0."""
    from repro import runtime as jrt
    from repro.jaxcompat import make_mesh as jmesh
    from repro.sched import (check_p_linearizable, mesh_relaxation_bound,
                             mesh_trace_history)
    traces = []
    for port in (True, False):
        if port:
            r = PriorityMeshRoundRunner(
                tree_step(64), mesh=make_mesh((1,), ("data",)),
                capacity_log2=8, batch=8, relaxed=relaxed, fused=False,
                trace=True, combine=_sum32, device="cpu")
            acc, _ = r.run([7919 % 1000], [1],
                           acc=torch.zeros(200, dtype=torch.int32))
        else:
            r = jrt.PriorityMeshRoundRunner(
                jax_tree_step(64), mesh=jmesh((1,), ("data",)),
                capacity_log2=8, batch=8, relaxed=relaxed, fused=False,
                trace=True, combine=lambda a: a.sum(0))
            acc, _ = r.run([7919 % 1000], [1],
                           acc=jnp.zeros(200, jnp.int32))
        assert _np(acc)[1:128].tolist() == [1] * 127
        traces.append((r.trace, r.stats["max_occupancy"]))
    (got, occ), (want, _) = traces
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for part in ("pops", "pushes"):
            for x, y in zip(a[part], b[part]):
                assert np.array_equal(np.asarray(x), np.asarray(y))
    hist = mesh_trace_history(got, [(7919 % 1000, 1)])
    res = check_p_linearizable(hist, 0)
    assert res.ok, res.reason
    assert mesh_relaxation_bound(1, 8, occ) == 0


def test_two_shard_trace_within_relaxation_bound():
    """The relaxed mesh at two shards: the recorded history is
    priority-linearizable within ``mesh_relaxation_bound``."""
    from repro.sched import (check_p_linearizable, mesh_relaxation_bound,
                             mesh_trace_history)
    r = PriorityMeshRoundRunner(tree_step(64),
                                mesh=make_mesh((2,), ("data",)),
                                capacity_log2=8, batch=8, fused=False,
                                trace=True, combine=_sum32, device="cpu")
    seeds = [(7919 % 1000, 1)]
    acc, _ = r.run([k for k, _ in seeds], [v for _, v in seeds],
                   acc=torch.zeros(200, dtype=torch.int32))
    assert acc[1:128].tolist() == [1] * 127
    assert r.trace[0]["pops"][0].shape == (2, 8)
    hist = mesh_trace_history(r.trace, seeds)
    k = mesh_relaxation_bound(2, 8, r.stats["max_occupancy"])
    res = check_p_linearizable(hist, k)
    assert res.ok, res.reason


# -- errors, word for word ----------------------------------------------------


def _both(port_fn, ref_fn):
    msgs = []
    for fn in (port_fn, ref_fn):
        with pytest.raises((RuntimeError, ValueError)) as e:
            fn()
        msgs.append((type(e.value), str(e.value)))
    assert msgs[0] == msgs[1]
    return msgs[0][1]


@pytest.mark.parametrize("fused", (True, False))
@pytest.mark.parametrize("relaxed", (True, False))
@pytest.mark.parametrize("case", ("overflow", "seed_overflow", "truncation"))
def test_errors_match_reference(case, relaxed, fused):
    """tests/test_sssp.py's overflow, seed-overflow and truncation runs:
    the same error, word for word; truncation leaves the same stats."""
    from repro import runtime as jrt
    from repro.jaxcompat import make_mesh as jmesh
    step, jstep, cap, seeds, rounds = {
        "overflow": (explode_step, jax_explode_step, 4, np.arange(8), 100),
        "seed_overflow": (pri_step, jax_pri_step, 4, np.arange(64), 100),
        "truncation": (immortal_step, jax_immortal_step, 6, [1, 2, 3], 5),
    }[case]
    port = PriorityMeshRoundRunner(step, mesh=make_mesh((1,), ("data",)),
                                   capacity_log2=cap, batch=8,
                                   relaxed=relaxed, fused=fused,
                                   device="cpu")
    ref = jrt.PriorityMeshRoundRunner(jstep, mesh=jmesh((1,), ("data",)),
                                      capacity_log2=cap, batch=8,
                                      relaxed=relaxed, fused=fused)
    acc = np.zeros(89, np.int32) if case == "seed_overflow" else 0
    msg = _both(lambda: port.run(seeds, seeds, acc=acc, max_rounds=rounds),
                lambda: ref.run(seeds, seeds, acc=jnp.asarray(acc, jnp.int32),
                                max_rounds=rounds))
    assert "mesh heap overflow" in msg or "not quiescent" in msg
    if case == "truncation":
        assert port.stats["drained"] == 0 and port.stats["rounds"] == 5
        assert port.stats == ref.stats


@pytest.mark.parametrize("fused", (True, False))
@pytest.mark.parametrize("relaxed", (True, False))
@pytest.mark.parametrize("case", ("empty", "max_rounds_0"))
def test_runs_with_no_round_match_reference(case, relaxed, fused):
    """No round runs: on empty seeds the legacy loop drains with no sync
    point (``host_syncs`` 0, ``sync_log`` []) and the fused engine reads
    back once; at ``max_rounds=0`` with work left both raise the
    reference's truncation error with its stats and log.  Relaxed and
    strict."""
    from repro import runtime as jrt
    from repro.jaxcompat import make_mesh as jmesh
    seeds, rounds = {"empty": ([], 100), "max_rounds_0": ([0, 1, 2], 0)}[case]
    runs = []
    for port in (True, False):
        if port:
            r = PriorityMeshRoundRunner(
                pri_step, mesh=make_mesh((1,), ("data",)), capacity_log2=8,
                batch=8, relaxed=relaxed, fused=fused, device="cpu")
            acc = torch.zeros(89, dtype=torch.int32)
        else:
            r = jrt.PriorityMeshRoundRunner(
                jax_pri_step, mesh=jmesh((1,), ("data",)), capacity_log2=8,
                batch=8, relaxed=relaxed, fused=fused)
            acc = jnp.zeros(89, jnp.int32)
        try:
            r.run(np.asarray(seeds, np.int32), np.asarray(seeds, np.int32),
                  acc=acc, max_rounds=rounds)
            err = None
        except RuntimeError as e:
            err = str(e)
        runs.append((dict(r.stats), [(p.rounds, p.occupancy, p.host_syncs)
                                     for p in r.sync_log], err))
    assert runs[0] == runs[1]
    stats, log, err = runs[0]
    if case == "empty":
        assert err is None and stats["drained"] == 1
        assert (stats["host_syncs"], log) == ((1, [(0, 0, 1)]) if fused
                                              else (0, []))
    else:
        assert "truncated at max_rounds=0 with occupancy 3" in err
        assert stats["rounds"] == 0 and stats["drained"] == 0


def test_constructor_errors_match_reference():
    from repro import runtime as jrt
    from repro.jaxcompat import make_mesh as jmesh
    from repro.obs import Spans
    mesh, jm = make_mesh((1,), ("data",)), jmesh((1,), ("data",))
    for kw in (dict(capacity_log2=4, batch=64),
               dict(capacity_log2=4, batch=64, relaxed=False),
               dict(trace=True),
               dict(fused=False, spans=True),
               dict(split=True, spans=True)):
        jkw, tkw = dict(kw), dict(kw)
        if kw.get("spans"):
            jkw["spans"] = Spans(classes=1, buckets=8)
            tkw["spans"] = obs.Spans(classes=1, buckets=8)
        _both(lambda: PriorityMeshRoundRunner(pri_step, mesh=mesh,
                                              device="cpu", **tkw),
              lambda: jrt.PriorityMeshRoundRunner(jax_pri_step, mesh=jm,
                                                  **jkw))
    # batch x shards, at a shard count the reference cannot reach here
    with pytest.raises(ValueError, match="^mesh batch 8 x 4 shards exceeds "
                                         "heap capacity 16$"):
        MeshHeapEngine(pri_step, mesh=make_mesh((4,), ("data",)),
                       capacity_log2=4, batch=8, relaxed=False, device="cpu")
    with pytest.raises(ValueError, match="one shape"):
        PriorityMeshRoundRunner(pri_step, mesh=mesh, device="cpu").run(
            [1, 2], [1], acc=torch.zeros(89, dtype=torch.int32))


def test_engine_registry_rows():
    for name, relaxed in (("pmesh-relaxed", True), ("pmesh-strict", False)):
        row = ENGINE_REGISTRY[name]
        assert row.runner is PriorityMeshRoundRunner
        assert row.priority and row.mesh and row.spans_ok
        assert row.kwargs == {"relaxed": relaxed}


if __name__ == "__main__":
    if "--worker" in sys.argv:
        s = int(sys.argv[sys.argv.index("--worker") + 1])
        print(json.dumps(_scenarios(s, port=False)))
