"""The port's observability slice (``repro_torch.obs`` and the fused
engines that carry its planes) on the CPU, held against the JAX package:

* the plane functions (``trace_record``, ``masked_min_max``,
  ``span_record``, ``span_tick``, the bucket rule, ``drain_plane``) and
  ``obs_record``, the round's record in one call, exact on seeded numpy
  inputs;
* ``Telemetry`` records and ``Spans`` summaries of both engines: the
  ``tel`` and ``spans`` digests of ``GOLDEN["fifo_fanout"]`` and
  ``GOLDEN["heap_sssp"]`` (``tests/test_enginecore.py``) at
  ``sync_every`` 0, 1 and 3, with records, sync logs and summaries equal
  to the reference's runs;
* obs on changes no result; the span clock's cap; class rows; BFS with
  telemetry; the analyzers; exported JSONL and Chrome traces through
  ``tools/trace_check.py``.

Integer state throughout, so every comparison is exact.  The kernels
behind ``obs_record``, the packed waves and the rider ``heap_apply`` run
only on the card; ``chip_smoke.py`` holds them against these plain
versions there."""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro.obs import spans as jspans  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.apps import bfs  # noqa: E402
from repro_torch.obs import spans as tspans  # noqa: E402
from repro_torch.runtime import PriorityRoundRunner, RoundRunner  # noqa

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
STATS = ("rounds", "processed", "spawned", "max_occupancy", "drained",
         "host_syncs")
# the tel / spans digests of GOLDEN in tests/test_enginecore.py
GOLDEN = {"fifo": {"stats": [7, 63, 62, 32, 1, 1], "tel": "cb3aae309ae1f69f",
                   "spans": "b5f891af2ff7334a"},
          "heap": {"stats": [10, 124, 122, 46, 1, 1],
                   "tel": "ef6805304552b52a", "spans": "bbf1586fce097a87"}}


def _digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()[:16]


def _tel_digest(tel):
    rows = [(r.round, r.imbalance, r.min_key, r.max_key, int(r.overflow),
             tuple(r.pops), tuple(r.pushes), tuple(r.occupancy))
            for r in tel.records]
    return hashlib.sha256(repr(rows).encode()).hexdigest()[:16]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rows(tel):
    """Records without their drain wall time."""
    return [dict(r.to_dict(), wall_time=None) for r in tel.records]


# -- the two golden workloads, in both packages ------------------------------


def tree_step(acc, vals, valid):
    acc = acc.index_add(0, torch.where(valid, vals, 0), valid.int())
    cv = torch.stack([vals * 2, vals * 2 + 1], -1).int()
    return acc, cv, (valid & (vals < 32))[:, None]


def jax_tree_step(acc, vals, valid):
    acc = acc.at[jnp.where(valid, vals, 0)].add(valid.astype(jnp.int32))
    cv = jnp.stack([vals * 2, vals * 2 + 1], -1).astype(jnp.int32)
    return acc, cv, (valid & (vals < 32))[:, None]


def pri_step(acc, keys, vals, valid):
    acc = acc.index_add(0, torch.where(valid, vals % 97, 0), valid.int())
    ck = torch.stack([keys + 3, keys + 7], -1).int()
    cv = torch.stack([vals * 2 + 1, vals * 2 + 2], -1).int()
    return acc, ck, cv, (valid & (keys < 24))[:, None]


def jax_pri_step(acc, keys, vals, valid):
    acc = acc.at[jnp.where(valid, vals % 97, 0)].add(valid.astype(jnp.int32))
    ck = jnp.stack([keys + 3, keys + 7], -1).astype(jnp.int32)
    cv = jnp.stack([vals * 2 + 1, vals * 2 + 2], -1).astype(jnp.int32)
    return acc, ck, cv, (valid & (keys < 24))[:, None]


def run_port(which, tel=None, sp=None, cap=None, **kw):
    """One golden workload on the port's fused runner (its span clock
    capped at ``cap`` when given)."""
    if which == "fifo":
        r = RoundRunner(tree_step, capacity_log2=8, batch=16, telemetry=tel,
                        spans=sp, device="cpu", **kw)
        if cap is not None:
            r._engine.span_round_cap = cap
        acc, st = r.run([1], acc=torch.zeros(80, dtype=torch.int32))
        planes = [_np(p) for p in st[:4]] + [st.head, st.tail]
    else:
        r = PriorityRoundRunner(pri_step, capacity_log2=9, batch=16,
                                telemetry=tel, spans=sp, device="cpu", **kw)
        if cap is not None:
            r._engine.span_round_cap = cap
        acc, st = r.run([5, 1], [1, 2], acc=torch.zeros(97,
                                                        dtype=torch.int32))
        planes = [_np(st.keys), _np(st.vals), st.size]
    return r, _np(acc), planes


def run_ref(which, tel=None, sp=None, cap=None, **kw):
    """The same workload on the JAX package's runner."""
    if which == "fifo":
        r = jrt.RoundRunner(jax_tree_step, capacity_log2=8, batch=16,
                            telemetry=tel, spans=sp, **kw)
        if cap is not None:
            r._engine.span_round_cap = cap
        acc, st = r.run([1], acc=jnp.zeros(80, jnp.int32))
        planes = [np.asarray(p) for p in st[:4]] + [int(st.head),
                                                   int(st.tail)]
    else:
        r = jrt.PriorityRoundRunner(jax_pri_step, capacity_log2=9, batch=16,
                                    telemetry=tel, spans=sp, **kw)
        if cap is not None:
            r._engine.span_round_cap = cap
        acc, st = r.run([5, 1], [1, 2], acc=jnp.zeros(97, jnp.int32))
        planes = [np.asarray(st.keys), np.asarray(st.vals), int(st.size)]
    return r, np.asarray(acc), planes


@pytest.mark.parametrize("sync_every", [0, 1, 3])
@pytest.mark.parametrize("which", ["fifo", "heap"])
def test_goldens_tel_and_spans_digests(which, sync_every):
    """Both goldens with ``Telemetry(capacity=256)`` and ``Spans(classes=1,
    buckets=8)``: the digests, the stats (``host_syncs`` 1 when drained
    in one chunk), and the records, sync log, heartbeats and span summary
    equal to the reference's run at the same ``sync_every``."""
    g = GOLDEN[which]
    tel, sp = obs.Telemetry(capacity=256), obs.Spans(classes=1, buckets=8)
    r, acc, planes = run_port(which, tel, sp, sync_every=sync_every)
    assert _tel_digest(tel) == g["tel"]
    assert _digest(sp.hist, sp.max_wait) == g["spans"]
    assert [r.stats[k] for k in STATS[:5]] == g["stats"][:5]
    if sync_every == 0:
        assert r.stats["host_syncs"] == 1
    jtel = jobs.Telemetry(capacity=256)
    jsp = jobs.Spans(classes=1, buckets=8)
    jr, jacc, jplanes = run_ref(which, jtel, jsp, sync_every=sync_every)
    assert r.stats == {k: int(v) for k, v in jr.stats.items()}
    assert ([(p.rounds, p.occupancy, p.host_syncs) for p in r.sync_log]
            == [(p.rounds, p.occupancy, p.host_syncs) for p in jr.sync_log])
    assert _rows(tel) == _rows(jtel)
    assert ([(p.rounds, p.occupancy) for p in tel.sync_points]
            == [(p.rounds, p.occupancy) for p in jtel.sync_points])
    assert sp.summary() == jsp.summary()
    assert sp.flows == jsp.flows
    np.testing.assert_array_equal(acc, jacc)
    for a, b in zip(planes, jplanes):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["fifo", "heap"])
def test_obs_on_changes_no_result(which):
    """Telemetry and spans on: acc, planes (the ring's flags stripped to
    ``& 1``), stats and sync log equal the unobserved run's; the records
    sum to the stats and the histogram holds one sojourn per pop."""
    r0, acc0, planes0 = run_port(which)
    tel, sp = obs.Telemetry(capacity=4096), obs.Spans()
    r1, acc1, planes1 = run_port(which, tel, sp)
    np.testing.assert_array_equal(acc0, acc1)
    for a, b in zip(planes0, planes1):
        np.testing.assert_array_equal(a, b)
    assert r0.stats == r1.stats
    recs = tel.records
    assert [x.round for x in recs] == list(range(r1.stats["rounds"]))
    assert sum(x.pops[0] for x in recs) == r1.stats["processed"]
    assert sum(x.pushes[0] for x in recs) == r1.stats["spawned"]
    assert recs[-1].occupancy == [0] and tel.dropped == 0
    assert sp.total == r1.stats["processed"]
    assert tel.registry.get("fused.rounds") == r1.stats["rounds"]
    assert sp.registry.get("fused.sojourn_p99") is not None


@pytest.mark.parametrize("which", ["fifo", "heap"])
def test_loop_carry_bytes_with_obs_match_reference(which):
    """The registered carry with the trace, span and births groups is the
    reference engine's, byte for byte."""
    from repro_torch.runtime import HeapEngine, RingEngine
    kw = dict(telemetry=obs.Telemetry(64), spans=obs.Spans(classes=3))
    jkw = dict(telemetry=jobs.Telemetry(64), spans=jobs.Spans(classes=3))
    if which == "fifo":
        e = RingEngine(tree_step, capacity_log2=8, batch=16, device="cpu",
                       **kw)
        je = jrt.RingEngine(jax_tree_step, capacity_log2=8, batch=16, **jkw)
    else:
        e = HeapEngine(pri_step, capacity_log2=9, batch=16, device="cpu",
                       **kw)
        je = jrt.HeapEngine(jax_pri_step, capacity_log2=9, batch=16, **jkw)
    assert e.loop_carry_bytes() == je.loop_carry_bytes()
    assert ([(g.name, g.shapes) for g in e.registry.groups]
            == [(g.name, g.shapes) for g in je.registry.groups])


# -- the plane functions ------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 3])
def test_trace_record_and_drain_match_reference(shards):
    """Seeded records through a 5-slot plane (the ring wraps): the planes
    after every record and the drained records, dropped counts included,
    equal the reference's."""
    rng = np.random.default_rng(shards)
    tp = obs.trace_init(5, shards=shards, device="cpu")
    jtp = jobs.trace_init(5, shards=shards)
    prev = jprev = 0
    for r in range(13):
        args = (r, *(rng.integers(0, 50, shards).astype(np.int32)
                     for _ in range(3)),
                int(rng.integers(-9, 9)), int(rng.integers(10, 99)),
                bool(r % 4 == 3))
        tp = obs.trace_record(tp, *args)
        jtp = jobs.trace_record(jtp, *args)
        for a, b in zip(tp, jtp):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        if r % 6 == 5:
            got = obs.drain_plane(tp, prev, engine="t", sync=r,
                                  wall_time=1.0)
            want = jobs.drain_plane(jtp, jprev, engine="t", sync=r,
                                    wall_time=1.0)
            assert [x.to_dict() for x in got[0]] == \
                [x.to_dict() for x in want[0]]
            assert got[1:] == want[1:]
            prev, jprev = got[1], want[1]
    assert prev == 12


def test_trace_record_in_place_and_functional():
    """``trace_record`` leaves its input plane as it was; the engines'
    ``trace_record_`` writes in place and returns the plane it got."""
    from repro_torch.obs.trace import trace_record_
    tp = obs.trace_init(3, device="cpu")
    before = [t.clone() for t in tp]
    out = obs.trace_record(tp, 0, 4, 2, 6, 1, 9, False)
    for a, b in zip(tp, before):
        assert torch.equal(a, b)
    assert trace_record_(tp, 0, 4, 2, 6, 1, 9, False) is tp
    for a, b in zip(tp, out):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="capacity"):
        obs.trace_init(0, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        obs.Telemetry(0)


def test_masked_min_max_matches_reference():
    rng = np.random.default_rng(4)
    for n in (1, 7, 64):
        keys = rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
        for valid in (rng.random(n) < 0.5, np.zeros(n, bool),
                      np.ones(n, bool)):
            got = obs.masked_min_max(torch.from_numpy(keys),
                                     torch.from_numpy(valid))
            want = jobs.masked_min_max(jnp.asarray(keys),
                                       jnp.asarray(valid))
            assert [int(x) for x in got] == [int(x) for x in want]
            assert all(x.dtype == torch.int32 for x in got)


@pytest.mark.parametrize("buckets", [2, 8, 16])
def test_bucket_rule_matches_reference(buckets):
    """The torch bucket rule, the reference's ``32 - clz`` and the host
    twin ``bucket_of`` agree on every width up to 2^31 - 1."""
    s = np.concatenate([np.arange(300), 2 ** np.arange(31) - 1,
                        2 ** np.arange(31), [2 ** 31 - 1, -5]])
    s = np.clip(s, -5, 2 ** 31 - 1).astype(np.int32)
    got = tspans._bucket_ix(torch.from_numpy(s), buckets).numpy()
    want = np.asarray(jspans._bucket_ix(jnp.asarray(s), buckets))
    np.testing.assert_array_equal(got, want)
    assert list(got) == [obs.bucket_of(int(x), buckets) for x in s]
    np.testing.assert_array_equal(obs.bucket_edges(buckets),
                                  jobs.bucket_edges(buckets))


def test_span_record_and_tick_match_reference():
    """Twenty seeded waves (classes out of range both ways, invalid lanes,
    a flow ring that wraps) through ``span_record`` and ``span_tick``:
    every plane equal to the reference's after every wave."""
    rng = np.random.default_rng(7)
    k, nb, f, b = 3, 8, 5, 11
    sp = obs.span_init(k, buckets=nb, flow_capacity=f, lanes=b, device="cpu")
    jsp = jobs.span_init(k, buckets=nb, flow_capacity=f, lanes=b)
    for _ in range(20):
        cls = rng.integers(-1, k + 1, b).astype(np.int32)
        s = rng.integers(-3, 3000, b).astype(np.int32)
        valid = rng.random(b) < 0.6
        ref = rng.integers(0, 1 << 20, b).astype(np.int32)
        sp = obs.span_tick(obs.span_record(sp, *map(torch.from_numpy,
                                                    (cls, s, valid, ref))))
        jsp = jobs.span_tick(jobs.span_record(jsp, *map(jnp.asarray,
                                                        (cls, s, valid,
                                                         ref))))
        for a, w in zip(sp, jsp):
            np.testing.assert_array_equal(_np(a), np.asarray(w))
    assert int(sp.fcount) > f
    with pytest.raises(ValueError, match="lanes"):
        obs.span_record(sp, *map(torch.from_numpy, (cls[:3], s[:3],
                                                    valid[:3], ref[:3])))


@pytest.mark.parametrize("planes", ["trace", "spans", "both"])
def test_obs_record_matches_reference_round(planes):
    """``obs_record`` (the CPU face of the round's one-launch record) in
    place against the reference round's own calls: ``trace_record(tp,
    tp.count, k, total, occ, *masked_min_max(keys, valid), over)``, then
    ``span_record(sp, cls, sp.round - births, valid, ref)`` and
    ``span_tick``."""
    rng = np.random.default_rng(len(planes))
    b = 16
    tp = jtp = sp = jsp = None
    if planes != "spans":
        tp, jtp = obs.trace_init(6, device="cpu"), jobs.trace_init(6)
    if planes != "trace":
        sp = obs.span_init(2, buckets=6, flow_capacity=3, lanes=b,
                           device="cpu")
        jsp = jobs.span_init(2, buckets=6, flow_capacity=3, lanes=b)
    for r in range(15):
        valid = np.arange(b) < rng.integers(0, b + 1)
        keys = rng.integers(0, 1000, b).astype(np.int32)
        births = np.where(valid, rng.integers(0, r + 1, b), -1).astype(
            np.int32)
        cls = rng.integers(0, 2, b).astype(np.int32) if r % 2 else None
        k, total, occ = (int(valid.sum()), int(rng.integers(0, 40)),
                         int(rng.integers(0, 90)))
        over = bool(r == 9)
        obs.obs_record(
            tp, sp, keys=torch.from_numpy(keys),
            valid=torch.from_numpy(valid), ref=torch.from_numpy(keys),
            births=torch.from_numpy(births),
            cls=None if cls is None else torch.from_numpy(cls),
            k=torch.tensor(k, dtype=torch.int32),
            total=torch.tensor(total, dtype=torch.int32),
            occ=torch.tensor(occ, dtype=torch.int32),
            over=torch.tensor(over))
        if jtp is not None:
            mn, mx = jobs.masked_min_max(jnp.asarray(keys),
                                         jnp.asarray(valid))
            jtp = jobs.trace_record(jtp, jtp.count, k, total, occ, mn, mx,
                                    over)
            for a, w in zip(tp, jtp):
                np.testing.assert_array_equal(_np(a), np.asarray(w))
        if jsp is not None:
            jcls = jnp.zeros(b, jnp.int32) if cls is None else cls
            jsp = jobs.span_tick(jobs.span_record(
                jsp, jnp.asarray(jcls), jsp.round - jnp.asarray(births),
                jnp.asarray(valid), jnp.asarray(keys)))
            for a, w in zip(sp, jsp):
                np.testing.assert_array_equal(_np(a), np.asarray(w))


@pytest.mark.parametrize("which", ["fifo", "heap"])
def test_telemetry_drops_like_reference(which):
    """A 4-record plane over a run of 7 or 10 rounds in one chunk drops
    the oldest rounds at the drain (never an error): records, dropped
    counts, the registry's counter and the heartbeats equal the
    reference's."""
    tel = obs.Telemetry(4, engine="rounds")
    r, _, _ = run_port(which, tel)
    jtel = jobs.Telemetry(4, engine="rounds")
    run_ref(which, jtel)
    assert _rows(tel) == _rows(jtel) and len(tel.records) == 4
    assert tel.dropped == jtel.dropped == r.stats["rounds"] - 4
    assert (tel.registry.get("rounds.trace_dropped")
            == jtel.registry.get("rounds.trace_dropped") == tel.dropped)
    assert [p.to_dict()["rounds"] for p in tel.sync_points] == \
        [p.to_dict()["rounds"] for p in jtel.sync_points]


def test_telemetry_records_accumulate_across_runs():
    """Records of two runs on one collector follow each other; each run's
    rounds start at 0 (a fresh plane a run)."""
    tel = obs.Telemetry(256, engine="rounds")
    r = RoundRunner(tree_step, capacity_log2=8, batch=16, telemetry=tel,
                    device="cpu")
    for _ in range(2):
        r.run([1], acc=torch.zeros(80, dtype=torch.int32))
    n = r.stats["rounds"]
    assert [x.round for x in tel.records] == list(range(n)) * 2


def test_spans_bank_across_runs_like_reference():
    """Two runs on one ``Spans``: the second banks the first, totals and
    flows equal the reference's, the gauges are published."""
    sp, jsp = obs.Spans(classes=1, engine="r"), jobs.Spans(classes=1,
                                                           engine="r")
    r = RoundRunner(tree_step, capacity_log2=8, batch=16, spans=sp,
                    device="cpu")
    jr = jrt.RoundRunner(jax_tree_step, capacity_log2=8, batch=16, spans=jsp)
    for _ in range(2):
        r.run([1], acc=torch.zeros(80, dtype=torch.int32))
        jr.run([1], acc=jnp.zeros(80, jnp.int32))
    assert sp.total == jsp.total == 2 * r.stats["processed"]
    assert sp.summary() == jsp.summary() and sp.flows == jsp.flows
    assert sp.dropped_flows == jsp.dropped_flows
    assert (sp.registry.get("r.sojourn_p99")
            == jsp.registry.get("r.sojourn_p99") is not None)
    for bad, what in (({"classes": 0}, "classes"), ({"buckets": 1},
                                                     "buckets"),
                      ({"flow_capacity": 0}, "flow_capacity")):
        with pytest.raises(ValueError, match=what):
            obs.Spans(**bad)


def test_priority_class_rows_exact():
    """``class_of`` (torch ops on the popped keys) picks the histogram
    row: key 3 (class 0) pops in round 0 with sojourn 0, key 100 (class
    1) in round 1 with sojourn 1 — as the reference's test pins it."""
    def inert(acc, keys, vals, valid):
        z = torch.zeros((keys.shape[0], 1), dtype=torch.int32)
        return acc + valid.sum(), z, z, z.bool()

    sp = obs.Spans(classes=2, engine="pr", class_of=lambda k: k // 64)
    r = PriorityRoundRunner(inert, capacity_log2=4, batch=1, spans=sp,
                            device="cpu")
    r.run([3, 100], [7, 8], acc=torch.tensor(0, dtype=torch.int32))
    np.testing.assert_array_equal(
        sp.hist, [[1] + [0] * (sp.buckets - 1),
                  [0, 1] + [0] * (sp.buckets - 2)])
    np.testing.assert_array_equal(sp.max_wait, [0, 1])
    assert [(f["birth"], f["claim"], f["cls"], f["ref"])
            for f in sp.flows] == [(0, 0, 0, 7), (0, 1, 1, 8)]


def test_fifo_histogram_matches_host_replay():
    """The FIFO engine's sojourns against a host replay of its rounds
    (claim the oldest ``batch``, children born in the claiming round)."""
    import collections
    batch = 16
    sp = obs.Spans(classes=1, engine="rounds")
    r = RoundRunner(tree_step, capacity_log2=8, batch=batch, spans=sp,
                    device="cpu")
    r.run([1], acc=torch.zeros(80, dtype=torch.int32))
    q = collections.deque([(1, 0)])
    hist = np.zeros((1, sp.buckets), np.int64)
    maxw, rnd = 0, 0
    while q:
        wave = [q.popleft() for _ in range(min(batch, len(q)))]
        for v, born in wave:
            hist[0, obs.bucket_of(rnd - born, sp.buckets)] += 1
            maxw = max(maxw, rnd - born)
        for v, _ in wave:
            if v < 32:
                q.extend([(2 * v, rnd), (2 * v + 1, rnd)])
        rnd += 1
    assert r.stats["rounds"] == rnd
    np.testing.assert_array_equal(sp.hist, hist)
    assert list(sp.max_wait) == [maxw]


@pytest.mark.parametrize("sync_every", [0, 3])
@pytest.mark.parametrize("which", ["fifo", "heap"])
def test_chunks_stop_before_span_stamps_wrap(which, sync_every):
    """With the span clock's cap lowered to 4 rounds, a spanned run stops
    at the readback that reaches it with the reference's error and stats;
    without spans the cap is irrelevant."""
    with pytest.raises(RuntimeError, match="span round clock") as got:
        run_port(which, sp=obs.Spans(), cap=4, sync_every=sync_every)
    with pytest.raises(RuntimeError) as want:
        run_ref(which, sp=jobs.Spans(), cap=4, sync_every=sync_every)
    assert str(got.value) == str(want.value)
    r, _, _ = run_port(which, cap=4, sync_every=sync_every)
    assert r.stats["drained"] == 1 and r.stats["rounds"] > 4


def test_bfs_rounds_telemetry_matches_reference():
    """``bfs_rounds`` with a ``Telemetry``: the distances and the records
    (the claimed vertex ids' extrema) equal the reference's runner."""
    from repro.apps import bfs as jbfs
    g = bfs.road_like(144)
    tel = obs.Telemetry(512, engine="bfs")
    sp = obs.Spans(engine="bfs")
    dist, stats = bfs.bfs_rounds(g, 0, batch=16, telemetry=tel, spans=sp,
                                 device="cpu")
    jtel = jobs.Telemetry(512, engine="bfs")
    jg = jbfs.road_like(144)
    runner, init_fn = jbfs.bfs_rounds_runner(jg, batch=16, telemetry=jtel)
    jdist, _ = runner.run([0], acc=init_fn(0))
    np.testing.assert_array_equal(dist, np.asarray(jdist))
    assert _rows(tel) == _rows(jtel)
    assert sp.total == stats["processed"] == g.n
    np.testing.assert_array_equal(dist, bfs.bfs_reference(g, 0))


def test_analyzers_match_reference():
    """The port's copies of the analyzers give the reference's answers on
    the same records and summaries."""
    from repro_torch.obs import analyze
    tel, sp = obs.Telemetry(256), obs.Spans(classes=1, buckets=8)
    run_port("heap", tel, sp)
    jrecs = [jobs.RoundRecord.from_dict(r.to_dict()) for r in tel.records]
    assert obs.occupancy_timeline(tel.records) == \
        jobs.occupancy_timeline(jrecs)
    assert obs.imbalance_timeline(tel.records) == \
        jobs.imbalance_timeline(jrecs)
    assert obs.key_inversions(tel.records) == jobs.key_inversions(jrecs)
    hist = [[3, 1, 4], [1, 5, 9], [2, 6, 5]]
    ins = [[5], [1, 9], [2], [6, 5, 3]]
    assert obs.measured_rank_error(hist, ins) == \
        jobs.measured_rank_error(hist, ins)
    assert (obs.rank_error_vs_envelope(3, history=hist, records=tel.records)
            == jobs.rank_error_vs_envelope(3, history=hist, records=jrecs))
    s = sp.summary()
    for fn in ("sojourn_percentiles", "max_wait_highwater",
               "starvation_flags"):
        assert getattr(obs, fn)(s) == getattr(jobs, fn)(s)
    assert analyze.starvation_flags(
        s, wait_stats={"urgent_max_wait": 1.0, "normal_max_wait": 2.0}) \
        == jobs.starvation_flags(
            s, wait_stats={"urgent_max_wait": 1.0, "normal_max_wait": 2.0})


def test_export_passes_trace_check(tmp_path):
    """A JSONL and a Chrome trace the port exports (records, heartbeats,
    the span histogram and flows) pass ``tools/trace_check.py``, read back
    exactly, and equal what the reference's exporters write from the
    same records."""
    from repro.obs import export as jexport
    from repro_torch.obs import export
    assert export.JSONL_SCHEMA == jexport.JSONL_SCHEMA
    assert export.SCHEMA_VERSION == jexport.SCHEMA_VERSION
    tel = obs.Telemetry(256, engine="rounds")
    sp = obs.Spans(classes=1, engine="rounds")
    run_port("fifo", tel, sp, sync_every=2)
    path = str(tmp_path / "trace.jsonl")
    n = obs.write_jsonl(path, tel.records, tel.sync_points,
                        metrics=tel.registry.snapshot(), engine="rounds",
                        spans=sp)
    assert n == 1 + len(tel.records) + len(tel.sync_points) + 2 + len(
        sp.flows)
    back = obs.read_jsonl(path)
    assert back["records"] == tel.records and back["syncs"] == \
        tel.sync_points
    assert back["hist"] == dict(sp.summary(), engine="rounds")
    chrome = str(tmp_path / "trace.json")
    obs.write_chrome_trace(chrome, tel.records, tel.sync_points,
                           engine="rounds", flows=sp.flows)
    tool = os.path.join(REPO, "tools", "trace_check.py")
    res = subprocess.run([sys.executable, tool, path, "--chrome", chrome],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    jpath = str(tmp_path / "ref.jsonl")
    jrecs = [jobs.RoundRecord.from_dict(r.to_dict()) for r in tel.records]
    jsyncs = [jobs.SyncPoint(**p.to_dict()) for p in tel.sync_points]
    jexport.write_jsonl(jpath, jrecs, jsyncs,
                        metrics=tel.registry.snapshot(), engine="rounds",
                        spans=sp)
    assert open(path).read() == open(jpath).read()
    assert obs.to_chrome_trace(tel.records, tel.sync_points,
                               flows=sp.flows) == \
        jexport.to_chrome_trace(jrecs, jsyncs, flows=sp.flows)
