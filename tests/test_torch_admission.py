"""The port's device serving admission (``repro_torch.serving.admission:
ServingMeshEngine``, the traffic generator, ``ServingEngine(admission=
"device")``) on the CPU, held against the JAX package.

* The serving goldens of ``tests/test_enginecore.py`` (``GOLDEN
  ["serving"]``, ``GOLDEN_2SHARD["serving_2"]``): stats with
  ``host_syncs``, ticks, the admitted order, planes, the pop history and
  the telemetry digest.
* ``tests/test_serving_admission.py``'s property on the port: at one
  shard every tick's admitted list equals its pure-Python EDF
  reference, and the pop history is priority-linearizable at k = 0 under
  the reference's checker; at two shards conservation and the checker at
  ``mesh_relaxation_bound``.
* The stall exit: a tick ends with the round that republished.
* The page-stall aging case, the deadline cap at, above and below 2^30,
  the span clock at the birth-stamp cap, and the errors word for word.
* ``ServingEngine(admission="device")`` against the reference's host
  pool on h2o-danube-1.8b reduced, with the traffic of
  ``test_device_admission_matches_host_pool``.
* ``generate_trace`` equal to the reference's.

Integer state throughout: every comparison is exact."""

import functools
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.distributed import make_mesh  # noqa: E402
from repro_torch.runtime import ENGINE_REGISTRY  # noqa: E402
from repro_torch.serving import (DEADLINE_KEY_CAP, EngineConfig,  # noqa
                                 Request, ServingEngine, ServingMeshEngine,
                                 TrafficConfig, generate_trace, offered_load)

STATS = ("rounds", "processed", "spawned", "max_occupancy", "drained",
         "host_syncs")
BATCH = 4
# GOLDEN["serving"] / GOLDEN_2SHARD["serving_2"] of tests/test_enginecore.py
GOLDEN = {
    "serving": {
        "stats": [4, 20, 12, 6, 1, 4], "ticks": 4,
        "admitted": [1, 3, 7, 2, 6, 5, 4, 0],
        "planes": "d70650fb443f714a", "hist": "256ab85ea28951cc",
        "tel": "55a5a0cd9cee8fb0"},
    "serving_2": {
        "stats": [4, 20, 12, 6, 1, 4], "ticks": 4,
        "admitted": [2, 1, 7, 3, 6, 4, 5, 0],
        "planes": "6ddad96eb514c320", "hist": "385db6ed17cface3",
        "tel": "12c1f9a6ce0747a2"},
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One torch thread for this file's tests: the tier-1 run puts six
    test workers on the machine's cores, where a pool as wide as the cores
    in each only contends with the others; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()[:16]


def _tel_digest(tel):
    rows = [(r.round, r.imbalance, r.min_key, r.max_key, int(r.overflow),
             tuple(r.pops), tuple(r.pushes), tuple(r.occupancy))
            for r in tel.records]
    return hashlib.sha256(repr(rows).encode()).hexdigest()[:16]


def _engine(shards=1, **kw):
    kw = dict(dict(capacity_log2=6, batch=BATCH, table_log2=6,
                   pop_log=2048), **kw)
    return ServingMeshEngine(mesh=make_mesh((shards,), ("data",)),
                             device="cpu", **kw)


def _ref_engine(**kw):
    from repro.jaxcompat import make_mesh as jmesh
    from repro.serving import ServingMeshEngine as JEngine
    kw = dict(dict(capacity_log2=6, batch=BATCH, table_log2=6,
                   pop_log=2048), **kw)
    return JEngine(mesh=jmesh((1,), ("data",)), **kw)


# -- goldens ------------------------------------------------------------------


@pytest.mark.parametrize("name", list(GOLDEN))
def test_serving_goldens(name):
    """tests/test_enginecore.py: _serving_scenario on the port."""
    tel = obs.Telemetry(capacity=256)
    e = ServingMeshEngine(mesh=make_mesh((2 if name.endswith("_2") else 1,),
                                         ("data",)),
                          capacity_log2=6, batch=8, table_log2=6,
                          pop_log=128, telemetry=tel, device="cpu")
    e.begin()
    admitted = list(e.tick([60, 10, 30, 20, 50, 40, 35, 25],
                           [0, 1, 2, 3, 4, 5, 6, 7],
                           slots=4, pages=5, need=[2] * 8))
    ticks = 1
    while e.occupancy() > 0 and ticks < 12:
        admitted += e.tick([], [], slots=4, pages=4)
        ticks += 1
    assert e.occupancy() == 0, "scenario must drain"
    st = e.heap_state()
    got = {"stats": [int(e.stats[k]) for k in STATS], "ticks": ticks,
           "admitted": admitted, "planes": _digest(st.keys, st.vals),
           "hist": _digest(np.asarray(e.pop_history(), np.int32)),
           "tel": _tel_digest(tel)}
    assert got == GOLDEN[name]
    assert [p.host_syncs for p in e.sync_log] == [1, 2, 3, 4]


def test_engine_registry_row():
    row = ENGINE_REGISTRY["serving"]
    assert row.runner is ServingMeshEngine
    assert row.priority and row.mesh and row.spans_ok and row.kwargs == {}


# -- the admission property ---------------------------------------------------


def _make_scenario(rng):
    """tests/test_serving_admission.py: random deadlines, page needs,
    arrivals and budgets (zero budgets = pure stall ticks), then two
    generous drain ticks."""
    n = int(rng.integers(1, 15))
    keys = np.sort(rng.choice(50_000, size=n, replace=False)).astype(int)
    rng.shuffle(keys)
    need = rng.integers(0, 4, size=n).astype(int)
    ticks_n = int(rng.integers(1, 4))
    arrive = rng.integers(0, ticks_n, size=n)
    budgets = [(int(rng.integers(0, 5)), int(rng.integers(0, 9)))
               for _ in range(ticks_n)]
    budgets += [(n, int(3 * n + 1))] * 2
    arrivals = [[] for _ in range(len(budgets))]
    for idx in range(n):
        arrivals[int(arrive[idx])].append((int(keys[idx]), idx))
    return {"n": n, "need": list(need), "arrivals": arrivals,
            "budgets": budgets}


def _reference(scn):
    """Pure-Python EDF admission: pending sorted by deadline each tick,
    admit the maximal prefix that fits, the rest stay at their keys."""
    pending, per_tick = [], []
    for t, (slots, pages) in enumerate(scn["budgets"]):
        pending.extend(scn["arrivals"][t])
        pending.sort()
        admitted = []
        for key, idx in pending:
            nd = scn["need"][idx]
            if len(admitted) >= slots or nd > pages:
                break
            admitted.append(idx)
            pages -= nd
        del pending[:len(admitted)]
        per_tick.append(admitted)
    return per_tick, [idx for _, idx in pending]


def _run(eng, scn):
    eng.begin()
    subs, per_tick = [], []
    for t, (slots, pages) in enumerate(scn["budgets"]):
        arr = scn["arrivals"][t]
        subs.extend((eng._rounds, key, idx) for key, idx in arr)
        per_tick.append(eng.tick([k for k, _ in arr], [i for _, i in arr],
                                 slots=slots, pages=pages,
                                 need=[scn["need"][i] for _, i in arr]))
    return per_tick, subs


def _history(subs, pops, resident, table):
    """tests/test_serving_admission.py: _admission_history."""
    from repro.core.sim import HistoryEvent
    from repro.sched import DELMIN, INS
    popped = {v for _, _, _, v in pops}
    res = {retry * table + idx for _, idx, retry in resident}
    h = []
    for r0, key, idx in subs:
        t = 4 * r0 + 2
        h.append(HistoryEvent(proc=0, op=INS, arg=(key, idx), ret=True,
                              call=t, end=t + 1))
    for r, s, k, v in pops:
        t = 4 * r + 4
        h.append(HistoryEvent(proc=s, op=DELMIN, arg=None, ret=(k, v),
                              call=t, end=t + 1))
        if v + table in popped or v + table in res:
            h.append(HistoryEvent(proc=s, op=INS, arg=(k, v + table),
                                  ret=True, call=t + 2, end=t + 3))
    return h


def _certify(eng, scn, exact_order):
    from repro.sched import check_p_linearizable, mesh_relaxation_bound
    ref_ticks, ref_left = _reference(scn)
    ticks, subs = _run(eng, scn)
    assert ref_left == []
    if exact_order:
        assert ticks == ref_ticks, (scn, ticks, ref_ticks)
    assert sorted(i for t in ticks for i in t) == list(range(scn["n"]))
    assert eng.occupancy() == 0
    k = mesh_relaxation_bound(eng.shards, eng.batch,
                              eng.stats["max_occupancy"])
    if exact_order:
        assert k == 0
    res = check_p_linearizable(
        _history(subs, eng.pop_history(), eng.resident(), eng.table), k)
    assert res.ok, (res.reason, scn)


@pytest.mark.parametrize("seed", range(8))
def test_admission_property_one_shard(seed):
    _certify(_engine(), _make_scenario(np.random.default_rng(seed)), True)


@pytest.mark.parametrize("seed", (11, 12, 13))
def test_admission_property_two_shards(seed):
    _certify(_engine(2), _make_scenario(np.random.default_rng(seed)), False)


def test_one_shard_ticks_match_the_reference_engine():
    """The same scenarios through the reference's engine: per-tick
    admitted lists, stats, sync log and pop history equal."""
    port, ref = _engine(), _ref_engine()
    for seed in (3, 4):
        scn = _make_scenario(np.random.default_rng(seed))
        out = []
        for e in (port, ref):
            ticks, _ = _run(e, scn)
            out.append((ticks, dict(e.stats), e.pop_history(),
                        [(p.rounds, p.occupancy, p.host_syncs)
                         for p in e.sync_log]))
        assert out[0] == out[1]


def test_stall_ends_the_tick():
    """The stop word: the first round that republishes ends the tick,
    with requests left resident and rounds to spare."""
    e = _engine()
    e.begin()
    adm = e.tick([5, 6, 7, 8, 9, 10], list(range(6)), slots=1, pages=100,
                 need=[1] * 6)
    assert adm == [0]
    assert e.stats["rounds"] == 1 and e.occupancy() == 5
    assert e.stats["spawned"] == 3           # the wave's unfit requests
    # no stall: the tick pops on until the heap is empty
    adm = e.tick([], [], slots=10, pages=100)
    assert adm == [1, 2, 3, 4, 5] and e.occupancy() == 0
    assert e.stats["rounds"] == 3


def test_page_stall_reenters_at_original_deadline():
    eng = _engine()
    eng.begin()
    assert eng.tick([100], [0], slots=1, pages=1, need=[4]) == []
    assert eng.occupancy() == 1
    assert eng.resident() == [(100, 0, 1)]
    assert eng.tick([200], [1], slots=2, pages=6, need=[1]) == [0, 1]
    assert eng.occupancy() == 0


# -- caps and errors ----------------------------------------------------------


def _both(port_fn, ref_fn):
    msgs = []
    for fn in (port_fn, ref_fn):
        with pytest.raises((RuntimeError, ValueError)) as e:
            fn()
        msgs.append((type(e.value), str(e.value)))
    assert msgs[0] == msgs[1]
    return msgs[0][1]


def test_deadline_cap_is_the_span_round_cap():
    from repro_torch.kernels.ring_slots import SPAN_ROUND_CAP
    assert DEADLINE_KEY_CAP == SPAN_ROUND_CAP == 1 << 30


@pytest.mark.parametrize("bad", (DEADLINE_KEY_CAP, DEADLINE_KEY_CAP + 5, -1))
def test_tick_rejects_wrapped_deadline_key(bad):
    port, ref = _engine(), _ref_engine()
    port.begin()
    ref.begin()
    msg = _both(lambda: port.tick([bad], [0], slots=1, pages=1, need=[1]),
                lambda: ref.tick([bad], [0], slots=1, pages=1, need=[1]))
    assert "would wrap" in msg


def test_near_cap_keys_order_exactly():
    eng = _engine()
    eng.begin()
    adm = eng.tick([DEADLINE_KEY_CAP - 2, DEADLINE_KEY_CAP - 5], [0, 1],
                   slots=2, pages=2, need=[1, 1])
    assert adm == [1, 0]


def test_insert_errors_match_reference():
    port, ref = _engine(capacity_log2=2), _ref_engine(capacity_log2=2)
    for e in (port, ref):
        e.begin()
        e.tick([1, 2, 3], [0, 1, 2], slots=0, pages=0, need=[1] * 3)
    msg = _both(lambda: port.tick([4, 5], [3, 4], slots=0, pages=0),
                lambda: ref.tick([4, 5], [3, 4], slots=0, pages=0))
    assert "serving heap overflow" in msg
    assert port.occupancy() == 3                 # nothing installed
    msg = _both(lambda: port.tick([4], [64], slots=0, pages=0),
                lambda: ref.tick([4], [64], slots=0, pages=0))
    assert "outside the 64-row table" in msg


def test_submit_rejects_wrapped_deadline():
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("h2o-danube-1.8b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    for admission in ("edf", "device"):
        eng = ServingEngine(cfg, params, EngineConfig(
            max_slots=2, page_size=8, num_pages=8, max_seq=64,
            admission=admission, device_capacity_log2=6,
            device_batch=BATCH, device_table_log2=6), device="cpu")
        with pytest.raises(ValueError, match="would wrap"):
            eng.submit(Request(rid=0, prompt=np.array([1], np.int32),
                               max_new_tokens=1, deadline=DEADLINE_KEY_CAP))
        assert eng.submit(Request(rid=1, prompt=np.array([1], np.int32),
                                  max_new_tokens=1,
                                  deadline=DEADLINE_KEY_CAP - 1))


def test_serving_span_clock_refuses_to_wrap():
    eng = _engine(pop_log=0, spans=obs.Spans(classes=1, buckets=8))
    assert eng.tick([5], [0], slots=1, pages=1, need=[1]) == [0]
    assert eng._rounds >= 1
    eng.span_round_cap = eng._rounds       # clock now AT the cap
    with pytest.raises(RuntimeError, match="birth-stamp cap"):
        eng.tick([6], [1], slots=1, pages=1, need=[1])


def test_spans_and_telemetry_match_reference():
    """Spans and telemetry on a stalling scenario: the span histogram
    and the telemetry digest equal the reference engine's."""
    from repro.obs import Spans as JSpans
    from repro.obs import Telemetry as JTelemetry
    runs = []
    for port in (True, False):
        tel = obs.Telemetry(capacity=64) if port else JTelemetry(capacity=64)
        sp = (obs.Spans(classes=1, buckets=8) if port
              else JSpans(classes=1, buckets=8))
        e = (_engine(pop_log=0, telemetry=tel, spans=sp) if port
             else _ref_engine(pop_log=0, telemetry=tel, spans=sp))
        e.begin()
        adm = e.tick([9, 3, 7, 1, 5], list(range(5)), slots=2, pages=3,
                     need=[1, 2, 1, 1, 2])
        adm += e.tick([2, 8], [5, 6], slots=1, pages=1, need=[1, 1])
        while e.occupancy():
            adm += e.tick([], [], slots=3, pages=9)
        runs.append((adm, dict(e.stats), _tel_digest(tel),
                     _digest(np.asarray(sp.hist), np.asarray(sp.max_wait))))
    assert runs[0] == runs[1]


# -- the serving engine -------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model():
    from repro.configs import get_config as jget
    from repro.models import init_params as jinit
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_numpy
    name = "h2o-danube-1.8b"
    jcfg, cfg = jget(name).reduced(), get_config(name).reduced()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jinit(jcfg))
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu")


def _drive(port, admission, trace, tc, policies=None):
    """tests/test_serving_admission.py: _drive_engine on either package."""
    jcfg, cfg, jp, tp = _model()
    kw = dict(max_slots=2, page_size=8, num_pages=8, max_seq=64,
              request_ring_capacity=64, admission=admission,
              tenants=tc.tenants, tenant_policies=policies,
              device_capacity_log2=6, device_batch=BATCH,
              device_table_log2=6)
    if port:
        eng = ServingEngine(cfg, tp, EngineConfig(**kw), device="cpu")
        make = Request
    else:
        from repro.serving import EngineConfig as JConfig
        from repro.serving import Request as JRequest
        from repro.serving import ServingEngine as JServing
        eng = JServing(jcfg, jp, JConfig(**kw))
        make = JRequest
    by_tick, reqs = {}, []
    for rid, a in enumerate(trace):
        req = make(rid=rid, prompt=(np.arange(a.prompt_len) % 17 + 1
                                    ).astype(np.int32),
                   max_new_tokens=a.max_new_tokens, priority=a.priority,
                   tenant=a.tenant)
        reqs.append(req)
        by_tick.setdefault(a.tick, []).append(req)
    horizon = max(by_tick) if by_tick else 0
    for _ in range(500):
        for req in by_tick.get(eng.tick, []):
            assert eng.submit(req)
        eng.step()
        if (eng.tick > horizon and not any(eng.slots) and not eng.stalled
                and eng._queue_empty()):
            break
    return eng, reqs


@pytest.mark.parametrize("policies", [None, ("strict", "weighted")],
                         ids=["inline-edf", "policy-lanes"])
def test_device_admission_matches_reference_host_pool(policies):
    from repro.serving import TrafficConfig as JTraffic
    from repro.serving import generate_trace as jtrace
    tc = TrafficConfig(ticks=30, rate=0.4, tenants=2, seed=3,
                       prompt_len=(2, 5), max_new_tokens=(1, 3))
    trace = generate_trace(tc)
    assert trace == [type(trace[0])(**a.__dict__) for a in jtrace(
        JTraffic(**tc.__dict__))]
    assert len(trace) >= 6
    host, hreqs = _drive(False, "edf", trace, tc, policies)
    dev, dreqs = _drive(True, "device", trace, tc, policies)
    assert dev.admission_log == host.admission_log
    assert dev.metrics["completed"] == host.metrics["completed"] == \
        len(trace)
    assert dev.metrics["decode_steps"] == host.metrics["decode_steps"]
    assert dev.tick == host.tick
    for hr, dr in zip(hreqs, dreqs):
        assert hr.deadline == dr.deadline
        assert (hr.admit_tick, hr.finish_tick) == \
            (dr.admit_tick, dr.finish_tick)
    # page conservation: all pages back on the free ring
    assert all(s is None for s in dev.slots)
    freed = sum(1 for _ in range(dev.ecfg.num_pages)
                if dev.free_pages.dequeue(timeout=0.0) is not None)
    assert freed == dev.ecfg.num_pages
    # one admission readback a tick that ran one
    assert dev._device.stats["host_syncs"] == len(dev._device.sync_log)


# -- traffic ------------------------------------------------------------------


@pytest.mark.parametrize("seed", (0, 5, 17))
def test_generate_trace_equals_reference(seed):
    from repro.serving import TrafficConfig as JTraffic
    from repro.serving import generate_trace as jtrace
    from repro.serving import offered_load as jload
    tc = TrafficConfig(ticks=300, rate=1.5, burst_period=16, burst_max=64,
                       tenants=3, seed=seed)
    jtc = JTraffic(**tc.__dict__)
    got, want = generate_trace(tc), jtrace(jtc)
    assert [a.__dict__ for a in got] == [a.__dict__ for a in want]
    assert offered_load(got, tc) == jload(want, jtc)
