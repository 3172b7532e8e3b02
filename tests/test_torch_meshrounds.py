"""The port's FIFO mesh (``repro_torch.runtime.meshrounds``, mesh BFS in
``repro_torch.apps.bfs``) on the CPU, held against the JAX package.

The shard axis is a tensor dimension here, so the port runs any shard
count in one process; the reference runs under ``shard_map``, at one
shard in this process and at 2 and 4 shards in one forced-device
subprocess per shard count (run once per pytest run).  Covered:

* the goldens of ``tests/test_enginecore.py`` (``mesh_fanout``,
  ``mesh_bfs``, ``mesh_fanout_2``, ``mesh_bfs_2``: stats with
  ``host_syncs``, acc, planes, head/tail, dist, the ``tel`` digests);
* live reference runs at 1, 2 and 4 shards: telemetry and spans digests
  of the replicated ring, the sharded rings' whole state, the
  ``sync_every`` heartbeats, compaction forced on;
* the sharded rings exact against the replicated ring on acc and
  totals, with ``loop_carry_bytes`` 8,200, 4,112 and 2,080 B;
* fused equal to legacy; the overflow, seed-overflow, truncation and
  constructor errors word for word; mesh BFS exact against
  ``bfs_reference``;
* the round's grid waves (``ring_dequeue_wave`` / ``ring_enqueue_wave``,
  plain versions) against the functional ``core.distqueue`` rounds.

Integer state throughout, so every comparison is exact.  The kernels
run only on the card, where ``chip_smoke.py`` holds them against these
plain versions."""

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

from repro_torch import core as tcore  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.apps import bfs  # noqa: E402
from repro_torch.distributed import make_mesh  # noqa: E402
from repro_torch.kernels import (ring_dequeue_wave_plain,  # noqa: E402
                                 ring_enqueue_wave_plain)
from repro_torch.runtime import (ENGINE_REGISTRY, IDX_BOT,  # noqa: E402
                                 MeshRingEngine, MeshRoundRunner,
                                 ShardedMeshRingEngine)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
STATS = ("rounds", "processed", "spawned", "max_occupancy", "drained",
         "host_syncs")
# GOLDEN / GOLDEN_2SHARD of tests/test_enginecore.py
GOLDEN = {
    "mesh_fanout": {
        "stats": [7, 63, 62, 32, 1, 1], "acc": "b8d77df0675e0603",
        "planes": "1a0afe86d6513a2a", "head_tail": [575, 575],
        "tel": "cb3aae309ae1f69f"},
    "mesh_bfs": {"stats": [23, 144, 143, 12, 1, 1],
                 "dist": "c8795c4f65942e14"},
    "mesh_fanout_2": {
        "stats": [6, 63, 62, 32, 1, 1], "acc": "b8d77df0675e0603",
        "planes": "1a0afe86d6513a2a", "head_tail": [575, 575],
        "tel": "01bcb5be848e8028"},
    "mesh_bfs_2": {"stats": [23, 287, 286, 24, 1, 1],
                   "dist": "c8795c4f65942e14"},
}
CARRY = {1: 8200, 2: 4112, 4: 2080}      # capacity_log2=8, per shard


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


def tree_step(acc, vals, valid):
    acc = acc.index_add(0, torch.where(valid, vals, 0), valid.int())
    cv = torch.stack([vals * 2, vals * 2 + 1], -1).int()
    return acc, cv, (valid & (vals < 32))[:, None]


def jax_tree_step(acc, vals, valid):
    acc = acc.at[jnp.where(valid, vals, 0)].add(valid.astype(jnp.int32))
    cv = jnp.stack([vals * 2, vals * 2 + 1], -1).astype(jnp.int32)
    return acc, cv, (valid & (vals < 32))[:, None]


def explode_step(acc, vals, valid):
    cv = vals[:, None].expand(-1, 4) + 1
    return acc, cv.int(), valid[:, None].expand(-1, 4)


def jax_explode_step(acc, vals, valid):
    cv = jnp.broadcast_to(vals[:, None], (vals.shape[0], 4)) + 1
    return acc, cv.astype(jnp.int32), jnp.broadcast_to(valid[:, None],
                                                       cv.shape)


def immortal_step(acc, vals, valid):
    return acc, vals[:, None], valid[:, None]


def jax_immortal_step(acc, vals, valid):
    return acc, vals[:, None], valid[:, None]


def _sum32(a):
    return a.sum(0, dtype=torch.int32)


# -- one scenario set, run by the reference and by the port -------------------


def _scenarios(s, port: bool):
    """The runs both packages make at ``s`` shards; returns {name: result
    dict of plain ints, lists and digests}."""
    if port:
        from repro_torch.obs import Spans, Telemetry
        mesh = make_mesh((s,), ("data",))
        runner, step, comb = MeshRoundRunner, tree_step, _sum32
        zeros = lambda: torch.zeros(80, dtype=torch.int32)  # noqa: E731
        kw = dict(device="cpu")
        graph_bfs = lambda g, **k: bfs.bfs_mesh_rounds(  # noqa: E731
            g, 0, mesh=mesh, batch=32, device="cpu", **k)
    else:
        from repro import runtime as jrt
        from repro.apps import bfs as jbfs
        from repro.jaxcompat import make_mesh as jmesh
        from repro.obs import Spans, Telemetry
        mesh = jmesh((s,), ("data",))
        runner, step = jrt.MeshRoundRunner, jax_tree_step
        comb = lambda a: a.sum(0)  # noqa: E731
        zeros = lambda: jnp.zeros(80, jnp.int32)  # noqa: E731
        kw = {}
        graph_bfs = lambda g, **k: jbfs.bfs_mesh_rounds(  # noqa: E731
            g, 0, mesh=mesh, batch=32, **k)
    out = {}

    def tree(name, **opts):
        tel = Telemetry(capacity=256)
        sp = opts.pop("spans", None)
        r = runner(step, mesh=mesh, capacity_log2=8, batch=16,
                   combine=comb, telemetry=tel, spans=sp, **opts, **kw)
        acc, st = r.run([1], acc=zeros())
        res = {"stats": _stats(r.stats), "acc": _digest(acc),
               "planes": _digest(*st[:4]), "tel": _tel_digest(tel),
               "sync_log": [(p.rounds, p.occupancy, p.host_syncs)
                            for p in r.sync_log]}
        if opts.get("sharded"):
            res["tickets"] = [_np(st.tails).tolist(), _np(st.heads).tolist()]
        else:
            res["head_tail"] = [int(_np(st.head)), int(_np(st.tail))]
        if sp is not None:
            res["spans"] = _digest(sp.hist, sp.max_wait)
            res["flows"] = sp.flows
            res["p"] = [sp.percentile(q) for q in (0.5, 0.95, 0.99)]
        out[name] = res

    tree("plain")
    tree("spans", spans=Spans(classes=1, buckets=8))
    tree("sharded", sharded=True)
    tree("sync2", sync_every=2)
    tree("compact", compact=True)
    tree("sharded_compact", sharded=True, compact=True)
    for name, g in (("road", bfs.road_like(144)),
                    ("kron", bfs.kron_like(200, avg_deg=6, seed=2))):
        dist, stats = graph_bfs(g)
        out["bfs_" + name] = {"stats": _stats(stats),
                              "dist": _digest(np.asarray(dist))}
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
                env=_forced_device_env(s), timeout=600)
            assert out.returncode == 0, out.stderr[-3000:]
            ref = json.loads(out.stdout.strip().splitlines()[-1])
        ref = json.loads(json.dumps(ref))            # tuples as lists
        port = json.loads(json.dumps(_scenarios(s, port=True)))
        _CACHE[s] = (ref, port)
    return _CACHE[s]


# -- goldens ------------------------------------------------------------------


def _golden_run(name, fused=True):
    s = 2 if name.endswith("_2") else 1
    mesh = make_mesh((s,), ("data",))
    if name.startswith("mesh_bfs"):
        dist, stats = bfs.bfs_mesh_rounds(bfs.road_like(144), 0, mesh=mesh,
                                          batch=32, fused=fused,
                                          device="cpu")
        return {"stats": _stats(stats), "dist": _digest(dist)}
    tel = obs.Telemetry(capacity=256) if fused else None
    r = MeshRoundRunner(tree_step, mesh=mesh, capacity_log2=8, batch=16,
                        fused=fused, combine=_sum32, telemetry=tel,
                        device="cpu")
    acc, st = r.run([1], acc=torch.zeros(80, dtype=torch.int32))
    out = {"stats": _stats(r.stats), "acc": _digest(acc),
           "planes": _digest(*st[:4]), "head_tail": [st.head, st.tail]}
    if fused:
        out["tel"] = _tel_digest(tel)
    return out


@pytest.mark.parametrize("name", list(GOLDEN))
def test_mesh_goldens(name):
    assert _golden_run(name) == GOLDEN[name]


@pytest.mark.parametrize("name", list(GOLDEN))
def test_legacy_loop_gives_the_golden_state(name):
    """The legacy loop: the golden state, one readback a round."""
    got = _golden_run(name, fused=False)
    want = dict(GOLDEN[name])
    want.pop("tel", None)
    rounds = want["stats"][0]
    assert got["stats"] == want["stats"][:5] + [rounds]
    got.pop("stats"), want.pop("stats")
    assert got == want


# -- live reference runs at 1, 2 and 4 shards ---------------------------------


@pytest.mark.parametrize("scenario", ["plain", "spans", "sharded", "sync2",
                                      "compact", "sharded_compact",
                                      "bfs_road", "bfs_kron"])
@pytest.mark.parametrize("s", (1, 2, 4))
def test_matches_reference_runs(s, scenario):
    """Stats, acc, planes, head/tail (each ring's tickets when sharded),
    the sync log, the telemetry digest and, with spans, the span digest,
    flow exemplars and percentiles: equal to the reference's run of the
    same scenario at ``s`` shards."""
    ref, port = _results(s)
    assert port[scenario] == ref[scenario]


@pytest.mark.parametrize("s", (1, 2, 4))
def test_sharded_exact_against_replicated(s):
    """The sharded rings give the replicated ring's acc and totals, with
    each shard carrying 1/S of the ring (``loop_carry_bytes``)."""
    mesh = make_mesh((s,), ("data",))
    res = {}
    for sharded in (False, True):
        r = MeshRoundRunner(tree_step, mesh=mesh, capacity_log2=8, batch=16,
                            sharded=sharded, combine=_sum32, device="cpu")
        acc, _ = r.run([1], acc=torch.zeros(80, dtype=torch.int32),
                       max_rounds=200)
        res[sharded] = (acc.tolist(), r.stats["processed"],
                        r.stats["spawned"], r.loop_carry_bytes())
    assert res[True][:3] == res[False][:3]
    assert res[False][3] == CARRY[1] and res[True][3] == CARRY[s]


@pytest.mark.parametrize("s", (1, 2))
def test_fused_equals_legacy(s):
    """Tree and BFS: the legacy loop's acc, planes, head/tail and stats
    (but host_syncs) equal the fused engine's."""
    mesh = make_mesh((s,), ("data",))
    runs = []
    for fused in (True, False):
        r = MeshRoundRunner(tree_step, mesh=mesh, capacity_log2=8, batch=16,
                            fused=fused, combine=_sum32, device="cpu")
        acc, st = r.run([1], acc=torch.zeros(80, dtype=torch.int32))
        d, bs = bfs.bfs_mesh_rounds(bfs.kron_like(200, avg_deg=6, seed=2),
                                    0, mesh=mesh, batch=32, fused=fused,
                                    device="cpu")
        runs.append((acc.tolist(), [p.tolist() for p in st[:4]],
                     st.head, st.tail, _stats(r.stats)[:5], d.tolist(),
                     _stats(bs)[:5], r.stats["host_syncs"]))
    assert runs[0][:7] == runs[1][:7]
    assert runs[0][7] == 1 and runs[1][7] == runs[1][4][0]


@pytest.mark.parametrize("sync_every", (1, 3))
def test_sync_every_heartbeats(sync_every):
    """A readback every ``sync_every`` rounds: the same acc as one chunk,
    the sync log the reference's."""
    from repro import runtime as jrt
    from repro.jaxcompat import make_mesh as jmesh
    logs = []
    for port in (True, False):
        if port:
            r = MeshRoundRunner(tree_step, mesh=make_mesh((1,), ("data",)),
                                capacity_log2=8, batch=16,
                                sync_every=sync_every, combine=_sum32,
                                device="cpu")
            acc, _ = r.run([1], acc=torch.zeros(80, dtype=torch.int32))
        else:
            r = jrt.MeshRoundRunner(jax_tree_step, mesh=jmesh((1,), ("data",)),
                                    capacity_log2=8, batch=16,
                                    sync_every=sync_every,
                                    combine=lambda a: a.sum(0))
            acc, _ = r.run([1], acc=jnp.zeros(80, jnp.int32))
        logs.append(([(p.rounds, p.occupancy, p.host_syncs)
                      for p in r.sync_log], _stats(r.stats),
                     _digest(np.asarray(_np(acc)))))
    assert logs[0] == logs[1]
    assert logs[0][1][5] > 1 and logs[0][0][-1][1] == 0
    assert logs[0][2] == GOLDEN["mesh_fanout"]["acc"]


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
@pytest.mark.parametrize("case", ("overflow", "seed_overflow", "truncation"))
def test_errors_match_reference(case, fused):
    from repro import runtime as jrt
    from repro.jaxcompat import make_mesh as jmesh
    step, jstep, cap, seeds, rounds = {
        "overflow": (explode_step, jax_explode_step, 4, np.arange(8), 100),
        "seed_overflow": (tree_step, jax_tree_step, 4, np.arange(64), 100),
        "truncation": (immortal_step, jax_immortal_step, 6, [1, 2, 3], 5),
    }[case]
    batch = 8
    port = MeshRoundRunner(step, mesh=make_mesh((1,), ("data",)),
                           capacity_log2=cap, batch=batch, fused=fused,
                           device="cpu")
    ref = jrt.MeshRoundRunner(jstep, mesh=jmesh((1,), ("data",)),
                              capacity_log2=cap, batch=batch, fused=fused)
    acc = np.zeros(80, np.int32) if case == "seed_overflow" else 0
    msg = _both(lambda: port.run(seeds, acc=acc, max_rounds=rounds),
                lambda: ref.run(seeds, acc=jnp.asarray(acc, jnp.int32),
                                max_rounds=rounds))
    assert "mesh ring overflow" in msg or "not quiescent" in msg
    if case == "truncation":
        assert port.stats["drained"] == 0 and port.stats["rounds"] == 5
        assert port.stats == ref.stats


@pytest.mark.parametrize("fused", (True, False))
@pytest.mark.parametrize("case", ("empty", "max_rounds_0"))
def test_runs_with_no_round_match_reference(case, fused):
    """No round runs: on empty seeds the run drains with no sync point in
    the legacy loop (``host_syncs`` 0, ``sync_log`` []) and one readback
    in the fused engine; at ``max_rounds=0`` with work left both raise the
    reference's truncation error with the reference's stats and log."""
    from repro import runtime as jrt
    from repro.jaxcompat import make_mesh as jmesh
    seeds, rounds = {"empty": ([], 100), "max_rounds_0": ([0, 1, 2], 0)}[case]
    runs = []
    for port in (True, False):
        if port:
            r = MeshRoundRunner(tree_step, mesh=make_mesh((1,), ("data",)),
                                capacity_log2=8, batch=16, fused=fused,
                                device="cpu")
            acc = torch.zeros(80, dtype=torch.int32)
        else:
            r = jrt.MeshRoundRunner(jax_tree_step,
                                    mesh=jmesh((1,), ("data",)),
                                    capacity_log2=8, batch=16, fused=fused)
            acc = jnp.zeros(80, jnp.int32)
        try:
            r.run(np.asarray(seeds, np.int32), acc=acc, max_rounds=rounds)
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


def test_sharded_overflow_raises():
    r = MeshRoundRunner(explode_step, mesh=make_mesh((2,), ("data",)),
                        capacity_log2=4, batch=4, sharded=True, device="cpu")
    with pytest.raises(RuntimeError, match="^sharded mesh ring overflow"):
        r.run(np.arange(8), acc=0, max_rounds=100)


def test_constructor_errors_match_reference():
    from repro import runtime as jrt
    from repro.jaxcompat import make_mesh as jmesh
    mesh, jm = make_mesh((1,), ("data",)), jmesh((1,), ("data",))
    for kw in (dict(capacity_log2=4, batch=64),
               dict(capacity_log2=8, batch=16, sharded=True,
                    spans=obs.Spans(classes=1, buckets=8)),
               dict(capacity_log2=8, batch=16, sharded=True, fused=False),
               dict(capacity_log2=8, batch=16, fused=False,
                    spans=obs.Spans(classes=1, buckets=8))):
        jkw = dict(kw)
        if "spans" in jkw:
            from repro.obs import Spans
            jkw["spans"] = Spans(classes=1, buckets=8)
        _both(lambda: MeshRoundRunner(tree_step, mesh=mesh, device="cpu",
                                      **kw),
              lambda: jrt.MeshRoundRunner(jax_tree_step, mesh=jm, **jkw))
    # batch x shards, at a shard count the reference cannot reach here
    with pytest.raises(ValueError, match="^mesh batch 8 x 4 shards exceeds "
                                         "ring capacity 16$"):
        MeshRingEngine(tree_step, mesh=make_mesh((4,), ("data",)),
                       capacity_log2=4, batch=8, device="cpu")
    with pytest.raises(ValueError, match="replicated mesh engine"):
        ShardedMeshRingEngine(tree_step, mesh=mesh, spans=obs.Spans(),
                              device="cpu")


def test_engine_registry_rows():
    assert ENGINE_REGISTRY["mesh"].runner is MeshRoundRunner
    assert ENGINE_REGISTRY["mesh"].mesh and ENGINE_REGISTRY["mesh"].spans_ok
    row = ENGINE_REGISTRY["mesh-sharded"]
    assert row.kwargs == {"sharded": True} and not row.spans_ok


# -- mesh BFS -----------------------------------------------------------------


@pytest.mark.parametrize("sharded", (False, True))
@pytest.mark.parametrize("s", (1, 2, 4))
def test_mesh_bfs_exact(s, sharded):
    for g in (bfs.road_like(144), bfs.kron_like(200, avg_deg=6, seed=2)):
        dist, stats = bfs.bfs_mesh_rounds(g, 0, shards=s, batch=32,
                                          sharded=sharded, device="cpu")
        assert np.array_equal(dist, bfs.bfs_reference(g, 0)), g.name
        assert stats["drained"] == 1 and stats["host_syncs"] == 1


def test_mesh_bfs_guards_match_reference():
    from repro.apps import bfs as jbfs
    from repro.jaxcompat import make_mesh as jmesh
    big = bfs.road_like(215 * 215)   # the largest square: n (n + 2) < 2^31
    r, _ = bfs.bfs_mesh_rounds_runner(big, shards=4, batch=1024,
                                      device="cpu")
    assert r.capacity_log2 == 19
    wide = bfs.road_like(216 * 216)
    _both(lambda: bfs.bfs_mesh_rounds_runner(wide, device="cpu"),
          lambda: jbfs.bfs_mesh_rounds_runner(
              wide, mesh=jmesh((1,), ("data",))))
    g = bfs.road_like(10_000)
    _both(lambda: bfs.bfs_mesh_rounds_runner(g, batch=1 << 16,
                                             device="cpu"),
          lambda: jbfs.bfs_mesh_rounds_runner(g, batch=1 << 16,
                                              mesh=jmesh((1,), ("data",))))


# -- the grid waves against the functional rounds -----------------------------


@pytest.mark.parametrize("start", (None, 2 ** 31 - 256, 2 ** 32 - 256))
@pytest.mark.parametrize("s", (1, 2, 4, 8))
def test_grid_waves_equal_functional_rounds(s, start):
    """A round's claim and publish as the engine runs them
    (``ring_dequeue_wave_plain`` / ``ring_enqueue_wave_plain``, in place)
    against ``dist_claim_round`` + ``dist_publish_round`` (ballot) and
    ``dist_publish_compact_round`` (grid-dense), round after round, with
    an overflowing round and a live=False round."""
    rng = np.random.default_rng(s)
    b, n, cap = 8, 16, 128
    kw = dict(nslots_log2=8, idx_bot=IDX_BOT)
    st = tcore.dist_queue_init(cap, start=None if start is None
                               else start // 256 * 256, device="cpu")
    ring = [p.clone() for p in st[:4]]
    head, tail = st.head.clone(), st.tail.clone()
    st, _ = tcore.dist_enqueue_round(
        st, torch.arange(1, 41, dtype=torch.int32).reshape(1, 40),
        torch.ones((1, 40), dtype=torch.int32))
    ring_enqueue_wave_plain(*ring, head, tail,
                            torch.arange(1, 41, dtype=torch.int32),
                            torch.tensor(True), capacity=cap, shards=1,
                            mask=torch.ones(40, dtype=torch.bool), **kw)
    for r in range(8):
        live = torch.tensor(r != 5)
        vals, ok, k, pops = ring_dequeue_wave_plain(
            *ring, head, tail, live, batch=b, shards=s, **kw)
        want_k = min(int(st.occupancy), s * b) if r != 5 else 0
        st, v2, ok2 = tcore.dist_claim_round(st, want_k, b, s)
        assert int(k) == want_k and torch.equal(vals, v2)
        assert torch.equal(ok, ok2)
        assert pops.sum().item() == want_k
        cv = torch.as_tensor(rng.integers(0, 1 << 20, (s, n)),
                             dtype=torch.int32)
        cm = torch.as_tensor(rng.random((s, n)) < (0.9 if r == 3 else 0.4))
        if r % 2:
            out = ring_enqueue_wave_plain(*ring, head, tail, cv.reshape(-1),
                                          live, capacity=cap, shards=s,
                                          mask=cm.reshape(-1), **kw)
            if r != 5:
                st, _, total, over, counts = tcore.dist_publish_round(
                    st, cv, cm, capacity=cap, with_counts=True)
        else:
            dense, counts_in = tcore.distqueue._compact_rows(cv, cm, n)
            out = ring_enqueue_wave_plain(*ring, head, tail, dense, live,
                                          capacity=cap, shards=s,
                                          counts=counts_in, **kw)
            if r != 5:
                st, _, total, over, counts = \
                    tcore.dist_publish_compact_round(
                        st, cv, cm, capacity=cap, width=n, with_counts=True)
        if r == 5:
            assert int(out[0]) == 0 and not bool(out[1])
            assert not out[2].any()
            continue
        assert (int(out[0]), bool(out[1])) == (int(total), bool(over))
        assert torch.equal(out[2], counts)
        for a, c in zip(ring, st[:4]):
            assert torch.equal(a, c)
        assert (int(head), int(tail)) == (int(st.head), int(st.tail))


@pytest.mark.parametrize("width", (None, 16))
@pytest.mark.parametrize("s", (1, 2, 4, 8))
def test_sharded_grid_waves_equal_functional_rounds(s, width):
    """The sharded rings' claim and publish as the engine runs them
    against ``dist_sharded_claim_round`` / ``dist_sharded_publish_round``,
    round after round, with rings overflowing."""
    rng = np.random.default_rng(10 + s)
    b, n, cap = 4, 16, 64
    lc, lg = cap // s, (2 * (cap // s)).bit_length() - 1
    kw = dict(nslots_log2=lg, idx_bot=IDX_BOT)
    st = tcore.dist_sharded_queue_init(cap, s, device="cpu")
    planes, heads, tails = tuple(st[:4]), st.heads, st.tails
    ring = [p.clone() for p in planes]
    gh, gt = heads.clone(), tails.clone()
    live = torch.tensor(True)
    for r in range(8):
        cv = torch.as_tensor(rng.integers(0, 1 << 20, (s, n)),
                             dtype=torch.int32)
        cm = torch.as_tensor(rng.random((s, n)) < (0.95 if r == 4 else 0.3))
        if width is None:
            out = ring_enqueue_wave_plain(*ring, gh, gt, cv.reshape(-1),
                                          live, capacity=lc,
                                          mask=cm.reshape(-1), **kw)
        else:
            dense, counts = tcore.distqueue._compact_rows(cv, cm, width)
            out = ring_enqueue_wave_plain(*ring, gh, gt, dense, live,
                                          capacity=lc, counts=counts, **kw)
        planes, tails, total, over, assigned = \
            tcore.dist_sharded_publish_round(
                planes, heads, tails, cv, cm, nslots_log2=lg,
                local_capacity=lc, width=width)
        assert (int(out[0]), bool(out[1])) == (int(total), bool(over))
        assert torch.equal(out[2], assigned) and torch.equal(gt, tails)
        vals, ok, k, pops = ring_dequeue_wave_plain(*ring, gh, gt, live,
                                                    batch=b, **kw)
        planes, heads, v2, ok2, counts = tcore.dist_sharded_claim_round(
            planes, heads, tails, b, nslots_log2=lg)
        assert torch.equal(vals, v2) and torch.equal(ok, ok2)
        assert torch.equal(pops, counts) and int(k) == int(counts.sum())
        assert torch.equal(gh, heads)
        for a, c in zip(ring, planes):
            assert torch.equal(a, c)


if __name__ == "__main__":
    if "--worker" in sys.argv:
        s = int(sys.argv[sys.argv.index("--worker") + 1])
        print(json.dumps(_scenarios(s, port=False)))
