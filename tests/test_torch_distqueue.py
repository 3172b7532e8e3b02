"""The port's mesh-level FIFO queue (``repro_torch.core.distqueue``) on the
CPU, held bit-exact against the JAX package's ``repro.core.distqueue``.

The same seeded numpy requests go through the reference under
``shard_map`` (one shard in this process; 2 and 4 shards in one
forced-device subprocess per shard count, run once per pytest run)
and through the port, which takes every shard's requests stacked as
``(S, B)`` rows on one device.  Every ``dist_*`` function is compared
op by op (ring planes, head/tail, granted, values, ok, totals, overflow
flags, per-shard counts), for ``engine="planes"`` and ``"scan"``, with
tickets starting at the JAX package's ``WRAP_STARTS`` (below and across
2^31 and 2^32), in rounds wider than the ring (sub-waves), with an
all-inactive round and an all-inactive shard; the sharded rings in the
sparse and the dense-wave publish, one ring overflowing; and the two
claim schedules on their own; the priority mesh's exchange
(``dist_priority_publish_round`` and its compact form, with and without
the telemetry meta words and the split layout's aux plane, one shard's
rows empty).  Integer state throughout, so every comparison is
exact."""

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
from repro_torch.distributed import (make_mesh, mesh_round_gather,  # noqa
                                     mesh_ticket_base)
from repro_torch.kernels import deq_planes, enq_planes  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ENGINES = ("planes", "scan")
# the JAX package's tests/test_distqueue.py WRAP_STARTS
WRAP_STARTS = (None, 2 ** 30, 2 ** 31 - 64, 2 ** 32 - 64)
SHARDS = (1, 2, 4)
CAP, B, ROUNDS = 16, 4, 5          # replicated scenario
OVER_CAP, OVER_B = 4, 12           # rounds wider than the 8-slot ring
SH_CAP, SH_N, SH_B = 32, 6, 4      # sharded scenario
PRI_W = 6                          # priority publish: child lanes a shard
PRI_OPTS = ("plain", "meta", "aux", "meta_aux")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One torch thread for this file's tests: the tier-1 run puts six
    test workers on the machine's cores, where a pool as wide as the cores
    in each only contends with the others; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start(start, cap):
    n2 = 2 * cap
    return None if start is None else (start // n2) * n2


def _inputs(s, seed, b, rounds):
    """Seeded requests for ``rounds`` rounds of every replicated op; round
    2 asks for nothing anywhere, and the last shard asks for nothing in
    round 3."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(rounds):
        d = {
            "values": rng.integers(1, 10_000, (s, b)) + r * 10_000,
            "emask": rng.random((s, b)) < 0.7,
            "want": rng.random((s, b)) < 0.7,
            "pvals": rng.integers(1, 10_000, (s, b)),
            "pmask": rng.random((s, b)) < 0.6,
            "cvals": rng.integers(1, 10_000, (s, b)),
            "cmask": rng.random((s, b)) < 0.6,
            "k": int(rng.integers(0, s * b + 3)),
        }
        for key in ("emask", "want", "pmask", "cmask"):
            if r == 2:
                d[key][:] = False
            if r == 3:
                d[key][-1] = False
        d = {k: (v.astype(np.int32) if isinstance(v, np.ndarray) else v)
             for k, v in d.items()}
        out.append(d)
    return out


def _sharded_inputs(s, seed):
    rng = np.random.default_rng(seed)
    return [{"values": rng.integers(1, 10_000, (s, SH_N)).astype(np.int32),
             "mask": (rng.random((s, SH_N)) < (0.9 if r < 3 else 0.4)
                      ).astype(np.int32),
             "mins": rng.integers(0, 100, s).astype(np.int32),
             "maxs": rng.integers(100, 200, s).astype(np.int32)}
            for r in range(6)]


def _pri_inputs(s, seed):
    """Seeded child rows, post-pop hints and sizes and popped-key extrema
    for the priority publish; the last shard spawns nothing in round 1."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(4):
        d = {"keys": rng.integers(-50, 50, (s, PRI_W)),
             "vals": rng.integers(0, 10_000, (s, PRI_W)),
             "aux": rng.integers(0, 1 << 20, (s, PRI_W)),
             "mask": rng.random((s, PRI_W)) < 0.6,
             "hint": rng.integers(-5, 60, s), "size": rng.integers(0, 40, s),
             "mn": rng.integers(-9, 0, s), "mx": rng.integers(0, 9, s)}
        if r == 1:
            d["mask"][-1] = False
        out.append({k: v.astype(np.int32) for k, v in d.items()})
    return out


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _put(res, key, **arrays):
    for name, a in arrays.items():
        res[f"{key}/{name}"] = np.asarray(a).astype(np.int64).tolist()


# -- the reference under shard_map -------------------------------------------


def _reference(s):
    """Every scenario through ``repro.core.distqueue`` on a mesh of ``s``
    devices.  Returns {key: nested list}."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro.core import distqueue as jd
    from repro.jaxcompat import make_mesh as jmesh

    mesh = jmesh((s,), ("data",))
    sm = lambda f, i, o: jax.jit(shard_map(f, mesh=mesh, in_specs=i,  # noqa
                                           out_specs=o, check_rep=False))
    d, r_ = P("data"), P()
    res = {}
    for engine in ENGINES:
        enq = sm(lambda st, v, m: jd.dist_enqueue_round(
            st, v, m, "data", engine=engine), (r_, d, d), (r_, d))
        deq = sm(lambda st, w: jd.dist_dequeue_round(
            st, w, "data", engine=engine), (r_, d), (r_, d, d))
        pub = sm(lambda st, v, m: jd.dist_publish_round(
            st, v, m, "data", capacity=CAP, engine=engine,
            with_counts=True), (r_, d, d), (r_, d, r_, r_, r_))

        def pubc_f(st, v, m):
            out = jd.dist_publish_compact_round(
                st, v, m, "data", capacity=CAP, width=B, with_counts=True)
            return out[0], out[2], out[3], out[4]

        pubc = sm(pubc_f, (r_, d, d), (r_, r_, r_, r_))
        claim = sm(lambda st, k: jd.dist_claim_round(
            st, k, B, "data", engine=engine, with_grid=True),
            (r_, r_), (r_, d, d, r_))
        for start in WRAP_STARTS:
            st = jd.dist_queue_init(CAP, start=_start(start, CAP))
            for r, x in enumerate(_inputs(s, 7 + s, B, ROUNDS)):
                key = f"rep/{engine}/{start}/{r}"
                st, g = enq(st, x["values"].reshape(-1),
                            x["emask"].reshape(-1))
                _put(res, key + "/enq", g=g, planes=st[:4],
                     ht=[st.tail, st.head])
                st, v, ok = deq(st, x["want"].reshape(-1))
                _put(res, key + "/deq", v=v, ok=ok, planes=st[:4],
                     ht=[st.tail, st.head])
                st, g, total, over, counts = pub(
                    st, x["pvals"].reshape(-1), x["pmask"].reshape(-1))
                _put(res, key + "/pub", g=g, total=total, over=over,
                     counts=counts, planes=st[:4], ht=[st.tail, st.head])
                st, total, over, counts = pubc(
                    st, x["cvals"].reshape(-1), x["cmask"].reshape(-1))
                _put(res, key + "/pubc", total=total, over=over,
                     counts=counts, planes=st[:4], ht=[st.tail, st.head])
                st, v, ok, (gv, gok) = claim(st, jnp.int32(x["k"]))
                _put(res, key + "/claim", v=v, ok=ok, gv=gv, gok=gok,
                     planes=st[:4], ht=[st.tail, st.head])
        # rounds wider than the ring: sub-waves of 2n tickets
        st = jd.dist_queue_init(OVER_CAP)
        for r, x in enumerate(_inputs(s, 3, OVER_B, 2)):
            key = f"over/{engine}/{r}"
            st, g = enq(st, x["values"].reshape(-1), x["emask"].reshape(-1))
            _put(res, key + "/enq", g=g, planes=st[:4],
                 ht=[st.tail, st.head])
            st, v, ok = deq(st, jnp.ones(s * OVER_B, jnp.int32))
            _put(res, key + "/deq", v=v, ok=ok, planes=st[:4],
                 ht=[st.tail, st.head])
    # the priority mesh's exchange, sparse and compact (width PRI_W - 2:
    # rows with more children keep their true counts)
    for opts in PRI_OPTS:
        meta, aux = "meta" in opts, "aux" in opts
        for width in (None, PRI_W - 2):
            def pub_f(ck, cv, m, h, sz, mn, mx, ax, meta=meta, aux=aux,
                      width=width):
                kw = dict(pop_meta=(mn[0], mx[0]) if meta else None,
                          aux=ax if aux else None)
                if width is None:
                    return jd.dist_priority_publish_round(
                        ck, cv, m, h[0], sz[0], "data", **kw)
                return jd.dist_priority_publish_compact_round(
                    ck, cv, m, h[0], sz[0], "data", width=width, **kw)
            nout = 7 + aux + 2 * meta
            pub = sm(pub_f, (d,) * 8, (r_,) * nout)
            for r, x in enumerate(_pri_inputs(s, 30 + s)):
                out = pub(*(x[k].reshape(-1) for k in (
                    "keys", "vals", "mask", "hint", "size", "mn", "mx",
                    "aux")))
                res[f"pri/{opts}/{width}/{r}"] = [
                    np.asarray(o).astype(np.int64).tolist() for o in out]
    # the sharded rings
    lg = (2 * (SH_CAP // s)).bit_length() - 1
    sclaim = sm(lambda pl, h, t: (lambda o: (tuple(p[None] for p in o[0]),)
                                  + o[1:])(jd.dist_sharded_claim_round(
                                      tuple(p[0] for p in pl), h, t, SH_B,
                                      "data", nslots_log2=lg)),
                ((d,) * 4, r_, r_), ((d,) * 4, r_, d, d, r_))
    for width in (None, SH_N):
        spub = sm(lambda pl, h, t, v, m, mn, mx: (
            lambda o: (tuple(p[None] for p in o[0]),) + o[1:])(
                jd.dist_sharded_publish_round(
                    tuple(p[0] for p in pl), h, t, v, m, "data",
                    nslots_log2=lg, local_capacity=SH_CAP // s, width=width,
                    pop_meta=(mn[0], mx[0]))),
            ((d,) * 4, r_, r_, d, d, d, d),
            ((d,) * 4, r_, r_, r_, r_, r_, r_))
        st = jd.dist_sharded_queue_init(SH_CAP, s)
        planes, heads, tails = tuple(st[:4]), st.heads, st.tails
        for r, x in enumerate(_sharded_inputs(s, 11 + s)):
            key = f"sh/{width}/{r}"
            planes, tails, total, over, assigned, mins, maxs = spub(
                planes, heads, tails, x["values"].reshape(-1),
                x["mask"].reshape(-1), x["mins"], x["maxs"])
            _put(res, key + "/pub", planes=planes, tails=tails, total=total,
                 over=over, assigned=assigned, mins=mins, maxs=maxs)
            planes, heads, v, ok, counts = sclaim(planes, heads, tails)
            _put(res, key + "/claim", planes=planes, heads=heads, v=v,
                 ok=ok, counts=counts)
    return res


def _port(s):
    """The same scenarios through ``repro_torch.core.distqueue`` on the
    CPU, the shards' requests stacked."""
    res = {}
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    for engine in ENGINES:
        kw = dict(engine=engine)
        for start in WRAP_STARTS:
            st = tcore.dist_queue_init(CAP, start=_start(start, CAP),
                                       device="cpu")
            for r, x in enumerate(_inputs(s, 7 + s, B, ROUNDS)):
                key = f"rep/{engine}/{start}/{r}"
                st, g = tcore.dist_enqueue_round(st, t(x["values"]),
                                                 t(x["emask"]), **kw)
                _put(res, key + "/enq", g=_np(g).reshape(-1),
                     planes=[_np(p) for p in st[:4]],
                     ht=[_np(st.tail), _np(st.head)])
                st, v, ok = tcore.dist_dequeue_round(st, t(x["want"]), **kw)
                _put(res, key + "/deq", v=_np(v).reshape(-1),
                     ok=_np(ok).reshape(-1), planes=[_np(p) for p in st[:4]],
                     ht=[_np(st.tail), _np(st.head)])
                st, g, total, over, counts = tcore.dist_publish_round(
                    st, t(x["pvals"]), t(x["pmask"]), capacity=CAP,
                    with_counts=True, **kw)
                _put(res, key + "/pub", g=_np(g).reshape(-1), total=total,
                     over=over, counts=counts,
                     planes=[_np(p) for p in st[:4]],
                     ht=[_np(st.tail), _np(st.head)])
                st, _, total, over, counts = tcore.dist_publish_compact_round(
                    st, t(x["cvals"]), t(x["cmask"]), capacity=CAP, width=B,
                    with_counts=True)
                _put(res, key + "/pubc", total=total, over=over,
                     counts=counts, planes=[_np(p) for p in st[:4]],
                     ht=[_np(st.tail), _np(st.head)])
                st, v, ok, (gv, gok) = tcore.dist_claim_round(
                    st, x["k"], B, s, with_grid=True, **kw)
                _put(res, key + "/claim", v=_np(v).reshape(-1),
                     ok=_np(ok).reshape(-1), gv=gv, gok=gok,
                     planes=[_np(p) for p in st[:4]],
                     ht=[_np(st.tail), _np(st.head)])
        st = tcore.dist_queue_init(OVER_CAP, device="cpu")
        for r, x in enumerate(_inputs(s, 3, OVER_B, 2)):
            key = f"over/{engine}/{r}"
            st, g = tcore.dist_enqueue_round(st, t(x["values"]),
                                             t(x["emask"]), **kw)
            _put(res, key + "/enq", g=_np(g).reshape(-1),
                 planes=[_np(p) for p in st[:4]],
                 ht=[_np(st.tail), _np(st.head)])
            st, v, ok = tcore.dist_dequeue_round(
                st, torch.ones((s, OVER_B), dtype=torch.int32), **kw)
            _put(res, key + "/deq", v=_np(v).reshape(-1),
                 ok=_np(ok).reshape(-1), planes=[_np(p) for p in st[:4]],
                 ht=[_np(st.tail), _np(st.head)])
    for opts in PRI_OPTS:
        meta, aux = "meta" in opts, "aux" in opts
        for width in (None, PRI_W - 2):
            for r, x in enumerate(_pri_inputs(s, 30 + s)):
                x = {k: t(v) for k, v in x.items()}
                kw = dict(pop_meta=(x["mn"], x["mx"]) if meta else None,
                          aux=x["aux"] if aux else None)
                args = (x["keys"], x["vals"], x["mask"], x["hint"],
                        x["size"])
                if width is None:
                    out = tcore.dist_priority_publish_round(*args, **kw)
                else:
                    out = tcore.dist_priority_publish_compact_round(
                        *args, width=width, **kw)
                res[f"pri/{opts}/{width}/{r}"] = [
                    _np(o).astype(np.int64).tolist() for o in out]
    lg = (2 * (SH_CAP // s)).bit_length() - 1
    for width in (None, SH_N):
        st = tcore.dist_sharded_queue_init(SH_CAP, s, device="cpu")
        planes, heads, tails = tuple(st[:4]), st.heads, st.tails
        for r, x in enumerate(_sharded_inputs(s, 11 + s)):
            key = f"sh/{width}/{r}"
            planes, tails, total, over, assigned, mins, maxs = \
                tcore.dist_sharded_publish_round(
                    planes, heads, tails, t(x["values"]), t(x["mask"]),
                    nslots_log2=lg, local_capacity=SH_CAP // s, width=width,
                    pop_meta=(t(x["mins"]), t(x["maxs"])))
            _put(res, key + "/pub", planes=[_np(p) for p in planes],
                 tails=tails, total=total, over=over, assigned=assigned,
                 mins=mins, maxs=maxs)
            planes, heads, v, ok, counts = tcore.dist_sharded_claim_round(
                planes, heads, tails, SH_B, nslots_log2=lg)
            _put(res, key + "/claim", planes=[_np(p) for p in planes],
                 heads=heads, v=_np(v).reshape(-1), ok=_np(ok).reshape(-1),
                 counts=counts)
    return res


_REF, _PORT = {}, {}


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
    """(reference, port) results at ``s`` shards, each computed once."""
    if s not in _REF:
        if s == 1:
            _REF[s] = _reference(1)
        else:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 str(s)], capture_output=True, text=True, cwd=REPO,
                env=_forced_device_env(s), timeout=600)
            assert out.returncode == 0, out.stderr[-3000:]
            _REF[s] = json.loads(out.stdout.strip().splitlines()[-1])
        _PORT[s] = _port(s)
    return _REF[s], _PORT[s]


def _same(prefix, s):
    ref, port = _results(s)
    keys = sorted(k for k in ref if k.startswith(prefix))
    assert keys and keys == sorted(k for k in port if k.startswith(prefix))
    for k in keys:
        assert port[k] == ref[k], k


@pytest.mark.parametrize("start", WRAP_STARTS)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("s", SHARDS)
def test_replicated_rounds_bit_exact(s, engine, start):
    """enqueue, dequeue, publish (whole-round suppression, per-shard
    counts), compact publish and claim (the gathered grid) round after
    round from a ring whose tickets start at ``start``: every plane,
    head/tail and output equal to the reference's at ``s`` shards."""
    _same(f"rep/{engine}/{start}/", s)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("s", SHARDS)
def test_overcapacity_round_subwaves(s, engine):
    """Rounds of S x 12 requests on an 8-slot ring split into sub-waves of
    2n tickets, as the reference's: misses burn their tickets and the
    states agree."""
    _same(f"over/{engine}/", s)


@pytest.mark.parametrize("width", (None, SH_N))
@pytest.mark.parametrize("s", SHARDS)
def test_sharded_rounds_bit_exact(s, width):
    """The sharded rings' publish (round-robin spray, whole-round
    overflow across rings, ``pop_meta``) and load-aware claim, sparse
    and dense-wave, equal to the reference's."""
    _same(f"sh/{width}/", s)


@pytest.mark.parametrize("width", (None, PRI_W - 2))
@pytest.mark.parametrize("opts", PRI_OPTS)
@pytest.mark.parametrize("s", SHARDS)
def test_priority_publish_bit_exact(s, opts, width):
    """The priority round's exchange: the gathered child planes (keys,
    payloads, the split layout's aux), active lanes, ranks, total, the
    hints and sizes meta words and, with telemetry, the popped-key
    extrema, equal to the reference's, sparse and compact (rows past the
    width keep their true counts)."""
    _same(f"pri/{opts}/{width}/", s)


def test_dist_heap_init():
    """One heap or S stacked, capacity rounded up to a power of two,
    empty slots KEY_INF / -1, as the reference's ``dist_heap_init``."""
    from repro.core.distqueue import dist_heap_init as jinit
    want = jinit(100)
    got = tcore.dist_heap_init(100, device="cpu")
    for a, b in zip(got, want):
        assert np.array_equal(_np(a), np.asarray(b))
    st = tcore.dist_heap_init(100, shards=4, device="cpu")
    assert st.keys.shape == (4, 128) and st.size.tolist() == [0] * 4
    assert bool((st.keys[1] == _np(want.keys)[0]).all())


@pytest.mark.parametrize("s", SHARDS)
def test_all_inactive_round_leaves_the_state(s):
    """Round 2 of the scenario asks for nothing: the enqueue and dequeue
    leave planes and tickets as they were, grant nothing and return no
    value."""
    _, port = _results(s)
    key = "rep/planes/None/2"
    before = port["rep/planes/None/1/claim/planes"]
    assert port[f"{key}/enq/planes"] == before
    assert port[f"{key}/deq/planes"] == before
    assert not any(port[f"{key}/enq/g"]) and not any(port[f"{key}/deq/ok"])
    assert port[f"{key}/deq/ht"] == port["rep/planes/None/1/claim/ht"]


@pytest.mark.parametrize("k,n,batch", [(0, 4, 8), (5, 1, 8), (5, 4, 8),
                                       (32, 4, 8), (40, 4, 8), (7, 3, 2)])
def test_claim_schedule_balanced(k, n, batch):
    """The even split with the remainder to the lowest shards, capped at
    ``n * batch``, equal to the reference's."""
    from repro.core.distqueue import claim_schedule as jcs
    ja, jr = jcs(jnp.int32(k), n, batch)
    ta, tr = tcore.claim_schedule(k, n, batch, device="cpu")
    assert np.array_equal(_np(ta), np.asarray(ja))
    assert np.array_equal(_np(tr), np.asarray(jr))
    per = _np(ta).reshape(n, batch).sum(1)
    assert per.sum() == min(k, n * batch) and per.max() - per.min() <= 1


@pytest.mark.parametrize("seed", range(4))
def test_priority_claim_schedule(seed):
    """The hint-ordered schedule (ties by index, shares clamped to sizes
    and batch) equal to the reference's on random hints and sizes."""
    from repro.core.distqueue import priority_claim_schedule as jpcs
    rng = np.random.default_rng(seed)
    n, batch = int(rng.integers(1, 9)), int(rng.integers(1, 6))
    sizes = rng.integers(0, 8, n).astype(np.int32)
    hints = rng.integers(-3, 3, n).astype(np.int32)
    k = int(rng.integers(0, n * batch + 4))
    want = jpcs(jnp.int32(k), n, batch, jnp.asarray(hints),
                jnp.asarray(sizes))
    got = tcore.priority_claim_schedule(k, n, batch, torch.as_tensor(hints),
                                        torch.as_tensor(sizes))
    assert np.array_equal(_np(got), np.asarray(want))


def test_collectives_on_stacked_rows():
    """``make_mesh`` names the shard count; ``mesh_ticket_base`` is the
    exclusive prefix and total of the per-shard counts, wrapping as int32;
    ``mesh_round_gather`` returns the (S, B_i) rows as int32."""
    mesh = make_mesh((4,), ("data",))
    assert mesh.shape["data"] == 4 and mesh.size == 4
    with pytest.raises(ValueError):
        make_mesh((0,), ("data",))
    base, total = mesh_ticket_base(torch.tensor([3, 0, 5, 2 ** 31 - 1],
                                                dtype=torch.int32))
    assert base.tolist() == [0, 3, 3, 8] and int(total) == -(2 ** 31) + 7
    rows = torch.arange(8, dtype=torch.int64).reshape(4, 2)
    (g,) = mesh_round_gather((rows,))
    assert g.dtype == torch.int32 and g.tolist() == rows.tolist()
    with pytest.raises(ValueError, match="rows"):
        mesh_round_gather((torch.zeros(3),))


@pytest.mark.parametrize("start", WRAP_STARTS)
def test_functional_faces_fifo_across_wraps(start):
    """``enq_planes`` / ``deq_planes`` with an explicit ``active`` move
    tickets on either side of 2^31 and 2^32: every installed value comes
    back once, in order (the sign rule would drop the tickets past
    2^31)."""
    cap = 64
    st = tcore.dist_queue_init(cap, start=_start(start, cap), device="cpu")
    planes, head, tail = list(st[:4]), int(st.head), int(st.tail)
    kw = dict(nslots_log2=7, idx_bot=tcore.IDX_BOT)

    def tickets(base, n):
        t = (base + np.arange(n, dtype=np.int64)) % 2 ** 32
        return torch.as_tensor(np.where(t >= 2 ** 31, t - 2 ** 32, t)
                               .astype(np.int32))

    sent, got = [], []
    for r in range(6):
        m = 20 + 5 * r
        v = torch.arange(100, dtype=torch.int32) + 1000 * r
        act = torch.arange(100) < m
        out = enq_planes(*planes, tickets(tail, 100), v, tickets(head, 1)[0],
                         active=act, **kw)
        planes = list(out[:4])
        sent += v[out[4].bool()].tolist()
        tail += m
        out = deq_planes(*planes, tickets(head, m - 3),
                         active=torch.ones(m - 3, dtype=torch.bool), **kw)
        planes = list(out[:4])
        got += out[4][out[5].bool()].tolist()
        head += m - 3
    assert len(sent) == sum(20 + 5 * r for r in range(6))
    assert got == sent[:len(got)] and len(got) == len(sent) - 18


if __name__ == "__main__":
    if "--worker" in sys.argv:
        print(json.dumps(_reference(int(sys.argv[sys.argv.index(
            "--worker") + 1]))))
