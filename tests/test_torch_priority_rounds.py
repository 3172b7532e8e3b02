"""The port's priority round engine (``PriorityRoundRunner`` over
``HeapEngine``) on the CPU, held bit-exact against the JAX reference: the
``heap_sssp`` golden digests side by side with the reference runner,
fused vs legacy, the heap-overflow, seed-overflow and truncation errors
word for word, compaction on vs off, exactly-once and min-key pop order,
chunks that stop at quiescence, the readback log at every
``sync_every``, and heap state carried across with
``repro_torch.interop``."""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.kernels import heap_batch as jheap  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import heap_apply  # noqa: E402
from repro_torch.runtime import (ENGINE_REGISTRY, HeapEngine,  # noqa: E402
                                 PriorityRoundRunner)

STATS = ("rounds", "processed", "spawned", "max_occupancy", "drained")
# GOLDEN["heap_sssp"] of tests/test_enginecore.py; its last stat,
# host_syncs, is the fused engine's (the legacy loop reads back per wave)
GOLDEN = {"stats": [10, 124, 122, 46, 1], "acc": "17210d10068cbe8b",
          "planes": "3e13f886f2e96c70", "size": 0, "host_syncs": 1}


def _digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()[:16]


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stats(st):
    return [int(st[k]) for k in STATS]


def golden_step(acc, keys, vals, valid):
    """Torch twin of ``_pri_step`` in ``tests/test_enginecore.py``."""
    acc = acc.index_add(0, torch.where(valid, vals % 97, 0), valid.int())
    ck = torch.stack([keys + 3, keys + 7], -1).int()
    cv = torch.stack([vals * 2 + 1, vals * 2 + 2], -1).int()
    return acc, ck, cv, (valid & (keys < 24))[:, None]


def jax_golden_step(acc, keys, vals, valid):
    acc = acc.at[jnp.where(valid, vals % 97, 0)].add(valid.astype(jnp.int32))
    ck = jnp.stack([keys + 3, keys + 7], -1).astype(jnp.int32)
    cv = jnp.stack([vals * 2 + 1, vals * 2 + 2], -1).astype(jnp.int32)
    return acc, ck, cv, (valid & (keys < 24))[:, None]


def tree_step(acc, keys, vals, valid):
    """Torch twin of ``_pri_step`` in ``tests/test_fusedrounds.py``."""
    acc = acc.index_add(0, torch.where(valid, vals, 0), valid.int())
    ck = torch.stack([keys + 1, keys + 2], -1).int()
    cv = torch.stack([vals * 2, vals * 2 + 1], -1).int()
    return acc, ck, cv, (valid & (vals < 32))[:, None]


def compact_step(acc, keys, vals, valid):
    """Torch twin of ``_pri_step`` in ``tests/test_compact.py``."""
    acc = acc.index_add(0, torch.where(valid, vals, 0), valid.int())
    cv = torch.stack([vals * 2, vals * 2 + 1], -1).int()
    return acc, (cv * 7919) % 1000, cv, (valid & (vals < 32))[:, None]


def jax_compact_step(acc, keys, vals, valid):
    acc = acc.at[jnp.where(valid, vals, 0)].add(valid.astype(jnp.int32))
    cv = jnp.stack([vals * 2, vals * 2 + 1], -1).astype(jnp.int32)
    ck = (cv * 7919) % 1000
    return acc, ck, cv, (valid & (vals < 32))[:, None]


def explode_step(acc, keys, vals, valid):
    ck = keys[:, None].expand(-1, 4) + 1
    cv = vals[:, None].expand(-1, 4) + 1
    return acc, ck.int(), cv.int(), valid[:, None].expand(-1, 4)


def jax_explode_step(acc, keys, vals, valid):
    ck = jnp.broadcast_to(keys[:, None], (keys.shape[0], 4)) + 1
    cv = jnp.broadcast_to(vals[:, None], ck.shape) + 1
    cm = jnp.broadcast_to(valid[:, None], ck.shape)
    return acc, ck.astype(jnp.int32), cv.astype(jnp.int32), cm


def immortal_step(acc, keys, vals, valid):
    return acc, keys[:, None], vals[:, None], valid[:, None]


def jax_immortal_step(acc, keys, vals, valid):
    return acc, keys[:, None], vals[:, None], valid[:, None]


def _golden_run(fused, **kw):
    r = PriorityRoundRunner(golden_step, capacity_log2=9, batch=16,
                            fused=fused, device="cpu", **kw)
    acc, st = r.run([5, 1], [1, 2], acc=torch.zeros(97, dtype=torch.int32))
    return r, acc, st


@pytest.mark.parametrize("fused", [True, False])
def test_heap_sssp_matches_golden_and_reference(fused):
    r, acc, st = _golden_run(fused)
    assert _stats(r.stats) == GOLDEN["stats"]
    assert _digest(_np(acc)) == GOLDEN["acc"]
    assert _digest(_np(st.keys), _np(st.vals)) == GOLDEN["planes"]
    assert st.size == GOLDEN["size"] and isinstance(st.size, int)
    assert r.stats["fused"] == int(fused)
    jr = jrt.PriorityRoundRunner(jax_golden_step, capacity_log2=9,
                                 batch=16, fused=fused)
    jacc, jst = jr.run([5, 1], [1, 2], acc=jnp.zeros(97, jnp.int32))
    assert _stats(r.stats) == _stats(jr.stats)
    assert r.stats["host_syncs"] == jr.stats["host_syncs"]
    if fused:
        assert r.stats["host_syncs"] == GOLDEN["host_syncs"]
        assert ([(p.rounds, p.occupancy) for p in r.sync_log]
                == [(p.rounds, p.occupancy) for p in jr.sync_log]
                == [(10, 0)])
    np.testing.assert_array_equal(_np(acc), np.asarray(jacc))
    np.testing.assert_array_equal(_np(st.keys), np.asarray(jst.keys))
    np.testing.assert_array_equal(_np(st.vals), np.asarray(jst.vals))
    assert st.size == int(jst.size)


@pytest.mark.parametrize("sync_every", [0, 1, 3])
def test_sync_log_matches_reference_at_every_sync_every(sync_every):
    """A chunk is ``sync_every`` rounds (the whole run at 0) that stops at
    quiescence: the readbacks, their log and the stats are the
    reference's."""
    r, acc, _ = _golden_run(True, sync_every=sync_every)
    jr = jrt.PriorityRoundRunner(jax_golden_step, capacity_log2=9,
                                 batch=16, sync_every=sync_every)
    jacc, _ = jr.run([5, 1], [1, 2], acc=jnp.zeros(97, jnp.int32))
    np.testing.assert_array_equal(_np(acc), np.asarray(jacc))
    assert ([(p.rounds, p.occupancy, p.host_syncs) for p in r.sync_log]
            == [(p.rounds, p.occupancy, p.host_syncs) for p in jr.sync_log])
    assert r.stats == {k: int(v) for k, v in jr.stats.items()}
    assert r.stats["host_syncs"] == {0: 1, 1: 10, 3: 4}[sync_every]


def test_fused_matches_legacy():
    """``tests/test_fusedrounds.py:117``'s workload, on the port."""
    out = []
    for fused in (True, False):
        r = PriorityRoundRunner(tree_step, capacity_log2=8, batch=16,
                                fused=fused, device="cpu")
        acc, st = r.run([5], [1], acc=torch.zeros(80, dtype=torch.int32))
        out.append((r, acc, st))
    (rf, af, sf), (rl, al, sl) = out
    np.testing.assert_array_equal(_np(af), _np(al))
    np.testing.assert_array_equal(_np(sf.keys), _np(sl.keys))
    np.testing.assert_array_equal(_np(sf.vals), _np(sl.vals))
    assert sf.size == sl.size
    assert _stats(rf.stats) == _stats(rl.stats)
    assert (rf.stats["host_syncs"] < rf.stats["rounds"]
            < rl.stats["host_syncs"])


def _errors(jstep, step, keys, vals, acc, jacc, **kw):
    """Run the reference and the port on the same failing workload; return
    both error messages and stats."""
    out = []
    for mk, s, a in ((jrt.PriorityRoundRunner, jstep, jacc),
                     (PriorityRoundRunner, step, acc)):
        extra = ({} if mk is jrt.PriorityRoundRunner
                 else {"device": "cpu"})
        r = mk(s, capacity_log2=kw["capacity_log2"], batch=8,
               fused=kw["fused"], **extra)
        with pytest.raises(RuntimeError) as exc:
            r.run(keys, vals, acc=a, max_rounds=kw.get("max_rounds", 100))
        out.append((str(exc.value), {k: r.stats.get(k) for k in STATS}))
    return out


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", ["overflow", "seed", "truncation"])
def test_errors_match_reference_wording(case, fused):
    zero, jzero = torch.tensor(0, dtype=torch.int32), jnp.int32(0)
    if case == "overflow":
        got = _errors(jax_explode_step, explode_step, np.arange(8),
                      np.arange(8), zero, jzero, capacity_log2=4,
                      fused=fused)
        match = "heap overflow"
    elif case == "seed":
        got = _errors(jax_immortal_step, immortal_step, np.arange(64),
                      np.arange(64), zero, jzero, capacity_log2=4,
                      fused=fused)
        match = "heap overflow"
    else:
        got = _errors(jax_immortal_step, immortal_step, [1, 2], [1, 2],
                      zero, jzero, capacity_log2=6, fused=fused,
                      max_rounds=5)
        match = "not quiescent"
        assert got[1][1]["rounds"] == 5 and got[1][1]["drained"] == 0
    (jmsg, jstats), (msg, stats) = got
    assert match in msg
    assert msg == jmsg
    assert stats == jstats


@pytest.mark.parametrize("mode", [True, None])
def test_compact_matches_uncompacted(mode):
    """``tests/test_compact.py:146`` on the port: the dense wave installs
    the same children in the same order, so nothing differs; and the
    reference agrees."""
    out = []
    for compact in (False, mode):
        r = PriorityRoundRunner(compact_step, capacity_log2=8, batch=16,
                                compact=compact, device="cpu")
        acc, st = r.run([7919 % 1000], [1],
                        acc=torch.zeros(80, dtype=torch.int32))
        out.append((_np(acc), _stats(r.stats), _np(st.keys), _np(st.vals)))
    jr = jrt.PriorityRoundRunner(jax_compact_step, capacity_log2=8, batch=16,
                                 compact=True)
    jacc, jst = jr.run([7919 % 1000], [1], acc=jnp.zeros(80, jnp.int32))
    want = (np.asarray(jacc), _stats(jr.stats), np.asarray(jst.keys),
            np.asarray(jst.vals))
    for got in out:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_compaction_engages_on_wide_child_waves(monkeypatch):
    from repro_torch.runtime import fusedrounds
    widths = []
    real = fusedrounds.wave_compact

    def counting(*a, **kw):
        widths.append(kw["width"])
        return real(*a, **kw)

    monkeypatch.setattr(fusedrounds, "wave_compact", counting)
    e = HeapEngine(explode_step, capacity_log2=4, batch=8, device="cpu")
    with pytest.raises(RuntimeError, match="heap overflow"):
        e.run(np.arange(8), np.arange(8), acc=torch.tensor(0))
    assert widths and set(widths) == {16}        # 8 x 4 lanes > 16 slots


def test_exactly_once_and_deterministic():
    """``tests/test_sched.py:265`` on the port."""
    def step(acc, keys, vals, valid):
        acc = acc.index_add(0, torch.where(valid, vals, 0), valid.int())
        ck = torch.stack([keys + 1, keys + 1], -1).int()
        cv = torch.stack([vals * 2, vals * 2 + 1], -1).int()
        return acc, ck, cv, (valid & (vals < 8))[:, None]

    runs = []
    for _ in range(2):
        r = PriorityRoundRunner(step, capacity_log2=8, batch=16,
                                device="cpu")
        acc, st = r.run([5], [1], acc=torch.zeros(64, dtype=torch.int32))
        runs.append((r, _np(acc), st))
    (r1, counts, st1), (r2, counts2, st2) = runs
    assert counts[1:16].tolist() == [1] * 15      # exactly once
    assert counts[0] == 0 and counts[16:].sum() == 0
    assert r1.stats["drained"] == 1 and r1.stats["processed"] == 15
    np.testing.assert_array_equal(counts, counts2)
    np.testing.assert_array_equal(_np(st1.keys), _np(st2.keys))
    assert st1.size == st2.size and r1.stats == r2.stats


@pytest.mark.parametrize("fused", [True, False])
def test_pops_in_key_order(fused):
    """``tests/test_sched.py:290`` on the port: every key comes out, in
    ascending order across rounds."""
    def step(acc, keys, vals, valid):
        buf, n = acc
        pos = torch.where(valid, n + torch.cumsum(valid.int(), 0) - 1,
                          buf.shape[0] - 1)        # invalid -> trash slot
        buf = buf.clone()
        buf[pos[valid].long()] = keys[valid]
        z = torch.zeros_like(keys)[:, None]
        return (buf, n + valid.sum(dtype=torch.int32)), z, z, z.bool()

    runner = PriorityRoundRunner(step, capacity_log2=6, batch=8,
                                 fused=fused, device="cpu")
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 100, 24).astype(np.int32)
    (buf, n), _ = runner.run(keys, np.arange(24),
                             acc=(torch.zeros(25, dtype=torch.int32),
                                  torch.tensor(0, dtype=torch.int32)))
    assert int(n) == 24
    np.testing.assert_array_equal(_np(buf)[:24], np.sort(keys))


def test_predicated_rounds_are_noops_past_quiescence():
    """A chunk longer than the run needs stops at quiescence and leaves
    the state exactly as the run left it, even with a step that bumps acc
    on every call and spawns from every lane of an empty wave.  One
    40-round chunk (30 rounds longer than the run) equals one-round
    chunks and the reference."""
    def noisy(acc, keys, vals, valid):
        acc, ck, cv, cm = golden_step(acc, keys, vals, valid)
        return acc + 1, ck, cv, cm | ~valid.any()

    def jax_noisy(acc, keys, vals, valid):
        acc, ck, cv, cm = jax_golden_step(acc, keys, vals, valid)
        return acc + 1, ck, cv, cm | ~valid.any()

    out = []
    for k in (1, 40):
        r = PriorityRoundRunner(noisy, capacity_log2=9, batch=16,
                                sync_every=k, device="cpu")
        acc, st = r.run([5, 1], [1, 2],
                        acc=torch.zeros(97, dtype=torch.int32))
        out.append((r, acc, st))
    jr = jrt.PriorityRoundRunner(jax_noisy, capacity_log2=9, batch=16)
    jacc, jst = jr.run([5, 1], [1, 2], acc=jnp.zeros(97, jnp.int32))
    assert out[0][0].stats["host_syncs"] == 10
    assert out[1][0].stats["host_syncs"] == 1
    for r, acc, st in out:
        np.testing.assert_array_equal(_np(acc), np.asarray(jacc))
        np.testing.assert_array_equal(_np(st.keys), np.asarray(jst.keys))
        np.testing.assert_array_equal(_np(st.vals), np.asarray(jst.vals))
        assert _stats(r.stats) == _stats(jr.stats) == GOLDEN["stats"]


def test_interop_round_trips_a_reference_heap():
    rng = np.random.default_rng(9)
    jk, jv, jsize, *_ = jheap.heap_apply(
        jnp.full(512, jheap.KEY_INF, jnp.int32), jnp.full(512, -1, jnp.int32),
        jnp.int32(0), jnp.zeros(40, jnp.int32),
        jnp.asarray(rng.integers(0, 37, 40).astype(np.int32)),
        jnp.arange(40, dtype=jnp.int32), cap_log2=9)
    arrays = (np.asarray(jk), np.asarray(jv), int(jsize))
    st = interop.heap_state_from_numpy(*arrays, device="cpu")
    back = interop.heap_state_to_numpy(st)
    for a, b in zip(back[:2], arrays[:2]):
        np.testing.assert_array_equal(a, b)
    assert back[2] == arrays[2] == 40
    # both packages driven from the carried state agree
    ops = np.array([1] * 10 + [0] * 6, np.int32)
    ks = np.arange(16, dtype=np.int32) * 3 % 11
    vs = np.arange(16, dtype=np.int32) + 1000
    want = jheap.heap_apply(jk, jv, jsize, *map(jnp.asarray, (ops, ks, vs)),
                            cap_log2=9)
    got = heap_apply(st.keys, st.vals, st.size,
                     *map(torch.from_numpy, (ops, ks, vs)), cap_log2=9)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_registries():
    assert ENGINE_REGISTRY["prounds"].runner is PriorityRoundRunner
    assert ENGINE_REGISTRY["prounds"].priority
    e = HeapEngine(tree_step, capacity_log2=8, batch=16, device="cpu")
    je = jrt.HeapEngine(tree_step, capacity_log2=8, batch=16)
    assert e.loop_carry_bytes() == je.loop_carry_bytes() == 2 * 256 * 4 + 4
    with pytest.raises(ValueError, match="exceeds heap capacity"):
        HeapEngine(tree_step, capacity_log2=3, batch=16, device="cpu")


def test_obs_planes_wait_for_their_slice():
    """Trace and span planes are in-round state: the legacy loop refuses
    them with the reference's ``ValueError`` (the fused engine takes
    them: ``tests/test_torch_obs.py``)."""
    from repro import obs as jobs
    from repro_torch import obs
    for kw, what in (("telemetry", "telemetry needs"),
                     ("spans", "spans needs")):
        name = "Telemetry" if kw == "telemetry" else "Spans"
        with pytest.raises(ValueError, match=what) as got:
            PriorityRoundRunner(tree_step, device="cpu", fused=False,
                  **{kw: getattr(obs, name)()})
        with pytest.raises(ValueError, match=what) as want:
            jrt.PriorityRoundRunner(tree_step, fused=False,
                  **{kw: getattr(jobs, name)()})
        assert str(got.value) == str(want.value)
