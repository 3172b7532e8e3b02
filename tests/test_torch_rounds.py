"""The port's round engine (``repro_torch.runtime``) on the CPU, held
bit-exact against the JAX reference engine: the ``fifo_fanout`` golden
digests (``host_syncs`` included), live reference runs, fused vs legacy,
the ``sync_every`` heartbeat and its readback log at every
``sync_every``, chunks that stop at quiescence, the overflow and
truncation errors word for word, compaction on vs off, and state carried
across with ``repro_torch.interop``."""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.kernels import ring_slots as jring  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import ring_enqueue  # noqa: E402
from repro_torch.runtime import (ENGINE_REGISTRY, IDX_BOT,  # noqa: E402
                                 PlaneRegistry, RingEngine, RoundRunner)
from repro_torch.runtime.enginecore import _sds  # noqa: E402

STATS = ("rounds", "processed", "spawned", "max_occupancy", "drained")
# GOLDEN["fifo_fanout"] of tests/test_enginecore.py; its last stat,
# host_syncs, is the fused engine's (the legacy loop reads back per wave)
GOLDEN = {"stats": [7, 63, 62, 32, 1], "acc": "b8d77df0675e0603",
          "planes": "1a0afe86d6513a2a", "head_tail": [575, 575],
          "host_syncs": 1}


def _digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()[:16]


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tree_step(acc, vals, valid):
    """Torch twin of the reference tests' ``_tree_step``."""
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


def _stats(st):
    return [int(st[k]) for k in STATS]


def _run(step, fused=True, **kw):
    r = RoundRunner(step, capacity_log2=8, batch=16, fused=fused,
                    device="cpu", **kw)
    acc, st = r.run([1], acc=torch.zeros(80, dtype=torch.int32))
    return r, acc, st


def _jax_run(**kw):
    r = jrt.RoundRunner(jax_tree_step, capacity_log2=8, batch=16, **kw)
    acc, st = r.run([1], acc=jnp.zeros(80, jnp.int32))
    return r, acc, st


@pytest.mark.parametrize("fused", [True, False])
def test_fifo_fanout_matches_golden_and_reference(fused):
    r, acc, st = _run(tree_step, fused=fused)
    assert _stats(r.stats) == GOLDEN["stats"]
    assert _digest(_np(acc)) == GOLDEN["acc"]
    assert _digest(*map(_np, st[:4])) == GOLDEN["planes"]
    assert [st.head, st.tail] == GOLDEN["head_tail"]
    assert r.stats["fused"] == int(fused)
    jr, jacc, jst = _jax_run(fused=fused)
    assert _stats(r.stats) == _stats(jr.stats)
    assert r.stats["host_syncs"] == jr.stats["host_syncs"]
    if fused:
        assert r.stats["host_syncs"] == GOLDEN["host_syncs"]
        assert ([(p.rounds, p.occupancy) for p in r.sync_log]
                == [(p.rounds, p.occupancy) for p in jr.sync_log]
                == [(7, 0)])
    np.testing.assert_array_equal(_np(acc), np.asarray(jacc))
    for a, b in zip(st[:4], jst[:4]):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert (st.head, st.tail) == (int(jst.head), int(jst.tail))


def test_fused_matches_legacy():
    (rf, af, sf), (rl, al, sl) = _run(tree_step), _run(tree_step, False)
    np.testing.assert_array_equal(_np(af), _np(al))
    for a, b in zip(sf, sl):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert _stats(rf.stats) == _stats(rl.stats)
    # the fused engine reads back per chunk, the legacy one per wave
    assert (rf.stats["host_syncs"] < rf.stats["rounds"]
            < rl.stats["host_syncs"])


def test_sync_every_log_matches_reference():
    r, acc, _ = _run(tree_step, sync_every=2)
    jr, jacc, _ = _jax_run(sync_every=2)
    np.testing.assert_array_equal(_np(acc), np.asarray(jacc))
    assert ([(p.rounds, p.occupancy) for p in r.sync_log]
            == [(p.rounds, p.occupancy) for p in jr.sync_log])
    assert r.stats["host_syncs"] == jr.stats["host_syncs"] == 4
    assert r.sync_log[-1]["occupancy"] == 0


@pytest.mark.parametrize("sync_every", [0, 1, 3])
def test_sync_log_matches_reference_at_every_sync_every(sync_every):
    """A chunk is ``sync_every`` rounds (the whole run at 0) that stops at
    quiescence: the readbacks, their log and the stats are the
    reference's."""
    r, acc, _ = _run(tree_step, sync_every=sync_every)
    jr, jacc, _ = _jax_run(sync_every=sync_every)
    np.testing.assert_array_equal(_np(acc), np.asarray(jacc))
    assert ([(p.rounds, p.occupancy, p.host_syncs) for p in r.sync_log]
            == [(p.rounds, p.occupancy, p.host_syncs) for p in jr.sync_log])
    assert r.stats == {k: int(v) for k, v in jr.stats.items()}
    assert r.stats["host_syncs"] == {0: 1, 1: 7, 3: 3}[sync_every]


def test_predicated_rounds_are_noops_past_quiescence():
    """A chunk longer than the run needs stops at quiescence and leaves
    the state exactly as the run left it, even with a step that is not a
    no-op on an empty wave: it bumps acc every call and spawns from every
    lane of an empty wave.  One 40-round chunk (33 rounds longer than
    the run) equals one-round chunks and the reference's
    ``while_loop``."""
    def noisy(acc, vals, valid):
        acc, cv, cm = tree_step(acc, vals, valid)
        return acc + 1, cv, cm | ~valid.any()

    def jax_noisy(acc, vals, valid):
        acc, cv, cm = jax_tree_step(acc, vals, valid)
        return acc + 1, cv, cm | ~valid.any()

    (r1, a1, s1), (r40, a40, s40) = (_run(noisy, sync_every=k)
                                     for k in (1, 40))
    jr = jrt.RoundRunner(jax_noisy, capacity_log2=8, batch=16)
    jacc, jst = jr.run([1], acc=jnp.zeros(80, jnp.int32))
    assert r40.stats["host_syncs"] == 1 and r1.stats["host_syncs"] == 7
    for acc, st, r in ((a1, s1, r1), (a40, s40, r40)):
        np.testing.assert_array_equal(_np(acc), np.asarray(jacc))
        for a, b in zip(st[:4], jst[:4]):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        assert (st.head, st.tail) == (int(jst.head), int(jst.tail))
        assert _stats(r.stats) == _stats(jr.stats) == GOLDEN["stats"]


def _errors(jstep, step, initial, acc, jacc, **kw):
    """Run the reference and the port on the same failing workload; return
    both error messages and stats."""
    out = []
    for mk, s, a in ((jrt.RoundRunner, jstep, jacc),
                     (RoundRunner, step, acc)):
        extra = {} if mk is jrt.RoundRunner else {"device": "cpu"}
        r = mk(s, capacity_log2=kw["capacity_log2"], batch=8,
               fused=kw["fused"], **extra)
        with pytest.raises(RuntimeError) as exc:
            r.run(initial, acc=a, max_rounds=kw.get("max_rounds", 100))
        out.append((str(exc.value), {k: r.stats.get(k) for k in STATS}))
    return out


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", ["overflow", "seed", "truncation"])
def test_errors_match_reference_wording(case, fused):
    if case == "overflow":
        got = _errors(jax_explode_step, explode_step, np.arange(8),
                      torch.tensor(0, dtype=torch.int32), jnp.int32(0),
                      capacity_log2=4, fused=fused)
        match = "ring overflow"
    elif case == "seed":
        got = _errors(jax_tree_step, tree_step, np.arange(64),
                      torch.zeros(80, dtype=torch.int32),
                      jnp.zeros(80, jnp.int32), capacity_log2=4, fused=fused)
        match = "ring overflow"
    else:
        got = _errors(jax_immortal_step, immortal_step, [1, 2, 3],
                      torch.tensor(0, dtype=torch.int32), jnp.int32(0),
                      capacity_log2=6, fused=fused, max_rounds=5)
        match = "not quiescent"
        assert got[1][1]["rounds"] == 5 and got[1][1]["drained"] == 0
    (jmsg, jstats), (msg, stats) = got
    assert match in msg
    assert msg == jmsg
    assert stats == jstats


@pytest.mark.parametrize("mode", [True, None])
def test_compact_matches_uncompacted(mode):
    r0, a0, s0 = _run(tree_step, compact=False)
    r1, a1, s1 = _run(tree_step, compact=mode)
    np.testing.assert_array_equal(_np(a0), _np(a1))
    for a, b in zip(s0, s1):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert _stats(r0.stats) == _stats(r1.stats)


def test_interop_round_trips_a_reference_ring():
    jr, _, jst = _jax_run()
    arrays = [np.asarray(p) for p in jst[:4]]
    st = interop.ring_state_from_numpy(*arrays, jst.head, jst.tail,
                                       device="cpu")
    back = interop.ring_state_to_numpy(st)
    for a, b in zip(back[:4], arrays):
        np.testing.assert_array_equal(a, b)
    assert back[4:] == (int(jst.head), int(jst.tail))
    # both packages driven from the carried state agree
    nsl2 = arrays[0].shape[0].bit_length() - 1
    t = np.arange(jst.tail, jst.tail + 8, dtype=np.int32)
    v = np.arange(8, dtype=np.int32)
    want = jring.ring_enqueue(*map(jnp.asarray, arrays), jnp.asarray(t),
                              jnp.asarray(v),
                              jnp.asarray([jst.head], jnp.int32),
                              nslots_log2=nsl2, idx_bot=IDX_BOT)
    got = ring_enqueue(*st[:4], torch.from_numpy(t), torch.from_numpy(v),
                       st.head, nslots_log2=nsl2, idx_bot=IDX_BOT)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_registries():
    assert ENGINE_REGISTRY["rounds"].runner is RoundRunner
    reg = PlaneRegistry()
    reg.register("ring", (_sds((1024,)),) * 4, sharded=True)
    reg.register("tickets", (_sds((4,)),) * 2)
    assert reg.bytes_per_shard(1) == 4 * 1024 * 4 + 2 * 4 * 4
    assert reg.bytes_per_shard(4) == 4 * 256 * 4 + 2 * 4 * 4
    e = RingEngine(tree_step, capacity_log2=8, batch=16, device="cpu")
    je = jrt.RingEngine(jax_tree_step, capacity_log2=8, batch=16)
    assert e.loop_carry_bytes() == je.loop_carry_bytes() == 4 * 512 * 4 + 8


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
            RoundRunner(tree_step, device="cpu", fused=False,
                  **{kw: getattr(obs, name)()})
        with pytest.raises(ValueError, match=what) as want:
            jrt.RoundRunner(tree_step, fused=False,
                  **{kw: getattr(jobs, name)()})
        assert str(got.value) == str(want.value)
