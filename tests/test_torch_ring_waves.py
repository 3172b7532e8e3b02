"""The ring round's wave kernels through their CPU faces
(``ring_dequeue_wave_plain`` / ``ring_enqueue_wave_plain`` and the
wrappers on CPU tensors) at one shard, the single ring's round (the
mesh's shard grids are ``test_torch_meshrounds.py``'s), held bit-exact
against the reference round's
arithmetic: the JAX package's ``deq_planes`` / ``enq_planes`` and its
plain ``wavefaa_ref``, composed as ``repro/runtime/fusedrounds.py``'s
``RingEngine._round`` composes them.  Inputs from a numpy seed; integer
state, so every comparison is exact.

The wave kernels take each lane's activity from the round's arithmetic
(``lane < k``, the ballot bit), so the reference here passes that
``active`` mask explicitly, as the JAX package's ``enq_planes`` asks of
callers whose tickets may pass 2^31; below 2^31 the reference round's
-1-sentinel tickets give the same state (checked too).

The CUDA kernels run only on the card; ``chip_smoke.py`` phase 2 holds
them against these plain versions there."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ring_slots as jring  # noqa: E402
from repro_torch.kernels import (LAUNCHES, ring_dequeue_wave,  # noqa: E402
                                 ring_dequeue_wave_plain, ring_enqueue_wave,
                                 ring_enqueue_wave_plain)

BOT = (1 << 31) - 1
NSL2 = 12                   # 4,096 slots, capacity 2,048
CAP = 1 << (NSL2 - 1)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One torch thread for this file's tests: the tier-1 run puts six
    test workers on the machine's cores, where a pool as wide as the cores
    in each only contends with the others; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def _t(a):
    return torch.from_numpy(np.array(a))


class Ring:
    """One ring state twice: numpy arrays for the reference, torch tensors
    for the port."""

    def __init__(self, start, nsl2=NSL2):
        ns = 1 << nsl2
        self.nsl2 = nsl2
        cyc0 = _i32(((start % 2 ** 32) >> nsl2) - 1)
        self.np = [np.full(ns, cyc0, np.int32), np.ones(ns, np.int32),
                   np.zeros(ns, np.int32), np.full(ns, BOT, np.int32)]
        self.head = self.tail = _i32(start)
        self.planes = [_t(p) for p in self.np]
        self.th = torch.tensor(self.head, dtype=torch.int32)
        self.tt = torch.tensor(self.tail, dtype=torch.int32)

    def same(self):
        for a, b in zip(self.planes, self.np):
            np.testing.assert_array_equal(a.numpy(), b)
        assert (int(self.th), int(self.tt)) == (self.head, self.tail)


def jax_deq(ring, batch, live, sentinel=False):
    """The reference round's dequeue side (fusedrounds.py:166-181)."""
    head, tail = jnp.int32(ring.head), jnp.int32(ring.tail)
    lane = jnp.arange(batch, dtype=jnp.int32)
    k = jnp.where(live, jnp.minimum(jnp.int32(batch), tail - head), 0)
    dtickets = jnp.where(lane < k, head + lane, -1)
    out = jring.deq_planes(*map(jnp.asarray, ring.np), dtickets,
                           nslots_log2=ring.nsl2, idx_bot=BOT,
                           active=None if sentinel else lane < k)
    ring.np = [np.asarray(p) for p in out[:4]]
    ring.head = int(head + k)
    return np.asarray(out[4]), np.asarray(out[5]).astype(bool), int(k)


def jax_enq(ring, values, live, mask=None, count=None, sentinel=False):
    """The reference round's enqueue side (fusedrounds.py:190-222): the
    ballot through the plain ``wavefaa_ref``, or the dense wave's
    contiguous tickets."""
    head, tail = jnp.int32(ring.head), jnp.int32(ring.tail)
    if mask is not None:
        cm = jnp.asarray(mask) & live
        tickets, newctr = jref.wavefaa_ref(cm.astype(jnp.int32),
                                           jnp.reshape(tail, (1,)))
        n_child = newctr[0] - tail
        active = cm
    else:
        n_child = jnp.where(live, jnp.int32(count), 0)
        lane = jnp.arange(len(values), dtype=jnp.int32)
        tickets = tail + lane
        active = lane < n_child
    over = (tail + n_child - head) > CAP
    if sentinel:
        tickets, active = jnp.where(active & ~over, tickets, -1), None
    else:
        active = active & ~over
    out = jring.enq_planes(*map(jnp.asarray, ring.np), tickets,
                           jnp.asarray(values), head, nslots_log2=ring.nsl2,
                           idx_bot=BOT, active=active)
    ring.np = [np.asarray(p) for p in out[:4]]
    ring.tail = int(jnp.where(over, tail, tail + n_child))
    return int(jnp.where(over, 0, n_child)), bool(over)


def _wave_args(values, mask, count):
    """The enqueue wave's children as one shard: ballot mode's flat values
    with their mask, or dense mode's (1, n) row with its (1,) count."""
    if mask is not None:
        return _t(values), dict(mask=_t(mask))
    return _t(values).reshape(1, -1), dict(
        counts=torch.tensor([count], dtype=torch.int32))


def deq_both(ring, batch, live, face=ring_dequeue_wave_plain):
    want = jax_deq(ring, batch, live)
    vals, ok, k, pops = face(*ring.planes, ring.th, ring.tt,
                             torch.tensor(live), batch=batch,
                             nslots_log2=ring.nsl2, idx_bot=BOT)
    assert vals.shape == ok.shape == (1, batch)      # the one shard's row
    np.testing.assert_array_equal(vals[0].numpy(), want[0])
    np.testing.assert_array_equal(ok[0].numpy(), want[1])
    assert k.dtype == torch.int32 and k.dim() == 0 and int(k) == want[2]
    assert pops.tolist() == [want[2]]
    ring.same()
    return want[2]


def enq_both(ring, values, live, mask=None, count=None,
             face=ring_enqueue_wave_plain):
    want = jax_enq(ring, values, live, mask, count)
    vals, mode = _wave_args(values, mask, count)
    total, over, pushes = face(*ring.planes, ring.th, ring.tt, vals,
                               torch.tensor(live), capacity=CAP,
                               nslots_log2=ring.nsl2, idx_bot=BOT, **mode)
    assert total.dtype == torch.int32 and over.dtype == torch.bool
    assert (int(total), bool(over)) == want
    assert pushes.tolist() == [want[0]]
    ring.same()
    return want


STARTS = [1 << NSL2, 2 ** 31 - 300, 2 ** 32 - 300]


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("batch", [1, 16, 1500])
def test_dequeue_wave_matches_reference(start, batch):
    """k = 0 on the empty ring, then k = 1, k below the batch and k =
    batch as the ring fills; a live=False call moves nothing."""
    rng = np.random.default_rng(batch)
    ring = Ring(start)
    seen = set()
    for fill in (0, 1, batch // 2, batch + 7, 2 * batch):
        if fill:
            enq_both(ring, rng.integers(0, 1 << 30, fill).astype(np.int32),
                     True, count=fill)
        seen.add(deq_both(ring, batch, False))
        seen.add(deq_both(ring, batch, True))
    assert {0, 1, batch} <= seen and (batch < 3 or len(seen) >= 4)


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("mode", ["ballot", "dense"])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_enqueue_wave_matches_reference(start, mode, density):
    """Ballot waves (empty, sparse and full masks) and dense waves of
    3,000 lanes (more than the 2,048 capacity, so some overflow), live and
    not, with the ring's head moved by dequeue waves in between."""
    rng = np.random.default_rng(int(density * 10) + len(mode))
    ring = Ring(start)
    overs = 0
    for r in range(8):
        n = 3000
        values = rng.integers(0, 1 << 30, n).astype(np.int32)
        live = r % 3 != 2
        if mode == "ballot":
            mask = rng.random(n) < density
            _, over = enq_both(ring, values, live, mask=mask)
        else:
            _, over = enq_both(ring, values, live,
                               count=max(int(density * n) - r, 0))
        overs += over
        deq_both(ring, 300, True)
    assert overs == 0 if density == 0.0 else overs > 0


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("mode", ["ballot", "dense"])
def test_round_sequence_matches_reference(start, mode):
    """Rounds as the engine runs them (a dequeue wave, then the children's
    enqueue wave) over 60 rounds that wrap the ring many times: every k
    from 0 to the batch, overflowing rounds and live=False rounds."""
    rng = np.random.default_rng(7)
    ring = Ring(start)
    enq_both(ring, np.arange(100, dtype=np.int32), True, count=100)
    ks, overs, batch = set(), 0, 256
    for r in range(60):
        live = r % 7 != 6
        ks.add(deq_both(ring, batch, live))
        n = 4 * batch
        values = rng.integers(0, 1 << 30, n).astype(np.int32)
        dens = rng.choice([0.0, 0.2, 0.3, 0.6, 1.0])
        if mode == "ballot":
            _, over = enq_both(ring, values, live, mask=rng.random(n) < dens)
        else:
            _, over = enq_both(ring, values, live,
                               count=int(rng.binomial(n, dens)))
        overs += over
    assert 0 in ks and batch in ks and overs > 0
    assert any(0 < k < batch for k in ks)


@pytest.mark.parametrize("mode", ["ballot", "dense"])
def test_live_false_moves_nothing(mode):
    """A round that is not live consumes nothing, installs nothing and
    leaves head, tail and the planes as they were, whatever the step's
    children."""
    ring = Ring(2 ** 31 - 40)
    enq_both(ring, np.arange(50, dtype=np.int32), True, count=50)
    before = ([p.clone() for p in ring.planes], int(ring.th), int(ring.tt))
    assert deq_both(ring, 64, False) == 0
    values = np.arange(64, dtype=np.int32)
    if mode == "ballot":
        got = enq_both(ring, values, False, mask=np.ones(64, bool))
    else:
        got = enq_both(ring, values, False, count=64)
    assert got == (0, False)
    for a, b in zip(ring.planes, before[0]):
        assert torch.equal(a, b)
    assert (int(ring.th), int(ring.tt)) == before[1:]


@pytest.mark.parametrize("mode", ["ballot", "dense"])
def test_below_2_31_the_sentinel_round_agrees(mode):
    """Below 2^31 the reference round's own -1-sentinel tickets (active
    left to ``tickets >= 0``) give the state the waves give."""
    rng = np.random.default_rng(3)
    a, b = Ring(1 << NSL2), Ring(1 << NSL2)
    for r in range(12):
        jax_deq(a, 300, True)
        jax_deq(b, 300, True, sentinel=True)
        values = rng.integers(0, 1 << 30, 1200).astype(np.int32)
        mask = rng.random(1200) < 0.4
        kw = ({"mask": mask} if mode == "ballot"
              else {"count": int(mask.sum())})
        assert jax_enq(a, values, True, **kw) == jax_enq(
            b, values, True, sentinel=True, **kw)
        for p, q in zip(a.np, b.np):
            np.testing.assert_array_equal(p, q)
        assert (a.head, a.tail) == (b.head, b.tail)


@pytest.mark.parametrize("wave", ["dequeue", "ballot", "dense"])
def test_wrappers_take_cpu_tensors_to_the_plain_version(wave):
    ring = Ring(2 ** 32 - 100)
    enq_both(ring, np.arange(90, dtype=np.int32), True, count=90,
             face=ring_enqueue_wave)
    before = dict(LAUNCHES)
    if wave == "dequeue":
        deq_both(ring, 1200, True, face=ring_dequeue_wave)
    else:
        values = np.arange(2000, dtype=np.int32)
        mask = (np.arange(2000) % 3 == 0) if wave == "ballot" else None
        enq_both(ring, values, True, mask=mask,
                 count=None if mask is not None else 1500,
                 face=ring_enqueue_wave)
    assert dict(LAUNCHES) == before      # no kernel ran
    assert {"ring_dequeue_wave", "ring_enqueue_wave"} <= set(LAUNCHES)


def test_enqueue_wave_takes_one_mode():
    ring = Ring(1 << NSL2)
    values = torch.arange(8, dtype=torch.int32)
    args = (*ring.planes, ring.th, ring.tt, values, torch.tensor(True))
    kw = dict(capacity=CAP, nslots_log2=NSL2, idx_bot=BOT)
    for mode in ({}, {"mask": torch.ones(8, dtype=torch.bool),
                      "counts": torch.tensor([8], dtype=torch.int32)}):
        with pytest.raises(ValueError, match="not both or neither"):
            ring_enqueue_wave(*args, **kw, **mode)
    for mask in (torch.ones(9, dtype=torch.bool),
                 torch.ones(8, dtype=torch.int32)):
        with pytest.raises(ValueError, match="bool .* as wide as values"):
            ring_enqueue_wave(*args, mask=mask, **kw)



# -- birth stamps (the span layer) --------------------------------------------


def _wave(rng, ns, b, start):
    """A random TRYENQ / TRYDEQ wave of ``b`` tickets from ``start`` with
    inactive (-1) lanes."""
    t = np.array([_i32(start + i) for i in range(b)], np.int32)
    return np.where(rng.random(b) < 0.8, t, -1).astype(np.int32)


@pytest.mark.parametrize("layout", ["packed", "separate"])
def test_birth_modes_of_the_plane_faces_match_reference(layout):
    """``enq_planes(birth_round=)`` / ``deq_planes(birth_packed=True)`` and
    the separate ``births`` plane, bit for bit against the JAX package's
    over cycles of random waves, seeds installed unpacked (flag 1, birth
    0) and birth rounds 0, 1 and 2^30 - 1."""
    from repro_torch.kernels import deq_planes, enq_planes
    rng = np.random.default_rng(17)
    nsl2, b = 6, 24
    ns = 1 << nsl2
    planes = [np.zeros(ns, np.int32), np.ones(ns, np.int32),
              np.zeros(ns, np.int32), np.full(ns, BOT, np.int32)]
    births = np.zeros(ns, np.int32) if layout == "separate" else None
    head = tail = ns
    kw = dict(nslots_log2=nsl2, idx_bot=BOT)
    seed = np.arange(tail, tail + 8, dtype=np.int32)
    want = jring.enq_planes(*map(jnp.asarray, planes), jnp.asarray(seed),
                            jnp.arange(8, dtype=jnp.int32),
                            jnp.int32(head), **kw)
    got = enq_planes(*map(_t, planes), _t(seed),
                     torch.arange(8, dtype=torch.int32), head, **kw)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    planes = [np.asarray(p) for p in want[:4]]
    tail += 8
    for r, rnd in enumerate([0, 1, 5, 2 ** 30 - 1] * 4):
        t = _wave(rng, ns, b, tail)
        v = rng.integers(0, 1 << 30, b).astype(np.int32)
        extra = ({"birth_round": rnd} if births is None
                 else {"births": births, "birth_round": rnd})
        want = jring.enq_planes(
            *map(jnp.asarray, planes), jnp.asarray(t), jnp.asarray(v),
            jnp.int32(head), **kw,
            **{k: jnp.asarray(x) if k == "births" else jnp.int32(x)
               for k, x in extra.items()})
        got = enq_planes(*map(_t, planes), _t(t), _t(v), head, **kw,
                         **{k: _t(x) if k == "births" else x
                            for k, x in extra.items()})
        assert len(got) == len(want)
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))
        planes = [np.asarray(p) for p in want[:4]]
        if births is not None:
            births = np.asarray(want[5])
        tail += b
        d = _wave(rng, ns, b, head)
        extra = ({"birth_packed": True} if births is None
                 else {"births": births})
        want = jring.deq_planes(*map(jnp.asarray, planes), jnp.asarray(d),
                                **kw, **{k: jnp.asarray(x) if k == "births"
                                         else x for k, x in extra.items()})
        got = deq_planes(*map(_t, planes), _t(d), **kw,
                         **{k: _t(x) if k == "births" else x
                            for k, x in extra.items()})
        assert len(got) == len(want) == 7
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))
        planes = [np.asarray(p) for p in want[:4]]
        head += b
    if births is None:          # the packed planes hold real stamps
        assert int(planes[2].max()) > 1


def test_span_round_cap_is_refused_at_stamp_time():
    """A packed stamp at ``SPAN_ROUND_CAP`` raises the reference's
    ``ValueError``; one round under it stamps."""
    from repro_torch.kernels import enq_planes
    from repro_torch.kernels.ring_slots import SPAN_ROUND_CAP
    assert SPAN_ROUND_CAP == jring.SPAN_ROUND_CAP == 1 << 30
    planes = [np.zeros(16, np.int32), np.ones(16, np.int32),
              np.zeros(16, np.int32), np.full(16, BOT, np.int32)]
    t = np.arange(16, 20, dtype=np.int32)       # cycle 1 over cycle 0
    kw = dict(nslots_log2=4, idx_bot=BOT)
    with pytest.raises(ValueError) as want:
        jring.enq_planes(*map(jnp.asarray, planes), jnp.asarray(t),
                         jnp.asarray(t), jnp.int32(0), **kw,
                         birth_round=SPAN_ROUND_CAP)
    for rnd in (SPAN_ROUND_CAP, torch.tensor(SPAN_ROUND_CAP)):
        with pytest.raises(ValueError) as got:
            enq_planes(*map(_t, planes), _t(t), _t(t), 0, **kw,
                       birth_round=rnd)
        assert str(got.value) == str(want.value)
    out = enq_planes(*map(_t, planes), _t(t), _t(t), 0, **kw,
                     birth_round=SPAN_ROUND_CAP - 1)
    assert int(out[2][0]) == 2 ** 31 - 1       # (2^30 - 1) << 1 | 1


def jax_packed_round(ring, batch, values, live, rnd, mask=None, count=None):
    """The reference's spanned round on the ring (fusedrounds.py:166-222
    with ``sp``): the packed dequeue, then the packed enqueue of the
    children at birth round ``rnd``.  Returns the births and the
    enqueue's (total, over)."""
    head, tail = jnp.int32(ring.head), jnp.int32(ring.tail)
    lane = jnp.arange(batch, dtype=jnp.int32)
    k = jnp.where(live, jnp.minimum(jnp.int32(batch), tail - head), 0)
    out = jring.deq_planes(*map(jnp.asarray, ring.np),
                           jnp.where(lane < k, head + lane, -1),
                           nslots_log2=ring.nsl2, idx_bot=BOT,
                           active=lane < k, birth_packed=True)
    ring.np = [np.asarray(p) for p in out[:4]]
    head = head + k
    ring.head = int(head)
    if mask is not None:
        cm = jnp.asarray(mask) & live
        tickets, newctr = jref.wavefaa_ref(cm.astype(jnp.int32),
                                           jnp.reshape(tail, (1,)))
        n_child, active = newctr[0] - tail, cm
    else:
        n_child = jnp.where(live, jnp.int32(count), 0)
        lw = jnp.arange(len(values), dtype=jnp.int32)
        tickets, active = tail + lw, lw < n_child
    over = (tail + n_child - head) > CAP
    enq = jring.enq_planes(*map(jnp.asarray, ring.np), tickets,
                           jnp.asarray(values), head, nslots_log2=ring.nsl2,
                           idx_bot=BOT, active=active & ~over,
                           birth_round=jnp.int32(rnd))
    ring.np = [np.asarray(p) for p in enq[:4]]
    ring.tail = int(jnp.where(over, tail, tail + n_child))
    return (np.asarray(out[6]), np.asarray(out[4]),
            (int(jnp.where(over, 0, n_child)), bool(over)))


@pytest.mark.parametrize("mode", ["ballot", "dense"])
@pytest.mark.parametrize("face", ["plain", "wrapper"])
def test_packed_waves_match_reference_round(mode, face):
    """The packed waves (``birth_packed`` / ``birth_round``), as the
    spanned round runs them, against the reference's spanned round over
    40 rounds that wrap the ring: births, values, head/tail and the
    planes with their stamps, bit for bit; live=False rounds and
    overflowing ones; the wrappers on CPU tensors launch nothing."""
    rng = np.random.default_rng(23)
    ring = Ring(2 ** 31 - 500)
    enq_both(ring, np.arange(60, dtype=np.int32), True, count=60)
    deq = ring_dequeue_wave if face == "wrapper" else ring_dequeue_wave_plain
    enq = ring_enqueue_wave if face == "wrapper" else ring_enqueue_wave_plain
    before = dict(LAUNCHES)
    batch, overs, stamped = 128, 0, 0
    clock = torch.tensor(0, dtype=torch.int32)
    for r in range(40):
        live = r % 9 != 8
        n = 4 * batch
        values = rng.integers(0, 1 << 30, n).astype(np.int32)
        dens = rng.choice([0.0, 0.3, 0.6, 1.0])
        mask = rng.random(n) < dens
        kw = ({"mask": mask} if mode == "ballot"
              else {"count": int(mask.sum())})
        births, vals, want = jax_packed_round(ring, batch, values, live, r,
                                              **kw)
        got = deq(*ring.planes, ring.th, ring.tt, torch.tensor(live),
                  batch=batch, nslots_log2=ring.nsl2, idx_bot=BOT,
                  birth_packed=True)
        assert len(got) == 5
        np.testing.assert_array_equal(got[0][0].numpy(), vals)
        np.testing.assert_array_equal(got[4][0].numpy(), births)
        clock.fill_(r)
        wv, wmode = _wave_args(values, kw.get("mask"), kw.get("count"))
        total, over, _ = enq(
            *ring.planes, ring.th, ring.tt, wv, torch.tensor(live),
            capacity=CAP, nslots_log2=ring.nsl2, idx_bot=BOT,
            birth_round=clock, **wmode)
        assert (int(total), bool(over)) == want
        ring.same()
        overs += want[1]
        stamped += int((births > 0).sum())
    assert overs > 0 and stamped > 0
    assert dict(LAUNCHES) == before
