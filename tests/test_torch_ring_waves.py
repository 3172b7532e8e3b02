"""The ring round's wave kernels through their CPU faces
(``ring_dequeue_wave_plain`` / ``ring_enqueue_wave_plain`` and the
wrappers on CPU tensors), held bit-exact against the reference round's
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


def deq_both(ring, batch, live, face=ring_dequeue_wave_plain):
    want = jax_deq(ring, batch, live)
    vals, ok, k = face(*ring.planes, ring.th, ring.tt, torch.tensor(live),
                       batch=batch, nslots_log2=ring.nsl2, idx_bot=BOT)
    np.testing.assert_array_equal(vals.numpy(), want[0])
    np.testing.assert_array_equal(ok.numpy(), want[1])
    assert k.dtype == torch.int32 and k.dim() == 0 and int(k) == want[2]
    ring.same()
    return want[2]


def enq_both(ring, values, live, mask=None, count=None,
             face=ring_enqueue_wave_plain):
    want = jax_enq(ring, values, live, mask, count)
    total, over = face(*ring.planes, ring.th, ring.tt, _t(values),
                       torch.tensor(live), capacity=CAP,
                       nslots_log2=ring.nsl2, idx_bot=BOT,
                       mask=None if mask is None else _t(mask),
                       count=None if count is None
                       else torch.tensor(count, dtype=torch.int32))
    assert total.dtype == torch.int32 and over.dtype == torch.bool
    assert (int(total), bool(over)) == want
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
                      "count": torch.tensor(8, dtype=torch.int32)}):
        with pytest.raises(ValueError, match="not both or neither"):
            ring_enqueue_wave(*args, **kw, **mode)
    for mask in (torch.ones(9, dtype=torch.bool),
                 torch.ones(8, dtype=torch.int32)):
        with pytest.raises(ValueError, match="bool .* as wide as values"):
            ring_enqueue_wave(*args, mask=mask, **kw)

