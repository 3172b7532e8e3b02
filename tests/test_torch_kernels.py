"""The port's kernels, through their CPU faces, held bit-exact against the
JAX reference: ``wavefaa``, the ring waves and ``wave_compact`` against
the Pallas wrappers (interpret mode, as the reference's own tests run
them), the pure-jnp twins and the sequential oracles in
``repro.kernels.ref``.  Integer state, so every comparison is exact.

The CUDA kernels themselves run only on the card; ``chip_smoke.py``
holds them against these plain versions there."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import compact as jcompact  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ring_slots as jring  # noqa: E402
from repro.kernels.wavefaa import wavefaa as jwavefaa  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import (compact_planes, compact_scratch,  # noqa: E402
                                 compact_width, deq_planes, enq_planes, ref, ring_dequeue,
                                 ring_enqueue, wave_compact, wavefaa,
                                 wavefaa_scratch)

BOT = (1 << 31) - 1


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def _same(torch_out, jax_out):
    assert len(torch_out) == len(jax_out)
    for a, b in zip(torch_out, jax_out):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      np.asarray(b).astype(np.int64))


# -- wavefaa -------------------------------------------------------------------


@pytest.mark.parametrize("n", [1024, 2048, 4096])
@pytest.mark.parametrize("density", [0.0, 0.37, 1.0])
@pytest.mark.parametrize("start", [17, 2 ** 31 - 5, 2 ** 32 - 5])
def test_wavefaa_matches_reference(n, density, start):
    rng = np.random.default_rng(n)
    a = (rng.random(n) < density).astype(np.int32)
    c = np.array([_i32(start)], np.int32)
    want = jwavefaa(jnp.asarray(a), jnp.asarray(c))
    _same(jref.wavefaa_ref(jnp.asarray(a), jnp.asarray(c)), want)
    for mask in (_t(a), _t(a).bool()):
        _same(wavefaa(mask, _t(c)), want)
    _same(ref.wavefaa_ref(_t(a), _t(c)), want)


def test_wavefaa_multiblock_order():
    """Ranks in block k start at the popcount of the blocks before it."""
    active = np.zeros(3 * 1024, np.int32)
    active[[5, 1023, 1024 + 7, 2048 + 11]] = 1
    tickets, newctr = wavefaa(_t(active),
                              torch.tensor([50], dtype=torch.int32))
    assert tickets[[5, 1023, 1031, 2059]].tolist() == [50, 51, 52, 53]
    assert int(newctr[0]) == 54
    assert (tickets[_t(active) == 0] == -1).all()


def test_wavefaa_rejects_ragged_mask():
    with pytest.raises(ValueError, match="multiple of 1024"):
        wavefaa(torch.zeros(1000, dtype=torch.bool),
                torch.zeros(1, dtype=torch.int32))


# -- ring waves ----------------------------------------------------------------


def _ring(nsl2, cyc0=0):
    n = 1 << nsl2
    return [np.full(n, cyc0, np.int32), np.ones(n, np.int32),
            np.zeros(n, np.int32), np.full(n, BOT, np.int32)]


def _enq_all(planes, tickets, values, head, nsl2, jax_ref=True):
    """The port's wrapper and oracle against the reference's Pallas
    wrapper (and its oracle, a slow op-by-op scan, when ``jax_ref``), from
    the same state.  Returns the new state."""
    want = jring.ring_enqueue(*map(jnp.asarray, planes), jnp.asarray(tickets),
                              jnp.asarray(values),
                              jnp.asarray([head], jnp.int32),
                              nslots_log2=nsl2, idx_bot=BOT)
    if jax_ref:
        _same(jref.ring_enqueue_ref(*map(jnp.asarray, planes),
                                    jnp.asarray(tickets),
                                    jnp.asarray(values),
                                    jnp.asarray([head], jnp.int32), nsl2,
                                    BOT), want)
    _same(ring_enqueue(*map(_t, planes), _t(tickets), _t(values), head,
                       nslots_log2=nsl2, idx_bot=BOT), want)
    _same(ref.ring_enqueue_ref(*map(_t, planes), _t(tickets), _t(values),
                               head, nsl2, BOT), want)
    return [np.asarray(p) for p in want[:4]], np.asarray(want[4])


def _deq_all(planes, tickets, nsl2, jax_ref=True):
    want = jring.ring_dequeue(*map(jnp.asarray, planes), jnp.asarray(tickets),
                              nslots_log2=nsl2, idx_bot=BOT)
    if jax_ref:
        _same(jref.ring_dequeue_ref(*map(jnp.asarray, planes),
                                    jnp.asarray(tickets), nsl2, BOT), want)
    _same(ring_dequeue(*map(_t, planes), _t(tickets), nslots_log2=nsl2,
                       idx_bot=BOT), want)
    _same(ref.ring_dequeue_ref(*map(_t, planes), _t(tickets), nsl2, BOT),
          want)
    return [np.asarray(p) for p in want[:4]], np.asarray(want[4]), \
        np.asarray(want[5])


@pytest.mark.parametrize("nsl2", [5, 6, 8])
def test_ring_roundtrip(nsl2):
    nslots = 1 << nsl2
    b = nslots // 2
    tickets = np.arange(nslots, nslots + b, dtype=np.int32)
    values = np.arange(100, 100 + b, dtype=np.int32)
    planes, ok = _enq_all(_ring(nsl2), tickets, values, nslots, nsl2)
    assert ok.all()
    _, vals, ok = _deq_all(planes, tickets, nsl2)
    np.testing.assert_array_equal(vals, values)
    assert ok.all()


def test_ring_inactive_tickets_noop():
    nsl2 = 5
    planes = _ring(nsl2)
    tickets = np.full(8, -1, np.int32)
    out, ok = _enq_all(planes, tickets, np.arange(8, dtype=np.int32), 32,
                       nsl2)
    assert not ok.any()
    out, vals, ok = _deq_all(out, tickets, nsl2)
    assert not ok.any() and (vals == -1).all()
    for a, b in zip(out, planes):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nsl2", [5, 6])
def test_ring_dirty_second_cycle(nsl2):
    """Random partial waves drive the ring through several cycles over
    dirty slots: enqueues skipped by an inactive lane leave empty slots
    that a later dequeue ⊥-advances, and values whose dequeue lane was
    inactive are met by next-cycle dequeues that mark them unsafe."""
    nslots = 1 << nsl2
    rng = np.random.default_rng(nsl2)
    planes = _ring(nsl2)
    head = tail = nslots
    advanced = unsafe = 0
    for _ in range(12):
        b = nslots // 2
        t = np.arange(tail, tail + b, dtype=np.int64)
        t = np.where(rng.random(b) < 0.7, t, -1).astype(np.int32)
        planes, _ = _enq_all(planes, t, rng.integers(0, 999, b, np.int32),
                             head, nsl2, jax_ref=False)
        tail += b
        d = np.arange(head, head + b, dtype=np.int64)
        d = np.where(rng.random(b) < 0.7, d, -1).astype(np.int32)
        before = [p.copy() for p in planes]
        planes, _, ok = _deq_all(planes, d, nsl2, jax_ref=False)
        changed_cyc = planes[0] != before[0]
        advanced += int(changed_cyc.sum())
        unsafe += int(((before[1] == 1) & (planes[1] == 0)).sum())
        head += b
    assert advanced > 0 and unsafe > 0


@pytest.mark.parametrize("start", [2 ** 30, 2 ** 31 - 64, 2 ** 32 - 64])
def test_ring_planes_at_wrap_boundaries(start):
    """Tickets crossing the int32 sign and the full 2^32 wrap, with an
    explicit active mask (as the mesh queue passes it): the functional
    plane updates match the reference's ``enq_planes``/``deq_planes``."""
    nsl2 = 5
    n2 = 1 << nsl2
    start = start // n2 * n2
    cyc0 = _i32(((start % 2 ** 32) >> nsl2) - 1)
    planes = _ring(nsl2, cyc0)
    rng = np.random.default_rng(3)
    head = tail = start
    sent, got = [], []
    for rnd in range(10):
        b = 8
        act = rng.random(b) < 0.8
        t = np.array([_i32(tail + i) for i in range(b)], np.int32)
        vals = rng.integers(1, 10_000, b).astype(np.int32)
        h = _i32(head)
        want = jring.enq_planes(*map(jnp.asarray, planes), jnp.asarray(t),
                                jnp.asarray(vals), jnp.int32(h),
                                nslots_log2=nsl2, idx_bot=BOT,
                                active=jnp.asarray(act))
        _same(enq_planes(*map(_t, planes), _t(t), _t(vals), h,
                         nslots_log2=nsl2, idx_bot=BOT, active=_t(act)),
              want)
        planes = [np.asarray(p) for p in want[:4]]
        sent += vals[np.asarray(want[4]) > 0].tolist()
        tail += b
        d = np.array([_i32(head + i) for i in range(b)], np.int32)
        dact = np.ones(b, bool) if rnd >= 5 else rng.random(b) < 0.9
        want = jring.deq_planes(*map(jnp.asarray, planes), jnp.asarray(d),
                                nslots_log2=nsl2, idx_bot=BOT,
                                active=jnp.asarray(dact))
        _same(deq_planes(*map(_t, planes), _t(d), nslots_log2=nsl2,
                         idx_bot=BOT, active=_t(dact)), want)
        planes = [np.asarray(p) for p in want[:4]]
        got += np.asarray(want[4])[np.asarray(want[5]) > 0].tolist()
        head += b
    assert len(sent) > 0 and set(got) <= set(sent)


# -- wave compaction -----------------------------------------------------------


@pytest.mark.parametrize("n", [256, 1024, 2500, 70000])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_compact_matches_reference(n, density):
    rng = np.random.default_rng(n * 7)
    mask = (rng.random(n) < density).astype(np.int32)
    for nplanes in (1, 2):
        planes = [rng.integers(1, 1 << 20, n).astype(np.int32)
                  for _ in range(nplanes)]
        for width in (max(n // 8, 8), n):       # clamping and full widths
            want = jcompact.compact_planes(
                jnp.asarray(mask), tuple(map(jnp.asarray, planes)),
                width=width)
            if n <= 2500:
                pallas = jcompact.wave_compact(
                    jnp.asarray(mask), tuple(map(jnp.asarray, planes)),
                    width=width)
                _same(pallas[0], want[0])
                assert int(pallas[1]) == int(want[1])
            for m in (_t(mask), _t(mask).bool()):
                dense, count = wave_compact(m, tuple(map(_t, planes)),
                                            width=width)
                _same(dense, want[0])
                assert count.dtype == torch.int32
                assert int(count) == int(want[1]) == int(mask.sum())


def test_compact_pallas_multiblock():
    """A wave wider than the Pallas kernel's 64Ki-lane block."""
    n, width = 70000, 4096
    rng = np.random.default_rng(9)
    mask = (rng.random(n) < 0.03).astype(np.int32)
    plane = rng.integers(1, 1 << 20, n).astype(np.int32)
    want = jcompact.wave_compact(jnp.asarray(mask), (jnp.asarray(plane),),
                                 width=width)
    dense, count = compact_planes(_t(mask), (_t(plane),), width=width)
    _same(dense, want[0])
    assert int(count) == int(want[1])


@pytest.mark.parametrize("density", [0.01, 0.3])
def test_compact_kron_wave_width_below_popcount(density):
    """The kron path's 1.26 M-lane child wave (1,024 x the graph's largest
    fan-out) compacted to a width below its popcount: the dense prefix,
    the dropped ranks and the TRUE count, against the reference twin."""
    n = 1024 * 1233
    rng = np.random.default_rng(int(density * 100))
    mask = rng.random(n) < density
    planes = [rng.integers(1, 1 << 20, n).astype(np.int32) for _ in range(2)]
    width = int(mask.sum()) // 3
    want = jcompact.compact_planes(jnp.asarray(mask.astype(np.int32)),
                                   tuple(map(jnp.asarray, planes)),
                                   width=width)
    dense, count = compact_planes(_t(mask), tuple(map(_t, planes)),
                                  width=width)
    _same(dense, want[0])
    assert int(count) == int(want[1]) == int(mask.sum()) > width


def test_compact_scratch_and_cpu_face():
    """The kernel's scratch is 4 words and one 64-bit status word per
    8,192-lane tile, all zero; the CPU face takes it and ignores it."""
    for n, words in ((1, 6), (8192, 6), (8193, 8), (1 << 22, 4 + 2 * 512)):
        sc = compact_scratch(n, "cpu")
        assert sc.dtype == torch.int32 and sc.shape == (words,)
        assert int(sc.abs().sum()) == 0
    mask = _t(np.array([0, 1, 1, 0, 1], np.int32))
    plane = _t(np.arange(5, dtype=np.int32) + 10)
    dense, count = wave_compact(mask, (plane,), width=4,
                                scratch=compact_scratch(5, "cpu"))
    _same(dense, ([11, 12, 14, 0],))
    assert int(count) == 3


@pytest.mark.parametrize("args", [(100, 64, False), (0, 64, None),
                                  (100, 64, None), (32, 64, None),
                                  (32, 64, True), (3, 0, True)])
def test_compact_width_rule(args):
    assert compact_width(*args) == jcompact.compact_width(*args)


def test_wavefaa_scratch_and_cpu_face():
    """The kernel's look-back scratch is 4 words and one 64-bit status
    word per 8,192-lane tile, all zero; a wave of one tile needs none, and
    the CPU face takes a scratch and ignores it."""
    for n, words in ((1024, 6), (8192, 6), (9216, 8), (1 << 22, 4 + 2 * 512)):
        sc = wavefaa_scratch(n, "cpu")
        assert sc.dtype == torch.int32 and sc.shape == (words,)
        assert int(sc.abs().sum()) == 0
    rng = np.random.default_rng(11)
    mask = _t(rng.random(3 * 1024) < 0.4)
    ctr = _t(np.array([2 ** 31 - 9], np.int32))
    got = wavefaa(mask, ctr, scratch=wavefaa_scratch(3 * 1024, "cpu"))
    want = jwavefaa(jnp.asarray(mask.numpy()), jnp.asarray(ctr.numpy()))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _c_params(source: str, fn: str) -> int:
    """The parameter count of ``extern "C" int fn(...)`` in ``source``."""
    import re
    m = re.search(r'extern "C" int ' + fn + r"\((.*?)\)\s*\{", source,
                  re.S)
    assert m, fn
    return len([p for p in m.group(1).split(",") if p.strip()])


@pytest.mark.parametrize("lib,fn", [(lib, fn) for lib, fns in
                                    _build.SIGNATURES.items()
                                    for fn in fns])
def test_ctypes_signature_matches_source(lib, fn):
    """Each entry point's ctypes argument list has as many arguments as
    its ``extern "C"`` declaration in ``csrc/<lib>.cu``: a count that
    disagrees fails only on the card, where ctypes refuses the call."""
    source = (_build.CSRC / f"{lib}.cu").read_text()
    assert _c_params(source, fn) == len(_build.SIGNATURES[lib][fn])
