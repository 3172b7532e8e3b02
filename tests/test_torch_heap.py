"""The port's heap kernel faces (``repro_torch.kernels.heap_batch``) on the
CPU, held bit-exact against ``repro.kernels.heap_batch``: ``heap_apply``
against the Pallas kernel (interpret mode) on random op sweeps that fill
the heap past full and drain it past empty, with NOP lanes, duplicate,
negative and ``KEY_INF`` keys; against the jitted ``heap_planes`` at
2^15 slots, where the card's kernel splits the heap between its
shared-memory top and the planes in device memory; a heapq oracle;
``heap_planes`` with a rider plane; and the partial waves
``heap_pop_count`` / ``heap_insert_masked``.  Everything is int32, so
every comparison is exact."""

import functools
import heapq
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import heap_batch as jheap  # noqa: E402
from repro_torch.kernels import heap_batch as heap  # noqa: E402

KEY_INF = heap.KEY_INF


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
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _empty(cap_log2):
    cap = 1 << cap_log2
    return (np.full(cap, KEY_INF, np.int32), np.full(cap, -1, np.int32))


def _batches(rng, cap_log2, b):
    """Op batches that fill the heap past full, drain it past empty, then
    mix: insert share 0.9, then 0.1, then 0.5."""
    nb = 2 * (1 << cap_log2) // b + 2
    out = []
    for share in [0.9] * nb + [0.1] * nb + [0.5] * 4:
        r = rng.random(b)
        ops = np.where(r < share, heap.OP_INSERT,
                       np.where(r < share + (1 - share) * 0.85,
                                heap.OP_DELMIN, heap.OP_NOP))
        keys = rng.integers(-20, 40, b)            # duplicates, negatives
        special = rng.random(b)
        keys = np.where(special < 0.05, KEY_INF, keys)
        keys = np.where(special > 0.98, -2 ** 31, keys)
        out.append((ops.astype(np.int32), keys.astype(np.int32),
                    rng.integers(0, 1000, b).astype(np.int32)))
    return out


@pytest.mark.parametrize("cap_log2", [4, 6, 8])
@pytest.mark.parametrize("arity_log2", [1, 2, 3])
def test_heap_apply_matches_reference(arity_log2, cap_log2):
    rng = np.random.default_rng(100 * arity_log2 + cap_log2)
    kw = dict(cap_log2=cap_log2, arity_log2=arity_log2)
    jk, jv = map(jnp.asarray, _empty(cap_log2))
    jsize = jnp.asarray(0, jnp.int32)
    keys, vals = map(torch.from_numpy, _empty(cap_log2))
    size = torch.tensor(0, dtype=torch.int32)
    seen_full = seen_empty = False
    for ops, ks, vs in _batches(rng, cap_log2, 16):
        jk, jv, jsize, jok_k, jok_v, jok = jheap.heap_apply(
            jk, jv, jsize, *map(jnp.asarray, (ops, ks, vs)), **kw)
        keys, vals, size, outk, outv, ok = heap.heap_apply(
            keys, vals, size, *map(torch.from_numpy, (ops, ks, vs)), **kw)
        for a, b in zip((keys, vals, size, outk, outv, ok),
                        (jk, jv, jsize, jok_k, jok_v, jok)):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        assert size.dtype == torch.int32 and size.dim() == 0
        assert ok.dtype == torch.bool
        seen_full |= bool(((ops == heap.OP_INSERT) & ~ok.numpy()).any())
        seen_empty |= bool(((ops == heap.OP_DELMIN) & ~ok.numpy()).any())
    assert seen_full and seen_empty


#: nodes of the card kernel's shared-memory top by arity_log2 (whole
#: levels: ``kResidentMax`` in ``csrc/heap_batch.cu``)
R_MAX = {1: 16383, 2: 21845, 3: 4681}


def _lanes(b, ops, keys, vals):
    """A (b,)-lane batch: the given ops first, NOP lanes after."""
    pad = b - len(ops)
    return (np.concatenate([ops, np.full(pad, heap.OP_NOP)]).astype(np.int32),
            np.concatenate([keys, np.full(pad, KEY_INF)]).astype(np.int32),
            np.concatenate([vals, np.full(pad, -1)]).astype(np.int32))


def _boundary_batches(rng, arity_log2, offset, b=4096):
    """Batches at 2^15 slots whose paths cross the kernel's shared-memory
    top: a seed to R_MAX + offset nodes, a pop batch, inserts below every
    key held (holes past the top that rise into it), a long pop batch,
    mixed batches with NOP lanes; at offset 0, batches that fill the heap
    past full and empty it past empty."""
    out = []
    seed = R_MAX[arity_log2] + offset
    for i in range(0, seed, b):
        n = min(b, seed - i)
        out.append(_lanes(b, np.zeros(n), rng.integers(0, 60, n),
                          rng.integers(0, 1 << 30, n)))
    out.append(_lanes(b, np.ones(64), np.full(64, KEY_INF), np.full(64, -1)))
    out.append(_lanes(b, np.zeros(3000), rng.integers(-90, -30, 3000),
                      rng.integers(0, 1 << 30, 3000)))
    out.append(_lanes(b, np.ones(3000), np.full(3000, KEY_INF),
                      np.full(3000, -1)))
    for _ in range(2):
        r = rng.random(b)
        ops = np.where(r < 0.6, heap.OP_INSERT,
                       np.where(r < 0.95, heap.OP_DELMIN, heap.OP_NOP))
        keys = rng.integers(-40, 60, b)
        keys = np.where(rng.random(b) < 0.05, KEY_INF, keys)
        out.append((ops.astype(np.int32), keys.astype(np.int32),
                    rng.integers(0, 1 << 30, b).astype(np.int32)))
    full = (1 << 15) + 100 if offset == 0 else 0
    for i in range(0, full, b):
        out.append(_lanes(b, np.zeros(b), rng.integers(-5, 200, b),
                          rng.integers(0, 1 << 30, b)))
    for i in range(0, full, b):
        out.append(_lanes(b, np.ones(b), np.full(b, KEY_INF),
                          np.full(b, -1)))
    return out


@pytest.mark.parametrize("offset", [-3, 0, 5])
@pytest.mark.parametrize("arity_log2", [1, 2, 3])
def test_heap_apply_across_the_shared_memory_top(arity_log2, offset):
    """At 2^15 slots, above the card kernel's shared-memory top: heaps
    seeded just below, at and just above R_MAX nodes, then pops, inserts
    and mixed batches whose sifts cross it, up to full and back to empty;
    every batch bit-exact against the jitted ``heap_planes``."""
    cap_log2 = 15
    rng = np.random.default_rng(1000 * arity_log2 + offset + 3)
    jfn = jax.jit(functools.partial(jheap.heap_planes, cap_log2=cap_log2,
                                    arity_log2=arity_log2))
    jk, jv = map(jnp.asarray, _empty(cap_log2))
    jsize = jnp.asarray(0, jnp.int32)
    keys, vals = map(torch.from_numpy, _empty(cap_log2))
    size = torch.tensor(0, dtype=torch.int32)
    sizes = []
    for ops, ks, vs in _boundary_batches(rng, arity_log2, offset):
        jk, jv, jsize, jok_k, jok_v, jok = jfn(
            jk, jv, jsize, *map(jnp.asarray, (ops, ks, vs)))
        keys, vals, size, outk, outv, ok = heap.heap_apply(
            keys, vals, size, *map(torch.from_numpy, (ops, ks, vs)),
            cap_log2=cap_log2, arity_log2=arity_log2)
        for a, b in zip((keys, vals, size, outk, outv, ok),
                        (jk, jv, jsize, jok_k, jok_v, jok)):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        sizes.append(int(size))
    assert R_MAX[arity_log2] + offset in sizes
    if offset == 0:
        assert max(sizes) == 1 << 15 and sizes[-1] == 0


def test_heap_apply_is_in_place():
    keys, vals = map(torch.from_numpy, _empty(4))
    ops = torch.tensor([0, 0, 1], dtype=torch.int32)
    k, v, size, outk, _, _ = heap.heap_apply(
        keys, vals, 0, ops, torch.tensor([5, 3, 0], dtype=torch.int32),
        torch.tensor([50, 30, 0], dtype=torch.int32), cap_log2=4)
    assert k is keys and v is vals
    assert int(size) == 1 and outk.tolist() == [KEY_INF, KEY_INF, 3]
    assert keys[:2].tolist() == [5, KEY_INF] and vals[0] == 50


def test_heap_apply_matches_host_oracle():
    """Mirror of ``tests/test_sched.py:227``: pops come out in heapq
    order, inserts are accepted, pops on an empty heap are rejected."""
    rng = random.Random(7)
    for arity_log2 in (1, 2):
        keys, vals = map(torch.from_numpy, _empty(6))
        size = torch.tensor(0, dtype=torch.int32)
        oracle = []
        for _ in range(6):
            ops, ks, vs = [], [], []
            for _ in range(8):
                r = rng.random()
                if r < 0.55:
                    ops.append(0)
                    ks.append(rng.randrange(100))
                    vs.append(rng.randrange(1000))
                elif r < 0.9:
                    ops.append(1)
                    ks.append(KEY_INF)
                    vs.append(-1)
                else:
                    ops.append(-1)
                    ks.append(KEY_INF)
                    vs.append(-1)
            keys, vals, size, outk, outv, ok = heap.heap_apply(
                keys, vals, size, *(torch.tensor(x, dtype=torch.int32)
                                    for x in (ops, ks, vs)),
                cap_log2=6, arity_log2=arity_log2)
            for i, op in enumerate(ops):
                if op == 0:
                    assert bool(ok[i])
                    heapq.heappush(oracle, ks[i])
                elif op == 1 and oracle:
                    assert bool(ok[i])
                    assert int(outk[i]) == heapq.heappop(oracle)
                else:
                    assert not bool(ok[i])
            assert int(size) == len(oracle)


@pytest.mark.parametrize("oprider", ["none", "scalar", "vector"])
def test_heap_planes_rider_matches_reference(oprider):
    rng = np.random.default_rng(5)
    cap_log2, b = 6, 16
    jk, jv = map(jnp.asarray, _empty(cap_log2))
    jr = jnp.full(1 << cap_log2, -1, jnp.int32)
    jsize = jnp.asarray(0, jnp.int32)
    keys, vals = map(torch.from_numpy, _empty(cap_log2))
    rider = torch.full((1 << cap_log2,), -1, dtype=torch.int32)
    size = torch.tensor(0, dtype=torch.int32)
    for step, (ops, ks, vs) in enumerate(_batches(rng, cap_log2, b)):
        opr = {"none": None, "scalar": step,
               "vector": rng.integers(0, 99, b).astype(np.int32)}[oprider]
        jout = jheap.heap_planes(
            jk, jv, jsize, *map(jnp.asarray, (ops, ks, vs)),
            cap_log2=cap_log2, rider=jr,
            oprider=None if opr is None else jnp.asarray(opr))
        before = keys.clone()
        out = heap.heap_planes(
            keys, vals, size, *map(torch.from_numpy, (ops, ks, vs)),
            cap_log2=cap_log2, rider=rider,
            oprider=None if opr is None else torch.as_tensor(opr))
        assert torch.equal(keys, before)              # functional
        assert len(out) == len(jout) == 8
        for a, bb in zip(out, jout):
            np.testing.assert_array_equal(_np(a), np.asarray(bb))
        jk, jv, jsize, _, _, _, jr, _ = jout
        keys, vals, size, _, _, _, rider, _ = out
    # without a rider the tuple and the planes are the single-plane ones
    got = heap.heap_planes(keys, vals, size, *map(torch.from_numpy,
                                                  (ops, ks, vs)),
                           cap_log2=cap_log2)
    want = jheap.heap_apply(jk, jv, jsize, *map(jnp.asarray, (ops, ks, vs)),
                            cap_log2=cap_log2)
    assert len(got) == 6
    for a, bb in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(bb))


@pytest.mark.parametrize("with_rider", [False, True])
def test_partial_waves_match_reference(with_rider):
    rng = np.random.default_rng(11)
    cap_log2, b = 6, 16
    jk, jv = map(jnp.asarray, _empty(cap_log2))
    keys, vals = map(torch.from_numpy, _empty(cap_log2))
    jsize, size = jnp.asarray(0, jnp.int32), torch.tensor(0,
                                                          dtype=torch.int32)
    jr = jnp.zeros(1 << cap_log2, jnp.int32) if with_rider else None
    rider = (torch.zeros(1 << cap_log2, dtype=torch.int32) if with_rider
             else None)
    for step in range(12):
        ks = rng.integers(0, 30, b).astype(np.int32)
        vs = rng.integers(0, 500, b).astype(np.int32)
        mask = rng.random(b) < 0.6
        ins_kw = dict(cap_log2=cap_log2, oprider=step) if with_rider else \
            dict(cap_log2=cap_log2)
        jout = jheap.heap_insert_masked(
            jk, jv, jsize, jnp.asarray(ks), jnp.asarray(vs),
            jnp.asarray(mask), rider=jr, **ins_kw)
        out = heap.heap_insert_masked(
            keys, vals, size, torch.from_numpy(ks), torch.from_numpy(vs),
            torch.from_numpy(mask), rider=rider, **ins_kw)
        for a, bb in zip(out, jout):
            np.testing.assert_array_equal(_np(a), np.asarray(bb))
        count = int(rng.integers(0, b + 1))
        jout = jheap.heap_pop_count(jout[0], jout[1], jout[2], count,
                                    batch=b, cap_log2=cap_log2,
                                    rider=jout[6] if with_rider else None)
        out = heap.heap_pop_count(out[0], out[1], out[2], count, batch=b,
                                  cap_log2=cap_log2,
                                  rider=out[6] if with_rider else None)
        for a, bb in zip(out, jout):
            np.testing.assert_array_equal(_np(a), np.asarray(bb))
        n_ok = int(out[5].sum())
        assert out[5].tolist() == [i < n_ok for i in range(b)]
        jk, jv, jsize = jout[:3]
        keys, vals, size = out[:3]
        if with_rider:
            jr, rider = jout[6], out[6]


@pytest.mark.parametrize("arity_log2", [0, 3])
def test_heap_apply_refuses_unbuilt_arities(arity_log2):
    """arity_log2 0 is refused on both faces (the reference's levels
    divide by it).  arity_log2 3 (an 8-ary heap), which both faces once
    refused, is bit-exact against the reference's ``heap_planes``: three
    inserts and a pop at 2^6 slots, then a sweep that fills the heap past
    full and drains it past empty."""
    if arity_log2 == 0:
        keys, vals = map(torch.from_numpy, _empty(4))
        lanes = torch.zeros(4, dtype=torch.int32)
        with pytest.raises(ValueError, match="arity_log2"):
            heap.heap_apply(keys, vals, 0, lanes, lanes, lanes, cap_log2=4,
                            arity_log2=arity_log2)
        with pytest.raises(ValueError, match="arity_log2"):
            heap.heap_apply_plain(keys, vals, 0, lanes, lanes, lanes,
                                  cap_log2=4, arity_log2=arity_log2)
        return
    kw = dict(cap_log2=6, arity_log2=arity_log2)
    first = (np.array([0, 0, 0, 1], np.int32), np.array([7, 3, 9, 0],
                                                         np.int32),
             np.array([70, 30, 90, 0], np.int32))
    rng = np.random.default_rng(3)
    jk, jv = map(jnp.asarray, _empty(6))
    jsize = jnp.asarray(0, jnp.int32)
    keys, vals = map(torch.from_numpy, _empty(6))
    size = torch.tensor(0, dtype=torch.int32)
    jfn = jax.jit(functools.partial(jheap.heap_planes, **kw))
    for i, (ops, ks, vs) in enumerate([first] + _batches(rng, 6, 16)):
        jout = jfn(jk, jv, jsize, *map(jnp.asarray, (ops, ks, vs)))
        out = heap.heap_planes(keys, vals, size,
                               *map(torch.from_numpy, (ops, ks, vs)), **kw)
        for a, b in zip(out, jout):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        if i == 0:
            assert (int(out[3][3]), int(out[4][3])) == (3, 30)
        jk, jv, jsize = jout[:3]
        keys, vals, size = out[:3]


@pytest.mark.parametrize("arity_log2", [1, 2, 3])
@pytest.mark.parametrize("oprider", ["device_word", "vector"])
def test_heap_apply_rider_matches_reference(arity_log2, oprider):
    """``heap_apply(rider=, oprider=)`` — the priority round's span path,
    in place, with the inserts' rider a 0-d tensor as the engine passes
    its round clock (or one per lane) — bit for bit against the JAX
    package's ``heap_planes`` with a rider; on CPU tensors it launches
    nothing."""
    from repro_torch.kernels import LAUNCHES
    rng = np.random.default_rng(31 + arity_log2)
    cap_log2, b = 6, 16
    kw = dict(cap_log2=cap_log2, arity_log2=arity_log2)
    jk, jv = map(jnp.asarray, _empty(cap_log2))
    jr = jnp.zeros(1 << cap_log2, jnp.int32)
    jsize = jnp.asarray(0, jnp.int32)
    keys, vals = map(torch.from_numpy, _empty(cap_log2))
    rider = torch.zeros(1 << cap_log2, dtype=torch.int32)
    size = torch.tensor(0, dtype=torch.int32)
    before = dict(LAUNCHES)
    popped = 0
    for step, (ops, ks, vs) in enumerate(_batches(rng, cap_log2, b)):
        opr = (np.int32(step) if oprider == "device_word"
               else rng.integers(0, 99, b).astype(np.int32))
        jout = jheap.heap_planes(jk, jv, jsize,
                                 *map(jnp.asarray, (ops, ks, vs)), rider=jr,
                                 oprider=jnp.asarray(opr), **kw)
        out = heap.heap_apply(keys, vals, size,
                              *map(torch.from_numpy, (ops, ks, vs)),
                              rider=rider, oprider=torch.as_tensor(opr),
                              **kw)
        assert len(out) == len(jout) == 8
        assert out[0] is keys and out[6] is rider      # in place
        for a, w in zip(out, jout):
            np.testing.assert_array_equal(_np(a), np.asarray(w))
        jk, jv, jsize, _, _, _, jr, _ = jout
        size = out[2]
        popped += int((out[7] > 0).sum())
    assert popped > 0 and dict(LAUNCHES) == before


# -- the shard grid: heap_apply_grid_plain against heap_planes per shard ------


def _grid_waves(rng, s, cap_log2, n):
    """Alternating insert and pop waves over ``s`` heaps: gathered insert
    waves of ``n`` lanes with destinations in [-1, s) (one shard installs
    nothing in wave 2, duplicate and KEY_INF keys), then pop counts from 0
    to past a heap's size."""
    cap = 1 << cap_log2
    out = []
    for w in range(10):
        keys = rng.integers(-20, 40, n)
        keys = np.where(rng.random(n) < 0.05, KEY_INF, keys)
        dest = rng.integers(-1, s, n)
        if w == 2:
            dest = np.where(dest == s - 1, -1, dest)
        out.append(("insert", keys.astype(np.int32),
                    rng.integers(0, 1000, n).astype(np.int32),
                    dest.astype(np.int32),
                    rng.integers(0, 99, n).astype(np.int32)))
        counts = rng.integers(0, cap // 2, s)
        if w == 4:
            counts[:] = 0
        if w == 7:
            counts[:] = cap + 1
        out.append(("pop", counts.astype(np.int32)))
    return out


@pytest.mark.parametrize("with_rider", [False, True])
@pytest.mark.parametrize("arity_log2", [1, 2, 3])
@pytest.mark.parametrize("s", [1, 2, 4])
def test_grid_plain_matches_reference_per_shard(s, arity_log2, with_rider):
    """``heap_apply_grid_plain`` on (S, cap) planes against the
    reference's ``heap_insert_masked`` (mask ``dest == s``) and
    ``heap_pop_count`` (``counts[s]``) on each shard's heap, wave after
    wave, filling heaps past full and popping past empty: planes, sizes,
    the popped keys, vals, riders and ok rows."""
    rng = np.random.default_rng(20 + s + 4 * arity_log2)
    cap_log2, n, batch = 5, 24, 12
    cap = 1 << cap_log2
    keys = torch.full((s, cap), KEY_INF, dtype=torch.int32)
    vals = torch.full((s, cap), -1, dtype=torch.int32)
    sizes = torch.zeros(s, dtype=torch.int32)
    rider = torch.zeros((s, cap), dtype=torch.int32) if with_rider else None
    ref = [[jnp.asarray(x) for x in _empty(cap_log2)] + [jnp.int32(0),
           jnp.zeros(cap, jnp.int32) if with_rider else None]
           for _ in range(s)]
    kw = dict(cap_log2=cap_log2, arity_log2=arity_log2)
    for wave in _grid_waves(rng, s, cap_log2, n):
        if wave[0] == "insert":
            _, ks, vs, dest, opr = wave
            out = heap.heap_apply_grid_plain(
                keys, vals, sizes, opkeys=torch.from_numpy(ks),
                opvals=torch.from_numpy(vs), dest=torch.from_numpy(dest),
                rider=rider, oprider=torch.from_numpy(opr), **kw)
            assert len(out) == 3 + with_rider
            for sh, r in enumerate(ref):
                j = jheap.heap_insert_masked(
                    r[0], r[1], r[2], jnp.asarray(ks), jnp.asarray(vs),
                    jnp.asarray(dest == sh), rider=r[3],
                    oprider=jnp.asarray(opr) if with_rider else None, **kw)
                ref[sh] = [j[0], j[1], j[2], j[6] if with_rider else None]
        else:
            counts = wave[1]
            out = heap.heap_apply_grid_plain(
                keys, vals, sizes, counts=torch.from_numpy(counts),
                batch=batch, rider=rider, **kw)
            for sh, r in enumerate(ref):
                j = jheap.heap_pop_count(r[0], r[1], r[2], int(counts[sh]),
                                         batch=batch, rider=r[3], **kw)
                for got, want in zip(out[3:6], j[3:6]):
                    np.testing.assert_array_equal(_np(got[sh]),
                                                  np.asarray(want))
                if with_rider:
                    np.testing.assert_array_equal(_np(out[7][sh]),
                                                  np.asarray(j[7]))
                ref[sh] = [j[0], j[1], j[2], j[6] if with_rider else None]
        for sh, r in enumerate(ref):
            np.testing.assert_array_equal(_np(keys[sh]), np.asarray(r[0]))
            np.testing.assert_array_equal(_np(vals[sh]), np.asarray(r[1]))
            assert int(sizes[sh]) == int(r[2])
            if with_rider:
                np.testing.assert_array_equal(_np(rider[sh]),
                                              np.asarray(r[3]))


def test_grid_at_one_shard_is_heap_apply():
    """The grid at S = 1 is ``heap_apply`` with the wave's ops: the same
    planes, size and results."""
    rng = np.random.default_rng(5)
    cap_log2 = 6
    g = [torch.from_numpy(x).reshape(1, -1) for x in _empty(cap_log2)]
    gs = torch.zeros(1, dtype=torch.int32)
    h = list(map(torch.from_numpy, _empty(cap_log2)))
    hs = torch.zeros((), dtype=torch.int32)
    for _ in range(6):
        ks = torch.from_numpy(rng.integers(0, 50, 40).astype(np.int32))
        mask = torch.from_numpy(rng.random(40) < 0.7)
        heap.heap_apply_grid(*g, gs, opkeys=ks, opvals=ks * 3,
                             dest=torch.where(mask, 0, -1).int(),
                             cap_log2=cap_log2)
        out = heap.heap_insert_masked(*h, hs, ks, ks * 3, mask,
                                      cap_log2=cap_log2)
        h, hs = list(out[:2]), out[2]
        c = int(rng.integers(0, 30))
        got = heap.heap_apply_grid(*g, gs, counts=torch.tensor(
            [c], dtype=torch.int32), batch=32, cap_log2=cap_log2)
        want = heap.heap_pop_count(*h, hs, c, batch=32, cap_log2=cap_log2)
        h, hs = list(want[:2]), want[2]
        for a, b in zip(got[3:6], want[3:6]):
            assert torch.equal(a[0], b)
        assert torch.equal(g[0][0], h[0]) and int(gs[0]) == int(hs)


def test_grid_refuses_bad_calls():
    planes = [torch.zeros((2, 16), dtype=torch.int32) for _ in range(2)]
    sizes = torch.zeros(2, dtype=torch.int32)
    lanes = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="counts= and batch="):
        heap.heap_apply_grid(*planes, sizes, cap_log2=4)
    with pytest.raises(ValueError, match="counts= and batch="):
        heap.heap_apply_grid(*planes, sizes, counts=sizes, batch=4,
                             opkeys=lanes, opvals=lanes, dest=lanes,
                             cap_log2=4)
    with pytest.raises(ValueError, match=r"planes must be \(S, 2\^5\)"):
        heap.heap_apply_grid(*planes, sizes, counts=sizes, batch=4,
                             cap_log2=5)
    with pytest.raises(ValueError, match="sizes must be"):
        heap.heap_apply_grid(*planes, lanes, counts=sizes, batch=4,
                             cap_log2=4)
    with pytest.raises(ValueError, match="arity_log2=0"):
        heap.heap_apply_grid(*planes, sizes, counts=sizes, batch=4,
                             cap_log2=4, arity_log2=0)
