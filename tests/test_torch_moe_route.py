"""The port's MoE ticket reservation (B6) through its CPU face, held
bit-exact against the JAX reference: ``expert_tickets_plain`` and
``moe_route`` against the Pallas ``expert_tickets`` (interpret mode, as
the reference's own tests run it), ``ops.expert_tickets`` (any N) and the
oracle ``ref.moe_route_ref``; the port's own oracle against both.

The CUDA kernel runs only on the card; ``chip_smoke.py`` holds it
against ``expert_tickets_plain`` there."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_route import expert_tickets as jtickets  # noqa: E402
from repro_torch.kernels import (expert_tickets,  # noqa: E402
                                 expert_tickets_plain, moe_route, ref)
from repro_torch.kernels.moe_route import (MAX_EXPERTS,  # noqa: E402
                                           TILE_PAIRS,
                                           tickets_scratch_words)


def _ids(rng, n, e, inactive=0.0):
    ids = rng.integers(0, e, n).astype(np.int32)
    ids[rng.random(n) < inactive] = -1
    return ids


def _port(ids, e, cap):
    return expert_tickets(torch.from_numpy(ids), num_experts=e,
                          capacity=cap).numpy()


@pytest.mark.parametrize("n", [128, 256, 1024])
@pytest.mark.parametrize("e", [8, 40, 64])
@pytest.mark.parametrize("inactive", [0.0, 0.3])
@pytest.mark.parametrize("cap", [0, 1, 5, 1 << 20])
def test_tickets_match_pallas_kernel(n, e, inactive, cap):
    rng = np.random.default_rng(n * e + cap)
    ids = _ids(rng, n, e, inactive)
    want = np.asarray(jtickets(jnp.asarray(ids), num_experts=e, capacity=cap,
                               interpret=True))
    np.testing.assert_array_equal(_port(ids, e, cap), want)
    np.testing.assert_array_equal(
        expert_tickets_plain(torch.from_numpy(ids), num_experts=e,
                             capacity=cap).numpy(), want)


@pytest.mark.parametrize("n", [1, 32, 127, 1000])
@pytest.mark.parametrize("cap", [0, 3, 64])
def test_tickets_take_any_n_like_ops(n, cap):
    """N not a multiple of 128: ``ops.expert_tickets`` takes its inline
    one-hot path there; the port takes any N on both faces."""
    rng = np.random.default_rng(n + cap)
    ids = _ids(rng, n, 40, 0.2)
    want = np.asarray(jops.expert_tickets(jnp.asarray(ids), num_experts=40,
                                          capacity=cap))
    np.testing.assert_array_equal(_port(ids, 40, cap), want)


def test_tickets_all_on_one_expert_saturate():
    ids = np.full(384, 3, np.int32)
    for cap in (0, 1, 100, 384, 1000):
        want = np.asarray(jtickets(jnp.asarray(ids), num_experts=8,
                                   capacity=cap))
        got = _port(ids, 8, cap)
        np.testing.assert_array_equal(got, want)
        assert (got >= 0).sum() == min(cap, 384)


def test_tickets_out_of_range_ids_follow_the_kernel():
    """An id >= E matches no expert in the Pallas one-hot: it counts
    toward none and gets slot 0 (-1 at capacity 0)."""
    ids = np.array([0, 9, 0, 12, 1, -1, 0, 8] * 16, np.int32)
    for cap in (0, 2, 50):
        want = np.asarray(jtickets(jnp.asarray(ids), num_experts=8,
                                   capacity=cap))
        np.testing.assert_array_equal(_port(ids, 8, cap), want)


@pytest.mark.parametrize("t,e,k,cap", [(64, 16, 2, 10), (128, 8, 1, 32),
                                       (64, 40, 8, 16), (100, 40, 8, 2080),
                                       (33, 64, 6, 1)])
def test_moe_route_matches_reference(t, e, k, cap):
    rng = np.random.default_rng(t * e)
    gates = rng.normal(size=(t, e)).astype(np.float32)
    g = torch.from_numpy(gates)
    dr, er, cr = (np.asarray(a) for a in
                  jref.moe_route_ref(jnp.asarray(gates), k, cap))
    for d, ex, c in (moe_route(g, k, cap), ref.moe_route_ref(g, k, cap)):
        np.testing.assert_array_equal(d.numpy(), dr)
        np.testing.assert_array_equal(ex.numpy(), er)
        np.testing.assert_allclose(c.numpy(), cr, atol=1e-6)
    if (t * k) % 128 == 0:
        dk, ek, ck = (np.asarray(a) for a in
                      jops.moe_route(jnp.asarray(gates), k, cap))
        np.testing.assert_array_equal(dk, dr)
        np.testing.assert_array_equal(ek, er)


def test_moe_route_ties_pick_lower_index_first():
    """``jax.lax.top_k`` orders equal gates by index; so does the port."""
    gates = np.zeros((16, 8), np.float32)
    gates[:, 5] = 1.0
    gates[::2, 2] = 1.0
    d, ex, _ = moe_route(torch.from_numpy(gates), 3, 4)
    dr, er, _ = jref.moe_route_ref(jnp.asarray(gates), 3, 4)
    np.testing.assert_array_equal(ex.numpy(), np.asarray(er))
    np.testing.assert_array_equal(d.numpy(), np.asarray(dr))


def test_moe_capacity_is_respected():
    t, e, k, cap = 256, 4, 1, 8
    gates = np.zeros((t, e), np.float32)
    gates[:, 0] = 10.0
    d, _, _ = moe_route(torch.from_numpy(gates), k, cap)
    granted = d.numpy()[:, 0]
    assert (granted >= 0).sum() == cap
    assert sorted(granted[granted >= 0].tolist()) == list(range(cap))


@pytest.mark.parametrize("n", [32, 1024, 1025, 65536])
@pytest.mark.parametrize("e", [40, 64, 128, 257])
def test_tickets_match_pallas_kernel_at_any_expert_count(n, e):
    """Beyond the 64 experts the card's first kernel held: the plain B6
    against the Pallas kernel (interpret mode) at a decode step's 32
    pairs, one and just over one of the card kernel's 1,024-pair tiles,
    and the prefill's 65,536.  N that is not a multiple of the Pallas
    tile is padded with inactive pairs, which take no slot."""
    rng = np.random.default_rng(7 * n + e)
    ids = _ids(rng, n, e, 0.1)
    ids[rng.random(n) < 0.01] = e + 2             # matches no expert
    pad = -n % 128
    padded = np.concatenate([ids, np.full(pad, -1, np.int32)])
    top = int(np.bincount(ids[(ids >= 0) & (ids < e)], minlength=e).max())
    for cap in (0, max(top // 2, 1), top + 1):
        want = np.asarray(jtickets(jnp.asarray(padded), num_experts=e,
                                   capacity=cap, interpret=True))[:n]
        got = expert_tickets_plain(torch.from_numpy(ids), num_experts=e,
                                   capacity=cap).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(_port(ids, e, cap), want)


def test_tickets_scratch_words():
    """A call of up to one 1,024-pair tile needs no scratch; a wider one
    keeps 4 words and one 64-bit status word per (tile, expert)."""
    assert tickets_scratch_words(1024, 40) == 4 + 2 * 40
    assert tickets_scratch_words(1025, 40) == 4 + 2 * 2 * 40
    assert tickets_scratch_words(65536, 257) == 4 + 2 * 64 * 257
    assert TILE_PAIRS == 1024 and MAX_EXPERTS >= 257
