"""The port's model zoo (``repro_torch.models``), layer by layer and whole,
held against the JAX reference on reduced configurations.

Parameters come from the reference's ``init_params`` through
``interop.params_from_numpy``; inputs from numpy seeds.  The layers run
on the CPU, where attention's flash path takes ``flash_attention_plain``
and the MoE ticket step ``expert_tickets_plain``.

Tolerances:
* float32 (both sides' parameters cast to float32, so the comparison is
  of the algorithm): 1e-5 absolute plus 1e-5 relative for a single layer;
  for the MoE layer, whose outputs reach 40 (``_dense`` scales the expert
  weights by 1/sqrt(E)) and cancel in places, 1e-5 of the largest output
  magnitude.  2e-4 absolute on the logits of a whole model (magnitude up
  to about 30; the sums run in another order), decode caches in float32.
* decode caches in bfloat16, as the engine keeps them: 5e-3 absolute on
  the logits.  A float32 value a few ulps from a bfloat16 rounding
  boundary can round the other way on the two sides and move a logit by
  up to 3.4e-3 over 40 steps (with float32 caches the same run differs
  by 3.3e-6).
* bfloat16 parameters (as the reference makes them): the near-tie rule
  of ``tests/test_models.py``: at least 70 % of the positions close
  within 0.15 absolute and relative, and a mean deviation below 0.2; a
  router choice may flip on a near tie and that position then diverges.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["granite-moe-3b-a800m", "h2o-danube-1.8b", "gemma2-27b"]
F32 = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=2e-4, rtol=0)


@functools.lru_cache(maxsize=None)
def _model(name, f32=True, **changes):
    jcfg = dataclasses.replace(jget(name).reduced(), **changes)
    cfg = dataclasses.replace(get_config(name).reduced(), **changes)
    jp = JT.init_params(jcfg)
    if f32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


def _layer(jp, tp, i=0):
    return (jax.tree.map(lambda a: a[i], jp["layers"]),
            {k: v[i] for k, v in tp["layers"].items()})


def _x(shape, seed, dtype=np.float32, scale=1.0):
    x = (np.random.default_rng(seed).normal(size=shape) * scale)
    return x.astype(dtype)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


# -- single layers ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_softcap(dtype):
    x = _x((3, 5, 64), 0, scale=2.0)
    w = _x((64,), 1, scale=0.1)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    got, want = TL.rms_norm(tx, tw), JL.rms_norm(jx, jw)
    assert got.dtype == getattr(torch, dtype)
    # bfloat16 outputs are the same float32 values rounded once
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5,
                               rtol=1e-2 if dtype == "bfloat16" else 1e-6)
    np.testing.assert_allclose(TL.softcap(torch.from_numpy(x), 3.0).numpy(),
                               np.asarray(JL.softcap(jnp.asarray(x), 3.0)),
                               **F32)


@pytest.mark.parametrize("theta", [10000.0, 5e6])
def test_rope(theta):
    """XLA's and PyTorch's float32 exp differ in the last place for a few
    frequencies, and the angle multiplies that by the position: the bound
    is 2e-5 plus 2e-9 per unit of position and of |x| (3e-5 seen at
    position 8,191, 2.3e-4 at 70,000)."""
    x = _x((2, 7, 3, 32), 2)
    pos = np.array([0, 1, 5, 9, 100, 8191, 70000], np.int32)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    want = np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    err = np.abs(got - want).max(axis=(0, 2, 3))
    bound = 2e-5 + 2e-9 * pos * np.abs(x).max()
    assert (err <= bound).all(), (err, bound)
    assert err[0] == 0.0


def test_mlp():
    jcfg, cfg, jp, tp = _model("h2o-danube-1.8b")
    jl, tl = _layer(jp, tp)
    x = _x((2, 6, cfg.d_model), 3)
    np.testing.assert_allclose(TL.mlp(tl, torch.from_numpy(x)).numpy(),
                               np.asarray(JL.mlp(jl, jnp.asarray(x))),
                               **F32)


def test_embedding_scale_rounds_to_bf16_first():
    """sqrt(128) = 11.31 is 11.3125 in bfloat16; the reference multiplies
    by the rounded value, so does the port."""
    jcfg, cfg, jp, tp = _model("h2o-danube-1.8b")
    toks = np.array([[1, 2, 3]], np.int32)
    got = TT._embed(tp, torch.from_numpy(toks).long(), cfg)
    want = (jp["embed"][jnp.asarray(toks)]
            * jnp.sqrt(float(jcfg.d_model)).astype(jnp.bfloat16))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), tp["embed"][torch.from_numpy(toks).long()].numpy()
        * np.float32(11.3125))


# -- attention ---------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_attention_dense_path(name):
    jcfg, cfg, jp, tp = _model(name)
    jl, tl = _layer(jp, tp)
    x = _x((2, 16, cfg.d_model), 4, scale=0.5)
    pos = np.arange(16, dtype=np.int32)
    w = cfg.window_for_layer(0)
    got, _ = TL.attention(tl, torch.from_numpy(x), cfg,
                          positions=torch.from_numpy(pos), window=w)
    want, _ = JL.attention(jl, jnp.asarray(x), jcfg,
                           positions=jnp.asarray(pos), window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "gemma2-27b"])
def test_attention_flash_path(name, monkeypatch):
    """S = 2048 keys, no cache: both sides take the blocked flash path
    (the port through ``flash_attention``: the kernel on the card, its
    plain version here)."""
    jcfg, cfg, jp, tp = _model(name)
    calls = []
    real = TL.flash_attention

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(TL, "flash_attention", spy)
    for layer in range(2):          # gemma2: a local and a global layer
        jl, tl = _layer(jp, tp, layer)
        x = _x((1, 2048, cfg.d_model), 5 + layer, scale=0.5)
        pos = np.arange(2048, dtype=np.int32)
        w = cfg.window_for_layer(layer)
        got, _ = TL.attention(tl, torch.from_numpy(x), cfg,
                              positions=torch.from_numpy(pos), window=w)
        want, _ = JL.attention(jl, jnp.asarray(x), jcfg,
                               positions=jnp.asarray(pos), window=w)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert [c["window"] for c in calls] == [cfg.window_for_layer(0),
                                            cfg.window_for_layer(1)]
    assert all(c["softcap_val"] == cfg.attn_softcap for c in calls)


@pytest.mark.parametrize("name", ["gemma2-27b", "granite-moe-3b-a800m"])
def test_attention_cache_path_wraps(name):
    """Decode through a ring cache smaller than the sequence: slots are
    rewritten at cur % Sc, slot positions come from a floor modulo, and
    unwritten slots are masked."""
    jcfg, cfg, jp, tp = _model(name)
    jl, tl = _layer(jp, tp)          # gemma2 layer 0: window 16
    sc = cfg.window_for_layer(0) or 12
    b = 2
    ck = torch.zeros(b, sc, cfg.n_kv_heads, cfg.hd, dtype=torch.bfloat16)
    cv = torch.zeros_like(ck)
    jck = jnp.zeros((b, sc, jcfg.n_kv_heads, jcfg.hd), jnp.bfloat16)
    jcv = jnp.zeros_like(jck)
    for t in range(sc * 2 + 5):
        x = _x((b, 1, cfg.d_model), 100 + t, scale=0.5)
        got, (ck, cv, cur) = TL.attention(
            tl, torch.from_numpy(x), cfg,
            positions=torch.tensor([t], dtype=torch.int32),
            window=cfg.window_for_layer(0), cache=(ck, cv, t))
        want, (jck, jcv, _) = JL.attention(
            jl, jnp.asarray(x), jcfg, positions=jnp.asarray([t], jnp.int32),
            window=cfg.window_for_layer(0), cache=(jck, jcv, jnp.int32(t)))
        assert cur == t + 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_array_equal(_np(ck), _np(jck))


# -- MoE ---------------------------------------------------------------------


def _jax_slots(jcfg, jl, x):
    """The reference's inline ticket reservation on its own routing."""
    t = x.shape[0] * x.shape[1]
    gates = x.reshape(t, -1).astype(jnp.float32) @ jl["router"]
    _, top_e = jax.lax.top_k(gates, jcfg.top_k)
    onehot = jax.nn.one_hot(top_e, jcfg.n_experts, dtype=jnp.int32)
    flat = onehot.reshape(t * jcfg.top_k, jcfg.n_experts)
    slot = jnp.sum((jnp.cumsum(flat, 0) - flat) * flat, -1)
    cap = TM.moe_capacity(t, jcfg)
    return np.where(np.asarray(slot) < cap, np.asarray(slot), -1)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.3])
@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "deepseek-moe-16b"])
def test_moe_forward(name, capacity_factor):
    """A capacity factor of 0.3 drops pairs: the slots must be the same
    on both sides, and so must the outputs."""
    jcfg, cfg, jp, tp = _model(name, capacity_factor=capacity_factor)
    jl, tl = _layer(jp, tp)
    x = _x((4, 40, cfg.d_model), 7)
    got = TM.moe_forward(tl, torch.from_numpy(x), cfg).numpy()
    want = np.asarray(JM.moe_forward(jl, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    t = 4 * 40
    gates = torch.from_numpy(x).reshape(t, -1) @ tl["router"]
    dispatch, _, _ = TM.moe_route(gates, cfg.top_k, TM.moe_capacity(t, cfg))
    slots = dispatch.reshape(-1).numpy()
    want_slots = _jax_slots(jcfg, jl, jnp.asarray(x)).reshape(-1)
    np.testing.assert_array_equal(slots, want_slots)
    dropped = (want_slots < 0).mean()
    assert (dropped > 0.1) if capacity_factor < 1 else (dropped == 0)


# -- whole models ------------------------------------------------------------


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_prefill(name):
    jcfg, cfg, jp, tp = _model(name)
    toks = _tokens(cfg, 2, 24, 8)
    tt = torch.from_numpy(toks).long()
    got = TT.forward(tp, tt, cfg)
    want = JT.forward(jp, jnp.asarray(toks), jcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 24, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    lg, caches = TT.prefill(tp, tt, cfg)
    jlg, jcaches = JT.prefill(jp, jnp.asarray(toks), jcfg)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGITS)
    for key in ("k", "v"):
        assert caches[key].shape == jcaches[key].shape
        np.testing.assert_allclose(caches[key].numpy(),
                                   np.asarray(jcaches[key]), **F32)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_decode_step(name, cache_dtype):
    """40 steps through caches of 32 positions: the window-16 rings of
    gemma2's local layers and every full cache wrap."""
    jcfg, cfg, jp, tp = _model(name)
    toks = _tokens(cfg, 2, 40, 9)
    cache = TT.init_decode_cache(cfg, 2, 32, getattr(torch, cache_dtype),
                                 device="cpu")
    jcache = JT.init_decode_cache(jcfg, 2, 32, getattr(jnp, cache_dtype))
    assert [c["k"].shape for c in cache] == [c["k"].shape for c in jcache]
    tol = LOGITS if cache_dtype == "float32" else dict(atol=5e-3, rtol=0)
    jstep = jax.jit(lambda p, c, tok, cur: JT.decode_step(p, c, tok, cur,
                                                           jcfg))
    for t in range(40):
        lg, cache = TT.decode_step(tp, cache, torch.from_numpy(
            toks[:, t:t + 1]).long(), t, cfg)
        jlg, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.int32(t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **tol)


def test_layer_flags():
    cfg = get_config("gemma2-27b").reduced()
    want = JT.layer_flags(jget("gemma2-27b").reduced())
    got = TT.layer_flags(cfg)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_bf16_forward_within_near_tie_rule():
    """The reference's own bfloat16 parameters: discontinuous routing
    may flip a near-tie choice, so the rule of ``tests/test_models.py``
    applies."""
    jcfg, cfg, jp, tp = _model("granite-moe-3b-a800m", f32=False)
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    toks = _tokens(cfg, 1, 16, 10)
    got = TT.forward(tp, torch.from_numpy(toks).long(), cfg).numpy()
    want = np.asarray(JT.forward(jp, jnp.asarray(toks), jcfg))
    close = np.isclose(got, want, rtol=0.15, atol=0.15)
    pos_close = close.all(axis=-1).mean()
    mean_dev = np.abs(got - want).mean()
    assert pos_close >= 0.7 and mean_dev < 0.2, (pos_close, mean_dev)


@pytest.mark.parametrize("name", list_archs())
def test_init_params_builds_the_reference_tree(name):
    """Every configuration of the registry, all six families: the port's
    ``init_params`` gives the reference's tree (``jax.eval_shape`` of its
    ``init_params``), key by key with shapes and dtypes, the hybrid's
    nested ``shared_attn`` block included."""
    cfg = get_config(name).reduced()
    gen = torch.Generator()
    gen.manual_seed(4)
    tp = TT.init_params(cfg, gen, device="cpu")
    shapes = jax.eval_shape(lambda: JT.init_params(jget(name).reduced()))

    def walk(t, j, path):
        if isinstance(j, dict):
            assert set(t) == set(j), (name, path)
            for k in j:
                walk(t[k], j[k], f"{path}/{k}")
            return
        assert tuple(t.shape) == j.shape, (name, path)
        assert str(t.dtype).split(".")[-1] == j.dtype.name, (name, path)
    walk(tp, shapes, "")


def test_init_params_matches_the_reference_tree():
    for name in ("granite-moe-3b-a800m", "deepseek-moe-16b", "gemma2-27b"):
        cfg = get_config(name).reduced()
        gen = torch.Generator()
        gen.manual_seed(3)
        tp = TT.init_params(cfg, gen, device="cpu")
        shapes = jax.eval_shape(lambda: JT.init_params(jget(name).reduced()))
        flat_t = {k: v for k, v in tp.items() if k != "layers"}
        for k, v in flat_t.items():
            assert tuple(v.shape) == shapes[k].shape, (name, k)
            assert str(v.dtype).split(".")[-1] == shapes[k].dtype.name
        assert set(tp["layers"]) == set(shapes["layers"])
        for k, v in tp["layers"].items():
            assert tuple(v.shape) == shapes["layers"][k].shape, (name, k)
            assert str(v.dtype).split(".")[-1] == \
                shapes["layers"][k].dtype.name


def test_params_round_trip_keeps_bits():
    """The reference's bfloat16 leaves (``ml_dtypes.bfloat16`` numpy
    arrays) become torch bfloat16 tensors with the same bits, in the same
    tree, and come back unchanged."""
    from repro_torch.interop import params_to_numpy
    jcfg, cfg, jp, tp = _model("granite-moe-3b-a800m", f32=False)
    jnp_tree = jax.tree.map(np.asarray, jp)
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jnp_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jnp_tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    assert tp["layers"]["router"].dtype == torch.float32
    assert tp["layers"]["e_gate"].dtype == torch.bfloat16
    again = params_from_numpy(back, device="cpu")
    assert torch.equal(again["embed"], tp["embed"])


def test_gemma3_prefill_at_head_width_256(monkeypatch):
    """gemma3-4b's reduced config at its full head width of 256 (the flash
    kernels' widest instance): a 2,048-token prompt takes the flash path
    in all six layers, five windowed and one global, and the prefill's
    last-token logits and caches match the reference's forward and
    prefill."""
    jcfg, cfg, jp, tp = _model("gemma3-4b", head_dim=256)
    assert cfg.hd == 256 and cfg.n_layers == 6
    calls = []
    real = TL.flash_attention

    def spy(*a, **kw):
        calls.append(kw["window"])
        return real(*a, **kw)

    monkeypatch.setattr(TL, "flash_attention", spy)
    toks = _tokens(cfg, 1, 2048, 21)
    lg, caches = TT.prefill(tp, torch.from_numpy(toks).long(), cfg)
    assert calls == [cfg.window_for_layer(i) for i in range(6)]
    assert calls.count(0) == 1 and cfg.window_for_layer(5) == 0
    want = np.asarray(JT.forward(jp, jnp.asarray(toks), jcfg))
    np.testing.assert_allclose(lg.numpy(), want[:, -1:], **LOGITS)
    jlg, jcaches = JT.prefill(jp, jnp.asarray(toks), jcfg)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGITS)
    # roped K at positions up to 2,047: a rope frequency one float32 ulp
    # apart on the two sides (``test_rope``) turns the angle by up to
    # position x ulp, about 2e-4 here, and the layers after the first
    # carry that into their K and V (2.5e-4 measured, values near 1)
    for key in ("k", "v"):
        np.testing.assert_allclose(caches[key].numpy(),
                                   np.asarray(jcaches[key]), atol=5e-4,
                                   rtol=0)
