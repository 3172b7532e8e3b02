"""The port's Mamba2 layer (``repro_torch.models.ssm``) and the ssm family
of its transformer, held against the JAX reference
(``repro.models.ssm``, ``repro.models.transformer``) on mamba2-130m's
reduced configuration, and against the naive recurrence.

Tolerances:
* float32 (parameters cast to float32 on both sides, so the comparison is
  of the algorithm): 1e-4 absolute plus 1e-4 relative on a layer's
  outputs and states (a chunk's cumulative decays and its 256-term sums
  run in another order; measured up to 2.9e-5); ``LOGITS`` (2e-4
  absolute) on a whole model's logits (the sums run in another order).
* the naive recurrence of ``tests/test_models.py``: 5e-4 absolute, its
  bound.
* bfloat16 activations (x, B and C in bfloat16, as the model runs): the
  reference rounds the intra-chunk products to bfloat16 in places XLA
  picks; 2e-2 of the largest |y|.
* ``DECODE_TOL`` (1e-3 absolute and relative, float32): the port's own
  decode after a prefill against its own chunked forward over the same
  tokens; ``chip_smoke.py`` holds the full-width model to the same bound
  on the card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

F32 = dict(atol=1e-4, rtol=1e-4)
LOGITS = dict(atol=2e-4, rtol=0)
DECODE_TOL = dict(atol=1e-3, rtol=1e-3)
NAME = "mamba2-130m"


def _model(f32=True):
    jcfg, cfg = jget(NAME).reduced(), get_config(NAME).reduced()
    jp = JT.init_params(jcfg)
    if f32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu")


def _ssd_inputs(b, s, nh, hd, st, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, nh, hd)).astype(np.float32),
            (rng.random((b, s, nh)) * 0.5).astype(np.float32),
            (rng.random(nh) * 0.5).astype(np.float32),
            rng.normal(size=(b, s, st)).astype(np.float32),
            rng.normal(size=(b, s, st)).astype(np.float32),
            (rng.normal(size=(b, nh, hd, st)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("s", [100, 256, 512, 768])
def test_ssd_chunked_matches_reference(s):
    args = _ssd_inputs(2, s, 3, 8, 16, seed=s)
    y, h = TS.ssd_chunked(*(torch.from_numpy(a) for a in args))
    jy, jh = JS.ssd_chunked(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **F32)


def test_ssd_matches_naive_recurrence():
    """``tests/test_models.py``'s case on the port."""
    x, dt, A, B, C, _ = _ssd_inputs(2, 512, 3, 8, 16)
    y, hf = TS.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, B, C)),
                           torch.zeros(2, 3, 8, 16))
    h = np.zeros((2, 3, 8, 16))
    ys = np.zeros((2, 512, 3, 8))
    negA = -np.exp(A)
    for t in range(512):
        dA = np.exp(dt[:, t] * negA)
        h = h * dA[:, :, None, None] + np.einsum("bh,bhd,bs->bhds", dt[:, t],
                                                 x[:, t], B[:, t])
        ys[:, t] = np.einsum("bs,bhds->bhd", C[:, t], h)
    np.testing.assert_allclose(y.numpy(), ys, atol=5e-4)
    np.testing.assert_allclose(hf.numpy(), h, atol=5e-4)


def test_ssd_chunked_bf16_activations():
    x, dt, A, B, C, h0 = _ssd_inputs(2, 512, 4, 16, 16, seed=3)
    bf = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    y, h = TS.ssd_chunked(bf(x), torch.from_numpy(dt), torch.from_numpy(A),
                          bf(B), bf(C), torch.from_numpy(h0))
    jbf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    jy, jh = JS.ssd_chunked(jbf(x), jnp.asarray(dt), jnp.asarray(A), jbf(B),
                            jbf(C), jnp.asarray(h0))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    want = np.asarray(jy.astype(jnp.float32))
    assert np.abs(y.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-2 *
                               np.abs(np.asarray(jh)).max())


def test_ssd_chunked_rejects_a_ragged_sequence():
    args = [torch.from_numpy(a) for a in _ssd_inputs(1, 300, 2, 8, 4)]
    with pytest.raises(ValueError, match="multiple"):
        TS.ssd_chunked(*args)


def test_causal_conv_and_split_match_reference():
    jcfg, cfg, jp, tp = _model()
    w = tp["layers"]["conv_w"][0]
    x = np.random.default_rng(1).normal(
        size=(2, 12, w.shape[1])).astype(np.float32)
    state = np.random.default_rng(2).normal(
        size=(2, w.shape[0] - 1, w.shape[1])).astype(np.float32)
    for st in (None, state):
        got, new = TS._causal_conv(torch.from_numpy(x), w,
                                   None if st is None else
                                   torch.from_numpy(st))
        want, jnew = JS._causal_conv(jnp.asarray(x), jp["layers"]["conv_w"][0],
                                     None if st is None else jnp.asarray(st))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))
    z = np.arange(2 * (2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_nheads),
                  dtype=np.float32).reshape(2, -1)
    for a, b in zip(TS._split_proj(cfg, torch.from_numpy(z)),
                    JS._split_proj(jcfg, jnp.asarray(z))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("s", [1, 64, 512])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_forward_matches_reference(s, with_state):
    jcfg, cfg, jp, tp = _model()
    jl = jax.tree.map(lambda a: a[1], jp["layers"])
    tl = {k: v[1] for k, v in tp["layers"].items()}
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        state = (rng.normal(size=(2, cfg.ssm_conv - 1, cfg.d_inner
                                  + 2 * cfg.ssm_state)).astype(np.float32),
                 (rng.normal(size=(2, cfg.ssm_nheads, cfg.ssm_headdim,
                                   cfg.ssm_state)) * 0.1).astype(np.float32))
    out, (conv, h) = TS.ssm_forward(
        tl, torch.from_numpy(x), cfg, state=None if state is None else
        tuple(torch.from_numpy(a) for a in state))
    jout, (jconv, jh) = JS.ssm_forward(
        jl, jnp.asarray(x), jcfg, state=None if state is None else
        tuple(jnp.asarray(a) for a in state))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)
    np.testing.assert_allclose(conv.numpy(), np.asarray(jconv), **F32)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **F32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


def test_init_params_matches_the_reference_tree():
    cfg = get_config(NAME).reduced()
    gen = torch.Generator()
    gen.manual_seed(3)
    tp = TT.init_params(cfg, gen, device="cpu")
    shapes = jax.eval_shape(lambda: JT.init_params(jget(NAME).reduced()))
    assert set(tp["layers"]) == set(shapes["layers"])
    for k, v in tp["layers"].items():
        assert tuple(v.shape) == shapes["layers"][k].shape, k
        assert str(v.dtype).split(".")[-1] == shapes["layers"][k].dtype.name
    for k in ("embed", "lm_head", "final_norm"):
        assert tuple(tp[k].shape) == shapes[k].shape
    n = (sum(v.numel() for k, v in tp.items() if k != "layers")
         + sum(v.numel() for v in tp["layers"].values()))
    # the reference's analytic count leaves out dt_bias (nh a layer)
    assert n == sum(int(np.prod(a.shape))
                    for a in jax.tree.leaves(shapes))
    assert n == cfg.param_count() + cfg.n_layers * cfg.ssm_nheads
    assert get_config(NAME).param_count() == jget(NAME).param_count()


def test_forward_and_prefill_match_reference():
    jcfg, cfg, jp, tp = _model()
    toks = _tokens(cfg, 2, 512, 8)
    got = TT.forward(tp, torch.from_numpy(toks).long(), cfg)
    want = JT.forward(jp, jnp.asarray(toks), jcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 512, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    lg, caches = TT.prefill(tp, torch.from_numpy(toks).long(), cfg)
    jlg, jcaches = JT.prefill(jp, jnp.asarray(toks), jcfg)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGITS)
    for key in ("conv", "ssm"):
        assert tuple(caches[key].shape) == jcaches[key].shape
        np.testing.assert_allclose(caches[key].numpy(),
                                   np.asarray(jcaches[key]), atol=1e-4,
                                   rtol=1e-4)


def _cache_from_prefill(caches, n):
    return [{"conv": caches["conv"][i], "ssm": caches["ssm"][i]}
            for i in range(n)]


def test_decode_after_prefill_matches_reference_and_forward():
    """Prefill 256 tokens, then 16 decode steps: the port's logits equal
    the reference's decode from the reference's prefill (``LOGITS``) and
    the port's own forward over the same 512 tokens (``DECODE_TOL``)."""
    jcfg, cfg, jp, tp = _model()
    toks = _tokens(cfg, 2, 512, 9)
    _, caches = TT.prefill(tp, torch.from_numpy(toks[:, :256]).long(), cfg)
    _, jcaches = JT.prefill(jp, jnp.asarray(toks[:, :256]), jcfg)
    cache = _cache_from_prefill(caches, cfg.n_layers)
    jcache = [{"conv": jcaches["conv"][i], "ssm": jcaches["ssm"][i]}
              for i in range(cfg.n_layers)]
    full = TT.forward(tp, torch.from_numpy(toks).long(), cfg)
    jstep = jax.jit(lambda p, c, tok, cur: JT.decode_step(p, c, tok, cur,
                                                           jcfg))
    for t in range(256, 272):
        lg, cache = TT.decode_step(tp, cache, torch.from_numpy(
            toks[:, t:t + 1]).long(), t, cfg)
        jlg, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.int32(t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGITS)
        np.testing.assert_allclose(lg.numpy(), full[:, t:t + 1].numpy(),
                                   **DECODE_TOL)


def test_decode_from_empty_cache_matches_reference():
    jcfg, cfg, jp, tp = _model()
    toks = _tokens(cfg, 2, 12, 10)
    cache = TT.init_decode_cache(cfg, 2, 64, torch.float32, device="cpu")
    jcache = JT.init_decode_cache(jcfg, 2, 64, jnp.float32)
    assert [tuple(c[k].shape) for c in cache for k in ("conv", "ssm")] == \
        [c[k].shape for c in jcache for k in ("conv", "ssm")]
    for t in range(12):
        lg, cache = TT.decode_step(tp, cache, torch.from_numpy(
            toks[:, t:t + 1]).long(), t, cfg)
        jlg, jcache = JT.decode_step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                     jnp.int32(t), jcfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGITS)


def test_bf16_forward_within_near_tie_rule():
    """The reference's own bfloat16 parameters: the rule of
    ``tests/test_models.py`` (at least 70 % of the positions close within
    0.15, a mean deviation below 0.2)."""
    jcfg, cfg, jp, tp = _model(f32=False)
    assert tp["layers"]["in_proj"].dtype == torch.bfloat16
    assert tp["layers"]["A_log"].dtype == torch.float32
    toks = _tokens(cfg, 1, 256, 11)
    got = TT.forward(tp, torch.from_numpy(toks).long(), cfg).numpy()
    want = np.asarray(JT.forward(jp, jnp.asarray(toks), jcfg))
    close = np.isclose(got, want, rtol=0.15, atol=0.15)
    assert close.all(axis=-1).mean() >= 0.7 and np.abs(got - want).mean() < 0.2


def test_ssm_decode_cache_dtype():
    cfg = dataclasses.replace(get_config(NAME).reduced(), n_layers=2)
    cache = TT.init_decode_cache(cfg, 3, 16, device="cpu")
    assert cache[0]["conv"].dtype == torch.bfloat16
    assert cache[0]["ssm"].dtype == torch.float32
    assert tuple(cache[1]["ssm"].shape) == (3, cfg.ssm_nheads,
                                            cfg.ssm_headdim, cfg.ssm_state)
