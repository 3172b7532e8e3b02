"""The rest of the model zoo — the ``hybrid`` (zamba2-7b), ``vlm``
(llama-3.2-vision-11b) and ``audio`` (hubert-xlarge) families — held
against the JAX reference on reduced configurations, on the CPU.

Parameters come from the reference's ``init_params`` through
``interop.params_from_numpy``; inputs (tokens, frames, image tokens,
labels) from numpy seeds.  On the CPU attention's flash path takes
``flash_attention_plain`` and, under autograd, the plain backward.

Tolerances (those of ``tests/test_torch_models.py`` and
``tests/test_torch_train_grads.py``):

* float32 parameters (the hybrid and the vlm families: the comparison is
  of the algorithm): logits within ``LOGITS`` (2e-4 absolute; 9e-6
  measured), K/V caches and SSM states within ``F32`` (1e-5 absolute
  plus relative), every gradient within ``GRAD_RTOL_F32`` (1e-4) of its
  Frobenius norm (5.9e-6 measured), the loss within 1e-5 relative.
* bfloat16 decode caches: ``BF16_CACHE`` (5e-3 absolute on the logits).
* The audio family only in bfloat16: the reference casts its frames to
  bfloat16, and its layer scan refuses a carry that float32 parameters
  would widen to float32.  The two sides round bfloat16 activations at
  other places, so: logits within 0.1 absolute (0.043 measured on logits
  up to 4.4) with a mean deviation below 0.02 (0.0082 measured); the
  loss within ``LOSS_RTOL`` (1e-2) relative; every gradient within
  ``GRAD_RTOL_BF16`` (5e-2, the dense family's bound) of its Frobenius
  norm (1.8e-2 measured).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import EngineConfig as JConfig  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import (params_from_numpy,  # noqa: E402
                                 params_to_numpy)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import (EngineConfig, Request,  # noqa: E402
                                 ServingEngine)
from repro_torch.tree import flatten_with_paths, tree_map  # noqa: E402

HYBRID, VLM, AUDIO = "zamba2-7b", "llama-3.2-vision-11b", "hubert-xlarge"
ZOO = (HYBRID, VLM, AUDIO)
F32 = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=2e-4, rtol=0)
BF16_CACHE = dict(atol=5e-3, rtol=0)
AUDIO_LOGITS = dict(atol=0.1, mean=0.02)
LOSS_RTOL = 1e-2
GRAD_RTOL_F32 = 1e-4
GRAD_RTOL_BF16 = 5e-2


def _f32(name):
    """The comparison's parameter type: float32 but for the audio
    family (see the module's docstring)."""
    return name != AUDIO


@functools.lru_cache(maxsize=None)
def _ref_params(name, **changes):
    """The reference's own (bfloat16) parameters."""
    return JT.init_params(dataclasses.replace(jget(name).reduced(),
                                              **changes))


@functools.lru_cache(maxsize=None)
def _model(name, **changes):
    jcfg = dataclasses.replace(jget(name).reduced(), **changes)
    cfg = dataclasses.replace(get_config(name).reduced(), **changes)
    jp = _ref_params(name, **changes)
    if _f32(name):
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


def _batch(cfg, b, s, seed, img=True):
    """numpy inputs: tokens (or the audio family's float32 frames),
    labels with the last two positions masked, and a vlm family's image
    tokens."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.audio_frontend:
        out["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[:, -2:] = -1
    out["labels"] = labels
    if cfg.family == "vlm" and img:
        out["img"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _sides(name, batch):
    """The batch for the reference and for the port: ``img`` in the
    parameters' type on both sides."""
    f32 = _f32(name)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if "img" in batch:
        jb["img"] = jb["img"].astype(jnp.float32 if f32 else jnp.bfloat16)
        tb["img"] = tb["img"].to(torch.float32 if f32 else torch.bfloat16)
    if "tokens" in tb:
        tb["tokens"] = tb["tokens"].long()
    return jb, tb


def _close_logits(name, got, want):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if _f32(name):
        np.testing.assert_allclose(got, want, **LOGITS)
    else:
        err = np.abs(got - want)
        assert err.max() <= AUDIO_LOGITS["atol"], err.max()
        assert err.mean() <= AUDIO_LOGITS["mean"], err.mean()


# -- the trees --------------------------------------------------------------


@pytest.mark.parametrize("name", ZOO)
def test_family_trees(name):
    """What each family's tree holds (its keys, shapes and dtypes against
    the reference's: ``tests/test_torch_models.py::
    test_init_params_builds_the_reference_tree``): the hybrid's layers
    carry only ``ln1`` and the SSM weights, and one ``shared_attn`` block
    sits at the top; every vlm layer carries the cross weights ``cwq``
    ... ``cwo`` and ``cln``; the audio family has neither."""
    cfg = get_config(name).reduced()
    gen = torch.Generator()
    gen.manual_seed(5)
    tp = TT.init_params(cfg, gen, device="cpu")
    layers = set(tp["layers"])
    cross = {"cwq", "cwk", "cwv", "cwo", "cln"}
    if cfg.family == "hybrid":
        assert layers == {"ln1", "in_proj", "conv_w", "A_log", "D",
                          "dt_bias", "ssm_norm", "out_proj"}
        assert set(tp["shared_attn"]) == {"ln1", "ln2", "wq", "wk", "wv",
                                          "wo", "w_gate", "w_up", "w_down"}
        assert tp["shared_attn"]["wq"].shape == (cfg.d_model,
                                                 cfg.n_heads * cfg.hd)
    else:
        assert "shared_attn" not in tp
        assert (cross <= layers) == (cfg.family == "vlm")
        if cfg.family == "vlm":
            assert all(tp["layers"][k].shape[0] == cfg.n_layers
                       for k in cross)


def test_params_from_numpy_carries_the_shared_block():
    """The nested ``shared_attn`` tree crosses over leaf by leaf with its
    bits, and comes back unchanged."""
    jp = jax.tree.map(np.asarray, _ref_params(HYBRID))
    tp = params_from_numpy(jp, device="cpu")
    assert set(tp["shared_attn"]) == set(jp["shared_attn"])
    for k, v in jp["shared_attn"].items():
        assert tp["shared_attn"][k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp["shared_attn"][k].float().numpy(), v.astype(np.float32))
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# -- forward, loss and gradients --------------------------------------------


@pytest.mark.parametrize("name,img", [(HYBRID, True), (VLM, True),
                                      (VLM, False), (AUDIO, True)])
def test_forward_matches_reference(name, img):
    """Tokens (frames for the audio family), and for the vlm family the
    image tokens or none (a cross layer then attends to its own
    input)."""
    jcfg, cfg, jp, tp = _model(name)
    jb, tb = _sides(name, _batch(cfg, 2, 24, 8, img=img))
    got = TT.forward(tp, tb.get("tokens"), cfg, img=tb.get("img"),
                     frames=tb.get("frames"))
    want = JT.forward(jp, jb.get("tokens"), jcfg, img=jb.get("img"),
                      frames=jb.get("frames"))
    assert got.dtype == torch.float32 and got.shape == (2, 24, cfg.vocab)
    _close_logits(name, got, want)


@pytest.mark.parametrize("name", ZOO)
def test_loss_and_grads_match_reference(name):
    """``loss_fn`` and the gradient of every leaf (the audio family's
    ``embed``, which its loss never reads, included: zero on both sides)
    against ``jax.value_and_grad``, with remat on."""
    jcfg, cfg, jp, tp = _model(name)
    assert cfg.remat
    jb, tb = _sides(name, _batch(cfg, 2, 16, 1))
    jl, jg = jax.value_and_grad(JT.loss_fn)(jp, jb, jcfg)
    leaves_t = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    loss = TT.loss_fn(leaves_t, tb, cfg)
    paths = [k for k, _ in flatten_with_paths(leaves_t)]
    grads = torch.autograd.grad(loss, [t for _, t in
                                       flatten_with_paths(leaves_t)],
                                allow_unused=True, materialize_grads=True)
    want = dict(flatten_with_paths(params_from_numpy(
        jax.tree.map(np.asarray, jg), device="cpu")))
    assert set(paths) == set(want)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=1e-5 if _f32(name) else LOSS_RTOL)
    rtol = GRAD_RTOL_F32 if _f32(name) else GRAD_RTOL_BF16
    for k, g in zip(paths, grads):
        w = want[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        err = float((g.float() - w.float()).norm()) / max(
            float(w.float().norm()), 1e-30)
        assert err <= rtol, (k, err)
    if cfg.audio_frontend:
        assert float(want["embed"].float().abs().max()) == 0.0
        assert float(grads[paths.index("embed")].abs().max()) == 0.0


@pytest.mark.parametrize("name", ZOO)
def test_prefill_matches_reference(name):
    """The last position's logits and the caches: the hybrid's final
    conv and SSM states (no K/V for its shared block, as the reference
    emits none), the vlm's roped K/V of every layer, cross layers
    included, the audio encoder's K/V."""
    jcfg, cfg, jp, tp = _model(name)
    jb, tb = _sides(name, _batch(cfg, 2, 24, 2))
    lg, caches = TT.prefill(tp, tb.get("tokens"), cfg, img=tb.get("img"),
                            frames=tb.get("frames"))
    jlg, jcaches = JT.prefill(jp, jb.get("tokens"), jcfg, img=jb.get("img"),
                              frames=jb.get("frames"))
    _close_logits(name, lg, jlg)
    assert set(caches) == set(jcaches) == (
        {"ssm", "conv"} if cfg.family == "hybrid" else {"k", "v"})
    for key in caches:
        got = caches[key].float().numpy()
        want = np.asarray(jnp.asarray(jcaches[key], jnp.float32))
        assert got.shape == want.shape, key
        if _f32(name):
            np.testing.assert_allclose(got, want, **F32)
        else:
            # bfloat16 K/V: layer 0's are the same roundings of the
            # frames' projection; the later layers' inputs carry the
            # activations' rounding differences (logits' bound)
            np.testing.assert_allclose(got[0], want[0], atol=2e-2, rtol=0)
            assert np.abs(got - want).mean() <= AUDIO_LOGITS["mean"]


@pytest.mark.parametrize("name,img,cache_dtype", [
    (HYBRID, False, "float32"), (HYBRID, False, "bfloat16"),
    (VLM, True, "float32"), (VLM, False, "bfloat16")])
def test_decode_steps_match_reference(name, img, cache_dtype):
    """8 steps from an empty cache through the reference's
    ``decode_step`` and the port's: the hybrid's shared block on its own
    K/V caches, a vlm cross layer over the image tokens (or over the
    token itself) leaving its cache entry as it was."""
    jcfg, cfg, jp, tp = _model(name)
    batch = _batch(cfg, 2, 8, 9, img=img)
    jb, tb = _sides(name, batch)
    cache = TT.init_decode_cache(cfg, 2, 16, getattr(torch, cache_dtype),
                                 device="cpu")
    jcache = JT.init_decode_cache(jcfg, 2, 16, getattr(jnp, cache_dtype))
    assert [sorted(c) for c in cache] == [sorted(c) for c in jcache]
    for c, jc in zip(cache, jcache):
        assert all(tuple(c[k].shape) == jc[k].shape for k in c)
    if cfg.family == "hybrid":
        shared = [i for i, c in enumerate(cache) if "k" in c]
        assert shared == [i for i in range(cfg.n_layers)
                          if (i + 1) % cfg.shared_attn_every == 0]
    tol = LOGITS if cache_dtype == "float32" else BF16_CACHE
    jstep = jax.jit(lambda p, c, tok, cur, im: JT.decode_step(
        p, c, tok, cur, jcfg, img=im))
    toks = batch["tokens"]
    cross = [i for i in range(cfg.n_layers) if cfg.cross_attn_every and
             (i + 1) % cfg.cross_attn_every == 0]
    for t in range(8):
        before = [cache[i]["k"].clone() for i in cross]
        lg, cache = TT.decode_step(tp, cache, torch.from_numpy(
            toks[:, t:t + 1]).long(), t, cfg, img=tb.get("img"))
        jlg, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.int32(t), jb.get("img"))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **tol)
        assert all(torch.equal(cache[i]["k"], b)
                   for i, b in zip(cross, before))


def test_hybrid_shared_block_takes_the_flash_path_at_hd112(monkeypatch):
    """zamba2-7b's head width of 112 at 2,048 tokens: the shared block
    (one invocation in two layers) takes the flash path, as B7 at hd 112
    does on the card, and the forward and the prefill's last logits
    match the reference's."""
    jcfg, cfg, jp, tp = _model(HYBRID, head_dim=112, n_layers=2)
    assert cfg.hd == 112 and cfg.shared_attn_every == 2
    calls = []
    real = TL.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), kw["causal"], kw["window"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(TL, "flash_attention", spy)
    toks = _batch(cfg, 1, 2048, 21)["tokens"]
    got = TT.forward(tp, torch.from_numpy(toks).long(), cfg)
    assert calls == [((1, cfg.n_heads, 2048, 112), True, 0)]
    want = np.asarray(JT.forward(jp, jnp.asarray(toks), jcfg))
    np.testing.assert_allclose(got.numpy(), want, **LOGITS)
    lg, caches = TT.prefill(tp, torch.from_numpy(toks).long(), cfg)
    np.testing.assert_allclose(lg.numpy(), want[:, -1:], **LOGITS)
    assert len(calls) == 2


def test_audio_encoder_flash_path_is_unmasked(monkeypatch):
    """hubert-xlarge at 2,048 frames, one layer, under autograd: the
    encoder's attention takes the flash path with its backward, no
    causal mask, and the loss and gradients match the reference's
    (bfloat16 tolerances)."""
    jcfg, cfg, jp, tp = _model(AUDIO, n_layers=1)
    calls = []
    real = TL.flash_attention_train

    def spy(q, k, v, **kw):
        calls.append(kw["causal"])
        return real(q, k, v, **kw)

    monkeypatch.setattr(TL, "flash_attention_train", spy)
    jb, tb = _sides(AUDIO, _batch(cfg, 1, 2048, 3))
    jl, jg = jax.value_and_grad(JT.loss_fn)(jp, jb, jcfg)
    leaves_t = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    loss = TT.loss_fn(leaves_t, tb, cfg)
    grads = dict(zip([k for k, _ in flatten_with_paths(leaves_t)],
                     torch.autograd.grad(
                         loss, [t for _, t in flatten_with_paths(leaves_t)],
                         allow_unused=True, materialize_grads=True)))
    assert calls == [False, False]      # the forward and its remat
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    want = dict(flatten_with_paths(params_from_numpy(
        jax.tree.map(np.asarray, jg), device="cpu")))
    for k, w in want.items():
        if k == "embed":
            continue
        err = float((grads[k].float() - w.float()).norm()) / max(
            float(w.float().norm()), 1e-30)
        assert err <= GRAD_RTOL_BF16, (k, err)


# -- serving ----------------------------------------------------------------


def _serve(port, name, trace, ecfg_kw):
    """``ServingEngine`` over ``trace`` on one side: the engine, its
    requests and the logits of every decode step."""
    jcfg, cfg, jp, tp = _model(name)
    eng = (ServingEngine(cfg, tp, EngineConfig(**ecfg_kw), device="cpu")
           if port else JEngine(jcfg, jp, JConfig(**ecfg_kw)))
    logits, step = [], eng._step

    def recording(p, c, t, cur):
        lg, nc = step(p, c, t, cur)
        logits.append(np.asarray(lg[:, -1].float() if port else lg[:, -1]))
        return lg, nc

    eng._step = recording
    make = Request if port else JRequest
    reqs = [make(rid=rid, prompt=prompt, max_new_tokens=new)
            for rid, prompt, new in trace]
    for r in reqs:
        assert eng.submit(r)
    eng.run(max_ticks=2000)
    return eng, reqs, logits


@pytest.mark.parametrize("name", [HYBRID, VLM])
def test_serving_engine_matches_reference(name):
    """``launch/serve.py``'s trace (8 requests of 6 prompt and 8 new
    tokens, 4 slots, 32 pages of 32 tokens, max_seq 64) through both
    engines: the same metrics, admission order, ticks and per-request
    record; every step's logits within ``BF16_CACHE`` (the engine's
    caches are bfloat16) and the same tokens wherever the reference's
    top-2 margin exceeds it."""
    cfg = get_config(name).reduced()
    rng = np.random.default_rng(0)
    trace = [(rid, rng.integers(0, cfg.vocab, 6).astype(np.int32), 8)
             for rid in range(8)]
    ecfg = dict(max_slots=4, num_pages=32, page_size=32, max_seq=64)
    j, jreqs, jlog = _serve(False, name, trace, ecfg)
    t, treqs, tlog = _serve(True, name, trace, ecfg)
    assert t.metrics == j.metrics and t.metrics["completed"] == 8
    assert t.admission_log == j.admission_log and t.tick == j.tick
    for a, b in zip(treqs, jreqs):
        assert (a.submit_tick, a.admit_tick, a.finish_tick, a.done,
                len(a.out)) == (b.submit_tick, b.admit_tick, b.finish_tick,
                                b.done, len(b.out))
    assert len(tlog) == len(jlog) == j.metrics["decode_steps"]
    rows = compared = 0
    for lt, lj in zip(tlog, jlog):
        np.testing.assert_allclose(lt, lj, **BF16_CACHE)
        top2 = np.sort(lj, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > BF16_CACHE["atol"]
        np.testing.assert_array_equal(lt.argmax(-1)[clear],
                                      lj.argmax(-1)[clear])
        rows += len(clear)
        compared += int(clear.sum())
    assert compared >= 0.9 * rows, (compared, rows)
