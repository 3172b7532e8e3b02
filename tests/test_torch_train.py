"""The port's training path (``repro_torch.data``, ``repro_torch.optim``,
``repro_torch.models.loss_fn``, ``repro_torch.launch.train``) held
against the JAX reference.

* ``synth_batch`` and ``DataPipeline`` give the reference's batches bit
  for bit (both draw with numpy).
* ``adamw.step`` on the reference's ``OptState`` and float32 gradients
  (carried across by ``interop.opt_state_from_numpy``) equals the
  reference's step within 1e-6 relative (``ADAM_RTOL``) over three steps:
  the same float32 operations in the same order, save the order of the
  gradient norm's sum over leaves.
* ``loss_fn`` and its gradient against
  ``jax.value_and_grad(repro.models.loss_fn)``.  At the reference's
  parameters cast to float32 (the algorithm): every leaf's gradient
  within ``GRAD_RTOL_F32`` (1e-4) of its Frobenius norm (measured up to
  3.5e-5, mamba2 at two chunks).  At its bfloat16 parameters (what
  training runs): the loss within ``LOSS_RTOL`` (1e-2) relative, every
  leaf's gradient within ``GRAD_RTOL`` of its Frobenius norm: 5e-2 for
  the dense model (measured up to 2.0e-2), 1e-1 for the MoE model (3.2e-2;
  a routing choice on a near tie may flip between the two sides) and for
  mamba2 (6.4e-2: XLA keeps the conv, gate and norm chains in float32
  inside its fusions where PyTorch rounds every bfloat16 op).  The flash
  path's logits are float32 in the port (the Pallas kernel's) and
  bfloat16 in the reference's XLA path.
* The restart test of ``tests/test_system.py`` and
  ``tests/test_models.py::test_training_reduces_loss`` on the port.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, DataPipeline, synth_batch  # noqa
from repro_torch.distributed import RestartManager  # noqa: E402
from repro_torch.interop import (opt_state_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import init_params, loss_fn  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import flatten_with_paths, tree_map  # noqa: E402

ADAM_RTOL = 1e-6
LOSS_RTOL = 1e-2
GRAD_RTOL = {"dense": 5e-2, "ssm": 1e-1, "moe": 1e-1}
GRAD_RTOL_F32 = 1e-4


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "mamba2-130m",
                                  "hubert-xlarge", "llama-3.2-vision-11b"])
def test_synth_batch_bit_identical(name):
    cfg, jcfg = get_config(name).reduced(), jget(name).reduced()
    for seed, step in ((0, 0), (0, 7), (3, 1 << 10)):
        dcfg = DataConfig(seq_len=16, global_batch=3, seed=seed)
        jdcfg = jpipe.DataConfig(seq_len=16, global_batch=3, seed=seed)
        got, want = synth_batch(cfg, dcfg, step), jpipe.synth_batch(
            jcfg, jdcfg, step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_delivers_the_reference_stream_in_order():
    cfg = get_config("h2o-danube-1.8b").reduced()
    dcfg = DataConfig(seq_len=8, global_batch=2, prefetch=2,
                      num_producer_threads=3)
    got = list(DataPipeline(cfg, dcfg, 10).start())
    want = list(jpipe.DataPipeline(jget("h2o-danube-1.8b").reduced(),
                                   jpipe.DataConfig(seq_len=8, global_batch=2,
                                                    prefetch=2), 10).start())
    assert [s for s, _ in got] == list(range(10)) == [s for s, _ in want]
    for (_, a), (_, b) in zip(got, want):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


# -- optimizer ----------------------------------------------------------------


def _ref_grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape).astype(np.float32)), params)


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_step_matches_reference(clip):
    """Three steps from the reference's state on random float32 gradients
    (the norm clipped, or not), warm-up and cosine in play."""
    jcfg = jget("mamba2-130m").reduced()
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=5,
                             clip_norm=clip)
    jocfg = jadamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=5,
                               clip_norm=clip)
    jst = jadamw.init(jinit(jcfg))
    st = opt_state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    assert st.master["layers"]["A_log"].dtype == torch.float32
    for i in range(3):
        g = _ref_grads(jst.master, i)
        jst, jm = jadamw.step(jocfg, jst, g)
        st, m = adamw.step(ocfg, st, params_from_numpy(
            jax.tree.map(np.asarray, g), device="cpu"))
        assert int(st.step) == int(jst.step) == i + 1
        assert st.step.dtype == torch.int32
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=ADAM_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=ADAM_RTOL)
        want = opt_state_from_numpy(jax.tree.map(np.asarray, jst),
                                    device="cpu")
        for (k, a), (_, b) in zip(flatten_with_paths(st),
                                  flatten_with_paths(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=ADAM_RTOL,
                                       atol=ADAM_RTOL * float(
                                           b.abs().max()), err_msg=k)


def test_schedule_norm_and_cast_match_reference():
    ocfg = adamw.AdamWConfig(warmup_steps=10, total_steps=100)
    jocfg = jadamw.AdamWConfig(warmup_steps=10, total_steps=100)
    for s in (0, 1, 9, 10, 11, 55, 100, 150):
        np.testing.assert_allclose(
            float(adamw.schedule(ocfg, torch.tensor(s, dtype=torch.int32))),
            float(jadamw.schedule(jocfg, jnp.int32(s))), rtol=1e-7)
    g = _ref_grads({"a": jnp.zeros((3, 5)), "b": [jnp.zeros(7)]}, 5)
    tg = params_from_numpy(jax.tree.map(np.asarray, g), device="cpu")
    np.testing.assert_allclose(float(adamw.global_norm(tg)),
                               float(jadamw.global_norm(g)), rtol=1e-6)
    master = {"w": torch.ones(2), "i": torch.ones(2, dtype=torch.int32)}
    cast = adamw.cast_params(master)
    assert cast["w"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int32


# -- loss and gradients -------------------------------------------------------


def _loss_and_grads(name, b, s, seed, changes=None, f32=False):
    changes = changes or {}
    jcfg = dataclasses.replace(jget(name).reduced(), **changes)
    cfg = dataclasses.replace(get_config(name).reduced(), **changes)
    jp = jinit(jcfg)
    if f32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (2, b, s))
    labels = toks[1].astype(np.int32)
    labels[:, -2:] = -1                       # masked positions
    batch = {"tokens": toks[0].astype(np.int32), "labels": labels}
    jl, jg = jax.value_and_grad(jloss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tp = tree_map(lambda t: t.requires_grad_(),
                  params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu"))
    loss = loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                   cfg)
    leaves = [t for _, t in flatten_with_paths(tp)]
    grads = dict(zip([k for k, _ in flatten_with_paths(tp)],
                     torch.autograd.grad(loss, leaves)))
    want = dict(flatten_with_paths(params_from_numpy(
        jax.tree.map(np.asarray, jg), device="cpu")))
    return cfg, float(loss.detach()), float(jl), grads, want


def _check_grads(cfg, grads, want, rtol=None):
    rtol = rtol or GRAD_RTOL[cfg.family]
    for k, w in want.items():
        g = grads[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        w32, g32 = w.float(), g.float()
        err = float((g32 - w32).norm()) / max(float(w32.norm()), 1e-30)
        assert err <= rtol, (k, err)


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "granite-moe-3b-a800m",
                                  "mamba2-130m"])
def test_loss_and_grads_match_reference_dense_path(name):
    """2 x 16 tokens: attention takes the dense path (autograd)."""
    cfg, loss, jl, grads, want = _loss_and_grads(name, 2, 16, 1)
    np.testing.assert_allclose(loss, jl, rtol=LOSS_RTOL)
    _check_grads(cfg, grads, want)


@pytest.mark.parametrize("name,s", [("h2o-danube-1.8b", 16),
                                    ("granite-moe-3b-a800m", 16),
                                    ("mamba2-130m", 16), ("mamba2-130m", 512)])
def test_float32_grads_match_reference(name, s):
    """The reference's parameters in float32: the same gradients up to
    the order of float32 sums (mamba2 at 512 tokens crosses a chunk)."""
    cfg, loss, jl, grads, want = _loss_and_grads(name, 2, s, 1, f32=True)
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    _check_grads(cfg, grads, want, rtol=GRAD_RTOL_F32)


def test_loss_and_grads_match_reference_flash_path(monkeypatch):
    """1 x 2,048 tokens for h2o-danube-1.8b: attention takes the flash
    path on both sides (the port's autograd Function, plain forward and
    backward on the CPU; the reference's custom_vjp ``_flash_core``), with
    512-row blocks, so several block pairs and the window's edge run."""
    calls = []
    real = TL.flash_attention_train

    def spy(*a, **kw):
        calls.append(kw["window"])
        return real(*a, **kw)

    monkeypatch.setattr(TL, "flash_attention_train", spy)
    cfg, loss, jl, grads, want = _loss_and_grads(
        "h2o-danube-1.8b", 1, 2048, 2, changes={"n_layers": 2,
                                                "sliding_window": 700})
    assert calls == [700] * 4      # each layer's forward and its remat
    np.testing.assert_allclose(loss, jl, rtol=LOSS_RTOL)
    _check_grads(cfg, grads, want)


def test_loss_and_grads_match_reference_flash_path_hd256(monkeypatch):
    """gemma3-4b's head width on the flash path: 1 x 2,048 tokens, a local
    layer (window 700) and a global one, hd 256, each taking the port's
    autograd Function (plain forward and backward on the CPU) against the
    reference's custom_vjp ``_flash_core``."""
    calls = []
    real = TL.flash_attention_train

    def spy(*a, **kw):
        calls.append((a[0].shape[-1], kw["window"]))
        return real(*a, **kw)

    monkeypatch.setattr(TL, "flash_attention_train", spy)
    cfg, loss, jl, grads, want = _loss_and_grads(
        "gemma3-4b", 1, 2048, 3, changes={
            "head_dim": 256, "layer_pattern": ("local", "global"),
            "n_layers": 2, "sliding_window": 700})
    # each layer's forward, then its remat in the backward (last first)
    assert calls == [(256, 700), (256, 0), (256, 0), (256, 700)]
    np.testing.assert_allclose(loss, jl, rtol=LOSS_RTOL)
    _check_grads(cfg, grads, want)


def test_loss_gradient_reuses_the_logits_once():
    """``loss_fn``'s gradient is written over the logits it saved, so it
    equals autograd's logsumexp-and-gather gradient and a second backward
    through the same graph raises."""
    cfg = get_config("h2o-danube-1.8b").reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = tree_map(lambda t: t.float().requires_grad_(),
                  init_params(cfg, gen, device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 2, 16)))
    labels = toks[1].clone()
    labels[:, -3:] = -1
    batch = {"tokens": toks[0], "labels": labels}
    loss = loss_fn(tp, batch, cfg)
    leaves = [t for _, t in flatten_with_paths(tp)]
    got = torch.autograd.grad(loss, leaves, retain_graph=True)
    with pytest.raises(RuntimeError, match="once"):
        torch.autograd.grad(loss, leaves)
    from repro_torch.models import forward
    logits = forward(tp, batch["tokens"], cfg)
    lab = labels.long()
    nll = (torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, lab.clamp(min=0)[..., None])[..., 0])
    mask = (lab >= 0).float()
    ref_loss = torch.sum(nll * mask) / torch.sum(mask)
    torch.testing.assert_close(loss, ref_loss, rtol=0, atol=0)
    want = torch.autograd.grad(ref_loss, leaves)
    # the two round (softmax - one-hot) g in another order: float32 sums
    # apart, 1e-5 of each leaf's largest gradient
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


def test_remat_gives_the_same_gradients():
    """``cfg.remat`` recomputes each layer in the backward: the same
    numbers as keeping the activations."""
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(get_config("h2o-danube-1.8b").reduced(),
                                  remat=remat)
        gen = torch.Generator()
        gen.manual_seed(0)
        tp = tree_map(lambda t: t.requires_grad_(),
                      init_params(cfg, gen, device="cpu"))
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (2, 2, 16)))
        loss = loss_fn(tp, {"tokens": toks[0], "labels": toks[1]}, cfg)
        out.append([loss] + list(torch.autograd.grad(
            loss, [t for _, t in flatten_with_paths(tp)])))
    for a, b in zip(*out):
        assert torch.equal(a, b)


# -- the loop -----------------------------------------------------------------


def test_train_restart_end_to_end(tmp_path):
    """``tests/test_system.py``'s restart test on the port: an injected
    fault at step 13, a restart from the step-10 checkpoint, the final
    step and the optimizer's step preserved, the loss lower."""
    cfg = get_config("mamba2-130m").reduced()
    dcfg = DataConfig(seq_len=16, global_batch=4, prefetch=4)
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=30)
    num_steps = 20
    gen = torch.Generator()
    gen.manual_seed(0)
    state = adamw.init(init_params(cfg, gen, device="cpu"))
    losses = {}

    def step_fn(state, i):
        b = train.batch_to_device(synth_batch(cfg, dcfg, i % 2), "cpu")
        state, metrics = train.train_step(cfg, ocfg, state, b)
        losses[i] = float(metrics["loss"])
        return state

    ckpt = CheckpointManager(str(tmp_path), async_write=True)
    rm = RestartManager(ckpt, save_every=5, max_restarts=2)
    final_step, state = rm.run(state, step_fn, num_steps=num_steps,
                               inject_fault_at=13)
    assert final_step == num_steps
    assert rm.restarts == 1
    assert losses[num_steps - 2] < losses[0]
    assert int(state.step) == num_steps
    assert ckpt.list_steps() == [10, 15, 20]


def test_training_reduces_loss():
    """``tests/test_models.py::test_training_reduces_loss`` on the port:
    eight AdamW steps on one batch lower the loss by more than 0.2."""
    cfg = get_config("h2o-danube-1.8b").reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    state = adamw.init(init_params(cfg, gen, device="cpu"))
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=40)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)),
        "labels": torch.from_numpy(
            rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))}
    losses = []
    for _ in range(8):
        state, m = train.train_step(cfg, ocfg, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses


def test_launch_train_runs_in_process(tmp_path, capsys):
    out = train.main(["--arch", "mamba2-130m-smoke", "--device", "cpu",
                      "--steps", "4", "--seq", "16", "--batch", "2"])
    assert out["step"] == 4 and out["restarts"] == 0
    assert int(out["state"].step) == 4
    assert all(np.isfinite(v) for v in out["losses"].values())
    text = capsys.readouterr().out
    assert "arch=mamba2-130m-smoke" in text and text.strip().endswith("done")
    out = train.main(["--arch", "h2o-danube-1.8b", "--device", "cpu",
                      "--steps", "6", "--seq", "16", "--batch", "2",
                      "--ckpt-dir", str(tmp_path), "--save-every", "2",
                      "--inject-fault-at", "3"])
    assert out["step"] == 6 and out["restarts"] == 1
    assert int(out["state"].step) == 6
    assert "done at step 6 (restarts: 1)" in capsys.readouterr().out
