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
  ``jax.value_and_grad(repro.models.loss_fn)``:
  ``tests/test_torch_train_grads.py``.
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
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, DataPipeline, synth_batch  # noqa
from repro_torch.distributed import RestartManager  # noqa: E402
from repro_torch.interop import (opt_state_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import init_params, loss_fn  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import flatten_with_paths, tree_map  # noqa: E402

ADAM_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One torch thread for this file's tests: the tier-1 run puts six
    test workers on the machine's cores, where a pool as wide as the cores
    in each only contends with the others (these tests run about 7x
    slower there than alone); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
