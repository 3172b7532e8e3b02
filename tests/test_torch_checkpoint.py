"""The port's gradient compression, checkpoints and fault tolerance
(``repro_torch.distributed.compression``, ``repro_torch.checkpoint``,
``repro_torch.distributed.fault_tolerance``) against the JAX reference.

* The int8 codes and the per-block scales are bit-identical to the
  reference's on the same float32 input; the dequantized payload and the
  residual within 1 ulp of float32 (XLA may contract the residual's
  product and difference into a fused multiply-add).
* Checkpoints are interchangeable: each package restores an ``OptState``
  the other wrote, bit for bit, into its own tree types.
* The restart manager, the straggler detector and the elastic plans
  follow the reference's own cases (``tests/test_distributed.py``).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.checkpoint.manager import CheckpointManager as JCkpt  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.distributed import fault_tolerance as jft  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.distributed import (RestartManager,  # noqa: E402
                                     StragglerDetector, elastic_mesh_plan)
from repro_torch.interop import (opt_state_from_numpy,  # noqa: E402
                                 opt_state_to_numpy)
from repro_torch.optim import OptState  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402


def _grad(n, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=n) * scale).astype(
        np.float32)


# -- compression -------------------------------------------------------------


@pytest.mark.parametrize("n,scale", [(256, 1.0), (1000, 3.0), (4096, 1e-3),
                                     (70000, 50.0)])
def test_quantize_codes_and_scales_bit_exact(n, scale):
    x = _grad(n, n, scale)
    x[:7] = 0.0                  # a zero run and a block with exact ties
    x[300:310] = np.float32(0.5)
    q, s = compression.quantize(torch.from_numpy(x))
    jq, js = jcomp.quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = compression.dequantize(q, s, (n,)).numpy()
    np.testing.assert_array_equal(back, np.asarray(
        jcomp.dequantize(jq, js, (n,))))


def test_compress_with_feedback_matches_reference():
    g = _grad((3, 333), 1)
    err = _grad((3, 333), 2, 1e-3)
    deq, new_err = compression.compress_with_feedback(torch.from_numpy(g),
                                                      torch.from_numpy(err))
    jdeq, jerr = jcomp.compress_with_feedback(jnp.asarray(g),
                                              jnp.asarray(err))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    np.testing.assert_allclose(new_err.numpy(), np.asarray(jerr), rtol=0,
                               atol=float(np.spacing(np.abs(g).max())))
    tree = {"a": torch.from_numpy(g), "b": [torch.from_numpy(err)]}
    errs = compression.init_feedback(tree)
    deqs, errs = compression.tree_compress_with_feedback(tree, errs)
    assert torch.equal(deqs["a"], compression.compress_with_feedback(
        tree["a"], torch.zeros_like(tree["a"]))[0])
    assert errs["b"][0].shape == err.shape
    assert compression.compression_ratio() == jcomp.compression_ratio()


def test_compression_error_feedback_converges():
    """The reference's case: the running mean of the compressed payload
    tracks the true gradient and the carried error stays bounded."""
    g_true = torch.from_numpy(_grad(1024, 0))
    err = torch.zeros_like(g_true)
    acc = torch.zeros_like(g_true)
    for _ in range(50):
        deq, err = compression.compress_with_feedback(g_true, err)
        acc = acc + deq
    drift = float((acc / 50 - g_true).abs().max())
    assert drift < 2e-2, drift
    assert float(err.abs().max()) < float(g_true.abs().max())
    assert compression.compression_ratio() < 0.27


def test_quantize_roundtrip_scale():
    x = torch.from_numpy(np.linspace(-3, 3, 512).astype(np.float32))
    q, s = compression.quantize(x)
    back = compression.dequantize(q, s, x.shape)
    assert float((back - x).abs().max()) <= float(x.abs().max()) / 127 + 1e-6


# -- checkpoints --------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), async_write=False)
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32)},
            "d": [torch.zeros(2, dtype=torch.bfloat16) + 1.5]}
    ckpt.save(7, tree)
    step, restored = ckpt.restore(tree)
    assert step == 7
    for (k1, a), (k2, b) in zip(flatten_with_paths(restored),
                                flatten_with_paths(tree)):
        assert k1 == k2 and a.dtype == b.dtype and torch.equal(a, b)
    assert sorted(os.listdir(tmp_path / "step_00000007")) == [
        "host0.npz", "manifest.json"]


def test_checkpoint_gc_keeps_latest(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        ckpt.save(s, {"x": torch.full((2,), float(s))})
    assert ckpt.list_steps() == [3, 4]
    assert ckpt.latest_step() == 4


def test_async_checkpoint_commits(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), async_write=True)
    x = torch.zeros(4)
    ckpt.save(1, {"x": x})
    x += 5                      # the snapshot was taken when save returned
    ckpt.wait()
    assert ckpt.latest_step() == 1
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    assert torch.equal(ckpt.restore({"x": x})[1]["x"], torch.zeros(4))


def test_restore_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path), async_write=False).restore(
            {"x": torch.zeros(1)})


def _ref_opt_state():
    cfg = jget("mamba2-130m").reduced()
    st = jadamw.init(jinit(cfg))
    rng = np.random.default_rng(4)
    # moments and a step that are not the initial zeros
    st = st._replace(
        m=jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape).astype(np.float32)), st.m),
        v=jax.tree.map(lambda a: jnp.asarray(
            rng.random(a.shape).astype(np.float32)), st.v),
        step=jnp.int32(17))
    return st


def test_checkpoint_keys_are_the_reference_paths(tmp_path):
    st = _ref_opt_state()
    port = opt_state_from_numpy(jax.tree.map(np.asarray, st), device="cpu")
    keys = [k for k, _ in flatten_with_paths(port)]
    assert ".master/layers/in_proj" in keys and ".step" in keys
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    JCkpt(str(jdir), async_write=False).save(3, st)
    CheckpointManager(str(tdir), async_write=False).save(3, port)
    with np.load(jdir / "step_00000003" / "host0.npz") as a, \
            np.load(tdir / "step_00000003" / "host0.npz") as b:
        assert sorted(a.files) == sorted(b.files) == sorted(keys)


def test_port_restores_reference_checkpoint(tmp_path):
    st = _ref_opt_state()
    JCkpt(str(tmp_path), async_write=False).save(5, st)
    like = opt_state_from_numpy(jax.tree.map(
        lambda a: np.zeros_like(np.asarray(a)), st), device="cpu")
    step, got = CheckpointManager(str(tmp_path), async_write=False).restore(
        like)
    assert step == 5 and isinstance(got, OptState)
    assert got.step.dtype == torch.int32 and int(got.step) == 17
    for (k, a), b in zip(flatten_with_paths(got),
                         jax.tree.leaves(opt_state_to_numpy_ref(st))):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)


def opt_state_to_numpy_ref(st):
    """The reference's leaves in the port's tree order (dict insertion
    order, which the reference's init also uses)."""
    port = opt_state_from_numpy(jax.tree.map(np.asarray, st), device="cpu")
    return [t.numpy() for _, t in flatten_with_paths(port)]


def test_reference_restores_port_checkpoint(tmp_path):
    st = _ref_opt_state()
    port = opt_state_from_numpy(jax.tree.map(np.asarray, st), device="cpu")
    ckpt = CheckpointManager(str(tmp_path), async_write=True)
    ckpt.save(9, port)
    ckpt.wait()
    like = jax.tree.map(jnp.zeros_like, st)
    step, got = JCkpt(str(tmp_path), async_write=False).restore(like)
    assert step == 9
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(st)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and the interop round trip keeps every leaf
    back = opt_state_to_numpy(port)
    for a, b in zip(jax.tree.leaves(jadamw.OptState(*back)),
                    jax.tree.leaves(st)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- fault tolerance ----------------------------------------------------------


def test_restart_manager_recovers_from_fault(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), async_write=False)

    def step_fn(state, i):
        return {"x": state["x"] + 1}

    rm = RestartManager(ckpt, save_every=5, max_restarts=2)
    final_step, state = rm.run({"x": torch.zeros(())}, step_fn,
                               num_steps=20, inject_fault_at=12)
    assert final_step == 20
    assert rm.restarts == 1
    # after the restart from step 10, steps 10-11 run again: still 20
    assert int(state["x"]) == 20


def test_restart_manager_gives_up_after_budget(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), async_write=False)

    def step_fn(state, i):
        if i == 3:
            raise RuntimeError("a persistent fault")
        return state

    rm = RestartManager(ckpt, save_every=2, max_restarts=2)
    with pytest.raises(RuntimeError, match="persistent"):
        rm.run({"x": torch.zeros(())}, step_fn, num_steps=6)
    assert rm.restarts == 3


def test_restart_without_checkpoint_restarts_from_start(tmp_path):
    """A fault before the first save: the reference restarts from
    start_step with the state it holds; so does the port."""
    def run(mgr_cls, ckpt_cls, zeros):
        seen = []

        def step_fn(state, i):
            seen.append(i)
            return state

        rm = mgr_cls(ckpt_cls(str(tmp_path / mgr_cls.__module__),
                              async_write=False), save_every=10)
        final, _ = rm.run({"x": zeros}, step_fn, num_steps=4,
                          inject_fault_at=2)
        return final, rm.restarts, seen

    assert run(RestartManager, CheckpointManager, torch.zeros(())) == run(
        jft.RestartManager, JCkpt, jnp.zeros(()))


def test_straggler_detection_and_plan():
    reports = []
    for mod in (StragglerDetector, jft.StragglerDetector):
        det = mod(n_pods=4, threshold=1.5)
        rep, all_reps = None, []
        for step in range(20):
            for pod in range(4):
                t = 1.0 if pod != 2 else (3.0 if step > 8 else 1.0)
                r = det.heartbeat(step, pod, t)
                rep = r or rep
        assert rep is not None and rep.pod == 2
        plan = det.mitigation_plan(rep)
        shares = plan["pod_shares"]
        assert shares[2] < min(shares[0], shares[1], shares[3])
        assert abs(sum(shares) - 1.0) < 1e-9
        reports.append(([(r.step, r.pod, r.ratio) for r in det.reports],
                        plan))
    assert reports[0] == reports[1]


@pytest.mark.parametrize("n,tp,expect", [(512, 16, (32, 16)),
                                         (496, 16, (31, 16)),
                                         (498, 16, (249, 2)),
                                         (8, 16, (1, 8)), (1, 16, (1, 1)),
                                         (96, 8, (12, 8))])
def test_elastic_mesh_plan(n, tp, expect):
    plan = elastic_mesh_plan(n, tp=tp)
    assert (plan["data"], plan["model"]) == expect
    assert plan == jft.elastic_mesh_plan(n, tp=tp)
