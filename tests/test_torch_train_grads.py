"""The port's loss and its gradient (``repro_torch.models.loss_fn``)
against ``jax.value_and_grad(repro.models.loss_fn)`` (split from
``tests/test_torch_train.py``, which holds the rest of the training path,
so that the two files run on two test workers).

At the reference's parameters cast to float32 (the algorithm): every
leaf's gradient within ``GRAD_RTOL_F32`` (1e-4) of its Frobenius norm
(measured up to 3.5e-5, mamba2 at two chunks).  At its bfloat16
parameters (what training runs): the loss within ``LOSS_RTOL`` (1e-2)
relative, every leaf's gradient within ``GRAD_RTOL`` of its Frobenius
norm: 5e-2 for the dense model (measured up to 2.0e-2), 1e-1 for the MoE
model (3.2e-2; a routing choice on a near tie may flip between the two
sides) and for mamba2 (6.4e-2: XLA keeps the conv, gate and norm chains
in float32 inside its fusions where PyTorch rounds every bfloat16 op).
The flash path's logits are float32 in the port (the Pallas kernel's) and
bfloat16 in the reference's XLA path.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.tree import flatten_with_paths, tree_map  # noqa: E402

LOSS_RTOL = 1e-2
GRAD_RTOL = {"dense": 5e-2, "ssm": 1e-1, "moe": 1e-1}
GRAD_RTOL_F32 = 1e-4


# -- loss and gradients -------------------------------------------------------


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
