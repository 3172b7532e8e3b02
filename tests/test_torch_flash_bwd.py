"""The port's flash backward through its CPU face, held against the JAX
reference (split from ``tests/test_torch_flash.py``, which holds the
forward, so that the two files run on two test workers).

``flash_attention_bwd_plain`` (what ``flash_attention_bwd`` runs for a
CPU tensor) against ``jax.vjp`` of the reference's ``_flash_core`` (its
custom_vjp, the XLA backward ``_flash_core_bwd``), with the reference's
blocks set to 64 at test time so several block pairs run: dq, dk and dv
within 1e-4 (float32; the sums run in another order) or 3e-2 (bfloat16:
the reference rounds q . k to bfloat16, the port keeps the forward's
float32 logits) of the largest |gradient|.  The autograd Function
``flash_attention_train`` equals the plain pair on the CPU.

The CUDA kernels run only on the card; ``chip_smoke.py`` holds them
against ``flash_attention_plain`` and ``flash_attention_bwd_plain``
there."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import layers as JLY  # noqa: E402
from repro.models.layers import _flash_core  # noqa: E402
from repro_torch.kernels import (flash_attention_bwd,  # noqa: E402
                                 flash_attention_bwd_plain,
                                 flash_attention_plain,
                                 flash_attention_train)
from repro_torch.kernels.flash_attn import BWD_HEAD_DIMS  # noqa: E402


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


def _inputs(cfg, scale=0.3):
    rng = np.random.default_rng(cfg["sq"])
    q = rng.normal(size=(cfg["b"], cfg["h"], cfg["sq"], cfg["hd"])) * scale
    k = rng.normal(size=(cfg["b"], cfg["kv"], cfg["sk"], cfg["hd"])) * scale
    v = rng.normal(size=(cfg["b"], cfg["kv"], cfg["sk"], cfg["hd"])) * scale
    return [x.astype(np.float32) for x in (q, k, v)]


def _kw(cfg):
    return dict(causal=cfg["causal"], window=cfg["win"],
                softcap_val=cfg["cap"])


# -- the backward -------------------------------------------------------------

BWD_CONFIGS = [
    dict(b=1, h=4, kv=2, sq=256, sk=256, hd=32, causal=True, win=0, cap=0.0),
    dict(b=2, h=4, kv=2, sq=256, sk=256, hd=32, causal=True, win=96,
         cap=0.0),
    dict(b=1, h=4, kv=4, sq=256, sk=256, hd=64, causal=True, win=0,
         cap=30.0),
    dict(b=1, h=4, kv=1, sq=256, sk=256, hd=32, causal=False, win=0,
         cap=0.0),
    dict(b=1, h=4, kv=2, sq=192, sk=192, hd=80, causal=True, win=100,
         cap=50.0),
    # hd 112 causal (zamba2-7b's shared block); hd 80 and 112 without a
    # causal mask (hubert-xlarge's encoder)
    dict(b=1, h=4, kv=4, sq=192, sk=192, hd=112, causal=True, win=0,
         cap=0.0),
    dict(b=1, h=4, kv=4, sq=128, sk=128, hd=80, causal=False, win=0,
         cap=0.0),
    dict(b=1, h=4, kv=2, sq=128, sk=128, hd=112, causal=False, win=0,
         cap=50.0),
    # hd 256 (gemma3-4b): GQA 2:1 causal (its global layers), with a window
    # (its local layers), and with softcap 50
    dict(b=1, h=4, kv=2, sq=192, sk=192, hd=256, causal=True, win=0,
         cap=0.0),
    dict(b=1, h=4, kv=2, sq=192, sk=192, hd=256, causal=True, win=100,
         cap=0.0),
    dict(b=1, h=4, kv=2, sq=128, sk=128, hd=256, causal=True, win=0,
         cap=50.0),
]
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _bwd_inputs(cfg, dtype):
    q, k, v = _inputs(cfg, scale=0.5)
    dout = np.random.default_rng(cfg["sq"] + 1).normal(
        size=q.shape).astype(np.float32)
    tdt = getattr(torch, dtype)
    return [torch.from_numpy(x).to(tdt) for x in (q, k, v, dout)]


@pytest.mark.parametrize("cfg", BWD_CONFIGS, ids=range(len(BWD_CONFIGS)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plain_matches_reference_vjp(cfg, dtype, monkeypatch):
    monkeypatch.setattr(JLY, "FLASH_BLOCK_Q", 64)
    monkeypatch.setattr(JLY, "FLASH_BLOCK_K", 64)
    tq, tk, tv, tdo = _bwd_inputs(cfg, dtype)
    b, h, s, hd = tq.shape
    kv, rep = cfg["kv"], h // cfg["kv"]
    jdt = getattr(jnp, dtype)
    j = [jnp.asarray(t.float().numpy(), jdt) for t in (tq, tk, tv, tdo)]
    grouped = lambda x: x.transpose(0, 2, 1, 3).reshape(  # noqa: E731
        b, s, kv, rep, hd)
    pos = jnp.arange(s, dtype=jnp.int32)
    static = (cfg["cap"], cfg["causal"], 1.0 / hd ** 0.5)
    jout, vjp = jax.vjp(lambda q, k, v: _flash_core(static, q, k, v, pos, pos,
                                                    cfg["win"]),
                        grouped(j[0]), j[1].transpose(0, 2, 1, 3),
                        j[2].transpose(0, 2, 1, 3))
    jdq, jdk, jdv = vjp(grouped(j[3]))
    want = [np.asarray(jdq.astype(jnp.float32)).reshape(b, s, h, hd)
            .transpose(0, 2, 1, 3)] + [
        np.asarray(g.astype(jnp.float32)).transpose(0, 2, 1, 3)
        for g in (jdk, jdv)]
    out, lse = flash_attention_plain(tq, tk, tv, bq=64, bk=64,
                                     return_lse=True, **_kw(cfg))
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, s)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(jout.astype(jnp.float32)).reshape(
            b, s, h, hd).transpose(0, 2, 1, 3),
        atol=1e-5 if dtype == "float32" else 2e-2, rtol=0)
    got = flash_attention_bwd_plain(tq, tk, tv, out, tdo, lse, bq=64, bk=64,
                                    **_kw(cfg))
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=BWD_TOL[dtype] * np.abs(w).max())


def test_lse_is_the_rows_logsumexp():
    cfg = dict(BWD_CONFIGS[4])
    tq, tk, tv, _ = _bwd_inputs(cfg, "float32")
    _, lse = flash_attention_plain(tq, tk, tv, bq=64, bk=64,
                                   return_lse=True, **_kw(cfg))
    rep = cfg["h"] // cfg["kv"]
    s = torch.einsum("bhqd,bhkd->bhqk", tq, tk.repeat_interleave(rep, 1))
    s = s / cfg["hd"] ** 0.5
    s = cfg["cap"] * torch.tanh(s / cfg["cap"])
    pos = torch.arange(cfg["sq"])
    ok = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                           - cfg["win"])
    want = torch.logsumexp(torch.where(ok, s, -1e30), -1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("blocks", [(64, 128), (256, 64), (192, 192)])
def test_bwd_plain_blocks_agree(blocks):
    """The plain backward's blocks only order its float32 sums."""
    cfg = BWD_CONFIGS[4]
    tq, tk, tv, tdo = _bwd_inputs(cfg, "float32")
    out, lse = flash_attention_plain(tq, tk, tv, bq=64, bk=64,
                                     return_lse=True, **_kw(cfg))
    want = flash_attention_bwd_plain(tq, tk, tv, out, tdo, lse, bq=64,
                                     bk=64, **_kw(cfg))
    got = flash_attention_bwd(tq, tk, tv, out, tdo, lse, bq=blocks[0],
                              bk=blocks[1], **_kw(cfg))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_function_equals_the_plain_pair(dtype):
    """On the CPU the autograd Function runs ``flash_attention_plain`` with
    the lse forward and ``flash_attention_bwd_plain`` backward: the same
    output and gradients, bit for bit, through the model's strided
    (B, S, H, hd) views."""
    cfg = BWD_CONFIGS[1]
    tq, tk, tv, tdo = _bwd_inputs(cfg, dtype)
    leaves = [t.transpose(1, 2).contiguous().requires_grad_()
              for t in (tq, tk, tv)]
    views = [t.transpose(1, 2) for t in leaves]
    out = flash_attention_train(*views, bq=64, bk=64, **_kw(cfg))
    grads = torch.autograd.grad(out, leaves, tdo)
    want_out, lse = flash_attention_plain(tq, tk, tv, bq=64, bk=64,
                                          return_lse=True, **_kw(cfg))
    want = flash_attention_bwd_plain(tq, tk, tv, want_out, tdo, lse, bq=64,
                                     bk=64, **_kw(cfg))
    assert torch.equal(out, want_out)
    for g, w in zip(grads, want):
        assert torch.equal(g.transpose(1, 2), w)


class _CudaLike(torch.Tensor):
    """A tensor that says it lies on the card and holds no data: what a
    wrapper decides from the device alone can be checked without one."""

    @staticmethod
    def __new__(cls, *shape, dtype=torch.float32):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype,
                                                   device="cuda:0")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} reached a tensor on the card")


def test_train_and_bwd_refuse_what_the_kernel_does_not_take(monkeypatch):
    """On the card: a float32 input that needs a gradient (the float32
    kernel is forward-only) and a width no config has raise by name.
    Every config's head width has a backward kernel: 32, 64, 80, 112
    (zamba2-7b), 128 and 256 (gemma3-4b), so hd 64 and 256 pass the
    checks and go on to the kernels, never to the plain versions.  On
    ``meta`` (shapes only) the plain pair runs: hd 256 gives its shapes
    there."""
    assert BWD_HEAD_DIMS == (32, 64, 80, 112, 128, 256)
    with pytest.raises(ValueError, match="forward-only"):
        flash_attention_train(*(_CudaLike(1, 2, 64, 64),) * 3)
    qb = _CudaLike(1, 2, 64, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="built for hd in"):
        flash_attention_train(qb, qb, qb)
    from repro_torch.kernels import flash_attn
    plain = []
    for name in ("flash_attention_plain", "flash_attention_bwd_plain"):
        monkeypatch.setattr(flash_attn, name,
                            lambda *a, name=name, **k: plain.append(name))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for hd in (64, 256):
        qb = _CudaLike(1, 2, 64, hd, dtype=torch.bfloat16)
        for call in (lambda: flash_attention_train(qb, qb, qb),
                     lambda: flash_attention_bwd(qb, qb, qb, qb, qb,
                                                 _CudaLike(1, 2, 64))):
            with pytest.raises(Exception) as err:
                call()
            assert "ROADMAP" not in str(err.value)
            assert "built for hd" not in str(err.value)
    assert plain == []
    monkeypatch.undo()
    meta = dict(device="meta", dtype=torch.bfloat16)
    q = torch.zeros(1, 4, 64, 256, **meta)
    k = torch.zeros(1, 2, 64, 256, **meta)
    out = flash_attention_train(q, k, k.requires_grad_())
    assert out.device.type == "meta" and out.shape == q.shape
    dq, dk, dv = flash_attention_bwd(q, k, k, q, q,
                                     torch.zeros(1, 4, 64, device="meta"))
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
