"""The port's flash attention (B7) through its CPU face, held against the
JAX reference: ``flash_attention_plain`` (what ``flash_attention`` runs
for a CPU tensor) against the Pallas ``flash_attention`` in interpret
mode and the oracle ``ref.flash_attention_ref`` on the configurations of
the reference's kernel tests, and in bfloat16 against the reference's
XLA path ``models.layers._flash_core``.

Tolerances:
* float32: 1e-5 absolute against the Pallas kernel and the oracle (the
  sums run in another order; measured differences are about 1e-7).
* bfloat16 against the Pallas kernel (the same float32 logits): 8e-3
  absolute, two bfloat16 ulps at the outputs' magnitude (up to 2).
* bfloat16 against ``_flash_core``: 2e-2 absolute.  The XLA path rounds
  q . k to bfloat16 before it scales it; the port follows the Pallas
  kernel, which keeps the product in float32.

The CUDA kernel runs only on the card; ``chip_smoke.py`` holds it
against ``flash_attention_plain`` there."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attn import flash_attention as jflash  # noqa: E402
from repro.models.layers import _flash_core  # noqa: E402
from repro_torch.kernels import (flash_attention,  # noqa: E402
                                 flash_attention_plain, ref)

CONFIGS = [
    dict(b=1, h=4, kv=2, sq=512, sk=512, hd=64, causal=True, win=0, cap=0.0),
    dict(b=2, h=8, kv=4, sq=1024, sk=1024, hd=64, causal=True, win=128,
         cap=0.0),
    dict(b=1, h=4, kv=4, sq=512, sk=1024, hd=32, causal=True, win=0,
         cap=50.0),
    dict(b=1, h=2, kv=2, sq=512, sk=512, hd=64, causal=False, win=0, cap=0.0),
]


def _inputs(cfg, scale=0.3):
    rng = np.random.default_rng(cfg["sq"])
    q = rng.normal(size=(cfg["b"], cfg["h"], cfg["sq"], cfg["hd"])) * scale
    k = rng.normal(size=(cfg["b"], cfg["kv"], cfg["sk"], cfg["hd"])) * scale
    v = rng.normal(size=(cfg["b"], cfg["kv"], cfg["sk"], cfg["hd"])) * scale
    return [x.astype(np.float32) for x in (q, k, v)]


def _kw(cfg):
    return dict(causal=cfg["causal"], window=cfg["win"],
                softcap_val=cfg["cap"])


@pytest.mark.parametrize("cfg", CONFIGS, ids=range(len(CONFIGS)))
@pytest.mark.parametrize("blocks", [(256, 256), (128, 512), (512, 512)])
def test_f32_matches_pallas_kernel_and_oracle(cfg, blocks):
    q, k, v = _inputs(cfg)
    want = np.asarray(jflash(*(jnp.asarray(x) for x in (q, k, v)),
                             bq=256, bk=256, **_kw(cfg)))
    oracle = np.asarray(jref.flash_attention_ref(
        *(jnp.asarray(x) for x in (q, k, v)), **_kw(cfg)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = flash_attention(tq, tk, tv, bq=blocks[0], bk=blocks[1],
                          **_kw(cfg)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ref.flash_attention_ref(tq, tk, tv,
                                                       **_kw(cfg)).numpy(),
                               oracle, atol=1e-5, rtol=0)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("cfg", CONFIGS, ids=range(len(CONFIGS)))
def test_bf16_matches_pallas_kernel(cfg):
    q, k, v = _inputs(cfg, scale=0.6)
    qb, kb, vb = (_bf16(x) for x in (q, k, v))
    jin = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (qb, kb, vb)]
    want = np.asarray(jflash(*jin, bq=256, bk=256, **_kw(cfg))
                      .astype(jnp.float32))
    got = flash_attention(qb, kb, vb, bq=256, bk=256, **_kw(cfg))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=8e-3, rtol=0)


@pytest.mark.parametrize("b,h,kv,s,hd,win,cap", [
    (1, 4, 2, 2048, 64, 0, 0.0),      # granite-like: GQA, full causal
    (2, 4, 2, 2048, 32, 128, 50.0),   # gemma2-like: window + softcap
])
def test_bf16_matches_xla_flash_core(b, h, kv, s, hd, win, cap):
    rng = np.random.default_rng(s + hd)
    q, k, v = ((rng.normal(size=shape) * 0.5).astype(np.float32) for shape in
               ((b, h, s, hd), (b, kv, s, hd), (b, kv, s, hd)))
    qb, kb, vb = (_bf16(x) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (qb, kb, vb))
    pos = jnp.arange(s, dtype=jnp.int32)
    want = _flash_core((cap, True, 1.0 / hd ** 0.5),
                       jq.transpose(0, 2, 1, 3).reshape(b, s, kv, h // kv,
                                                        hd),
                       jk.transpose(0, 2, 1, 3), jv.transpose(0, 2, 1, 3),
                       pos, pos, win)
    want = np.asarray(want.astype(jnp.float32)).reshape(
        b, s, h, hd).transpose(0, 2, 1, 3)
    got = flash_attention(qb, kb, vb, causal=True, window=win,
                          softcap_val=cap).float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_strided_views_and_layout():
    """The (B, S, H, hd) activations passed as transposed views give the
    same result as contiguous (B, H, S, hd) copies."""
    cfg = CONFIGS[1]
    q, k, v = (torch.from_numpy(x) for x in _inputs(cfg))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]
    a = flash_attention(q, k, v, **_kw(cfg))
    b = flash_attention(*views, **_kw(cfg))
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_rejects_bad_shapes():
    q = torch.zeros(1, 3, 64, 32)
    k = torch.zeros(1, 2, 64, 32)
    with pytest.raises(ValueError, match="does not fit"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="multiples"):
        flash_attention_plain(torch.zeros(1, 2, 96, 32),
                              torch.zeros(1, 2, 96, 32),
                              torch.zeros(1, 2, 96, 32), bq=64, bk=64)
