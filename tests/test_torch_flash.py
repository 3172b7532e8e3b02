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

The backward's tests are ``tests/test_torch_flash_bwd.py``.

The CUDA kernels run only on the card; ``chip_smoke.py`` holds them
against ``flash_attention_plain`` there."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attn import flash_attention as jflash  # noqa: E402
from repro.models.layers import _flash_core  # noqa: E402
from repro_torch.kernels import (flash_attention,  # noqa: E402
                                 flash_attention_plain, ref)
from repro_torch.kernels.flash_attn import (HEAD_DIMS,  # noqa: E402
                                            KERNEL_TILES, _kernel_view,
                                            kernel_tiles)

CONFIGS = [
    dict(b=1, h=4, kv=2, sq=512, sk=512, hd=64, causal=True, win=0, cap=0.0),
    dict(b=2, h=8, kv=4, sq=1024, sk=1024, hd=64, causal=True, win=128,
         cap=0.0),
    dict(b=1, h=4, kv=4, sq=512, sk=1024, hd=32, causal=True, win=0,
         cap=50.0),
    dict(b=1, h=2, kv=2, sq=512, sk=512, hd=64, causal=False, win=0, cap=0.0),
    # the kernel's other widths at small sizes: hd 128 (gemma2-27b,
    # yi-34b, deepseek-moe) and hd 80 (h2o-danube-1.8b)
    dict(b=1, h=4, kv=2, sq=256, sk=256, hd=128, causal=True, win=0, cap=0.0),
    dict(b=1, h=4, kv=2, sq=256, sk=512, hd=80, causal=True, win=96,
         cap=30.0),
    # hd 256 (gemma3-4b): a local layer's window and a global layer
    dict(b=1, h=4, kv=2, sq=256, sk=256, hd=256, causal=True, win=96,
         cap=0.0),
    dict(b=1, h=4, kv=2, sq=256, sk=512, hd=256, causal=True, win=0,
         cap=0.0),
    # hd 112 (zamba2-7b's shared block), causal and without a mask; hd 80
    # without a mask (hubert-xlarge, an encoder)
    dict(b=1, h=4, kv=4, sq=256, sk=256, hd=112, causal=True, win=0,
         cap=0.0),
    dict(b=1, h=4, kv=2, sq=256, sk=512, hd=112, causal=False, win=0,
         cap=30.0),
    dict(b=1, h=4, kv=4, sq=256, sk=256, hd=80, causal=False, win=0,
         cap=0.0),
]


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


@functools.lru_cache(maxsize=None)
def _pallas(i, dtype):
    """The Pallas kernel (interpret mode, 256 x 256 blocks) on CONFIGS[i]'s
    inputs in ``dtype`` (float32 at scale 0.3, bfloat16 at 0.6), as
    float32 numpy: computed once a test process and shared by the tests
    that hold against the same call."""
    cfg = CONFIGS[i]
    x = _inputs(cfg, scale=0.3 if dtype == "float32" else 0.6)
    tdt = getattr(torch, dtype)
    jin = [jnp.asarray(torch.from_numpy(a).to(tdt).float().numpy(),
                       getattr(jnp, dtype)) for a in x]
    return np.asarray(jflash(*jin, bq=256, bk=256, **_kw(cfg))
                      .astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _oracle(i):
    """``ref.flash_attention_ref`` on CONFIGS[i]'s float32 inputs, once a
    test process."""
    cfg = CONFIGS[i]
    return np.asarray(jref.flash_attention_ref(
        *(jnp.asarray(x) for x in _inputs(cfg)), **_kw(cfg)))


@pytest.mark.parametrize("cfg", CONFIGS, ids=range(len(CONFIGS)))
@pytest.mark.parametrize("blocks", [(256, 256), (128, 512), (512, 512)])
def test_f32_matches_pallas_kernel_and_oracle(cfg, blocks):
    q, k, v = _inputs(cfg)
    want = _pallas(CONFIGS.index(cfg), "float32")
    oracle = _oracle(CONFIGS.index(cfg))
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
    want = _pallas(CONFIGS.index(cfg), "bfloat16")
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


@pytest.mark.parametrize("cfg", CONFIGS, ids=range(len(CONFIGS)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_at_kernel_tiles_matches_pallas_and_oracle(cfg, dtype):
    """The plain version at the tiles of the kernel that runs this dtype
    on the card (``kernel_tiles``: 128 x 128 for the wgmma kernel in
    bfloat16, 128 x 64 at hd 256, 64 x 32 in float32), which is what the
    card's check holds
    the kernel against: within 1e-5 of the Pallas kernel and the oracle
    in float32, 8e-3 of the Pallas kernel in bfloat16."""
    q, k, v = _inputs(cfg, scale=0.3 if dtype == "float32" else 0.6)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    bq, bk = kernel_tiles(tdt, cfg["hd"])
    got = flash_attention_plain(tq, tk, tv, bq=bq, bk=bk, **_kw(cfg))
    assert got.dtype == tdt
    want = _pallas(CONFIGS.index(cfg), dtype)
    tol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    if dtype == "float32":
        oracle = _oracle(CONFIGS.index(cfg))
        np.testing.assert_allclose(got.numpy(), oracle, atol=1e-5, rtol=0)


def test_kernel_tiles():
    """The plain version rescales at the wgmma kernel's 128-key tiles in
    bfloat16 (64-key tiles at hd 256) and at the scalar kernel's 32-key
    tiles in float32, at every head width the kernels are built for."""
    assert KERNEL_TILES[torch.bfloat16] == (128, 128)
    assert KERNEL_TILES[torch.float32] == (64, 32)
    for dtype, hds in HEAD_DIMS.items():
        assert hds == (32, 64, 80, 112, 128, 256)
        for hd in hds:
            want = (128, 64) if (dtype, hd) == (torch.bfloat16, 256) \
                else KERNEL_TILES[dtype]
            assert kernel_tiles(dtype, hd) == want


@pytest.mark.parametrize("sk,causal,win", [(1000, False, 0), (700, True, 0),
                                            (1000, True, 300)])
def test_plain_ragged_last_key_block_matches_oracle(sk, causal, win):
    """Sk that is not a multiple of the key block: the plain version's last
    block is short, as the kernels weigh the keys past Sk 0."""
    cfg = dict(b=1, h=4, kv=2, sq=512, sk=sk, hd=64, causal=causal, win=win,
               cap=0.0)
    q, k, v = _inputs(cfg)
    oracle = np.asarray(jref.flash_attention_ref(
        *(jnp.asarray(x) for x in (q, k, v)), **_kw(cfg)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = flash_attention_plain(tq, tk, tv, bq=128, bk=128, **_kw(cfg))
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-5, rtol=0)


def _model_layout(b, s, h, hd, dtype=torch.bfloat16):
    """A (B, S, H, hd) activation seen as (B, H, S, hd), as the model
    hands it to the kernel."""
    return torch.randn(b, s, h, hd).to(dtype).transpose(1, 2)


def test_kernel_view_keeps_aligned_strided_views():
    """The model's strided view (strides multiples of 16 bytes, base
    16-byte aligned) goes to the kernel as it is, without a copy."""
    for hd in (64, 128, 80, 32):
        t = _model_layout(2, 64, 3, hd)
        assert not t.is_contiguous()
        out = _kernel_view(t)
        assert out.data_ptr() == t.data_ptr()
        assert out.stride() == t.stride()


def test_kernel_view_copies_what_tma_refuses():
    """A base that is not 16-byte aligned, a stride that is not a multiple
    of 16 bytes, or a size-1 dimension with such a stride is copied into
    the standard (B, H, S, hd) strides with the same values."""
    flat = torch.randn(1 + 2 * 4 * 32 * 64).to(torch.bfloat16)
    shifted = flat[1:].view(2, 4, 32, 64)               # base + 2 bytes
    padded = torch.randn(2, 4, 32, 68).to(torch.bfloat16)[..., :64]
    odd = torch.randn(4 * 32 * 64).to(torch.bfloat16).as_strided(
        (1, 4, 32, 64), (3, 2048, 64, 1))               # size-1 dim
    for t in (shifted, padded, odd):
        out = _kernel_view(t)
        assert out.data_ptr() != t.data_ptr()
        assert out.stride() == (4 * 32 * 64, 32 * 64, 64, 1)
        assert out.data_ptr() % 16 == 0
        torch.testing.assert_close(out, t, atol=0, rtol=0)
