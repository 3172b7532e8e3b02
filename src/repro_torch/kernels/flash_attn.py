"""Flash attention forward — the PyTorch twin of
``repro/kernels/flash_attn.py``.

Attention with an online softmax over key blocks: GQA (q head h reads kv
head ``h // (H // KV)``), causal and sliding-window masks, and gemma-style
logit soft-capping.  q is (B, H, Sq, hd), k and v (B, KV, Sk, hd), the
output like q.  The numerics are the Pallas body's: the logits are
``(q . k) * 1/sqrt(hd)`` in float32, soft-capped, then masked with -1e30
(not -inf); p is cast to v's type before the p . v product; the row sum
is floored at 1e-30.

* ``flash_attention`` — the wrapper.  A CPU tensor goes to
  ``flash_attention_plain``; a CUDA tensor launches a kernel or raises.
  A ``meta`` tensor goes to the plain version too, in one block of all
  Sq rows and Sk keys: nothing is computed there, and the one block's
  products are every (q, k) tile's, which the plain loop would walk
  one by one (``launch/op_analysis.py`` counts them).
  The kernel is chosen by dtype: bfloat16 runs ``csrc/flash_wgmma.cu``
  (wgmma for both products, K/V by TMA into an mbarrier ring, 128-key
  tiles, 64-key tiles at hd 256); float32 (the reference's float32 tests)
  runs ``csrc/flash_attn.cu`` (scalar FMAs).  Both take hd 32, 64, 80,
  112, 128 and 256 (``HEAD_DIMS``): every head width of the configs,
  with a causal mask or none (hubert-xlarge is an encoder).  The kernels
  read every tensor through its strides (unit stride along hd), so the
  model's (B, S, H, hd) activations pass as transposed views without a
  copy, and the output takes q's layout.
  ``bq``/``bk`` size the plain version's blocks; the kernel's tiles are
  its own (``kernel_tiles``).  The plain version at the kernel's tiles
  rescales its running sums at the same keys, so the two differ only by
  the order of float32 sums and by exp's last place.
* ``flash_attention_plain`` — the blocked loop of the reference's XLA
  path (``models/layers.py: _flash_fwd_impl``) with the Pallas kernel's
  float32 logits, in PyTorch.

Both take ``return_lse=True`` and then also return each row's
log-sum-exp of its capped, masked logits, float32 (B, H, Sq) in
natural-log units (m + log l): the statistic the backward recomputes P
from.  On the card only the bfloat16 kernel writes it.

The backward, the counterpart of the reference's XLA backward
``models/layers.py: _flash_core_bwd`` (no Pallas kernel):

* ``flash_attention_bwd`` — dq, dk and dv from q, k, v, out, dout and
  the lse.  A CPU tensor goes to ``flash_attention_bwd_plain``; a CUDA
  tensor launches ``csrc/flash_bwd.cu`` or raises: two launches, a dq
  kernel a block of query rows (which also computes D = rowsum(dout *
  out)) and a dk/dv kernel a block of keys, each with wgmma and a TMA
  ring and no atomics, so two calls give the same bits.  bfloat16 only,
  hd 32, 64, 80, 112, 128 and 256 (``BWD_HEAD_DIMS``), Sq == Sk, causal
  or not.
* ``flash_attention_bwd_plain`` — the reference's blocked recompute in
  PyTorch with its casts: float32 p and dv, dp from a product in the
  inputs' dtype, ds cast to the inputs' dtype before the dq and dk
  products.  Its logits are the forward's float32 ones, so p = exp(s -
  lse) recomputes exactly what the forward weighed.
* ``flash_attention_train`` — a ``torch.autograd.Function`` whose forward
  is ``flash_attention`` with the lse and whose backward is
  ``flash_attention_bwd``.  The model calls it when a gradient is needed;
  ``flash_attention`` itself stays forward-only.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

DEFAULT_BQ = 512
DEFAULT_BK = 512
#: head widths the kernels are built for, by dtype
HEAD_DIMS = {torch.bfloat16: (32, 64, 80, 112, 128, 256),
             torch.float32: (32, 64, 80, 112, 128, 256)}
#: (query rows, keys) per block at which the plain version matches each
#: kernel below hd 256: both rescale their running sums at the same keys.
#: The wgmma kernel (bfloat16) walks 128-key tiles with CTAs of 192 query
#: rows at hd <= 64 and 128 at hd 80, 112 and 128; rows are independent,
#: so the query block only has to divide Sq.  The scalar kernel (float32): 64 x
#: 32 at every hd.
KERNEL_TILES = {torch.bfloat16: (128, 128), torch.float32: (64, 32)}
#: head widths the backward kernel is built for (bfloat16 only): every
#: head width of the configs
BWD_HEAD_DIMS = (32, 64, 80, 112, 128, 256)


def kernel_tiles(dtype: torch.dtype, hd: int):
    """``KERNEL_TILES`` at head width ``hd``: the wgmma kernel walks
    64-key tiles with CTAs of 128 query rows at hd 256."""
    if dtype == torch.bfloat16 and hd == 256:
        return (128, 64)
    return KERNEL_TILES[dtype]


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q must be (B, H, Sq, hd) and k, v "
                         f"(B, KV, Sk, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k and v must share a dtype")


def _scale(hd: int) -> float:
    """The reference's ``1.0 / (hd ** 0.5)``, as a Python float."""
    return 1.0 / (hd ** 0.5)


def _mask(q0: int, nq: int, k0: int, nk: int, causal: bool, window: int,
          dev) -> torch.Tensor:
    """(nq, nk) bool: which of queries q0.. may see keys k0.. (positions
    from 0 on both sides)."""
    qpos = torch.arange(q0, q0 + nq, device=dev)[:, None]
    kpos = torch.arange(k0, k0 + nk, device=dev)[None, :]
    ok = torch.ones(nq, nk, dtype=torch.bool, device=dev)
    if causal:
        ok = ok & (kpos <= qpos)
    if window:
        ok = ok & (kpos > qpos - window)
    return ok


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap_val: float = 0.0, bq: int = DEFAULT_BQ,
                          bk: int = DEFAULT_BK, return_lse: bool = False):
    """Plain PyTorch flash attention: blocks of ``bq`` query rows and ``bk``
    keys, an online softmax over the key blocks in float32.  Sq must be a
    multiple of ``bq``; the last key block may be short (the kernels weigh
    the keys past Sk of their last tile exactly 0).  With ``return_lse``
    also each row's log-sum-exp, float32 (B, H, Sq)."""
    _check(q, k, v)
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    rep = h // kvh
    bq, bk = min(bq, sq), min(bk, sk)
    if sq % bq:
        raise ValueError(f"flash_attention: Sq={sq} is not in multiples "
                         f"of the query block {bq}")
    scale = _scale(hd)
    dev = q.device
    qg = q.reshape(b, kvh, rep, sq, hd).float()
    kf, vf = k.float(), v.float()
    out = torch.empty(b, kvh, rep, sq, hd, dtype=q.dtype, device=dev)
    lse = torch.empty(b, kvh, rep, sq, dtype=torch.float32, device=dev)
    for q0 in range(0, sq, bq):
        qb = qg[:, :, :, q0:q0 + bq]
        m = torch.full((b, kvh, rep, bq), float("-inf"), device=dev)
        l = torch.zeros(b, kvh, rep, bq, device=dev)
        acc = torch.zeros(b, kvh, rep, bq, hd, device=dev)
        for k0 in range(0, sk, bk):
            s = torch.einsum("bgrqd,bgkd->bgrqk", qb,
                             kf[:, :, k0:k0 + bk]) * scale
            if softcap_val:
                s = softcap_val * torch.tanh(s / softcap_val)
            ok = _mask(q0, bq, k0, min(bk, sk - k0), causal, window, dev)
            s = torch.where(ok, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bgrqk,bgkd->bgrqd", p.to(v.dtype).float(),
                              vf[:, :, k0:k0 + bk])
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, :, :, q0:q0 + bq] = (
            acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        lse[:, :, :, q0:q0 + bq] = m + torch.log(l)
    out = out.reshape(b, h, sq, hd)
    return (out, lse.reshape(b, h, sq)) if return_lse else out


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read it through its strides, else
    a copy with the standard (B, H, S, hd) strides.  The wgmma kernel's TMA
    takes a tensor as (hd, S, H, B) with its strides in bytes: unit stride
    along hd, the base 16-byte aligned and the three other strides
    multiples of 16 bytes (8 elements), size-1 dimensions included."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s % 8 == 0 for s in t.stride()[:3]))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _plain_blocks(q, k, bq: int, bk: int):
    """The plain version's blocks: the caller's, or on ``meta`` one block
    of every row and key."""
    if q.device.type == "meta":
        return q.shape[2], k.shape[2]
    return bq, bk


def _on_card(name: str, *tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: takes CPU tensors (plain version) or "
                             f"CUDA tensors (kernel), got {t.device}")
        if (t.device != tensors[0].device
                or t.device.index != torch.cuda.current_device()):
            raise ValueError(f"{name}: every tensor must be on the current "
                             f"card")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap_val: float = 0.0, bq: int = DEFAULT_BQ,
                    bk: int = DEFAULT_BK, return_lse: bool = False):
    """q: (B, H, Sq, hd); k/v: (B, KV, Sk, hd) with H % KV == 0.  Returns
    (B, H, Sq, hd) in q's dtype (and, on the card, q's memory layout);
    with ``return_lse`` also the rows' log-sum-exp, float32 (B, H, Sq)."""
    _check(q, k, v)
    if q.device.type in _build.PLAIN_DEVICES:
        bq, bk = _plain_blocks(q, k, bq, bk)
        with _build.plain_span("flash_attention", q, k, v):
            return flash_attention_plain(
                q, k, v, causal=causal, window=window,
                softcap_val=softcap_val, bq=bq, bk=bk,
                return_lse=return_lse)
    _on_card("flash_attention", q, k, v)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention: the kernel takes bfloat16 or "
                         f"float32, got {q.dtype}")
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"flash_attention: the {q.dtype} kernel is built "
                         f"for hd in {HEAD_DIMS[q.dtype]}, got {hd}")
    if min(b, h, sq, sk) == 0:
        raise ValueError("flash_attention: empty input")
    if return_lse and q.dtype != torch.bfloat16:
        raise ValueError("flash_attention: the float32 kernel "
                         "(csrc/flash_attn.cu) is forward-only and writes no "
                         "lse; the backward runs in bfloat16")
    q, k, v = (_kernel_view(t) for t in (q, k, v))
    out = torch.empty_like(q)
    dims = (ctypes.c_int * 9)(b, h, kvh, sq, sk, hd, int(bool(causal)),
                              int(window), int(q.dtype == torch.bfloat16))
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    args = (dims, strides, ctypes.c_float(_scale(hd)),
            ctypes.c_float(float(softcap_val)), _build.stream_of(q))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    lse = None
    if q.dtype == torch.bfloat16:
        if return_lse:
            lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
        rc = _build.library("flash_wgmma").repro_flash_attention_wgmma(
            *ptrs, None if lse is None else lse.data_ptr(), *args)
    else:
        rc = _build.library("flash_attn").repro_flash_attention(*ptrs, *args)
    _build.check(rc, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------


def flash_attention_bwd_plain(q, k, v, out, dout, lse, *, causal: bool = True,
                              window: int = 0, softcap_val: float = 0.0,
                              bq: int = DEFAULT_BQ, bk: int = DEFAULT_BK):
    """Plain PyTorch flash backward: the reference's ``_flash_core_bwd``
    loop (key blocks outside, query blocks inside) with p recomputed as
    exp(s - lse) from the forward's float32 logits.  Block pairs the mask
    leaves wholly empty are skipped (their p is exactly 0).  Returns (dq,
    dk, dv) in the inputs' dtype and shapes."""
    _check(q, k, v)
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    rep = h // kvh
    bq, bk = min(bq, sq), min(bk, sk)
    scale = _scale(hd)
    dev = q.device
    qg = q.reshape(b, kvh, rep, sq, hd)
    dog = dout.reshape(b, kvh, rep, sq, hd)
    d_row = (dout.float() * out.float()).sum(-1).reshape(b, kvh, rep, sq)
    lg = lse.reshape(b, kvh, rep, sq).float()
    dq = torch.zeros(b, kvh, rep, sq, hd, dtype=torch.float32, device=dev)
    dk = torch.zeros(b, kvh, sk, hd, dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for k0 in range(0, sk, bk):
        kn = min(bk, sk - k0)
        kb, vb = k[:, :, k0:k0 + kn], v[:, :, k0:k0 + kn]
        for q0 in range(0, sq, bq):
            qn = min(bq, sq - q0)
            if (causal and k0 > q0 + qn - 1) or (
                    window and k0 + kn - 1 <= q0 - window):
                continue
            qb, dob = qg[..., q0:q0 + qn, :], dog[..., q0:q0 + qn, :]
            raw = torch.einsum("bgrqd,bgkd->bgrqk", qb.float(),
                               kb.float()) * scale
            s = softcap_val * torch.tanh(raw / softcap_val) \
                if softcap_val else raw
            ok = _mask(q0, qn, k0, kn, causal, window, dev)
            s = torch.where(ok, s, -1e30)
            p = torch.exp(s - lg[..., q0:q0 + qn, None])
            dv[:, :, k0:k0 + kn] += torch.einsum("bgrqk,bgrqd->bgkd", p,
                                                 dob.float())
            dp = torch.einsum("bgrqd,bgkd->bgrqk", dob.to(v.dtype), vb)
            ds = p * (dp.float() - d_row[..., q0:q0 + qn, None])
            if softcap_val:
                ds = ds * (1.0 - torch.tanh(raw / softcap_val) ** 2)
            ds = ds * scale
            dq[..., q0:q0 + qn, :] += torch.einsum(
                "bgrqk,bgkd->bgrqd", ds.to(k.dtype), kb).float()
            dk[:, :, k0:k0 + kn] += torch.einsum(
                "bgrqk,bgrqd->bgkd", ds.to(q.dtype), qb).float()
    return (dq.reshape(b, h, sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _bwd_supported(name: str, q) -> None:
    """What the backward kernel refuses, raised before any work."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the backward kernel takes bfloat16; the "
                         f"float32 kernel (csrc/flash_attn.cu) is "
                         f"forward-only, got {q.dtype}")
    if q.shape[-1] not in BWD_HEAD_DIMS:
        raise ValueError(f"{name}: the backward kernel is built for hd in "
                         f"{BWD_HEAD_DIMS}, got {q.shape[-1]}")


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: int = 0, softcap_val: float = 0.0,
                        bq: int = DEFAULT_BQ, bk: int = DEFAULT_BK):
    """dq, dk, dv of ``flash_attention`` at (q, k, v) for the output
    gradient ``dout``, from its ``out`` and ``lse``.  ``bq``/``bk`` size
    the plain version's blocks.  On the card one call is two launches:
    dq (and D), then dk/dv."""
    _check(q, k, v)
    if q.device.type in _build.PLAIN_DEVICES:
        bq, bk = _plain_blocks(q, k, bq, bk)
        with _build.plain_span("flash_attention_bwd", q, k, v, out,
                               dout, lse):
            return flash_attention_bwd_plain(
                q, k, v, out, dout, lse, causal=causal, window=window,
                softcap_val=softcap_val, bq=bq, bk=bk)
    _on_card("flash_attention_bwd", q, k, v, out, dout, lse)
    _bwd_supported("flash_attention_bwd", q)
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if sq != sk:
        raise ValueError(f"flash_attention_bwd: the kernel takes Sq == Sk, "
                         f"got {sq} and {sk}")
    if out.shape != q.shape or dout.shape != q.shape or \
            tuple(lse.shape) != (b, h, sq):
        raise ValueError("flash_attention_bwd: out and dout must be like q, "
                         "lse (B, H, Sq)")
    if out.dtype != q.dtype or dout.dtype != q.dtype or \
            lse.dtype != torch.float32:
        raise ValueError("flash_attention_bwd: out and dout in q's dtype, "
                         "lse in float32")
    q, k, v, out, dout = (_kernel_view(t) for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    dsum = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    dq = torch.empty(b, h, sq, hd, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    dims = (ctypes.c_int * 8)(b, h, kvh, sq, sk, hd, int(bool(causal)),
                              int(window))
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, out, dout, dq, dk, dv)
          for s in t.stride()[:3]))
    _build.check(_build.library("flash_bwd").repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dims, strides,
        ctypes.c_float(_scale(hd)), ctypes.c_float(float(softcap_val)),
        _build.stream_of(q)), "flash_attention_bwd")
    _build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class _FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its flash backward: the forward saves q, k, v,
    out and the lse; the backward recomputes each logits tile from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap_val, bq, bk):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   softcap_val=softcap_val, bq=bq, bk=bk,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, softcap_val=softcap_val,
                      bq=bq, bk=bk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_train(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap_val: float = 0.0, bq: int = DEFAULT_BQ,
                          bk: int = DEFAULT_BK):
    """``flash_attention`` with a gradient: the kernels on the card (B7
    with its lse, then ``csrc/flash_bwd.cu``), the plain pair on the CPU.
    A CUDA input the backward kernel does not take (float32, a head
    width outside ``BWD_HEAD_DIMS``) raises here, before the forward
    runs."""
    _check(q, k, v)
    if q.device.type not in _build.PLAIN_DEVICES:
        _bwd_supported("flash_attention_train", q)
    return _FlashAttentionFn.apply(q, k, v, bool(causal), int(window),
                                   float(softcap_val), int(bq), int(bk))
