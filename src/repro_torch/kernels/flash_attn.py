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
  ``flash_attention_plain``; a CUDA tensor launches the kernel of
  ``csrc/flash_attn.cu`` (bfloat16 on the tensor cores, hd 32, 64, 80
  or 128; or float32, hd 32 or 64) or raises.  The kernel reads every
  tensor through its strides (unit stride along hd), so the model's
  (B, S, H, hd) activations pass as transposed views without a copy, and
  the output takes q's layout.
  ``bq``/``bk`` size the plain version's blocks; the kernel's tiles are
  its own (``KERNEL_TILES``).  The plain version at the kernel's tiles
  rescales its running sums at the same keys, so the two differ only by
  the order of float32 sums and by exp's last place.
* ``flash_attention_plain`` — the blocked loop of the reference's XLA
  path (``models/layers.py: _flash_fwd_impl``) with the Pallas kernel's
  float32 logits, in PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

DEFAULT_BQ = 512
DEFAULT_BK = 512
#: head widths the kernel is built for, by dtype
HEAD_DIMS = {torch.bfloat16: (32, 64, 80, 128), torch.float32: (32, 64)}
#: the kernel's (query rows, keys) per tile, by dtype
KERNEL_TILES = {torch.bfloat16: (64, 64), torch.float32: (64, 32)}


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


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap_val: float = 0.0, bq: int = DEFAULT_BQ,
                          bk: int = DEFAULT_BK):
    """Plain PyTorch flash attention: blocks of ``bq`` query rows and ``bk``
    keys, an online softmax over the key blocks in float32."""
    _check(q, k, v)
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    rep = h // kvh
    bq, bk = min(bq, sq), min(bk, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"flash_attention: Sq={sq}, Sk={sk} must be "
                         f"multiples of the blocks {bq}, {bk}")
    scale = _scale(hd)
    dev = q.device
    qg = q.reshape(b, kvh, rep, sq, hd).float()
    kf, vf = k.float(), v.float()
    out = torch.empty(b, kvh, rep, sq, hd, dtype=q.dtype, device=dev)
    for q0 in range(0, sq, bq):
        qb = qg[:, :, :, q0:q0 + bq]
        qpos = torch.arange(q0, q0 + bq, device=dev)[:, None]
        m = torch.full((b, kvh, rep, bq), float("-inf"), device=dev)
        l = torch.zeros(b, kvh, rep, bq, device=dev)
        acc = torch.zeros(b, kvh, rep, bq, hd, device=dev)
        for k0 in range(0, sk, bk):
            s = torch.einsum("bgrqd,bgkd->bgrqk", qb,
                             kf[:, :, k0:k0 + bk]) * scale
            if softcap_val:
                s = softcap_val * torch.tanh(s / softcap_val)
            kpos = torch.arange(k0, k0 + bk, device=dev)[None, :]
            ok = torch.ones(bq, bk, dtype=torch.bool, device=dev)
            if causal:
                ok = ok & (kpos <= qpos)
            if window:
                ok = ok & (kpos > qpos - window)
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
    return out.reshape(b, h, sq, hd)


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it through its strides (unit
    stride along hd, 16-byte aligned rows), else a contiguous copy."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s % 8 == 0 for s in t.stride()[:3]))
    return t if ok else t.contiguous()


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap_val: float = 0.0, bq: int = DEFAULT_BQ,
                    bk: int = DEFAULT_BK):
    """q: (B, H, Sq, hd); k/v: (B, KV, Sk, hd) with H % KV == 0.  Returns
    (B, H, Sq, hd) in q's dtype (and, on the card, q's memory layout)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap_val=softcap_val, bq=bq, bk=bk)
    for t in (q, k, v):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: takes CPU tensors (plain "
                             f"version) or CUDA tensors (kernel), got "
                             f"{t.device}")
        if (t.device != q.device
                or q.device.index != torch.cuda.current_device()):
            raise ValueError("flash_attention: q, k and v must be on the "
                             "current card")
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
    q, k, v = (_kernel_view(t) for t in (q, k, v))
    out = torch.empty_like(q)
    dims = (ctypes.c_int * 9)(b, h, kvh, sq, sk, hd, int(bool(causal)),
                              int(window), int(q.dtype == torch.bfloat16))
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _build.library("flash_attn")
    _build.check(lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dims,
        strides, ctypes.c_float(_scale(hd)),
        ctypes.c_float(float(softcap_val)), _build.stream_of(q)),
        "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out
