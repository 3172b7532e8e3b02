"""Error-feedback int8 gradient compression — the PyTorch twin of
``repro/distributed/compression.py``.

f32 -> int8 codes with one float32 scale per block of ``BLOCK`` values,
the quantization error carried forward (EF-SGD).  They compress the
payload of the gradient all-reduce (``collectives.allreduce_compressed``)
and are the pure functions over trees of tensors, with the reference's
arithmetic: codes and scales bit for bit.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..tree import tree_map

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    n = x.numel()
    pad = (-n) % BLOCK
    flat = torch.cat([x.reshape(-1), torch.zeros(pad, dtype=x.dtype,
                                                 device=x.device)])
    return flat.reshape(-1, BLOCK), n


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8 codes (blocks, BLOCK), per-block f32 scales
    (blocks, 1))."""
    blocks, _ = _pad_to_block(g.float())
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 \
        + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
               dtype=torch.float32) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return (q.float() * scale).reshape(-1)[:n].reshape(shape).to(dtype)


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor):
    """Quantize (g + carried error); return the dequantized payload in g's
    dtype and the new residual."""
    corrected = g.float() + err
    q, scale = quantize(corrected)
    deq = dequantize(q, scale, tuple(g.shape))
    new_err = corrected - deq
    return deq.to(g.dtype), new_err


def tree_compress_with_feedback(grads: Any, errs: Any):
    pairs = tree_map(compress_with_feedback, grads, errs)
    deq = tree_map(lambda g, p: p[0], grads, pairs)
    new_errs = tree_map(lambda g, p: p[1], grads, pairs)
    return deq, new_errs


def init_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compression_ratio() -> float:
    """Payload bytes ratio vs f32: int8 codes + one f32 scale per block."""
    return (BLOCK * 1 + 4) / (BLOCK * 4)
