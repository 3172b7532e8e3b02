"""Step builders: train_step / prefill_step / serve_step and their inputs
for any (architecture x input shape) cell — the PyTorch twin of
``repro/launch/steps.py`` on one card.

``make_train_step``, ``make_prefill_step`` and ``make_serve_step`` return
a cell's step as a function of its inputs, over ``launch/train.py:
train_step``, ``models.prefill`` and ``models.decode_step``.
``batch_struct``, ``cache_struct``, ``params_struct`` and ``state_struct``
give those inputs as tensors on the ``meta`` device, the reference's
``jax.ShapeDtypeStruct`` stand-ins: shapes and dtypes, nothing
allocated.  ``batch_struct``'s ``batch`` and ``seq`` override the
shape's (``launch/dryrun.py`` sizes a cell's cut with them).

The reference's partition specs (``sanitize_pspecs``, ``batch_pspecs``,
``state_pspecs``, ``cache_pspecs``, ``token_pspecs``) lay a cell over a
256- or 512-chip mesh and have no meaning on one card; they are not
ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import SHAPES, ArchConfig
from ..models import decode_step, init_decode_cache, init_params, prefill
from ..optim import adamw
from .train import train_step

META = torch.device("meta")


def batch_struct(cfg: ArchConfig, shape_name: str, *,
                 batch: Optional[int] = None,
                 seq: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The cell's batch: ``tokens`` (B, S) int32, or the audio family's
    ``frames`` (B, S, d) bfloat16; ``labels`` (B, S) int32; the vlm
    family's ``img`` (B, n_image_tokens, d) bfloat16."""
    sh = SHAPES[shape_name]
    b = sh["global_batch"] if batch is None else batch
    s = sh["seq_len"] if seq is None else seq
    out: Dict[str, torch.Tensor] = {}
    if cfg.audio_frontend:
        out["frames"] = torch.empty(b, s, cfg.d_model, dtype=torch.bfloat16,
                                    device=META)
    else:
        out["tokens"] = torch.empty(b, s, dtype=torch.int32, device=META)
    out["labels"] = torch.empty(b, s, dtype=torch.int32, device=META)
    if cfg.family == "vlm":
        out["img"] = torch.empty(b, cfg.n_image_tokens, cfg.d_model,
                                 dtype=torch.bfloat16, device=META)
    return out


def make_train_step(cfg: ArchConfig,
                    opt_cfg: Optional[adamw.AdamWConfig] = None):
    """``step(state, batch) -> (state, metrics)``: the loss, its gradient
    and AdamW (``launch/train.py: train_step``)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def step(state: adamw.OptState, batch: Dict[str, torch.Tensor]):
        return train_step(cfg, opt_cfg, state, batch)

    return step


def params_struct(cfg: ArchConfig):
    """The parameter tree on ``meta``."""
    return init_params(cfg, device=META)


def state_struct(cfg: ArchConfig) -> adamw.OptState:
    """The optimizer state on ``meta``: float32 master, m and v."""
    return adamw.init(params_struct(cfg))


def make_prefill_step(cfg: ArchConfig):
    """``step(params, batch) -> (last-token logits, K/V or states)``."""
    def step(params, batch):
        return prefill(params, batch.get("tokens"), cfg,
                       img=batch.get("img"), frames=batch.get("frames"))
    return step


def make_serve_step(cfg: ArchConfig):
    """``step(params, cache, token, cur, img=None) -> (logits, cache)``:
    one decode step (``cur`` a Python int)."""
    def step(params, cache, token, cur, img=None):
        return decode_step(params, cache, token, cur, cfg, img=img)
    return step


def cache_struct(cfg: ArchConfig, shape_name: str):
    """The decode cache of the cell's batch over its sequence, on
    ``meta``."""
    sh = SHAPES[shape_name]
    return init_decode_cache(cfg, sh["global_batch"], sh["seq_len"],
                             device=META)
