"""AdamW with mixed precision, global-norm clipping and a cosine schedule
— the PyTorch twin of ``repro/optim/adamw.py``.

State: float32 master weights and float32 (m, v); the model computes on
``cast_params(master)``, bfloat16 working copies.  ``init`` / ``step`` as
in the reference, with its order of operations and types: the clip
scale ``min(1, clip / (gnorm + 1e-9))``, float32 moments, bias
corrections from ``b ** t`` in float32 and the decoupled weight decay
inside the update.  The step count, the learning rate and the gradient
norm stay 0-dim tensors on the state's device, so a step reads nothing
back.

One liberty: ``step`` updates ``m``, ``v`` and ``master`` in place and
returns them in the new state (the reference returns new trees), so the
card holds one copy of the optimizer state (on h2o-danube-1.8b 21.6 GB of
float32) and a leaf's temporaries at a time.

ZeRO: the reference's state follows the parameters' PartitionSpecs, so
with FSDP each rank holds a block of every sharded leaf's master, m and
v, and over "model" a block of every leaf cut over it.
``step(..., mesh=, specs=)`` updates a rank's blocks (each element's
update is its own) with the global gradient norm: each block's sum of
squares counted once over the mesh (on the ranks whose index is 0 on the
axes that do not cut it), the replicated leaves' (whole and equal on
every rank) on rank 0, added in ONE all-reduce (``sharded_norm``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..distributed.sharding import (all_reduce_, coords, leaf_dims,
                                    model_dim)
from ..tree import tree_leaves, tree_map


#: elements of a leaf one update takes at a time, so that its float32
#: temporaries are a slab's (256 MB each), not the leaf's (4.7 GB each for
#: gemma2-27b's embedding)
SLAB = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    master: Any   # float32 params
    m: Any
    v: Any
    step: torch.Tensor   # 0-dim int32, on the params' device


def init(params: Any) -> OptState:
    """Float32 master copies of ``params`` and zero moments."""
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return OptState(master=master, m=tree_map(zeros, params),
                    v=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio``: float32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    total = None
    for g in tree_leaves(tree):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def sharded_norm(grads: Any, specs: Any, mesh) -> torch.Tensor:
    """The global norm of a gradient of which this rank holds the blocks
    of the leaves ``specs`` cuts over ``mesh``'s data axes or "model" and
    the other leaves whole: each leaf's sum of squares counted once over
    the mesh (a block on the ranks whose index is 0 on every axis that
    does not cut it; a replicated leaf on rank 0 only), summed in one
    all-reduce (none when no leaf is cut)."""
    d, m = coords(mesh, mesh.rank)
    blocks, whole, cut = None, None, False
    for g, dd, md in zip(tree_leaves(grads), leaf_dims(grads, specs, mesh),
                         tree_leaves(tree_map(lambda x, s: model_dim(s, mesh),
                                              grads, specs))):
        sq = torch.sum(torch.square(g.float()))
        if dd is None and md is None:
            whole = sq if whole is None else whole + sq
            continue
        cut = True
        if (dd is not None or d == 0) and (md is not None or m == 0):
            blocks = sq if blocks is None else blocks + sq
    if not cut:
        return torch.sqrt(whole)
    if blocks is None:
        blocks = torch.zeros((), dtype=torch.float32,
                             device=tree_leaves(grads)[0].device)
    if whole is not None and mesh.rank == 0:
        blocks = blocks + whole
    return torch.sqrt(all_reduce_(blocks.reshape(1), mesh)[0])


@torch.no_grad()
def step(cfg: AdamWConfig, state: OptState, grads: Any, *, mesh=None,
         specs: Any = None) -> Tuple[OptState, Dict]:
    """One AdamW step on ``grads`` (any float type, the tree of
    ``state.master``).  With ``mesh`` (a group-bound mesh) and ``specs``
    (the sanitized specs of the master tree) the state and the gradients
    are this rank's blocks (``sharded_norm``).  Returns (state,
    {"grad_norm", "lr"})."""
    gnorm = (global_norm(grads) if mesh is None
             else sharded_norm(grads, specs, mesh))
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    t = state.step + 1
    lr = schedule(cfg, t)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.pow(b1, t.float())
    bc2 = 1 - torch.pow(b2, t.float())

    def upd(p, m, v, g):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mh = m / bc1
        vh = v / bc2
        p.sub_(lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p))

    def by_slabs(p, m, v, g):
        # each op is elementwise: a slab's numbers are the whole leaf's
        flat = [t.view(-1) for t in (p, m, v)] + [g.reshape(-1)]
        for i in range(0, flat[0].numel(), SLAB):
            upd(*(t[i:i + SLAB] for t in flat))

    tree_map(by_slabs, state.master, state.m, state.v, grads)
    return (OptState(state.master, state.m, state.v, t),
            {"grad_norm": gnorm, "lr": lr})


def cast_params(master: Any) -> Any:
    """bfloat16 working copy (leaves of other types kept as they are)."""
    return tree_map(
        lambda p: p.to(torch.bfloat16) if p.dtype == torch.float32 else p,
        master)
