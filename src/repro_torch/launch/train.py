"""Training driver: data -> train step (loss, backward, AdamW) -> async
checkpoints -> restart on failure — the PyTorch twin of
``repro/launch/train.py``, with the same options plus ``--device``
(``cuda`` by default).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch mamba2-130m-smoke --device cpu --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch hubert-xlarge-smoke --device cpu --steps 5

Like the reference it trains the reduced configuration of ``--arch``
unless ``--full`` is given, on ``synth_batch``'s batches, from random
parameters (a ``torch.Generator`` seeded 0).  The step is
``cast_params(state.master)`` as leaves that record a gradient,
``loss_fn``, its backward (on the card the flash kernels and their
backward for attention at 2,048 keys or more) and ``adamw.step``.
``--ckpt-dir`` runs the loop under ``RestartManager`` (checkpoints every
``--save-every`` steps, ``--inject-fault-at`` raises once at that step).
It prints the reference's lines, with tokens/s on the card.
``train_step(dp=)`` is the step of one rank of the sharded train step
over a mesh's data axis, ``train_step(tp=)`` over a ("data", "model")
mesh (``launch.steps.make_train_step(pspecs=, mesh=)``).
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import get_config
from ..configs.base import ArchConfig
from ..data.pipeline import DataConfig, synth_batch
from ..distributed.collectives import bucketed_psum
from ..distributed.fault_tolerance import RestartManager, StragglerDetector
from ..distributed.sharding import (DataParallel, TensorParallel,
                                    all_reduce_, leaf_dims)
from ..kernels._build import resolve_device
from ..models import init_params, loss_fn, loss_terms
from ..models.transformer import model_partial
from ..optim import adamw
from ..tree import tree_leaves, tree_map


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A ``synth_batch`` (numpy arrays) as tensors on ``device``, the audio
    family's ``frames`` and the vlm family's ``img`` in bfloat16, as the
    reference's ``launch/steps.py: batch_struct`` declares them (its
    forward casts the frames itself and takes ``img`` in the
    activations' type)."""
    out = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    for k in ("frames", "img"):
        if k in out:
            out[k] = out[k].to(torch.bfloat16)
    return out


def train_step(cfg: ArchConfig, ocfg: adamw.AdamWConfig,
               state: adamw.OptState, batch: Dict[str, torch.Tensor], *,
               groups: int = 1,
               dp: Optional[DataParallel] = None,
               tp: Optional[TensorParallel] = None
               ) -> Tuple[adamw.OptState, Dict]:
    """One step: the loss and its gradient at ``cast_params(master)``, then
    ``adamw.step``.  Returns (state, {"loss", "grad_norm", "lr"}), each a
    0-dim tensor on the state's device (nothing is read back).  A leaf
    the loss does not read (the audio family's ``embed``) gets a zero
    gradient, as ``jax.grad`` gives it.  ``groups``: the MoE's dispatch
    groups on one card.

    With ``dp`` the state holds this rank's blocks under ``dp.specs`` and
    ``batch`` this rank's rows (every row when ``dp.batch_sharded`` is
    False).  The loss is the global mean: the ranks' sums of the masked
    cross-entropy and their label counts are added (one all-reduce)
    before the backward, which takes each rank's sum over the global
    count.  The sharded leaves' gradients are reduce-scattered by the
    gathers' backward; the replicated leaves' are summed in float32 over
    the ranks (``bucketed_psum``); AdamW updates the blocks
    (``adamw.step(mesh=)``).  With the batch whole on every rank, each
    rank's gradient is already the whole one and nothing is summed.

    With ``tp`` (a ("data", "model") mesh: dense and moe) the state holds
    this rank's blocks under ``tp.specs`` and ``batch`` its data index's
    rows.  The loss terms are equal on the ranks of "model"
    (``loss_terms(tp=)``) and are summed over "data" before the
    backward.  The gradients of the leaves cut over "data" are
    reduce-scattered by the gathers' backward; those of the leaves a
    rank holds whole over "data" are summed over it, and a leaf whole
    over "model" whose gradient is a term of a sum over "model"
    (``models.transformer.model_partial``) is summed over "model" too,
    each in float32 (``bucketed_psum`` over the mesh, its data or its
    model sub-group)."""
    if tp is not None:
        return _train_step_tp(cfg, ocfg, state, batch, tp)
    params = tree_map(lambda p: p.detach().requires_grad_(),
                      adamw.cast_params(state.master))
    leaves = tree_leaves(params)
    if dp is None:
        loss = loss_fn(params, batch, cfg, groups=groups)
        scale, total = None, loss
    else:
        total, count = loss_terms(params, batch, cfg, dp=dp)
        sums = torch.stack([total.detach(), count])
        if dp.batch_sharded:
            all_reduce_(sums, dp.mesh)
        denom = torch.clamp(sums[1], min=1.0)
        loss, scale = sums[0] / denom, 1.0 / denom
    grads = list(torch.autograd.grad(total, leaves, grad_outputs=scale,
                                     allow_unused=True,
                                     materialize_grads=True))
    if dp is not None and dp.batch_sharded:
        whole = [i for i, d in enumerate(leaf_dims(params, dp.specs,
                                                   dp.mesh)) if d is None]
        for i, g in zip(whole, bucketed_psum([grads[i].float()
                                              for i in whole], dp.mesh)):
            grads[i] = g
    it = iter(grads)
    grads = tree_map(lambda p: next(it), params)
    loss = loss.detach()
    del params, leaves          # the bfloat16 copy, before the update
    state, metrics = adamw.step(ocfg, state, grads,
                                mesh=None if dp is None else dp.mesh,
                                specs=None if dp is None else dp.specs)
    metrics["loss"] = loss
    return state, metrics


def _train_step_tp(cfg: ArchConfig, ocfg: adamw.AdamWConfig,
                   state: adamw.OptState, batch: Dict[str, torch.Tensor],
                   tp: TensorParallel) -> Tuple[adamw.OptState, Dict]:
    params = tree_map(lambda p: p.detach().requires_grad_(),
                      adamw.cast_params(state.master))
    leaves = tree_leaves(params)
    total, count = loss_terms(params, batch, cfg, tp=tp)
    sums = torch.stack([total.detach(), count])
    data = tp.batch_sharded and tp.data_mesh is not None
    if data:
        all_reduce_(sums, tp.data_mesh)
    denom = torch.clamp(sums[1], min=1.0)
    loss = sums[0] / denom
    grads = list(torch.autograd.grad(total, leaves, grad_outputs=1.0 / denom,
                                     allow_unused=True,
                                     materialize_grads=True))
    sp = cfg.seq_parallel and batch["tokens"].shape[1] % tp.model == 0
    for mesh, idx in grad_sums(tp.specs, tp.mesh, sp, data).items():
        for i, g in zip(idx, bucketed_psum([grads[i].float() for i in idx],
                                           getattr(tp, mesh))):
            grads[i] = g
    it = iter(grads)
    grads = tree_map(lambda p: next(it), params)
    del params, leaves
    state, metrics = adamw.step(ocfg, state, grads, mesh=tp.mesh,
                                specs=tp.specs)
    metrics["loss"] = loss.detach()
    return state, metrics


def grad_sums(specs: Any, mesh, sp: bool, data: bool) -> Dict[str, list]:
    """The leaves (indices in ``tree_leaves`` order of the sanitized
    parameter ``specs``) whose gradients a rank of a ("data", "model")
    ``mesh`` sums, by the ``TensorParallel`` mesh they are summed over:
    ``"mesh"`` (whole over "data" with the batch split over it, and a
    term of a sum over "model"), ``"data_mesh"`` (whole over "data", the
    gradient whole over "model") and ``"model_mesh"`` (a term of a sum
    over "model", its sum over "data" done or not needed).  ``sp``: the
    step's sequence parallelism; ``data``: the batch split over more
    than one data shard."""
    part = model_partial(specs, mesh, sp)
    out = {"mesh": [], "data_mesh": [], "model_mesh": []}
    for i, d in enumerate(leaf_dims(specs, specs, mesh)):
        whole = d is None and data
        if part[i]:
            out["mesh" if whole else "model_mesh"].append(i)
        elif whole:
            out["data_mesh"].append(i)
    return {k: v for k, v in out.items() if v}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--inject-fault-at", type=int, default=None,
                    help="simulate a node failure at this step (demo)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch)
    ocfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=5,
                             total_steps=args.steps)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"device={dev}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = adamw.init(init_params(cfg, gen, device=dev))
    detector = StragglerDetector(n_pods=1)
    losses: Dict[int, float] = {}

    def step_fn(state, i):
        t0 = time.time()
        batch = batch_to_device(synth_batch(cfg, dcfg, i), dev)
        state, metrics = train_step(cfg, ocfg, state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        losses[i] = loss
        detector.heartbeat(i, 0, dt)
        if i % 10 == 0 or i == args.steps - 1:
            rate = (f"  {args.batch * args.seq / dt:.0f} tok/s"
                    if dev.type == "cuda" else "")
            print(f"step {i:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{dt*1e3:.0f}ms{rate}")
        return state

    restarts = 0
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        rm = RestartManager(ckpt, save_every=args.save_every)
        final, state = rm.run(state, step_fn, num_steps=args.steps,
                              inject_fault_at=args.inject_fault_at)
        restarts = rm.restarts
        print(f"done at step {final} (restarts: {restarts})")
    else:
        for i in range(args.steps):
            state = step_fn(state, i)
        final = args.steps
        print("done")
    return {"step": final, "restarts": restarts, "losses": losses,
            "state": state}


if __name__ == "__main__":
    main()
