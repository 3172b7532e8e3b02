"""One-card dry run: every (architecture x input shape) cell of the
registry built at full size, its roofline inputs counted, the cut that
fits one card worked out, and the cut cell run once on the card — the
one-card twin of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun          # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --force --jobs 7
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --arch gemma2-27b-smoke
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

A cell is keyed ``arch|shape|h100``.  A shape the config skips
(``cfg.skip_shapes``) is recorded as skipped with ``cfg.skip_reason``.
Otherwise the cell's step (``launch/steps.py``) is built on ``meta`` at
the shape's full batch and the config's full depth, and the record holds
the argument bytes (parameters, and the float32 master, m and v of a
training step; the batch; the decode cache), ``op_analysis``'s FLOPs, HBM
bytes and collective bytes (0), its eager peak of temporaries, and the
config's ``param_count`` and ``active_param_count``.

Then the cut that fits one card (``plan_cut``): the batch is cut first,
to the largest that fits; when one sequence does not fit at full depth,
the depth is cut next, in whole periods of the layer pattern (a period
holds each kind of layer once, so every attention config keeps a global
layer).  A cell fits when its arguments and its eager peak stay within
``FIT`` of the card's memory; each cut states the bytes that forced it.
On the card (``--device cuda``, the default) the cut cell's step then
runs from seeded random parameters: once to warm up, once timed, with
``torch.cuda.max_memory_allocated``; a cut the card refuses (out of
memory) is planned again at ``RETRY_SHARE`` of the budget, and the
record lists the refused plans.  ``--device cpu`` does the same on
the CPU within ``CPU_BUDGET_GB``, for the reduced configs
(``<arch>-smoke``).

The walks on ``meta`` are the sweep's long part and need no card:
``--jobs N`` runs the cells' walks and cuts (``analyze_cell``) in N
worker processes while this one runs the cut cells on the card, one at a
time, as their plans arrive.

Results accumulate in ``--out`` (``dryrun_results_h100.json``, listed in
``.gitignore``; completed cells are skipped on re-runs, ``--force``
recomputes).  ``python -m repro_torch.launch.roofline`` reads them.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import multiprocessing
import os
import time
import traceback
from typing import Dict, Optional

import torch

from ..configs import SHAPES, get_config, list_archs
from ..configs.base import ArchConfig
from ..kernels._build import resolve_device
from ..models import init_decode_cache, init_params
from ..optim import adamw
from ..tree import tree_leaves, tree_map
from . import op_analysis
from . import steps as S
from .roofline import PEAK_FLOPS, RESULTS_PATH, cell_report

MESH = "h100"
#: the share of the card's memory a cut may fill: the eager peak leaves
#: out the caching allocator's rounding and cuBLAS's workspaces
FIT = 0.88
CPU_BUDGET_GB = 0.5
#: a cut cell that runs out of memory on the card is planned again at
#: this share of the budget, up to ``TRIES`` plans in all
RETRY_SHARE, TRIES = 0.9, 4


def layer_period(cfg: ArchConfig) -> int:
    """Layers a depth cut keeps or drops together: the layer pattern, the
    hybrid's shared-block stride, the vlm's cross-layer stride, else 1."""
    if cfg.layer_pattern:
        return len(cfg.layer_pattern)
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        return cfg.shared_attn_every
    if cfg.family == "vlm" and cfg.cross_attn_every:
        return cfg.cross_attn_every
    return 1


def with_layers(cfg: ArchConfig, layers: int) -> ArchConfig:
    return (cfg if layers == cfg.n_layers
            else dataclasses.replace(cfg, n_layers=layers))


def _batch(cfg: ArchConfig, batch: int, seq: int, dev, gen,
           labels: bool) -> Dict[str, torch.Tensor]:
    if dev.type == "meta":
        out = S.batch_struct(cfg, "train_4k", batch=batch, seq=seq)
    else:
        out = {}
        if cfg.audio_frontend:
            out["frames"] = torch.randn(batch, seq, cfg.d_model,
                                        generator=gen, device=dev
                                        ).to(torch.bfloat16)
        else:
            out["tokens"] = torch.randint(0, cfg.vocab, (batch, seq),
                                          generator=gen, device=dev,
                                          dtype=torch.int32)
        out["labels"] = torch.randint(0, cfg.vocab, (batch, seq),
                                      generator=gen, device=dev,
                                      dtype=torch.int32)
        if cfg.family == "vlm":
            out["img"] = torch.randn(batch, cfg.n_image_tokens, cfg.d_model,
                                     generator=gen, device=dev
                                     ).to(torch.bfloat16)
    if not labels:
        out.pop("labels")
    return out


def build(cfg: ArchConfig, kind: str, batch: int, seq: int, *,
          device="meta", dtype=torch.bfloat16, seed: int = 0):
    """A cell's step and its arguments: ``kind`` "train" (the optimizer
    state and a batch with labels), "prefill" (parameters and a batch) or
    "decode" (parameters, a cache of ``seq`` positions, a token, ``cur``
    = seq - 1 and a vlm's image tokens).  On ``meta`` the structs of
    ``launch/steps.py``; elsewhere parameters drawn from a generator
    seeded ``seed`` and random tokens.  ``dtype`` casts the floating
    parameters (and the cache) of a prefill or decode."""
    dev = torch.device(device)
    if dev.type == "meta":
        gen = None
        params = S.params_struct(cfg)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = init_params(cfg, gen, device=dev)
    if kind == "train":
        state = adamw.init(params)
        del params
        return S.make_train_step(cfg), (state,
                                        _batch(cfg, batch, seq, dev, gen,
                                               True))
    if dtype != torch.bfloat16:
        params = tree_map(lambda t: t.to(dtype) if t.is_floating_point()
                          else t, params)
    if kind == "prefill":
        return S.make_prefill_step(cfg), (params,
                                          _batch(cfg, batch, seq, dev, gen,
                                                 False))
    cache = init_decode_cache(cfg, batch, seq, dtype, device=dev)
    token = (torch.empty(batch, 1, dtype=torch.int32, device=dev)
             if gen is None else torch.randint(
                 0, cfg.vocab, (batch, 1), generator=gen, device=dev,
                 dtype=torch.int32))
    args = (params, cache, token, seq - 1)
    if cfg.family == "vlm":
        args += (_batch(cfg, batch, 1, dev, gen, False)["img"].to(dtype),)
    return S.make_serve_step(cfg), args


def arg_bytes(args) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(args)
               if isinstance(t, torch.Tensor))


def _grad_mode(kind: str):
    return contextlib.nullcontext() if kind == "train" else torch.no_grad()


def footprint(cfg: ArchConfig, kind: str, batch: int, seq: int, *,
              dtype=torch.bfloat16):
    """(argument bytes, ``OpCosts``) of the cell's step on ``meta``."""
    fn, args = build(cfg, kind, batch, seq, dtype=dtype)
    with _grad_mode(kind):
        _, costs = op_analysis.analyze_step(fn, *args)
    return arg_bytes(args), costs


def plan_cut(cfg: ArchConfig, kind: str, batch: int, seq: int, *,
             budget: float, dtype=torch.bfloat16,
             layers: Optional[int] = None,
             footprints: Optional[Dict] = None) -> Dict:
    """The batch and depth (from ``layers``, the config's by default) at
    which the cell's arguments and eager peak fit in ``budget`` bytes:
    the batch cut first, then the depth in whole ``layer_period``s.
    Returns {"batch", "layers", "need_bytes", "budget_bytes", "cuts",
    "fits"}; each cut names what it cut, from and to what, and the bytes
    (arguments + peak) that forced it.  ``footprints`` keeps each
    ``footprint`` walked, by (batch, layers), across calls."""
    memo = {} if footprints is None else footprints

    def need(b: int, n: int) -> int:
        if (b, n) not in memo:
            memo[b, n] = footprint(with_layers(cfg, n), kind, b, seq,
                                   dtype=dtype)
        a, c = memo[b, n]
        return a + c.peak_bytes

    def largest(hi: int, bytes_at) -> int:
        """A large x in [1, hi] with bytes_at(x) <= budget, given
        bytes_at(1) <= budget: the bytes grow about linearly in x (a
        batch's rows, a depth's periods), so the line through x = 1 and
        2 guesses it; a guess that does not fit is bisected down."""
        if hi <= 1 or bytes_at(2) > budget:
            return 1
        step = max(bytes_at(2) - bytes_at(1), 1)
        x = min(hi, 2 + int((budget - bytes_at(2)) // step))
        if bytes_at(x) <= budget:
            return x
        lo, hi = 2, x - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if bytes_at(mid) <= budget else (lo, mid - 1)
        return lo

    b = batch
    n = cfg.n_layers if layers is None else layers
    cuts = []
    if need(b, n) > budget and b > 1:
        to = (largest(b - 1, lambda x: need(x, n))
              if need(1, n) <= budget else 1)
        cuts.append({"cut": "batch", "from": b, "to": to,
                     "forced_by_bytes": need(b, n)})
        b = to
    if need(b, n) > budget:
        p = layer_period(cfg)
        to = (largest(max(n // p - 1, 1), lambda k: need(b, k * p)) * p
              if need(b, p) <= budget else p)
        cuts.append({"cut": "layers", "from": n, "to": to,
                     "forced_by_bytes": need(b, n)})
        n = to
    return {"batch": b, "layers": n, "need_bytes": need(b, n),
            "budget_bytes": int(budget), "cuts": cuts,
            "fits": need(b, n) <= budget}


def card_budget(dev: torch.device) -> float:
    """The bytes a cut may fill on ``dev``."""
    if dev.type == "cuda":
        return FIT * torch.cuda.get_device_properties(dev).total_memory
    return CPU_BUDGET_GB * 1e9


def cut_model_flops(cfg: ArchConfig, kind: str, batch: int,
                    seq: int) -> float:
    """``roofline.model_flops`` of a cut cell."""
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch


def run_cut(cfg: ArchConfig, kind: str, batch: int, seq: int, dev) -> Dict:
    """The cut cell's step from seeded parameters: once to warm up, once
    timed (seconds, and on the card ``max_memory_allocated`` and the
    model FLOPs' share of ``PEAK_FLOPS``)."""
    cuda = dev.type == "cuda"
    gc.collect()                # a train step's graph holds cycles
    fn, args = build(cfg, kind, batch, seq, device=dev)
    with _grad_mode(kind):
        out = fn(*args)
        if kind == "train":
            args = (out[0],) + args[1:]
        del out
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    # the logits (the loss of a training step) are finite; a test of the
    # caches would take a bool tensor as large as they are
    head = out[1]["loss"] if kind == "train" else out[0]
    rec = {"seconds": seconds, "argument_bytes": arg_bytes(args),
           "finite": bool(torch.isfinite(head).all())}
    if cuda:
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        rec["model_flops_share"] = (cut_model_flops(cfg, kind, batch, seq)
                                    / seconds / PEAK_FLOPS)
    del out, args, fn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rec


def analyze_cell(arch: str, shape: str, budget: float):
    """A cell's walks on ``meta``: ({(batch, layers): footprint}, the cut
    at ``budget`` bytes, seconds).  Needs no card, so ``--jobs`` runs it
    in a worker process."""
    t0 = time.time()
    sh = SHAPES[shape]
    fps: Dict = {}
    plan = plan_cut(get_config(arch), sh["kind"], sh["global_batch"],
                    sh["seq_len"], budget=budget, footprints=fps)
    return fps, plan, time.time() - t0


def run_cell(arch: str, shape: str, results: dict, *, force: bool = False,
             device="cuda", analysis=None) -> dict:
    """The cell's record in ``results``: its walks (``analysis``, a future
    of ``analyze_cell``'s result, else walked here) and its cut run on
    ``device``."""
    key = f"{arch}|{shape}|{MESH}"
    cfg = get_config(arch)
    if shape in cfg.skip_shapes:
        rec = {"status": "skipped", "reason": cfg.skip_reason}
        results[key] = rec
        return rec
    if key in results and results[key].get("status") == "ok" and not force:
        return results[key]
    dev = resolve_device(device)
    sh = SHAPES[shape]
    kind, b, s = sh["kind"], sh["global_batch"], sh["seq_len"]
    budget, refused = card_budget(dev), []
    t0 = time.time()
    try:
        fps, plan, walk_s = (analysis.result() if analysis is not None
                             else analyze_cell(arch, shape, budget))
        t0 = time.time() - walk_s
        args, ops = fps[b, cfg.n_layers]
        for attempt in range(TRIES):
            if attempt:
                budget *= RETRY_SHARE
                plan = plan_cut(cfg, kind, b, s, budget=budget,
                                footprints=fps)
            if not plan["fits"]:
                raise MemoryError(f"one period of layers at batch "
                                  f"{plan['batch']} needs "
                                  f"{plan['need_bytes']} bytes, more than "
                                  f"{plan['budget_bytes']}")
            try:
                run = run_cut(with_layers(cfg, plan["layers"]), kind,
                              plan["batch"], s, dev)
                break
            except torch.cuda.OutOfMemoryError as e:
                # the eager peak on meta leaves out the allocator's
                # fragments: plan again below it
                refused.append({k: plan[k] for k in
                                ("batch", "layers", "need_bytes",
                                 "budget_bytes")}
                               | {"error": str(e)[:160]})
            # out of the handler: its traceback held the failed run's
            # tensors
            gc.collect()
            torch.cuda.empty_cache()
        else:
            raise MemoryError(f"out of memory at {TRIES} plans: {refused}")
        plan["out_of_memory_at"] = refused
        rec = {
            "status": "ok",
            "ndev": 1,
            "memory": {"argument_bytes": args,
                       "temp_bytes": ops.peak_bytes},
            "ops": {"flops_per_dev": ops.flops, "bytes_per_dev": ops.bytes,
                    "collective_bytes_per_dev": ops.collective_bytes,
                    "by_collective": ops.by_collective,
                    "dot_count": ops.dot_count,
                    "warnings": ops.warnings[:20]},
            "model_flops_note": {"params": cfg.param_count(),
                                 "active_params": cfg.active_param_count()},
            "cut": plan,
        }
        rec["run"] = run
        rec["seconds"] = round(time.time() - t0, 1)
        rec["roofline"] = {k: v for k, v in cell_report(key, rec).items()
                           if k in ("compute_s", "memory_s",
                                    "collective_s", "dominant",
                                    "useful_ratio", "roofline_fraction")}
        print(f"[ok] {key}: {rec['seconds']}s  flops={ops.flops:.3e}  "
              f"cut batch {plan['batch']} layers {plan['layers']}  "
              f"run {rec['run']['seconds']:.3f}s", flush=True)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec = {"status": "error", "seconds": round(time.time() - t0, 1),
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
        print(f"[ERROR] {key}: {type(e).__name__}: {str(e)[:200]}",
              flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    results[key] = rec
    return rec


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=RESULTS_PATH)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for the walks on meta (default "
                         "1: this process walks each cell before its run)")
    args = ap.parse_args(argv)

    if args.list:
        for a in list_archs():
            cfg = get_config(a)
            print(f"{a:26s} {cfg.family:7s} "
                  f"params={cfg.param_count()/1e9:7.2f}B "
                  f"skips={','.join(cfg.skip_shapes) or '-'}")
        return {}

    dev = resolve_device(args.device)
    # large cells allocate tens of GB at once: segments that grow keep
    # the freed pieces usable (set before the first allocation)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    def save() -> None:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    cells = [(a, sh) for a in ([args.arch] if args.arch else list_archs())
             for sh in ([args.shape] if args.shape else list(SHAPES))]
    done = set()
    if args.jobs > 1:
        todo = [(a, sh) for a, sh in cells
                if sh not in get_config(a).skip_shapes and (
                    args.force or results.get(f"{a}|{sh}|{MESH}", {})
                    .get("status") != "ok")]
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")
        ) as pool:
            futs = {pool.submit(analyze_cell, a, sh, card_budget(dev)):
                    (a, sh) for a, sh in todo}
            for fut in concurrent.futures.as_completed(futs):
                run_cell(*futs[fut], results, force=True, device=dev,
                         analysis=fut)
                done.add(futs[fut])
                save()
    for a, sh in cells:
        if (a, sh) not in done:
            run_cell(a, sh, results, force=args.force, device=dev)
            save()
    ok = sum(1 for r in results.values() if r.get("status") == "ok")
    sk = sum(1 for r in results.values() if r.get("status") == "skipped")
    err = sum(1 for r in results.values() if r.get("status") == "error")
    print(f"\n=== dry-run summary: {ok} ok, {sk} skipped, {err} errors "
          f"(of {len(results)} cells) -> {args.out}")
    return results


if __name__ == "__main__":
    main()
