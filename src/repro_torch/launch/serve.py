"""Serving driver: continuous-batching engine over the queue substrate —
the PyTorch twin of ``repro/launch/serve.py``, with the same options plus
``--device`` (``cuda`` by default).

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m-smoke --device cpu

Like the reference it serves the reduced configuration of ``--arch``
with random parameters (seed 0).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..kernels._build import resolve_device
from ..models import init_params
from ..serving.engine import EngineConfig, Request, ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--pages", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    eng = ServingEngine(cfg, params, EngineConfig(
        max_slots=args.slots, num_pages=args.pages, page_size=32,
        max_seq=max(64, args.prompt_len + args.max_new + 1)), device=dev)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for rid in range(args.requests):
        ok = eng.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new))
        print(f"submit {rid}: {'ok' if ok else 'ring full'}")
    metrics = eng.run(max_ticks=2000)
    dt = time.time() - t0
    print(f"\ncompleted {metrics['completed']}/{args.requests} requests, "
          f"{metrics['tokens_out']} tokens in {dt:.1f}s "
          f"({metrics['tokens_out']/dt:.1f} tok/s) on {dev}")
    print(f"decode steps: {metrics['decode_steps']}  "
          f"page stalls (ring RETRY path): {metrics['page_stalls']}")


if __name__ == "__main__":
    main()
