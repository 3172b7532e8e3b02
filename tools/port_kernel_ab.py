#!/usr/bin/env python3
"""Time one checkout's B1 (``wavefaa``) and B6 (``expert_tickets``)
kernels of the PyTorch port on the card, so that two checkouts can be
compared in one call.

    python3 tools/port_kernel_ab.py --src PATH/TO/CHECKOUT/src --label A

imports ``repro_torch`` from ``--src`` (its kernels build into that
checkout's ``build/repro_torch``) and prints one JSON line: the per-call
device time in microseconds of ``wavefaa`` at the road path's child wave
(4,096 lanes at density 0.2) and of ``expert_tickets`` at a decode step
(32 pairs) and at a prefill (65,536 pairs), 40 experts, each the median
of 5 batches of 50 calls timed with CUDA events behind a
``torch.cuda._sleep`` (``chip_smoke.py``'s ``Smoke.time_ms``), beside
the card's name and power limit.  Run two checkouts in turns in one call
(A, B, B, A): a number from another call does not compare.  Needs a CUDA
card; exits 2 without one.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="a checkout's src directory")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("port_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import Smoke
    from repro_torch import kernels as K
    smoke = Smoke(torch, np)
    dev = smoke.dev
    rng = np.random.default_rng(5)
    mask = torch.as_tensor(rng.random(4096) < 0.2, device=dev)
    counter = torch.tensor([1 << 24], dtype=torch.int32, device=dev)
    out = {"label": args.label, "src": args.src,
           "repro_torch": K.__file__}
    out["wavefaa_4096_us"] = smoke.time_ms(
        lambda: None, lambda a, i: K.wavefaa(mask, counter))[0] * 1e3
    for name, n in (("decode_32", 32), ("prefill_65536", 65536)):
        ids = torch.as_tensor(rng.integers(0, 40, n, dtype=np.int32),
                              device=dev)
        kw = dict(num_experts=40, capacity=2080)
        want = K.expert_tickets_plain(ids, **kw)
        if not torch.equal(K.expert_tickets(ids, **kw), want):
            raise AssertionError(f"expert_tickets differs at {name}")
        out[f"expert_tickets_{name}_us"] = smoke.time_ms(
            lambda: None, lambda a, i: K.expert_tickets(ids, **kw))[0] * 1e3
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
