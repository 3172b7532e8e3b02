"""Phase ``tp_serve`` of ``chip_smoke.py`` alone: the serve steps over the
"model" axis across ranks, without the other phases.

Run from the repo root on a machine with one CUDA card or more::

    python3 tools/tp_serve_probe.py

It builds the kernels (``_build.build_all``), runs ``Smoke.tp_serve_path``
as ``chip_smoke.py`` does (the one-card steps, then two gloo ranks sharing
card 0 on a (1, 2) mesh; with four cards also the full-depth cases over
four NCCL ranks, a card a rank: yi-34b at 60 layers, gemma2-27b's
524,288-token prefill at 46 layers, deepseek-moe-16b's float32 serve at
28 layers), then holds B6 and B7 against their plain versions on the
ranks' inputs as the phase does, and prints the phase's JSON line, the
cards' name and power limit (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``) and the seconds it
took.  ``--out FILE`` also writes the phase's line to FILE; ``--keep
DIR`` writes the four-card moe check's inputs to ``DIR/tp_moe_check.pt``.
A failed check raises, as in ``chip_smoke.py``.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the phase's JSON line here")
    ap.add_argument("--keep", default=None,
                    help="a directory for the four-card moe check's inputs "
                         "(routes, logit differences, margins)")
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch import kernels as K
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("tp_serve_probe: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = _build.build_all()
    print(json.dumps({"build_s": build["seconds"]}), flush=True)
    smoke = cs.Smoke(torch, np)
    if args.keep:
        Path(args.keep).mkdir(parents=True, exist_ok=True)
        smoke.tp_keep = args.keep
    line = json.dumps(smoke.tp_serve_path(K))
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(json.dumps({"checked": smoke.cases, "max_abs_err": smoke.err,
                      "bound_used": smoke.bound_used}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
