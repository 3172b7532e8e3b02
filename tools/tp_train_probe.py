"""Phase ``tp_train`` of ``chip_smoke.py`` alone: the train step over the
"model" axis across ranks, without the other phases.

Run from the repo root on a machine with one CUDA card or more::

    python3 tools/tp_train_probe.py

It builds the kernels (``_build.build_all``), runs ``Smoke.tp_train_path``
as ``chip_smoke.py`` does (each case's one-card step, then two gloo ranks
sharing card 0 on a (1, 2) mesh against it, with B7 with its lse, the
flash backward and B6 held against their plain versions on rank 0's
inputs; with four cards also yi-34b and gemma2-27b over four NCCL ranks,
a card a rank, on (1, 4) and (2, 2) meshes at the deepest cut whose state
and activations stay under 0.88 of a card: ``chip_smoke.tt_full``), and
prints the phase's JSON line, the cards' name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``) and
the seconds it took.  ``--out FILE`` also writes the phase's line to
FILE.  A failed check raises, as in ``chip_smoke.py``.
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
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch import kernels as K
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("tp_train_probe: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = _build.build_all()
    print(json.dumps({"build_s": build["seconds"]}), flush=True)
    smoke = cs.Smoke(torch, np)
    line = json.dumps(smoke.tp_train_path(K))
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
