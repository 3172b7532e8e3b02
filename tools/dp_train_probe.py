"""Phase ``dp_train`` of ``chip_smoke.py`` alone: the sharded train step
across ranks, without the other phases.

Run from the repo root on a machine with one CUDA card or more::

    python3 tools/dp_train_probe.py

It builds the kernels (``_build.build_all``), runs ``Smoke.dp_train_path``
as ``chip_smoke.py`` does (the one-card steps, the gloo ranks sharing card
0; with two cards or more the NCCL ranks, a card a rank; with four,
zamba2-7b at all 81 layers over four NCCL ranks), and prints the phase's
JSON line, then the cards' name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``) and
the seconds it took.  A failed check raises, as in ``chip_smoke.py``.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch import kernels as K
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("dp_train_probe: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = _build.build_all()
    print(json.dumps({"build_s": build["seconds"]}), flush=True)
    smoke = cs.Smoke(torch, np)
    print(json.dumps(smoke.dp_train_path(K)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
