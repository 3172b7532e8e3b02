"""Roofline report: the three terms per (architecture x shape) cell of
the one-card dry run — the PyTorch twin of ``repro/launch/roofline.py``.

    compute    = op_FLOPs / PEAK_FLOPS
    memory     = op_bytes / HBM_BW
    collective = collective_bytes / NVLINK_BW   (0 on one card)

The op quantities come from ``launch/op_analysis.py`` (``launch/dryrun.py``
stores them under ``ops`` in its results).  MODEL_FLOPS = 6·N·D for a
training step, 2·N·D for a prefill and 2·N per sequence for a decode step
(N_active for MoE) cross-checks the counted compute; the ratio shows what
the step computes beyond the model's own products (attention, the
recomputed forward of remat, and the masked (query, key) tiles the count
keeps).  ``roofline_fraction`` is the model FLOPs' share of the peak over
the time of the dominant term.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        [--results FILE] [--md]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

from ..configs import SHAPES, get_config

#: where ``launch/dryrun.py`` keeps its results (listed in .gitignore)
RESULTS_PATH = "dryrun_results_h100.json"

# NVIDIA H100 SXM5 80 GB, data-sheet figures
PEAK_FLOPS = 989e12     # dense bfloat16 tensor-core FLOP/s
HBM_BW = 3.35e12        # HBM3, B/s
NVLINK_BW = 450e9       # NVLink 4, B/s each direction


def model_flops(arch: str, shape: str) -> float:
    cfg = get_config(arch)
    sh = SHAPES[shape]
    n = cfg.active_param_count()
    if sh["kind"] == "train":
        tokens = sh["global_batch"] * sh["seq_len"]
        return 6.0 * n * tokens
    if sh["kind"] == "prefill":
        tokens = sh["global_batch"] * sh["seq_len"]
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * sh["global_batch"]


def cell_report(key: str, rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "ok":
        return None
    arch, shape, mesh = key.split("|")
    ndev = rec["ndev"]
    ops = rec["ops"]
    compute = ops["flops_per_dev"] / PEAK_FLOPS
    memory = ops["bytes_per_dev"] / HBM_BW
    coll = ops["collective_bytes_per_dev"] / NVLINK_BW
    terms = {"compute": compute, "memory": memory, "collective": coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mf = model_flops(arch, shape)
    mf_dev = mf / ndev
    useful_ratio = mf_dev / max(ops["flops_per_dev"], 1.0)
    # roofline fraction: useful model flops per device over the time the
    # dominant term implies, vs peak
    frac = (mf_dev / PEAK_FLOPS) / max(bound, 1e-30)
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "ndev": ndev,
        "compute_s": compute, "memory_s": memory, "collective_s": coll,
        "dominant": dominant, "model_flops_per_dev": mf_dev,
        "useful_ratio": useful_ratio, "roofline_fraction": frac,
        "temp_gib": rec["memory"]["temp_bytes"] / 2 ** 30,
        "arg_gib": rec["memory"]["argument_bytes"] / 2 ** 30,
        "by_collective": ops.get("by_collective", {}),
        "warnings": ops.get("warnings", []),
    }


MITIGATION = {
    "compute": "raise useful-FLOP share: cheaper remat policy / fewer "
               "recomputed tiles / larger per-card batch",
    "memory": "fuse / shrink materialized intermediates; bf16 residuals; "
              "keep tiles on chip in hand-written kernels",
    "collective": "reshard to cut the bytes each card exchanges; overlap "
                  "with bucketed collectives",
}


def build_report(results: Dict) -> Dict[str, Dict]:
    out = {}
    for key, rec in sorted(results.items()):
        r = cell_report(key, rec)
        if r is not None:
            out[key] = r
    return out


def to_markdown(report: Dict[str, Dict], results: Dict) -> str:
    lines = [
        "| arch | shape | mesh | compute (s) | memory (s) | collective (s) |"
        " dominant | MODEL/op flops | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key, r in report.items():
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.1%} |")
    for key, rec in sorted(results.items()):
        if rec.get("status") == "skipped":
            a, s, m = key.split("|")
            lines.append(f"| {a} | {s} | {m} | — | — | — | skipped |"
                         f" {rec['reason'][:40]} | — |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=RESULTS_PATH)
    ap.add_argument("--md", action="store_true")
    args = ap.parse_args(argv)
    with open(args.results) as f:
        results = json.load(f)
    report = build_report(results)
    if args.md:
        print(to_markdown(report, results))
        return
    for key, r in report.items():
        print(f"{key:48s} C={r['compute_s']:.2e} M={r['memory_s']:.2e} "
              f"X={r['collective_s']:.2e} dom={r['dominant']:10s} "
              f"frac={r['roofline_fraction']:6.1%} "
              f"useful={r['useful_ratio']:.2f} temp={r['temp_gib']:.1f}GiB")
        print(f"{'':48s} -> {MITIGATION[r['dominant']]}")


if __name__ == "__main__":
    main()
