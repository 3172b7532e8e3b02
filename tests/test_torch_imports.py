"""Boundaries of the PyTorch port: it loads neither JAX nor the reference
package, no file of it (or ``chip_smoke.py``) imports either, its entry
points run on the card unless the caller asks for the CPU, and its kernel
wrappers never fall back to the plain version for a tensor off the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.apps import bfs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import (expert_tickets, flash_attention,  # noqa
                                 frontier_expand, heap_apply,
                                 heap_insert_masked, heap_planes,
                                 heap_pop_count, ring_dequeue, wave_compact,
                                 wavefaa)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import init_decode_cache, init_params  # noqa: E402
from repro_torch.runtime import (HeapEngine, PriorityRoundRunner,  # noqa
                                 RingEngine, RoundRunner, heap_init,
                                 ring_init)
from repro_torch.serving import EngineConfig, ServingEngine  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def test_import_loads_neither_jax_nor_reference():
    code = ("import json, sys\n"
            "import repro_torch, repro_torch.apps.bfs, repro_torch.runtime\n"
            "import repro_torch.kernels, repro_torch.interop\n"
            "import repro_torch.models, repro_torch.serving\n"
            "import repro_torch.launch.serve, repro_torch.configs\n"
            "import repro_torch.sched, repro_torch.data, repro_torch.obs\n"
            "mods = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "print(json.dumps(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_files_import_no_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:            # relative: stays inside the package
                continue
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def _step(acc, vals, valid):
    return acc, vals[:, None], valid[:, None] & False


def _pstep(acc, keys, vals, valid):
    return acc, keys[:, None], vals[:, None], valid[:, None] & False


@pytest.mark.parametrize("entry", [
    lambda: RoundRunner(_step),
    lambda: RoundRunner(_step, fused=False),
    lambda: RingEngine(_step),
    lambda: ring_init(4),
    lambda: bfs.bfs_rounds_runner(bfs.road_like(16)),
    lambda: bfs.bfs_rounds(bfs.road_like(16)),
    lambda: PriorityRoundRunner(_pstep),
    lambda: PriorityRoundRunner(_pstep, fused=False),
    lambda: HeapEngine(_pstep),
    lambda: heap_init(4),
    lambda: bfs.bfs_queue(bfs.road_like(16)),
    lambda: bfs.bfs_baseline(bfs.road_like(16)),
    lambda: init_params(get_config("granite-moe-3b-a800m-smoke")),
    lambda: init_decode_cache(get_config("h2o-danube-1.8b-smoke"), 2, 8),
    lambda: ServingEngine(get_config("h2o-danube-1.8b-smoke"), {},
                          EngineConfig()),
    lambda: serve.main(["--arch", "granite-moe-3b-a800m"]),
], ids=["RoundRunner", "RoundRunner-legacy", "RingEngine", "ring_init",
        "bfs_rounds_runner", "bfs_rounds", "PriorityRoundRunner",
        "PriorityRoundRunner-legacy", "HeapEngine", "heap_init",
        "bfs_queue", "bfs_baseline", "init_params", "init_decode_cache",
        "ServingEngine", "launch.serve"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Without a card the default device raises; nothing runs on the CPU
    unless the caller passes device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_wrappers_do_not_fall_back_off_the_cpu():
    meta = dict(device="meta")
    mask = torch.zeros(1024, dtype=torch.bool, **meta)
    ctr = torch.zeros(1, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wavefaa(mask, ctr)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wave_compact(mask, (torch.zeros(1024, dtype=torch.int32, **meta),),
                     width=8)
    planes = [torch.zeros(32, dtype=torch.int32, **meta) for _ in range(4)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        ring_dequeue(*planes, torch.zeros(8, dtype=torch.int32, **meta),
                     nslots_log2=5, idx_bot=2 ** 31 - 1)
    lanes = [torch.zeros(8, dtype=torch.int32, **meta) for _ in range(3)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        heap_apply(*planes[:2], torch.zeros(1, dtype=torch.int32, **meta),
                   *lanes, cap_log2=5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        frontier_expand(torch.zeros(33, dtype=torch.int32, **meta),
                        *lanes[:2], planes[0], max_out=32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        expert_tickets(lanes[0], num_experts=8, capacity=4)
    q = torch.zeros(1, 2, 64, 32, **meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, q, q)
    # the plain-only heap faces have no kernel: they refuse every tensor
    # off the CPU instead of copying it to the host and back
    size = torch.zeros(1, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CPU tensors only"):
        heap_planes(*planes[:2], size, *lanes, cap_log2=5)
    with pytest.raises(ValueError, match="CPU tensors only"):
        heap_pop_count(*planes[:2], size, 4, batch=8, cap_log2=5)
    with pytest.raises(ValueError, match="CPU tensors only"):
        heap_insert_masked(*planes[:2], size, *lanes[:2],
                           lanes[2].bool(), cap_log2=5)


def test_cpu_entry_point_runs():
    dist, stats = bfs.bfs_rounds(bfs.road_like(64), device="cpu")
    assert stats["drained"] == 1
    side = np.arange(8)
    np.testing.assert_array_equal(dist, (side[:, None] + side).reshape(-1))
