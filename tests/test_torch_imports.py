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

from repro_torch.apps import bfs, raytrace, sssp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import (expert_tickets, flash_attention,  # noqa
                                 frontier_expand, heap_apply,
                                 heap_apply_grid, heap_insert_masked,
                                 heap_planes,
                                 heap_pop_count, ring_dequeue,
                                 ring_dequeue_wave, ring_enqueue_wave,
                                 wave_compact, wavefaa)
from repro_torch.core import (QUEUE_CLASSES, AtomicMemory,  # noqa
                              Scheduler, check_linearizable, dist_heap_init,
                              dist_queue_init, dist_sharded_queue_init,
                              fast_violation_screen, run_balanced,
                              run_producer_consumer)
from repro_torch.distributed import make_mesh  # noqa: E402
from repro_torch.kernels import (claim_schedule, deq_planes,  # noqa
                                 enq_planes, priority_claim_schedule)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import init_decode_cache, init_params  # noqa: E402
from repro_torch.runtime import (ExecutorConfig, HeapEngine,  # noqa
                                 HostTaskPool, MeshHeapEngine,
                                 MeshRingEngine, MeshRoundRunner,
                                 PriorityFabric, PriorityMeshRoundRunner,
                                 PriorityRoundRunner, RingEngine,
                                 RoundRunner, ShardedMeshRingEngine,
                                 TaskFabric, TaskRuntime, TaskSpec,
                                 heap_init, mesh_task_round, ring_init)
from repro_torch.sched import (GPQ, RelaxedGPQ,  # noqa: E402
                               check_p_linearizable,
                               check_p_linearizable_search,
                               mesh_relaxation_bound, mesh_trace_history)
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
            "import repro_torch.core, repro_torch.distributed\n"
            "import repro_torch.runtime.meshrounds\n"
            "import repro_torch.apps.sssp, repro_torch.apps.raytrace\n"
            "import repro_torch.serving.admission\n"
            "import repro_torch.serving.traffic\n"
            "import repro_torch.core.sim, repro_torch.core.linearizability\n"
            "import repro_torch.sched.gpq, repro_torch.sched.relaxed\n"
            "import repro_torch.sched.plinearizability\n"
            "import repro_torch.runtime.taskpool\n"
            "import repro_torch.runtime.executor\n"
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
    lambda: MeshRoundRunner(_step, mesh=make_mesh((2,), ("data",))),
    lambda: MeshRoundRunner(_step, mesh=make_mesh((2,), ("data",)),
                            fused=False),
    lambda: MeshRingEngine(_step, mesh=make_mesh((2,), ("data",))),
    lambda: ShardedMeshRingEngine(_step, mesh=make_mesh((2,), ("data",))),
    lambda: dist_queue_init(16),
    lambda: dist_sharded_queue_init(16, 2),
    lambda: bfs.bfs_mesh_rounds(bfs.road_like(16), shards=2),
    lambda: claim_schedule(5, 2, 4),
    lambda: priority_claim_schedule(5, 2, 4, [0, 1], [3, 3]),
    lambda: PriorityMeshRoundRunner(_pstep, mesh=make_mesh((2,), ("data",))),
    lambda: PriorityMeshRoundRunner(_pstep, mesh=make_mesh((2,), ("data",)),
                                    fused=False, relaxed=False),
    lambda: MeshHeapEngine(_pstep, mesh=make_mesh((2,), ("data",))),
    lambda: dist_heap_init(16),
    lambda: sssp.sssp_mesh_rounds_runner(bfs.road_like(16),
                                         np.ones(48, np.int32)),
    lambda: sssp.sssp_mesh_rounds(bfs.road_like(16), np.ones(48, np.int32),
                                  shards=2),
    lambda: raytrace.render_runtime(raytrace.cornell_scene(), 16, 16),
], ids=["RoundRunner", "RoundRunner-legacy", "RingEngine", "ring_init",
        "bfs_rounds_runner", "bfs_rounds", "PriorityRoundRunner",
        "PriorityRoundRunner-legacy", "HeapEngine", "heap_init",
        "bfs_queue", "bfs_baseline", "init_params", "init_decode_cache",
        "ServingEngine", "launch.serve", "MeshRoundRunner",
        "MeshRoundRunner-legacy", "MeshRingEngine", "ShardedMeshRingEngine",
        "dist_queue_init", "dist_sharded_queue_init", "bfs_mesh_rounds",
        "claim_schedule", "priority_claim_schedule",
        "PriorityMeshRoundRunner", "PriorityMeshRoundRunner-legacy",
        "MeshHeapEngine", "dist_heap_init", "sssp_mesh_rounds_runner",
        "sssp_mesh_rounds", "render_runtime"])
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
    # the functional heap faces (rider included) run heap_apply on
    # copies: a tensor off the CPU goes to the kernel or raises, and is
    # never copied to the host and back
    size = torch.zeros(1, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        heap_planes(*planes[:2], size, *lanes, cap_log2=5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        heap_planes(*planes[:2], size, *lanes, cap_log2=5, rider=planes[2],
                    oprider=lanes[0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        heap_pop_count(*planes[:2], size, 4, batch=8, cap_log2=5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        heap_insert_masked(*planes[:2], size, *lanes[:2],
                           lanes[2].bool(), cap_log2=5)
    # the packed ring waves and the round's record
    head = torch.zeros((), dtype=torch.int32, **meta)
    live = torch.ones((), dtype=torch.bool, **meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ring_dequeue_wave(*planes, head, head, live, batch=8,
                          nslots_log2=5, idx_bot=2 ** 31 - 1,
                          birth_packed=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ring_enqueue_wave(*planes, head, head, lanes[0], live, capacity=16,
                          nslots_log2=5, idx_bot=2 ** 31 - 1,
                          mask=lanes[1].bool(), birth_round=head)
    # the functional ring faces and the mesh's sharded waves
    tickets = torch.zeros(8, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        enq_planes(*planes, tickets, tickets, 0, nslots_log2=5,
                   idx_bot=2 ** 31 - 1, active=lanes[1].bool())
    with pytest.raises(ValueError, match="CUDA tensors"):
        deq_planes(*planes, tickets, nslots_log2=5, idx_bot=2 ** 31 - 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ring_dequeue_wave(*planes, head, head, live, batch=4, shards=2,
                          nslots_log2=5, idx_bot=2 ** 31 - 1)
    rows = [p.reshape(2, 16) for p in planes]
    pair = torch.zeros(2, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ring_enqueue_wave(*rows, pair, pair, tickets, live, capacity=16,
                          nslots_log2=4, idx_bot=2 ** 31 - 1,
                          mask=tickets.bool())
    # the heap grid (the priority mesh's waves), both modes
    grid = [p.reshape(2, 16) for p in planes[:3]]
    for wave in (dict(counts=pair, batch=4),
                 dict(opkeys=tickets, opvals=tickets, dest=tickets)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            heap_apply_grid(*grid[:2], pair, cap_log2=4, **wave)
        with pytest.raises(ValueError, match="CUDA tensors"):
            heap_apply_grid(*grid[:2], pair, cap_log2=4, rider=grid[2],
                            **wave)
    from repro_torch.obs import obs_record, span_init, trace_init
    tp = trace_init(4, device="cpu")._replace(count=head)
    sp = span_init(1, lanes=8, device="cpu")._replace(round=head)
    wave = dict(keys=lanes[0], valid=lanes[1].bool(), ref=lanes[0],
                births=lanes[2], k=head, total=head, occ=head, over=live)
    with pytest.raises(ValueError, match="CUDA tensors"):
        obs_record(tp, sp, **wave)
    # the kernel reads raw memory: what the plain version would convert
    # (another integer type, a strided lane, a missing input) is refused
    strided = torch.zeros(16, dtype=torch.int32, **meta)[::2]
    for key, bad, match in [("keys", lanes[0].long(), "keys must be"),
                            ("births", strided, "births must be a contig"),
                            ("cls", lanes[2].long(), "cls must be"),
                            ("k", head.long(), "k must be"),
                            ("over", head, "over must be"),
                            ("ref", None, "ref is required")]:
        with pytest.raises(ValueError, match=match):
            obs_record(tp, sp, **{**wave, key: bad})


def test_cpu_entry_point_runs():
    dist, stats = bfs.bfs_rounds(bfs.road_like(64), device="cpu")
    assert stats["drained"] == 1
    side = np.arange(8)
    np.testing.assert_array_equal(dist, (side[:, None] + side).reshape(-1))
