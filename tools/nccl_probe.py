"""The NCCL form of the queue meshes on four cards, one card a rank.

Run from the repo root on a machine with four CUDA cards::

    python3 tools/nccl_probe.py

It prints one JSON line a stage:

1. ``one_card``: the multicard cells of ``chip_smoke.py`` (at its ``MC_*``
   cut) on the one-card stacked engine;
2. ``nccl_cells``: the same cells on four NCCL ranks, the rounds issued
   from the host, each rank's result held bit for bit against stage 1
   (``mismatches`` lists any), with µs a round and collectives a round;
3. ``graph_capture``: one all-reduce captured in a CUDA graph
   (``capture_error_mode="thread_local"``) and replayed three times;
4. ``while_capture``: the same capture as the body of ``csrc/loop.cu``'s
   conditional WHILE node (``repro_loop_create``'s return code), launched
   where it builds.

Stages 3 and 4 run in spawns of their own that are killed after
``PROBE_TIMEOUT`` seconds; a killed spawn reports ``"hung": true`` and
each rank's last stage.
"""
import ctypes
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

WORLD = 4
PROBE_TIMEOUT = 30
CELLS = ["fifo_tree", "fifo_tree_sharded", "fifo_tree_sharded_compact",
         "bfs_road", "sssp_road", "task_round", "admission"]
T0 = time.perf_counter()


def emit(obj):
    obj["elapsed_s"] = time.perf_counter() - T0
    print(json.dumps(obj), flush=True)


def capture_rank(rank, world, store, outdir, what):
    """One rank of stage 3 (``what="graph"``) or 4 (``"while"``): five
    rounds of ``buf[rank] = occ + 10 rank; all_reduce(buf); acc += buf;
    occ -= 1``, captured once."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import _build

    def mark(s):
        (Path(outdir) / f"rank{rank}.stage").write_text(s)
    mark("started")
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method="file://" + store,
                            world_size=world, rank=rank)
    out = {}
    try:
        i32 = dict(dtype=torch.int32, device=dev)
        buf = torch.zeros((world, 1), **i32)
        occ = torch.full((), 5, **i32)
        acc = torch.zeros(world, **i32)
        rounds = torch.zeros((), **i32)
        oflow = torch.zeros((), dtype=torch.bool, device=dev)
        limit = torch.full((), 100, **i32)

        def body():
            buf.zero_()
            buf[rank] = occ + 10 * rank
            dist.all_reduce(buf)
            acc.add_(buf.reshape(-1))
            occ.sub_(1)
            rounds.add_(1)
        body()                          # warms the communicator up
        torch.cuda.synchronize()
        occ.fill_(5)
        acc.zero_()
        rounds.zero_()
        mark("warm-up done")
        g = torch.cuda.CUDAGraph(keep_graph=what == "while")
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            body()
        mark("captured")
        if what == "graph":
            for _ in range(3):
                g.replay()
            torch.cuda.synchronize()
            mark("replayed")
        else:
            lib = _build.library("loop")
            graph, exe = ctypes.c_void_p(), ctypes.c_void_p()
            rc = lib.repro_loop_create(
                g.raw_cuda_graph(), occ.data_ptr(), oflow.data_ptr(),
                rounds.data_ptr(), limit.data_ptr(), None,
                ctypes.byref(graph), ctypes.byref(exe))
            out["loop_create_rc"] = rc
            mark(f"loop_create rc={rc}")
            if rc == 0:
                out["loop_launch_rc"] = lib.repro_loop_launch(
                    exe.value, torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                mark("loop done")
        out.update(acc=acc.tolist(), rounds=int(rounds), occ=int(occ))
        dist.barrier()
    except Exception as e:
        out["error"] = f"{type(e).__name__}: {e}"[:600]
    finally:
        dist.destroy_process_group()
    with open(Path(outdir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


def spawn_capture(what):
    """``capture_rank`` on WORLD spawned ranks, killed after
    PROBE_TIMEOUT seconds: {"hung", "s", "ranks": {rank: {"stage",
    "out"}}}."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            capture_rank, args=(WORLD, str(Path(tmp) / "store"), tmp, what),
            nprocs=WORLD, join=False, start_method="spawn")
        t0 = time.perf_counter()
        hung = False
        while not ctx.join(timeout=2):
            if time.perf_counter() - t0 > PROBE_TIMEOUT:
                hung = True
                for p in ctx.processes:
                    p.kill()
                for p in ctx.processes:
                    p.join()
                break
        ranks = {}
        for r in range(WORLD):
            st, js = (Path(tmp) / f"rank{r}.stage",
                      Path(tmp) / f"rank{r}.json")
            ranks[r] = {"stage": st.read_text() if st.exists() else None,
                        "out": json.loads(js.read_text())
                        if js.exists() else None}
        return {"hung": hung, "s": time.perf_counter() - t0, "ranks": ranks}


def main():
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.distributed import make_mesh
    from repro_torch.kernels import _build
    if torch.cuda.device_count() < WORLD:
        sys.exit(f"needs {WORLD} cards, found {torch.cuda.device_count()}")
    _build.build_all()
    smoke = cs.Smoke(torch, np)
    t0 = time.perf_counter()
    one = cs.mc_cells(torch, np, make_mesh((WORLD,), ("data",)), CELLS,
                      smoke.dev, True)
    emit({"stage": "one_card", "s": time.perf_counter() - t0,
          "cells": {n: {k: c[k] for k in ("rounds", "s", "us_per_round")}
                    for n, c in one.items()}})
    t0 = time.perf_counter()
    ranks = cs.mc_spawn(WORLD, "nccl", CELLS, True)
    bad = []
    for n in CELLS:
        want = json.loads(json.dumps(one[n]["result"]))
        for r, res in ranks.items():
            if res[n]["result"] != want:
                bad.append(f"{n} rank {r}")
            try:
                smoke.mc_checks(f"nccl x {WORLD} rank {r}", res[n], n,
                                "nccl")
            except AssertionError as e:
                bad.append(str(e))
    emit({"stage": "nccl_cells", "s": time.perf_counter() - t0,
          "mismatches": bad,
          "cells": {n: {k: v for k, v in ranks[0][n].items()
                        if k not in ("result", "launches")}
                    for n in CELLS}})
    emit({"stage": "graph_capture", **spawn_capture("graph")})
    emit({"stage": "while_capture", **spawn_capture("while")})


if __name__ == "__main__":
    main()
