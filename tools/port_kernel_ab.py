#!/usr/bin/env python3
"""Time one checkout of the PyTorch port on the card, so that two
checkouts can be compared in one call.

    python3 tools/port_kernel_ab.py --src PATH/TO/CHECKOUT/src --label A

imports ``repro_torch`` from ``--src`` (its kernels build into that
checkout's ``build/repro_torch``) and prints one JSON line, beside the
card's name and power limit:

* the round engines' drained runs on their device loops, as
  ``chip_smoke.py`` phases 3-5 run them: BFS on road_like(2048 * 2048)
  and kron_like(65536, avg_deg=4, seed=1) at batch 1,024, and the
  priority task tree (65,536 seeds, 2^20-slot heap, batch 1,024).  For
  each, after one run that captures the round: the median over three runs
  of the wall time (rounds/s) and of the device span between CUDA events
  around the run (µs a round), and the nodes of the captured round
  (``chip_smoke.graph_nodes``); road's and kron's dist and the heap run's
  acc are checked against their oracles;
* the per-call device time in microseconds of ``wavefaa`` at the road
  path's child wave (4,096 lanes at density 0.2) and of
  ``expert_tickets`` at a decode step (32 pairs) and at a prefill (65,536
  pairs), 40 experts, each the median of 5 batches of 50 calls timed with
  CUDA events behind a ``torch.cuda._sleep`` (``Smoke.time_ms``);
* road and the task tree with ``Telemetry`` and ``Spans`` on, sized as
  ``chip_smoke.py`` phase 5b sizes them, each in turns with its obs-off
  twin (off, on, on, off, three times over: the median of six runs a
  side, every run kept), with one record a round and a histogram total
  equal to the pops checked, and the per-call time of ``obs_record`` at
  road's wave (1,024 lanes, 819 of them valid, a trace plane of 8,192
  rows, spans of 16 buckets), timed as above;
* the per-call time of the single heap's ``heap_apply`` on the priority
  path's 2^20-slot heap holding 200,000 nodes: a 1,024-pop call and a
  2,048-lane insert call at the tree's child density (0.62), each on a
  state that flows from call to call, timed as above;
* the per-call time of the flash backward ``flash_attention_bwd`` at the
  training paths' shapes (``BWD_SHAPES``: h2o-danube-1.8b's layers,
  zamba2-7b's shared block, hubert-xlarge's encoder, and gemma3-4b's
  global and local layers where the checkout's backward takes hd 256),
  on seeded bfloat16 q, k, v in the model's strided (B, S, H, hd) layout
  with B7's out and lse and a seeded dout, timed as above, beside
  ``scaled_dot_product_attention``'s backward on the same inputs (a
  window as a boolean band), which the port never calls.

``--cells`` picks a comma-separated subset of ``engines``, ``obs``,
``heap``, ``small`` (wavefaa, expert_tickets) and ``flash_bwd``; all by
default.  Run two checkouts in turns in one call (A, B, B, A): a number
from another call does not compare.  Needs a CUDA card; exits 2 without
one.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUNS = 3
CELLS = ("engines", "obs", "heap", "small", "flash_bwd")
# (label, B, H, KV, S, hd, causal, window)
BWD_SHAPES = (("danube_hd80", 2, 32, 8, 4096, 80, True, 0),
              ("zamba2_hd112", 2, 32, 32, 4096, 112, True, 0),
              ("hubert_hd80_unmasked", 2, 16, 16, 4096, 80, False, 0),
              ("gemma3_hd256_global", 2, 8, 4, 4096, 256, True, 0),
              ("gemma3_hd256_local", 2, 8, 4, 4096, 256, True, 1024))


def drained(torch, run, rounds_of):
    """``run()`` once to capture, then RUNS times between CUDA events:
    (last result, median rounds/s, median device µs a round)."""
    out = run()
    rates, us = [], []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = run()
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
        rounds = rounds_of(out)
        rates.append(rounds / wall)
        us.append(start.elapsed_time(end) * 1e3 / rounds)
    return out, statistics.median(rates), statistics.median(us)


def engine_cells(np, torch, cs, dev):
    """The road, kron and heap cells of one checkout."""
    from repro_torch import runtime as rt
    from repro_torch.apps import bfs
    out = {}
    road = bfs.road_like(cs.ROAD_SIDE * cs.ROAD_SIDE)
    v = np.arange(road.n)
    kron = bfs.kron_like(cs.KRON_N, avg_deg=4, seed=1)
    for name, g, want in (
            ("road", road, (v // cs.ROAD_SIDE + v % cs.ROAD_SIDE)),
            ("kron", kron, bfs.bfs_reference(kron, 0))):
        runner, init_fn = bfs.bfs_rounds_runner(g, batch=cs.BATCH)
        (dist, _), rate, us = drained(
            torch, lambda: runner.run([0], acc=init_fn(0),
                                      max_rounds=1_000_000),
            lambda _: runner.stats["rounds"])
        if not np.array_equal(dist.cpu().numpy(), want):
            raise AssertionError(f"{name}: dist differs from its oracle")
        out[name] = {"rounds": runner.stats["rounds"],
                     "readbacks": runner.stats["host_syncs"],
                     "rounds_per_s": rate, "device_us_per_round": us,
                     "round_graph": cs.graph_nodes(runner._engine)}
    rng = np.random.default_rng(12)
    ik = rng.integers(0, 16, cs.HEAP_SEEDS).astype(np.int32)
    iv = rng.integers(0, 2 ** 31 - 1, cs.HEAP_SEEDS).astype(np.int32)
    runner = rt.PriorityRoundRunner(cs.heap_tree_step(torch),
                                    capacity_log2=cs.HEAP_CAP_LOG2,
                                    batch=cs.BATCH)
    (acc, _), rate, us = drained(
        torch, lambda: runner.run(ik, iv, acc=torch.zeros(
            4096, dtype=torch.int32, device=dev), max_rounds=1_000_000),
        lambda _: runner.stats["rounds"])
    if not np.array_equal(acc.cpu().numpy(), cs.heap_closure(np, ik, iv)[0]):
        raise AssertionError("heap: acc differs from the closure oracle")
    out["heap"] = {"rounds": runner.stats["rounds"],
                   "readbacks": runner.stats["host_syncs"],
                   "rounds_per_s": rate, "device_us_per_round": us,
                   "round_graph": cs.graph_nodes(runner._engine)}
    return out


def obs_cells(np, torch, cs, dev, smoke):
    """Road and the task tree with obs off and on in turns, and the
    per-call time of ``obs_record`` at road's wave."""
    from repro_torch import obs
    from repro_torch import runtime as rt
    from repro_torch.apps import bfs
    out = {}
    road = bfs.road_like(cs.ROAD_SIDE * cs.ROAD_SIDE)
    rng = np.random.default_rng(12)
    ik = rng.integers(0, 16, cs.HEAP_SEEDS).astype(np.int32)
    iv = rng.integers(0, 2 ** 31 - 1, cs.HEAP_SEEDS).astype(np.int32)

    def road_runner(**kw):
        runner, init_fn = bfs.bfs_rounds_runner(road, batch=cs.BATCH, **kw)
        return runner, lambda: runner.run([0], acc=init_fn(0),
                                          max_rounds=1_000_000)

    def heap_runner(**kw):
        runner = rt.PriorityRoundRunner(
            cs.heap_tree_step(torch), capacity_log2=cs.HEAP_CAP_LOG2,
            batch=cs.BATCH, **kw)
        return runner, lambda: runner.run(ik, iv, acc=torch.zeros(
            4096, dtype=torch.int32, device=dev), max_rounds=1_000_000)

    for name, make, cap in (("road", road_runner, cs.OBS_ROAD_CAPACITY),
                            ("heap", heap_runner, cs.OBS_HEAP_CAPACITY)):
        tel, sp = obs.Telemetry(cap, engine=name), obs.Spans(engine=name)
        runners = {"off": make(), "on": make(telemetry=tel, spans=sp)}
        for _, run in runners.values():
            run()                                    # capture
        runs = {"off": [], "on": []}
        for flag in ("off", "on", "on", "off") * 3:
            runner, run = runners[flag]
            if flag == "on":
                tel.reset()
                sp.reset()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            run()
            end.record()
            end.synchronize()
            runs[flag].append(start.elapsed_time(end) * 1e3
                              / runner.stats["rounds"])
        st = runners["on"][0].stats
        if not (len(tel.records) == st["rounds"]
                and sum(r.pops[0] for r in tel.records) == st["processed"]
                and sp.total == st["processed"]):
            raise AssertionError(f"obs {name}: records or histogram wrong")
        off_us = statistics.median(runs["off"])
        on_us = statistics.median(runs["on"])
        out[f"obs_{name}"] = {
            "rounds": st["rounds"], "device_us_per_round_off": off_us,
            "device_us_per_round_on": on_us, "on_minus_off_us": on_us - off_us,
            "runs_us": runs,
            "round_graph_on": cs.graph_nodes(runners["on"][0]._engine)}
    card = dict(dtype=torch.int32, device=dev)
    k_obs = 819
    wave = dict(
        keys=torch.as_tensor(rng.integers(0, 1 << 22, cs.BATCH,
                                          dtype=np.int32), device=dev),
        valid=torch.arange(cs.BATCH, device=dev) < k_obs,
        births=torch.as_tensor(rng.integers(1000, 5000, cs.BATCH,
                                            dtype=np.int32), device=dev),
        k=torch.tensor(k_obs, **card), total=torch.tensor(k_obs, **card),
        occ=torch.tensor(1 << 20, **card),
        over=torch.zeros((), dtype=torch.bool, device=dev))
    wave["ref"] = wave["keys"]

    def setup():
        sp = obs.span_init(1, lanes=cs.BATCH, device=dev)
        sp.round.fill_(5000)
        return obs.trace_init(cs.OBS_ROAD_CAPACITY, device=dev), sp

    out["obs_record_us"] = smoke.time_ms(
        setup, lambda p, i: obs.obs_record(*p, **wave))[0] * 1e3
    return out


def heap_calls(np, torch, K, smoke, dev):
    """Per-call µs of ``heap_apply``: 1,024 pops and 2,048 insert lanes on
    a 2^20-slot heap of 200,000 nodes."""
    card = dict(dtype=torch.int32, device=dev)
    rng = np.random.default_rng(4)
    cap_log2, occ = 20, 200_000
    keys = torch.full((1 << cap_log2,), 2 ** 31 - 1, **card)
    vals = torch.full((1 << cap_log2,), -1, **card)
    seed = torch.as_tensor(rng.integers(0, 26, occ, dtype=np.int32),
                           device=dev)
    K.heap_apply(keys, vals, 0, torch.zeros(occ, **card), seed, seed,
                 cap_log2=cap_log2)
    act = rng.random(2048) < 0.62
    waves = {
        "pop": (torch.ones(1024, **card),
                torch.full((1024,), 2 ** 31 - 1, **card),
                torch.full((1024,), -1, **card)),
        "insert": (torch.as_tensor(np.where(act, 0, -1).astype(np.int32),
                                   device=dev),
                   torch.as_tensor(rng.integers(0, 30, 2048,
                                                dtype=np.int32), device=dev),
                   torch.as_tensor(rng.integers(0, 1 << 30, 2048,
                                                dtype=np.int32), device=dev))}
    out = {}
    for name, wave in waves.items():
        def launch(st, i, wave=wave):
            st[2] = K.heap_apply(st[0], st[1], st[2], *wave,
                                 cap_log2=cap_log2)[2]
        out[f"heap_apply_{name}_us"] = smoke.time_ms(
            lambda: [keys.clone(), vals.clone(), torch.tensor(occ, **card)],
            launch, iters=40)[0] * 1e3
    return out


def flash_bwd_calls(torch, K, smoke, dev):
    """Per-call µs of the flash backward and of SDPA's backward at
    ``BWD_SHAPES``; shapes whose width the checkout's backward does not
    take are reported as such."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    out = {}
    for label, b, h, kv, s, hd, causal, window in BWD_SHAPES:
        if hd not in K.flash_attn.BWD_HEAD_DIMS:
            out[label] = "not built for this width"
            continue
        g = torch.Generator(device=dev)
        g.manual_seed(hd + h)
        q, k, v = ((torch.randn(shape, generator=g, device=dev) * 0.5)
                   .to(torch.bfloat16).transpose(1, 2)
                   for shape in ((b, s, h, hd), (b, s, kv, hd),
                                 (b, s, kv, hd)))
        kw = dict(causal=causal, window=window, softcap_val=0.0)
        o, lse = K.flash_attention(q, k, v, return_lse=True, **kw)
        dout = torch.randn(o.shape, generator=g, device=dev).to(o.dtype)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        if window:
            pos = torch.arange(s, device=dev)
            band = ((pos[None, :] > pos[:, None] - window)
                    & (pos[None, :] <= pos[:, None]))
            ref = sdpa(*leaves, attn_mask=band, enable_gqa=True)
        else:
            ref = sdpa(*leaves, is_causal=causal, enable_gqa=True)
        out[label] = {
            "us": smoke.time_ms(lambda: None, lambda a, i:
                                K.flash_attention_bwd(q, k, v, o, dout, lse,
                                                      **kw),
                                iters=10)[0] * 1e3,
            "sdpa_us": smoke.time_ms(lambda: None, lambda a, i:
                                     torch.autograd.grad(
                                         ref, leaves, dout,
                                         retain_graph=True),
                                     iters=10)[0] * 1e3}
        del q, k, v, o, lse, dout, leaves, ref
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="a checkout's src directory")
    ap.add_argument("--label", default="")
    ap.add_argument("--cells", default=",".join(CELLS),
                    help="comma-separated subset of " + ", ".join(CELLS))
    args = ap.parse_args()
    cells = args.cells.split(",")
    if not set(cells) <= set(CELLS):
        ap.error(f"--cells takes {', '.join(CELLS)}")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("port_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch import kernels as K
    smoke = cs.Smoke(torch, np)
    dev = smoke.dev
    out = {"label": args.label, "src": args.src,
           "repro_torch": K.__file__}
    if "engines" in cells:
        out.update(engine_cells(np, torch, cs, dev))
    if "obs" in cells:
        out.update(obs_cells(np, torch, cs, dev, smoke))
    if "heap" in cells:
        out.update(heap_calls(np, torch, K, smoke, dev))
    if "small" in cells:
        rng = np.random.default_rng(5)
        mask = torch.as_tensor(rng.random(4096) < 0.2, device=dev)
        counter = torch.tensor([1 << 24], dtype=torch.int32, device=dev)
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
                lambda: None,
                lambda a, i: K.expert_tickets(ids, **kw))[0] * 1e3
    if "flash_bwd" in cells:
        out["flash_bwd"] = flash_bwd_calls(torch, K, smoke, dev)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
