#!/usr/bin/env python3
"""Smoke test of the PyTorch / H100 port (``src/repro_torch``) on the card.

Run from the repository root on a machine with one NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Each phase prints one
JSON line; any failure raises and exits non-zero with no result line:

1. build   — compile every kernel of ``src/repro_torch/kernels/csrc``
             with nvcc for sm_90a (nvcc version and build seconds).
2. compare — each kernel (wavefaa, ring_dequeue, ring_enqueue,
             wave_compact) against its plain PyTorch version on the card,
             bit-exact, at the main path's shapes and at the CPU tests'
             edge cases (wrapping counters, width overflow, multi-block
             waves of 1.26 M lanes).
3. road    — the main path: ``bfs_rounds`` on road_like(2048 * 2048)
             (4,194,304 vertices) at batch 1024 on the fused engine;
             dist[v] must be row(v) + col(v) everywhere and wavefaa and
             both ring waves must have launched.
4. kron    — the compaction path: ``bfs_rounds`` on
             kron_like(65536, avg_deg=4, seed=1) at batch 1024; dist must
             equal the sequential BFS oracle and wave_compact must have
             launched.
5. kernels — per kernel: launches in phases 3-4, exactness, its device
             time per call at the main path's shape (profiler) beside its
             plain version's, the torch.cumsum time for the two scans, the
             least time the card could take (bytes over 3.35 TB/s, or
             operations), and the wall time per call of back-to-back
             calls, which includes the host's launch cost.

Then the card's name and power limit as nvidia-smi prints them, and a last
line ``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3, NVIDIA data sheet
ALU_OPS_PER_S = 67e12        # H100 SXM non-tensor-core fp32 rate
BATCH = 1024
ROAD_SIDE = 2048
KRON_N = 65536
IDX_BOT = 2 ** 31 - 1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def die(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


class Smoke:
    def __init__(self, torch, np):
        self.torch, self.np = torch, np
        self.dev = torch.device("cuda")
        self.rng = np.random.default_rng(0)
        self.err = {}             # kernel -> max |kernel - plain| seen
        self.cases = {}           # kernel -> comparisons made

    # -- helpers -------------------------------------------------------------

    def t(self, a, dtype=None):
        out = self.torch.as_tensor(self.np.asarray(a), device=self.dev)
        return out if dtype is None else out.to(dtype)

    def same(self, name, got, want):
        """Exact comparison of two output tuples; records the error."""
        err = 0
        for a, b in zip(got, want):
            a = a if isinstance(a, self.torch.Tensor) else self.t(a)
            b = b if isinstance(b, self.torch.Tensor) else self.t(b)
            if a.shape != b.shape:
                raise AssertionError(f"{name}: shape {tuple(a.shape)} != "
                                     f"{tuple(b.shape)}")
            if a.numel():
                err = max(err, int((a.long() - b.long()).abs().max()))
        self.err[name] = max(self.err.get(name, 0), err)
        self.cases[name] = self.cases.get(name, 0) + 1
        if err:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version by {err}")

    def time_ms(self, setup, launch, iters=50, reps=5):
        """Per-call milliseconds of ``iters`` calls of ``launch(args, i)``,
        each batch after an untimed ``setup()``: the median over ``reps``
        batches of (device, wall) time.  Device time is the sum of the
        CUDA activity the profiler (CUPTI) records, per call; wall time is
        CUDA events around back-to-back calls, so it includes the host's
        launch cost whenever the host is slower than the card."""
        torch = self.torch
        wall, dev = [], []
        for r in range(reps + 1):
            args = setup()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(iters):
                launch(args, i)
            end.record()
            end.synchronize()
            if r:                                    # batch 0 warms up
                wall.append(start.elapsed_time(end) / iters)
        for _ in range(reps):
            args = setup()
            torch.cuda.synchronize()
            with self.profile() as prof:
                for i in range(iters):
                    launch(args, i)
                torch.cuda.synchronize()
            dev.append(device_us(prof) / 1e3 / iters)
        return statistics.median(dev), statistics.median(wall)

    def profile(self):
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA])

    # -- phase 2: kernels against plain versions -----------------------------

    def compare_wavefaa(self, K):
        np, torch = self.np, self.torch
        for n in (1024, 4096, 1230 * 1024):
            for dens in (0.0, 0.18, 1.0):
                a = self.rng.random(n) < dens
                for dtype in (torch.bool, torch.int32):
                    for c0 in (2 << 23, 2 ** 31 - 5, 2 ** 32 - 5):
                        m = self.t(a, dtype)
                        c = self.t(np.array([i32(c0)], np.int32))
                        self.same("wavefaa", K.wavefaa(m, c),
                                  K.wavefaa_plain(m, c))

    def compare_compact(self, K, kron_lanes):
        torch = self.torch
        for n in (256, 1024, 2500, 70000, kron_lanes):
            for dens in (0.0, 0.003, 0.3, 1.0):
                m = self.t(self.rng.random(n) < dens)
                for k in (1, 2):
                    planes = tuple(
                        self.t(self.rng.integers(1, 1 << 20, n), torch.int32)
                        for _ in range(k))
                    for width in (max(n // 8, 8), n, 1 << 17):
                        d1, c1 = K.wave_compact(m, planes, width=width)
                        d2, c2 = K.compact_planes(m, planes, width=width)
                        self.same("wave_compact", (*d1, c1), (*d2, c2))

    def compare_ring(self, K):
        """Random partial waves over several cycles on small rings (dirty
        slots: ⊥-advance and unsafe marking), tickets approaching 2^31,
        and the main path's 2^24-slot ring at its wave widths."""
        np, torch = self.np, self.torch
        for nsl2, start, b_enq, b_deq, rounds in (
                (5, None, 16, 16, 12), (6, None, 32, 32, 12),
                (8, None, 128, 128, 12), (5, 2 ** 31 - 192, 16, 16, 12),
                (24, None, 4096, 1024, 6)):
            ns = 1 << nsl2
            head = tail = ns if start is None else start // ns * ns
            cyc0 = i32(((head % 2 ** 32) >> nsl2) - 1)
            kern = [torch.full((ns,), cyc0, dtype=torch.int32,
                               device=self.dev),
                    torch.ones(ns, dtype=torch.int32, device=self.dev),
                    torch.zeros(ns, dtype=torch.int32, device=self.dev),
                    torch.full((ns,), IDX_BOT, dtype=torch.int32,
                               device=self.dev)]
            plain = [p.clone() for p in kern]
            for _ in range(rounds):
                t = np.array([i32(tail + i) for i in range(b_enq)], np.int32)
                t = np.where(self.rng.random(b_enq) < 0.7, t, -1)
                tt = self.t(t.astype(np.int32))
                vv = self.t(self.rng.integers(0, 1000, b_enq), torch.int32)
                hh = self.t(np.array([i32(head)], np.int32))
                got = K.ring_enqueue(*kern, tt, vv, hh, nslots_log2=nsl2,
                                     idx_bot=IDX_BOT)
                want = K.ring_enqueue_plain(*plain, tt, vv, hh,
                                            nslots_log2=nsl2,
                                            idx_bot=IDX_BOT)
                self.same("ring_enqueue", got, want)
                tail += b_enq
                d = np.array([i32(head + i) for i in range(b_deq)], np.int32)
                d = np.where(self.rng.random(b_deq) < 0.8, d, -1)
                td = self.t(d.astype(np.int32))
                got = K.ring_dequeue(*kern, td, nslots_log2=nsl2,
                                     idx_bot=IDX_BOT)
                want = K.ring_dequeue_plain(*plain, td, nslots_log2=nsl2,
                                            idx_bot=IDX_BOT)
                self.same("ring_dequeue", got, want)
                head += b_deq

    # -- phases 3/4: the paths ------------------------------------------------

    def run_path(self, label, g, K, bfs):
        torch = self.torch
        t0 = time.perf_counter()
        runner, init_fn = bfs.bfs_rounds_runner(g, batch=BATCH)
        acc = init_fn(0)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        dist, st = runner.run([0], acc=acc, max_rounds=1_000_000)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        stats = dict(runner.stats)
        # the same run again under the profiler: the card's busy time
        # (its idle share is read against the unprofiled run's wall time)
        with self.profile() as prof:
            runner.run([0], acc=init_fn(0), max_rounds=1_000_000)
            torch.cuda.synchronize()
        busy_s = device_us(prof) / 1e6
        top = sorted(prof.key_averages(), key=self_device_us, reverse=True)
        fan = max(int(self.np.diff(g.row_ptr).max()), 1)
        return dist.cpu().numpy(), {
            "phase": label, "graph": g.name, "n": g.n, "m": g.m,
            "batch": BATCH, "fanout": fan, "capacity": runner.capacity,
            "rounds": stats["rounds"], "processed": stats["processed"],
            "spawned": stats["spawned"],
            "max_occupancy": stats["max_occupancy"],
            "readbacks": stats["host_syncs"], "setup_s": setup_s,
            "run_s": run_s, "rounds_per_s": stats["rounds"] / run_s,
            "launches": launches,
            "launches_per_round": {k: v / stats["rounds"]
                                   for k, v in launches.items()},
            "device_busy_s": busy_s, "idle_share": 1 - busy_s / run_s,
            "top_device_ms": {e.key[:60]: self_device_us(e) / 1e3
                              for e in top[:6]},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def self_device_us(event) -> float:
    """Self device time of a profiler entry, in microseconds."""
    t = getattr(event, "self_device_time_total", None)
    return float(t if t is not None else event.self_cuda_time_total)


def device_us(prof) -> float:
    """All CUDA activity a profiler recorded, in microseconds; raises when
    it recorded none (the tracer does not reach the card)."""
    us = sum(self_device_us(e) for e in prof.key_averages())
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        die(f"needs numpy and torch: {e}")
    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is False: this smoke test needs a "
            "CUDA card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        die(f"the port's sources are not under {ROOT / 'src'}: run from a "
            f"checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels as K
    from repro_torch.apps import bfs
    from repro_torch.kernels import _build

    # 1. build
    info = _build.build_all()
    regs = {name: [ln.split("info    : ")[-1] for ln in log.splitlines()
                   if "registers" in ln]
            for name, log in info["ptxas"].items()}
    emit({"phase": "build", "nvcc": info["nvcc"], "seconds": info["seconds"],
          "built": info["built"], "ptxas": regs})

    smoke = Smoke(torch, np)
    kron = bfs.kron_like(KRON_N, avg_deg=4, seed=1)
    kron_lanes = BATCH * int(np.diff(kron.row_ptr).max())

    # 2. kernels against their plain versions
    t0 = time.perf_counter()
    smoke.compare_wavefaa(K)
    smoke.compare_ring(K)
    smoke.compare_compact(K, kron_lanes)
    torch.cuda.synchronize()
    emit({"phase": "compare", "exact": True, "cases": smoke.cases,
          "max_abs_err": smoke.err, "seconds": time.perf_counter() - t0})

    # 3. main path: road BFS at full size
    road = bfs.road_like(ROAD_SIDE * ROAD_SIDE)
    dist, road_info = smoke.run_path("road", road, K, bfs)
    v = np.arange(road.n)
    if not np.array_equal(dist, v // ROAD_SIDE + v % ROAD_SIDE):
        raise AssertionError("road: dist != row + col")
    for name in ("wavefaa", "ring_dequeue", "ring_enqueue"):
        if road_info["launches"][name] <= 0:
            raise AssertionError(f"road: {name} was not launched")
    road_info["dist_exact"] = True
    emit(road_info)

    # 4. compaction path: kron BFS
    dist, kron_info = smoke.run_path("kron", kron, K, bfs)
    if not np.array_equal(dist, bfs.bfs_reference(kron, 0)):
        raise AssertionError("kron: dist != bfs_reference")
    for name in ("wave_compact", "ring_dequeue", "ring_enqueue"):
        if kron_info["launches"][name] <= 0:
            raise AssertionError(f"kron: {name} was not launched")
    kron_info["dist_exact"] = True
    emit(kron_info)

    # 5. kernel times at the main path's shapes
    emit({"kernels": kernel_rows(smoke, K, road_info, kron_info)})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def kernel_rows(smoke, K, road, kron):
    """Time each kernel, its plain version and (for the scans) one
    torch.cumsum at the main path's shapes, with the densities the two
    runs produced; compute each one's bound from the same inputs."""
    torch, np, dev = smoke.torch, smoke.np, smoke.dev
    rng = np.random.default_rng(1)
    rows = []

    def bound(nbytes, ops):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = ops / ALU_OPS_PER_S * 1e3
        return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")

    def row(name, source, replaces, kern, plain, lib, nbytes, ops, shape):
        """``kern``/``plain``/``lib`` are (device_ms, wall_ms) pairs."""
        b, by = bound(nbytes, ops)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": road["launches"][name] + kron["launches"][name],
            "launches_by_path": {"road": road["launches"][name],
                                 "kron": kron["launches"][name]},
            "exact": smoke.err[name] == 0, "max_abs_err": smoke.err[name],
            "ms": kern[0], "plain_ms": plain[0], "bound_ms": b,
            "bound_by": by, "library_ms": lib[0] if lib else None,
            "wall_ms": {"kernel": kern[1], "plain": plain[1],
                        "library": lib[1] if lib else None},
            "shape": shape})

    csrc = "src/repro_torch/kernels/csrc/"
    # B1 wavefaa: the road run's child wave (batch x fanout lanes)
    n1 = road["batch"] * road["fanout"]
    dens1 = road["spawned"] / (road["rounds"] * n1)
    m1 = torch.as_tensor(rng.random(n1) < dens1, device=dev)
    c1 = torch.tensor([1 << 24], dtype=torch.int32, device=dev)
    active1 = int(m1.sum())
    row("wavefaa", csrc + "wavefaa.cu", "src/repro/kernels/wavefaa.py:29",
        smoke.time_ms(lambda: None, lambda a, i: K.wavefaa(m1, c1)),
        smoke.time_ms(lambda: None, lambda a, i: K.wavefaa_plain(m1, c1)),
        smoke.time_ms(lambda: None,
                      lambda a, i: torch.cumsum(m1, 0, dtype=torch.int32)),
        n1 * 1 + 4 + n1 * 4 + 4, n1,
        {"lanes": n1, "active": active1, "mask": "bool"})

    # B2 ring waves on the road run's 2^24-slot ring: dequeue waves of
    # `batch` tickets, enqueue waves of batch x fanout lanes of which the
    # run's share is active, at successive ticket ranges so every launch
    # consumes / installs for real
    nsl2 = road["capacity"].bit_length()            # capacity_log2 + 1
    ns, iters = 1 << nsl2, 50
    b_deq, b_enq = road["batch"], n1
    base = ns

    def fresh_ring():
        return [torch.zeros(ns, dtype=torch.int32, device=dev),
                torch.ones(ns, dtype=torch.int32, device=dev),
                torch.zeros(ns, dtype=torch.int32, device=dev),
                torch.full((ns,), IDX_BOT, dtype=torch.int32, device=dev)]

    enq_waves = []
    tail = base
    for i in range(iters):
        act = rng.random(b_enq) < dens1
        t = np.full(b_enq, -1, np.int64)
        t[act] = tail + np.arange(int(act.sum()))
        tail += int(act.sum())
        enq_waves.append((torch.as_tensor(t.astype(np.int32), device=dev),
                          torch.as_tensor(rng.integers(0, 1 << 22, b_enq,
                                                       dtype=np.int32),
                                          device=dev)))
    head = torch.tensor([base], dtype=torch.int32, device=dev)
    n_installed = tail - base

    def enq_setup():
        return fresh_ring()

    def deq_setup():
        planes = fresh_ring()
        t = torch.arange(base, base + iters * b_deq, dtype=torch.int32,
                         device=dev)
        vals = torch.arange(iters * b_deq, dtype=torch.int32, device=dev)
        K.ring_enqueue(*planes, t, vals, head, nslots_log2=nsl2,
                       idx_bot=IDX_BOT)
        return planes

    deq_waves = [torch.arange(base + i * b_deq, base + (i + 1) * b_deq,
                              dtype=torch.int32, device=dev)
                 for i in range(iters)]
    row("ring_dequeue", csrc + "ring_slots.cu",
        "src/repro/kernels/ring_slots.py:184",
        smoke.time_ms(deq_setup, lambda p, i: K.ring_dequeue(
            *p, deq_waves[i], nslots_log2=nsl2, idx_bot=IDX_BOT),
            iters=iters),
        smoke.time_ms(deq_setup, lambda p, i: K.ring_dequeue_plain(
            *p, deq_waves[i], nslots_log2=nsl2, idx_bot=IDX_BOT),
            iters=iters),
        None,
        # ticket in; three plane words read (cycle, enq, idx), one written
        # (idx on a consume); vals + ok out
        b_deq * (4 + 12 + 4 + 4 + 1), b_deq,
        {"lanes": b_deq, "ring_slots": ns})
    row("ring_enqueue", csrc + "ring_slots.cu",
        "src/repro/kernels/ring_slots.py:170",
        smoke.time_ms(enq_setup, lambda p, i: K.ring_enqueue(
            *p, *enq_waves[i], head, nslots_log2=nsl2, idx_bot=IDX_BOT),
            iters=iters),
        smoke.time_ms(enq_setup, lambda p, i: K.ring_enqueue_plain(
            *p, *enq_waves[i], head, nslots_log2=nsl2, idx_bot=IDX_BOT),
            iters=iters),
        None,
        # tickets + ok for every lane; value, three plane words read and
        # four written for each installing lane; head
        b_enq * (4 + 1) + 4 + (n_installed // iters) * (4 + 12 + 16),
        b_enq, {"lanes": b_enq, "active": n_installed // iters,
                "ring_slots": ns})

    # B3 wave_compact: the kron run's child wave, compacted to capacity
    n3 = kron["batch"] * kron["fanout"]
    width = kron["capacity"]
    dens3 = kron["spawned"] / (kron["rounds"] * n3)
    m3 = torch.as_tensor(rng.random(n3) < dens3, device=dev)
    p3 = (torch.as_tensor(rng.integers(0, 1 << 16, n3, dtype=np.int32),
                          device=dev),)
    active3 = int(m3.sum())
    row("wave_compact", csrc + "compact.cu",
        "src/repro/kernels/compact.py:94",
        smoke.time_ms(lambda: None,
                      lambda a, i: K.wave_compact(m3, p3, width=width)),
        smoke.time_ms(lambda: None,
                      lambda a, i: K.compact_planes(m3, p3, width=width)),
        smoke.time_ms(lambda: None,
                      lambda a, i: torch.cumsum(m3, 0, dtype=torch.int32)),
        # mask in, the active lanes' values in, the dense plane and the
        # count out
        n3 * 1 + active3 * 4 + width * 4 + 4, n3,
        {"lanes": n3, "active": active3, "width": width, "mask": "bool"})
    return rows


if __name__ == "__main__":
    sys.exit(main())
