#!/usr/bin/env python3
"""Smoke test of the PyTorch / H100 port (``src/repro_torch``) on the card.

Run from the repository root on a machine with one NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Each phase prints one
JSON line; any failure raises and exits non-zero with no result line:

1. build    — compile every kernel of ``src/repro_torch/kernels/csrc``
              with nvcc for sm_90a, one nvcc per source, all at once
              (nvcc version and build seconds).
2. compare  — each kernel (wavefaa, ring_dequeue, ring_enqueue,
              wave_compact, heap_apply, frontier_expand, expert_tickets,
              flash_attention) against its plain PyTorch version on the
              card, at the paths' shapes and at the CPU tests' edge cases
              (wrapping counters, width overflow, multi-block waves of
              1.26 M lanes; heap batches into a full and out of an empty
              heap at 2^4, 2^6 and 2^20 slots with NOP lanes, duplicate
              and KEY_INF keys, and the heap path's 1,024-pop / 2,048-
              insert batches; frontier levels with -1 slots, duplicate
              neighbours, max_out overflow, and the largest real level of
              each graph of phase 6; expert tickets for N of 32 to 65,536,
              8, 40 and 64 experts, -1 lanes, capacities 0, 1, below and
              above the largest expert count, all pairs on one expert;
              flash attention on the four configurations of the JAX
              package's kernel tests in float32, the prefill shape in
              bfloat16, a gemma2-style window of 4,096 with softcap 50 at
              S = 8,192, Sq < Sk, hd 80 (h2o-danube-1.8b), and the
              model's strided layout).  The integer kernels must be
              bit-exact; flash attention is held against its plain
              version at the kernel's tiles, element by element (one ulp
              of the output plus 2^-5 of its rms in bfloat16) and in the
              Frobenius norm (2^-10 in bfloat16; 1e-5 throughout in
              float32), as ``FLASH_TOL`` states.
3. road     — ``bfs_rounds`` on road_like(2048 * 2048) (4,194,304
              vertices) at batch 1024 on the fused engine; dist[v] must be
              row(v) + col(v) everywhere and wavefaa and both ring waves
              must have launched.
4. kron     — the compaction path: ``bfs_rounds`` on
              kron_like(65536, avg_deg=4, seed=1) at batch 1024; dist must
              equal the sequential BFS oracle and wave_compact must have
              launched.
5. heap     — the priority path.  First the ``heap_sssp`` golden run of
              the JAX package's tests on the card (fused and legacy:
              stats [10, 124, 122, 46, 1] and the acc and plane digests).
              Then ``PriorityRoundRunner`` at capacity_log2=20 (two 4 MB
              planes, 4-ary) and batch 1024, fused and legacy, on a
              priority task tree: 65,536 seeds, keys uniform in [0, 16)
              and vals uniform in [0, 2^31 - 1) from
              numpy.random.default_rng(12); each pop (key, val) offers two
              children c = 0, 1 with h = tree_hash(val, c), child key
              key + 1 + ((h >> 8) & 3), child val (h >> 1) & 0x7FFFFFFF,
              spawned iff key < 26 and (h & 15) < 10 (1.25 children per
              pop below the horizon).  That pops about 1.86 M items in
              about 1,800 rounds with the heap peaking near 420 K (between
              2^18 and 2^20, no overflow).  acc (pops per val % 4096),
              processed and spawned must equal a numpy closure of the
              seeds under the child rule; fused must equal legacy bit for
              bit; heap_apply must launch at least twice per round.
6. bfs_queue — ``bfs_queue`` (the frontier kernel) and ``bfs_baseline``
              (a plain dense sweep) on the road graph of phase 3 and on
              kron_like(2^20, avg_deg=16, seed=1); road dist must be
              row + col, kron dist must equal a vectorised numpy level
              sweep, the two must agree, and frontier_expand must launch
              once per level.
7. kernels  — per kernel: launches on each path (phases 3-6 and 8),
              exactness or max error, its device time per call at its
              path's shape (CUDA events around calls queued behind a
              sleep, so no host gap counts) beside its plain version's, one
              PyTorch library call's time where one computes the same
              function, the least time the card could take (bytes over
              3.35 TB/s, or operations over the card's rate for their
              type), and the wall time per call of back-to-back calls,
              which includes the host's launch cost.
8. serve    — the model path at full width: granite-moe-3b-a800m (32
              layers, d_model 1536, 40 experts top-8, 3,374,295,552
              parameters in bfloat16) from ``init_params`` with a
              torch.Generator seeded 0 on the card.  Two 4,096-token
              prompts (numpy.random.default_rng(13)) through ``prefill``:
              flash_attention must launch once per layer and
              expert_tickets once per MoE layer, the last-token logits
              must be finite, and both kernels are held against their
              plain versions on the q/k/v and expert ids of the first and
              the last layer of that very prefill.  Then ``ServingEngine``
              (4 slots, 32 pages of 32 tokens, max_seq 64) answers 8
              requests of 16 prompt tokens and 16 new tokens: 8 completed,
              128 tokens out, expert_tickets launched once per MoE layer
              per decode step, and admitted, decode steps, page stalls
              and the admission order equal to the port's own CPU run of
              the same trace at the reduced width (the schedule does not
              depend on the width).  Prefill tokens/s, decode tokens/s and
              readbacks; both re-run under the profiler.

Phases 3, 5, 6 and 8 also re-run their path under the profiler and
report the card's idle share against the unprofiled wall time.  Phase 8
runs before phase 7, whose line needs its launch counts.  Every phase
line carries ``elapsed_s``, the seconds since the script started, and
every kernel row ``timing_s``, the seconds its timing took.  Then the
card's name and power limit as nvidia-smi prints them, and a last line
``{"ok": true, "device": {...}}``.
"""

import hashlib
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3, NVIDIA data sheet
ALU_OPS_PER_S = 67e12        # H100 SXM non-tensor-core fp32 rate
BF16_TC_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate, data sheet
GPU_CYCLES_PER_S = 1.98e9    # H100 SXM boost clock: sizes the timing backlog
BATCH = 1024
ROAD_SIDE = 2048
KRON_N = 65536
IDX_BOT = 2 ** 31 - 1
KEY_INF = 2 ** 31 - 1
HEAP_CAP_LOG2 = 20       # the priority path's heap: 2^20 slots
HEAP_SEEDS = 65536
HEAP_HORIZON = 26        # children only below this key
HEAP_SPAWN = 10          # a child is offered with probability 10/16
QKRON_N = 1 << 20        # bfs_queue's kron graph
QKRON_DEG = 16
# the heap_sssp golden of the JAX package's tests (tests/test_enginecore.py)
HEAP_GOLDEN = {"stats": [10, 124, 122, 46, 1], "acc": "17210d10068cbe8b",
               "planes": "3e13f886f2e96c70"}
SERVE_ARCH = "granite-moe-3b-a800m"
PREFILL_BATCH, PREFILL_LEN = 2, 4096
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 8, 16, 16
SERVE_VOCAB = 512        # prompt ids valid at full and at reduced width
# flash attention against its plain version at the kernel's tiles, element
# by element and as a whole: |kernel - plain| <= rtol * |plain| + atol *
# rms(plain) and ||kernel - plain|| <= frob * ||plain||.  bf16: one ulp of
# the output (2^-7), 2^-5 of the rms for p's rounding, 2^-10 overall;
# float32: 1e-5 each.
FLASH_TOL = {"bfloat16": {"rtol": 2.0 ** -7, "atol_rms": 2.0 ** -5,
                          "frob": 2.0 ** -10},
             "float32": {"rtol": 1e-5, "atol_rms": 1e-5, "frob": 1e-5}}


START = time.perf_counter()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def emit_phase(obj) -> None:
    """A phase line, with the seconds since the script started."""
    emit(dict(obj, elapsed_s=time.perf_counter() - START))


def die(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def tree_hash(v, c):
    """32-bit mix of (val, child index) on int64 numpy arrays or torch
    tensors alike (every product stays below 2^63)."""
    h = (v * 0x7FEB352D + c * 0x2545F491 + 0x1B873593) & 0xFFFFFFFF
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & 0xFFFFFFFF
    return h ^ (h >> 12)


def tree_children(keys, vals, xp_arange, valid=None):
    """The priority task tree's child rule on (B,) keys and vals (numpy
    or torch int64): child keys, vals and mask, each (B, 2)."""
    h = tree_hash(vals[:, None], xp_arange(2)[None, :])
    ck = keys[:, None] + 1 + ((h >> 8) & 3)
    cv = (h >> 1) & 0x7FFFFFFF
    cm = (keys[:, None] < HEAP_HORIZON) & ((h & 15) < HEAP_SPAWN)
    if valid is not None:
        cm = cm & valid[:, None]
    return ck, cv, cm


def heap_closure(np, keys, vals):
    """Every item the tree holds, generation by generation: (pops per
    val % 4096, processed, spawned).  Children depend only on their
    parent, so these do not depend on the order of the pops."""
    acc = np.zeros(4096, np.int64)
    k, v = keys.astype(np.int64), vals.astype(np.int64)
    processed = 0
    while len(k):
        processed += len(k)
        acc += np.bincount(v % 4096, minlength=4096)
        ck, cv, cm = tree_children(k, v, np.arange)
        k, v = ck[cm], cv[cm]
    return acc, processed, processed - len(keys)


def bfs_levels(np, g, source):
    """Vectorised numpy level sweep: BFS distances by definition, one
    level at a time, independent of the port's code."""
    rp = g.row_ptr.astype(np.int64)
    dist = np.full(g.n, -1, np.int32)
    dist[source] = 0
    front, level = np.array([source]), 0
    while len(front):
        level += 1
        start, deg = rp[front], rp[front + 1] - rp[front]
        idx = (np.repeat(start - np.cumsum(deg) + deg, deg)
               + np.arange(deg.sum()))
        nb = g.col_idx[idx]
        front = np.unique(nb[dist[nb] < 0])
        dist[front] = level
    return dist


STATS = ("rounds", "processed", "spawned", "max_occupancy", "drained")


class Smoke:
    def __init__(self, torch, np):
        self.torch, self.np = torch, np
        self.dev = torch.device("cuda")
        self.rng = np.random.default_rng(0)
        self.err = {}             # kernel -> max |kernel - plain| seen
        self.bound_used = {}      # float kernel -> largest share of a bound
        self.rejected = {}        # wrong flash results -> shares of bounds
        self.cases = {}           # kernel -> comparisons made
        self.launches = {"road": {}, "kron": {}, "heap": {},
                         "queue": {}, "prefill": {},
                         "serve": {}}   # path -> kernel launches

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

    def bound_shares(self, got, want):
        """(max |got - want|, the largest share of the element bound, the
        share of the Frobenius bound) under ``FLASH_TOL`` of the dtype."""
        tol = FLASH_TOL[str(want.dtype).split(".")[-1]]
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{got.shape} {got.dtype} != "
                                 f"{want.shape} {want.dtype}")
        g, w = got.float(), want.float()
        if not bool(self.torch.isfinite(g).all()):
            raise AssertionError("the kernel gave non-finite values")
        diff = (g - w).abs()
        rms = float(w.pow(2).mean().sqrt())
        bound = tol["rtol"] * w.abs() + tol["atol_rms"] * rms
        elem = float((diff / bound.clamp(min=1e-30)).max())
        frob = (float((g - w).norm()) / max(float(w.norm()), 1e-30)
                / tol["frob"])
        return float(diff.max()), elem, frob

    def close(self, name, got, want):
        """Float comparison within ``FLASH_TOL`` of the dtype, element by
        element and in the Frobenius norm; records the largest error and
        each bound's largest share used."""
        err, elem, frob = self.bound_shares(got, want)
        self.err[name] = max(self.err.get(name, 0.0), err)
        used = self.bound_used.setdefault(name, {"element": 0.0,
                                                 "frobenius": 0.0})
        used["element"] = max(used["element"], elem)
        used["frobenius"] = max(used["frobenius"], frob)
        self.cases[name] = self.cases.get(name, 0) + 1
        if elem > 1 or frob > 1:
            raise AssertionError(
                f"{name}: kernel differs from its plain version by "
                f"{elem:.3g} of the element bound and {frob:.3g} of the "
                f"Frobenius bound (max |diff| {err})")

    def time_ms(self, setup, launch, iters=50, reps=5):
        """Per-call milliseconds of ``iters`` calls of ``launch(args, i)``,
        each batch after an untimed ``setup()``: the median over ``reps``
        batches of (device, wall) time, both from CUDA events around the
        batch.  Wall: the calls issued back to back, so it includes the
        host's launch cost whenever the host is slower than the card.
        Device: the same batch queued behind a ``torch.cuda._sleep`` that
        outlasts three times the host's time to issue it, so the card runs
        the calls back to back and the events see no host gap (a call
        that reads a value back drains that queue: its device time then
        includes the readback).  The profiler is not used here: after
        many sessions in one process it was seen to drop kernel records
        (B7 summed to 1.09 ms a call where events and the profile of the
        prefill saw 1.70 ms) or to record none."""
        torch = self.torch

        def batch(args, backlog_cycles):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            if backlog_cycles:
                torch.cuda._sleep(backlog_cycles)
            t0 = time.perf_counter()
            start.record()
            for i in range(iters):
                launch(args, i)
            end.record()
            host_s = time.perf_counter() - t0
            end.synchronize()
            return start.elapsed_time(end) / iters, host_s

        wall, dev, host = [], [], 0.0
        for r in range(reps + 1):                    # batch 0 warms up
            ms, host_s = batch(setup(), 0)
            host = max(host, host_s)
            if r:
                wall.append(ms)
        cycles = int(3 * host * GPU_CYCLES_PER_S) + 1_000_000
        for _ in range(reps):
            dev.append(batch(setup(), cycles)[0])
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

    def heap_batch(self, b, share, lo=-20, hi=40):
        """A random op batch: INSERT with probability ``share``, else mostly
        DELETE-MIN and some NOP lanes; duplicate and negative keys, 5 %
        KEY_INF keys and a few -2^31 keys."""
        np = self.np
        r = self.rng.random(b)
        ops = np.where(r < share, 0,
                       np.where(r < share + (1 - share) * 0.85, 1, -1))
        keys = self.rng.integers(lo, hi, b)
        sp = self.rng.random(b)
        keys = np.where(sp < 0.05, KEY_INF, np.where(sp > 0.99, -2 ** 31,
                                                     keys))
        vals = self.rng.integers(0, 1 << 30, b)
        return [self.t(x.astype(np.int32)) for x in (ops, keys, vals)]

    def compare_heap(self, K):
        """Heap batches on both faces from the same state: at 2^4 and 2^6
        slots, batches that fill the heap past full and drain it past
        empty; at 2^20 slots, a 131,072-insert seed and the priority
        path's batches (1,024 pops, then 2,048 insert lanes)."""
        np, torch = self.np, self.torch
        card = dict(dtype=torch.int32, device=self.dev)
        for arity in (1, 2):
            for c in (4, 6, HEAP_CAP_LOG2):
                cap = 1 << c
                kern = [torch.full((cap,), KEY_INF, **card),
                        torch.full((cap,), -1, **card)]
                plain = [p.clone() for p in kern]
                sk = sp = torch.zeros((), **card)
                if c < HEAP_CAP_LOG2:
                    nb = 2 * cap // 16 + 2
                    batches = [self.heap_batch(16, share) for share in
                               [0.9] * nb + [0.1] * nb + [0.5] * 4]
                else:
                    batches = [self.heap_batch(1 << 17, 1.0, 0, 16)]
                    for _ in range(3):
                        pops = [self.t(np.full(BATCH, x, np.int32))
                                for x in (1, KEY_INF, -1)]
                        batches += [pops, self.heap_batch(2 * BATCH, 0.6,
                                                          0, 30)]
                for ops, keys, vals in batches:
                    got = K.heap_apply(*kern, sk, ops, keys, vals,
                                       cap_log2=c, arity_log2=arity)
                    want = K.heap_apply_plain(*plain, sp, ops, keys, vals,
                                              cap_log2=c,
                                              arity_log2=arity)
                    self.same("heap_apply", got, want)
                    sk, sp = got[2], want[2]

    def frontier_case(self, K, rp, col, frontier, visited, max_out):
        kw = dict(max_out=max_out)
        got = K.frontier_expand(rp, col, frontier, visited.clone(), **kw)
        want = K.frontier_expand_plain(rp, col, frontier, visited.clone(),
                                       **kw)
        self.same("frontier_expand", got, want)

    def compare_frontier(self, K, graphs):
        """Synthetic levels (-1 slots inside the frontier, repeated
        frontier vertices, duplicate neighbours, max_out overflow, the CPU
        tests' overflow case) and the level with the most edges of each
        graph in ``graphs`` (name -> (graph, dist))."""
        np = self.np
        t = self.t
        self.frontier_case(K, t(np.array([0, 3, 6, 6, 8, 8, 8, 8, 8],
                                         np.int32)),
                           t(np.array([4, 5, 6, 5, 7, 1, 2, 3], np.int32)),
                           t(np.array([0, -1, 1, 3, -1, -1, -1, -1],
                                      np.int32)),
                           t(np.array([1, 1, 0, 1, 0, 0, 0, 0], np.int32)),
                           3)
        for n, deg, fl in ((64, 5, 12), (5000, 7, 3000), (70000, 3, 40000)):
            col = self.rng.integers(0, n, n * deg).astype(np.int32)
            rp = np.arange(0, n * deg + 1, deg, dtype=np.int32)
            for max_out in (n, 257, 1):
                f = self.rng.integers(0, n, fl).astype(np.int32)
                f[self.rng.random(fl) < 0.25] = -1
                vis = (self.rng.random(n) < 0.3).astype(np.int32)
                self.frontier_case(K, t(rp), t(col), t(f), t(vis), max_out)
        for g, dist in graphs.values():
            level = busiest_level(np, g, dist)
            f, vis = level_input(np, dist, level)
            self.frontier_case(K, t(g.row_ptr), t(g.col_idx), t(f), t(vis),
                               max(g.n, 16))

    def tickets_case(self, K, ids, e, cap):
        kw = dict(num_experts=e, capacity=cap)
        self.same("expert_tickets", (K.expert_tickets(ids, **kw),),
                  (K.expert_tickets_plain(ids, **kw),))

    def compare_moe(self, K):
        """Expert tickets bit-exact: N of 32 (a decode step), 127, 128,
        1,000 and 65,536 (a prefill), 8, 40 and 64 experts, a share of -1
        lanes, capacities 0, 1, half and past the largest expert count,
        and all pairs on one expert."""
        np, torch = self.np, self.torch
        for n in (32, 127, 128, 1000, 65536):
            for e in (8, 40, 64):
                for inactive in (0.0, 0.2):
                    ids = self.rng.integers(0, e, n)
                    ids[self.rng.random(n) < inactive] = -1
                    top = int(np.bincount(ids[ids >= 0], minlength=e).max()) \
                        if (ids >= 0).any() else 0
                    t = self.t(ids.astype(np.int32))
                    for cap in (0, 1, max(top // 2, 1), top + 5):
                        self.tickets_case(K, t, e, cap)
            one = torch.full((n,), 7, dtype=torch.int32, device=self.dev)
            for cap in (0, 1, n // 2, n):
                self.tickets_case(K, one, 40, cap)

    def flash_case(self, K, q, k, v, **kw):
        """The kernel against the plain version at the kernel's tiles (in
        place of any blocks the caller's ``kw`` names); returns the plain
        version's output."""
        bq, bk = K.flash_attn.KERNEL_TILES[q.dtype]
        want = K.flash_attention_plain(q, k, v, **{**kw, "bq": bq, "bk": bk})
        self.close("flash_attention", K.flash_attention(q, k, v, **kw), want)
        return want

    def compare_flash(self, K):
        """Flash attention within ``FLASH_TOL``: the four configurations
        of the JAX package's kernel tests (tests/test_kernels.py) in
        float32 and bfloat16, the prefill shape in bfloat16 (also in the
        model's strided layout), a gemma2-style window of 4,096 with
        softcap 50 at S = 8,192, Sq < Sk, and hd 80 (h2o-danube-1.8b).
        Then two wrong results, which the check must reject."""
        torch = self.torch

        def qkv(b, h, kv, sq, sk, hd, dtype, seed):
            g = torch.Generator(device=self.dev)
            g.manual_seed(seed)
            return [(torch.randn(shape, generator=g, device=self.dev) * 0.5)
                    .to(dtype) for shape in ((b, h, sq, hd), (b, kv, sk, hd),
                                             (b, kv, sk, hd))]

        for i, (b, h, kv, sq, sk, hd, causal, win, cap) in enumerate((
                (1, 4, 2, 512, 512, 64, True, 0, 0.0),
                (2, 8, 4, 1024, 1024, 64, True, 128, 0.0),
                (1, 4, 4, 512, 1024, 32, True, 0, 50.0),
                (1, 2, 2, 512, 512, 64, False, 0, 0.0))):
            for dtype in (torch.float32, torch.bfloat16):
                self.flash_case(K, *qkv(b, h, kv, sq, sk, hd, dtype, i),
                                causal=causal, window=win, softcap_val=cap)
        cfg = (PREFILL_BATCH, 24, 8, PREFILL_LEN, PREFILL_LEN, 64)
        q, k, v = qkv(*cfg, torch.bfloat16, 10)
        want_prefill = self.flash_case(K, q, k, v)
        # the model's (B, S, H, hd) activations as (B, H, S, hd) views
        self.flash_case(K, *(x.transpose(1, 2).contiguous().transpose(1, 2)
                             for x in (q, k, v)))
        gemma = qkv(1, 8, 4, 8192, 8192, 128, torch.bfloat16, 11)
        want_gemma = self.flash_case(K, *gemma, window=4096,
                                     softcap_val=50.0)
        self.flash_case(K, *qkv(1, 4, 2, 1024, 2048, 64, torch.bfloat16,
                                12))
        self.flash_case(K, *qkv(1, 4, 2, 1024, 2048, 32, torch.float32,
                                13), window=300)
        # hd 80: h2o-danube-1.8b's heads at a prompt of 2,048
        self.flash_case(K, *qkv(1, 32, 8, 2048, 2048, 80, torch.bfloat16,
                                14))

        # the check must reject a wrong kernel: the window's edge one key
        # short, and one key tile left out of P V (its v zeroed)
        v0 = v.clone()
        v0[:, :, 1024:1024 + K.flash_attn.KERNEL_TILES[v.dtype][1]] = 0
        for name, got, want in (
                ("window_edge", K.flash_attention(*gemma, window=4095,
                                                  softcap_val=50.0),
                 want_gemma),
                ("key_tile", K.flash_attention(q, k, v0), want_prefill)):
            _, elem, frob = self.bound_shares(got, want)
            self.rejected[name] = {"element": elem, "frobenius": frob}
            if elem <= 1 and frob <= 1:
                raise AssertionError(f"flash_attention: the check passed "
                                     f"a wrong kernel ({name})")

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
        t0 = time.perf_counter()
        with self.profile() as prof:
            runner.run([0], acc=init_fn(0), max_rounds=1_000_000)
            torch.cuda.synchronize()
        times = device_times(prof)
        busy_s = sum(times.values()) / 1e6
        profile_s = time.perf_counter() - t0
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
            "profile_s": profile_s,
            "top_device_ms": top_ms(times, 6),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}

    # -- phase 5: the priority path ------------------------------------------

    def heap_golden(self, rt):
        """The JAX package's heap_sssp golden run, on the card."""
        torch = self.torch

        def step(acc, keys, vals, valid):
            acc = acc.index_add(0, torch.where(valid, vals % 97, 0),
                                valid.int())
            ck = torch.stack([keys + 3, keys + 7], -1).int()
            cv = torch.stack([vals * 2 + 1, vals * 2 + 2], -1).int()
            return acc, ck, cv, (valid & (keys < 24))[:, None]

        out = {}
        for fused in (True, False):
            r = rt.PriorityRoundRunner(step, capacity_log2=9, batch=16,
                                       fused=fused)
            acc, st = r.run([5, 1], [1, 2],
                            acc=torch.zeros(97, dtype=torch.int32,
                                            device=self.dev))
            got = {"stats": [r.stats[k] for k in STATS],
                   "acc": digest(acc.cpu().numpy()),
                   "planes": digest(st.keys.cpu().numpy(),
                                    st.vals.cpu().numpy())}
            if got != HEAP_GOLDEN or st.size != 0:
                raise AssertionError(f"heap golden (fused={fused}): {got}")
            out["fused" if fused else "legacy"] = got
        return out

    def heap_path(self, K, rt):
        """The full-size priority task tree, fused and legacy, against the
        closure oracle and each other; then the fused run again under the
        profiler."""
        np, torch = self.np, self.torch
        rng = np.random.default_rng(12)
        ik = rng.integers(0, 16, HEAP_SEEDS).astype(np.int32)
        iv = rng.integers(0, 2 ** 31 - 1, HEAP_SEEDS).astype(np.int32)
        t0 = time.perf_counter()
        want_acc, want_proc, want_spawn = heap_closure(np, ik, iv)
        oracle_s = time.perf_counter() - t0

        def step(acc, keys, vals, valid):
            acc = acc.index_add(0, torch.where(valid, vals % 4096, 0),
                                valid.int())
            ck, cv, cm = tree_children(
                keys.long(), vals.long(),
                lambda n: torch.arange(n, device=keys.device), valid)
            return acc, ck.int(), cv.int(), cm

        def run(fused):
            r = rt.PriorityRoundRunner(step, capacity_log2=HEAP_CAP_LOG2,
                                       batch=BATCH, fused=fused)
            acc = torch.zeros(4096, dtype=torch.int32, device=self.dev)
            out = r.run(ik, iv, acc=acc, max_rounds=1_000_000)
            torch.cuda.synchronize()
            return r, out

        info = {"phase": "heap", "golden": self.heap_golden(rt),
                "capacity": 1 << HEAP_CAP_LOG2, "batch": BATCH,
                "seeds": HEAP_SEEDS, "oracle_s": oracle_s}
        runs = {}
        for fused in (True, False):
            K.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r, (acc, st) = run(fused)
            wall = time.perf_counter() - t0
            runs[fused] = (r, acc.cpu().numpy(), st)
            name = "fused" if fused else "legacy"
            info[name] = {
                "rounds": r.stats["rounds"],
                "processed": r.stats["processed"],
                "spawned": r.stats["spawned"],
                "max_occupancy": r.stats["max_occupancy"],
                "readbacks": r.stats["host_syncs"], "run_s": wall,
                "rounds_per_s": r.stats["rounds"] / wall,
                "launches": dict(K.LAUNCHES),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            if fused:
                self.launches["heap"] = dict(K.LAUNCHES)
        (rf, af, sf), (rl, al, sl) = runs[True], runs[False]
        if not (np.array_equal(af, want_acc)
                and rf.stats["processed"] == want_proc
                and rf.stats["spawned"] == want_spawn):
            raise AssertionError("heap: fused run != closure oracle")
        same = (np.array_equal(af, al) and sf.size == sl.size == 0
                and torch.equal(sf.keys, sl.keys)
                and torch.equal(sf.vals, sl.vals)
                and all(rf.stats[k] == rl.stats[k] for k in STATS))
        if not same:
            raise AssertionError("heap: fused != legacy")
        st = rf.stats
        if not (1 << 18 <= st["max_occupancy"] <= 1 << HEAP_CAP_LOG2
                and st["rounds"] >= 500
                and 1_000_000 <= st["processed"] <= 4_000_000):
            raise AssertionError(f"heap: the run left its design range: "
                                 f"{st}")
        if self.launches["heap"]["heap_apply"] < 2 * st["rounds"]:
            raise AssertionError("heap: heap_apply launched fewer than two "
                                 "times per round")
        t0 = time.perf_counter()
        with self.profile() as prof:
            run(True)
        times = device_times(prof)
        busy = sum(times.values()) / 1e6
        info.update(oracle_exact=True, fused_equals_legacy=True,
                    device_busy_s=busy, profile_s=time.perf_counter() - t0,
                    idle_share=1 - busy / info["fused"]["run_s"],
                    top_device_ms=top_ms(times, 6))
        return info

    # -- phase 6: queue-driven BFS -------------------------------------------

    def queue_path(self, label, g, K, bfs, want):
        """bfs_queue and bfs_baseline on ``g``; both must give ``want``."""
        torch = self.torch
        info = {"phase": "bfs_queue", "graph": g.name, "n": g.n, "m": g.m}
        for fn in (bfs.bfs_queue, bfs.bfs_baseline):
            K.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            dist, st = fn(g, 0)
            wall = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
            if not self.np.array_equal(dist, want):
                raise AssertionError(f"{label}: {fn.__name__} dist wrong")
            t0 = time.perf_counter()
            with self.profile() as prof:
                fn(g, 0)
                torch.cuda.synchronize()
            times = device_times(prof)
            busy = sum(times.values()) / 1e6
            info[fn.__name__] = dict(
                st, run_s=wall, launches=launches, device_busy_s=busy,
                idle_share=1 - busy / wall,
                profile_s=time.perf_counter() - t0,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                top_device_ms=top_ms(times, 4))
            if fn is bfs.bfs_queue:
                if launches["frontier_expand"] != st["levels"]:
                    raise AssertionError(f"{label}: frontier_expand "
                                         f"launches != levels")
                q = self.launches["queue"]
                for k, v in launches.items():
                    q[k] = q.get(k, 0) + v
        if info["bfs_queue"]["levels"] != info["bfs_baseline"]["levels"]:
            raise AssertionError(f"{label}: level counts differ")
        info["dist_exact"] = True
        return info


    # -- phase 8: serving granite-moe-3b-a800m at full width -----------------

    def serve_trace(self):
        rng = self.np.random.default_rng(0)
        return [rng.integers(0, SERVE_VOCAB, SERVE_PROMPT)
                .astype(self.np.int32) for _ in range(SERVE_REQUESTS)]

    def serve_run(self, serving, cfg, params, device):
        """The request trace through a fresh ``ServingEngine``."""
        eng = serving.ServingEngine(
            cfg, params, serving.EngineConfig(max_slots=4, page_size=32,
                                              num_pages=32, max_seq=64),
            device=device)
        for rid, prompt in enumerate(self.serve_trace()):
            if not eng.submit(serving.Request(rid=rid, prompt=prompt,
                                              max_new_tokens=SERVE_NEW)):
                raise AssertionError("serve: the request pool refused a "
                                     "request")
        t0 = time.perf_counter()
        metrics = eng.run(max_ticks=10_000)
        if self.torch.device(device).type == "cuda":
            self.torch.cuda.synchronize()
        return eng, metrics, time.perf_counter() - t0

    def serve_path(self, K, configs, models, serving):
        """Phase 8; returns its line and the recorded kernel inputs of the
        prefill (for the rows of phase 7)."""
        np, torch = self.np, self.torch
        from repro_torch.models import layers
        # the module (the package exports a function of the same name)
        moe_route = importlib.import_module("repro_torch.kernels.moe_route")
        cfg = configs.get_config(SERVE_ARCH)
        t0 = time.perf_counter()
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(0)
        params = models.init_params(cfg, gen, device=self.dev)
        torch.cuda.synchronize()
        n_params = (sum(v.numel() for k, v in params.items() if k != "layers")
                    + sum(v.numel() for v in params["layers"].values()))
        if n_params != cfg.param_count():
            raise AssertionError(f"serve: {n_params} parameters, the config "
                                 f"counts {cfg.param_count()}")
        info = {"phase": "serve", "arch": cfg.name, "params": n_params,
                "init_s": time.perf_counter() - t0}
        tokens = torch.as_tensor(np.random.default_rng(13).integers(
            0, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN)), device=self.dev)

        # record the kernels' inputs of the first and the last layer
        seen = {"flash": [], "tickets": []}
        real_flash, real_tickets = (layers.flash_attention,
                                    moe_route.expert_tickets)

        def flash_spy(q, k, v, **kw):
            seen["flash"].append((q, k, v, kw))
            return real_flash(q, k, v, **kw)

        def tickets_spy(ids, **kw):
            seen["tickets"].append((ids, kw))
            return real_tickets(ids, **kw)

        models.prefill(params, tokens, cfg)            # warm-up
        torch.cuda.synchronize()
        layers.flash_attention, moe_route.expert_tickets = (flash_spy,
                                                            tickets_spy)
        try:
            K.reset_launches()
            t0 = time.perf_counter()
            logits, caches = models.prefill(params, tokens, cfg)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
        finally:
            layers.flash_attention, moe_route.expert_tickets = (
                real_flash, real_tickets)
        self.launches["prefill"] = launches
        L = cfg.n_layers
        if launches["flash_attention"] != L or \
                launches["expert_tickets"] != L:
            raise AssertionError(f"prefill: launches {launches}, expected "
                                 f"{L} flash_attention and {L} "
                                 f"expert_tickets")
        if logits.shape != (PREFILL_BATCH, 1, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError("prefill: last-token logits not finite")
        if caches["k"].shape != (L, PREFILL_BATCH, PREFILL_LEN,
                                 cfg.n_kv_heads, cfg.hd):
            raise AssertionError("prefill: cache shape")
        for i in (0, L - 1):
            q, k, v, kw = seen["flash"][i]
            self.flash_case(K, q, k, v, **kw)
            ids, kw = seen["tickets"][i]
            self.tickets_case(K, ids, kw["num_experts"], kw["capacity"])
        ids, kw = seen["tickets"][0]
        dropped = float((real_tickets(ids, **kw) < 0).float().mean())
        info["prefill"] = {
            "batch": PREFILL_BATCH, "prompt_len": PREFILL_LEN,
            "run_s": prefill_s,
            "tokens_per_s": PREFILL_BATCH * PREFILL_LEN / prefill_s,
            "launches": launches, "capacity": seen["tickets"][0][1]
            ["capacity"], "dropped_share_layer0": dropped,
            "kernels_held_on_layers": [0, L - 1],
            "logits_finite": True}

        # serve at full width on the card, then the same trace at reduced
        # width on the CPU
        self.serve_run(serving, cfg, params, self.dev)   # warm-up
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        eng, metrics, serve_s = self.serve_run(serving, cfg, params,
                                               self.dev)
        launches = dict(K.LAUNCHES)
        self.launches["serve"] = launches
        small = cfg.reduced()
        cpu_gen = torch.Generator()
        cpu_gen.manual_seed(0)
        cpu_params = models.init_params(small, cpu_gen, device="cpu")
        t0 = time.perf_counter()
        ceng, cmetrics, _ = self.serve_run(serving, small, cpu_params, "cpu")
        cpu_s = time.perf_counter() - t0
        want = (SERVE_REQUESTS, SERVE_REQUESTS * SERVE_NEW)
        if (metrics["completed"], metrics["tokens_out"]) != want:
            raise AssertionError(f"serve: {metrics}")
        keys = ("admitted", "decode_steps", "page_stalls")
        if [metrics[k] for k in keys] != [cmetrics[k] for k in keys] or \
                eng.admission_log != ceng.admission_log:
            raise AssertionError(f"serve: card {metrics} "
                                 f"{eng.admission_log} != CPU {cmetrics} "
                                 f"{ceng.admission_log}")
        if launches["expert_tickets"] != L * metrics["decode_steps"]:
            raise AssertionError(f"serve: expert_tickets launched "
                                 f"{launches['expert_tickets']} times in "
                                 f"{metrics['decode_steps']} steps")
        info["serve"] = {
            "requests": SERVE_REQUESTS, "prompt_len": SERVE_PROMPT,
            "max_new": SERVE_NEW, "metrics": metrics,
            "admission_log": eng.admission_log, "run_s": serve_s,
            "tokens_out_per_s": metrics["tokens_out"] / serve_s,
            "decode_steps_per_s": metrics["decode_steps"] / serve_s,
            "readbacks": eng.host_syncs, "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "cpu_reduced_run": {"metrics": cmetrics, "run_s": cpu_s},
            "schedule_equals_cpu": True}

        # both again under the profiler
        for name, run in (("prefill", lambda: models.prefill(params, tokens,
                                                             cfg)),
                          ("serve", lambda: self.serve_run(
                              serving, cfg, params, self.dev))):
            t0 = time.perf_counter()
            with self.profile() as prof:
                run()
                torch.cuda.synchronize()
            times = device_times(prof)
            busy = sum(times.values()) / 1e6
            info[name].update(device_busy_s=busy,
                              idle_share=1 - busy / info[name]["run_s"],
                              profile_s=time.perf_counter() - t0,
                              top_device_ms=top_ms(times, 6))
        return info, seen


def busiest_level(np, g, dist):
    """The BFS level whose frontier scans the most edges."""
    deg = np.diff(g.row_ptr).astype(np.int64)
    reached = dist >= 0
    return int(np.argmax(np.bincount(dist[reached], weights=deg[reached])))


def level_input(np, dist, level):
    """The frontier (vertices at ``level``, ascending) and visited map
    (vertices at levels <= ``level``) that expand into ``level + 1``."""
    f = np.flatnonzero(dist == level).astype(np.int32)
    vis = ((dist >= 0) & (dist <= level)).astype(np.int32)
    return f, vis


def device_times(prof) -> dict:
    """Device microseconds by name (kernels, copies, sets) of everything a
    profiler recorded on the card, summed from its raw trace: building the
    profiler's event tree (``key_averages``) for a run of thousands of
    rounds takes many times longer than the run.  Raises when it recorded
    no device time (the tracer does not reach the card)."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            out[e.name()] = out.get(e.name(), 0.0) + e.duration_ns() / 1e3
    if sum(out.values()) <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return out


def top_ms(times: dict, k: int) -> dict:
    """The ``k`` names with the most device time, in milliseconds."""
    top = sorted(times.items(), key=lambda kv: kv[1], reverse=True)[:k]
    return {name[:60]: us / 1e3 for name, us in top}


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
    # float32 products in full float32 (the plain versions' reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import configs, models, serving
    from repro_torch import kernels as K
    from repro_torch.apps import bfs
    from repro_torch.kernels import _build

    # 1. build
    info = _build.build_all()
    regs = {name: [ln.split("info    : ")[-1] for ln in log.splitlines()
                   if "registers" in ln]
            for name, log in info["ptxas"].items()}
    emit_phase({"phase": "build", "nvcc": info["nvcc"],
                "seconds": info["seconds"], "built": info["built"],
                "ptxas": regs})

    smoke = Smoke(torch, np)
    from repro_torch import runtime as rt
    kron = bfs.kron_like(KRON_N, avg_deg=4, seed=1)
    kron_lanes = BATCH * int(np.diff(kron.row_ptr).max())
    road = bfs.road_like(ROAD_SIDE * ROAD_SIDE)
    v = np.arange(road.n)
    road_dist = (v // ROAD_SIDE + v % ROAD_SIDE).astype(np.int32)
    t0 = time.perf_counter()
    qkron = bfs.kron_like(QKRON_N, avg_deg=QKRON_DEG, seed=1)
    qkron_dist = bfs_levels(np, qkron, 0)
    qkron_s = time.perf_counter() - t0

    # 2. kernels against their plain versions
    t0 = time.perf_counter()
    smoke.compare_wavefaa(K)
    smoke.compare_ring(K)
    smoke.compare_compact(K, kron_lanes)
    smoke.compare_heap(K)
    smoke.compare_frontier(K, {"road": (road, road_dist),
                               "kron": (qkron, qkron_dist)})
    smoke.compare_moe(K)
    smoke.compare_flash(K)
    torch.cuda.synchronize()
    emit_phase({"phase": "compare",
                "exact": sorted(k for k in smoke.cases
                                if k != "flash_attention"),
                "within_tolerance": {"flash_attention": FLASH_TOL},
                "cases": smoke.cases, "max_abs_err": smoke.err,
                "bound_used": smoke.bound_used,
                "wrong_results_rejected": smoke.rejected,
                "seconds": time.perf_counter() - t0})

    # 3. main path: road BFS at full size
    dist, road_info = smoke.run_path("road", road, K, bfs)
    if not np.array_equal(dist, road_dist):
        raise AssertionError("road: dist != row + col")
    for name in ("wavefaa", "ring_dequeue", "ring_enqueue"):
        if road_info["launches"][name] <= 0:
            raise AssertionError(f"road: {name} was not launched")
    road_info["dist_exact"] = True
    emit_phase(road_info)
    smoke.launches["road"] = road_info["launches"]

    # 4. compaction path: kron BFS
    dist, kron_info = smoke.run_path("kron", kron, K, bfs)
    if not np.array_equal(dist, bfs.bfs_reference(kron, 0)):
        raise AssertionError("kron: dist != bfs_reference")
    for name in ("wave_compact", "ring_dequeue", "ring_enqueue"):
        if kron_info["launches"][name] <= 0:
            raise AssertionError(f"kron: {name} was not launched")
    kron_info["dist_exact"] = True
    emit_phase(kron_info)
    smoke.launches["kron"] = kron_info["launches"]

    # 5. priority path: the golden run, then the full-size task tree
    heap_info = smoke.heap_path(K, rt)
    emit_phase(heap_info)

    # 6. queue-driven BFS on road 2048^2 and kron 2^20
    emit_phase(smoke.queue_path("road", road, K, bfs, road_dist))
    kron_q = smoke.queue_path("kron", qkron, K, bfs, qkron_dist)
    kron_q["setup_s"] = qkron_s
    emit_phase(kron_q)

    # 8. serving granite-moe-3b-a800m at full width
    serve_info, seen = smoke.serve_path(K, configs, models, serving)
    emit_phase(serve_info)

    # 7. kernel times at the paths' shapes
    emit({"kernels": kernel_rows(smoke, K, road_info, kron_info, heap_info,
                                 (qkron, qkron_dist), seen)})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def kernel_rows(smoke, K, road, kron, heap, qkron, seen):
    """Time each kernel, its plain version and one PyTorch library call
    where one computes the same function (torch.cumsum for the scans,
    scaled_dot_product_attention for flash attention) at its path's
    shapes, with the densities the runs produced; compute each one's
    bound from the same inputs.  ``qkron`` is the bfs_queue kron graph and
    its distances, ``seen`` the kernel inputs recorded in phase 8's
    prefill."""
    torch, np, dev = smoke.torch, smoke.np, smoke.dev
    rng = np.random.default_rng(1)
    rows = []
    last = [time.perf_counter()]

    def bound(nbytes, ops, rate):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = ops / rate * 1e3
        return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")

    def row(name, source, replaces, kern, plain, lib, nbytes, ops, shape,
            rate=ALU_OPS_PER_S):
        """``kern``/``plain``/``lib`` are (device_ms, wall_ms) pairs; ops
        are counted against ``rate``."""
        b, by = bound(nbytes, ops, rate)
        by_path = {k: p.get(name, 0) for k, p in smoke.launches.items()}
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "exact": smoke.err[name] == 0 and name != "flash_attention",
            "max_abs_err": smoke.err[name],
            "ms": kern[0], "plain_ms": plain[0], "bound_ms": b,
            "bound_by": by, "library_ms": lib[0] if lib else None,
            "wall_ms": {"kernel": kern[1], "plain": plain[1],
                        "library": lib[1] if lib else None},
            "shape": shape, "timing_s": time.perf_counter() - last[0]})
        last[0] = time.perf_counter()

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

    # B4 heap_apply: the priority path's batches on its 2^20-slot heap
    # holding half the run's peak occupancy; even calls pop 1,024, odd
    # calls insert 2,048 lanes at the run's child density.  The plain
    # version is a host loop over the planes copied off the card, so its
    # time is wall time.  No single PyTorch call maintains a heap.
    hf = heap["fused"]
    c4, occ = HEAP_CAP_LOG2, hf["max_occupancy"] // 2
    card = dict(dtype=torch.int32, device=dev)
    heap_k = torch.full((1 << c4,), KEY_INF, **card)
    heap_v = torch.full((1 << c4,), -1, **card)
    seed = torch.as_tensor(rng.integers(0, HEAP_HORIZON, occ,
                                        dtype=np.int32), device=dev)
    K.heap_apply(heap_k, heap_v, 0, torch.zeros(occ, **card), seed, seed,
                 cap_log2=c4)
    pops = (torch.ones(BATCH, **card), torch.full((BATCH,), KEY_INF, **card),
            torch.full((BATCH,), -1, **card))
    density4 = hf["spawned"] / (hf["rounds"] * 2 * BATCH)
    act4 = rng.random(2 * BATCH) < density4
    inserts = (torch.as_tensor(np.where(act4, 0, -1).astype(np.int32),
                               device=dev),
               torch.as_tensor(rng.integers(0, HEAP_HORIZON + 4, 2 * BATCH,
                                            dtype=np.int32), device=dev),
               torch.as_tensor(rng.integers(0, 1 << 30, 2 * BATCH,
                                            dtype=np.int32), device=dev))
    n_act4 = int(act4.sum())

    def heap_setup():
        return [heap_k.clone(), heap_v.clone(),
                torch.tensor(occ, **card)]

    def heap_call(fn):
        def launch(st, i):
            st[2] = fn(st[0], st[1], st[2], *(pops if i % 2 == 0
                                              else inserts),
                       cap_log2=c4)[2]
        return launch

    plain4 = smoke.time_ms(heap_setup, heap_call(K.heap_apply_plain),
                           iters=4, reps=2)
    depth4 = max(int(np.ceil(np.log(occ) / np.log(4))), 1)
    row("heap_apply", csrc + "heap_batch.cu",
        "src/repro/kernels/heap_batch.py:47",
        smoke.time_ms(heap_setup, heap_call(K.heap_apply)),
        (plain4[1], plain4[1]), None,
        # per call, the mean of a pop call and an insert call: the opcode
        # of every lane in (4 B) and the key and val of each INSERT lane
        # (8 B), results out (9 B a lane), the size word each way.  A pop
        # reads the root and the last leaf and scrubs the leaf's slot
        # (24 B), and the leaf sifts down from the root through about
        # log_4(size) levels, each reading 4 child keys and the winner's
        # val and writing one key + val (28 B); an applied insert reads a
        # parent key and writes its node (12 B).  Compares: 4 children per
        # level on a pop's path.
        (BATCH * (4 + 9 + 24 + depth4 * 28) + 2 * BATCH * (4 + 9)
         + n_act4 * (8 + 12) + 16) / 2, BATCH * depth4 * 4 / 2,
        {"heap_slots": 1 << c4, "occupancy": occ, "pop_lanes": BATCH,
         "insert_lanes": 2 * BATCH, "insert_active": n_act4,
         "plain_ms_is": "wall (host loop)"})

    # B5 frontier_expand: the kron 2^20 BFS's level with the most edges,
    # each call from that level's own visited map.  No single PyTorch
    # call expands a BFS level in discovery order.
    g5, dist5 = qkron
    lvl = busiest_level(np, g5, dist5)
    f5, vis5 = level_input(np, dist5, lvl)
    rp5, col5, ft5, vt5 = (torch.as_tensor(x, device=dev) for x in
                           (g5.row_ptr, g5.col_idx, f5, vis5))
    max_out5, iters5 = max(g5.n, 16), 20
    scratch5 = K.frontier_scratch(g5.n, dev)
    edges5 = int(np.diff(g5.row_ptr)[f5].sum())
    fresh5 = int((dist5 == lvl + 1).sum())
    # the distinct row_ptr words (f and f + 1 of each frontier vertex) and
    # the distinct targets of the level's edges: each is read once at least
    start5 = g5.row_ptr[f5].astype(np.int64)
    deg5 = np.diff(g5.row_ptr)[f5].astype(np.int64)
    eidx5 = (np.repeat(start5 - np.cumsum(deg5) + deg5, deg5)
             + np.arange(edges5))
    targets5 = len(np.unique(g5.col_idx[eidx5]))
    rp_words5 = len(np.union1d(f5, f5 + 1))

    def fr_setup():
        return [vt5.clone() for _ in range(iters5)]

    row("frontier_expand", csrc + "frontier.cu",
        "src/repro/kernels/frontier.py:25",
        smoke.time_ms(fr_setup, lambda v, i: K.frontier_expand(
            rp5, col5, ft5, v[i], max_out=max_out5, scratch=scratch5),
            iters=iters5),
        smoke.time_ms(fr_setup, lambda v, i: K.frontier_expand_plain(
            rp5, col5, ft5, v[i], max_out=max_out5), iters=iters5),
        None,
        # the frontier and its distinct row_ptr words in; per scanned edge
        # its col word; per distinct target its visited word in; per fresh
        # vertex its visited word out; the whole -1-padded output and the
        # count out
        len(f5) * 4 + rp_words5 * 4 + edges5 * 4 + targets5 * 4
        + fresh5 * 4 + max_out5 * 4 + 4, edges5,
        {"graph": g5.name, "level": lvl, "frontier": len(f5),
         "edges": edges5, "targets": targets5, "fresh": fresh5,
         "max_out": max_out5})

    # B6 expert_tickets: the expert ids of the serve prefill's first MoE
    # layer (2 x 4,096 tokens x top-8 = 65,536 pairs, 40 experts).  The
    # library call is an int32 torch.cumsum of the one-hot, the scan B1/B3
    # are timed against, laid out (E, N) so that it runs along the
    # contiguous axis; the (N, E) layout's scan down the strided axis is
    # timed beside it.  The one-hots are built untimed.
    ids6, kw6 = seen["tickets"][0]
    n6, e6 = ids6.shape[0], kw6["num_experts"]
    onehot6 = torch.nn.functional.one_hot(ids6.long(), e6).int()
    onehot6_t = onehot6.t().contiguous()
    strided6 = smoke.time_ms(lambda: None, lambda a, i: torch.cumsum(
        onehot6, 0, dtype=torch.int32), iters=10, reps=3)
    row("expert_tickets", csrc + "moe_route.cu",
        "src/repro/kernels/moe_route.py:25",
        smoke.time_ms(lambda: None,
                      lambda a, i: K.expert_tickets(ids6, **kw6)),
        smoke.time_ms(lambda: None,
                      lambda a, i: K.expert_tickets_plain(ids6, **kw6),
                      iters=20, reps=3),
        smoke.time_ms(lambda: None, lambda a, i: torch.cumsum(
            onehot6_t, 1, dtype=torch.int32)),
        # the ids in, the slots out
        8 * n6, n6,
        {"pairs": n6, "experts": e6, "capacity": kw6["capacity"],
         "dropped": int((K.expert_tickets(ids6, **kw6) < 0).sum()),
         "library": "torch.cumsum of the (E, N) int32 one-hot along N",
         "library_ms_n_e_layout": strided6[0]})

    # B7 flash_attention: the q/k/v of the serve prefill's first layer,
    # the model's (B, S, H, hd) bfloat16 activations as (B, H, S, hd)
    # views.  Library: scaled_dot_product_attention with the same causal
    # mask and GQA, timed here only (the port never calls it).
    q7, k7, v7, kw7 = seen["flash"][0]
    b7, h7, s7, hd7 = q7.shape
    kvh7 = k7.shape[1]
    pairs7 = s7 * (s7 + 1) // 2          # causal (query, key) pairs
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row("flash_attention", csrc + "flash_attn.cu",
        "src/repro/kernels/flash_attn.py:38",
        smoke.time_ms(lambda: None,
                      lambda a, i: K.flash_attention(q7, k7, v7, **kw7),
                      iters=20),
        smoke.time_ms(lambda: None, lambda a, i: K.flash_attention_plain(
            q7, k7, v7, **kw7), iters=5, reps=3),
        smoke.time_ms(lambda: None, lambda a, i: sdpa(
            q7, k7, v7, is_causal=True, enable_gqa=True), iters=20),
        # q and out (B, H, S, hd), k and v (B, KV, S, hd), bfloat16; two
        # products of 2 * hd flop per causal (query, key) pair and head
        2 * (2 * b7 * h7 * s7 * hd7 + 2 * b7 * kvh7 * s7 * hd7),
        4 * b7 * h7 * pairs7 * hd7,
        {"q": [b7, h7, s7, hd7], "kv_heads": kvh7, "dtype": "bfloat16",
         "causal": kw7["causal"], "window": kw7["window"],
         "softcap": kw7["softcap_val"], "tolerance": FLASH_TOL,
         "bound_used": smoke.bound_used["flash_attention"],
         "layout": "(B, S, H, hd) strided"},
        rate=BF16_TC_FLOP_PER_S)
    return rows


if __name__ == "__main__":
    sys.exit(main())
