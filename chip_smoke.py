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
              ring_dequeue_wave, ring_enqueue_wave and their packed and
              sharded instances, wave_compact, heap_apply and its rider
              instance,
              obs_record, frontier_expand, expert_tickets,
              flash_attention) against its plain PyTorch version on the
              card, at the paths' shapes and at the CPU tests' edge cases
              (the round's two wave kernels on the single ring, one
              shard, at road's shape (2^24 slots,
              batch 1,024, 4,096-lane ballots), in kron's dense mode, at
              batches of 3,000 and 8,192 with a three-tile ballot, with
              counters that wrap past 2^31 and 2^32, on a ring that
              overflows, with live=False calls, empty and full masks and
              k = 0, 1, below and at the batch, every case at least ten
              calls queued back to back; the packed waves (birth stamps)
              at road's and kron's shapes with unpacked seeds (flag 1,
              birth 0), birth rounds 0, 1 and 2^30 - 1, wrapping
              counters, an overflowing ring and live=False calls;
              heap_apply's rider instance at arities 2, 4 and 8 across
              its own shared-memory top, the inserts' rider a 0-d device
              word or one per lane; obs_record against the torch-op
              record at road's and the goldens' shapes, with planes that
              wrap, 3,000 lanes, class rows and each plane alone; the
              mesh's instances: ring_enqueue / ring_dequeue with an
              explicit active mask (live tickets 2^31 - 64 ... 2^31 + 64
              and 2^32 - 64 ... 2^32 + 64 installed and consumed in full,
              enq_planes / deq_planes on the card against the host),
              the two wave kernels on the mesh's shard grids
              (replicated, sharded and packed) at the mesh tree's and
              road's shapes and at S =
              1, 2, 4 and 8 with k = 0, 1, below, at and above S x batch,
              ballot and grid-dense publishes, wrapping counters, an
              overflowing round in each mode, one sharded ring
              overflowing alone and live=False calls, and obs_record over
              S = 1, 2, 4 and 8 shards (stacked span planes);
              heap_apply_grid (B4 over a shard grid: one launch, a block
              a heap) and its rider instance at S = 1, 2, 4 and 8 and
              arities 2, 4 and 8, pop waves (counts of 0 and past a
              heap's size) and gathered insert waves (-1 lanes, one shard
              installing nothing, duplicate and KEY_INF keys, heaps filled
              past capacity and driven to just below and at it), heaps
              across the shared-memory top at 2^15 slots, the priority
              mesh's shapes at 2^20 and the strict paths' one heap (the
              tree's 4,096-pop waves at 2^20, SSSP's 16,384-lane inserts
              with a rider at 2^22), ten calls a case back to back;
              wavefaa at 1,024, 4,096 (road's wave), 8,192, 1.26 M and
              2^22 lanes with wrapping counters, wave_compact also at 2^22
              and 2^22 - 77 lanes with width overflow, every case of both
              as ten calls queued back to back on one scratch with no
              synchronise between them; heap batches at arities 2, 4 and
              8, ten calls queued back to back per case, into a full and
              out of an empty heap at 2^4, 2^6, 2^15 and 2^20 slots with
              NOP lanes,
              duplicate and KEY_INF keys, heaps just below, at and just
              above the kernel's shared-memory top, pops and inserts
              whose paths cross it, and the heap path's 1,024-pop /
              2,048-insert batches; frontier levels, ten calls queued back
              to back per case on one scratch and two kept output buffers,
              with -1 slots, duplicate neighbours, no edges, max_out
              overflow, and consecutive real levels of each graph of
              phase 6 (its busiest, its median, an overflowing hub level),
              edge counts included; expert tickets, ten calls back to
              back per case, for N of 32 to 65,536 (1,024 and 1,025
              across the kernel's one-block limit), 8, 40, 64, 128 and 257
              experts, -1 lanes and ids past E, capacities 0, 1, below
              and above the largest expert count, all pairs on one
              expert; flash attention on the four
              configurations of the JAX package's kernel tests in float32
              and bfloat16, the prefill shape in bfloat16, a gemma2-style
              window of 4,096 with softcap 50 at S = 8,192, Sq < Sk, hd 80
              (h2o-danube-1.8b), hd 128 causal with GQA at S = 4,096, Sk
              not a multiple of the 128-key tile, the model's strided
              layout, gemma3-4b's hd 256 at its prefill shape (GQA 8/4,
              window 1,024 and causal) and with Sq < Sk and softcap, and
              float32 at hd 80, 128 and 256).  The integer kernels must be
              bit-exact; flash attention is held against its plain version
              at the tiles of the kernel that runs it (``kernel_tiles``),
              element by
              element (one ulp of the output plus 2^-5 of its rms in
              bfloat16) and in the Frobenius norm (2^-10 in bfloat16;
              1e-5 throughout in float32), as ``FLASH_TOL`` states.
3. road     — first the ``fifo_fanout`` golden run of the JAX package's
              tests (fused, with host_syncs 1, and legacy).  Then
              ``bfs_rounds`` on road_like(2048 * 2048) (4,194,304
              vertices) at batch 1024 on the fused engine's device loop
              (a drained run is one CUDA graph launch whose conditional
              WHILE node replays the round, and one readback: host_syncs
              1 and sync_log [(rounds, 0)]); dist[v] must be row(v) +
              col(v) everywhere, and ring_dequeue_wave and
              ring_enqueue_wave must have launched once a round, wavefaa
              and the standalone ring_dequeue never and ring_enqueue once
              (the seed).  The same engine's rounds issued eagerly from
              the host, 64 to a readback, must give the same dist and
              stats; both are timed (host clock and CUDA events around the
              run), and the nodes of the captured round are counted
              (``graph_nodes``: total, by type, kernels by name).
4. kron     — the compaction path: ``bfs_rounds`` on
              kron_like(65536, avg_deg=4, seed=1) at batch 1024 as in
              phase 3; dist must equal the sequential BFS oracle and
              wave_compact and both wave kernels must have launched once
              a round.
5. heap     — the priority path.  First the ``heap_sssp`` golden run of
              the JAX package's tests on the card (fused and legacy:
              stats [10, 124, 122, 46, 1], the acc and plane digests, and
              host_syncs 1 fused).
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
              seeds under the child rule; fused (one readback) must equal
              legacy and the eager 64-round chunks bit for bit; heap_apply
              must launch at least twice per round.
5b. obs     — the observability slice: both goldens with
              Telemetry(capacity=256) and Spans(classes=1, buckets=8) on
              the device loop (their tel and spans digests, stats,
              host_syncs 1); road 2048² with Telemetry(capacity=8,192)
              and Spans(), and the 2^20 heap tree with
              Telemetry(capacity=2,048) and Spans(): state, stats and
              one readback equal to phases 3 and 5's obs-off runs (road's
              dist = row + col, the heap's acc = the closure oracle), one
              record a round, pops and pushes summing to processed and
              spawned, the histogram's total = the pops; the packed
              waves, the rider heap_apply and obs_record launched once a
              round or more.  Each timed in turns with its obs-off twin
              ((off, on, on, off) x 3: µs a round, rounds/s) and its captured
              round's nodes counted with obs off and on.
mesh.       — the FIFO mesh on one card, the shard axis a tensor
              dimension (``repro_torch.runtime.meshrounds``).  The
              JAX package's mesh goldens (mesh_fanout and mesh_fanout_2
              with their tel digests, mesh_bfs and mesh_bfs_2) on the
              device loop with host_syncs 1, and the legacy loop's same
              state; the functional rounds (core.distqueue at 4 x 1,024
              requests, the masked ring waves) from tickets 8,192 below
              2^31 and 2^32, every granted value back once in order;
              bfs_mesh_rounds on road_like(215 * 215) (46,225 vertices,
              the largest square with n (n + 2) < 2^31) at 4 shards and
              batch 1,024, replicated (2^20 slots) and sharded (four
              rings of 2^18): dist = row + col for both,
              ring_dequeue_wave and ring_enqueue_wave once a round (the
              sharded run's totals are reported beside the replicated
              ones: the label-correcting BFS re-expands by claim order);
              the FIFO
              task tree (65,536 seeds numpy.random.default_rng(15)
              .integers(0, 2^27) << 4, two children a pop c = 0, 1 with h
              = tree_hash(val, c), child val ((h >> 1) & 0x7FFFFFF0) |
              (depth + 1), spawned iff depth < 14 and (h & 15) < 10:
              7,211,034 pops) at 4 shards, batch 1,024 and
              capacity_log2=22, replicated, sharded and on RingEngine at
              batch 4,096: acc, processed and spawned equal the numpy
              closure for all three, the replicated mesh equals
              RingEngine bit for bit (stats, acc, planes, head/tail),
              timed in turns (replicated, sharded, single) x 3 with the
              captured rounds' nodes; the replicated and the sharded
              tree again with compact=True (each shard's child row through
              wave_compact, then the dense enqueue wave): the ballot run's
              state, wave_compact 4 times and each wave kernel once a
              round; then the replicated tree with Telemetry (4 shard
              columns) and Spans(): its state equal to the obs-off run,
              one record a round whose pops and pushes sum to processed
              and spawned, the packed waves and obs_record once a round.
pmesh.      — the priority mesh on one card
              (``PriorityMeshRoundRunner``, relaxed and strict).  The JAX
              package's pmesh goldens (pmesh_relaxed, pmesh_strict and
              their 2-shard rows, tel digests included) fused with one
              readback and legacy; the same four runs once more on the
              legacy loop with ``trace=True`` (tree-numbered payloads:
              the checker needs each payload once), their stats the
              goldens' and their ``mesh_trace_history`` priority-
              linearizable under the port's ``check_p_linearizable`` (k
              = 0 strict, ``mesh_relaxation_bound`` relaxed); delta-stepping SSSP
              (``apps.sssp``) on road_like(1024 * 1024) (1,048,576
              vertices, the size of USA-road-d.FLA of the 9th DIMACS
              challenge) with weights 1-8 (seed 1) at 4 shards x 1,024,
              the split payload and delta 4, relaxed and strict: dist
              equal to scipy's Dijkstra, one readback, the rider grid
              twice a round; phase 5's priority task tree at 4 x 1,024,
              relaxed on four heaps of 2^20 slots and strict on one, and
              PriorityRoundRunner at batch 4,096: each equal to the
              closure oracle, strict equal to PriorityRoundRunner bit for
              bit, timed in turns with the captured rounds' nodes; the
              relaxed tree with compact=True (the ballot run's state) and
              with Telemetry and Spans() against the run without them.
raytrace. — the paper's Fig. 7 scenes (``apps.raytrace``: complex, 100
              spheres, 2 bounces; cornell, 2 spheres, 4 bounces) at
              1920 x 1080 (2,073,600 pixel ids, ring 2^21, batch
              65,536): ``render_rounds`` on the ring engine's device
              loop (the trace is plain PyTorch inside the captured
              round; the ring waves B2a/B2b once a round, the
              standalone enqueue once for the seed), one readback,
              against ``render_compaction`` on the same card (rays
              equal, images within RAY_TOL); MRays/s of both, µs a round
              (CUDA events), the captured round's nodes and the idle
              share (the profiler over a second run).  Then both scenes
              at 256 x 256, batch 256, fused against legacy
              (``ring_dequeue`` / ``ring_enqueue`` a round): bit for bit.
admission. — device serving admission (``serving.ServingMeshEngine``):
              (a) the JAX package's serving goldens (GOLDEN["serving"],
              GOLDEN_2SHARD["serving_2"] of tests/test_enginecore.py)
              with Telemetry(capacity=256): stats, ticks, admitted order,
              planes, pop history and tel digests; (b) a backlogged
              server's tick stream (ADM_TRAFFIC: 48,168 requests over
              1,000 ticks with Pareto bursts, 40 slots and 4,096 pages
              of 16 tokens a tick, then drain ticks) at one shard and at
              four, heaps of 2^16 a shard, batch 256, 4-ary: at one shard
              every tick's admitted list equal to a heapq EDF oracle, at
              four each request admitted once within every tick's
              budgets (the ticks off the oracle counted), one readback a
              tick (the copies to the host counted under the profiler
              over 50 ticks), heap_apply_grid twice a round and once a
              tick with arrivals; (c) phase 8's granite-moe serve again
              with ``admission="device"``: its admission log, completed
              requests and decode steps equal to the EDF serve's.
runtime.  — the host task runtime (``runtime.taskpool``,
              ``runtime.executor``) and its consumers: (a)
              ``mesh_task_round`` on the card, the FIFO task tree of 16,384
              seeds (1,792,495 pops) drained one round at a time at 4
              shards x 1,024 claims on a replicated ring of 2^20 slots
              whose tickets start 2^20 below 2^32 (head and tail wrap),
              against ``fifo_closure`` exactly once, the masked waves
              B2b and B2a once each a round, its first 64 rounds bit for
              bit against the same rounds on the plain waves; (b)
              ``render_runtime`` (tiles 4 x 4, 32 workers, 4 shards,
              stealing, G-LFQ, waves of 4,096 rays) on both Fig. 7 scenes
              at 1920 x 1080, image and rays bit-identical to phase
              raytrace's ``render_rounds``, and cornell at 256² on each
              of the four queue algorithms, the same image; (c)
              ``bfs_runtime`` on kron_like(4,096, avg_deg=6, seed=2), 32
              workers, each algorithm, against ``bfs_reference``; (d)
              phase 8's granite-moe serve with ``admission="lanes"``,
              requests 6 and 7 urgent: all complete, the urgent ones
              admitted first, the schedule equal to the port's CPU lanes
              run at the reduced width.
6. bfs_queue — ``bfs_queue`` (the frontier kernel) and ``bfs_baseline``
              (a plain dense sweep) on the road graph of phase 3 and on
              kron_like(2^20, avg_deg=16, seed=1); road dist must be
              row + col, kron dist must equal a vectorised numpy level
              sweep, the two must agree, frontier_expand must launch
              once per level and bfs_queue read back one int per level
              (plus the edge total and dist once each).
7. kernels  — per kernel: launches on each path (phases 3-6, mesh,
              pmesh, raytrace (``ray``), admission, runtime, 8 and 9;
              a kernel inside the device loop's graph counts once per
              round it ran),
              exactness or max error, its device time per call at its
              path's shape (CUDA events around calls queued behind a
              sleep, so no host gap counts) beside its plain version's, one
              PyTorch library call's time where one computes the same
              function, the least time the card could take (bytes over
              3.35 TB/s, or operations over the card's rate for their
              type), and the wall time per call of back-to-back calls,
              which includes the host's launch cost, and what the paths
              lose to it beyond its bound (launches x (time - bound)).
              heap_apply is timed as a pop call and an insert call, each
              also against a dependent-chain bound; frontier_expand at the
              busiest level of kron 2^20 and at the busiest and the median
              level of road.  wavefaa also at 2^22 lanes, expert_tickets
              also at a decode step's 32 pairs.  The two wave kernels, a
              row an instance, at road's shape (the row's own), kron's
              (its ``kron``) and the mesh tree's (its ``mesh``; the
              sharded instances at the mesh tree's alone).  The flash
              attention row
              also carries the same times at hd 128 (q (1, 32, 4096, 128),
              kv 8, causal) under ``hd128`` and on gemma3-4b's layer 5
              (global) and layer 0 (window 1,024) inputs of phase 9 under
              ``hd256_global`` and ``hd256_local``.  ``device_loop``
              (csrc/loop.cu) is the WHILE node's own cost a round on a
              one-kernel body, against the same body issued from the host
              with a readback a round; its row also carries the nodes of
              each engine's captured round (road, kron, heap, road and
              heap with obs on, the meshes, the raytrace renders and the
              admission streams).  The packed waves at road's and
              kron's shapes, the rider heap_apply at the heap path's
              (beside the rider-less instance's time) and obs_record at
              one road round's record have rows of their own; their
              launches come from phase 5b.  The mesh's instances have
              rows at the mesh tree's shapes (masked ring_enqueue at its
              65,536 seeds, masked ring_dequeue at the functional rounds'
              4 x 1,024 requests); their launches come from phase mesh.
              heap_apply_grid and its rider instance have rows at the
              priority mesh's shapes (phase pmesh; heap_apply_grid also
              at the admission streams'): the relaxed tree's
              pop (4 x 1,024) and insert (8,192 lanes) waves beside one
              heap's 1,024-pop call by the grid and by heap_apply, the
              strict tree's (4,096 pops, one heap), SSSP's and the
              spanned tree's (rider), each against a bytes and a
              dependent-chain bound.  wave_compact also at the meshes'
              2,048-lane rows.
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
9. prefill_gemma3 — gemma3-4b at full width (34 layers, d_model 2,560,
              8/4 heads of 256, five local layers of window 1,024 to a
              global one, vocab 262,144; 4,550,996,480 parameters in
              bfloat16 from a torch.Generator seeded 1; granite's weights
              are freed first) prefills the same two 4,096-token prompts
              shape (numpy.random.default_rng(14)): flash_attention at hd
              256 must launch once per layer, the last-token logits must
              be finite, and the kernel is held against the plain version
              on layer 0's (local) and layer 5's (global) q/k/v.

Phases 3-6, 8 and 9 (not 5b) also re-run their path under the profiler
and report the card's idle share against the unprofiled wall time (where
the profiler drops a long graph run's records, the events' span stands
in).  Phases 5b, mesh, pmesh, raytrace, 8, admission, runtime and 9 run
before phase 7, whose line needs their launch counts.  Every phase
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
SMEM_LATENCY_CYCLES = 30     # shared-memory load, Luo et al. 2024 (Hopper)
L2_LATENCY_CYCLES = 260      # L2 hit, the same microbenchmarks
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
# the heap_sssp and fifo_fanout goldens of the JAX package's tests
# (tests/test_enginecore.py); host_syncs is the fused engine's
HEAP_GOLDEN = {"stats": [10, 124, 122, 46, 1], "acc": "17210d10068cbe8b",
               "planes": "3e13f886f2e96c70", "host_syncs": 1}
FIFO_GOLDEN = {"stats": [7, 63, 62, 32, 1], "acc": "b8d77df0675e0603",
               "planes": "1a0afe86d6513a2a", "head_tail": [575, 575],
               "host_syncs": 1}
# the goldens' trace and span digests (Telemetry(capacity=256),
# Spans(classes=1, buckets=8)) and the obs phase's plane sizes: road's
# 5,119 rounds fit the trace plane, the heap tree's 1,816 too
OBS_GOLDEN = {"fifo": {"tel": "cb3aae309ae1f69f", "spans": "b5f891af2ff7334a"},
              "heap": {"tel": "ef6805304552b52a", "spans": "bbf1586fce097a87"}}
# the mesh goldens of the JAX package's tests (tests/test_enginecore.py:
# GOLDEN["mesh_fanout"], GOLDEN["mesh_bfs"], GOLDEN_2SHARD), stats with
# host_syncs last
MESH_GOLDEN = {
    "mesh_fanout": {"shards": 1, "stats": [7, 63, 62, 32, 1, 1],
                    "acc": "b8d77df0675e0603", "planes": "1a0afe86d6513a2a",
                    "head_tail": [575, 575], "tel": "cb3aae309ae1f69f"},
    "mesh_fanout_2": {"shards": 2, "stats": [6, 63, 62, 32, 1, 1],
                      "acc": "b8d77df0675e0603",
                      "planes": "1a0afe86d6513a2a",
                      "head_tail": [575, 575], "tel": "01bcb5be848e8028"},
    "mesh_bfs": {"shards": 1, "stats": [23, 144, 143, 12, 1, 1],
                 "dist": "c8795c4f65942e14"},
    "mesh_bfs_2": {"shards": 2, "stats": [23, 287, 286, 24, 1, 1],
                   "dist": "c8795c4f65942e14"}}
# the priority mesh goldens (tests/test_enginecore.py: GOLDEN["pmesh_*"],
# GOLDEN_2SHARD["pmesh_*_2"]), stats with host_syncs last
PMESH_GOLDEN = {
    "pmesh_relaxed": {"shards": 1, "relaxed": True,
                      "stats": [19, 260, 258, 128, 1, 1],
                      "acc": "cd729cf83f33eed5",
                      "planes": "c5830eb454bd1761", "tel": "c24a2c5171ec130e"},
    "pmesh_strict": {"shards": 1, "relaxed": False,
                     "stats": [19, 260, 258, 128, 1, 1],
                     "acc": "cd729cf83f33eed5",
                     "planes": "c5830eb454bd1761", "tel": "c24a2c5171ec130e"},
    "pmesh_relaxed_2": {"shards": 2, "relaxed": True,
                        "stats": [12, 260, 258, 88, 1, 1],
                        "acc": "cd729cf83f33eed5",
                        "planes": "c822643452639513",
                        "tel": "bd8f8645639ba8bc"},
    "pmesh_strict_2": {"shards": 2, "relaxed": False,
                       "stats": [12, 260, 258, 110, 1, 1],
                       "acc": "cd729cf83f33eed5",
                       "planes": "c5830eb454bd1761",
                       "tel": "2455cb0b0971fae9"}}
SSSP_SIDE = 1024         # road 1024^2: 1,048,576 vertices (USA-road-d.FLA)
SSSP_MAX_W = 8
SSSP_DELTA = 4
SSSP_STRICT_CAP_LOG2 = 22  # the strict run's one heap: 4 n slots
MESH_SHARDS = 4
MESH_ROAD_SIDE = 215     # the largest square grid with n (n + 2) < 2^31
MESH_TREE_SEEDS = 65536
MESH_TREE_DEPTH = 14     # children only below this depth
MESH_TREE_SPAWN = 10     # a child is offered with probability 10/16
MESH_TREE_CAP_LOG2 = 22
# phase raytrace: the paper's Fig. 7 scenes at 1920 x 1080 on the ring
# engine (capacity_log2 21: the 2,073,600 pixel ids fit 2^21 slots), and
# fused against legacy at 256 x 256
RAY_W, RAY_H, RAY_BATCH = 1920, 1080, 65536
RAY_SMALL, RAY_SMALL_BATCH = 256, 256
RAY_TOL = 1e-5
# phase admission: the serving goldens of the JAX package's tests
# (tests/test_enginecore.py: GOLDEN["serving"], GOLDEN_2SHARD["serving_2"])
SERVING_GOLDEN = {
    "serving": {"shards": 1, "stats": [4, 20, 12, 6, 1, 4], "ticks": 4,
                "admitted": [1, 3, 7, 2, 6, 5, 4, 0],
                "planes": "d70650fb443f714a", "hist": "256ab85ea28951cc",
                "tel": "55a5a0cd9cee8fb0"},
    "serving_2": {"shards": 2, "stats": [4, 20, 12, 6, 1, 4], "ticks": 4,
                  "admitted": [2, 1, 7, 3, 6, 4, 5, 0],
                  "planes": "6ddad96eb514c320", "hist": "385db6ed17cface3",
                  "tel": "12c1f9a6ce0747a2"}}
# and a backlogged server's tick stream: 48 requests a tick with bursts,
# 40 slots and 4,096 pages of 16 tokens a tick, heaps of 2^16 a shard
ADM_TRAFFIC = dict(ticks=1000, rate=48, burst_period=32, burst_max=1024,
                   tenants=4, urgent_frac=0.25, prompt_len=(128, 2048),
                   max_new_tokens=(32, 512), seed=5)
ADM_CAP_LOG2, ADM_BATCH, ADM_TABLE_LOG2 = 16, 256, 16
ADM_SLOTS, ADM_PAGES, ADM_PAGE_SIZE, ADM_SLACK = 40, 4096, 16, 64
ADM_DRAIN_SLOTS, ADM_DRAIN_PAGES = 4096, 1 << 30
ADM_PROFILED_TICKS = 50
# phase runtime: (a) mesh_task_round on a replicated ring of 2^20 slots
# (logical capacity 2^19) whose tickets start 2^20 below 2^32 (the nearest
# multiple of the ring's 2n), so head and tail wrap, draining the FIFO task
# tree from 16,384 seeds (1,792,495 pops, at most about 372,000 queued) at
# 4 shards x 1,024 claims, its first 64 rounds against the plain waves;
# (b) render_runtime on the Fig. 7 scenes at 1920 x 1080 and cornell at
# 256^2 on each algorithm; (c) bfs_runtime on kron 4,096; (d) granite's
# serve with admission="lanes", requests 6 and 7 urgent
RT_RING_CAP = 1 << 19
RT_START = 2 ** 32 - 2 ** 20
RT_SEEDS = 16384
RT_COMPARE_ROUNDS = 64
RT_TILES, RT_WORKERS, RT_WAVE = 4, 32, 4096
RT_KRON_N, RT_KRON_DEG = 4096, 6
RT_URGENT = (6, 7)
OBS_ROAD_CAPACITY = 8192
OBS_HEAP_CAPACITY = 2048
EAGER_CHUNK = 64         # rounds a readback in the eager yardstick
GEMMA_ARCH = "gemma3-4b"
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


def tel_digest(tel):
    """The goldens' digest of a Telemetry's records
    (tests/test_enginecore.py: _tel_digest)."""
    rows = [(r.round, r.imbalance, r.min_key, r.max_key, int(r.overflow),
             tuple(r.pops), tuple(r.pushes), tuple(r.occupancy))
            for r in tel.records]
    return hashlib.sha256(repr(rows).encode()).hexdigest()[:16]


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


def heap_tree_step(torch):
    """The priority task tree's step: pops counted by val % 4096, children
    by ``tree_children``."""
    def step(acc, keys, vals, valid):
        acc = acc.index_add(0, torch.where(valid, vals % 4096, 0),
                            valid.int())
        ck, cv, cm = tree_children(
            keys.long(), vals.long(),
            lambda n: torch.arange(n, device=keys.device), valid)
        return acc, ck.int(), cv.int(), cm
    return step


def fifo_tree_step(torch):
    """The FIFO task tree's step: pops counted by val % 4096; each pop
    offers children c = 0, 1 with h = ``tree_hash(val, c)``, child val
    ``((h >> 1) & 0x7FFFFFF0) | (depth + 1)`` (the depth in the low 4
    bits), spawned iff depth < 14 and (h & 15) < 10."""
    def step(acc, vals, valid):
        acc = acc.index_add(0, torch.where(valid, vals % 4096, 0),
                            valid.int())
        v = vals.long()
        h = tree_hash(v[:, None], torch.arange(2, device=vals.device)[None])
        depth = (v & 15)[:, None]
        cv = ((h >> 1) & 0x7FFFFFF0) | (depth + 1)
        cm = (valid[:, None] & (depth < MESH_TREE_DEPTH)
              & ((h & 15) < MESH_TREE_SPAWN))
        return acc, cv.int(), cm
    return step


def fifo_closure(np, vals):
    """Every item the FIFO tree holds, generation by generation: (pops
    per val % 4096, processed, spawned, the largest payload)."""
    acc = np.zeros(4096, np.int64)
    v = vals.astype(np.int64)
    processed, top = 0, 0
    while len(v):
        processed += len(v)
        top = max(top, int(v.max()))
        acc += np.bincount(v % 4096, minlength=4096)
        h = tree_hash(v[:, None], np.arange(2)[None, :])
        depth = (v & 15)[:, None]
        cv = ((h >> 1) & 0x7FFFFFF0) | (depth + 1)
        v = cv[(depth < MESH_TREE_DEPTH) & ((h & 15) < MESH_TREE_SPAWN)]
    return acc, processed, processed - len(vals), top


def golden_tree_step(torch):
    """The goldens' fifo_fanout step (tests/test_enginecore.py:
    _tree_step)."""
    def step(acc, vals, valid):
        acc = acc.index_add(0, torch.where(valid, vals, 0), valid.int())
        cv = torch.stack([vals * 2, vals * 2 + 1], -1).int()
        return acc, cv, (valid & (vals < 32))[:, None]
    return step


# CUgraphNodeType of the CUDA driver API (cuda.h)
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    4: "graph", 5: "empty", 6: "wait_event",
                    7: "event_record", 10: "mem_alloc", 11: "mem_free",
                    13: "conditional"}


def graph_nodes(engine) -> dict:
    """The nodes of the round an engine's device loop captured (its one
    ``DeviceLoop``'s graph, before the WHILE node wraps it), read with the
    driver's ``cuGraphGetNodes``: the total, the count by node type and
    the kernel nodes by kernel name (the first 100 characters)."""
    import ctypes
    (_, loop), = engine._loops.values()
    cu = ctypes.CDLL("libcuda.so.1")
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    cu.cuGraphGetNodes.argtypes = [vp, vp, ctypes.POINTER(sz)]
    cu.cuGraphNodeGetType.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphKernelNodeGetParams_v2.argtypes = [vp, vp]
    cu.cuFuncGetName.argtypes = [ctypes.POINTER(ctypes.c_char_p), vp]
    graph = vp(loop.graph.raw_cuda_graph())
    n = sz(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (vp * n.value)()
    if cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    by_type, kernels = {}, {}
    for node in nodes:
        t = ctypes.c_int()
        if cu.cuGraphNodeGetType(vp(node), ctypes.byref(t)):
            raise RuntimeError("cuGraphNodeGetType failed")
        name = GRAPH_NODE_TYPES.get(t.value, str(t.value))
        by_type[name] = by_type.get(name, 0) + 1
        if t.value != 0:
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: the CUfunction is its first word
        params = (ctypes.c_uint64 * 16)()
        fname = ctypes.c_char_p()
        if (cu.cuGraphKernelNodeGetParams_v2(vp(node), params)
                or not params[0]
                or cu.cuFuncGetName(ctypes.byref(fname), vp(params[0]))):
            key = "(name not read)"
        else:
            key = fname.value.decode()[:100]
        kernels[key] = kernels.get(key, 0) + 1
    return {"nodes": n.value, "by_type": by_type, "kernels": kernels}


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
                         "queue": {}, "prefill": {}, "serve": {},
                         "prefill_gemma3": {}, "obs_road": {},
                         "obs_heap": {},
                         "mesh": {}, "pmesh": {}, "ray": {},
                         "admission": {}, "runtime": {}}  # path -> launches
        self.keep = {}            # path -> (runner, final state) for obs

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
        """Every case as ten calls queued back to back on one scratch,
        with no synchronise between them: waves of one block (1,024 lanes,
        road's 4,096-lane child wave, a whole 8,192-lane tile) and of many
        tiles ranked by look-back (1.26 M lanes and 2^22), bool and int32
        masks, counters that wrap past 2^31 and 2^32."""
        np, torch = self.np, self.torch
        for n in (1024, 4096, 8192, 1230 * 1024, 1 << 22):
            scratch = K.wavefaa_scratch(n, self.dev)
            for dens in (0.0, 0.18, 1.0):
                a = self.rng.random(n) < dens
                for dtype in (torch.bool, torch.int32):
                    for c0 in (2 << 23, 2 ** 31 - 5, 2 ** 32 - 5):
                        m = self.t(a, dtype)
                        c = self.t(np.array([i32(c0)], np.int32))
                        got = [K.wavefaa(m, c, scratch=scratch)
                               for _ in range(10)]
                        want = K.wavefaa_plain(m, c)
                        for g in got:
                            self.same("wavefaa", g, want)
            if int(scratch.abs().sum()):
                raise AssertionError("wavefaa: the kernel left its scratch "
                                     "dirty")

    def compare_compact(self, K, kron_lanes):
        """Every case as ten calls queued back to back on one stream and
        one scratch, with no synchronise between them, each held against
        the plain version: a look-back status word or ticket counter left
        stale by one call would break the next.  Waves of one tile, ragged
        tails, the kron wave, 2^22 lanes (512 tiles) and 2^22 - 77."""
        torch = self.torch
        for n in (256, 1024, 2500, 70000, kron_lanes, 1 << 22,
                  (1 << 22) - 77):
            scratch = K.compact_scratch(n, self.dev)
            for dens in (0.0, 0.003, 0.3, 1.0):
                m = self.t(self.rng.random(n) < dens)
                for k in (1, 2):
                    planes = tuple(
                        self.t(self.rng.integers(1, 1 << 20, n), torch.int32)
                        for _ in range(k))
                    for width in (max(n // 8, 8), n, 1 << 17):
                        got = [K.wave_compact(m, planes, width=width,
                                              scratch=scratch)
                               for _ in range(10)]
                        d2, c2 = K.compact_planes(m, planes, width=width)
                        for d1, c1 in got:
                            self.same("wave_compact", (*d1, c1), (*d2, c2))
            if int(scratch.abs().sum()):
                raise AssertionError("wave_compact: the kernel left its "
                                     "scratch dirty")

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

    def compare_ring_waves(self, K):
        """The round's two wave kernels on the single ring (one shard)
        against their plain versions, each case at least ten calls queued
        back to back: road's shape (2^24
        slots, batch 1,024, a 4,096-lane ballot at road's density), kron's
        dense mode (2^18 slots, a 2^17-lane compacted wave, counts up to
        and past the free space), batches above 1,024 (3,000 and 8,192:
        the head hazard) with a three-tile ballot of 20,000 lanes, counters
        that wrap past 2^31 and 2^32, a small ring that overflows, empty
        and full masks, k = 0, 1, below and at the batch, and live=False
        calls in every case."""
        np, torch = self.np, self.torch

        def vals(n):
            return self.t(self.rng.integers(0, 1 << 30, n), torch.int32)

        def ballot(n, dens, live=True):
            return ("enq", vals(n), live,
                    self.t(self.rng.random(n) < dens), None)

        def dense(width, count, live=True):
            return ("enq", vals(width).reshape(1, width), live, None,
                    torch.tensor([count], dtype=torch.int32,
                                 device=self.dev))

        def rounds(batch, lanes, dens, n, mode="ballot", counts=None):
            calls = []
            for r in range(n):
                live = r % 4 != 3
                calls.append(("deq", batch, live))
                if mode == "ballot":
                    calls.append(ballot(lanes, dens[r % len(dens)], live))
                else:
                    calls.append(dense(lanes, counts[r % len(counts)], live))
            return calls

        road_dens = (0.2, 0.0, 1.0, 0.25)
        cases = [
            # road: 2^24 slots, batch 1,024, 4,096-lane ballots; k = 0 on
            # the empty ring first, then 1, then below and at the batch
            (24, 1 << 24, [("deq", BATCH, True), dense(1, 1),
                           ("deq", BATCH, True), dense(4096, 700)]
             + rounds(BATCH, 4 * BATCH, road_dens, 10)),
            # kron: dense waves of the 2^17 capacity, one past the space
            (18, 1 << 18, [dense(1 << 17, 5000)]
             + rounds(BATCH, 1 << 17, None, 10, "dense",
                      [900, 0, 20000, 130000, 4000])),
            # batches past one block's 1,024 lanes, a three-tile ballot
            (16, 1 << 16, [dense(1 << 15, 12000)]
             + rounds(3000, 20000, (0.3, 1.0, 0.05), 6)
             + rounds(8192, 1 << 15, None, 4, "dense", [9000, 30000])),
            # counters that wrap past 2^31 and 2^32
            (12, 2 ** 31 - 3000, rounds(512, 2048, (0.25, 0.3, 0.2), 12)),
            (12, 2 ** 32 - 3000, [dense(2048, 1500)]
             + rounds(512, 2048, (0.25, 0.3, 0.2), 12)),
            (12, 2 ** 32 - 3000, rounds(512, 2048, None, 12, "dense",
                                        [400, 700, 1200, 3000])),
            # a 32-slot capacity that overflows
            (6, 1 << 6, rounds(16, 64, (0.8, 0.1, 0.5), 12)),
        ]
        for nsl2, start, calls in cases:
            self.wave_calls(K, nsl2, start, calls)

    def compare_packed_waves(self, K):
        """The wave kernels' packed instances (birth stamps) against their
        plain versions, each case at least ten calls queued back to back:
        road's shape (2^24 slots, batch 1,024, 4,096-lane ballots) and
        kron's dense mode (2^18 slots, 2^17-lane waves) with slots seeded
        by the unpacked enqueue wave (flag 1, birth 0) and consumed by the
        packed dequeue wave, birth rounds 0, 1 and 2^30 - 1 among others,
        counters that wrap past 2^32, an overflowing ring, and live=False
        calls in every case."""
        np, torch = self.np, self.torch
        top = 2 ** 30 - 1

        def vals(n):
            return self.t(self.rng.integers(0, 1 << 30, n), torch.int32)

        def seed(n, count):
            return ("enq", vals(n).reshape(1, n), True, None,
                    torch.tensor([count], dtype=torch.int32,
                                 device=self.dev), None)

        def rounds(batch, lanes, n, births, dens=None, counts=None):
            calls = []
            for r in range(n):
                live = r % 4 != 3
                birth = births[r % len(births)]
                calls.append(("deq", batch, live, True))
                if dens is not None:
                    calls.append(("enq", vals(lanes), live,
                                  self.t(self.rng.random(lanes)
                                         < dens[r % len(dens)]),
                                  None, birth))
                else:
                    calls.append(("enq", vals(lanes).reshape(1, lanes),
                                  live, None,
                                  torch.tensor([counts[r % len(counts)]],
                                               dtype=torch.int32,
                                               device=self.dev), birth))
            return calls

        births = (0, 1, top, 7, 2 ** 20 + 3)
        cases = [
            (24, 1 << 24, [seed(4096, 3000)]
             + rounds(BATCH, 4 * BATCH, 12, births,
                      dens=(0.2, 0.0, 1.0, 0.25))),
            (18, 1 << 18, [seed(1 << 17, 5000)]
             + rounds(BATCH, 1 << 17, 12, births,
                      counts=[900, 0, 20000, 130000, 4000])),
            (12, 2 ** 32 - 3000, [seed(2048, 1500)]
             + rounds(512, 2048, 12, (top, 1, 0), dens=(0.25, 0.3, 0.2))),
            (6, 1 << 6, rounds(16, 64, 12, (top, 0, 5),
                               dens=(0.8, 0.1, 0.5))),
        ]
        for nsl2, start, calls in cases:
            self.wave_calls(K, nsl2, start, calls)

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

    def heap_calls(self, K, state, batches, c, arity):
        """``batches`` applied as calls queued back to back on the card
        (no synchronise between them, the size flowing from call to call
        as a device tensor) and one at a time on the plain version's
        planes; every call's outputs and the planes after the last are
        held against each other.  ``state`` is [kernel planes, plain
        planes, kernel size, plain size], updated."""
        kern, plain, sk, sp = state
        got = []
        for ops, keys, vals in batches:
            out = K.heap_apply(*kern, sk, ops, keys, vals, cap_log2=c,
                               arity_log2=arity)
            sk = out[2]
            got.append(out[2:])
        for (ops, keys, vals), g in zip(batches, got):
            want = K.heap_apply_plain(*plain, sp, ops, keys, vals,
                                      cap_log2=c, arity_log2=arity)
            sp = want[2]
            self.same("heap_apply", g, want[2:])
        self.same("heap_apply", kern, plain)
        state[2:] = [sk, sp]

    def heap_rider_calls(self, K, state, batches, c, arity):
        """``heap_calls`` for the rider instance: ``batches`` of (ops,
        keys, vals, oprider) where oprider is a 0-d device tensor (the
        round clock, as the priority round passes it) or one per lane;
        ``state`` is [kernel planes (keys, vals, rider), plain planes,
        kernel size, plain size].  Every call's outputs (size, popped keys,
        vals and riders, ok) and the three planes after the last are held
        against each other."""
        kern, plain, sk, sp = state
        got = []
        for ops, keys, vals, opr in batches:
            out = K.heap_apply(*kern[:2], sk, ops, keys, vals, cap_log2=c,
                               arity_log2=arity, rider=kern[2], oprider=opr)
            sk = out[2]
            got.append(out[2:6] + out[7:])
        for (ops, keys, vals, opr), g in zip(batches, got):
            want = K.heap_apply_plain(*plain[:2], sp, ops, keys, vals,
                                      cap_log2=c, arity_log2=arity,
                                      rider=plain[2], oprider=opr)
            sp = want[2]
            self.same("heap_apply_rider", g, want[2:6] + want[7:])
        self.same("heap_apply_rider", kern, plain)
        state[2:] = [sk, sp]

    def compare_heap_rider(self, K):
        """The rider instance of ``heap_apply`` against its plain version
        at arities 2, 4 and 8, ten calls per case queued back to back, the
        inserts' rider a 0-d device tensor (or one per lane): at 2^6 slots
        batches that fill the heap past full and drain it past empty; at
        2^15 slots heaps seeded just below, at and just above the rider
        instance's shared-memory top (R_MAX_RIDER nodes: one level fewer
        than the rider-less top at arities 2 and 4) with pops and inserts
        whose paths cross it; at 2^20 slots the priority path's batches."""
        torch = self.torch
        card = dict(dtype=torch.int32, device=self.dev)
        clocks = [torch.tensor(v, **card) for v in (0, 1, 2 ** 30 - 1, 77)]

        def rid(batch, i, vector=False):
            ops, keys, vals = batch
            opr = (self.t(self.rng.integers(0, 1 << 20, ops.shape[0]),
                          torch.int32) if vector
                   else clocks[i % len(clocks)])
            return (ops, keys, vals, opr)

        for arity in (1, 2, 3):
            def fresh(c):
                kern = [torch.full((1 << c,), KEY_INF, **card),
                        torch.full((1 << c,), -1, **card),
                        torch.zeros((1 << c,), **card)]
                return [kern, [p.clone() for p in kern],
                        torch.zeros((), **card), torch.zeros((), **card)]
            st = fresh(6)
            batches = [rid(self.heap_batch(16, share), i, i % 5 == 4)
                       for i, share in enumerate([0.9] * 10 + [0.1] * 10
                                                 + [0.5] * 4)]
            for i in range(0, len(batches), 10):
                self.heap_rider_calls(K, st, batches[i:i + 10], 6, arity)
            r_max = K.heap_resident_max(arity, rider=True)
            for seed in (r_max - 3, r_max, r_max + 5):
                st = fresh(15)
                self.heap_rider_calls(
                    K, st, [rid(self.heap_batch(seed, 1.0, 0, 60), 3)],
                    15, arity)
                self.heap_rider_calls(
                    K, st, [rid(self.pop_batch(64), i) for i in range(10)],
                    15, arity)
                self.heap_rider_calls(
                    K, st, [rid(self.heap_batch(5000, 1.0, -90, -30), 1)]
                    + [rid(self.pop_batch(3000), 0)]
                    + [rid(self.heap_batch(2048, 0.6, -40, 60), i)
                       for i in range(8)], 15, arity)
            st = fresh(HEAP_CAP_LOG2)
            batches = [rid(self.heap_batch(1 << 17, 1.0, 0, 16), 0)]
            for i in range(3):
                batches += [rid(self.pop_batch(BATCH), i),
                            rid(self.heap_batch(2 * BATCH, 0.6, 0, 30), i)]
            self.heap_rider_calls(K, st, batches + batches[1:3],
                                  HEAP_CAP_LOG2, arity)

    def grid_calls(self, K, state, waves, c, arity):
        """``waves`` (dicts of ``heap_apply_grid``'s wave arguments) applied
        as calls queued back to back on the card (no synchronise between
        them, the sizes updated in place) and one at a time by
        ``heap_apply_grid_plain`` on the plain version's planes; every
        call's outputs and sizes and the planes after the last are held
        against each other.  ``state`` is [kernel planes (keys, vals,
        rider or None), plain planes, kernel sizes, plain sizes]."""
        kern, plain, sk, sp = state
        name = "heap_apply_grid" + ("" if kern[2] is None else "_rider")
        kw = dict(cap_log2=c, arity_log2=arity)
        got = []
        for w in waves:
            out = K.heap_apply_grid(*kern[:2], sk, rider=kern[2], **w, **kw)
            got.append((sk.clone(),) + (out[3:6] + out[7:]
                                        if "counts" in w else ()))
        for w, g in zip(waves, got):
            out = K.heap_apply_grid_plain(*plain[:2], sp, rider=plain[2],
                                          **w, **kw)
            self.same(name, g, (sp,) + (out[3:6] + out[7:]
                                        if "counts" in w else ()))
        self.same(name, [p for p in kern if p is not None],
                  [p for p in plain if p is not None])

    def compare_heap_grid(self, K):
        """``heap_apply_grid`` (B4 over a shard grid: a pop wave of
        ``counts[s]`` DELETE-MINs on heap s, or one gathered insert wave
        whose lane i goes to heap ``dest[i]``) against
        ``heap_apply_grid_plain``, bit for bit: S = 1, 2, 4 and 8, arities
        2, 4 and 8, both modes, with and without a rider (the inserts'
        rider a 0-d device word or one per lane), ten calls per case
        queued back to back.  At 2^6 slots: heaps filled from empty past
        capacity (inserts rejected when full), one shard installing
        nothing, duplicate and KEY_INF keys, -1 destinations, pop counts of
        0 and past a heap's size, heaps driven to just below and exactly
        at capacity.  At 2^15 slots (S = 8) heaps seeded across the
        kernel's shared-memory top.  At 2^20 slots the priority mesh
        tree's waves (4 x 1,024 pops, 8,192 insert lanes) and SSSP's
        (16,384 insert lanes, a rider); the strict paths' one heap (S = 1):
        4,096-pop waves and 8,192-lane inserts at 2^20, 16,384-lane
        inserts with a rider at SSSP's 2^22.  Arities past 8 are
        refused."""
        np, torch = self.np, self.torch
        card = dict(dtype=torch.int32, device=self.dev)

        def fresh(s, c, rider):
            kern = [torch.full((s, 1 << c), KEY_INF, **card),
                    torch.full((s, 1 << c), -1, **card),
                    torch.zeros((s, 1 << c), **card) if rider else None]
            return [kern, [None if p is None else p.clone() for p in kern],
                    torch.zeros(s, **card), torch.zeros(s, **card)]

        def ins(s, n, lo=-20, hi=40, skip=None, rider=False, i=0):
            _, keys, vals = self.heap_batch(n, 1.0, lo, hi)
            dest = self.rng.integers(-1, s, n)
            if skip is not None:
                dest = np.where(dest == skip, -1, dest)
            w = dict(opkeys=keys, opvals=vals,
                     dest=self.t(dest.astype(np.int32)))
            if rider:
                w["oprider"] = (self.t(self.rng.integers(0, 1 << 20, n),
                                       torch.int32) if i % 2
                                else torch.tensor(i, **card))
            return w

        def to(s, counts):
            return dict(opkeys=self.t(self.rng.integers(-9, 9, len(counts))
                                      .astype(np.int32)),
                        opvals=self.t(np.arange(len(counts), dtype=np.int32)),
                        dest=self.t(np.asarray(counts, np.int32)))

        def pop(s, b, counts):
            return dict(counts=self.t(np.asarray(counts, np.int32)), batch=b)

        # other arities are refused by name on the card
        st = fresh(2, 6, False)
        try:
            K.heap_apply_grid(*st[0][:2], st[2], counts=st[2], batch=4,
                              cap_log2=6, arity_log2=4)
            raise AssertionError("heap_apply_grid ran at arity_log2=4")
        except ValueError as e:
            if "built for arity_log2" not in str(e):
                raise
        for arity in (1, 2, 3):
            for rider in (False, True):
                for s in (1, 2, 4, 8):
                    st = fresh(s, 6, rider)
                    waves = [ins(s, 24 * s, skip=0 if i == 3 else None,
                                 rider=rider, i=i) for i in range(10)]
                    self.grid_calls(K, st, waves, 6, arity)
                    self.grid_calls(K, st, [pop(s, 40, self.rng.integers(
                        0, 70, s)) for _ in range(8)]
                        + [pop(s, 8, [0] * s), pop(s, 64, [99] * s)],
                        6, arity)
                    # just below and at capacity: 63 nodes on every heap,
                    # then one more, then one past
                    st = fresh(s, 6, rider)
                    fill = [d for d in range(s) for _ in range(63)]
                    self.grid_calls(K, st, [to(s, fill), to(s, range(s)),
                                            to(s, range(s))]
                                    + [pop(s, 16, [1] * s), to(s, [0] * 3)]
                                    + [pop(s, 64, self.rng.integers(
                                        0, 64, s)) for _ in range(5)],
                                    6, arity)
                r_max = K.heap_resident_max(arity, rider=rider)
                st = fresh(8, 15, rider)
                seeds = [d for d in range(8)
                         for _ in range(r_max + (d - 4) * 3)]
                self.rng.shuffle(seeds)
                self.grid_calls(K, st, [to(8, seeds)] + [
                    pop(8, 512, self.rng.integers(0, 600, 8))
                    if i % 2 else ins(8, 4096, -90, 60, rider=rider, i=i)
                    for i in range(10)], 15, arity)
                # the paths' shapes: 4 heaps of 2^20
                st = fresh(4, HEAP_CAP_LOG2, rider)
                lanes = (4 if rider else 2) * 4 * BATCH
                self.grid_calls(K, st, [ins(4, 1 << 17, 0, 16, rider=rider)]
                                + [pop(4, BATCH, [BATCH] * 4)
                                   if i % 2 else
                                   ins(4, lanes, 0, 30, rider=rider, i=i)
                                   for i in range(10)],
                                HEAP_CAP_LOG2, arity)
                # the strict paths' one heap: the tree's 4,096-pop waves
                # (four staging chunks a call, full and cut mid-chunk) and
                # 8,192-lane inserts at 2^20 slots, and with a rider
                # SSSP's 16,384-lane inserts at its 2^22 slots
                wide = MESH_SHARDS * BATCH
                shapes = [(HEAP_CAP_LOG2, 2 * wide)]
                if rider:
                    shapes.append((SSSP_STRICT_CAP_LOG2, 4 * wide))
                for c, lanes in shapes:
                    st = fresh(1, c, rider)
                    self.grid_calls(K, st, [ins(1, 1 << 18, 0, 16,
                                                rider=rider)]
                                    + [pop(1, wide, [wide if i % 4 == 1 else
                                                     self.rng.integers(
                                                         BATCH, wide)])
                                       if i % 2 else
                                       ins(1, lanes, 0, 30, rider=rider, i=i)
                                       for i in range(10)], c, arity)

    def compare_obs_record(self, K):
        """``obs_record`` (the round's trace row and span update in one
        launch) against ``obs_record_plain`` on the same planes, ten calls
        per case queued back to back and every plane held against the
        plain one's after each call: road's shape (1,024 lanes, a trace
        plane of 8,192 and spans of 16 buckets), the goldens' (16 lanes,
        8 buckets), a trace plane and a flow ring that wrap, 3,000 lanes
        (more than one block's threads), class rows from a ``cls`` out of
        range both ways, each plane alone, waves with no claims, births
        from round 0 and near the 2^30 clock cap."""
        np, torch = self.np, self.torch
        from repro_torch.obs import (obs_record, obs_record_plain,
                                     span_init, trace_init)
        card = dict(dtype=torch.int32, device=self.dev)
        for b, cap, k, nb, f, trace, spans, cls, clock0 in (
                (BATCH, OBS_ROAD_CAPACITY, 1, 16, 64, True, True, False, 0),
                (16, 256, 1, 8, 64, True, True, False, 5),
                (BATCH, 4, 1, 16, 3, True, True, False, 2 ** 30 - 12),
                (3000, 64, 3, 8, 5, True, True, True, 1000),
                (BATCH, 64, 1, 16, 64, True, False, False, 0),
                (BATCH, 64, 2, 16, 7, False, True, True, 40)):
            planes = {}
            for face in ("kern", "plain"):
                tp = trace_init(cap, device=self.dev) if trace else None
                sp = (span_init(k, buckets=nb, flow_capacity=f, lanes=b,
                                device=self.dev) if spans else None)
                if sp is not None:
                    sp.round.fill_(clock0)
                planes[face] = (tp, sp)
            waves = []
            for r in range(10):
                rnd = clock0 + r
                n_valid = int(self.rng.integers(0, b + 1)) if r % 4 else 0
                valid = np.arange(b) < n_valid
                if r == 7:
                    valid = self.rng.random(b) < 0.5
                births = np.where(valid, self.rng.integers(
                    max(rnd - 5000, 0), rnd + 1, b), -1)
                waves.append(dict(
                    keys=self.t(self.rng.integers(-2 ** 31, 2 ** 31 - 1, b),
                                torch.int32),
                    valid=self.t(valid),
                    ref=self.t(self.rng.integers(0, 1 << 30, b),
                               torch.int32),
                    births=self.t(births, torch.int32),
                    cls=(self.t(self.rng.integers(-1, k + 1, b),
                                torch.int32) if cls else None),
                    k=torch.tensor(n_valid, **card),
                    total=torch.tensor(int(self.rng.integers(0, 4 * b)),
                                       **card),
                    occ=torch.tensor(int(self.rng.integers(0, 1 << 20)),
                                     **card),
                    over=torch.tensor(r == 6, device=self.dev)))
            out = {}
            for face, fn in (("kern", obs_record), ("plain",
                                                    obs_record_plain)):
                tp, sp = planes[face]
                out[face] = []
                for w in waves:
                    fn(tp, sp, **w)
                    out[face].append([x.clone() for p in (tp, sp)
                                      if p is not None for x in p])
            for got, want in zip(out["kern"], out["plain"]):
                self.same("obs_record", got, want)

    def compare_ring_masked(self, K):
        """The standalone waves' masked instance (``ring_enqueue`` /
        ``ring_dequeue`` with ``active``, the functional faces' kernel)
        against the plain versions, ten or more calls per case queued back
        to back: live tickets 2^31 - 64 ... 2^31 + 64 and 2^32 - 64 ...
        2^32 + 64 installed and consumed in full (the sign rule would drop
        the half past 2^31), then random waves over those boundaries
        whose inactive lanes carry tickets of either sign, and on the mesh
        tree's 2^23-slot ring; ten or more calls a case.  ``enq_planes`` /
        ``deq_planes`` on the card (copies, the masked kernel) against the
        same faces on copies of the planes on the host."""
        np, torch = self.np, self.torch
        for nsl2, start, b, rounds, full in (
                (8, 2 ** 31 - 64, 129, 5, True),
                (8, 2 ** 32 - 64, 129, 5, True),
                (6, 2 ** 31 - 64, 24, 12, False),
                (9, 2 ** 32 - 200, 96, 12, False),
                (23, 1 << 23, 4096, 10, False)):
            ns = 1 << nsl2
            cyc0 = i32(((start % 2 ** 32) >> nsl2) - 1)
            kern = [torch.full((ns,), cyc0, dtype=torch.int32,
                               device=self.dev),
                    torch.ones(ns, dtype=torch.int32, device=self.dev),
                    torch.zeros(ns, dtype=torch.int32, device=self.dev),
                    torch.full((ns,), IDX_BOT, dtype=torch.int32,
                               device=self.dev)]
            plain = [p.clone() for p in kern]
            head = tail = start
            kw = dict(nslots_log2=nsl2, idx_bot=IDX_BOT)
            calls = []
            for r in range(rounds):
                act = (np.ones(b, bool) if full
                       else self.rng.random(b) < 0.7)
                t = np.array([i32(tail + i) for i in range(b)], np.int32)
                # inactive lanes: tickets of both signs, never a live one's
                junk = self.rng.integers(-2 ** 31, 2 ** 31 - 1, b)
                t = np.where(act, t, junk).astype(np.int32)
                calls.append(("enq", self.t(t), self.t(self.rng.integers(
                    0, 1 << 30, b), torch.int32), self.t(act),
                    self.t(np.array([i32(head)], np.int32))))
                tail += b
                dact = (np.ones(b, bool) if full
                        else self.rng.random(b) < 0.8)
                d = np.array([i32(head + i) for i in range(b)], np.int32)
                d = np.where(dact, d, self.rng.integers(
                    -2 ** 31, 2 ** 31 - 1, b)).astype(np.int32)
                calls.append(("deq", self.t(d), self.t(dact)))
                head += b
            got = []
            for c in calls:
                if c[0] == "enq":
                    got.append(K.ring_enqueue(*kern, c[1], c[2], c[4],
                                              active=c[3], **kw)[4].clone())
                else:
                    got.append(torch.stack([x.int() for x in K.ring_dequeue(
                        *kern, c[1], active=c[2], **kw)[4:]]))
            for c, g in zip(calls, got):
                if c[0] == "enq":
                    want = K.ring_enqueue_plain(*plain, c[1], c[2], c[4],
                                                active=c[3], **kw)
                    self.same("ring_enqueue_masked", (g,), want[4:])
                else:
                    want = K.ring_dequeue_plain(*plain, c[1], active=c[2],
                                                **kw)
                    self.same("ring_dequeue_masked", (g,), (torch.stack(
                        [x.int() for x in want[4:]]),))
                    if full and not bool(g[1].all()):
                        raise AssertionError(
                            f"ring_dequeue_masked: live tickets from "
                            f"{start} did not all come back")
            self.same("ring_dequeue_masked", kern, plain)
        # the functional faces: card copies against host copies
        ns, start = 1 << 8, 2 ** 32 - 64
        cyc0 = i32(((start % 2 ** 32) >> 8) - 1)
        planes = [torch.full((ns,), cyc0, dtype=torch.int32), torch.ones(
            ns, dtype=torch.int32), torch.zeros(ns, dtype=torch.int32),
            torch.full((ns,), IDX_BOT, dtype=torch.int32)]
        t = torch.tensor([i32(start + i) for i in range(129)],
                         dtype=torch.int32)
        act = torch.as_tensor(self.rng.random(129) < 0.8)
        v = torch.arange(129, dtype=torch.int32)
        kw = dict(nslots_log2=8, idx_bot=IDX_BOT)
        h = torch.tensor(i32(start), dtype=torch.int32)
        card = K.enq_planes(*(p.to(self.dev) for p in planes),
                            t.to(self.dev), v.to(self.dev), h.to(self.dev),
                            active=act.to(self.dev), **kw)
        host = K.enq_planes(*planes, t, v, h, active=act, **kw)
        self.same("ring_enqueue_masked", card,
                  [x.to(self.dev) for x in host])
        card = K.deq_planes(*card[:4], t.to(self.dev),
                            active=act.to(self.dev), **kw)
        host = K.deq_planes(*host[:4], t, active=act, **kw)
        self.same("ring_dequeue_masked", card,
                  [x.to(self.dev) for x in host])
        if not torch.equal(host[5].bool(), act):
            raise AssertionError("deq_planes: the live tickets past 2^32 "
                                 "did not all come back")

    def wave_calls(self, K, nsl2, start, calls, shards=1, sharded=False,
                   fill=0):
        """Rings on the card driven by ``calls``: one ring of 2^nsl2 slots
        (replicated; the single ring at ``shards`` = 1) or ``shards`` of
        2^nsl2 each (``sharded``), head and tail at ``start``, ``fill``
        items (an int, or one count a ring when sharded) installed first
        by the plain enqueue; ("deq", batch, live[, packed]) calls
        ``ring_dequeue_wave`` and ("enq", values, live, mask, counts[,
        birth]) calls ``ring_enqueue_wave`` (ballot mode with a mask,
        dense mode with counts; ``packed`` and a ``birth`` round take the
        packed instances) at a ring's capacity 2^(nsl2 - 1).  The calls
        are queued back to back on the card with no synchronise between
        them, then made one at a time on the plain versions' copy; every
        call's outputs and heads and tails after it, and the planes after
        the last, are held against each other."""
        np, torch = self.np, self.torch
        ns, cap = 1 << nsl2, 1 << (nsl2 - 1)
        i32c = dict(dtype=torch.int32, device=self.dev)
        cyc0 = i32(((start % 2 ** 32) >> nsl2) - 1)
        lead = (shards,) if sharded else ()
        planes = [torch.full(lead + (ns,), cyc0, **i32c),
                  torch.ones(lead + (ns,), **i32c),
                  torch.zeros(lead + (ns,), **i32c),
                  torch.full(lead + (ns,), IDX_BOT, **i32c)]
        heads = torch.full(lead, i32(start), **i32c)
        tails = heads.clone()
        fills = list(fill) if sharded else [fill]
        for r, c in enumerate(fills):
            if not c:
                continue
            rows = [p[r] for p in planes] if sharded else planes
            tk = self.t(np.array([i32(start + i) for i in range(c)],
                                 np.int32))
            K.ring_enqueue_plain(*rows, tk, self.t(self.rng.integers(
                0, 1 << 30, c), torch.int32), heads[r] if sharded else heads,
                nslots_log2=nsl2, idx_bot=IDX_BOT,
                active=torch.ones(c, dtype=torch.bool, device=self.dev))
            if sharded:
                tails[r] += c
            else:
                tails += c
        ring = {"kern": (planes, heads, tails),
                "plain": ([p.clone() for p in planes], heads.clone(),
                          tails.clone())}
        kw = dict(nslots_log2=nsl2, idx_bot=IDX_BOT,
                  shards=None if sharded else shards)
        lives = {b: torch.tensor(b, device=self.dev) for b in (False, True)}
        births = {c[5]: torch.tensor(c[5], **i32c) for c in calls
                  if c[0] == "enq" and len(c) > 5 and c[5] is not None}
        out = {}
        for face, suffix in (("kern", ""), ("plain", "_plain")):
            deq = getattr(K, "ring_dequeue_wave" + suffix)
            enq = getattr(K, "ring_enqueue_wave" + suffix)
            pl, hd, tl = ring[face]
            out[face] = []
            for call in calls:
                live = lives[call[2]]
                if call[0] == "deq":
                    packed = len(call) > 3 and call[3]
                    got = deq(*pl, hd, tl, live, batch=call[1],
                              birth_packed=packed, **kw)
                    name = "ring_dequeue_wave" + (
                        "_sharded" if sharded else "_packed" * packed)
                else:
                    birth = births.get(call[5]) if len(call) > 5 else None
                    got = enq(*pl, hd, tl, call[1], live, capacity=cap,
                              mask=call[3], counts=call[4],
                              birth_round=birth, **kw)
                    name = "ring_enqueue_wave" + (
                        "_sharded" if sharded else
                        "" if birth is None else "_packed")
                out[face].append((name, got + (hd.clone(), tl.clone())))
        for (name, got), (_, want) in zip(out["kern"], out["plain"]):
            self.same(name, got, want)
        self.same(out["kern"][-1][0], ring["kern"][0], ring["plain"][0])

    def compare_grid_waves(self, K):
        """The round's two wave kernels on the mesh's shard grids against
        their plain versions, every case at least ten calls queued back to
        back: the mesh tree's shape (S = 4,
        batch 1,024, 8,192-lane ballots on a 2^23-slot ring, four rings of
        2^21 sharded) and road's (16,384-lane ballots over two tiles), S =
        1, 2, 4 and 8, claims of k = 0, 1, below, at and above S * batch,
        grid-dense publishes, counters that wrap past 2^31 and 2^32, an
        overflowing round in each mode, one ring of the sharded mesh
        overflowing alone, occupancies tied and empty rings, the packed
        instances with birth rounds 0, 1 and 2^30 - 1, and live=False
        calls."""
        np, torch = self.np, self.torch
        i32c = dict(dtype=torch.int32, device=self.dev)

        def vals(n):
            return self.t(self.rng.integers(0, 1 << 30, n), torch.int32)

        def ballot(lanes, dens, live=True, birth=None):
            return ("enq", vals(lanes), live,
                    self.t(self.rng.random(lanes) < dens), None, birth)

        def dense(shards, width, counts, live=True, birth=None):
            return ("enq", vals(shards * width).reshape(shards, width),
                    live, None, torch.tensor(counts, **i32c), birth)

        def rounds(shards, batch, n, dens, count, packed=False):
            calls = []
            for r in range(count):
                live = r % 4 != 3
                birth = (0, 1, 2 ** 30 - 1, 9)[r % 4] if packed else None
                calls.append(("deq", batch, live, packed))
                calls.append(ballot(shards * n, dens[r % len(dens)], live,
                                    birth))
            return calls

        tree_d, road_d = (0.6, 0.55, 0.7), (0.24, 0.3, 0.0, 1.0)
        # replicated: (S, nsl2, start, fill, calls)
        for shards, nsl2, start, fill, calls in (
                (4, 23, 1 << 23, 65536,
                 rounds(4, BATCH, 2 * BATCH, tree_d, 10)),
                (4, 20, 1 << 20, 1, [("deq", BATCH, True)]
                 + rounds(4, BATCH, 4 * BATCH, road_d, 10)),
                (4, 23, 1 << 23, 65536,
                 rounds(4, BATCH, 2 * BATCH, tree_d, 10, packed=True)),
                (1, 10, 1 << 10, 0, [("deq", 16, True), ("deq", 16, True)]
                 + rounds(1, 16, 32, (0.03, 0.5), 10)),
                (2, 10, 1 << 10, 5, [("deq", 16, True)]
                 + rounds(2, 16, 32, (0.3, 0.5, 0.9), 10)),
                (8, 12, 1 << 12, 128, [("deq", 16, True)]
                 + rounds(8, 16, 64, (0.2, 0.13), 10)
                 + [dense(8, 64, [3, 0, 64, 9, 1, 0, 0, 40])]),
                (4, 12, 2 ** 31 - 3000, 700,
                 rounds(4, 64, 128, (0.25, 0.3), 12)),
                (4, 12, 2 ** 32 - 3000, 700,
                 rounds(4, 64, 128, (0.25, 0.3), 12, packed=True)),
                (4, 12, 2 ** 32 - 3000, 0,
                 [dense(4, 256, [200, 0, 256, 31])] + [
                     c for r in range(10) for c in (
                         ("deq", 64, r % 4 != 3),
                         dense(4, 256, [int(x) for x in self.rng.integers(
                             0, 300, 4)], r % 4 != 3))]),
                # a 64-slot ring that overflows, and dense overflow
                (2, 7, 1 << 7, 60, rounds(2, 8, 32, (0.8, 0.1, 0.5), 12)
                 + [dense(2, 40, [40, 39])])):
            self.wave_calls(K, nsl2, start, calls, shards, False, fill)
        # sharded: (S, nsl2 of a ring, start, fills, calls)
        for shards, nsl2, start, fill, calls in (
                (4, 21, 1 << 21, [16384] * 4,
                 rounds(4, BATCH, 2 * BATCH, tree_d, 10)),
                (4, 18, 1 << 18, [1, 0, 0, 0],
                 rounds(4, BATCH, 4 * BATCH, road_d, 10)),
                (1, 8, 1 << 8, [3], rounds(1, 16, 32, (0.5, 0.2), 10)),
                (2, 8, 1 << 8, [40, 7], rounds(2, 16, 32, (0.4, 0.6), 10)),
                (8, 8, 1 << 8, [5, 5, 0, 9, 9, 1, 0, 5],
                 rounds(8, 4, 16, (0.3, 0.8), 10)
                 + [dense(8, 16, [0, 16, 3, 3, 3, 0, 1, 2])]),
                (4, 8, 2 ** 31 - 300, [10, 20, 30, 40],
                 rounds(4, 16, 32, (0.5, 0.4), 12)),
                (4, 8, 2 ** 32 - 300, [10, 20, 30, 40],
                 rounds(4, 16, 32, (0.5, 0.4), 12)),
                # ring 0 nearly full: it alone overflows a small spray
                (4, 6, 1 << 6, [31, 0, 0, 2],
                 [ballot(4 * 8, 0.2), ("deq", 1, True)]
                 + rounds(4, 1, 8, (0.3, 0.9), 10)),
                (4, 6, 1 << 6, [30, 1, 2, 3],
                 [dense(4, 8, [3, 2, 2, 2]), dense(4, 8, [8, 8, 8, 8])]
                 + [c for r in range(8) for c in (
                     ("deq", 2, r % 4 != 3),
                     dense(4, 8, [int(x) for x in self.rng.integers(
                         0, 9, 4)], r % 4 != 3))])):
            self.wave_calls(K, nsl2, start, calls, shards, True, fill)

    def compare_obs_mesh(self, K):
        """``obs_record`` over S shards (the mesh's record: S x B lanes,
        (S,) pops, pushes and occupancies, a stacked span plane) against
        ``obs_record_plain`` on the same planes, ten calls per case queued
        back to back, every plane held against the plain one's after each
        call: S = 1, 2, 4 and 8, the mesh tree's shape (4 x 1,024 lanes), a
        trace plane and flow rings that wrap, class rows from ``cls``,
        each plane alone, shards with no claims, clocks near the cap."""
        np, torch = self.np, self.torch
        from repro_torch.obs import (obs_record, obs_record_plain,
                                     span_init, trace_init)
        card = dict(dtype=torch.int32, device=self.dev)
        for s, b, cap, nb, f, trace, spans, cls, clock0 in (
                (4, BATCH, 2048, 16, 64, True, True, False, 0),
                (1, 16, 256, 8, 64, True, True, False, 3),
                (2, 16, 256, 8, 64, True, True, False, 5),
                (8, 64, 4, 8, 3, True, True, True, 2 ** 30 - 12),
                (4, 300, 64, 16, 5, True, False, False, 0),
                (8, 128, 64, 16, 7, False, True, True, 40)):
            planes = {}
            for face in ("kern", "plain"):
                tp = trace_init(cap, s, device=self.dev) if trace else None
                sp = None
                if spans:
                    z = span_init(s, buckets=nb, flow_capacity=f, lanes=b,
                                  device=self.dev)
                    sp = type(z)(*(x.expand((s,) + x.shape).clone()
                                   for x in z))
                    sp.round.fill_(clock0)
                planes[face] = (tp, sp)
            waves = []
            for r in range(10):
                rnd = clock0 + r
                counts = self.rng.integers(0, b + 1, s) if r % 4 else \
                    np.zeros(s, np.int64)
                valid = (np.arange(b)[None, :] < counts[:, None]).reshape(-1)
                if r == 7:
                    valid = self.rng.random(s * b) < 0.5
                births = np.where(valid, self.rng.integers(
                    max(rnd - 5000, 0), rnd + 1, s * b), -1)
                shard_ix = np.repeat(np.arange(s), b)
                waves.append(dict(
                    keys=self.t(self.rng.integers(-2 ** 31, 2 ** 31 - 1,
                                                  s * b), torch.int32),
                    valid=self.t(valid),
                    ref=self.t(self.rng.integers(0, 1 << 30, s * b),
                               torch.int32),
                    births=self.t(births, torch.int32),
                    cls=self.t((self.rng.integers(-1, s + 1, s * b) if cls
                                else shard_ix), torch.int32),
                    k=self.t(counts, torch.int32),
                    total=self.t(self.rng.integers(0, 4 * b, s),
                                 torch.int32),
                    occ=self.t(self.rng.integers(0, 1 << 20, s),
                               torch.int32),
                    over=torch.tensor(r == 6, device=self.dev), shards=s))
            out = {}
            for face, fn in (("kern", obs_record),
                             ("plain", obs_record_plain)):
                tp, sp = planes[face]
                out[face] = []
                for w in waves:
                    fn(tp, sp, **w)
                    out[face].append([x.clone() for p in (tp, sp)
                                      if p is not None for x in p])
            for got, want in zip(out["kern"], out["plain"]):
                self.same("obs_record_mesh", got, want)

    def pop_batch(self, b):
        return [self.t(self.np.full(b, x, self.np.int32))
                for x in (1, KEY_INF, -1)]

    def compare_heap(self, K):
        """Heap cases on both faces from the same state, ten calls per
        case queued back to back.  At 2^4 and 2^6 slots: batches that fill
        the heap past full and drain it past empty.  At 2^15 slots, above
        the kernel's shared-memory top (R_MAX nodes, whole levels): heaps
        seeded just below, at and just above R_MAX; pop batches whose last
        leaves lie in the kernel's tail window and ones (3,000 pops) that
        run past it; insert batches of 5,000 keys below every key held,
        whose holes start past the window and rise into the top; mixed
        batches with NOP lanes; a batch that fills the heap and one that
        empties it.  At 2^20 slots: a 131,072-insert seed and the priority
        path's batches (1,024 pops, then 2,048 insert lanes)."""
        np, torch = self.np, self.torch
        card = dict(dtype=torch.int32, device=self.dev)
        for arity in (1, 2, 3):
            def fresh(c):
                kern = [torch.full((1 << c,), KEY_INF, **card),
                        torch.full((1 << c,), -1, **card)]
                return [kern, [p.clone() for p in kern],
                        torch.zeros((), **card), torch.zeros((), **card)]
            for c in (4, 6):
                st = fresh(c)
                nb = 2 * (1 << c) // 16 + 2
                batches = [self.heap_batch(16, share) for share in
                           [0.9] * nb + [0.1] * nb + [0.5] * 4]
                for i in range(0, len(batches), 10):
                    self.heap_calls(K, st, batches[i:i + 10], c, arity)
            r_max = K.heap_resident_max(arity)
            for seed in (r_max - 3, r_max, r_max + 5):
                st = fresh(15)
                self.heap_calls(K, st, [self.heap_batch(seed, 1.0, 0, 60)],
                                15, arity)
                self.heap_calls(K, st, [self.pop_batch(64)] * 10, 15, arity)
                self.heap_calls(
                    K, st, [self.heap_batch(64, 1.0, 0, 60)] * 5
                    + [self.heap_batch(64, 0.5, 0, 60) for _ in range(5)],
                    15, arity)
                self.heap_calls(K, st, [self.heap_batch(5000, 1.0, -90, -30)]
                                + [self.pop_batch(3000)]
                                + [self.heap_batch(2048, 0.6, -40, 60)
                                   for _ in range(8)], 15, arity)
            st = fresh(15)
            self.heap_calls(K, st, [self.heap_batch(35000, 0.99, -5, 200),
                                    self.heap_batch(64, 0.5),
                                    self.pop_batch(35000)]
                            + [self.heap_batch(256, 0.7) for _ in range(7)],
                            15, arity)
            st = fresh(HEAP_CAP_LOG2)
            batches = [self.heap_batch(1 << 17, 1.0, 0, 16)]
            for _ in range(3):
                batches += [self.pop_batch(BATCH),
                            self.heap_batch(2 * BATCH, 0.6, 0, 30)]
            self.heap_calls(K, st, batches + batches[1:3], HEAP_CAP_LOG2,
                            arity)

    def frontier_calls(self, K, rp, col, n, levels, max_out):
        """``levels`` (frontier, visited) as ``frontier_level`` calls queued
        back to back on one scratch and two kept output buffers, used in
        turn as ``bfs_queue`` does, with no synchronise between them; then
        the plain version on its own two buffers.  Every call's next
        frontier, count, visited map and edge count are held against each
        other, and so are the buffers after the last call; the scratch
        must be left as it was, but for the word that keeps the last
        level's edge count (``FrontierState.edges``, word 4 of the state
        after the (n,) plane)."""
        t, torch = self.t, self.torch
        scratch = K.frontier_scratch(n, self.dev,
                                     max_frontier=max(len(f) for f, _ in
                                                      levels))
        before = scratch.clone()
        bufs = [K.frontier_buffer(max_out, self.dev) for _ in range(2)]
        pbufs = [b.clone() for b in bufs]
        got = []
        for i, (f, vis) in enumerate(levels):
            out = K.frontier_level(rp, col, t(f), t(vis.copy()),
                                   max_out=max_out,
                                   scratch=scratch, out=bufs[i % 2])
            got.append(tuple(x.clone() for x in out))
        for i, (f, vis) in enumerate(levels):
            want = K.frontier_level_plain(rp, col, t(f), t(vis.copy()),
                                          max_out=max_out, out=pbufs[i % 2])
            self.same("frontier_expand", got[i], want)
        self.same("frontier_expand", bufs, pbufs)
        edges_word = n + (n & 1) + 4
        before[edges_word] = scratch[edges_word]
        if not torch.equal(scratch, before):
            raise AssertionError("frontier_expand: the kernel left its "
                                 "scratch changed")

    def compare_frontier(self, K, graphs):
        """Synthetic levels (-1 slots inside the frontier, repeated
        frontier vertices, duplicate neighbours, max_out overflow, the CPU
        tests' overflow case, levels with no edges) and real levels of
        each graph in ``graphs`` (name -> (graph, dist)): ten consecutive
        levels from the one with the most edges and from the one with the
        median edge count, the first ten levels, and the busiest
        levels again into a max_out of 1,000 (overflow); on a graph of
        fewer than ten levels every level.  Ten calls (or fewer for a
        case of fewer levels) queued per case."""
        np = self.np
        t = self.t
        self.frontier_calls(
            K, t(np.array([0, 3, 6, 6, 8, 8, 8, 8, 8], np.int32)),
            t(np.array([4, 5, 6, 5, 7, 1, 2, 3], np.int32)), 8,
            [(np.array([0, -1, 1, 3, -1, -1, -1, -1], np.int32),
              np.array([1, 1, 0, 1, 0, 0, 0, 0], np.int32)),
             (np.array([-1, 2, 4, -1], np.int32),       # no edges
              np.array([1, 1, 1, 1, 1, 1, 1, 1], np.int32))] * 5, 3)
        for n, deg, fl in ((64, 5, 12), (5000, 7, 3000), (70000, 3, 40000)):
            col = self.rng.integers(0, n, n * deg).astype(np.int32)
            rp = np.arange(0, n * deg + 1, deg, dtype=np.int32)
            for max_out in (n, 257, 1):
                levels = []
                for _ in range(10):
                    f = self.rng.integers(0, n, fl).astype(np.int32)
                    f[self.rng.random(fl) < 0.25] = -1
                    vis = (self.rng.random(n) < 0.3).astype(np.int32)
                    levels.append((f, vis))
                self.frontier_calls(K, t(rp), t(col), n, levels, max_out)
        for g, dist in graphs.values():
            rp, col = t(g.row_ptr), t(g.col_idx)
            deg = np.diff(g.row_ptr).astype(np.int64)
            reached = dist >= 0
            edges = np.bincount(dist[reached], weights=deg[reached])
            top = int(dist.max())
            busiest = int(np.argmax(edges))
            median = int(np.argsort(edges)[len(edges) // 2])
            for first, cases, max_out in (
                    (busiest, 10, max(g.n, 16)), (median, 10, max(g.n, 16)),
                    (0, top + 1, max(g.n, 16)), (busiest, 3, 1000)):
                lo = max(0, min(first - cases // 2, top + 1 - cases))
                levels = [level_input(np, dist, lvl) for lvl in
                          range(lo, min(lo + min(cases, 10), top + 1))]
                self.frontier_calls(K, rp, col, g.n, levels, max_out)

    def tickets_case(self, K, ids, e, cap, calls=1):
        """``calls`` kernel calls queued back to back (on the kept
        look-back scratch), each held against the plain version."""
        kw = dict(num_experts=e, capacity=cap)
        got = [K.expert_tickets(ids, **kw) for _ in range(calls)]
        want = K.expert_tickets_plain(ids, **kw)
        for g in got:
            self.same("expert_tickets", (g,), (want,))

    def compare_moe(self, K):
        """Expert tickets bit-exact, ten calls back to back per case: N of
        32 (a decode step), 127, 128, 1,000, 1,024 (one tile), 1,025 (the
        first look-back) and 65,536 (a prefill), 8, 40, 64, 128 and 257
        experts, a share of -1 lanes and of ids past E, capacities 0, 1,
        half and past the largest expert count, and all pairs on one
        expert."""
        np, torch = self.np, self.torch
        for n in (32, 127, 128, 1000, 1024, 1025, 65536):
            for e in (8, 40, 64, 128, 257):
                for inactive in (0.0, 0.2):
                    ids = self.rng.integers(0, e, n)
                    ids[self.rng.random(n) < inactive] = -1
                    ids[self.rng.random(n) < inactive / 20] = e + 1
                    top = int(np.bincount(ids[ids >= 0], minlength=e).max()) \
                        if (ids >= 0).any() else 0
                    t = self.t(ids.astype(np.int32))
                    for cap in (0, 1, max(top // 2, 1), top + 5):
                        self.tickets_case(K, t, e, cap, calls=10)
            one = torch.full((n,), 7, dtype=torch.int32, device=self.dev)
            for cap in (0, 1, n // 2, n):
                self.tickets_case(K, one, 40, cap, calls=10)

    def flash_case(self, K, q, k, v, **kw):
        """The kernel against the plain version at the kernel's tiles (in
        place of any blocks the caller's ``kw`` names); returns the plain
        version's output."""
        bq, bk = K.flash_attn.kernel_tiles(q.dtype, q.shape[-1])
        want = K.flash_attention_plain(q, k, v, **{**kw, "bq": bq, "bk": bk})
        self.close("flash_attention", K.flash_attention(q, k, v, **kw), want)
        return want

    def compare_flash(self, K):
        """Flash attention within ``FLASH_TOL``: the four configurations
        of the JAX package's kernel tests (tests/test_kernels.py) in
        float32 and bfloat16, the prefill shape in bfloat16 (also in the
        model's strided layout), a gemma2-style window of 4,096 with
        softcap 50 at S = 8,192, Sq < Sk, hd 80 (h2o-danube-1.8b), hd 128
        causal at S = 4,096, and Sk not a multiple of the key tile.  Then
        two wrong results, which the check must reject."""
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
        # hd 128, causal, GQA 32/8 at S = 4,096 (the wgmma kernel's other
        # width); Sk not a multiple of the 128-key tile, causal with Sq <
        # Sk at hd 64 and with softcap at hd 128
        self.flash_case(K, *qkv(1, 32, 8, 4096, 4096, 128, torch.bfloat16,
                                15))
        self.flash_case(K, *qkv(1, 8, 2, 1024, 1100, 64, torch.bfloat16,
                                16))
        self.flash_case(K, *qkv(1, 8, 2, 1024, 1000, 128, torch.bfloat16,
                                17), causal=False, softcap_val=50.0)
        # hd 256 (gemma3-4b): its prefill's shape, GQA 8/4, a local
        # layer's window of 1,024 and a global causal layer; Sq < Sk, Sk
        # not a multiple of the 64-key tile, softcap without a mask
        g3 = qkv(PREFILL_BATCH, 8, 4, PREFILL_LEN, PREFILL_LEN, 256,
                 torch.bfloat16, 19)
        self.flash_case(K, *g3, window=1024)
        self.flash_case(K, *g3)
        self.flash_case(K, *qkv(1, 8, 4, 1024, 2100, 256, torch.bfloat16,
                                20))
        self.flash_case(K, *qkv(1, 8, 2, 1024, 1000, 256, torch.bfloat16,
                                21), causal=False, softcap_val=50.0)
        # float32 at the scalar kernel's wider heads
        for hd in (80, 128, 256):
            self.flash_case(K, *qkv(1, 4, 2, 1024, 1024, hd, torch.float32,
                                    22 + hd))
            self.flash_case(K, *qkv(1, 4, 2, 512, 1000, hd, torch.float32,
                                    23 + hd), window=300, softcap_val=30.0)

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

    def eager_chunks(self, engine, q, acc, occ0, max_rounds):
        """``engine``'s rounds issued from the host in chunks of
        ``EAGER_CHUNK``, each round predicated on the device flag ``live =
        (occupancy > 0) & ~overflow`` and each chunk ending in one
        readback: the port's round loop before the device loop, kept here
        as the yardstick of the device loop and not in the package.  ``q``
        and ``acc`` as the engine's run starts them.  Returns (q, acc,
        stats)."""
        torch = self.torch
        i32 = dict(dtype=torch.int32, device=self.dev)
        processed, spawned = (torch.zeros((), **i32) for _ in range(2))
        max_occ = torch.tensor(occ0, **i32)
        rounds = readbacks = 0
        while True:
            oflow = torch.zeros((), dtype=torch.bool, device=self.dev)
            live_rounds = torch.zeros((), **i32)
            for _ in range(EAGER_CHUNK):
                live = (engine._occ_of(q) > 0) & ~oflow
                q, new_acc, k, total, over, _ = engine._round(q, acc, live)
                acc = torch.where(live, new_acc, acc)
                processed += k
                spawned += total
                max_occ = torch.where(
                    live, torch.maximum(max_occ, engine._occ_of(q)), max_occ)
                oflow = oflow | (over & live)
                live_rounds += live.to(torch.int32)
            occ, r, of = torch.stack([engine._occ_of(q), live_rounds,
                                      oflow.to(torch.int32)]).tolist()
            readbacks += 1
            rounds += r
            if of:
                raise AssertionError("eager rounds overflowed")
            if occ == 0 or rounds >= max_rounds:
                break
        return q, acc, {"rounds": rounds, "processed": int(processed),
                        "spawned": int(spawned),
                        "max_occupancy": int(max_occ), "readbacks": readbacks}

    def timed(self, fn):
        """``fn()`` between two CUDA events and a host clock, then a
        synchronise: (result, wall s, device span s)."""
        torch = self.torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, time.perf_counter() - t0, start.elapsed_time(end) / 1e3

    def loop_checks(self, label, stats, sync_log):
        """A drained run of the device loop reads back once, as the
        reference's one ``while_loop`` chunk does."""
        got = [(p.rounds, p.occupancy) for p in sync_log]
        if stats["host_syncs"] != 1 or got != [(stats["rounds"], 0)]:
            raise AssertionError(f"{label}: host_syncs "
                                 f"{stats['host_syncs']}, sync_log {got}")

    def fifo_golden(self, rt):
        """The JAX package's fifo_fanout golden run, on the card, host_syncs
        included (fused); the legacy loop reads back once per wave."""
        torch = self.torch
        out = {}
        for fused in (True, False):
            r = rt.RoundRunner(golden_tree_step(torch), capacity_log2=8,
                               batch=16, fused=fused)
            acc, st = r.run([1], acc=torch.zeros(80, dtype=torch.int32,
                                                 device=self.dev))
            got = {"stats": [r.stats[k] for k in STATS],
                   "acc": digest(acc.cpu().numpy()),
                   "planes": digest(*(p.cpu().numpy() for p in st[:4])),
                   "head_tail": [st.head, st.tail]}
            want = {k: v for k, v in FIFO_GOLDEN.items() if k != "host_syncs"}
            if got != want:
                raise AssertionError(f"fifo golden (fused={fused}): {got}")
            if fused:
                self.loop_checks("fifo golden", r.stats, r.sync_log)
                got["host_syncs"] = r.stats["host_syncs"]
            out["fused" if fused else "legacy"] = got
        return out

    def run_path(self, label, g, K, bfs):
        np, torch = self.np, self.torch
        from repro_torch.runtime import RingState, ring_init
        t0 = time.perf_counter()
        runner, init_fn = bfs.bfs_rounds_runner(g, batch=BATCH)
        acc = init_fn(0)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        # the first run builds the engine's device loop (warm-up round and
        # capture); it is timed on its own
        _, capture_s, _ = self.timed(lambda: runner.run(
            [0], acc=init_fn(0), max_rounds=1_000_000))
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        (dist, st), run_s, span_s = self.timed(lambda: runner.run(
            [0], acc=acc, max_rounds=1_000_000))
        launches = dict(K.LAUNCHES)
        stats = dict(runner.stats)
        self.loop_checks(label, stats, runner.sync_log)
        round_graph = graph_nodes(runner._engine)
        self.keep[label] = (runner, init_fn, dist, st)
        # the same run again under the profiler: the card's busy time
        # (its idle share is read against the unprofiled run's wall time)
        t0 = time.perf_counter()
        with self.profile() as prof:
            runner.run([0], acc=init_fn(0), max_rounds=1_000_000)
            torch.cuda.synchronize()
        times = device_times(prof)
        busy_s = sum(times.values()) / 1e6
        profile_s = time.perf_counter() - t0
        # the same engine's rounds issued eagerly, 64 to a readback
        eng = runner._engine
        seeded = eng._seed(ring_init(eng.capacity_log2, self.dev),
                           np.array([0], np.int32))
        i32 = dict(dtype=torch.int32, device=self.dev)
        q0 = RingState(*seeded[:4], torch.tensor(seeded.head, **i32),
                       torch.tensor(seeded.tail, **i32))
        (_, eacc, est), eager_s, eager_span_s = self.timed(
            lambda: self.eager_chunks(eng, q0, init_fn(0), 1, 1_000_000))
        if not (torch.equal(eacc, dist)
                and all(est[k] == stats[k] for k in STATS[:4])):
            raise AssertionError(f"{label}: eager rounds != device loop")
        self.err["device_loop"] = 0
        self.cases["device_loop"] = self.cases.get("device_loop", 0) + 1
        fan = max(int(np.diff(g.row_ptr).max()), 1)
        return dist.cpu().numpy(), {
            "phase": label, "graph": g.name, "n": g.n, "m": g.m,
            "batch": BATCH, "fanout": fan, "capacity": runner.capacity,
            "rounds": stats["rounds"], "processed": stats["processed"],
            "spawned": stats["spawned"],
            "max_occupancy": stats["max_occupancy"],
            "readbacks": stats["host_syncs"],
            "sync_log": [(p.rounds, p.occupancy) for p in runner.sync_log],
            "setup_s": setup_s, "first_run_s": capture_s,
            "run_s": run_s, "rounds_per_s": stats["rounds"] / run_s,
            "device_span_s": span_s,
            "device_us_per_round": span_s / stats["rounds"] * 1e6,
            "launches": launches,
            "launches_per_round": {k: v / stats["rounds"]
                                   for k, v in launches.items()},
            "round_graph": round_graph,
            # the profiler may drop the records of a long graph run (road:
            # 0.66 ms recorded of a 749 ms launch); then only the events'
            # span, the one graph launch from start to end, says how busy
            # the card was
            "device_busy_s": busy_s if busy_s >= 0.5 * span_s else None,
            "idle_share": (1 - busy_s / run_s if busy_s >= 0.5 * span_s
                           else None),
            "profiler_recorded_s": busy_s,
            "span_idle_share": 1 - span_s / run_s,
            "profile_s": profile_s,
            "top_device_ms": top_ms(times, 6),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "eager_chunks_of_64": {
                "run_s": eager_s, "rounds_per_s": est["rounds"] / eager_s,
                "readbacks": est["readbacks"], "device_span_s": eager_span_s,
                "rounds": est["rounds"], "equals_device_loop": True}}

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
            want = {k: v for k, v in HEAP_GOLDEN.items() if k != "host_syncs"}
            if got != want or st.size != 0:
                raise AssertionError(f"heap golden (fused={fused}): {got}")
            if fused:
                self.loop_checks("heap golden", r.stats, r.sync_log)
                got["host_syncs"] = r.stats["host_syncs"]
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

        runners = {fused: rt.PriorityRoundRunner(
            heap_tree_step(torch), capacity_log2=HEAP_CAP_LOG2, batch=BATCH,
            fused=fused) for fused in (True, False)}

        def run(fused):
            r = runners[fused]
            acc = torch.zeros(4096, dtype=torch.int32, device=self.dev)
            out = r.run(ik, iv, acc=acc, max_rounds=1_000_000)
            torch.cuda.synchronize()
            return r, out

        info = {"phase": "heap", "golden": self.heap_golden(rt),
                "capacity": 1 << HEAP_CAP_LOG2, "batch": BATCH,
                "seeds": HEAP_SEEDS, "oracle_s": oracle_s}
        # the first fused run builds the engine's device loop
        info["first_run_s"] = self.timed(lambda: run(True))[1]
        runs = {}
        for fused in (True, False):
            K.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            (r, (acc, st)), wall, span = self.timed(lambda: run(fused))
            runs[fused] = (r, acc.cpu().numpy(), st)
            if fused:
                self.keep["heap"] = (r, ik, iv, acc, st)
            name = "fused" if fused else "legacy"
            info[name] = {
                "rounds": r.stats["rounds"],
                "processed": r.stats["processed"],
                "spawned": r.stats["spawned"],
                "max_occupancy": r.stats["max_occupancy"],
                "readbacks": r.stats["host_syncs"], "run_s": wall,
                "rounds_per_s": r.stats["rounds"] / wall,
                "device_span_s": span,
                "device_us_per_round": span / r.stats["rounds"] * 1e6,
                "launches": dict(K.LAUNCHES),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            if fused:
                self.launches["heap"] = dict(K.LAUNCHES)
                self.loop_checks("heap", r.stats, r.sync_log)
                info[name]["round_graph"] = graph_nodes(r._engine)
                info[name]["sync_log"] = [(p.rounds, p.occupancy)
                                          for p in r.sync_log]
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
        # the same engine's rounds issued eagerly, 64 to a readback
        from repro_torch.runtime import HeapState, heap_init
        eng = rf._engine
        seeded = eng._seed(heap_init(HEAP_CAP_LOG2, self.dev), ik, iv)
        q0 = HeapState(seeded.keys, seeded.vals,
                       torch.tensor(seeded.size, dtype=torch.int32,
                                    device=self.dev))
        (_, eacc, est), eager_s, eager_span = self.timed(
            lambda: self.eager_chunks(
                eng, q0, torch.zeros(4096, dtype=torch.int32,
                                     device=self.dev), HEAP_SEEDS,
                1_000_000))
        if not (np.array_equal(eacc.cpu().numpy(), af)
                and all(est[k] == rf.stats[k] for k in STATS[:4])):
            raise AssertionError("heap: eager rounds != device loop")
        self.err["device_loop"] = 0
        self.cases["device_loop"] = self.cases.get("device_loop", 0) + 1
        info["eager_chunks_of_64"] = {
            "run_s": eager_s, "rounds_per_s": est["rounds"] / eager_s,
            "readbacks": est["readbacks"], "device_span_s": eager_span,
            "rounds": est["rounds"], "equals_device_loop": True}
        return info

    # -- phase 5b: observability on the round engines ------------------------

    def obs_golden(self, rt, obs):
        """Both goldens with ``Telemetry(capacity=256)`` and
        ``Spans(classes=1, buckets=8)`` on the device loop: the trace and
        span digests, the stats and one readback."""
        torch = self.torch

        def heap_step(acc, keys, vals, valid):
            acc = acc.index_add(0, torch.where(valid, vals % 97, 0),
                                valid.int())
            ck = torch.stack([keys + 3, keys + 7], -1).int()
            cv = torch.stack([vals * 2 + 1, vals * 2 + 2], -1).int()
            return acc, ck, cv, (valid & (keys < 24))[:, None]

        out = {}
        for name, golden in (("fifo", FIFO_GOLDEN), ("heap", HEAP_GOLDEN)):
            tel = obs.Telemetry(capacity=256)
            sp = obs.Spans(classes=1, buckets=8)
            kw = dict(telemetry=tel, spans=sp, batch=16)
            zeros = dict(dtype=torch.int32, device=self.dev)
            if name == "fifo":
                r = rt.RoundRunner(golden_tree_step(torch), capacity_log2=8,
                                   **kw)
                acc, st = r.run([1], acc=torch.zeros(80, **zeros))
            else:
                r = rt.PriorityRoundRunner(heap_step, capacity_log2=9, **kw)
                acc, st = r.run([5, 1], [1, 2], acc=torch.zeros(97, **zeros))
            got = {"stats": [r.stats[k] for k in STATS],
                   "acc": digest(acc.cpu().numpy()),
                   "tel": tel_digest(tel),
                   "spans": digest(sp.hist, sp.max_wait)}
            want = {"stats": golden["stats"], "acc": golden["acc"],
                    **OBS_GOLDEN[name]}
            if got != want:
                raise AssertionError(f"{name} golden with obs: {got}")
            self.loop_checks(f"{name} golden with obs", r.stats, r.sync_log)
            got["host_syncs"] = r.stats["host_syncs"]
            out[name] = got
        return out

    def obs_pair(self, K, label, off, on, run):
        """``run(runner)`` for the kept obs-off runner and the obs-on one
        (its first run builds its device loop), then timed in turns off,
        on, on, off three times over (six runs a side, so that one slow
        run shows as an outlier beside the median) with CUDA events and
        the host clock; the obs-on runs' launches counted under
        ``obs_<label>``.  Returns (the last obs-on run's result,
        timings)."""
        torch = self.torch
        run(on)                               # capture
        times = {"off": [], "on": []}
        result = None
        for flag in ("off", "on", "on", "off") * 3:
            runner = on if flag == "on" else off
            if flag == "on":
                runner.telemetry.reset()
                runner.spans.reset()
                K.reset_launches()
            res, wall, span = self.timed(lambda: run(runner))
            rounds = runner.stats["rounds"]
            times[flag].append({"run_s": wall, "rounds_per_s": rounds / wall,
                                "device_span_s": span,
                                "device_us_per_round": span / rounds * 1e6})
            if flag == "on":
                self.launches[f"obs_{label}"] = dict(K.LAUNCHES)
                result = res
        torch.cuda.synchronize()
        med = {f: {k: statistics.median(t[k] for t in times[f])
                   for k in times[f][0]} for f in times}
        med["on_over_off_us_per_round"] = (
            med["on"]["device_us_per_round"]
            / med["off"]["device_us_per_round"])
        return result, {"runs": times, "median": med}

    def obs_checks(self, label, runner, off_stats, tel, sp, graph):
        """One readback, one record a round summing to the stats, one
        sojourn a pop, and no node added to the unobserved round."""
        st = runner.stats
        self.loop_checks(f"obs {label}", st, runner.sync_log)
        if {k: st[k] for k in STATS} != {k: off_stats[k] for k in STATS}:
            raise AssertionError(f"obs {label}: stats {st} != {off_stats}")
        recs = tel.records
        checks = {
            "records": len(recs), "rounds": st["rounds"],
            "pops": sum(r.pops[0] for r in recs),
            "pushes": sum(r.pushes[0] for r in recs),
            "hist_total": sp.total, "dropped": tel.dropped,
            "last_occupancy": recs[-1].occupancy[0],
            "max_wait": int(sp.max_wait.max()),
            "p50": sp.percentile(0.5), "p99": sp.percentile(0.99)}
        if not (checks["records"] == st["rounds"]
                and [r.round for r in recs] == list(range(st["rounds"]))
                and checks["pops"] == st["processed"]
                and checks["pushes"] == st["spawned"]
                and checks["hist_total"] == st["processed"]
                and checks["dropped"] == 0
                and checks["last_occupancy"] == 0):
            raise AssertionError(f"obs {label}: {checks}")
        checks["round_graph_on"] = graph
        return checks

    def obs_path(self, K, rt, bfs, road, road_dist):
        """The observability phase: the goldens' digests on the card, then
        road 2048² and the 2^20 heap tree with telemetry and spans on the
        device loop, each held against the same path's obs-off run of
        phases 3 and 5 (state, stats, one readback), timed in turns with
        it, and its captured round's nodes counted."""
        np, torch = self.np, self.torch
        from repro_torch import obs
        info = {"phase": "obs", "golden": self.obs_golden(rt, obs)}
        # road: obs-off runner and final state of phase 3
        off, init_fn, off_dist, off_st = self.keep.pop("road")
        tel = obs.Telemetry(OBS_ROAD_CAPACITY, engine="road")
        sp = obs.Spans(engine="road")
        on, _ = bfs.bfs_rounds_runner(road, batch=BATCH, telemetry=tel,
                                      spans=sp)
        off_stats = dict(off.stats)
        (dist, st), times = self.obs_pair(
            K, "road", off, on, lambda r: r.run([0], acc=init_fn(0),
                                             max_rounds=1_000_000))
        if not (np.array_equal(dist.cpu().numpy(), road_dist)
                and torch.equal(dist, off_dist)
                and all(torch.equal(a, b) for a, b in zip(st[:4],
                                                          off_st[:4]))
                and (st.head, st.tail) == (off_st.head, off_st.tail)):
            raise AssertionError("obs road: state != the obs-off run's")
        road_info = self.obs_checks("road", on, off_stats, tel, sp,
                                    graph_nodes(on._engine))
        road_info.update(times=times, state_equals_obs_off=True,
                         dist_exact=True,
                         launches=self.launches["obs_road"],
                         round_graph_off=graph_nodes(off._engine)["nodes"])
        info["road"] = road_info
        del off, on, off_dist, off_st, dist, st
        # the heap tree: obs-off runner and final state of phase 5
        off, ik, iv, off_acc, off_st = self.keep.pop("heap")
        tel = obs.Telemetry(OBS_HEAP_CAPACITY, engine="heap")
        sp = obs.Spans(engine="heap")
        on = rt.PriorityRoundRunner(
            heap_tree_step(torch), capacity_log2=HEAP_CAP_LOG2, batch=BATCH,
            telemetry=tel, spans=sp)
        off_stats = dict(off.stats)

        def run_heap(r):
            out = r.run(ik, iv, acc=torch.zeros(4096, dtype=torch.int32,
                                                device=self.dev),
                        max_rounds=1_000_000)
            torch.cuda.synchronize()
            return out

        (acc, st), times = self.obs_pair(K, "heap", off, on, run_heap)
        # phase 5 held the obs-off run against the closure oracle
        if not (torch.equal(acc, off_acc) and st.size == off_st.size == 0
                and torch.equal(st.keys, off_st.keys)
                and torch.equal(st.vals, off_st.vals)):
            raise AssertionError("obs heap: state != the obs-off run's")
        heap_info = self.obs_checks("heap", on, off_stats, tel, sp,
                                    graph_nodes(on._engine))
        heap_info.update(times=times, state_equals_obs_off=True,
                         oracle_exact=True,
                         launches=self.launches["obs_heap"],
                         round_graph_off=graph_nodes(off._engine)["nodes"])
        info["heap"] = heap_info
        for path, names in (("obs_road", ("ring_dequeue_wave_packed",
                                          "ring_enqueue_wave_packed",
                                          "obs_record")),
                            ("obs_heap", ("heap_apply_rider",
                                          "obs_record"))):
            rounds = info[path[4:]]["rounds"]
            for name in names:
                if self.launches[path].get(name, 0) < rounds:
                    raise AssertionError(f"{path}: {name} launched "
                                         f"{self.launches[path].get(name)} "
                                         f"times in {rounds} rounds")
        return info

    # -- phase mesh: the FIFO mesh on one card -------------------------------

    def mesh_run(self, K, fn, path="mesh"):
        """``fn()`` between CUDA events, with every launch count set to 0
        just before and read just after; the counts are added to the
        path's (the mesh's, or ``path``).  Returns (fn's result, its
        launches, wall s, device s)."""
        K.reset_launches()
        out, wall, span = self.timed(fn)
        got = {k: v for k, v in K.LAUNCHES.items() if v}
        path = self.launches[path]
        for k, v in got.items():
            path[k] = path.get(k, 0) + v
        return out, got, wall, span

    def mesh_checks(self, label, got, rounds, names):
        for name in names:
            if got.get(name, 0) != rounds:
                raise AssertionError(f"{label}: {name} launched "
                                     f"{got.get(name, 0)} times in {rounds} "
                                     f"rounds")

    def mesh_golden(self, K, rt, bfs, obs, make_mesh):
        """The JAX package's mesh goldens on the card: the fanout tree at 1
        and 2 shards with Telemetry(capacity=256), fused (one readback) and
        legacy (the same state, a readback a round), and mesh BFS on
        road_like(144) at batch 32, 1 and 2 shards."""
        torch, np = self.torch, self.np
        out = {}
        for name, g in MESH_GOLDEN.items():
            mesh = make_mesh((g["shards"],), ("data",))
            for fused in (True, False):
                if name.startswith("mesh_bfs"):
                    (dist, stats), _, _, _ = self.mesh_run(
                        K, lambda: bfs.bfs_mesh_rounds(
                            bfs.road_like(144), 0, mesh=mesh, batch=32,
                            fused=fused))
                    got = {"stats": [stats[k] for k in STATS]
                           + [stats["host_syncs"]], "dist": digest(dist)}
                else:
                    tel = obs.Telemetry(capacity=256) if fused else None
                    r = rt.MeshRoundRunner(
                        golden_tree_step(torch), mesh=mesh, capacity_log2=8,
                        batch=16, fused=fused, telemetry=tel,
                        combine=lambda a: a.sum(0, dtype=torch.int32))
                    (acc, st), _, _, _ = self.mesh_run(K, lambda: r.run(
                        [1], acc=torch.zeros(80, dtype=torch.int32,
                                             device=self.dev)))
                    stats = r.stats
                    got = {"stats": [stats[k] for k in STATS]
                           + [stats["host_syncs"]],
                           "acc": digest(acc.cpu().numpy()),
                           "planes": digest(*(p.cpu().numpy()
                                              for p in st[:4])),
                           "head_tail": [st.head, st.tail]}
                    if fused:
                        got["tel"] = tel_digest(tel)
                want = {k: v for k, v in g.items() if k != "shards"}
                if not fused:           # the legacy loop reads back a round
                    want = dict(want, stats=want["stats"][:5]
                                + [want["stats"][0]])
                    want.pop("tel", None)
                if got != want:
                    raise AssertionError(f"{name} (fused={fused}): {got}")
                out[name + ("" if fused else "_legacy")] = got
        return out

    def mesh_functional(self, K, core):
        """The functional faces on the card at the mesh's shape (4 shards x
        1,024 requests, the masked ring waves): enqueue and dequeue rounds
        from rings whose tickets start 8,192 below 2^31 and 2^32, then
        claim rounds to empty; every granted value comes back once, in
        order (host FIFO oracle)."""
        np, torch = self.np, self.torch
        rng = np.random.default_rng(16)
        out = {}

        def rounds(start):
            st = core.dist_queue_init(4096, start=start)
            sent, got = [], []
            for r in range(6):
                vals = self.t(rng.integers(1, 1 << 30, (MESH_SHARDS, BATCH)),
                              torch.int32)
                em = self.t(rng.random((MESH_SHARDS, BATCH)) < 0.7)
                wm = self.t(rng.random((MESH_SHARDS, BATCH)) < 0.6)
                st, granted = core.dist_enqueue_round(st, vals, em)
                st, dv, ok = core.dist_dequeue_round(st, wm)
                sent += vals[granted].tolist()
                got += dv[ok].tolist()
            while int(st.occupancy) > 0:
                st, cv, cok = core.dist_claim_round(
                    st, int(st.occupancy), BATCH, MESH_SHARDS)
                got += cv[cok].tolist()
            if got != sent:
                raise AssertionError(f"mesh functional rounds from {start}: "
                                     f"{len(got)} values back of "
                                     f"{len(sent)}")
            return {"sent": len(sent), "tail": int(st.tail)}

        for start in (2 ** 31 - 8192, 2 ** 32 - 8192):
            res, got, _, _ = self.mesh_run(K, lambda: rounds(start))
            out[str(start)] = dict(res, launches=got)
        return out

    def in_turns(self, runners, run, turns=3):
        """Each of ``runners`` (label -> runner) run by ``run(runner)`` in
        turns, ``turns`` times over: {label: {"runs": [wall s, rounds/s,
        device µs a round], "median": the same}}."""
        times = {label: [] for label in runners}
        for _ in range(turns):
            for label, r in runners.items():
                _, wall, span = self.timed(lambda: run(r))
                rounds = r.stats["rounds"]
                times[label].append({
                    "run_s": wall, "rounds_per_s": rounds / wall,
                    "device_us_per_round": span / rounds * 1e6})
        return {label: {"runs": t, "median": {
            k: statistics.median(x[k] for x in t) for k in t[0]}}
            for label, t in times.items()}

    def mesh_obs_checks(self, label, tel, sp, stats, shards):
        """A mesh run with Telemetry and Spans: one record a round, their
        pops and pushes summing to processed and spawned, the histogram's
        total the pops, nothing dropped, every shard empty at the end.
        Returns the checks."""
        recs = tel.records
        checks = {
            "records": len(recs), "rounds": stats["rounds"],
            "pops": sum(sum(r.pops) for r in recs),
            "pushes": sum(sum(r.pushes) for r in recs),
            "max_imbalance": max(r.imbalance for r in recs),
            "hist_total": sp.total, "dropped": tel.dropped,
            "last_occupancy": recs[-1].occupancy,
            "p50": sp.percentile(0.5), "p99": sp.percentile(0.99),
            "max_wait": int(sp.max_wait.max())}
        if not (checks["records"] == stats["rounds"]
                and [r.round for r in recs] == list(range(stats["rounds"]))
                and checks["pops"] == stats["processed"]
                and checks["pushes"] == stats["spawned"]
                and checks["hist_total"] == stats["processed"]
                and checks["dropped"] == 0
                and checks["last_occupancy"] == [0] * shards):
            raise AssertionError(f"{label}: {checks}")
        return checks

    def mesh_bfs_road(self, K, bfs):
        """Mesh BFS on road_like(215^2) at 4 shards and batch 1,024,
        replicated (2^20 slots) and sharded (four rings of 2^18): dist =
        row + col, the two dists equal, one readback, the grid waves once
        a round; each run after a first that captures its round."""
        np, torch = self.np, self.torch
        side = MESH_ROAD_SIDE
        g = bfs.road_like(side * side)
        v = np.arange(g.n)
        want = (v // side + v % side).astype(np.int32)
        out, dists = {}, {}
        for sharded in (False, True):
            label = "road_sharded" if sharded else "road"
            runner, init_fn = bfs.bfs_mesh_rounds_runner(
                g, shards=MESH_SHARDS, batch=BATCH, sharded=sharded)
            runner.run([0], acc=init_fn(0), max_rounds=1_000_000)
            (dist, _), got, wall, span = self.mesh_run(
                K, lambda: runner.run([0], acc=init_fn(0),
                                      max_rounds=1_000_000))
            dist = dist.cpu().numpy()
            if not np.array_equal(dist, want):
                raise AssertionError(f"mesh {label}: dist != row + col")
            st = runner.stats
            self.loop_checks(f"mesh {label}", st, runner.sync_log)
            sfx = "_sharded" if sharded else ""
            self.mesh_checks(f"mesh {label}", got, st["rounds"],
                             ("ring_dequeue_wave" + sfx,
                              "ring_enqueue_wave" + sfx))
            dists[sharded] = dist
            out[label] = {
                "n": g.n, "shards": MESH_SHARDS, "batch": BATCH,
                "ring_slots": 2 << runner.capacity_log2,
                **{k: st[k] for k in STATS}, "readbacks": st["host_syncs"],
                "run_s": wall, "rounds_per_s": st["rounds"] / wall,
                "device_us_per_round": span / st["rounds"] * 1e6,
                "launches": got,
                "round_graph": graph_nodes(runner._engine)}
        if not np.array_equal(dists[False], dists[True]):
            raise AssertionError("mesh road: sharded dist != replicated")
        out["dist_exact"] = True
        return out

    def mesh_tree(self, K, rt, obs, make_mesh):
        """The FIFO task tree at a real backlog on the mesh (4 shards x
        batch 1,024, 2^23 slots replicated, four rings of 2^21 sharded)
        and on RingEngine at batch 4,096: each against the numpy closure
        of the seeds, the replicated mesh against RingEngine bit for bit
        (stats, acc, planes, head/tail), timed in turns; then the
        replicated and the sharded mesh with compact=True (each shard's
        child row through wave_compact, the dense enqueue wave): the
        ballot run's state; then the replicated mesh with Telemetry (4
        shard rows) and Spans()."""
        np, torch = self.np, self.torch
        seeds = (np.random.default_rng(15).integers(
            0, 2 ** 27, MESH_TREE_SEEDS) << 4).astype(np.int32)
        want_acc, want_p, want_s, top = fifo_closure(np, seeds)
        if top >= IDX_BOT - 1:
            raise AssertionError("fifo tree: a payload reaches the ring's "
                                 "empty markers")
        mesh = make_mesh((MESH_SHARDS,), ("data",))
        step = fifo_tree_step(torch)
        sum32 = lambda a: a.sum(0, dtype=torch.int32)  # noqa: E731
        runners = {
            "replicated": rt.MeshRoundRunner(
                step, mesh=mesh, capacity_log2=MESH_TREE_CAP_LOG2,
                batch=BATCH, combine=sum32),
            "sharded": rt.MeshRoundRunner(
                step, mesh=mesh, capacity_log2=MESH_TREE_CAP_LOG2,
                batch=BATCH, sharded=True, combine=sum32),
            "single": rt.RoundRunner(step, capacity_log2=MESH_TREE_CAP_LOG2,
                                     batch=MESH_SHARDS * BATCH)}

        def run(r):
            return r.run(seeds, acc=torch.zeros(4096, dtype=torch.int32,
                                                device=self.dev),
                         max_rounds=1_000_000)

        out, final = {}, {}
        for label, r in runners.items():
            run(r)                               # capture
            (acc, st), got, wall, span = self.mesh_run(K, lambda: run(r))
            stats = r.stats
            self.loop_checks(f"mesh tree {label}", stats, r.sync_log)
            if not (np.array_equal(acc.cpu().numpy(), want_acc)
                    and stats["processed"] == want_p
                    and stats["spawned"] == want_s):
                raise AssertionError(f"mesh tree {label}: acc or totals != "
                                     f"the closure ({stats})")
            if label != "single":
                sfx = "_sharded" if label == "sharded" else ""
                self.mesh_checks(f"mesh tree {label}", got, stats["rounds"],
                                 ("ring_dequeue_wave" + sfx,
                                  "ring_enqueue_wave" + sfx))
            final[label] = (acc, st)
            out[label] = {**{k: stats[k] for k in STATS},
                          "readbacks": stats["host_syncs"],
                          "first_timing": {"run_s": wall,
                                           "device_span_s": span},
                          "launches": got,
                          "round_graph": graph_nodes(r._engine)}
        (ra, rs), (sa, ss) = final["replicated"], final["single"]
        if not ({k: out["replicated"][k] for k in STATS}
                == {k: out["single"][k] for k in STATS}
                and torch.equal(ra, sa)
                and all(torch.equal(a, b) for a, b in zip(rs[:4], ss[:4]))
                and (rs.head, rs.tail) == (ss.head, ss.tail)):
            raise AssertionError("mesh tree: the replicated mesh != "
                                 "RingEngine at batch 4,096")
        out["replicated_equals_ring_engine"] = True
        out["sharded_equals_closure"] = True
        # timed in turns (replicated, sharded, single) x 3
        for label, timed in self.in_turns(runners, run).items():
            out[label]["timed"] = timed
        # the compacted publish (compact=True): each shard's child row
        # through wave_compact, then the dense enqueue wave; the state of
        # the ballot run
        for label, sharded in (("replicated", False), ("sharded", True)):
            r = rt.MeshRoundRunner(
                step, mesh=mesh, capacity_log2=MESH_TREE_CAP_LOG2,
                batch=BATCH, sharded=sharded, combine=sum32, compact=True)
            run(r)                               # capture
            (acc, st), got, wall, span = self.mesh_run(K, lambda: run(r))
            stats = r.stats
            self.loop_checks(f"mesh tree {label} compact", stats,
                             r.sync_log)
            acc0, st0 = final[label]
            if not ({k: stats[k] for k in STATS}
                    == {k: out[label][k] for k in STATS}
                    and torch.equal(acc, acc0)
                    and all(torch.equal(torch.as_tensor(a),
                                        torch.as_tensor(b))
                            for a, b in zip(st, st0))):
                raise AssertionError(f"mesh tree {label} compact: state != "
                                     f"the ballot run's")
            sfx = "_sharded" if sharded else ""
            rounds = stats["rounds"]
            self.mesh_checks(f"mesh tree {label} compact", got, rounds,
                             ("ring_dequeue_wave" + sfx,
                              "ring_enqueue_wave" + sfx))
            if got.get("wave_compact", 0) != MESH_SHARDS * rounds:
                raise AssertionError(
                    f"mesh tree {label} compact: wave_compact launched "
                    f"{got.get('wave_compact', 0)} times in {rounds} "
                    f"rounds of {MESH_SHARDS} shards")
            out[label]["compact"] = {
                "state_equals_ballot_run": True, "run_s": wall,
                "device_us_per_round": span / rounds * 1e6,
                "launches": got, "round_graph": graph_nodes(r._engine)}
        # observability on the replicated mesh
        tel = obs.Telemetry(2048, engine="mesh")
        sp = obs.Spans(engine="mesh")
        on = rt.MeshRoundRunner(step, mesh=mesh,
                                capacity_log2=MESH_TREE_CAP_LOG2,
                                batch=BATCH, combine=sum32, telemetry=tel,
                                spans=sp)
        run(on)                                  # capture
        tel.reset()
        sp.reset()
        (acc, st), got, wall, span = self.mesh_run(K, lambda: run(on))
        stats = on.stats
        self.loop_checks("mesh tree obs", stats, on.sync_log)
        checks = self.mesh_obs_checks("mesh tree obs", tel, sp, stats,
                                      MESH_SHARDS)
        if not (torch.equal(acc, ra)
                and all(torch.equal(a, b) for a, b in zip(st[:4], rs[:4]))
                and (st.head, st.tail) == (rs.head, rs.tail)
                and {k: stats[k] for k in STATS}
                == {k: out["replicated"][k] for k in STATS}):
            raise AssertionError("mesh tree obs: state != obs off")
        self.mesh_checks("mesh tree obs", got, stats["rounds"],
                         ("ring_dequeue_wave_packed",
                          "ring_enqueue_wave_packed", "obs_record_mesh"))
        out["obs"] = dict(checks, state_equals_obs_off=True, run_s=wall,
                          device_us_per_round=span / stats["rounds"] * 1e6,
                          launches=got, round_graph=graph_nodes(on._engine))
        out["closure"] = {"processed": want_p, "spawned": want_s}
        return out

    def mesh_path(self, K, rt, bfs):
        """Phase mesh: the goldens, the functional faces, road 215^2 and
        the task tree on the mesh engines, each run's launches added to
        the mesh path's."""
        from repro_torch import core, obs
        from repro_torch.distributed import make_mesh
        t0 = time.perf_counter()
        info = {"phase": "mesh",
                "golden": self.mesh_golden(K, rt, bfs, obs, make_mesh),
                "functional": self.mesh_functional(K, core)}
        info.update(self.mesh_bfs_road(K, bfs))
        info["tree"] = self.mesh_tree(K, rt, obs, make_mesh)
        for name in ("ring_enqueue_masked", "ring_dequeue_masked",
                     "ring_dequeue_wave", "ring_dequeue_wave_sharded",
                     "ring_dequeue_wave_packed", "ring_enqueue_wave",
                     "ring_enqueue_wave_sharded", "ring_enqueue_wave_packed",
                     "wave_compact", "obs_record_mesh"):
            if not self.launches["mesh"].get(name):
                raise AssertionError(f"mesh: {name} never launched")
        info["launches"] = self.launches["mesh"]
        info["seconds"] = time.perf_counter() - t0
        return info

    # -- phase pmesh: the priority mesh on one card -------------------------

    def grid_checks(self, label, got, rounds, name="heap_apply_grid"):
        """A priority mesh run launches its grid twice a round (the pop and
        the insert wave) and once for the seed."""
        if got.get(name, 0) != 2 * rounds + 1:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{got.get(name, 0)} times in {rounds} "
                                 f"rounds, not {2 * rounds + 1}")

    def pmesh_golden(self, K, rt, obs, make_mesh):
        """The JAX package's priority mesh goldens on the card: relaxed and
        strict at 1 and 2 shards with Telemetry(capacity=512), fused (one
        readback) and legacy (the same state, a readback a round)."""
        torch = self.torch

        def step(acc, keys, vals, valid):
            acc = acc.index_add(0, torch.where(valid, vals % 89, 0),
                                valid.int())
            ck = torch.stack([keys + 2, keys + 5], -1).int()
            cv = torch.stack([(vals * 7919) % 1000,
                              (vals * 104729) % 1000], -1).int()
            return acc, ck, cv, (valid & (keys < 20))[:, None]

        out = {}
        for name, g in PMESH_GOLDEN.items():
            mesh = make_mesh((g["shards"],), ("data",))
            for fused in (True, False):
                tel = obs.Telemetry(capacity=512) if fused else None
                r = rt.PriorityMeshRoundRunner(
                    step, mesh=mesh, capacity_log2=10, batch=16,
                    relaxed=g["relaxed"], fused=fused, telemetry=tel,
                    combine=lambda a: a.sum(0, dtype=torch.int32))
                (acc, st), _, _, _ = self.mesh_run(K, lambda: r.run(
                    [3, 1], [7, 11], acc=torch.zeros(
                        89, dtype=torch.int32, device=self.dev)), "pmesh")
                got = {"stats": [r.stats[k] for k in STATS]
                       + [r.stats["host_syncs"]],
                       "acc": digest(acc.cpu().numpy()),
                       "planes": digest(st.keys.cpu().numpy(),
                                        st.vals.cpu().numpy())}
                want = {k: v for k, v in g.items()
                        if k not in ("shards", "relaxed")}
                if fused:
                    got["tel"] = tel_digest(tel)
                    self.loop_checks(name, r.stats, r.sync_log)
                else:
                    want = dict(want, stats=want["stats"][:5]
                                + [want["stats"][0]])
                    want.pop("tel")
                if got != want:
                    raise AssertionError(f"{name} (fused={fused}): {got}")
                out[name + ("" if fused else "_legacy")] = got
        return out

    def pmesh_histories(self, K, rt, make_mesh):
        """The pmesh goldens' runs once more on the legacy loop with
        ``trace=True`` (the goldens' keys, seeds and sizes; tree-numbered
        payloads, child vals 2v and 2v + 1, since the checker needs each
        payload once and the goldens' repeat): their stats equal the
        goldens', and ``mesh_trace_history`` of each run passes the port's
        ``check_p_linearizable`` at k = 0 strict and at
        ``mesh_relaxation_bound`` relaxed."""
        from repro_torch.sched import (check_p_linearizable,
                                       mesh_relaxation_bound,
                                       mesh_trace_history)
        torch = self.torch

        def step(acc, keys, vals, valid):
            acc = acc.index_add(0, torch.where(valid, vals % 89, 0),
                                valid.int())
            ck = torch.stack([keys + 2, keys + 5], -1).int()
            cv = torch.stack([vals * 2, vals * 2 + 1], -1).int()
            return acc, ck, cv, (valid & (keys < 20))[:, None]

        seeds = [(3, 7), (1, 11)]
        out = {}
        for name, g in PMESH_GOLDEN.items():
            r = rt.PriorityMeshRoundRunner(
                step, mesh=make_mesh((g["shards"],), ("data",)),
                capacity_log2=10, batch=16, relaxed=g["relaxed"],
                fused=False, trace=True, device=self.dev,
                combine=lambda a: a.sum(0, dtype=torch.int32))
            self.mesh_run(K, lambda: r.run(
                [k for k, _ in seeds], [v for _, v in seeds],
                acc=torch.zeros(89, dtype=torch.int32, device=self.dev)),
                "pmesh")
            stats = [r.stats[k] for k in STATS]
            hist = mesh_trace_history(r.trace, seeds)
            k = (mesh_relaxation_bound(g["shards"], 16,
                                       r.stats["max_occupancy"])
                 if g["relaxed"] else 0)
            res = check_p_linearizable(hist, k)
            if stats != g["stats"][:5] or not res.ok:
                raise AssertionError(f"{name} history: stats {stats}, "
                                     f"k = {k}: {res.reason}")
            out[name] = {"stats": stats, "events": len(hist), "k": k,
                         "p_linearizable": res.ok,
                         "k0": check_p_linearizable(hist, 0).ok}
        return out

    def pmesh_sssp(self, K, bfs, sssp):
        """Delta-stepping SSSP on road_like(1024^2) (1,048,576 vertices,
        the size of the 9th DIMACS challenge's USA-road-d.FLA), weights
        1-8 from seed 1, at 4 shards x 1,024 with the split payload
        (the distance on the heaps' rider plane) and delta 4, relaxed and
        strict: dist equal to scipy's Dijkstra on the host, one readback,
        the rider grid twice a round; each timed after a first run that
        captures its round."""
        np, torch = self.np, self.torch
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import dijkstra
        t0 = time.perf_counter()
        g = bfs.road_like(SSSP_SIDE * SSSP_SIDE)
        w = sssp.with_weights(g, max_w=SSSP_MAX_W, seed=1)
        want = dijkstra(csr_matrix((w.astype(np.float64), g.col_idx,
                                    g.row_ptr), shape=(g.n, g.n)),
                        indices=0)
        if not np.isfinite(want).all():
            raise AssertionError("sssp: the grid is connected")
        want = want.astype(np.int64)
        out = {"n": g.n, "m": g.m, "max_w": SSSP_MAX_W, "delta": SSSP_DELTA,
               "shards": MESH_SHARDS, "batch": BATCH, "layout": "split",
               "oracle": "scipy.sparse.csgraph.dijkstra",
               "setup_s": time.perf_counter() - t0}
        for relaxed in (True, False):
            label = "relaxed" if relaxed else "strict"
            runner, init_fn = sssp.sssp_mesh_rounds_runner(
                g, w, shards=MESH_SHARDS, batch=BATCH, delta=SSSP_DELTA,
                relaxed=relaxed, split_payload=True)

            def run():
                return runner.run([0], [0], acc=init_fn(0),
                                  max_rounds=1_000_000, initial_aux=[0])

            _, first_s, _ = self.timed(run)          # captures the round
            (dist, _), got, wall, span = self.mesh_run(K, run, "pmesh")
            if not np.array_equal(dist.cpu().numpy().astype(np.int64),
                                  want):
                raise AssertionError(f"sssp {label}: dist != Dijkstra")
            if not relaxed and runner.capacity != 1 << SSSP_STRICT_CAP_LOG2:
                raise AssertionError("sssp strict: the heap is not the one "
                                     "phase 2 holds against its plain twin")
            st = runner.stats
            self.loop_checks(f"sssp {label}", st, runner.sync_log)
            self.grid_checks(f"sssp {label}", got, st["rounds"],
                             "heap_apply_grid_rider")
            out[label] = {
                **{k: st[k] for k in STATS}, "readbacks": st["host_syncs"],
                "heap_slots": runner.capacity, "first_run_s": first_s,
                "run_s": wall, "rounds_per_s": st["rounds"] / wall,
                "device_span_s": span,
                "device_us_per_round": span / st["rounds"] * 1e6,
                "launches": got,
                "round_graph": graph_nodes(runner._engine),
                "dist_exact": True}
        return out

    def pmesh_tree(self, K, rt, obs, make_mesh):
        """The priority task tree of phase 5 (65,536 seeds) at 4 shards x
        1,024: relaxed on four heaps of 2^20 slots, strict on one heap of
        2^20, and PriorityRoundRunner at batch 4,096: each against the
        closure oracle, strict against PriorityRoundRunner bit for bit
        (stats, acc, planes, size), timed in turns (relaxed, strict,
        single) x 3 with the captured rounds' nodes; the relaxed tree with
        compact=True (the ballot run's state, wave_compact a shard a
        round); the relaxed tree with Telemetry (4 shard columns) and
        Spans() against the same run without, in turns (off, on, on,
        off)."""
        np, torch = self.np, self.torch
        rng = np.random.default_rng(12)
        ik = rng.integers(0, 16, HEAP_SEEDS).astype(np.int32)
        iv = rng.integers(0, 2 ** 31 - 1, HEAP_SEEDS).astype(np.int32)
        want_acc, want_p, want_s = heap_closure(np, ik, iv)
        mesh = make_mesh((MESH_SHARDS,), ("data",))
        step = heap_tree_step(torch)
        sum32 = lambda a: a.sum(0, dtype=torch.int32)  # noqa: E731
        kw = dict(mesh=mesh, capacity_log2=HEAP_CAP_LOG2, batch=BATCH,
                  combine=sum32)
        runners = {
            "relaxed": rt.PriorityMeshRoundRunner(step, **kw),
            "strict": rt.PriorityMeshRoundRunner(step, relaxed=False, **kw),
            "single": rt.PriorityRoundRunner(
                step, capacity_log2=HEAP_CAP_LOG2,
                batch=MESH_SHARDS * BATCH)}

        def run(r):
            return r.run(ik, iv, acc=torch.zeros(4096, dtype=torch.int32,
                                                 device=self.dev),
                         max_rounds=1_000_000)

        out, final = {}, {}
        for label, r in runners.items():
            run(r)                               # capture
            (acc, st), got, wall, span = self.mesh_run(
                K, lambda: run(r), "pmesh")
            stats = r.stats
            self.loop_checks(f"pmesh tree {label}", stats, r.sync_log)
            if not (np.array_equal(acc.cpu().numpy(), want_acc)
                    and stats["processed"] == want_p
                    and stats["spawned"] == want_s):
                raise AssertionError(f"pmesh tree {label}: acc or totals != "
                                     f"the closure ({stats})")
            self.grid_checks(f"pmesh tree {label}", got, stats["rounds"],
                             "heap_apply" if label == "single"
                             else "heap_apply_grid")
            final[label] = (acc, st)
            out[label] = {**{k: stats[k] for k in STATS},
                          "readbacks": stats["host_syncs"],
                          "first_timing": {"run_s": wall,
                                           "device_span_s": span},
                          "launches": got,
                          "round_graph": graph_nodes(r._engine)}
        (sa, ss), (ga, gs) = final["strict"], final["single"]
        if not ({k: out["strict"][k] for k in STATS}
                == {k: out["single"][k] for k in STATS}
                and torch.equal(sa, ga) and torch.equal(ss.keys, gs.keys)
                and torch.equal(ss.vals, gs.vals)
                and int(ss.size) == int(gs.size) == 0):
            raise AssertionError("pmesh tree: strict != PriorityRoundRunner "
                                 "at batch 4,096")
        out["strict_equals_priority_round_runner"] = True
        for label, timed in self.in_turns(runners, run).items():
            out[label]["timed"] = timed
        # the compacted publish: each shard's child row through
        # wave_compact; the ballot run's state
        ra, rs = final["relaxed"]
        r = rt.PriorityMeshRoundRunner(step, compact=True, **kw)
        run(r)                                   # capture
        (acc, st), got, wall, span = self.mesh_run(K, lambda: run(r),
                                                   "pmesh")
        stats = r.stats
        self.loop_checks("pmesh tree compact", stats, r.sync_log)
        if not ({k: stats[k] for k in STATS}
                == {k: out["relaxed"][k] for k in STATS}
                and torch.equal(acc, ra)
                and all(torch.equal(a, b) for a, b in zip(st, rs))):
            raise AssertionError("pmesh tree compact: state != the ballot "
                                 "run's")
        self.grid_checks("pmesh tree compact", got, stats["rounds"])
        if got.get("wave_compact", 0) != MESH_SHARDS * stats["rounds"]:
            raise AssertionError(
                f"pmesh tree compact: wave_compact launched "
                f"{got.get('wave_compact', 0)} times in {stats['rounds']} "
                f"rounds of {MESH_SHARDS} shards")
        out["relaxed"]["compact"] = {
            "state_equals_ballot_run": True, "run_s": wall,
            "device_us_per_round": span / stats["rounds"] * 1e6,
            "launches": got, "round_graph": graph_nodes(r._engine)}
        # observability on the relaxed tree
        tel = obs.Telemetry(2048, engine="pmesh")
        sp = obs.Spans(engine="pmesh")
        on = rt.PriorityMeshRoundRunner(step, telemetry=tel, spans=sp, **kw)
        run(on)                                  # capture
        tel.reset()
        sp.reset()
        (acc, st), got, wall, span = self.mesh_run(K, lambda: run(on),
                                                   "pmesh")
        stats = on.stats
        self.loop_checks("pmesh tree obs", stats, on.sync_log)
        checks = self.mesh_obs_checks("pmesh tree obs", tel, sp, stats,
                                      MESH_SHARDS)
        if not (torch.equal(acc, ra)
                and all(torch.equal(a, b) for a, b in zip(st, rs))
                and {k: stats[k] for k in STATS}
                == {k: out["relaxed"][k] for k in STATS}):
            raise AssertionError("pmesh tree obs: state != obs off")
        # the births plane rides both waves of every round; the seeds,
        # born at round 0 on a zeroed plane, install without it
        want = {"heap_apply_grid_rider": 2 * stats["rounds"],
                "heap_apply_grid": 1, "obs_record_mesh": stats["rounds"]}
        if any(got.get(k, 0) != v for k, v in want.items()):
            raise AssertionError(f"pmesh tree obs: launches {got}")
        turns = {"off": [], "on": []}
        for label in ("off", "on", "on", "off"):
            r = runners["relaxed"] if label == "off" else on
            _, wall, span = self.timed(lambda: run(r))
            turns[label].append(span / r.stats["rounds"] * 1e6)
        out["obs"] = dict(
            checks, state_equals_obs_off=True, run_s=wall,
            device_us_per_round={k: statistics.median(v)
                                 for k, v in turns.items()},
            turns=turns, launches=got, round_graph=graph_nodes(on._engine))
        out["closure"] = {"processed": want_p, "spawned": want_s}
        return out

    def pmesh_path(self, K, rt, bfs):
        """Phase pmesh: the goldens, SSSP on road 1024^2 and the priority
        task tree on the priority mesh, each run's launches added to the
        pmesh path's."""
        from repro_torch import obs
        from repro_torch.apps import sssp
        from repro_torch.distributed import make_mesh
        t0 = time.perf_counter()
        info = {"phase": "pmesh",
                "golden": self.pmesh_golden(K, rt, obs, make_mesh),
                "histories": self.pmesh_histories(K, rt, make_mesh),
                "sssp": self.pmesh_sssp(K, bfs, sssp),
                "tree": self.pmesh_tree(K, rt, obs, make_mesh)}
        for name in ("heap_apply_grid", "heap_apply_grid_rider",
                     "wave_compact", "obs_record_mesh"):
            if not self.launches["pmesh"].get(name):
                raise AssertionError(f"pmesh: {name} never launched")
        info["launches"] = self.launches["pmesh"]
        info["seconds"] = time.perf_counter() - t0
        return info

    # -- phase raytrace: render_rounds on the ring engine -------------------

    def ray_render(self, K, raytrace, name):
        """One Fig. 7 scene at RAY_W x RAY_H: ``render_rounds`` fused on
        the device loop (a first run captures the round; the second is
        the path's, its launches counted) beside ``render_compaction`` on
        the same card: rays equal, images within RAY_TOL, one readback;
        then the fused run again under the profiler."""
        np, torch = self.np, self.torch
        scene = getattr(raytrace, f"{name}_scene")()
        npix = RAY_W * RAY_H
        runner, init_fn = raytrace.render_rounds_runner(
            scene, RAY_W, RAY_H, RAY_BATCH)
        seeds = np.arange(npix, dtype=np.int32)

        def run():
            acc, _ = runner.run(seeds, acc=init_fn(), max_rounds=1_000_000)
            return acc[0][:npix]

        _, first_s, _ = self.timed(run)             # capture
        img, got, run_s, span_s = self.mesh_run(K, run, "ray")
        stats = dict(runner.stats)
        self.loop_checks(f"raytrace {name}", stats, runner.sync_log)
        ring_launches(f"raytrace {name}", {"launches": got,
                                           "rounds": stats["rounds"]},
                      compacts=False)
        (cimg, cinfo), comp_s, comp_span = self.timed(
            lambda: raytrace.render_compaction(scene, RAY_W, RAY_H))
        img = img.cpu().numpy().reshape(RAY_H, RAY_W, 3)
        self.keep[f"ray_{name}"] = (img, stats["processed"])
        err = float(np.abs(img - cimg).max())
        if stats["processed"] != cinfo["rays"] or err > RAY_TOL or \
                not np.isfinite(img).all():
            raise AssertionError(
                f"raytrace {name}: rays {stats['processed']} vs compaction "
                f"{cinfo['rays']}, max |diff| {err}")
        t0 = time.perf_counter()
        with self.profile() as prof:
            run()
            torch.cuda.synchronize()
        times = device_times(prof)
        busy_s = sum(times.values()) / 1e6
        rays = stats["processed"]
        return {
            "scene": name, "pixels": npix, "rays": rays,
            "rounds": stats["rounds"], "max_occupancy":
                stats["max_occupancy"], "readbacks": stats["host_syncs"],
            "first_run_s": first_s, "run_s": run_s,
            "mrays_per_s": rays / run_s / 1e6,
            "device_span_s": span_s,
            "device_us_per_round": span_s / stats["rounds"] * 1e6,
            "compaction": {"rays": cinfo["rays"], "run_s": comp_s,
                           "device_span_s": comp_span,
                           "mrays_per_s": cinfo["rays"] / comp_s / 1e6,
                           "max_abs_diff": err},
            "launches": got,
            "round_graph": graph_nodes(runner._engine),
            "device_busy_s": busy_s if busy_s >= 0.5 * span_s else None,
            "idle_share": (1 - busy_s / run_s if busy_s >= 0.5 * span_s
                           else None),
            "profiler_recorded_s": busy_s,
            "span_idle_share": 1 - span_s / run_s,
            "profile_s": time.perf_counter() - t0,
            "top_device_ms": top_ms(times, 6)}

    def ray_path(self, K, raytrace):
        """Phase raytrace: both scenes at RAY_W x RAY_H, then
        ``render_rounds`` fused against legacy at RAY_SMALL^2, batch
        RAY_SMALL_BATCH, bit for bit."""
        np = self.np
        t0 = time.perf_counter()
        info = {"phase": "raytrace", "width": RAY_W, "height": RAY_H,
                "batch": RAY_BATCH, "tolerance": RAY_TOL}
        for name in ("complex", "cornell"):
            info[name] = self.ray_render(K, raytrace, name)
        small = {}
        for name in ("complex", "cornell"):
            scene = getattr(raytrace, f"{name}_scene")()
            runs = {}
            for fused in (True, False):
                K.reset_launches()
                (img, st), wall, span = self.timed(
                    lambda: raytrace.render_rounds(
                        scene, RAY_SMALL, RAY_SMALL, RAY_SMALL_BATCH,
                        fused=fused, max_rounds=1_000_000))
                runs[fused] = (img, st, wall, dict(
                    (k, v) for k, v in K.LAUNCHES.items() if v))
            (fi, fs, fw, fl), (li, ls, lw, ll) = runs[True], runs[False]
            if not (np.array_equal(fi, li)
                    and all(fs[k] == ls[k] for k in STATS[:4])):
                raise AssertionError(f"raytrace {name} {RAY_SMALL}^2: fused "
                                     f"!= legacy ({fs} vs {ls})")
            if ll.get("ring_dequeue", 0) != ls["rounds"]:
                raise AssertionError(f"raytrace {name} legacy: ring_dequeue "
                                     f"launched {ll.get('ring_dequeue')} "
                                     f"times in {ls['rounds']} rounds")
            self.keep[f"ray_{name}_{RAY_SMALL}"] = (fi, fs["rays"])
            small[name] = {"rays": fs["rays"], "rounds": fs["rounds"],
                           "fused_run_s": fw, "legacy_run_s": lw,
                           "fused_readbacks": fs["host_syncs"],
                           "legacy_readbacks": ls["host_syncs"],
                           "fused_launches": fl, "legacy_launches": ll,
                           "bit_identical": True}
        info[f"fused_vs_legacy_{RAY_SMALL}"] = small
        info["launches"] = self.launches["ray"]
        info["seconds"] = time.perf_counter() - t0
        return info

    # -- phase admission: device serving admission --------------------------

    def admission_golden(self, K, serving, obs, make_mesh):
        """The JAX package's serving goldens on the card with
        Telemetry(capacity=256): stats, ticks, admitted, planes, pop
        history and tel digests."""
        np = self.np
        out = {}
        for name, g in SERVING_GOLDEN.items():
            tel = obs.Telemetry(capacity=256)
            e = serving.ServingMeshEngine(
                mesh=make_mesh((g["shards"],), ("data",)), capacity_log2=6,
                batch=8, table_log2=6, pop_log=128, telemetry=tel)

            def run():
                e.begin()
                adm = list(e.tick([60, 10, 30, 20, 50, 40, 35, 25],
                                  list(range(8)), slots=4, pages=5,
                                  need=[2] * 8))
                ticks = 1
                while e.occupancy() > 0 and ticks < 12:
                    adm += e.tick([], [], slots=4, pages=4)
                    ticks += 1
                return adm, ticks

            (adm, ticks), _, _, _ = self.mesh_run(K, run, "admission")
            st = e.heap_state()
            got = {"stats": [e.stats[k] for k in STATS]
                   + [e.stats["host_syncs"]], "ticks": ticks,
                   "admitted": adm,
                   "planes": digest(st.keys.cpu().numpy(),
                                    st.vals.cpu().numpy()),
                   "hist": digest(np.asarray(e.pop_history(), np.int32)),
                   "tel": tel_digest(tel)}
            want = {k: v for k, v in g.items() if k != "shards"}
            if got != want:
                raise AssertionError(f"{name}: {got}")
            out[name] = got
        return out

    def admission_stream(self, K, serving, make_mesh, shards):
        """ADM_TRAFFIC through ``ServingMeshEngine`` at ``shards`` heaps of
        2^ADM_CAP_LOG2: each arrival keyed 2 (seq + slack) + (0 urgent, 1
        else), slack 0 urgent and ADM_SLACK else (distinct keys), pages
        ceil((prompt + new) / ADM_PAGE_SIZE), ADM_SLOTS and ADM_PAGES a
        tick, then drain ticks until the heaps are empty.  Each tick's
        admitted list against a heapq EDF oracle over the same pending
        requests (the prefix that fits, stop at the first that does not):
        equal at one shard; at more, each request admitted once, no tick
        over its budgets, and the ticks that differ counted (in order, or
        in the set admitted).  CUDA events
        around each tick; ADM_PROFILED_TICKS ticks under the profiler
        count their copies to the host (and are left out of the times)."""
        import heapq
        np, torch = self.np, self.torch
        trace = serving.generate_trace(serving.TrafficConfig(**ADM_TRAFFIC))
        by_tick = {}
        for rid, a in enumerate(trace):
            by_tick.setdefault(a.tick, []).append(rid)
        need = [-(-(a.prompt_len + a.max_new_tokens) // ADM_PAGE_SIZE)
                for a in trace]
        e = serving.ServingMeshEngine(
            mesh=make_mesh((shards,), ("data",)), capacity_log2=ADM_CAP_LOG2,
            batch=ADM_BATCH, arity_log2=2, table_log2=ADM_TABLE_LOG2)
        e.begin()                                   # capture
        torch.cuda.synchronize()
        free = list(range(e.table))[::-1]
        rid_of, pend, done = {}, [], set()
        seq = t = differ = differ_set = peak = 0
        walls, spans, per_tick = [], [], []
        prof, copies = None, None
        K.reset_launches()
        while t < ADM_TRAFFIC["ticks"] or e.occupancy() > 0:
            if t > ADM_TRAFFIC["ticks"] + 64:
                raise AssertionError("admission stream: not drained")
            keys, idxs, needs = [], [], []
            for rid in by_tick.get(t, []):
                seq += 1
                urgent = trace[rid].priority == 0
                key = 2 * (seq + (0 if urgent else ADM_SLACK)) + (
                    0 if urgent else 1)
                idx = free.pop()
                rid_of[idx] = rid
                keys.append(key)
                idxs.append(idx)
                needs.append(need[rid])
                heapq.heappush(pend, (key, rid))
            slots, pages = ((ADM_SLOTS, ADM_PAGES)
                            if t < ADM_TRAFFIC["ticks"]
                            else (ADM_DRAIN_SLOTS, ADM_DRAIN_PAGES))
            if t == 100:
                prof = self.profile()
                prof.__enter__()
            r0 = e.stats["rounds"]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            adm = e.tick(keys, idxs, slots=slots, pages=pages, need=needs)
            end.record()
            end.synchronize()
            if prof is None or copies is not None:
                walls.append(time.perf_counter() - t0)
                spans.append(start.elapsed_time(end) / 1e3)
            per_tick.append(e.stats["rounds"] - r0)
            if t == 100 + ADM_PROFILED_TICKS - 1:
                prof.__exit__(None, None, None)
                copies = readbacks(prof)
            got = [rid_of.pop(i) for i in adm]
            free.extend(adm)
            # the oracle: the EDF prefix of the same pending requests
            want, left = [], pages
            while pend:
                key, rid = pend[0]
                if rid in done:
                    heapq.heappop(pend)
                    continue
                if len(want) >= slots or need[rid] > left:
                    break
                left -= need[rid]
                want.append(heapq.heappop(pend))
            if got != [r for _, r in want]:
                if shards == 1:
                    raise AssertionError(
                        f"admission stream, 1 shard, tick {t}: {got[:8]} "
                        f"!= oracle {[r for _, r in want][:8]}")
                differ += 1
                differ_set += set(got) != {r for _, r in want}
            gs = set(got)
            if len(got) > slots or sum(need[r] for r in got) > pages or \
                    done & gs or len(gs) != len(got):
                raise AssertionError(f"admission stream, {shards} shards, "
                                     f"tick {t}: over budget or readmitted")
            for item in want:
                if item[1] not in gs:
                    heapq.heappush(pend, item)
            done |= gs
            peak = max(peak, e.occupancy())
            t += 1
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        path = self.launches["admission"]
        for k, v in launches.items():
            path[k] = path.get(k, 0) + v
        st = e.stats
        if len(done) != len(trace) or st["host_syncs"] != t:
            raise AssertionError(
                f"admission stream, {shards} shards: {len(done)} of "
                f"{len(trace)} admitted, {st['host_syncs']} readbacks in "
                f"{t} ticks")
        if copies != ADM_PROFILED_TICKS:
            raise AssertionError(f"admission stream: {copies} copies to "
                                 f"the host in {ADM_PROFILED_TICKS} ticks")
        if launches.get("heap_apply_grid", 0) != 2 * st["rounds"] + sum(
                1 for x in by_tick if x < t):
            raise AssertionError(f"admission stream: heap_apply_grid "
                                 f"launched {launches.get('heap_apply_grid')}"
                                 f" times in {st['rounds']} rounds")
        timed = len(walls)
        return {"shards": shards, "ticks": t, "requests": len(trace),
                "peak_backlog": peak, "rounds": st["rounds"],
                "processed": st["processed"], "spawned": st["spawned"],
                "max_occupancy": st["max_occupancy"],
                "readbacks": st["host_syncs"],
                "readbacks_per_tick": st["host_syncs"] / t,
                "profiled_ticks": ADM_PROFILED_TICKS,
                "copies_to_host_in_profiled_ticks": copies,
                "ticks_differing_from_oracle": differ,
                "ticks_admitting_another_set": differ_set,
                "timed_ticks": timed, "run_s": sum(walls),
                "us_per_tick": sum(walls) / timed * 1e6,
                "rounds_per_tick": st["rounds"] / t,
                "rounds_per_tick_max": max(per_tick),
                "device_span_s": sum(spans),
                "device_us_per_tick": sum(spans) / timed * 1e6,
                "device_us_per_round": (sum(spans) / sum(
                    r for i, r in enumerate(per_tick)
                    if not 100 <= i < 100 + ADM_PROFILED_TICKS) * 1e6),
                "launches": launches, "round_graph": graph_nodes(e)}

    def admission_path(self, K, serving, models, configs):
        """Phase admission: (a) the serving goldens, (b) the tick stream at
        one and four shards, (c) phase 8's granite-moe serve again with
        ``admission="device"``: its schedule equal to the EDF serve's."""
        from repro_torch import obs
        from repro_torch.distributed import make_mesh
        t0 = time.perf_counter()
        info = {"phase": "admission",
                "golden": self.admission_golden(K, serving, obs, make_mesh),
                "stream": {f"shards_{s}": self.admission_stream(
                    K, serving, make_mesh, s) for s in (1, 4)},
                "traffic": ADM_TRAFFIC,
                "engine": {"capacity_log2": ADM_CAP_LOG2,
                           "batch": ADM_BATCH, "table_log2": ADM_TABLE_LOG2,
                           "arity": 4, "slots": ADM_SLOTS,
                           "pages": ADM_PAGES, "page_size": ADM_PAGE_SIZE}}
        cfg, params, edf = self.keep["serve"]
        self.serve_run(serving, cfg, params, self.dev,
                       admission="device")             # warm-up
        K.reset_launches()
        eng, metrics, serve_s = self.serve_run(serving, cfg, params, self.dev,
                                               admission="device")
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        path = self.launches["admission"]
        for k, v in launches.items():
            path[k] = path.get(k, 0) + v
        keys = ("completed", "decode_steps", "admitted", "tokens_out")
        if eng.admission_log != edf["admission_log"] or \
                [metrics[k] for k in keys] != [edf["metrics"][k]
                                               for k in keys]:
            raise AssertionError(f"admission serve: {metrics} "
                                 f"{eng.admission_log} != EDF {edf}")
        info["serve"] = {"arch": cfg.name, "metrics": metrics,
                         "admission_log": eng.admission_log,
                         "run_s": serve_s,
                         "admission_ticks": eng._device.stats["host_syncs"],
                         "readbacks": eng.host_syncs
                         + eng._device.stats["host_syncs"],
                         "launches": launches, "equals_edf_serve": True}
        for name in ("heap_apply_grid", "device_loop", "expert_tickets"):
            if not self.launches["admission"].get(name):
                raise AssertionError(f"admission: {name} never launched")
        info["launches"] = self.launches["admission"]
        info["seconds"] = time.perf_counter() - t0
        return info

    # -- phase runtime: the host task runtime and its consumers ----------

    def task_round_tree(self, K, core, rt):
        """(a) ``mesh_task_round`` on the card: the FIFO task tree drained
        one round at a time on a replicated ring that wraps 2^32, 4 shards
        x 1,024 claims a round (the masked waves B2b and B2a once each a
        round), against ``fifo_closure``.  A round claims the first
        min(occupancy after its publish, 4 x 1,024) lanes in shard order,
        computed on the card: a claim past the tail would burn its ticket
        (the reference's semantics), so none is made.  Its first
        RT_COMPARE_ROUNDS
        rounds in lockstep with the same rounds on the plain waves (the
        ring faces patched to ``ring_enqueue_plain`` /
        ``ring_dequeue_plain`` on the card), every state and output bit
        for bit."""
        np, torch = self.np, self.torch
        from repro_torch.core import distqueue
        vals = (np.random.default_rng(15).integers(0, 2 ** 27, RT_SEEDS)
                << 4).astype(np.int32)
        want_acc, want_p, want_s, _ = fifo_closure(np, vals)
        step = fifo_tree_step(torch)
        s = MESH_SHARDS
        lanes = torch.arange(s * BATCH, device=self.dev)

        def claims(st, sm):
            return (lanes < st.occupancy.long() + sm.sum()).reshape(s, BATCH)

        def start():
            st = core.dist_queue_init(RT_RING_CAP, start=RT_START,
                                     device=self.dev)
            sv = self.t(vals).reshape(s, -1)
            return st, sv, torch.ones_like(sv, dtype=torch.bool)

        def plain_faces():
            def enq(*a, **kw):
                out = K.ring_enqueue_plain(*(x.clone() for x in a[:4]),
                                           *a[4:], **kw)
                return (*out[:4], out[4].int())

            def deq(*a, **kw):
                out = K.ring_dequeue_plain(*(x.clone() for x in a[:4]),
                                           *a[4:], **kw)
                return (*out[:5], out[5].int())
            return enq, deq

        # the first rounds against the plain waves, in lockstep
        kern = start()
        plain = start()
        acc = torch.zeros(4096, dtype=torch.int32, device=self.dev)
        faces = (distqueue.enq_planes, distqueue.deq_planes)
        for r in range(RT_COMPARE_ROUNDS):
            st, sv, sm = kern
            claim = claims(st, sm)
            out_k = rt.mesh_task_round(st, sv, sm, claim)
            distqueue.enq_planes, distqueue.deq_planes = plain_faces()
            try:
                out_p = rt.mesh_task_round(plain[0], sv, sm, claim)
            finally:
                distqueue.enq_planes, distqueue.deq_planes = faces
            for a, b in zip((*out_k[0], *out_k[1:]), (*out_p[0], *out_p[1:])):
                if not torch.equal(a, b):
                    raise AssertionError(f"runtime mesh_task_round: round "
                                         f"{r} differs from the plain "
                                         f"waves")
            acc, cv, cm = step(acc, out_k[2].reshape(-1),
                               out_k[3].reshape(-1))
            kern = (out_k[0], cv.reshape(s, -1), cm.reshape(s, -1))
            plain = (out_p[0],) + kern[1:]

        # the drained run: the path's launches counted
        def run():
            st, sv, sm = start()
            acc = torch.zeros(4096, dtype=torch.int32, device=self.dev)
            lost = torch.zeros((), dtype=torch.int64, device=self.dev)
            pops = torch.zeros((), dtype=torch.int64, device=self.dev)
            pushes = torch.zeros((), dtype=torch.int64, device=self.dev)
            rounds = peak = 0
            while True:
                st, granted, cv, ok = rt.mesh_task_round(st, sv, sm,
                                                         claims(st, sm))
                lost += (sm & ~granted).sum()
                pushes += granted.sum()
                pops += ok.sum()
                acc, cv, cm = step(acc, cv.reshape(-1), ok.reshape(-1))
                sv, sm = cv.reshape(s, -1), cm.reshape(s, -1)
                rounds += 1
                # the round's one readback: occupancy and pending spawns
                occ, more = torch.stack([st.occupancy.long(),
                                         sm.any().long()]).tolist()
                peak = max(peak, occ)
                if occ == 0 and not more:
                    return st, acc, rounds, peak, lost, pops, pushes

        (st, acc, rounds, peak, lost, pops, pushes), got, run_s, span_s = \
            self.mesh_run(K, run, "runtime")
        pops, pushes = int(pops), int(pushes)
        if int(lost) or pops != want_p or pushes != want_p or \
                not np.array_equal(acc.cpu().numpy(), want_acc):
            raise AssertionError(f"runtime mesh_task_round: {pops} pops, "
                                 f"{pushes} published, {int(lost)} lost; "
                                 f"the closure {want_p} / {want_s}")
        for name in ("ring_enqueue_masked", "ring_dequeue_masked"):
            if got.get(name, 0) != rounds:
                raise AssertionError(f"runtime mesh_task_round: {name} "
                                     f"launched {got.get(name, 0)} times in "
                                     f"{rounds} rounds")
        head, tail = int(st.head) % 2 ** 32, int(st.tail) % 2 ** 32
        # the same run under the profiler: the card's busy time
        t0 = time.perf_counter()
        with self.profile() as prof:
            run()
            torch.cuda.synchronize()
        times = device_times(prof)
        busy_s = sum(times.values()) / 1e6
        return {"shards": s, "claims_a_round": BATCH, "seeds": RT_SEEDS,
                "ring_slots": 2 * RT_RING_CAP, "start": RT_START,
                "rounds": rounds, "pops": pops, "spawned": want_s,
                "peak_occupancy": peak, "head_tail": [head, tail],
                "wrapped": head < RT_START and tail < RT_START,
                "exactly_once": True,
                "plain_rounds_bit_identical": RT_COMPARE_ROUNDS,
                "run_s": run_s, "device_span_s": span_s,
                "device_us_per_round": span_s / rounds * 1e6,
                "pops_per_s": pops / run_s, "readbacks": rounds,
                "device_busy_s": busy_s, "idle_share": 1 - busy_s / run_s,
                "profile_s": time.perf_counter() - t0,
                "top_device_ms": top_ms(times, 6), "launches": got}

    def runtime_renders(self, K, raytrace):
        """(b) ``render_runtime`` on the card: both Fig. 7 scenes at
        RAY_W x RAY_H (tiles 4 x 4, 32 workers, 4 shards, stealing, G-LFQ,
        waves of RT_WAVE rays), each image and ray count bit-identical to
        phase raytrace's ``render_rounds``; cornell at RAY_SMALL^2 on each
        of the four queue algorithms, each image equal to
        ``render_rounds``' at that size.  One readback a task.  Beside
        each 1080p render, ``render_queue`` at the same tiles and wave
        (the same batches traced with no simulator), the same image."""
        np = self.np
        kw = dict(tx=RT_TILES, ty=RT_TILES, wave=RT_WAVE,
                  workers=RT_WORKERS, shards=MESH_SHARDS, steal=True,
                  device=self.dev)
        out = {}
        for name in ("complex", "cornell"):
            scene = getattr(raytrace, f"{name}_scene")()
            want, rays = self.keep.pop(f"ray_{name}")
            (img, info), got, run_s, span_s = self.mesh_run(
                K, lambda: raytrace.render_runtime(scene, RAY_W, RAY_H,
                                                   algo="glfq", **kw),
                "runtime")
            if info["rays"] != rays or not np.array_equal(img, want):
                raise AssertionError(
                    f"runtime render {name}: rays {info['rays']} vs "
                    f"{rays}, max |diff| "
                    f"{float(np.abs(img - want).max())}")
            # the same tile batches with no simulator: render_queue's host
            # tile queues at the same wave
            (qimg, qinfo), q_s, _ = self.timed(
                lambda: raytrace.render_queue(scene, RAY_W, RAY_H, RT_TILES,
                                              RT_TILES, RT_WAVE,
                                              device=self.dev))
            if not np.array_equal(qimg, want):
                raise AssertionError(f"runtime render {name}: render_queue "
                                     f"differs from render_rounds")
            out[name] = dict(info, algo="glfq", pixels=RAY_W * RAY_H,
                             run_s=run_s, device_span_s=span_s,
                             mrays_per_s=info["rays"] / run_s / 1e6,
                             readbacks=info["tasks"],
                             equals_render_rounds=True,
                             render_queue={"waves": qinfo["waves"],
                                           "run_s": q_s,
                                           "mrays_per_s": qinfo["rays"]
                                           / q_s / 1e6})
        want, rays = self.keep.pop(f"ray_cornell_{RAY_SMALL}")
        small = {}
        for algo in sorted(("glfq", "gwfq", "gwfq-ymc", "sfq")):
            (img, info), _, run_s, _ = self.mesh_run(
                K, lambda: raytrace.render_runtime(
                    raytrace.cornell_scene(), RAY_SMALL, RAY_SMALL,
                    algo=algo, **dict(kw, wave=256)), "runtime")
            if info["rays"] != rays or not np.array_equal(img, want):
                raise AssertionError(f"runtime render cornell "
                                     f"{RAY_SMALL}^2 {algo}: differs from "
                                     f"render_rounds")
            small[algo] = dict(info, run_s=run_s)
        out[f"cornell_{RAY_SMALL}"] = small
        return out

    def runtime_bfs(self, bfs):
        """(c) ``bfs_runtime`` on kron_like(4,096, avg_deg=6, seed=2), 32
        workers, each queue algorithm: dist equal to ``bfs_reference``.
        Host work: the simulated fabric touches no device."""
        np = self.np
        g = bfs.kron_like(RT_KRON_N, avg_deg=RT_KRON_DEG, seed=2)
        want = bfs.bfs_reference(g, 0)
        out = {"graph": g.name, "n": g.n, "m": g.m, "workers": RT_WORKERS}
        for algo in sorted(("glfq", "gwfq", "gwfq-ymc", "sfq")):
            t0 = time.perf_counter()
            dist, info = bfs.bfs_runtime(g, 0, algo=algo,
                                         workers=RT_WORKERS)
            wall = time.perf_counter() - t0
            if not np.array_equal(dist, want):
                raise AssertionError(f"runtime bfs {algo}: dist != "
                                     f"bfs_reference")
            out[algo] = dict(info, run_s=wall,
                             tasks_per_s=info["tasks"] / wall)
        return out

    def runtime_serve(self, K, serving, models):
        """(d) phase 8's granite-moe serve again at full width with
        ``admission="lanes"`` (the host task pool's strict lanes),
        requests RT_URGENT urgent: all complete, and the schedule (the
        admission log, every request's admit and finish ticks and the
        metrics) equals the port's CPU run of the same trace at the
        reduced width: it depends only on lengths, slots and pages."""
        torch = self.torch
        cfg, params, _ = self.keep.pop("serve")
        K.reset_launches()
        eng, metrics, serve_s = self.serve_run(
            serving, cfg, params, self.dev, admission="lanes",
            urgent=RT_URGENT)
        ticks = [(r.admit_tick, r.finish_tick) for r in self.requests]
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        path = self.launches["runtime"]
        for k, v in launches.items():
            path[k] = path.get(k, 0) + v
        small = cfg.reduced()
        gen = torch.Generator()
        gen.manual_seed(0)
        ceng, cmetrics, cpu_s = self.serve_run(
            serving, small, models.init_params(small, gen, device="cpu"),
            "cpu", admission="lanes", urgent=RT_URGENT)
        cticks = [(r.admit_tick, r.finish_tick) for r in self.requests]
        if metrics["completed"] != SERVE_REQUESTS or \
                eng.admission_log != ceng.admission_log or \
                ticks != cticks or metrics != cmetrics:
            raise AssertionError(f"runtime serve: card {metrics} "
                                 f"{eng.admission_log} {ticks} != CPU "
                                 f"{cmetrics} {ceng.admission_log} {cticks}")
        if set(eng.admission_log[:len(RT_URGENT)]) != set(RT_URGENT):
            raise AssertionError(f"runtime serve: the urgent lane did not "
                                 f"go first: {eng.admission_log}")
        return {"arch": cfg.name, "urgent": list(RT_URGENT),
                "metrics": metrics, "admission_log": eng.admission_log,
                "ticks": ticks, "run_s": serve_s,
                "tokens_out_per_s": metrics["tokens_out"] / serve_s,
                "readbacks": eng.host_syncs, "pool": eng.requests.metrics,
                "launches": launches,
                "cpu_reduced_run": {"run_s": cpu_s}, "equals_cpu": True}

    def runtime_path(self, K, raytrace, bfs, serving, models):
        """Phase runtime: (a) mesh_task_round, (b) render_runtime, (c)
        bfs_runtime, (d) the lanes serve."""
        from repro_torch import core
        from repro_torch import runtime as rt
        t0 = time.perf_counter()
        info = {"phase": "runtime",
                "mesh_task_round": self.task_round_tree(K, core, rt)}
        t1 = time.perf_counter()
        info["render"] = self.runtime_renders(K, raytrace)
        t2 = time.perf_counter()
        info["bfs"] = self.runtime_bfs(bfs)
        t3 = time.perf_counter()
        info["serve"] = self.runtime_serve(K, serving, models)
        info["part_s"] = {"mesh_task_round": t1 - t0, "render": t2 - t1,
                          "bfs": t3 - t2,
                          "serve": time.perf_counter() - t3}
        for name in ("ring_enqueue_masked", "ring_dequeue_masked",
                     "expert_tickets"):
            if not self.launches["runtime"].get(name):
                raise AssertionError(f"runtime: {name} never launched")
        info["launches"] = self.launches["runtime"]
        info["seconds"] = time.perf_counter() - t0
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
            reads = readbacks(prof)
            info[fn.__name__] = dict(
                st, run_s=wall, launches=launches, device_busy_s=busy,
                readbacks=reads, readbacks_per_level=reads / st["levels"],
                idle_share=1 - busy / wall,
                profile_s=time.perf_counter() - t0,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                top_device_ms=top_ms(times, 4))
            if fn is bfs.bfs_queue:
                # a fresh count per level, then the edge total and dist
                if reads > st["levels"] + 2:
                    raise AssertionError(f"{label}: bfs_queue read back "
                                         f"{reads} times in {st['levels']} "
                                         f"levels")
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

    def serve_run(self, serving, cfg, params, device, admission="edf",
                  urgent=()):
        """The request trace through a fresh ``ServingEngine`` with
        ``admission`` ("edf": the host pool; "device": the admission
        engine on the card; "lanes": the host task pool's strict lanes),
        the requests in ``urgent`` of the urgent class; the requests are
        kept in ``self.requests``."""
        eng = serving.ServingEngine(
            cfg, params, serving.EngineConfig(max_slots=4, page_size=32,
                                              num_pages=32, max_seq=64,
                                              admission=admission),
            device=device)
        self.requests = [
            serving.Request(rid=rid, prompt=prompt, max_new_tokens=SERVE_NEW,
                            priority=0 if rid in urgent else 1)
            for rid, prompt in enumerate(self.serve_trace())]
        for req in self.requests:
            if not eng.submit(req):
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
        # phase admission serves the same trace again on the card's
        # admission engine
        self.keep["serve"] = (cfg, params, {
            "admission_log": list(eng.admission_log),
            "metrics": dict(metrics)})

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

    # -- phase 9: gemma3-4b prefill at full width ---------------------------

    def gemma_path(self, K, configs, models):
        """gemma3-4b at full width prefills 2 x 4,096 tokens on the hd-256
        flash kernel in every layer; layers 0 (local, window 1,024) and 5
        (the first global one) are held against the plain attention on
        their own q/k/v.  Returns its line and those inputs."""
        torch = self.torch
        from repro_torch.models import layers
        cfg = configs.get_config(GEMMA_ARCH)
        t0 = time.perf_counter()
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(1)
        params = models.init_params(cfg, gen, device=self.dev)
        torch.cuda.synchronize()
        n_params = (sum(v.numel() for k, v in params.items() if k != "layers")
                    + sum(v.numel() for v in params["layers"].values()))
        if n_params != cfg.param_count():
            raise AssertionError(f"gemma: {n_params} parameters, the config "
                                 f"counts {cfg.param_count()}")
        info = {"phase": "prefill_gemma3", "arch": cfg.name,
                "params": n_params, "hd": cfg.hd,
                "window": cfg.sliding_window,
                "init_s": time.perf_counter() - t0}
        tokens = torch.as_tensor(self.np.random.default_rng(14).integers(
            0, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN)), device=self.dev)
        held = (0, 5)
        seen, calls = {}, [0]
        real_flash = layers.flash_attention

        def flash_spy(q, k, v, **kw):
            if calls[0] in held:
                seen[calls[0]] = (q, k, v, kw)
            calls[0] += 1
            return real_flash(q, k, v, **kw)

        models.prefill(params, tokens, cfg)            # warm-up
        torch.cuda.synchronize()
        layers.flash_attention = flash_spy
        try:
            K.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            logits, caches = models.prefill(params, tokens, cfg)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
        finally:
            layers.flash_attention = real_flash
        self.launches["prefill_gemma3"] = launches
        L = cfg.n_layers
        self.gemma_windows = [cfg.window_for_layer(i) for i in range(L)]
        if launches["flash_attention"] != L:
            raise AssertionError(f"gemma prefill: launches {launches}, "
                                 f"expected {L} flash_attention")
        if logits.shape != (PREFILL_BATCH, 1, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError("gemma prefill: last-token logits not "
                                 "finite")
        if caches["k"].shape != (L, PREFILL_BATCH, PREFILL_LEN,
                                 cfg.n_kv_heads, cfg.hd):
            raise AssertionError("gemma prefill: cache shape")
        for i in held:
            q, k, v, kw = seen[i]
            if kw["window"] != cfg.window_for_layer(i) or q.shape[-1] != 256:
                raise AssertionError(f"gemma layer {i}: {kw}, {q.shape}")
            self.flash_case(K, q, k, v, **kw)
        info["prefill"] = {
            "batch": PREFILL_BATCH, "prompt_len": PREFILL_LEN,
            "run_s": prefill_s,
            "tokens_per_s": PREFILL_BATCH * PREFILL_LEN / prefill_s,
            "launches": launches, "kernels_held_on_layers": list(held),
            "windows_held": [seen[i][3]["window"] for i in held],
            "logits_finite": True,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        t0 = time.perf_counter()
        with self.profile() as prof:
            models.prefill(params, tokens, cfg)
            torch.cuda.synchronize()
        times = device_times(prof)
        busy = sum(times.values()) / 1e6
        info["prefill"].update(device_busy_s=busy,
                               idle_share=1 - busy / prefill_s,
                               profile_s=time.perf_counter() - t0,
                               top_device_ms=top_ms(times, 6))
        return info, seen


def ring_launches(label, info, compacts):
    """The ring round's launches on a path: both wave kernels (and
    wave_compact where the child wave is wider than the ring) once a
    round; B1 and the standalone dequeue wave never, the standalone
    enqueue wave once, for the seed."""
    got, rounds = info["launches"], info["rounds"]
    want = {"ring_dequeue_wave": rounds, "ring_enqueue_wave": rounds,
            "wave_compact": rounds if compacts else 0, "wavefaa": 0,
            "ring_dequeue": 0, "ring_enqueue": 1}
    for name, n in want.items():
        if got.get(name, 0) != n:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{got.get(name, 0)} times in {rounds} "
                                 f"rounds, not {n}")


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


def readbacks(prof) -> int:
    """Copies from the card to the host that a profiler recorded."""
    from torch.autograd import DeviceType
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and e.name().startswith("Memcpy DtoH"))


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
    from repro_torch.apps import bfs, raytrace
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
    smoke.compare_ring_waves(K)
    smoke.compare_packed_waves(K)
    smoke.compare_compact(K, kron_lanes)
    smoke.compare_heap(K)
    smoke.compare_heap_rider(K)
    smoke.compare_heap_grid(K)
    smoke.compare_obs_record(K)
    smoke.compare_ring_masked(K)
    smoke.compare_grid_waves(K)
    smoke.compare_obs_mesh(K)
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

    # 3. main path: road BFS at full size, after the fifo_fanout golden
    fifo_info = smoke.fifo_golden(rt)
    dist, road_info = smoke.run_path("road", road, K, bfs)
    road_info["fifo_golden"] = fifo_info
    if not np.array_equal(dist, road_dist):
        raise AssertionError("road: dist != row + col")
    ring_launches("road", road_info, compacts=False)
    road_info["dist_exact"] = True
    emit_phase(road_info)
    smoke.launches["road"] = road_info["launches"]

    # 4. compaction path: kron BFS
    dist, kron_info = smoke.run_path("kron", kron, K, bfs)
    if not np.array_equal(dist, bfs.bfs_reference(kron, 0)):
        raise AssertionError("kron: dist != bfs_reference")
    ring_launches("kron", kron_info, compacts=True)
    kron_info["dist_exact"] = True
    emit_phase(kron_info)
    smoke.launches["kron"] = kron_info["launches"]

    # 5. priority path: the golden run, then the full-size task tree
    heap_info = smoke.heap_path(K, rt)
    emit_phase(heap_info)

    # 5b. observability: the goldens, road and the heap tree with
    # telemetry and spans, against phases 3 and 5
    obs_info = smoke.obs_path(K, rt, bfs, road, road_dist)
    emit_phase(obs_info)

    # mesh. the FIFO mesh: its goldens, the functional faces, road 215^2
    # and the task tree at 4 shards, against RingEngine and with obs on
    mesh_info = smoke.mesh_path(K, rt, bfs)
    emit_phase(mesh_info)

    # pmesh. the priority mesh: its goldens, SSSP on road 1024^2 and the
    # priority task tree at 4 shards, against PriorityRoundRunner and
    # with obs on
    pmesh_info = smoke.pmesh_path(K, rt, bfs)
    emit_phase(pmesh_info)

    # raytrace. the Fig. 7 scenes at 1920 x 1080 on the ring engine,
    # against render_compaction, and fused against legacy at 256^2
    ray_info = smoke.ray_path(K, raytrace)
    emit_phase(ray_info)

    # 6. queue-driven BFS on road 2048^2 and kron 2^20
    emit_phase(smoke.queue_path("road", road, K, bfs, road_dist))
    kron_q = smoke.queue_path("kron", qkron, K, bfs, qkron_dist)
    kron_q["setup_s"] = qkron_s
    emit_phase(kron_q)

    # 8. serving granite-moe-3b-a800m at full width
    serve_info, seen = smoke.serve_path(K, configs, models, serving)
    emit_phase(serve_info)

    # admission. device serving admission: the goldens, a backlogged
    # server's tick stream at 1 and 4 shards, granite's serve again
    adm_info = smoke.admission_path(K, serving, models, configs)
    emit_phase(adm_info)

    # runtime. the host task runtime and its consumers: mesh_task_round
    # on the card, render_runtime at 1920 x 1080, bfs_runtime, granite's
    # serve with admission="lanes"
    emit_phase(smoke.runtime_path(K, raytrace, bfs, serving, models))

    # 9. gemma3-4b prefill at full width (granite's weights are freed)
    torch.cuda.empty_cache()
    gemma_info, seen_gemma = smoke.gemma_path(K, configs, models)
    emit_phase(gemma_info)

    # 7. kernel times at the paths' shapes
    emit({"kernels": kernel_rows(smoke, K, road_info, kron_info, heap_info,
                                 (qkron, qkron_dist), seen, road,
                                 road_dist, seen_gemma, obs_info,
                                 mesh_info, pmesh_info, ray_info,
                                 adm_info)})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def kernel_rows(smoke, K, road, kron, heap, qkron, seen, road_g,
                road_dist, seen_gemma, obs_info, mesh_info, pmesh_info,
                ray_info, adm_info):
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
            rate=ALU_OPS_PER_S, excess=None):
        """``kern``/``plain``/``lib`` are (device_ms, wall_ms) pairs; ops
        are counted against ``rate``.  ``excess``: what the paths lose to
        the kernel beyond its bound, where each path's own shape gives it
        (else launches x (ms - bound_ms))."""
        b, by = bound(nbytes, ops, rate)
        by_path = {k: p.get(name, 0) for k, p in smoke.launches.items()}
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "excess_ms": (sum(by_path.values()) * (kern[0] - b)
                          if excess is None else excess),
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
    # and a wave of 2^22 lanes at the same density: 512 tiles ranked by
    # look-back on one kept scratch
    n1w = 1 << 22
    m1w = torch.as_tensor(rng.random(n1w) < dens1, device=dev)
    s1w = K.wavefaa_scratch(n1w, dev)
    wide1 = smoke.time_ms(lambda: None,
                          lambda a, i: K.wavefaa(m1w, c1, scratch=s1w))
    wide1_plain = smoke.time_ms(lambda: None,
                                lambda a, i: K.wavefaa_plain(m1w, c1))
    b1w, b1w_by = bound(n1w * 5 + 8, n1w, ALU_OPS_PER_S)
    row("wavefaa", csrc + "wavefaa.cu", "src/repro/kernels/wavefaa.py:29",
        smoke.time_ms(lambda: None, lambda a, i: K.wavefaa(m1, c1)),
        smoke.time_ms(lambda: None, lambda a, i: K.wavefaa_plain(m1, c1)),
        smoke.time_ms(lambda: None,
                      lambda a, i: torch.cumsum(m1, 0, dtype=torch.int32)),
        n1 * 1 + 4 + n1 * 4 + 4, n1,
        {"lanes": n1, "active": active1, "mask": "bool",
         "lanes_4194304": {"ms": wide1[0], "wall_ms": wide1[1],
                           "plain_ms": wide1_plain[0], "bound_ms": b1w,
                           "bound_by": b1w_by}})

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

    # the round's wave kernels at the paths' shapes: road's dequeue wave
    # (batch 1,024 on its 2^24-slot ring) and ballot enqueue wave (batch x
    # fanout lanes at the run's density), kron's dequeue wave on its
    # 2^18-slot ring and dense enqueue wave (the 2^17-lane compacted wave
    # holding the run's mean children a round).  Each launch consumes or
    # installs for real: the ring holds a dequeue wave's 50 batches, and
    # the enqueue waves never fill it.  No single PyTorch call runs a ring
    # wave.
    live = torch.ones((), dtype=torch.bool, device=dev)

    def ring_at(nsl2, fill):
        """[planes, head, tail] of a ring of 2^nsl2 slots holding
        ``fill`` values from ticket 2^nsl2 on."""
        n = 1 << nsl2
        planes = [torch.zeros(n, dtype=torch.int32, device=dev),
                  torch.ones(n, dtype=torch.int32, device=dev),
                  torch.zeros(n, dtype=torch.int32, device=dev),
                  torch.full((n,), IDX_BOT, dtype=torch.int32, device=dev)]
        if fill:
            K.ring_enqueue(*planes, torch.arange(n, n + fill,
                                                 dtype=torch.int32,
                                                 device=dev),
                           torch.arange(fill, dtype=torch.int32, device=dev),
                           n, nslots_log2=nsl2, idx_bot=IDX_BOT)
        return [planes, torch.tensor(n, dtype=torch.int32, device=dev),
                torch.tensor(n + fill, dtype=torch.int32, device=dev)]

    # the packed instances (spans on): the dequeue wave also writes each
    # lane's birth (4 B a lane), the enqueue wave reads the round clock
    # (4 B) and writes it into the flag word it writes anyway
    clock = torch.tensor(5000, dtype=torch.int32, device=dev)

    def deq_wave_times(nsl2, batch, packed=False):
        kw = dict(batch=batch, nslots_log2=nsl2, idx_bot=IDX_BOT,
                  birth_packed=packed)
        out = [smoke.time_ms(lambda: ring_at(nsl2, iters * batch),
                             lambda r, i: fn(*r[0], r[1], r[2], live, **kw),
                             iters=iters)
               for fn in (K.ring_dequeue_wave, K.ring_dequeue_wave_plain)]
        # per consuming lane three plane words in and one out, per lane
        # vals and ok out; head in and out, tail, live, k and the one
        # shard's pops
        return out + [batch * (12 + 4 + 4 + 1 + 4 * packed) + 21, batch]

    def enq_wave_times(nsl2, waves, nbytes, ops, packed=False):
        kw = dict(capacity=1 << (nsl2 - 1), nslots_log2=nsl2,
                  idx_bot=IDX_BOT, birth_round=clock if packed else None)
        return [smoke.time_ms(lambda: ring_at(nsl2, 0),
                              lambda r, i: fn(*r[0], r[1], r[2],
                                              waves[i][0], live,
                                              **waves[i][1], **kw),
                              iters=iters)
                for fn in (K.ring_enqueue_wave, K.ring_enqueue_wave_plain)] \
            + [nbytes + 4 * packed, ops]

    kron_nsl2 = kron["capacity"].bit_length()
    kron_child = kron["spawned"] // kron["rounds"]
    deq_kron = deq_wave_times(kron_nsl2, kron["batch"])
    deq_road = deq_wave_times(nsl2, b_deq)
    road_waves, road_child = [], 0
    for i in range(iters):
        m = torch.as_tensor(rng.random(b_enq) < dens1, device=dev)
        road_child += int(m.sum())
        road_waves.append((torch.as_tensor(rng.integers(
            0, 1 << 22, b_enq, dtype=np.int32), device=dev), {"mask": m}))
    road_child //= iters
    # the mask in; per child its value and three plane words in and four
    # out; head, tail in and out, live, total, over and the one shard's
    # pushes
    enq_road = enq_wave_times(nsl2, road_waves,
                              b_enq + road_child * 32 + 22, b_enq)
    kron_count = torch.tensor([kron_child], dtype=torch.int32, device=dev)
    kron_waves = [(torch.as_tensor(rng.integers(
        0, 1 << 16, (1, kron["capacity"]), dtype=np.int32), device=dev),
                   {"counts": kron_count})
                  for _ in range(iters)]
    # as above with the count in place of the mask
    enq_kron = enq_wave_times(kron_nsl2, kron_waves, kron_child * 32 + 25,
                              kron_child)
    # the packed instances at the same shapes: the spanned road run is the
    # path that launches them (kron runs no spans)
    deq_road_p = deq_wave_times(nsl2, b_deq, True)
    deq_kron_p = deq_wave_times(kron_nsl2, kron["batch"], True)
    enq_road_p = enq_wave_times(nsl2, road_waves,
                                b_enq + road_child * 32 + 22, b_enq, True)
    enq_kron_p = enq_wave_times(kron_nsl2, kron_waves, kron_child * 32 + 25,
                                kron_child, True)

    def wave_row(name, replaces, cells):
        """One row of the round's wave kernels from ``cells``: (key, the
        paths whose launches run at that shape, times as
        ``deq_wave_times`` gives them, shape) for each shape, the first
        the row's own and the rest under their keys; the launches of each
        cell's paths are charged at its own shape."""
        subs, excess = {}, 0.0
        for key, paths, t, shape in cells:
            b = bound(t[2], t[3], ALU_OPS_PER_S)
            excess += sum(smoke.launches[p].get(name, 0)
                          for p in paths) * (t[0][0] - b[0])
            subs[key] = dict(shape, ms=t[0][0], wall_ms=t[0][1],
                             plain_ms=t[1][0], bound_ms=b[0],
                             bound_by=b[1])
        t, shape = cells[0][2], cells[0][3]
        subs.pop(cells[0][0])
        row(name, csrc + "ring_slots.cu", replaces, t[0], t[1], None, t[2],
            t[3], dict(shape, **subs), excess=excess)

    # B3 wave_compact: the kron run's child wave, compacted to capacity
    n3 = kron["batch"] * kron["fanout"]
    width = kron["capacity"]
    dens3 = kron["spawned"] / (kron["rounds"] * n3)
    m3 = torch.as_tensor(rng.random(n3) < dens3, device=dev)
    p3 = (torch.as_tensor(rng.integers(0, 1 << 16, n3, dtype=np.int32),
                          device=dev),)
    active3 = int(m3.sum())
    scratch3 = K.compact_scratch(n3, dev)      # as the engine keeps it
    kern3 = smoke.time_ms(lambda: None, lambda a, i: K.wave_compact(
        m3, p3, width=width, scratch=scratch3))
    # mask in, the active lanes' values in, the dense planes and the count
    # out
    bytes3 = n3 * 1 + active3 * 4 + width * 4 + 4
    # the meshes' compactions, each at its own shape: a shard's child row
    # of 2,048 lanes (two children a claim of 1,024) into 2,048, at each
    # tree's child density, one plane (the FIFO mesh) or two (the
    # priority mesh's keys and vals)
    cells3 = {}
    for key, info, planes in (
            ("mesh", mesh_info["tree"]["replicated"], 1),
            ("pmesh", pmesh_info["tree"]["relaxed"], 2)):
        n = 2 * BATCH
        dens = info["spawned"] / (info["rounds"] * MESH_SHARDS * n)
        m = torch.as_tensor(rng.random(n) < dens, device=dev)
        pl = tuple(torch.as_tensor(rng.integers(0, 1 << 30, n,
                                                dtype=np.int32), device=dev)
                   for _ in range(planes))
        sc = K.compact_scratch(n, dev)
        act = int(m.sum())
        k = smoke.time_ms(lambda: None, lambda a, i: K.wave_compact(
            m, pl, width=n, scratch=sc))
        pk = smoke.time_ms(lambda: None,
                           lambda a, i: K.compact_planes(m, pl, width=n))
        b = bound(n + planes * (act * 4 + n * 4) + 4, n, ALU_OPS_PER_S)
        cells3[key] = {"lanes": n, "active": act, "width": n,
                       "planes": planes, "ms": k[0], "wall_ms": k[1],
                       "plain_ms": pk[0], "bound_ms": b[0], "bound_by": b[1],
                       "launches": smoke.launches[key].get("wave_compact",
                                                           0)}
    b3 = bound(bytes3, n3, ALU_OPS_PER_S)[0]
    row("wave_compact", csrc + "compact.cu",
        "src/repro/kernels/compact.py:94", kern3,
        smoke.time_ms(lambda: None,
                      lambda a, i: K.compact_planes(m3, p3, width=width)),
        smoke.time_ms(lambda: None,
                      lambda a, i: torch.cumsum(m3, 0, dtype=torch.int32)),
        bytes3, n3,
        {"lanes": n3, "active": active3, "width": width, "mask": "bool",
         **cells3},
        excess=smoke.launches["kron"].get("wave_compact", 0)
        * (kern3[0] - b3) + sum(c["launches"] * (c["ms"] - c["bound_ms"])
                                for c in cells3.values()))

    # B4 heap_apply: the priority path's batches on its 2^20-slot heap
    # holding half the run's peak occupancy: pop calls of 1,024 and insert
    # calls of 2,048 lanes at the run's child density, each timed on its
    # own (the row's ms is their mean).  The plain version is a host loop
    # over the planes copied off the card, so its time is wall time.  No
    # single PyTorch call maintains a heap.
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
        return [heap_k.clone(), heap_v.clone(), torch.tensor(occ, **card)]

    def heap_call(fn, batch):
        def launch(st, i):
            st[2] = fn(st[0], st[1], st[2], *batch, cap_log2=c4)[2]
        return launch

    # levels of a heap of `occ` nodes, those in the kernel's shared-memory
    # top, and those left in the global planes (L2-resident at 8 MB)
    levels4 = max(int(np.ceil(np.log(3 * occ + 1) / np.log(4))), 1)
    top4 = int(round(np.log(3 * K.heap_resident_max(2) + 1) / np.log(4)))
    l2_levels4 = max(levels4 - top4, 0)
    # bytes (see csrc/heap_batch.cu): the opcode of every lane in (4 B),
    # the key and val of each INSERT lane (8 B), results out (9 B a lane),
    # the size word each way; a pop reads the root and the last leaf and
    # scrubs the leaf's slot (24 B) and its leaf sifts down about `levels4`
    # levels, each reading 4 child keys and the winner's val and writing
    # one key + val (28 B); an applied insert reads a parent key and writes
    # its node (12 B).  Compares: 4 children per level on a pop's path.
    pop_bytes = BATCH * (4 + 9 + 24 + levels4 * 28) + 8
    ins_bytes = 2 * BATCH * (4 + 9) + n_act4 * (8 + 12) + 8
    # dependent chain: one serial thread; a pop's level costs at least one
    # shared-memory round trip in the top and one L2 round trip below it
    # (latencies from Luo et al., "Benchmarking and Dissecting the Nvidia
    # Hopper GPU Architecture", 2024: about 30 and 260 cycles at the boost
    # clock); an applied insert at least one shared-memory round trip for
    # its parent's key
    pop_chain_ms = BATCH * (top4 * SMEM_LATENCY_CYCLES
                            + l2_levels4 * L2_LATENCY_CYCLES) \
        / GPU_CYCLES_PER_S * 1e3
    ins_chain_ms = n_act4 * SMEM_LATENCY_CYCLES / GPU_CYCLES_PER_S * 1e3
    sub4 = {}
    for name, batch, nbytes, ops, chain in (
            ("pop", pops, pop_bytes, BATCH * levels4 * 4, pop_chain_ms),
            ("insert", inserts, ins_bytes, n_act4, ins_chain_ms)):
        kern = smoke.time_ms(heap_setup, heap_call(K.heap_apply, batch))
        plain = smoke.time_ms(heap_setup,
                              heap_call(K.heap_apply_plain, batch),
                              iters=2, reps=2)
        b, by = bound(nbytes, ops, ALU_OPS_PER_S)
        sub4[name] = {"ms": kern[0], "wall_ms": kern[1],
                      "plain_ms": plain[1], "bound_ms": b, "bound_by": by,
                      "chain_bound_ms": chain}
    row("heap_apply", csrc + "heap_batch.cu",
        "src/repro/kernels/heap_batch.py:47",
        ((sub4["pop"]["ms"] + sub4["insert"]["ms"]) / 2,
         (sub4["pop"]["wall_ms"] + sub4["insert"]["wall_ms"]) / 2),
        ((sub4["pop"]["plain_ms"] + sub4["insert"]["plain_ms"]) / 2,) * 2,
        None, (pop_bytes + ins_bytes) / 2,
        (BATCH * levels4 * 4 + n_act4) / 2,
        {"heap_slots": 1 << c4, "occupancy": occ, "levels": levels4,
         "levels_in_shared_memory": top4, "levels_in_l2": l2_levels4,
         "pop_lanes": BATCH, "insert_lanes": 2 * BATCH,
         "insert_active": n_act4, "plain_ms_is": "wall (host loop)",
         "ms_is": "mean of a pop call and an insert call",
         "pop": sub4["pop"], "insert": sub4["insert"],
         "chain_bound_ms": (pop_chain_ms + ins_chain_ms) / 2})

    # B4's rider instance (spans on): the same batches with a rider plane
    # of zeros and the inserts' rider one device word, as the spanned
    # priority round runs it; its shared-memory top is one level shorter
    # (levels 0-6 of the 4-ary heap).  Bytes: the rider-less call's plus,
    # per pop, the root's and the last leaf's riders, the scrub, the
    # popped rider out and per level the winner's rider read and written
    # (16 + 8 B a level), per applied insert its rider written and its
    # parent's moved (8 B), and the clock word.
    heap_r = torch.zeros(1 << c4, **card)
    clock4 = torch.tensor(3, **card)
    top4r = int(round(np.log(3 * K.heap_resident_max(2, rider=True) + 1)
                      / np.log(4)))
    l2_levels4r = max(levels4 - top4r, 0)
    pop_bytes_r = pop_bytes + BATCH * (16 + levels4 * 8) + 4
    ins_bytes_r = ins_bytes + n_act4 * 8 + 4
    pop_chain_r = BATCH * (top4r * SMEM_LATENCY_CYCLES
                           + l2_levels4r * L2_LATENCY_CYCLES) \
        / GPU_CYCLES_PER_S * 1e3

    def rider_setup():
        return heap_setup() + [heap_r.clone()]

    def rider_call(fn, batch):
        def launch(st, i):
            st[2] = fn(st[0], st[1], st[2], *batch, cap_log2=c4,
                       rider=st[3], oprider=clock4)[2]
        return launch

    sub4r = {}
    for name, batch, nbytes, ops, chain in (
            ("pop", pops, pop_bytes_r, BATCH * levels4 * 4, pop_chain_r),
            ("insert", inserts, ins_bytes_r, n_act4, ins_chain_ms)):
        kern = smoke.time_ms(rider_setup, rider_call(K.heap_apply, batch))
        plain = smoke.time_ms(rider_setup,
                              rider_call(K.heap_apply_plain, batch),
                              iters=2, reps=2)
        b, by = bound(nbytes, ops, ALU_OPS_PER_S)
        sub4r[name] = {"ms": kern[0], "wall_ms": kern[1],
                       "plain_ms": plain[1], "bound_ms": b, "bound_by": by,
                       "chain_bound_ms": chain,
                       "riderless_ms": sub4[name]["ms"]}
    row("heap_apply_rider", csrc + "heap_batch.cu",
        "src/repro/kernels/heap_batch.py:47 with heap_planes(rider=) "
        "(:183-296)",
        ((sub4r["pop"]["ms"] + sub4r["insert"]["ms"]) / 2,
         (sub4r["pop"]["wall_ms"] + sub4r["insert"]["wall_ms"]) / 2),
        ((sub4r["pop"]["plain_ms"] + sub4r["insert"]["plain_ms"]) / 2,) * 2,
        None, (pop_bytes_r + ins_bytes_r) / 2,
        (BATCH * levels4 * 4 + n_act4) / 2,
        {"heap_slots": 1 << c4, "occupancy": occ, "levels": levels4,
         "levels_in_shared_memory": top4r, "levels_in_l2": l2_levels4r,
         "pop_lanes": BATCH, "insert_lanes": 2 * BATCH,
         "insert_active": n_act4, "plain_ms_is": "wall (host loop)",
         "ms_is": "mean of a pop call and an insert call",
         "pop": sub4r["pop"], "insert": sub4r["insert"],
         "riderless_ms": (sub4["pop"]["ms"] + sub4["insert"]["ms"]) / 2,
         "chain_bound_ms": (pop_chain_r + ins_chain_ms) / 2})

    # B4 over a shard grid (phase pmesh): one launch of S blocks, a heap a
    # block, each heap's top in its block's shared memory.  Heaps are
    # filled with keys below the tree's horizon by one insert wave, then
    # each call is a pop wave (``counts`` a shard) or an insert wave (the
    # run's child density over the gathered lanes, child rank r to heap r
    # % S), on a state that flows from call to call.  Bytes as for
    # heap_apply, per heap: a pop wave's counts word and results (9 B a
    # lane), per pop the root, the last leaf and its scrub (24 B) and per
    # level 28 B; an insert wave's destinations (4 B a lane), per
    # installed child its key and val (8 B) and 12 B; the size words each
    # way.  Chain bound: the blocks run side by side, so a wave's chain is
    # its busiest heap's (pops x levels at their latencies, or inserts x
    # a shared-memory round trip).
    def grid_levels(occ_h, rider):
        lv = max(int(np.ceil(np.log(3 * occ_h + 1) / np.log(4))), 1)
        top = int(round(np.log(3 * K.heap_resident_max(2, rider=rider) + 1)
                        / np.log(4)))
        return lv, min(lv, top), max(lv - top, 0)

    def grid_heaps(s, occ_h, c, rider):
        keys = torch.full((s, 1 << c), KEY_INF, **card)
        vals = torch.full((s, 1 << c), -1, **card)
        rid = torch.zeros((s, 1 << c), **card) if rider else None
        sizes = torch.zeros(s, **card)
        n = s * occ_h
        seed = torch.as_tensor(rng.integers(0, HEAP_HORIZON, n,
                                            dtype=np.int32), device=dev)
        K.heap_apply_grid(keys, vals, sizes, opkeys=seed, opvals=seed,
                          dest=torch.arange(n, **card) % s, cap_log2=c,
                          rider=rid, oprider=torch.zeros((), **card))
        return [keys, vals, sizes, rid]

    def grid_insert_wave(s, lanes, dens):
        act = rng.random(lanes) < dens
        rank = np.cumsum(act) - act
        dest = np.where(act, rank % s, -1).astype(np.int32)
        return (dict(opkeys=torch.as_tensor(rng.integers(
                    0, HEAP_HORIZON + 4, lanes, dtype=np.int32), device=dev),
                     opvals=torch.as_tensor(rng.integers(
                         0, 1 << 30, lanes, dtype=np.int32), device=dev),
                     dest=torch.as_tensor(dest, device=dev)), int(act.sum()))

    def grid_times(s, occ_h, c, rider, waves, iters):
        """(kernel, plain) (device ms, wall ms) a call of ``waves`` taken
        in turn, on ``s`` heaps of ``occ_h`` nodes."""
        base = grid_heaps(s, occ_h, c, rider)
        clock = torch.tensor(7, **card)

        def setup():
            return [None if x is None else x.clone() for x in base]

        def call(fn):
            def launch(st, i):
                w = waves[i % len(waves)]
                extra = {} if "counts" in w or not rider else {
                    "oprider": clock}
                fn(st[0], st[1], st[2], rider=st[3], cap_log2=c, **w,
                   **extra)
            return launch
        return (smoke.time_ms(setup, call(K.heap_apply_grid), iters=iters),
                smoke.time_ms(setup, call(K.heap_apply_grid_plain),
                              iters=2, reps=2))

    def grid_cell(s, occ_h, c, rider, pops, lanes, dens, iters=40):
        """One shape: a pop wave of ``pops`` a heap and an insert wave of
        ``lanes`` at ``dens``, each timed on its own (the cell's ms is
        their mean), with their bounds."""
        lv, top, l2 = grid_levels(occ_h, rider)
        ins_w, n_act = grid_insert_wave(s, lanes, dens)
        pop_w = dict(counts=torch.full((s,), pops, **card), batch=pops)
        pop_b = s * (pops * (9 + 24 + lv * 28) + 8) + (16 + lv * 8) * (
            s * pops if rider else 0)
        ins_b = lanes * 4 + n_act * (8 + 12 + 8 * rider) + 8 * s
        pop_chain = pops * (top * SMEM_LATENCY_CYCLES
                            + l2 * L2_LATENCY_CYCLES) / GPU_CYCLES_PER_S * 1e3
        ins_chain = (-(-n_act // s) * SMEM_LATENCY_CYCLES
                     / GPU_CYCLES_PER_S * 1e3)
        cell = {"shards": s, "heap_slots": 1 << c, "occupancy_a_heap": occ_h,
                "levels": lv, "levels_in_shared_memory": top,
                "levels_in_l2": l2, "pops_a_heap": pops,
                "insert_lanes": lanes, "insert_active": n_act,
                "rider": rider}
        for name, w, nb, ops, chain, it in (
                ("pop", pop_w, pop_b, s * pops * lv * 4, pop_chain,
                 max(2, min(iters, occ_h // max(pops, 1) - 1))),
                ("insert", ins_w, ins_b, n_act, ins_chain, iters)):
            kern, plain = grid_times(s, occ_h, c, rider, [w], it)
            b, by = bound(nb, ops, ALU_OPS_PER_S)
            cell[name] = {"ms": kern[0], "wall_ms": kern[1],
                          "plain_ms": plain[1], "bound_ms": b,
                          "bound_by": by, "chain_bound_ms": chain,
                          "bytes": nb, "calls": it}
        cell["ms"] = (cell["pop"]["ms"] + cell["insert"]["ms"]) / 2
        cell["wall_ms"] = (cell["pop"]["wall_ms"]
                           + cell["insert"]["wall_ms"]) / 2
        cell["plain_ms"] = (cell["pop"]["plain_ms"]
                            + cell["insert"]["plain_ms"]) / 2
        cell["bound_ms"] = (cell["pop"]["bound_ms"]
                            + cell["insert"]["bound_ms"]) / 2
        cell["bytes"] = (pop_b + ins_b) / 2
        cell["ops"] = (s * pops * lv * 4 + n_act) / 2
        cell["chain_bound_ms"] = (pop_chain + ins_chain) / 2
        return cell

    def run_shape(run, s):
        """(occupancy a heap at half the run's peak, pops a heap a round,
        child density) of a pmesh run at ``s`` heaps."""
        return (max(run["max_occupancy"] // (2 * s), 1),
                max(run["processed"] // (run["rounds"] * s), 1))

    def grid_row(name, replaces, cells, note):
        """A row whose ms, bound and plain are its first cell's; the paths
        lose launches x (ms - bound) at each cell's own shape."""
        excess, subs = 0.0, {}
        for key, launches, cell in cells:
            excess += launches * (cell["ms"] - cell["bound_ms"])
            subs[key] = dict(cell, launches=launches)
        first = cells[0][2]
        row(name, csrc + "heap_batch.cu", replaces,
            (first["ms"], first["wall_ms"]), (first["plain_ms"],) * 2, None,
            first["bytes"], first["ops"],
            dict({k: v for k, v in first.items()},
                 plain_ms_is="wall (host loop)",
                 ms_is="mean of a pop wave and an insert wave",
                 cells={k: v for k, v in subs.items()}, excess_note=note),
            excess=excess)

    pt, ps = pmesh_info["tree"], pmesh_info["sssp"]
    s_m = MESH_SHARDS
    tree_lanes = 2 * s_m * BATCH            # two children a pop
    rel = pt["relaxed"]
    occ_r, _ = run_shape(rel, s_m)
    dens_t = rel["spawned"] / (rel["rounds"] * tree_lanes)
    tree_cell = grid_cell(s_m, occ_r, c4, False, BATCH, tree_lanes, dens_t)
    strict = pt["strict"]
    occ_s, _ = run_shape(strict, 1)
    strict_cell = grid_cell(1, occ_s, c4, False, s_m * BATCH, tree_lanes,
                            dens_t, iters=20)
    # one heap of the relaxed tree's occupancy popped 1,024 by the grid at
    # S = 1 and by heap_apply (the single heap's kernel): what the relaxed
    # pop wave costs beside one shard's call, in this call
    one = grid_cell(1, occ_r, c4, False, BATCH, tree_lanes // s_m, dens_t)
    base1 = grid_heaps(1, occ_r, c4, False)
    pops1 = (torch.ones(BATCH, **card), torch.full((BATCH,), KEY_INF, **card),
             torch.full((BATCH,), -1, **card))
    single_pop = smoke.time_ms(
        lambda: [base1[0][0].clone(), base1[1][0].clone(),
                 base1[2][0].clone()],
        heap_call(K.heap_apply, pops1), iters=40)
    tree_cell["one_shard_pop_ms"] = one["pop"]["ms"]
    tree_cell["one_shard_heap_apply_pop_ms"] = single_pop[0]
    # heap_apply's launches on the pmesh path (PriorityRoundRunner at
    # 4,096 lanes beside the strict mesh) lose what the strict cell's one
    # heap loses, not what the heap path's 1,024-pop batches do
    heap_row = next(r for r in rows if r["name"] == "heap_apply")
    n_pm = smoke.launches["pmesh"].get("heap_apply", 0)
    heap_row["excess_ms"] += n_pm * (
        (strict_cell["ms"] - strict_cell["bound_ms"])
        - (heap_row["ms"] - heap_row["bound_ms"]))
    heap_row["shape"]["pmesh_launches_charged_at"] = "tree_strict"
    tree_launch = lambda r: r["launches"].get(  # noqa: E731
        "heap_apply_grid", 0)
    # the admission streams (phase admission): heaps of 2^ADM_CAP_LOG2 at
    # half the stream's peak backlog a heap, its mean pops a heap a round
    # and one child lane a claim lane at its re-entry density; the ticks'
    # arrival waves are charged at the same shape
    adm_cells = []
    for key, st in adm_info["stream"].items():
        s_a = st["shards"]
        lanes_a = s_a * ADM_BATCH
        adm_cells.append((f"admission_{key}", tree_launch(st), grid_cell(
            s_a, max(st["peak_backlog"] // (2 * s_a), 1), ADM_CAP_LOG2,
            False, max(st["processed"] // (st["rounds"] * s_a), 1),
            lanes_a, st["spawned"] / (st["rounds"] * lanes_a))))
    grid_row("heap_apply_grid", "src/repro/kernels/heap_batch.py:47 "
             "(heap_pop_count / heap_insert_masked on each shard's heap, "
             ":299, :314)",
             [("tree_relaxed", tree_launch(rel) + tree_launch(
                 rel["compact"]), tree_cell),
              ("tree_strict", tree_launch(strict), strict_cell)]
             + adm_cells,
             "the goldens' and the device-admission serve's launches are "
             "not charged")
    # the rider instance: SSSP's split payload (4 heaps of 2^20 at the
    # run's occupancy, its mean pops a heap, 16,384 insert lanes) and the
    # spanned tree (births on the rider)
    srel, sstr = ps["relaxed"], ps["strict"]
    fan = 4
    lanes_s = s_m * BATCH * fan
    occ_q, pops_q = run_shape(srel, s_m)
    occ_q = max(occ_q, 2 * pops_q)
    sssp_cell = grid_cell(s_m, occ_q, int(np.log2(srel["heap_slots"])),
                          True, pops_q, lanes_s,
                          srel["spawned"] / (srel["rounds"] * lanes_s))
    occ_q1, pops_q1 = run_shape(sstr, 1)
    occ_q1 = max(occ_q1, 2 * pops_q1)
    sssp_strict_cell = grid_cell(1, occ_q1, int(np.log2(sstr["heap_slots"])),
                                 True, pops_q1, lanes_s,
                                 sstr["spawned"] / (sstr["rounds"]
                                                    * lanes_s), iters=20)
    obs_tree_cell = grid_cell(s_m, occ_r, c4, True, BATCH, tree_lanes,
                              dens_t)
    rider_launch = lambda r: r["launches"].get(  # noqa: E731
        "heap_apply_grid_rider", 0)
    grid_row("heap_apply_grid_rider", "src/repro/kernels/heap_batch.py:47 "
             "with heap_planes(rider=, oprider=) (:183-296), on each "
             "shard's heap", [
                 ("sssp_relaxed", rider_launch(srel), sssp_cell),
                 ("sssp_strict", rider_launch(sstr), sssp_strict_cell),
                 ("tree_obs", rider_launch(pt["obs"]), obs_tree_cell)],
             "every launch charged at its run's shape")

    # obs_record (not a TPU kernel: the reference's XLA fuses the record
    # into its round): one spanned road round's record, 1,024 lanes of
    # which the run's mean claim count are valid, a trace plane of 8,192
    # rows and spans of 16 buckets, births up to 4,000 rounds back.
    # Bytes, as the function needs them on these inputs: valid for every
    # lane (1 B); for each valid lane its key and birth in (8 B) and its
    # bucket and max-wait words read and written (16 B); once: ref[0]
    # (4 B), the trace row out (32 B), its cursor and the clock each way
    # (16 B), the round's k, total, occ and over in (13 B), the flow row
    # out (16 B) and its cursor each way (8 B).  No PyTorch call records
    # a round.
    from repro_torch.obs import (obs_record, obs_record_plain, span_init,
                                 trace_init)
    k_obs = road["processed"] // road["rounds"]
    valid_o = torch.arange(BATCH, device=dev) < k_obs
    wave_o = dict(
        keys=torch.as_tensor(rng.integers(0, 1 << 22, BATCH,
                                          dtype=np.int32), device=dev),
        valid=valid_o,
        births=torch.as_tensor(rng.integers(1000, 5000, BATCH,
                                            dtype=np.int32), device=dev),
        k=torch.tensor(k_obs, **card), total=torch.tensor(k_obs, **card),
        occ=torch.tensor(1 << 20, **card),
        over=torch.zeros((), dtype=torch.bool, device=dev))
    wave_o["ref"] = wave_o["keys"]

    def obs_setup():
        sp = span_init(1, lanes=BATCH, device=dev)
        sp.round.fill_(5000)
        return (trace_init(OBS_ROAD_CAPACITY, device=dev), sp)

    nbytes_o = BATCH * 1 + k_obs * (8 + 16) + 4 + 32 + 16 + 13 + 16 + 8
    row("obs_record", csrc + "obs_record.cu",
        "src/repro/runtime/enginecore.py:312-319 (fused_loop: "
        "trace_record) and src/repro/runtime/fusedrounds.py:227-230 "
        "(span_record, span_tick); no pallas_call",
        smoke.time_ms(obs_setup, lambda p, i: obs_record(*p, **wave_o)),
        smoke.time_ms(obs_setup,
                      lambda p, i: obs_record_plain(*p, **wave_o)),
        None, nbytes_o, BATCH,
        {"lanes": BATCH, "valid": k_obs, "trace_capacity":
         OBS_ROAD_CAPACITY, "classes": 1, "buckets": 16, "flows": 64})

    # the mesh's instances (phase mesh), at the task tree's shapes: 4
    # shards x batch 1,024, a 2^23-slot ring (four of 2^21 sharded), the
    # tree's mean claim and child density.  Each call consumes or installs
    # for real at successive tickets.  No single PyTorch call runs a ring
    # wave or records a round.
    tree = mesh_info["tree"]["replicated"]
    s_m, lanes_m = MESH_SHARDS, MESH_SHARDS * BATCH
    nsl2_m = MESH_TREE_CAP_LOG2 + 1
    pops_m = tree["processed"] // tree["rounds"]
    child_lanes_m = lanes_m * 2
    dens_m = tree["spawned"] / (tree["rounds"] * child_lanes_m)

    def grid_ring(sharded, fill):
        """[planes, heads, tails] of the tree's rings holding ``fill``
        values (each ring, sharded) from ticket 2^nsl2 on."""
        nsl2 = nsl2_m - (2 if sharded else 0)
        n = 1 << nsl2
        lead = (s_m,) if sharded else ()
        planes = [torch.zeros(lead + (n,), **card),
                  torch.ones(lead + (n,), **card),
                  torch.zeros(lead + (n,), **card),
                  torch.full(lead + (n,), IDX_BOT, **card)]
        for r in range(s_m if sharded else 1):
            rows = [p[r] for p in planes] if sharded else planes
            if fill:
                K.ring_enqueue(*rows, torch.arange(n, n + fill, **card),
                               torch.arange(fill, **card), n,
                               nslots_log2=nsl2, idx_bot=IDX_BOT)
        heads = torch.full(lead, n, **card)
        return [planes, heads, heads + fill]

    def mesh_deq_times(sharded, packed=False):
        nsl2 = nsl2_m - (2 if sharded else 0)
        kw = dict(batch=BATCH, nslots_log2=nsl2, idx_bot=IDX_BOT,
                  birth_packed=packed, shards=None if sharded else s_m)
        fill = iters * (BATCH if sharded else lanes_m)
        rings = s_m if sharded else 1
        # per consuming lane three plane words in and one out, per lane
        # vals and ok out; head and tail (each ring's) in, head out, live,
        # k and the shards' pops out
        return [smoke.time_ms(lambda: grid_ring(sharded, fill),
                              lambda r, i: fn(*r[0], r[1], r[2], live, **kw),
                              iters=iters)
                for fn in (K.ring_dequeue_wave, K.ring_dequeue_wave_plain)] \
            + [pops_m * 16 + lanes_m * (5 + 4 * packed) + 12 * rings + 4
               + 1 + 4 * s_m, lanes_m]

    m_waves = [(torch.as_tensor(rng.integers(0, 1 << 30, child_lanes_m,
                                             dtype=np.int32), device=dev),
                torch.as_tensor(rng.random(child_lanes_m) < dens_m,
                                device=dev)) for _ in range(iters)]
    child_m = int(sum(int(m.sum()) for _, m in m_waves)) // iters

    def mesh_enq_times(sharded, packed=False):
        nsl2 = nsl2_m - (2 if sharded else 0)
        kw = dict(capacity=1 << (nsl2 - 1), nslots_log2=nsl2,
                  idx_bot=IDX_BOT, shards=None if sharded else s_m,
                  birth_round=clock if packed else None)
        rings = s_m if sharded else 1
        # the mask in; per child its value and three plane words in and
        # four out; head, tail (each ring's) in, tail out, live, total,
        # over and the shards' pushes
        return [smoke.time_ms(lambda: grid_ring(sharded, 0),
                              lambda r, i: fn(*r[0], r[1], r[2],
                                              m_waves[i][0], live,
                                              mask=m_waves[i][1], **kw),
                              iters=iters)
                for fn in (K.ring_enqueue_wave, K.ring_enqueue_wave_plain)] \
            + [child_lanes_m + child_m * 32 + 4 * packed + 12 * rings + 6
               + 4 * s_m, child_lanes_m]

    def mesh_shape(wave, sharded, packed=False):
        ring_slots = (1 << (nsl2_m - 2 * sharded)) * (s_m if sharded else 1)
        if wave == "deq":
            return {"shards": s_m, "batch": BATCH, "claims": pops_m,
                    "ring_slots": ring_slots,
                    "births": "out" if packed else None,
                    "with": "src/repro/core/distqueue.py:" + (
                        "663 (dist_sharded_claim_round)" if sharded else
                        "428 (dist_claim_round)")}
        return {"shards": s_m, "mode": "ballot", "lanes": child_lanes_m,
                "children": child_m, "ring_slots": ring_slots,
                "birth_round": int(clock) if packed else None,
                "with": "src/repro/core/distqueue.py:" + (
                    "689 (dist_sharded_publish_round)" if sharded else
                    "296 (dist_publish_round)")}

    # the round's two wave kernels: one row an instance, at road's shape
    # (the row's own; the spanned road run's for the packed instances),
    # kron's (``kron``) and the mesh tree's (``mesh``; the sharded
    # instances have no other)
    wave_row("ring_dequeue_wave", "src/repro/kernels/ring_slots.py:184", [
        ("road", ("road",), deq_road,
         {"batch": b_deq, "ring_slots": ns, "shards": 1,
          "with": "the round's dequeue arithmetic "
                  "(src/repro/runtime/fusedrounds.py:166-181)"}),
        ("kron", ("kron",), deq_kron,
         {"batch": kron["batch"], "ring_slots": 1 << kron_nsl2}),
        ("mesh", ("mesh",), mesh_deq_times(False),
         mesh_shape("deq", False))])
    wave_row("ring_enqueue_wave", "src/repro/kernels/ring_slots.py:170", [
        ("road", ("road",), enq_road,
         {"mode": "ballot", "lanes": b_enq, "children": road_child,
          "ring_slots": ns, "shards": 1,
          "with": "B1's ballot, the overflow test and the new tail "
                  "(src/repro/runtime/fusedrounds.py:194-222)"}),
        ("kron", ("kron",), enq_kron,
         {"mode": "dense", "lanes": kron["capacity"],
          "children": kron_child, "ring_slots": 1 << kron_nsl2}),
        ("mesh", ("mesh",), mesh_enq_times(False),
         mesh_shape("enq", False))])
    wave_row("ring_dequeue_wave_packed",
             "src/repro/kernels/ring_slots.py:184 with deq_planes("
             "birth_packed=True) (:130-167)", [
                 ("road", ("obs_road",), deq_road_p,
                  {"batch": b_deq, "ring_slots": ns, "shards": 1,
                   "births": "out"}),
                 ("kron", (), deq_kron_p,
                  {"batch": kron["batch"], "ring_slots": 1 << kron_nsl2}),
                 ("mesh", ("mesh",), mesh_deq_times(False, True),
                  mesh_shape("deq", False, True))])
    wave_row("ring_enqueue_wave_packed",
             "src/repro/kernels/ring_slots.py:170 with enq_planes("
             "birth_round=) (:60-127)", [
                 ("road", ("obs_road",), enq_road_p,
                  {"mode": "ballot", "lanes": b_enq, "children": road_child,
                   "ring_slots": ns, "shards": 1,
                   "birth_round": int(clock)}),
                 ("kron", (), enq_kron_p,
                  {"mode": "dense", "lanes": kron["capacity"],
                   "children": kron_child, "ring_slots": 1 << kron_nsl2}),
                 ("mesh", ("mesh",), mesh_enq_times(False, True),
                  mesh_shape("enq", False, True))])
    wave_row("ring_dequeue_wave_sharded",
             "src/repro/kernels/ring_slots.py:184", [
                 ("mesh", ("mesh",), mesh_deq_times(True),
                  mesh_shape("deq", True))])
    wave_row("ring_enqueue_wave_sharded",
             "src/repro/kernels/ring_slots.py:170", [
                 ("mesh", ("mesh",), mesh_enq_times(True),
                  mesh_shape("enq", True))])
    # the standalone waves' masked instance: the tree's seed wave (65,536
    # tickets, every lane live) on its 2^23-slot ring, and the functional
    # rounds' dequeue (4 x 1,024 requests, 60 % live).  Per lane its
    # ticket, flag and value in and ok out; per live lane three plane
    # words in and four out (enqueue), three in and one out and its value
    # out (dequeue).
    seed_n = MESH_TREE_SEEDS
    enq_m = [(torch.arange(n0, n0 + seed_n, **card),
              torch.arange(seed_n, **card))
             for n0 in range(1 << nsl2_m, (1 << nsl2_m) + iters * seed_n,
                             seed_n)]
    all_live = torch.ones(seed_n, dtype=torch.bool, device=dev)
    head_m = torch.tensor([1 << nsl2_m], **card)
    masked = [smoke.time_ms(
        lambda: grid_ring(False, 0)[0],
        lambda r, i: fn(*r, enq_m[i][0], enq_m[i][1], head_m,
                        nslots_log2=nsl2_m, idx_bot=IDX_BOT,
                        active=all_live), iters=iters)
        for fn in (K.ring_enqueue, K.ring_enqueue_plain)]
    row("ring_enqueue_masked", csrc + "ring_slots.cu",
        "src/repro/kernels/ring_slots.py:170 (enq_planes(active=))",
        masked[0], masked[1], None, seed_n * (10 + 28) + 4, seed_n,
        {"lanes": seed_n, "live": seed_n, "ring_slots": 1 << nsl2_m})
    dq_live = torch.as_tensor(rng.random(lanes_m) < 0.6, device=dev)
    n_live = int(dq_live.sum())
    deq_m = [torch.arange(n0, n0 + lanes_m, **card)
             for n0 in range(1 << nsl2_m, (1 << nsl2_m) + iters * lanes_m,
                             lanes_m)]
    masked = [smoke.time_ms(
        lambda: grid_ring(False, iters * lanes_m)[0],
        lambda r, i: fn(*r, deq_m[i], nslots_log2=nsl2_m, idx_bot=IDX_BOT,
                        active=dq_live), iters=iters)
        for fn in (K.ring_dequeue, K.ring_dequeue_plain)]
    row("ring_dequeue_masked", csrc + "ring_slots.cu",
        "src/repro/kernels/ring_slots.py:184 (deq_planes(active=))",
        masked[0], masked[1], None, lanes_m * 10 + n_live * 16, lanes_m,
        {"lanes": lanes_m, "live": n_live, "ring_slots": 1 << nsl2_m})
    # obs_record over the mesh's 4 shards: one tree round's record, the
    # run's mean claims valid, a trace plane of 2,048 rows, spans of 16
    # buckets stacked 4 shards.  Bytes as for obs_record, with the row's
    # words and the flow exemplar's a shard.
    valid_m = (torch.arange(BATCH, device=dev)[None, :]
               < pops_m // s_m).expand(s_m, BATCH).reshape(-1).contiguous()
    wave_m = dict(
        keys=torch.as_tensor(rng.integers(0, 1 << 30, lanes_m,
                                          dtype=np.int32), device=dev),
        valid=valid_m,
        births=torch.as_tensor(rng.integers(1000, 5000, lanes_m,
                                            dtype=np.int32), device=dev),
        cls=torch.arange(s_m, **card).repeat_interleave(BATCH),
        k=torch.full((s_m,), pops_m // s_m, **card),
        total=torch.full((s_m,), child_m // s_m, **card),
        occ=torch.full((s_m,), 1 << 20, **card),
        over=torch.zeros((), dtype=torch.bool, device=dev), shards=s_m)
    wave_m["ref"] = wave_m["keys"]

    def obs_mesh_setup():
        z = span_init(s_m, lanes=BATCH, device=dev)
        sp = type(z)(*(x.expand((s_m,) + x.shape).clone() for x in z))
        sp.round.fill_(5000)
        return (trace_init(2048, s_m, device=dev), sp)

    n_valid_m = int(valid_m.sum())
    row("obs_record_mesh", csrc + "obs_record.cu",
        "src/repro/runtime/enginecore.py:312-319 (trace_record) and "
        "src/repro/runtime/meshrounds.py:276-281 (span_record, span_tick "
        "a shard); no pallas_call",
        smoke.time_ms(obs_mesh_setup, lambda p, i: obs_record(*p, **wave_m)),
        smoke.time_ms(obs_mesh_setup,
                      lambda p, i: obs_record_plain(*p, **wave_m)),
        None, lanes_m * 5 + n_valid_m * (8 + 16) + 20 + 8 + 1
        + s_m * (12 + 12 + 16 + 8 + 8 + 16), lanes_m,
        {"shards": s_m, "lanes": lanes_m, "valid": n_valid_m,
         "trace_capacity": 2048, "classes": s_m, "buckets": 16,
         "flows": 64})

    # B5 frontier_expand: the BFS level with the most edges of the kron
    # 2^20 graph (the row's ms), and of the road graph and its level with
    # the median edge count, each call from that level's own visited map
    # on a kept output buffer and scratch, as bfs_queue runs it.  No single
    # PyTorch call expands a BFS level in discovery order.
    def level_times(g, dist, lvl):
        f, vis = level_input(np, dist, lvl)
        rp, col, ft, vt = (torch.as_tensor(x, device=dev) for x in
                           (g.row_ptr, g.col_idx, f, vis))
        max_out, iters = max(g.n, 16), 20
        scratch = K.frontier_scratch(g.n, dev)
        bufs = [K.frontier_buffer(max_out, dev) for _ in range(2)]
        edges = int(np.diff(g.row_ptr)[f].sum())
        fresh = int((dist == lvl + 1).sum())
        # the distinct row_ptr words (f and f + 1 of each frontier vertex)
        # and the distinct targets of the level's edges: each is read once
        # at least
        start = g.row_ptr[f].astype(np.int64)
        deg = np.diff(g.row_ptr)[f].astype(np.int64)
        eidx = np.repeat(start - np.cumsum(deg) + deg, deg) + np.arange(edges)
        targets = len(np.unique(g.col_idx[eidx]))
        rp_words = len(np.union1d(f, f + 1))

        def setup():
            return [vt.clone() for _ in range(iters)]

        kern = smoke.time_ms(setup, lambda v, i: K.frontier_expand(
            rp, col, ft, v[i], max_out=max_out, scratch=scratch,
            out=bufs[i % 2]), iters=iters)
        plain = smoke.time_ms(setup, lambda v, i: K.frontier_expand_plain(
            rp, col, ft, v[i], max_out=max_out), iters=iters)
        # the frontier and its distinct row_ptr words in; per scanned edge
        # its col word; per distinct target its visited word in; per fresh
        # vertex its visited word and its output slot out; the count out
        nbytes = (len(f) * 4 + rp_words * 4 + edges * 4 + targets * 4
                  + fresh * 8 + 4)
        b, by = bound(nbytes, edges, ALU_OPS_PER_S)
        return kern, plain, nbytes, edges, {
            "graph": g.name, "level": lvl, "frontier": len(f),
            "edges": edges, "targets": targets, "fresh": fresh,
            "max_out": max_out, "ms": kern[0], "wall_ms": kern[1],
            "plain_ms": plain[0], "bound_ms": b, "bound_by": by}

    g5, dist5 = qkron
    kern5, plain5, bytes5, edges5, kron5 = level_times(
        g5, dist5, busiest_level(np, g5, dist5))
    deg_r = np.diff(road_g.row_ptr).astype(np.int64)
    edges_r = np.bincount(road_dist, weights=deg_r)
    road_busy = level_times(road_g, road_dist, int(np.argmax(edges_r)))[4]
    road_med = level_times(road_g, road_dist,
                           int(np.argsort(edges_r)[len(edges_r) // 2]))[4]
    # the queue path's launches at their own shapes: road's levels at its
    # median level, kron's at its busiest (an upper bound for its six)
    q = smoke.launches["queue"].get("frontier_expand", 0)
    levels_r = len(edges_r)
    by_path5 = {"queue_road": levels_r * (road_med["ms"]
                                          - road_med["bound_ms"]),
                "queue_kron": (q - levels_r) * (kron5["ms"]
                                                - kron5["bound_ms"])}
    row("frontier_expand", csrc + "frontier.cu",
        "src/repro/kernels/frontier.py:25", kern5, plain5, None, bytes5,
        edges5, dict(kron5, road_busiest=road_busy, road_median=road_med,
                     excess_ms_by_path=by_path5),
        excess=sum(by_path5.values()))

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
    # a decode step's call: 4 rows x top-8 = 32 pairs over the same
    # experts, as the serve cell makes it 5,120 times
    ids6d = torch.as_tensor(rng.integers(0, e6, 32, dtype=np.int32),
                            device=dev)
    oh6d = torch.nn.functional.one_hot(ids6d.long(), e6).int().t() \
        .contiguous()
    dec6 = smoke.time_ms(lambda: None, lambda a, i: K.expert_tickets(
        ids6d, **kw6))
    dec6_plain = smoke.time_ms(lambda: None, lambda a, i:
                               K.expert_tickets_plain(ids6d, **kw6))
    dec6_lib = smoke.time_ms(lambda: None, lambda a, i: torch.cumsum(
        oh6d, 1, dtype=torch.int32))
    b6d, b6d_by = bound(8 * 32, 32, ALU_OPS_PER_S)
    prefill6 = smoke.time_ms(lambda: None,
                             lambda a, i: K.expert_tickets(ids6, **kw6))
    row("expert_tickets", csrc + "moe_route.cu",
        "src/repro/kernels/moe_route.py:25", prefill6,
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
         "library_ms_n_e_layout": strided6[0],
         "decode_32_pairs": {"ms": dec6[0], "wall_ms": dec6[1],
                             "plain_ms": dec6_plain[0],
                             "library_ms": dec6_lib[0], "bound_ms": b6d,
                             "bound_by": b6d_by}},
        # the prefill's calls at its shape, serve's decode calls at theirs
        excess=(smoke.launches["prefill"].get("expert_tickets", 0)
                * (prefill6[0] - bound(8 * n6, n6, ALU_OPS_PER_S)[0])
                + (smoke.launches["serve"].get("expert_tickets", 0)
                   + smoke.launches["runtime"].get("expert_tickets", 0))
                * (dec6[0] - b6d)))

    # B7 flash_attention: the q/k/v of the serve prefill's first layer,
    # the model's (B, S, H, hd) bfloat16 activations as (B, H, S, hd)
    # views.  Library: scaled_dot_product_attention with the same causal
    # mask and GQA, timed here only (the port never calls it).  The same
    # timings at hd 128 (q (1, 32, 4096, 128), kv 8, causal) go into the
    # row's ``hd128``: the wgmma kernel's other width, off the main path.
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def flash_times(q, k, v, kw):
        b, h, s, hd = q.shape
        kvh = k.shape[1]
        pairs = s * (s + 1) // 2          # causal (query, key) pairs
        return (smoke.time_ms(lambda: None, lambda a, i: K.flash_attention(
                    q, k, v, **kw), iters=20),
                smoke.time_ms(lambda: None, lambda a, i:
                              K.flash_attention_plain(q, k, v, **kw),
                              iters=5, reps=3),
                smoke.time_ms(lambda: None, lambda a, i: sdpa(
                    q, k, v, is_causal=True, enable_gqa=True), iters=20),
                # q and out (B, H, S, hd), k and v (B, KV, S, hd),
                # bfloat16; two products of 2 * hd flop per causal
                # (query, key) pair and head
                2 * (2 * b * h * s * hd + 2 * b * kvh * s * hd),
                4 * b * h * pairs * hd)

    q7, k7, v7, kw7 = seen["flash"][0]
    g8 = torch.Generator(device=dev)
    g8.manual_seed(18)
    q8, k8, v8 = ((torch.randn(shape, generator=g8, device=dev) * 0.5)
                  .to(torch.bfloat16) for shape in
                  ((1, 32, 4096, 128), (1, 8, 4096, 128), (1, 8, 4096, 128)))
    kw8 = dict(causal=True, window=0, softcap_val=0.0)
    k8t, p8t, l8t, by8, op8 = flash_times(q8, k8, v8, kw8)
    b8, b8_by = bound(by8, op8, BF16_TC_FLOP_PER_S)
    hd128 = {"ms": k8t[0], "plain_ms": p8t[0], "library_ms": l8t[0],
             "bound_ms": b8, "bound_by": b8_by,
             "wall_ms": {"kernel": k8t[1], "plain": p8t[1],
                         "library": l8t[1]},
             "q": [1, 32, 4096, 128], "kv_heads": 8, "causal": True,
             "layout": "(B, H, S, hd) contiguous"}
    # hd 256: gemma3-4b's prefill, layer 5 (global, causal) and layer 0
    # (local, window 1,024), on their own q/k/v (the model's strided
    # views).  The local layer's library call is SDPA with the band as a
    # boolean mask; its bound counts the (query, key) pairs in the window.
    def sub(kern, plain, lib, nbytes, ops, extra):
        b, by = bound(nbytes, ops, BF16_TC_FLOP_PER_S)
        return dict({"ms": kern[0], "plain_ms": plain[0],
                     "library_ms": lib[0], "bound_ms": b, "bound_by": by,
                     "wall_ms": {"kernel": kern[1], "plain": plain[1],
                                 "library": lib[1]}}, **extra)

    q9, k9, v9, kw9 = seen_gemma[5]
    hd256 = sub(*flash_times(q9, k9, v9, kw9),
                {"q": list(q9.shape), "kv_heads": k9.shape[1],
                 "causal": True, "window": 0, "layer": 5})
    q10, k10, v10, kw10 = seen_gemma[0]
    b10, h10, s10, hd10 = q10.shape
    win = kw10["window"]
    pos = torch.arange(s10, device=dev)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - win)
    pairs10 = int(band.sum())
    hd256_local = sub(
        smoke.time_ms(lambda: None, lambda a, i: K.flash_attention(
            q10, k10, v10, **kw10), iters=20),
        smoke.time_ms(lambda: None, lambda a, i: K.flash_attention_plain(
            q10, k10, v10, **kw10), iters=5, reps=3),
        smoke.time_ms(lambda: None, lambda a, i: sdpa(
            q10, k10, v10, attn_mask=band, enable_gqa=True), iters=20),
        2 * (2 * b10 * h10 * s10 * hd10 + 2 * b10 * k10.shape[1] * s10
             * hd10), 4 * b10 * h10 * pairs10 * hd10,
        {"q": list(q10.shape), "kv_heads": k10.shape[1], "causal": True,
         "window": win, "pairs": pairs10, "layer": 0,
         "library": "scaled_dot_product_attention with the band as a "
                    "boolean mask"})
    kern7, plain7, lib7, bytes7, ops7 = flash_times(q7, k7, v7, kw7)
    b7, h7, s7, hd7 = q7.shape
    row("flash_attention", csrc + "flash_wgmma.cu",
        "src/repro/kernels/flash_attn.py:38", kern7, plain7, lib7,
        bytes7, ops7,
        {"q": [b7, h7, s7, hd7], "kv_heads": k7.shape[1],
         "dtype": "bfloat16", "causal": kw7["causal"],
         "window": kw7["window"], "softcap": kw7["softcap_val"],
         "tolerance": FLASH_TOL,
         "bound_used": smoke.bound_used["flash_attention"],
         "layout": "(B, S, H, hd) strided", "hd128": hd128,
         "hd256_global": hd256, "hd256_local": hd256_local},
        rate=BF16_TC_FLOP_PER_S,
        # granite's prefill at its shape; gemma3's local and global layers
        # each at their own
        excess=(smoke.launches["prefill"].get("flash_attention", 0)
                * (kern7[0] - bound(bytes7, ops7, BF16_TC_FLOP_PER_S)[0])
                + sum(1 for w in smoke.gemma_windows if w)
                * (hd256_local["ms"] - hd256_local["bound_ms"])
                + sum(1 for w in smoke.gemma_windows if not w)
                * (hd256["ms"] - hd256["bound_ms"])))

    # device_loop: the conditional WHILE node's own cost a round, on a
    # body of one kernel (occupancy - 1) and its round count: a chunk of
    # 1,024 rounds as one graph launch, against the same body issued from
    # the host with the condition read back after every round (the loop
    # the CPU runs).  Bound: the body's and the condition kernel's words
    # (occupancy and round count read and written, the flag and the limit
    # read), 29 B a round.  Its launches are graph launches (one a drained
    # run); what the paths lose to it is rounds x (ms - bound).
    from repro_torch.runtime.enginecore import DeviceLoop, new_carry
    lc = new_carry(None, None, dev)
    n_loop = 1024

    def loop_body(c):
        c.occ.sub_(1)
        c.rounds.add_(1)

    def loop_setup():
        lc.occ.fill_(n_loop)
        lc.limit.fill_(n_loop)

    def host_loop(a, i):
        lc.rounds.zero_()
        while int(lc.occ) > 0 and int(lc.rounds) < n_loop:
            loop_body(lc)

    before = dict(K.LAUNCHES)
    dloop = DeviceLoop(loop_body, lc)
    stream = torch.cuda.current_stream().cuda_stream
    kern_l = smoke.time_ms(loop_setup, lambda a, i: dloop.launch(stream),
                           iters=1)
    loop_setup()
    dloop.launch(stream)
    if int(lc.occ) != 0 or int(lc.rounds) != n_loop:
        raise AssertionError("device_loop: the timing loop ran "
                             f"{int(lc.rounds)} rounds")
    plain_l = smoke.time_ms(loop_setup, host_loop, iters=1, reps=3)
    K.LAUNCHES.update(before)             # timing launches do not count
    per = [x / n_loop for x in kern_l]
    plain_per = [x / n_loop for x in plain_l]
    b_l, _ = bound(29, 0, ALU_OPS_PER_S)
    rounds_paths = (road["rounds"] + kron["rounds"] + heap["fused"]["rounds"]
                    + obs_info["road"]["rounds"] + obs_info["heap"]["rounds"]
                    + sum(ray_info[k]["rounds"] for k in ("complex",
                                                          "cornell"))
                    + sum(v["rounds"] for v in adm_info["stream"].values()))
    row("device_loop", csrc + "loop.cu",
        "src/repro/runtime/enginecore.py:330 (fused_loop's lax.while_loop)",
        per, plain_per, None, 29, 0,
        {"unit": "one round of a one-kernel body", "rounds": n_loop,
         "chunk_ms": kern_l[0], "host_loop_chunk_ms": plain_l[0],
         "rounds_on_paths": rounds_paths,
         # the nodes of each engine's captured round (graph_nodes)
         "round_graph_nodes": {
             "road": road["round_graph"]["nodes"],
             "kron": kron["round_graph"]["nodes"],
             "heap": heap["fused"]["round_graph"]["nodes"],
             "road_obs": obs_info["road"]["round_graph_on"]["nodes"],
             "heap_obs": obs_info["heap"]["round_graph_on"]["nodes"],
             "mesh_tree": mesh_info["tree"]["replicated"]["round_graph"][
                 "nodes"],
             **{f"pmesh_tree_{k}": pmesh_info["tree"][k]["round_graph"][
                 "nodes"] for k in ("relaxed", "strict", "single")},
             **{f"pmesh_sssp_{k}": pmesh_info["sssp"][k]["round_graph"][
                 "nodes"] for k in ("relaxed", "strict")},
             **{f"ray_{k}": ray_info[k]["round_graph"]["nodes"]
                for k in ("complex", "cornell")},
             **{f"admission_{k}": v["round_graph"]["nodes"]
                for k, v in adm_info["stream"].items()}}},
        excess=rounds_paths * (per[0] - b_l))
    return rows


if __name__ == "__main__":
    sys.exit(main())
