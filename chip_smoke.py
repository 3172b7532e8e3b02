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
              ((off, on, on, off) x 2: µs a round, rounds/s) and its captured
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
              timed in turns (replicated, sharded, single) x 2 with the
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
multicard. — the queue meshes across processes, one shard a rank
              (``make_mesh(..., group=)``), spawned from this script
              after the build: gloo ranks sharing card 0, 2 of them on
              the 2-shard goldens and 4 on the FIFO tree (replicated at
              65,536 seeds; sharded and sharded with compaction at
              MC_TREE_SEEDS), mesh BFS on road 215^2, SSSP on road
              MC_SSSP_SIDE^2 relaxed with the split payload,
              ``mesh_task_round``'s tree from MC_RT_SEEDS seeds and the
              admission stream's first MC_ADM_TICKS ticks; every rank's
              results equal, and equal bit for bit to the same runs of
              the one-card engine in this process; one collective a
              round; the round's kernels once a round on every rank
              (the host-issued gloo rounds' claim wave once more a
              chunk).  With two cards or more the same cells at full
              size over NCCL, a card a rank; with one, a line says NCCL
              did not run.
dp_train. — the sharded train step (``launch.steps.make_train_step(
              pspecs=, mesh=)``: parameters, master, m and v sharded
              over "data" by the reference's specs, each layer gathered
              where it is used and again in the remat backward, the
              gradients reduce-scattered, AdamW on the blocks) on
              DP_WORLD gloo ranks sharing card 0, spawned after the
              build, each case at full width against the one-card step
              on its global batch in this process (``groups`` = the
              ranks): (a) deepseek-moe-16b with FSDP at DP_MOE_LAYERS of
              its 28 layers, one 4,096-token sequence a rank (B6 on
              24,576 pairs a rank with the group's capacity, B7 with
              lse and the flash backward at hd 128); (b) the same at 128
              tokens a rank and DP_FALLBACK_LAYERS layer, the MoE's
              one-group fallback (the ticket base across ranks); (c)
              h2o-danube-1.8b at DP_DENSE_LAYERS layers without FSDP
              (gradients all-reduced).  Every rank's
              loss and grad norm identical; the first step within
              DP_TOL of the one-card step's, the later ones within the
              training check's bounds; the gathered master's change
              within DP_TOL of the one-card master's; B6, B7 and the
              backward launched on every rank as the path plans; the
              collectives a step those of ``train_collectives``; B6 on
              the first expert ids of the one-card step (a group's
              24,576 pairs) and of rank 0 ((a) its own group; (b) the
              fallback's no-drop call before the base) against its
              plain version.  It prints step s, tokens/s (untimed
              steps), the collectives' seconds (one more step with each
              collective timed), peak memory a rank and the spawn's
              seconds.  With two cards or more the same cases
              over NCCL, a card a rank, and with four zamba2-7b at all
              81 layers over four ranks (ZeRO-3: one card cannot hold
              its state), its loss falling; with one card a line says
              NCCL did not run.
tp_serve. — the serve steps over "model" (``make_prefill_step(pspecs=,
              mesh=)``, ``make_serve_step(pspecs=, mesh=)``: Megatron
              column- and row-parallel attention and MLP, experts and
              vocabulary over "model", the prefill's residual stream
              split along the sequence) on TP_WORLD gloo ranks sharing
              card 0, a (1, 2) mesh, each TP_CASES case at full width
              against the one-card steps on the same weights: yi-34b,
              gemma2-27b (local and global layers) and deepseek-moe-16b
              prefill 2 x 4,096 tokens in bfloat16 into their ring
              caches (B7 on each rank's heads, B6 on every rank),
              decode TP_DECODE steps teacher-forced in bfloat16 (greedy
              tokens equal where clear) and TP_DECODE in float32 (within
              DECODE_TOL); every rank's collectives those of
              ``serve_collectives``, B6's slots equal on both ranks and
              to the one-card route, B7 and B6 on the ranks' own inputs
              against their plain versions.  With four cards the
              full-depth cases over NCCL (``tp_full``): yi-34b's
              decode_32k at batch 16, gemma2-27b's 524,288-token
              prefill, deepseek-moe-16b's float32 serve against one
              card's (``tp_moe_check``).
6. bfs_queue — ``bfs_queue`` (the frontier kernel) and ``bfs_baseline``
              (a plain dense sweep) on the road graph of phase 3 and on
              kron_like(2^20, avg_deg=16, seed=1); road dist must be
              row + col, kron dist must equal a vectorised numpy level
              sweep, the two must agree, frontier_expand must launch
              once per level and bfs_queue read back one int per level
              (plus the edge total and dist once each).
7. kernels  — per kernel: launches on each path (phases 3-6, mesh,
              pmesh, raytrace (``ray``), admission, runtime, multicard,
              dp_train, tp_serve, 8, 9 and train;
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
              ``hd256_global`` and ``hd256_local``, on phase zoo's first
              calls under ``hd112`` (zamba2-7b), ``vlm_hd128`` and
              ``hd80_unmasked`` (hubert-xlarge), its time with and
              without the lse write at granite's shape (in turns) and
              training's forward at danube's layer 0 with the lse.
              ``flash_attention_bwd`` at danube's layer 0 of phase train
              (the split between its dq and dk/dv kernels from the
              profiled step), at phase zoo's training shapes (``hd112``,
              ``hd80_unmasked``) and at gemma3-4b's global and local
              training layers (``hd256_global``, ``hd256_local``) beside
              ``scaled_dot_product_attention``'s backward.  ``device_loop``
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
              2,048-lane rows.  expert_tickets also at phase registry's
              64 experts (``registry_64_experts``: the prefills' first
              layers and a serve decode step), flash_attention at each of
              phase registry's shapes by window and dtype
              (``registry``: 4,096, 32,768 and 524,288 keys, its float32
              check's scalar kernel), each with its launches by path and
              charged at its shape (``registry_rows``).
8. serve    — the model path at full width and cut depth:
              granite-moe-3b-a800m at 4 of its 32 layers
              (``SERVE_LAYERS``; d_model 1536, 40 experts top-8,
              553,916,928 parameters in bfloat16) from ``init_params`` with a
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
train.      — the training path (``launch.train.train_step``:
              ``cast_params`` of the float32 master weights, ``loss_fn``
              with remat, its backward, ``optim.adamw.step``).  (a) B7's
              row log-sum-exp (``return_lse``) and the flash backward
              (``csrc/flash_bwd.cu``: a dq kernel, which also computes
              D, then a dk/dv kernel) against ``flash_attention_plain``
              and ``flash_attention_bwd_plain`` on ``BWD_CASES`` (hd 32,
              64, 80, 112, 128 and 256, causal, and at hd 80, 112 and 256
              without a mask, a 1,024-key window, softcap 50, rep 1, 2
              and 4, S = 2,048 and 4,096, and 1,000; gemma3-4b's global
              and local layer shapes), element by element and in the
              Frobenius norm (``FLASH_BWD_TOL``, ``LSE_TOL``), and
              against the exact float64 gradient of every (batch, kv
              head) group of each case (``FLASH_BWD_EXACT_TOL``), each
              backward called twice with the same bits, and three wrong
              results the checks must reject (a shifted lse block, a
              zeroed value tile, one dq row off by its group's rms in
              the last group); (b)
              h2o-danube-1.8b at full width (24 layers, d 2,560, 32/8
              heads of 80, window 4,096, vocab 32,000; 1,831,201,280
              parameters from a torch.Generator seeded 2, float32 master,
              m and v on the card): its step-0 loss and gradients through
              the backward kernel equal to / within ``GRADS_VS_PLAIN`` of
              the same through the plain backward; then 6 steps of 2 x
              4,096 tokens on two recurring synth_batches (lr 3e-4,
              three warm-up steps):
              per step wall and event seconds, tokens/s, peak memory, and
              the launches (B7 2 x 24: forward and remat; the backward
              24), the last step under the profiler (idle share against
              the median unprofiled step); the loss of step 4 below step
              0's, every grad norm finite; the kernels are held once more
              on its layer 0's own q/k/v; (d) gemma3-4b at full width
              (d 2,560, 8/4 heads of 256, d_ff 10,240, vocab 262,144) and
              12 of its 34 layers (10 local with a 1,024-key window, 2
              global; 2,474,703,360 parameters from a torch.Generator
              seeded 8) the same way as danube, 6 steps (B7 2 x 12, the
              backward 12 a step), the kernels held on its first local
              and first global layer's q/k/v; (c) mamba2-130m at full width
              (24 layers, d 768, state 128, vocab 50,280) trains 12 steps
              of 4 x 4,096 under ``RestartManager`` and
              ``CheckpointManager`` (keep 2, a temporary directory, a
              checkpoint every 5 steps, a fault at step 7): one restart,
              final step and optimizer step 12, checkpoints 10 and 12
              kept, the loss of step 10 below step 0's; then its float32
              master weights prefill 2 x 4,096 tokens and take 16 decode
              steps, whose logits (and the prefill's last) match
              ``forward`` over the same 4,352 tokens within
              ``DECODE_TOL``.
zoo.        — the hybrid, vlm and audio families at full width (the
              ``ZOO_*`` constants).  (a) flash_attention at hd 112 in
              bfloat16 and float32 (zamba2-7b's shape, S off the tiles, a
              window, softcap 50, rep 4) and without a causal mask (hd 80
              at hubert-xlarge's shape, hd 112) within ``FLASH_TOL``.  (b)
              zamba2-7b (81 layers, d_model 3,584, state 64, one shared
              attention block of 32 heads of 112 after every sixth layer;
              6,750,539,856 parameters in bfloat16 from a torch.Generator
              seeded 4) prefills 2 x 4,096 tokens: flash_attention must
              launch 13 times, the logits be finite, the kernel is held on
              the first call's q/k/v; ``ServingEngine`` answers phase 8's
              8 requests at 12 of the 81 layers with the schedule of the
              reduced CPU run; then, cast to float32, it decodes 64 tokens
              from an empty cache, each step within ``DECODE_TOL`` of
              ``forward`` over the same tokens.  (c) llama-3.2-vision-11b
              the same (40 layers, 8 of them cross layers over 2 x 1,601
              bfloat16 image tokens, GQA 32/8 at hd 128; 32 launches; the
              serve at 10 layers, without image tokens as the engine
              decodes; the decode with them).  (d) hubert-xlarge (48
              layers, 16 heads of 80, no causal mask) encodes 2 x 4,096
              frames (48 launches), then trains 6 steps as phase train's
              danube does, its step-0 gradients within
              ``GRADS_VS_PLAIN`` of the plain backward's, the loss of
              step 4 below step 0's.  (e) zamba2-7b trains 4 steps at 24
              of its 81 layers (the optimizer state of all 81 does not fit
              on one card), with the same gradient check.  Prefill and
              encode tokens/s, idle share and peak memory; step seconds,
              tokens/s and peak memory; the backward held on each training
              run's first attention inputs.
registry.   — the registry's cells no chip run had touched (the ``REG_*``
              constants), each cut where ``launch.dryrun.plan_cut`` finds
              that one card does not hold it (its batch first, then its
              depth in whole periods of the layer pattern, to ``FIT`` of
              the card's memory; the line prints each plan and the bytes
              that forced each cut).  (a) deepseek-moe-16b (64 experts,
              top-6, 2 shared), gemma2-27b (windows of 4,096, softcaps 50
              and 30) and yi-34b (GQA 56/8) at full width and depth from
              a torch.Generator on the card prefill 2 x 4,096 tokens as
              phase zoo's do (B7 once a layer and held on the first call's
              q/k/v; deepseek's B6 once a MoE layer and bit-exact on its
              first layer's 49,152 pairs), decode 16 tokens in float32
              against their forward (``DECODE_TOL``) at plan_cut's float32
              depth, and deepseek-moe-16b serves phase 8's requests at 4
              of its 28 layers (B6 in every decode step).  (b)
              prefill_32k at 1 x 32,768 tokens and 4 layers (``P32_LAYERS``,
              cut for time), B7 at 32,768 keys
              against a dense float32 computation of 128 query rows (the
              first, a middle and the last) of three (batch, head) pairs
              on the first and the first global layer's call
              (``DENSE_TOL``; the rows read one row later must fail),
              deepseek's B6 on its first layer's pairs.  (c) decode_32k:
              yi-34b and gemma2-27b decode 8 steps over caches of 32,768
              positions at plan_cut's batch and depth (tokens out/s, peak
              memory), then in float32 at 2 layers a decode of 16 tokens
              from the cache of a prefill of 32,768 held against that
              prefill (``against_prefill``: the last logits within
              ``DECODE_TOL``, every mixer layer's outputs within
              ``LAYER_TOL``), and the same cache shifted by one position
              must fail.  (d) long_500k on h2o-danube-1.8b, gemma3-4b,
              gemma2-27b, zamba2-7b and mamba2-130m at plan_cut's depth
              from ``L500_LAYERS``: a prefill of 524,288 tokens, B7 held
              against the dense rows at 524,288 keys, and the decode of
              the last 8 tokens (zamba2-7b: 512, mamba2-130m in float32)
              against it as in (c), in bfloat16 within
              ``LOGITS_TOL_BF16``, ``LAYER_TOL`` and ``LAYER0_TOL_BF16``,
              the shifted cache rejected.  Prefill tokens/s and peak
              memory of each cell, the plans' and the phase's seconds.

Phases 3-6, 8, 9 and zoo's prefills (not 5b) also re-run their path under
the profiler and report the card's idle share against the unprofiled wall
time (where the profiler drops a long graph run's records, the events'
span stands in).  Phases 5b, mesh, pmesh, raytrace, 8, admission, runtime,
9, train, zoo and registry run before phase 7, whose line needs their
launch counts.  Every phase
line carries ``elapsed_s``, the seconds since the script started, and
every kernel row ``timing_s``, the seconds its timing took.  Then the
card's name and power limit as nvidia-smi prints them, and a last line
``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import dataclasses
import hashlib
import importlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
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
# phase 2 holds B4 at these arity_log2: 1-3 on the instances with a
# shared-memory top, 4, 5 and 8 (16-, 32- and 256-ary) on the
# runtime-arity instance, seeded with WIDE_HEAP_SEED nodes at 2^15 slots
HEAP_ARITIES = (1, 2, 3, 4, 5, 8)
WIDE_HEAP_SEED = 4096
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
# phase multicard: the gloo ranks share one card, whose time slices
# between the processes make a round 10-44 ms on an H100, so their
# cells past the replicated FIFO tree and mesh BFS run at a smaller
# backlog at the same widths (4 shards x 1,024 claims): the sharded trees
# from MC_TREE_SEEDS seeds, SSSP on road MC_SSSP_SIDE^2, mesh_task_round
# from MC_RT_SEEDS seeds, the admission stream's first MC_ADM_TICKS
# ticks and its drain; the NCCL cells (a card a rank) run at the same cut
MC_TREE_SEEDS = 8192
MC_SSSP_SIDE = 128
MC_RT_SEEDS = 4096
MC_ADM_TICKS = 200
# a spawn's ranks must finish in this many seconds, or they are killed and
# the phase fails naming each rank's last stage (four NCCL ranks with the
# round's all-reduce captured in a CUDA graph made no progress on four
# H100s; the rounds are now issued from the host)
MC_SPAWN_TIMEOUT = 300
# phase dp_train: DP_WORLD gloo ranks sharing card 0, each case's global
# batch DP_WORLD sequences (one a rank), TRAIN_LR with TRAIN_WARMUP
# warm-up steps.  (label, arch, layers, tokens a rank, steps, seed).  The
# MoE cases are cut for time: gloo stages each gather through the host,
# about 5 s of deepseek's 7-8 s a step on an H100 at 2 layers (its first
# step 20 s), whatever the tokens, so (a) takes 2 steps and (b) 1, both
# at 1 layer (since PR 29, when phase tp_serve was added; (a) had 2).  A case of 2 steps or more takes one step more with every
# collective timed (the card synchronised around each): its seconds split
# the step, and step s and tokens/s come from the untimed steps
DP_WORLD = 2
DP_MOE_LAYERS, DP_FALLBACK_LAYERS, DP_DENSE_LAYERS = 1, 1, 4
DP_CASES = (("moe", "deepseek-moe-16b", DP_MOE_LAYERS, 4096, 2, 21),
            ("moe_fallback", "deepseek-moe-16b", DP_FALLBACK_LAYERS, 128, 1,
             22),
            ("dense_dp", "h2o-danube-1.8b", DP_DENSE_LAYERS, 4096, 2, 23))
# four cards: zamba2-7b at every layer, ZeRO-3 over four NCCL ranks
DP_ZAMBA = ("zamba2_81", "zamba2-7b", 81, 4096, 3, 24)
# against the one-card step on the global batch (``groups`` = the ranks):
# the first step's loss and grad norm (the gradients differ by each
# rank's bfloat16 rounding before the sum), the later steps' within the
# training check's LOSS / GRAD bounds, and the gathered master's change
# from its initial value, ||ranks - one card|| / ||one card - initial||
# leaf by leaf (Adam's first update is each element's gradient sign
# times lr, so elements with gradients near zero step either way):
# tests/test_torch_dp_train.py's ONE_CARD_RTOL
DP_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "later_loss": 1e-2,
          "later_grad_norm": 1e-1, "master": 0.25}
DP_SPAWN_TIMEOUT = 300
# phase tp_serve: the serve steps over ("data", "model") (Megatron TP,
# experts and vocabulary over "model", the prefill's residual stream split
# along the sequence), TP_WORLD gloo ranks sharing card 0 on a (1,
# TP_WORLD) mesh, each case at full width and cut depth (label, arch,
# layers, seed): yi-34b 4 of 60, gemma2-27b 4 of 46 (two local, two
# global), deepseek-moe-16b 2 of 28.  Each prefills TP_BATCH x TP_SEQ
# tokens in bfloat16 (B7 on each rank's heads; B6 on every rank of the
# moe case), decodes TP_DECODE steps in bfloat16 from the prefill's cache
# teacher-forced with the one-card step's greedy tokens, and TP_DECODE
# steps in float32 from an empty cache over the prompt's first tokens.
# Held against the one-card steps on the same weights: the float32
# logits within DECODE_TOL; the bfloat16 prefill logits within
# TP_BF16_FROB of the one-card's in the Frobenius norm; the bfloat16
# greedy tokens equal wherever the one-card's top two logits are
# TP_TOKEN_MARGIN apart or more (a bfloat16 logit near 30 moves by
# 0.125 a rounding); B6's slots on both ranks equal to each other and to
# the one-card route on the same gates; every rank's collectives those
# of serve_collectives.  A prefill and a decode step are then run again
# with every collective timed (the card synchronised around each)
TP_WORLD = 2
TP_BATCH, TP_SEQ, TP_DECODE = 2, 4096, 16
TP_CASES = (("yi", "yi-34b", 4, 31), ("gemma", "gemma2-27b", 4, 32),
            ("moe", "deepseek-moe-16b", 2, 33))
TP_BF16_FROB = 2e-2
TP_TOKEN_MARGIN = 0.25
TP_SPAWN_TIMEOUT = 300
# four cards (NCCL, a card a rank, a (1, 4) mesh), at full depth:
# yi-34b prefills TP_BATCH x TP_SEQ and decodes TP_FULL_STEPS steps at
# batch TP_YI_DECODE_BATCH from cur = TP_YI_CACHE - TP_FULL_STEPS over
# ring caches of TP_YI_CACHE positions filled with random values (the
# cells' decode_32k); gemma2-27b prefills TP_LONG tokens (long_500k,
# batch 1) into its ring caches and decodes TP_FULL_STEPS greedy steps;
# deepseek-moe-16b serves TP_MOE_REQUESTS requests of TP_MOE_PROMPT +
# TP_MOE_NEW tokens in float32 against the one-card greedy serve
TP_FULL_STEPS = 8
TP_YI_DECODE_BATCH, TP_YI_CACHE = 16, 32768
TP_LONG = 524288
TP_MOE_REQUESTS, TP_MOE_PROMPT, TP_MOE_NEW = 8, 16, 16
# the moe serve is teacher-forced with the one card's greedy tokens (a
# near tie that the sums over "model" break the other way would send a
# free-running serve down another path for good; see tp_moe_check): its
# float32 logits within TP_F32_LOGITS of the one card's, its argmax equal
# wherever the one card's top two logits are TP_F32_MARGIN apart
TP_F32_LOGITS = 1e-3
TP_F32_MARGIN = 1e-2
# a routing difference is a tie the sums over "model" broke the other way
# only where the one card's k-th and (k+1)-th gates are closer than this
# (float32 gates near 1: a few hundred ulps); at most TP_MOE_TIED requests
# may be touched by ties and are then left out of the logits check
TP_GATE_TIE = 1e-4
TP_MOE_TIED = 2
TP_FULL_TIMEOUT = 900
# phase tp_train: the train step over ("data", "model") (Megatron TP with
# its backward, experts and the vocabulary over "model", the residual
# stream split along the sequence), TT_WORLD gloo ranks sharing card 0 on
# a (1, TT_WORLD) mesh, each case at full width and cut depth in
# bfloat16 (label, arch, layers, batch rows, sequence, steps, seed):
# yi-34b 2 of 60, gemma2-27b 2 of 46 (one local, one global),
# deepseek-moe-16b 2 of 28.  Each case's one-card step first (the same
# seeded weights and batches), then the ranks' steps, held against it:
# the first step's loss and grad norm within TT_TOL (the ranks' bfloat16
# partial products are summed in float32 and rounded once, where one card
# rounds the whole product once), the later steps' within the training
# check's LOSS / GRAD bounds, and the master's change after the steps
# leaf by leaf within TT_TOL's family bound (Adam's first update is each
# element's gradient sign times lr; in the MoE a token near a tie may
# take another expert: tests/test_torch_moe_drift.py); every rank's loss
# and grad norm identical, the replicated leaves equal on both ranks, each
# step's collectives those of train_collectives.  Measured (an H100, 700
# W): the first step's loss 3.0e-6 / 5.9e-6 / 2.8e-5 and grad norm 2.6e-5
# / 1.3e-4 / 2.2e-4 off one card's (yi / gemma2 / deepseek), the master's
# change 0.099 / 0.110 / 0.258 (embed)
TT_WORLD = 2
TT_CASES = (("yi", "yi-34b", 2, 2, 4096, 2, 41),
            ("gemma", "gemma2-27b", 2, 1, 4096, 2, 42),
            ("moe", "deepseek-moe-16b", 2, 2, 4096, 2, 43))
TT_TOL = {"loss": 2e-4, "grad_norm": 2e-3, "later_loss": 1e-2,
          "later_grad_norm": 1e-1, "master": {"dense": 0.25, "moe": 0.5}}
TT_SPAWN_TIMEOUT = 400
# four cards (NCCL, a card a rank; tools/tp_train_probe.py): yi-34b and
# gemma2-27b on (1, 4) and (2, 2) at the deepest cut whose state (16 bytes
# a parameter over the four cards) and TT_ACT_RESERVE of activations stay
# under TT_CARD_SHARE of a card beside what this process keeps on card 0,
# TT_FULL_STEPS steps (batches 0, 1, 0: the loss of the last below the
# first's)
TT_CARD_SHARE = 0.88
TT_ACT_RESERVE = 10e9
TT_FULL_STEPS = 3
TT_FULL_TIMEOUT = 900
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
# granite's depth on the serving paths (phases 8, admission and runtime):
# 4 of its 32 layers at full width since phase train joined the run; its
# serves are host-bound a layer at a time, so the cut keeps the script
# under 11 minutes
SERVE_LAYERS = 4
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


# phase train: (b) h2o-danube-1.8b at full width, train_4k's 4,096-token
# sequence at a batch of 2 (its global batch of 256 cut to what one card
# holds), 6 steps on two recurring synth_batches.  lr 3e-4 with three
# warm-up steps (the reference's trainer takes five): with one warm-up
# step the loss of step 4 spikes above step 0's (11.03 against 10.89;
# 9.84 at step 2) through the backward kernel and through the plain
# backward alike (10.89, 10.86, 9.84, 10.55, 11.03 against 10.89, 10.86,
# 9.84, 10.53, 11.04), and with three it is 10.52.  Its step-0
# gradients through the backward kernel are held against the same
# gradients through flash_attention_bwd_plain, leaf by leaf in the
# Frobenius norm within GRADS_VS_PLAIN (2^-5; 1.55e-2 measured on embed):
# the two differ by FLASH_BWD_TOL's bfloat16 roundings, compounded over
# 24 layers of bfloat16 activations.  (c) mamba2-130m at full
# width, 4 x 4,096, 12 steps under RestartManager with a checkpoint every
# 5 steps (keep 2) and a fault at step 7, then a prefill of 2 x 4,096 and
# 16 decode steps in float32 against its forward
TRAIN_ARCH = "h2o-danube-1.8b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 4096, 6, 3e-4
TRAIN_WARMUP = 3
GRADS_VS_PLAIN = 2.0 ** -5
# (d) gemma3-4b at full width (d_model 2,560, 8/4 heads of 256, d_ff
# 10,240, vocab 262,144) and GEMMA_TRAIN_LAYERS of its 34 layers: two
# periods of its 5:1 pattern, 10 local layers (window 1,024) and 2 global
# ones, so both masks run in the backward.  The cut is forced by memory:
# ArchConfig.param_count gives 4,550,996,480 parameters at 34 layers (an
# untied 262,144 x 2,560 head), 72.8 GB at 16 bytes a parameter (float32
# master, m and v, the bfloat16 cast and its gradient) before activations;
# 2,474,703,360 and 39.6 GB at 12.  TRAIN_BATCH x TRAIN_SEQ tokens,
# TRAIN_LR, TRAIN_WARMUP, GEMMA_TRAIN_STEPS steps
GEMMA_TRAIN_LAYERS, GEMMA_TRAIN_STEPS = 12, 6
SSM_ARCH = "mamba2-130m"
SSM_BATCH, SSM_SEQ, SSM_STEPS, SSM_LR = 4, 4096, 12, 1e-3
SSM_SAVE_EVERY, SSM_FAULT_AT, SSM_KEEP = 5, 7, 2
SSM_DECODE_BATCH, SSM_DECODE = 2, 16
# (a) the flash backward (csrc/flash_bwd.cu) against
# flash_attention_bwd_plain at the model's 512-row blocks, on the kernel's
# own out and lse: |kernel - plain| <= rtol |plain| + atol_rms rms(plain)
# per element and ||kernel - plain|| <= frob ||plain|| for dq, dk and dv.
# rtol: two bfloat16 ulps of the element.  frob 2^-7: the two round p,
# dp and the partial sums to bfloat16 at other places (2^-9 a term).
# atol_rms: the rms itself, because the plain version is not the exact
# gradient element by element: it keeps the reference's casts, and one
# of them rounds dp = dout . v^T to bfloat16 before it subtracts D, so
# where dp is close to D (the first rows, whose p sits on a few keys) ds
# keeps that rounding (2^-9 |dp|) though its exact value is near 0: 0.69
# of the rms at dq's row 0 of the first case, whose exact gradient and
# the kernel's are 0.  The element check that rejects one wrong row is
# therefore the one against the exact (float64, dense) gradient, taken
# for every (batch, kv head) group of every case: FLASH_BWD_EXACT_TOL,
# two ulps plus half the group's rms per element, and 2^-7 in the
# Frobenius norm; a dq row moved by its group's rms must fail it.  B7's
# lse against the plain version's m + log(l): 1e-5 absolute plus 1e-5
# relative, and 1e-5 in the Frobenius norm (float32; exp2 on the
# special-function unit)
BWD_CASES = (   # (B, H, KV, S, hd, causal, window, softcap)
    (2, 32, 8, 4096, 80, True, 0, 0.0),       # danube's heads: rep 4
    (1, 8, 8, 2048, 32, True, 1024, 0.0),     # rep 1, a 1,024-key window
    (1, 16, 4, 2048, 64, True, 0, 50.0),      # rep 4, softcap 50
    (1, 8, 2, 4096, 128, True, 1024, 50.0),   # hd 128, window and softcap
    (1, 8, 8, 4096, 64, True, 0, 0.0),        # rep 1 at 4,096
    (1, 4, 4, 2048, 80, True, 1024, 50.0),    # hd 80, rep 1, window, softcap
    (1, 4, 1, 1000, 64, True, 100, 0.0),      # S off the 64-row tiles
    (2, 32, 32, 4096, 112, True, 0, 0.0),     # zamba2-7b's shared block
    (2, 16, 16, 4096, 80, False, 0, 0.0),     # hubert-xlarge: no mask
    (1, 8, 2, 2048, 112, False, 0, 50.0),     # hd 112 unmasked, rep 4
    (2, 8, 4, 4096, 256, True, 0, 0.0),       # gemma3-4b's global layers
    (2, 8, 4, 4096, 256, True, 1024, 0.0),    # gemma3-4b's local layers
    (1, 4, 2, 1000, 256, False, 0, 50.0))     # hd 256 unmasked, softcap 50
FLASH_BWD_TOL = {"rtol": 2.0 ** -6, "atol_rms": 1.0, "frob": 2.0 ** -7}
FLASH_BWD_EXACT_TOL = {"rtol": 2.0 ** -6, "atol_rms": 2.0 ** -1,
                       "frob": 2.0 ** -7}
LSE_TOL = {"atol": 1e-5, "rtol": 1e-5, "frob": 1e-5}
# the backward's two kernels, by the names the profiler gives them
BWD_KERNELS = {"dq": "repro::bwd_dq_kernel",
               "dkdv": "repro::bwd_dkdv_kernel"}
# (c) decode after a prefill against the forward over the same tokens, in
# float32 (tests/test_torch_ssm.py: DECODE_TOL)
DECODE_TOL = {"atol": 1e-3, "rtol": 1e-3}
# phase zoo: the hybrid, vlm and audio families at full width.  (a) B7 at
# hd 112 (bfloat16 and float32) and without a causal mask, ZOO_FLASH_CASES
# within FLASH_TOL (the backward's cases are BWD_CASES' last three, run in
# phase train).  (b) zamba2-7b, all 81 layers (13 shared-block
# invocations at hd 112), and (c) llama-3.2-vision-11b, all 40 layers (8
# cross layers over its 1,601 image tokens), each prefills 2 x 4,096
# tokens in bfloat16 (B7 once per self-attention), decodes ZOO_DECODE
# tokens from an empty cache in float32 against its forward over them
# (DECODE_TOL), and serves SERVE_REQUESTS at ZOO_SERVE_LAYERS of its
# layers (the serves are host-bound a layer at a time: the cut keeps the
# phase near two minutes).  (d) hubert-xlarge, all 48 layers (unmasked B7
# at hd 80): encodes 2 x 4,096 frames, then trains ZOO_AUDIO_STEPS steps
# of 2 x 4,096 frames (TRAIN_LR, TRAIN_WARMUP) with the step-0 gradient
# check of phase train.  (e) zamba2-7b trains at full width and
# ZOO_HYBRID_TRAIN_LAYERS of its 81 layers (4 shared-block invocations):
# float32 master, m and v and bfloat16 weights and gradients, 16 bytes a
# parameter, are about 109 GB at 81 layers and 37 GB at 24
ZOO_HYBRID, ZOO_VLM, ZOO_AUDIO = ("zamba2-7b", "llama-3.2-vision-11b",
                                  "hubert-xlarge")
ZOO_BATCH, ZOO_SEQ = 2, 4096
ZOO_DECODE = 64
ZOO_SERVE_LAYERS = {ZOO_HYBRID: 12, ZOO_VLM: 10}
ZOO_AUDIO_STEPS = 6
ZOO_HYBRID_TRAIN_LAYERS, ZOO_HYBRID_TRAIN_STEPS = 24, 4
ZOO_FLASH_CASES = (   # (B, H, KV, S, hd, causal, window, softcap)
    (2, 32, 32, 4096, 112, True, 0, 0.0),     # zamba2-7b's shared block
    (1, 8, 8, 1000, 112, True, 0, 0.0),       # S off the tiles
    (1, 8, 8, 4096, 112, True, 1024, 0.0),    # a 1,024-key window
    (1, 8, 8, 2048, 112, True, 0, 50.0),      # softcap 50
    (1, 32, 8, 2048, 112, True, 0, 0.0),      # rep 4
    (2, 16, 16, 4096, 80, False, 0, 0.0),     # hubert-xlarge: no mask
    (2, 32, 32, 4096, 112, False, 0, 0.0),    # hd 112 without a mask
    (1, 8, 2, 1000, 112, False, 0, 50.0))     # unmasked, S off the tiles

# phase registry: the registry's cells no chip run had touched (A23), at
# full width; where one card does not hold a cell, launch/dryrun.plan_cut
# cuts its batch, then its depth in whole periods of the layer pattern,
# to FIT of the card's memory, and the line prints each cut.  (a)
# REG_ARCHS at full depth prefill REG_BATCH x REG_SEQ tokens in bfloat16
# (B7 held against its plain version on the first call's q, k and v, as
# phase zoo does; deepseek-moe-16b's B6 on its first MoE layer's 49,152
# (token, choice) pairs over 64 experts, bit for bit), then, at the depth
# plan_cut finds for float32, decode REG_DECODE tokens in float32 against
# their forward over them (DECODE_TOL); deepseek-moe-16b serves
# SERVE_REQUESTS at REG_SERVE_LAYERS of its 28 layers (B6 in every decode
# step).  (b) prefill_32k at 1 x P32_SEQ tokens and P32_LAYERS layers,
# cut for time from its batch of 32 and full depth;
# B7 at 32,768 keys held against a dense float32 computation of
# DENSE_ROWS query rows (the first, a middle and the last) of several
# (batch, head) pairs within DENSE_TOL, on the first call and on the
# first global layer's, and on those rows moved by one row, which must
# fail; deepseek-moe-16b's B6 on its 196,608 pairs.  (c) decode_32k:
# D32_ARCHS decode D32_STEPS steps with caches of D32_SEQ positions at
# plan_cut's batch and depth (decode tokens out/s, peak memory); then
# in float32 at D32_CHECK_LAYERS layers, a prefill over D32_SEQ tokens
# whose first D32_SEQ - D32_TAIL positions' K and V are the cache (with
# causal attention a position's K and V read no later token, so they are
# what a prefill of D32_SEQ - D32_TAIL tokens gives), D32_TAIL decode
# steps, the last step's logits against the prefill's (DECODE_TOL) and
# each attention layer's output at that step against the prefill's last
# row (LAYER_TOL); the same cache with its positions shifted by one must
# fail that check.  (d) long_500k on every config that does not skip
# it, at plan_cut's depth for a prefill of L500_SEQ tokens: the same
# check with L500_TAIL decode steps, in bfloat16 within LOGITS_TOL_BF16
# and LAYER_TOL (mamba2-130m in float32 within DECODE_TOL: its prefill of
# L500_SEQ - L500_TAIL tokens ends in a padded SSD chunk; zamba2-7b
# decodes L500_HYBRID_TAIL steps after a prefill of a multiple of B7's
# and the SSD's blocks, its shared block's K and V taken from that
# prefill), B7 at 524,288 keys against the dense rows.
REG_ARCHS = ("deepseek-moe-16b", "gemma2-27b", "yi-34b")
REG_BATCH, REG_SEQ, REG_DECODE, REG_SERVE_LAYERS = 2, 4096, 16, 4
P32_SEQ = 32768
# the depth prefill_32k runs at, cut for time (plan_cut's walk and the
# prefill both grow with depth), from a batch of 1: whole periods holding
# a global layer and, for deepseek-moe-16b, MoE layers past its dense one
# (plan_cut fills a shallower cut with a larger batch: batch 32 at this
# depth ran out of memory on an H100)
P32_LAYERS = 4
D32_ARCHS = ("yi-34b", "gemma2-27b")
D32_SEQ, D32_TAIL, D32_STEPS = 32768, 16, 8
D32_CHECK_LAYERS = 2     # one period of gemma2's (local, global); time
L500_ARCHS = ("h2o-danube-1.8b", "gemma3-4b", "gemma2-27b", "zamba2-7b",
              "mamba2-130m")
L500_SEQ, L500_TAIL, L500_HYBRID_TAIL = 524288, 8, 512
# the depth plan_cut starts from (the config's where none is named), cut
# for time: a global layer's B7 call is seconds at 524,288 keys, and each
# SSD layer's chunk recurrence 2,048 steps (on meta too, where plan_cut
# counts it); each keeps one period or more, so a global layer
L500_LAYERS = {"h2o-danube-1.8b": 6, "gemma3-4b": 6, "gemma2-27b": 2,
               "zamba2-7b": 6, "mamba2-130m": 2}
DENSE_ROWS = 128
# B7 (bfloat16) against the exact float32 attention of the same rows: one
# ulp of the element plus 2^-5 of the rows' rms (p is rounded to bfloat16
# before p.v), and 2^-8 in the Frobenius norm, since rounding the output
# to bfloat16 alone moves each element by up to 2^-8 of itself
DENSE_TOL = {"rtol": 2.0 ** -7, "atol_rms": 2.0 ** -5, "frob": 2.0 ** -8}
# a mixer layer's (attention's or SSM's) outputs at the decode steps
# against the prefill's rows at those positions, ||decode - prefill|| /
# ||prefill|| over the steps: float32 rounding (the dense path against
# B7's float32 kernel, the SSM's recurrence against its chunked form),
# and in bfloat16 the two paths' roundings of the layer's input, the
# residual stream of every earlier layer rounded to bfloat16 at other
# places (2^-8 an element a layer), and the chunked SSD's bfloat16
# products
LAYER_TOL = {"float32": 2.0 ** -10, "bfloat16": 2.0 ** -4}
# the first layer of an attention family in bfloat16: its input is the
# same token's embedding on both paths, so the two differ by the
# attention's own roundings alone (B7's p in bfloat16 against the dense
# path's weights, 2^-8 of an element); a cache shifted by one moved it by
# 2.2 % at 524,288 tokens through a 4,096-key window (h2o-danube-1.8b on an
# H100 80GB HBM3), under LAYER_TOL, over this
LAYER0_TOL_BF16 = 2.0 ** -6
# the last logits of a bfloat16 decode against the prefill's, in the
# Frobenius norm: the same roundings through every layer and the head
LOGITS_TOL_BF16 = 2.0 ** -4
# a decode step's K and V in its cache slot against the ones it computed,
# ||slot - own|| / ||own||: one rounding to the cache's dtype (2^-8 an
# element in bfloat16); a step that skips its write leaves zeros (a share
# of 2^7) or another position's K and V
WRITE_TOL = 2.0 ** -7

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


def golden_pri_step(torch):
    """The priority mesh goldens' step (tests/test_enginecore.py:
    _pri_mesh_step)."""
    def step(acc, keys, vals, valid):
        acc = acc.index_add(0, torch.where(valid, vals % 89, 0), valid.int())
        ck = torch.stack([keys + 2, keys + 5], -1).int()
        cv = torch.stack([(vals * 7919) % 1000, (vals * 104729) % 1000],
                         -1).int()
        return acc, ck, cv, (valid & (keys < 20))[:, None]
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
                         "admission": {}, "runtime": {}, "train": {},
                         "train_ssm": {}}  # path -> launches (and zoo_*)
        self.keep = {}            # path -> (runner, final state) for obs
        self.lse_used = {"element": 0.0, "frobenius": 0.0}  # B7's lse
        self.bwd_same = 0         # backward calls repeated bit for bit
        self.attn_inputs = {}     # training path -> {window: q, k, v, kw}
        self.reg_b7 = []          # phase registry's B7 calls by shape
        self.reg_tickets = {}     # phase registry's B6 inputs
        self.tp_keep = None       # where tp_full writes its moe check's inputs
        self.tp_bwd = None        # phase tp_train's B7 and backward inputs

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

    def bound_shares(self, got, want, tol=None):
        """(max |got - want|, the largest share of the element bound, the
        share of the Frobenius bound) under ``tol``, by default
        ``FLASH_TOL`` of the dtype."""
        tol = tol or FLASH_TOL[str(want.dtype).split(".")[-1]]
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

    def close(self, name, got, want, tol=None, part=None):
        """Float comparison within ``tol`` (by default ``FLASH_TOL`` of the
        dtype), element by element and in the Frobenius norm; records the
        largest error and each bound's largest share used (by ``part``
        where one kernel has several outputs)."""
        err, elem, frob = self.bound_shares(got, want, tol)
        self.err[name] = max(self.err.get(name, 0.0), err)
        used = self.bound_used.setdefault(name, {})
        if part is not None:
            used = used.setdefault(part, {})
        used.setdefault("element", 0.0)
        used.setdefault("frobenius", 0.0)
        used["element"] = max(used["element"], elem)
        used["frobenius"] = max(used["frobenius"], frob)
        self.cases[name] = self.cases.get(name, 0) + 1
        if elem > 1 or frob > 1:
            raise AssertionError(
                f"{name}: kernel differs from its plain version by "
                f"{elem:.3g} of the element bound and {frob:.3g} of the "
                f"Frobenius bound (max |diff| {err})")

    def time_ms(self, setup, launch, iters=50, reps=2):
        """Per-call milliseconds of ``iters`` calls of ``launch(args, i)``,
        each batch after an untimed ``setup()``: the median over ``reps``
        batches of (device, wall) time, both from CUDA events around the
        batch (2 by default: the script's time limit).  Wall: the calls issued back to back, so it includes the
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
            if r:                   # the warm-up's first-call set-up aside
                host = max(host, host_s)
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
        at arities 2, 4, 8, 16, 32 and 256 (the last three with one pop
        and one insert batch at 2^20 slots and the 2^15 cases from a heap
        of WIDE_HEAP_SEED nodes), ten calls per case queued back to back, the
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

        for arity in HEAP_ARITIES:
            wide = arity not in K.TOP_ARITY_LOG2

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
            for seed in ((r_max - 3, r_max, r_max + 5) if not wide
                         else (WIDE_HEAP_SEED,)):
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
            for i in range(1 if wide else 3):
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
        inserts with a rider at SSSP's 2^22.  At arities 16, 32 and 256
        (the runtime-arity instance) the 2^6 and 2^15 cases."""
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

        for arity in HEAP_ARITIES:
            wide = arity not in K.TOP_ARITY_LOG2
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
                r_max = (K.heap_resident_max(arity, rider=rider)
                         or WIDE_HEAP_SEED)
                st = fresh(8, 15, rider)
                seeds = [d for d in range(8)
                         for _ in range(r_max + (d - 4) * 3)]
                self.rng.shuffle(seeds)
                self.grid_calls(K, st, [to(8, seeds)] + [
                    pop(8, 512, self.rng.integers(0, 600, 8))
                    if i % 2 else ins(8, 4096, -90, 60, rider=rider, i=i)
                    for i in range(10)], 15, arity)
                if wide:   # the plain version scans 2^a children a level
                    continue
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
                   fill=0, own=None):
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
        the last, are held against each other.  ``own=r`` (sharded):
        the planes hold ring r alone (the mesh across processes, one ring
        a rank), beside all ``shards`` heads and tails."""
        np, torch = self.np, self.torch
        ns, cap = 1 << nsl2, 1 << (nsl2 - 1)
        i32c = dict(dtype=torch.int32, device=self.dev)
        cyc0 = i32(((start % 2 ** 32) >> nsl2) - 1)
        lead = (shards,) if sharded else ()
        rows_held = (1,) if own is not None else lead
        planes = [torch.full(rows_held + (ns,), cyc0, **i32c),
                  torch.ones(rows_held + (ns,), **i32c),
                  torch.zeros(rows_held + (ns,), **i32c),
                  torch.full(rows_held + (ns,), IDX_BOT, **i32c)]
        heads = torch.full(lead, i32(start), **i32c)
        tails = heads.clone()
        fills = list(fill) if sharded else [fill]
        for r, c in enumerate(fills):
            if not c:
                continue
            if own is not None and r != own:
                tails[r] += c             # another rank's ring
                continue
            rows = ([p[0 if own is not None else r] for p in planes]
                    if sharded else planes)
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
        if own is not None:
            kw["ring"] = own
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
        # ring=r: one ring a rank (the sharded mesh across processes), the
        # schedule, ranks and overflow test the whole grid's; every ring
        # of the mesh tree's shape, and the small mesh's with one ring
        # overflowing alone, wrapping counters and dense publishes
        for ring in range(4):
            for nsl2, start, fill, calls in (
                    (21, 1 << 21, [16384] * 4,
                     rounds(4, BATCH, 2 * BATCH, tree_d, 10)),
                    (8, 2 ** 32 - 300, [10, 20, 30, 40],
                     rounds(4, 16, 32, (0.5, 0.4), 12)),
                    (6, 1 << 6, [31, 0, 0, 2],
                     [ballot(4 * 8, 0.2), ("deq", 1, True)]
                     + rounds(4, 1, 8, (0.3, 0.9), 10)),
                    (6, 1 << 6, [30, 1, 2, 3],
                     [dense(4, 8, [3, 2, 2, 2]), dense(4, 8, [8, 8, 8, 8])]
                     + [c for r in range(8) for c in (
                         ("deq", 2, r % 4 != 3),
                         dense(4, 8, [int(x) for x in self.rng.integers(
                             0, 9, 4)], r % 4 != 3))])):
                self.wave_calls(K, nsl2, start, calls, 4, True, fill,
                                own=ring)

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
        path's batches (1,024 pops, then 2,048 insert lanes).  At arities
        16, 32 and 256 (``HEAP_ARITIES`` past 3: the runtime-arity
        instance, no shared-memory top) the 2^4 and 2^6 cases, the 2^15
        cases from a heap of WIDE_HEAP_SEED nodes, and at 2^20 the seed,
        one pop batch and one insert batch."""
        np, torch = self.np, self.torch
        card = dict(dtype=torch.int32, device=self.dev)
        for arity in HEAP_ARITIES:
            wide = arity not in K.TOP_ARITY_LOG2

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
            for seed in ((r_max - 3, r_max, r_max + 5) if not wide
                         else (WIDE_HEAP_SEED,)):
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
            if wide:       # the plain version scans 2^a children a level
                st = fresh(HEAP_CAP_LOG2)
                self.heap_calls(K, st, [self.heap_batch(1 << 17, 1.0, 0, 16),
                                        self.pop_batch(BATCH),
                                        self.heap_batch(2 * BATCH, 0.6, 0,
                                                        30)],
                                HEAP_CAP_LOG2, arity)
                continue
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
        on, on, off twice over (four runs a side, so that one slow
        run shows as an outlier beside the median) with CUDA events and
        the host clock; the obs-on runs' launches counted under
        ``obs_<label>``.  Returns (the last obs-on run's result,
        timings)."""
        torch = self.torch
        run(on)                               # capture
        times = {"off": [], "on": []}
        result = None
        for flag in ("off", "on", "on", "off") * 2:
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

    def in_turns(self, runners, run, turns=2):
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
        # timed in turns (replicated, sharded, single) x 2
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

    # -- phase multicard: the queue meshes across processes ---------------

    def mc_checks(self, label, cell, name, ring):
        """A rank's cell (or the one-card run's, ``ring`` None): the
        round's kernels launched once a round, and one collective a
        round."""
        got, rounds = cell["launches"], cell["rounds"]
        sfx = "_sharded" if "sharded" in name else ""
        want = {}
        if name.startswith("fifo_tree") or name == "bfs_road":
            want = {"ring_dequeue_wave" + sfx: rounds,
                    "ring_enqueue_wave" + sfx: rounds}
            if name.endswith("compact"):
                want["wave_compact"] = (MESH_SHARDS * rounds if ring is None
                                        else rounds)
        elif name == "sssp_road":
            want = {"heap_apply_grid_rider": 2 * rounds + 1}
        elif name == "task_round":
            want = {"ring_enqueue_masked": rounds,
                    "ring_dequeue_masked": rounds}
        for k, v in want.items():
            if got.get(k, 0) != v:
                raise AssertionError(f"multicard {label} {name}: {k} "
                                     f"launched {got.get(k, 0)} times in "
                                     f"{rounds} rounds, not {v}")
        if ring is not None:
            per = {"task_round": 4 * rounds + 1}.get(name, rounds)
            if cell["exchanges"] != per:
                raise AssertionError(f"multicard {label} {name}: "
                                     f"{cell['exchanges']} collectives in "
                                     f"{rounds} rounds, not {per}")

    def multicard_path(self, K):
        """Phase multicard: the queue meshes across processes, one shard a
        rank (``make_mesh(..., group=)``), each cell held bit for bit
        against the same run of the one-card stacked engine in this
        process: gloo at 2 ranks (the GOLDEN_2SHARD rows) and 4 ranks
        sharing card 0 (the FIFO tree replicated, sharded and sharded
        with compaction, mesh BFS on road 215^2 (the largest its packed
        payload takes), SSSP on road MC_SSSP_SIDE^2 relaxed with the
        split payload, mesh_task_round's tree, the admission stream, the
        last four at the MC_* cut), and, where the machine has two cards
        or more, the same cells at the same cut over NCCL on min(4,
        cards) cards, one a rank (with the goldens at two).  Every
        rank's results are equal; every round makes one collective; every
        kernel of the path launches on every rank.  The kernels are built
        here first (ranks building into one directory at once would
        race)."""
        from repro_torch.distributed import make_mesh
        torch, np = self.torch, self.np
        t0 = time.perf_counter()
        cards = torch.cuda.device_count()
        cells = ["fifo_tree", "fifo_tree_sharded",
                 "fifo_tree_sharded_compact", "bfs_road", "sssp_road",
                 "task_round", "admission"]
        # (backend, ranks, cells, at the MC_* cut)
        plan = [("gloo", 2, ["goldens"], False),
                ("gloo", MESH_SHARDS, cells, True)]
        nccl = min(4, cards)
        if nccl >= 2:
            plan.append(("nccl", nccl,
                         (["goldens"] if nccl == 2 else []) + cells, True))
        else:
            print(json.dumps({"phase": "multicard", "nccl": "not run",
                              "why": f"torch.cuda.device_count() is "
                                     f"{cards}: NCCL runs one card a rank "
                                     f"and needs two"}), flush=True)
        one = {}
        for _, world, names, cut in plan:
            todo = [n for n in names if (world, n, cut) not in one]
            if not todo:
                continue
            got = mc_cells(torch, np, make_mesh((world,), ("data",)), todo,
                           self.dev, cut)
            for n, cell in got.items():
                self.mc_checks(f"one card S={world}", cell, n, None)
                one[(world, n, cut)] = cell
        for n, g in one.items():
            if n[1] == "goldens":
                want = {k: {kk: vv for kk, vv in v.items()
                            if kk not in ("shards", "relaxed")}
                        for k, v in {**MESH_GOLDEN, **PMESH_GOLDEN,
                                     **SERVING_GOLDEN}.items()
                        if k.endswith("_2")}
                if json.loads(json.dumps(g["result"])) != want:
                    raise AssertionError(f"multicard goldens on one card: "
                                         f"{g['result']}")
        info = {"phase": "multicard", "cards": cards,
                "one_card": {f"{w}/{n}{'/cut' * cut}": {
                    k: v for k, v in c.items() if k != "result"}
                    for (w, n, cut), c in one.items()},
                "cut": {"tree_seeds_sharded": MC_TREE_SEEDS,
                        "sssp_side": MC_SSSP_SIDE, "rt_seeds": MC_RT_SEEDS,
                        "admission_ticks": MC_ADM_TICKS}}
        K.reset_launches()
        path = self.launches.setdefault("multicard", {})
        for backend, world, names, cut in plan:
            t1 = time.perf_counter()
            ranks = mc_spawn(world, backend, names, cut)
            spawn_s = time.perf_counter() - t1
            for n in names:
                want = json.loads(json.dumps(one[(world, n, cut)]["result"]))
                for r, res in ranks.items():
                    if res[n]["result"] != want:
                        raise AssertionError(
                            f"multicard {backend} x {world} {n}: rank {r} "
                            f"{res[n]['result']} != one card {want}")
                    self.mc_checks(f"{backend} x {world} rank {r}", res[n],
                                   n, backend)
                    for k, v in res[n]["launches"].items():
                        path[k] = path.get(k, 0) + v
            info[f"{backend}_{world}"] = {
                "ranks": world, "spawn_and_run_s": spawn_s, "cut": cut,
                "cells": {n: {k: v for k, v in ranks[0][n].items()
                              if k != "result"} for n in names},
                "equal_to_one_card": True}
        for name in ("ring_dequeue_wave", "ring_enqueue_wave",
                     "ring_dequeue_wave_sharded", "ring_enqueue_wave_sharded",
                     "wave_compact", "heap_apply_grid",
                     "heap_apply_grid_rider", "ring_enqueue_masked",
                     "ring_dequeue_masked", "obs_record_mesh"):
            if not path.get(name):
                raise AssertionError(f"multicard: {name} never launched")
        info["launches"] = path
        info["seconds"] = time.perf_counter() - t0
        return info

    # -- phase dp_train: the sharded train step across ranks -------------

    def dp_one_card(self, K, case, world):
        """A dp_train case's steps on one card in this process: the global
        batch, ``groups`` = ``world``, from the ranks' seed; its first
        flash attention call's inputs, a rank's row of them, go to
        ``attn_inputs["dp_train"]``, and its first B6 call's (a group's
        pairs at the group's capacity) is held against the plain version
        after the steps.  Returns (rows, the final master on the
        host)."""
        torch = self.torch
        from repro_torch.data import synth_batch
        from repro_torch.distributed import make_mesh
        from repro_torch.launch import train
        from repro_torch.models import layers
        from repro_torch.models import init_params
        from repro_torch.models.moe import dp_groups, moe_capacity
        from repro_torch.optim import adamw
        from repro_torch.tree import flatten_with_paths
        label, _, _, tokens, n_steps, seed = case
        cfg, _, _, dcfg, ocfg = dp_setup(torch, case, world, make_mesh(
            (world, 1), ("data", "model")))
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(seed)
        state = adamw.init(init_params(cfg, gen, device=self.dev))
        want = dp_launch_plan(cfg, tokens, dp_groups(tokens * world, world))
        rows, real, tickets = [], layers.flash_attention_train, []

        def spy(q, k, v, **kw):
            self.attn_inputs.setdefault("dp_train", (
                q[:1].detach(), k[:1].detach(), v[:1].detach(), kw))
            return real(q, k, v, **kw)
        for i in range(n_steps):
            batch = train.batch_to_device(synth_batch(cfg, dcfg, i % 2),
                                          self.dev)
            torch.cuda.synchronize()
            K.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            layers.flash_attention_train = spy
            try:
                with self.spy_tickets(tickets):
                    t1 = time.perf_counter()
                    state, m = train.train_step(cfg, ocfg, state, batch,
                                                groups=world)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t1
            finally:
                layers.flash_attention_train = real
            launches = {k: v for k, v in K.LAUNCHES.items() if v}
            if any(launches.get(k) != v for k, v in want.items()):
                raise AssertionError(f"dp_train one card {label} step {i}: "
                                     f"launches {launches}, want {want}")
            rows.append({"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "lr": float(m["lr"]), "wall_s": wall,
                         "tokens_per_s": world * tokens / wall,
                         "peak_mem_gb": torch.cuda.max_memory_allocated()
                         / 1e9})
        master = {k: v.cpu() for k, v in flatten_with_paths(state.master)}
        del state, batch
        if tickets:              # B6 on the step's first group's pairs
            ids, kw = tickets[0]
            if kw["capacity"] != moe_capacity(ids.numel() // cfg.top_k, cfg):
                raise AssertionError(f"dp_train one card {label}: B6 ran "
                                     f"with {kw}, not its group's capacity")
            self.tickets_case(K, ids, kw["num_experts"], kw["capacity"])
            rows[0]["tickets_checked"] = {"pairs": ids.numel(), **kw}
        return rows, master

    def dp_master_errors(self, case, world, specs, one, outdir):
        """Leaf by leaf, ||ranks' master - one card's|| / ||one card's -
        initial||, the ranks' blocks (``outdir/<case>_rank<r>.pt``) put
        together along each leaf's sharded dimension on the card."""
        torch = self.torch
        from repro_torch.distributed import make_mesh
        from repro_torch.distributed.sharding import data_dim
        from repro_torch.models import init_params
        from repro_torch.tree import flatten_with_paths
        label, seed = case[0], case[5]
        mesh = make_mesh((world, 1), ("data", "model"))
        cfg = dp_setup(torch, case, world, mesh)[0]
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(seed)
        init = dict(flatten_with_paths(init_params(cfg, gen,
                                                   device=self.dev)))
        blocks = [torch.load(Path(outdir) / f"{label}_rank{r}.pt",
                             mmap=True) for r in range(world)]
        errs = {}
        for k, spec in flatten_with_paths(specs.master):
            d = data_dim(spec, mesh)
            parts = [b[k].to(self.dev) for b in blocks]
            got = parts[0] if d is None else torch.cat(parts, d)
            if d is None and any(not torch.equal(p, got) for p in parts):
                raise AssertionError(f"dp_train {label}: the replicated "
                                     f"leaf {k} differs across ranks")
            want = one[k].to(self.dev)
            errs[k] = float((got - want).norm() / (
                want - init[k].float()).norm().clamp(min=1e-30))
            del parts, got, want
        del init, blocks
        return errs

    def dp_run(self, K, backend, world, cases, one):
        """``cases`` on ``world`` ranks over ``backend``, each held against
        the one-card rows and master ``one[label]`` (None: no one-card run;
        then the loss must fall over the steps), and an MoE case's first
        B6 call on rank 0 (its own group, or the fallback's no-drop call
        before the base) against the plain version.  Returns its line."""
        torch = self.torch
        from repro_torch.distributed import make_mesh
        from repro_torch.models.moe import dp_groups, moe_capacity
        info = {}
        with tempfile.TemporaryDirectory() as tmp:
            t1 = time.perf_counter()
            ranks = spawn_ranks(dp_rank, world, backend, tmp,
                                DP_SPAWN_TIMEOUT,
                                f"dp_train {backend} x {world}", cases,
                                bool(one))
            info["spawn_and_run_s"] = time.perf_counter() - t1
            path = self.launches.setdefault("dp_train", {})
            for case in cases:
                label, _, _, tokens, _, _ = case
                tag = f"dp_train {backend} x {world} {label}"
                cfg, specs = dp_setup(torch, case, world, make_mesh(
                    (world, 1), ("data", "model")))[:2]
                want = dp_launch_plan(cfg, tokens, 1)
                first = ranks[0][label]["rows"]
                split = ranks[0][label]["timed_step"]

                def steps_of(res):   # the untimed steps, then the timed one
                    return res[label]["rows"] + [
                        x for x in (res[label]["timed_step"],) if x]
                for r, res in ranks.items():
                    for i, (row, base) in enumerate(zip(
                            steps_of(res), steps_of(ranks[0]))):
                        if (row["loss"], row["grad_norm"]) != (
                                base["loss"], base["grad_norm"]):
                            raise AssertionError(f"{tag}: rank {r} step {i} "
                                                 f"{row} != rank 0's")
                        if row["collectives"] != res[label]["plan"]:
                            raise AssertionError(
                                f"{tag}: rank {r} step {i} collectives "
                                f"{row['collectives']}, planned "
                                f"{res[label]['plan']}")
                        got = row["launches"]
                        if any(got.get(k) != v for k, v in want.items()):
                            raise AssertionError(f"{tag}: rank {r} step {i} "
                                                 f"launches {got}, want "
                                                 f"{want}")
                        for k, v in got.items():
                            path[k] = path.get(k, 0) + v
                cell = {"rows_rank0": first, "plan": ranks[0][label]["plan"],
                        "init_s": ranks[0][label]["init_s"],
                        "save_s": ranks[0][label]["save_s"],
                        "state_gb_a_rank": ranks[0][label]["state_gb"],
                        "peak_mem_gb_a_rank": max(
                            row["peak_mem_gb"] for res in ranks.values()
                            for row in res[label]["rows"]),
                        "step_s_median": statistics.median(
                            row["wall_s"] for row in first[1:] or first),
                        "tokens_per_s_median": statistics.median(
                            row["tokens_per_s"] for row in first[1:] or first),
                        "collectives_timed_step": split and {
                            "wall_s": split["wall_s"],
                            "collective_s": split["collective_s"]},
                        "ranks_equal": True}
                if cfg.family == "moe":
                    ids, kw = torch.load(Path(tmp) / f"{label}_tickets.pt")
                    t = ids.numel() // cfg.top_k
                    cap = (moe_capacity(t, cfg) if dp_groups(
                        t * world, world) == world else t * cfg.top_k)
                    if kw["capacity"] != cap:
                        raise AssertionError(f"{tag}: rank 0's B6 ran with "
                                             f"{kw}, not capacity {cap}")
                    self.tickets_case(K, ids.to(self.dev), kw["num_experts"],
                                      kw["capacity"])
                    cell["tickets_checked"] = {"pairs": ids.numel(), **kw}
                if one.get(label) is None:
                    if not first[2]["loss"] < first[0]["loss"]:
                        raise AssertionError(f"{tag}: the loss of step 2 is "
                                             f"not below step 0's: {first}")
                    cell["loss_falls"] = [first[0]["loss"], first[2]["loss"]]
                else:
                    rows1, master1 = one[label]
                    for i, (a, b) in enumerate(zip(first, rows1)):
                        for k in ("loss", "grad_norm"):
                            tol = DP_TOL[k if i == 0 else f"later_{k}"]
                            if abs(a[k] - b[k]) > tol * abs(b[k]):
                                raise AssertionError(
                                    f"{tag}: step {i} {k} {a[k]} against the "
                                    f"one-card step's {b[k]} (rtol {tol})")
                        if a["lr"] != b["lr"]:
                            raise AssertionError(f"{tag}: step {i} lr")
                    t2 = time.perf_counter()
                    errs = self.dp_master_errors(case, world, specs, master1,
                                                 tmp)
                    worst = max(errs, key=errs.get)
                    if errs[worst] > DP_TOL["master"]:
                        raise AssertionError(f"{tag}: the master's {worst} "
                                             f"moved {errs[worst]} off the "
                                             f"one-card master's change")
                    cell.update(one_card_rows=rows1,
                                master_change_err_max=[worst, errs[worst]],
                                compare_s=time.perf_counter() - t2)
                info[label] = cell
        return info

    def dp_train_path(self, K):
        """Phase dp_train: each DP_CASES case on one card (its numbers
        kept, its master on the host, the card emptied), then DP_WORLD gloo
        ranks sharing card 0 on all of them against it; with two cards or
        more the same over NCCL, and with four zamba2-7b at 81 layers
        over four NCCL ranks."""
        torch = self.torch
        t0 = time.perf_counter()
        cards = torch.cuda.device_count()
        one = {}
        for case in DP_CASES:
            t1 = time.perf_counter()
            one[case[0]] = self.dp_one_card(K, case, DP_WORLD)
            torch.cuda.empty_cache()
            print(json.dumps({"phase": "dp_train", "one_card": case[0],
                              "seconds": time.perf_counter() - t1}),
                  flush=True)
        info = {"phase": "dp_train", "cards": cards, "world": DP_WORLD,
                "cases": {c[0]: {"arch": c[1], "layers": c[2],
                                 "tokens_a_rank": c[3], "steps": c[4]}
                          for c in DP_CASES},
                "tolerance": DP_TOL}
        K.reset_launches()
        info["gloo"] = self.dp_run(K, "gloo", DP_WORLD, DP_CASES, one)
        # B7 with lse and the backward against their plain versions on
        # deepseek's layer-0 inputs of a rank (hd 128) for phase 7's row
        qkv = self.attn_inputs.pop("dp_train")
        self.dp_bwd = self.bwd_inputs(K, qkv, 66)
        info["backward_hd128"] = {
            "q": list(qkv[0].shape), "kv_heads": qkv[1].shape[1],
            "bound_used": self.bound_used["flash_attention_bwd"],
            "lse_bound_used": self.lse_used}
        if cards >= 2:
            info["nccl"] = self.dp_run(K, "nccl", DP_WORLD, DP_CASES, one)
        if cards >= 4:
            info["nccl_zamba2_81"] = self.dp_run(K, "nccl", 4, (DP_ZAMBA,),
                                                 {})
        else:
            print(json.dumps({"phase": "dp_train", "nccl": "not run"
                              if cards < 2 else "2 ranks",
                              "zamba2_81": "not run",
                              "why": f"torch.cuda.device_count() is {cards}: "
                                     f"NCCL runs a card a rank, zamba2-7b "
                                     f"at 81 layers on four"}), flush=True)
        del one
        path = self.launches["dp_train"]
        for name in ("expert_tickets", "flash_attention",
                     "flash_attention_bwd"):
            if not path.get(name):
                raise AssertionError(f"dp_train: {name} never launched")
        info["launches"] = path
        info["seconds"] = time.perf_counter() - t0
        return info

    # -- phase tp_serve: the serve steps over "model" across ranks --------

    def tp_one_card(self, case, outdir):
        """A TP_CASES case's one-card steps on the same weights: the
        bfloat16 prefill, TP_DECODE greedy decode steps from its cache,
        and TP_DECODE float32 steps from an empty cache over the prompt's
        first tokens.  Writes the ranks' inputs (the prompt, the greedy
        tokens) to ``outdir/<label>_inputs.pt``; returns the logits on the
        host."""
        torch = self.torch
        from repro_torch import models
        from repro_torch.distributed import make_mesh
        from repro_torch.models.transformer import fill_rings
        label, _, _, seed = case
        cfg, _ = tp_setup(case, make_mesh((1, TP_WORLD), ("data", "model")))
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(seed)
        params = models.init_params(cfg, gen, device=self.dev)
        tg = torch.Generator().manual_seed(seed)
        tokens = torch.randint(0, cfg.vocab, (TP_BATCH, TP_SEQ),
                               generator=tg, dtype=torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, kv = models.prefill(params, tokens.to(self.dev), cfg)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        cache = models.init_decode_cache(cfg, TP_BATCH, TP_SEQ + TP_DECODE,
                                         device=self.dev)
        for i in range(cfg.n_layers):
            fill_rings(cache, i, kv["k"][i], kv["v"][i])
        del kv
        teach, dec, walls = [logits.argmax(-1).int()], [], []
        for j in range(TP_DECODE):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lj, cache = models.decode_step(params, cache, teach[-1],
                                           TP_SEQ + j, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            teach.append(lj.argmax(-1).int())
            dec.append(lj.float().cpu())
        out = {"prefill": logits.float().cpu(), "decode": torch.cat(dec, 1),
               "teacher": torch.cat(teach, 1).cpu(), "prefill_s": prefill_s,
               "decode_ms_median": statistics.median(walls) * 1e3}
        del params, cache, logits
        torch.cuda.empty_cache()
        gen.manual_seed(seed)
        params = models.init_params(cfg, gen, device=self.dev,
                                    dtype=torch.float32)
        cache = models.init_decode_cache(cfg, TP_BATCH, TP_DECODE,
                                         torch.float32, device=self.dev)
        f32 = []
        for j in range(TP_DECODE):
            lj, cache = models.decode_step(
                params, cache, tokens[:, j:j + 1].to(self.dev), j, cfg)
            f32.append(lj.cpu())
        out["f32"] = torch.cat(f32, 1)
        torch.save({"tokens": tokens, "teacher": out["teacher"]},
                   Path(outdir) / f"{label}_inputs.pt")
        del params, cache
        torch.cuda.empty_cache()
        return out

    def tp_check(self, K, ranks, one, outdir):
        """Each TP_CASES case's ranks held against the one-card steps
        (see TP_CASES), B7 on rank 0's first call's inputs and B6 on
        each rank's first call's against their plain versions, and the
        launches of the ranks' main path (a prefill: B7 once an attention
        layer, B6 once an MoE layer; a decode step: B6 once an MoE
        layer).  Returns the phase's rows."""
        torch = self.torch
        from repro_torch.distributed import make_mesh
        from repro_torch.models import moe
        path = self.launches.setdefault("tp_serve", {})
        info = {}
        for case in TP_CASES:
            label = case[0]
            cfg, _ = tp_setup(case, make_mesh((1, TP_WORLD),
                                              ("data", "model")))
            o = one[label]
            got = [torch.load(Path(outdir) / f"{label}_rank{r}.pt")
                   for r in range(TP_WORLD)]
            tag = f"tp_serve gloo x {TP_WORLD} {label}"
            for r, g in enumerate(got[1:], 1):
                for k in ("prefill", "argmax", "f32"):
                    if not torch.equal(g[k], got[0][k]):
                        raise AssertionError(f"{tag}: rank {r}'s {k} differs "
                                             f"from rank 0's")
            g = got[0]
            frob = float((g["prefill"] - o["prefill"]).norm()
                         / o["prefill"].norm())
            if not frob <= TP_BF16_FROB:
                raise AssertionError(f"{tag}: bfloat16 prefill logits "
                                     f"{frob} off the one card's")
            f32_err = float((g["f32"] - o["f32"]).abs().max())
            if not torch.allclose(g["f32"], o["f32"], **DECODE_TOL):
                raise AssertionError(f"{tag}: float32 decode logits "
                                     f"{f32_err} off the one card's")
            ref = torch.cat([o["prefill"], o["decode"]], 1)   # (B, 17, V)
            top2 = ref.topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) >= TP_TOKEN_MARGIN
            if not torch.equal(g["argmax"][clear].long(),
                               o["teacher"][clear].long()):
                raise AssertionError(f"{tag}: a greedy token differs where "
                                     f"the one card's top two are "
                                     f"{TP_TOKEN_MARGIN} apart")
            row = {"bf16_prefill_frobenius": frob,
                   "bf16_prefill_max_abs": float(
                       (g["prefill"] - o["prefill"]).abs().max()),
                   "f32_decode_max_abs": f32_err,
                   "greedy_tokens_checked": int(clear.sum()),
                   "greedy_tokens": int(clear.numel()),
                   "one_card": {k: o[k] for k in ("prefill_s",
                                                  "decode_ms_median")},
                   "ranks": {r: ranks[r][label] for r in ranks}}
            q, k, v, kw = g["attn"]
            self.flash_case(K, q.to(self.dev), k.to(self.dev),
                            v.to(self.dev), **kw)
            row["b7_checked"] = {"q": list(q.shape), "kv_heads": k.shape[1],
                                 **kw}
            if cfg.family == "moe":
                slots = [x["route"][1] for x in got]
                if any(not torch.equal(x, slots[0]) for x in slots):
                    raise AssertionError(f"{tag}: B6's slots differ between "
                                         f"ranks")
                for r, x in enumerate(got):
                    want = moe.route(x["route"][0].to(self.dev), cfg)[0]
                    if not torch.equal(want.cpu(), x["route"][1]):
                        raise AssertionError(f"{tag}: rank {r}'s slots differ "
                                             f"from the one-card route on "
                                             f"its gates")
                    ids, kw6 = x["tickets"]
                    self.tickets_case(K, ids.to(self.dev), kw6["num_experts"],
                                      kw6["capacity"])
                row["b6_checked"] = {"pairs": int(ids.numel()), **kw6,
                                     "slots_equal_on_ranks": True,
                                     "equal_to_one_card_route": True}
            want = {"flash_attention": cfg.n_layers}
            if cfg.family == "moe":
                want["expert_tickets"] = cfg.n_layers * (1 + TP_DECODE)
            for r in ranks:
                launches = ranks[r][label]["launches"]
                if any(launches.get(n) != c for n, c in want.items()):
                    raise AssertionError(f"{tag}: rank {r} launches "
                                         f"{launches}, want {want}")
                for n, c in launches.items():
                    path[n] = path.get(n, 0) + c
            info[label] = row
        return info

    def tp_full(self, K, outdir):
        """The four-card cases over NCCL (a card a rank, a (1, 4) mesh):
        the one-card float32 serve of deepseek-moe-16b at 28 layers first,
        then ``tp_rank``'s "full" cases; every rank's tokens equal, the
        outputs finite, each step's collectives those of
        serve_collectives, and the moe serve, teacher-forced with the one
        card's tokens, within TP_F32_LOGITS of its float32 logits and its
        argmax equal wherever the one card's top two are TP_F32_MARGIN
        apart.  Each case's line is printed as it is checked."""
        torch = self.torch
        from repro_torch import models
        from repro_torch.distributed import make_mesh
        case = ("moe_28", "deepseek-moe-16b", 28, 44)
        cfg, _ = tp_setup(case, make_mesh((1, 4), ("data", "model")))
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(case[3])
        params = models.init_params(cfg, gen, device=self.dev,
                                    dtype=torch.float32)
        routes = []
        with torch.no_grad():
            toks, logits, pre_s, walls = tp_moe_serve(
                torch, cfg, params, self.dev, routes=routes)
        del params
        torch.cuda.empty_cache()
        d = Path(outdir) / "full"
        d.mkdir()
        torch.save(toks, d / "moe_teacher.pt")
        t0 = time.perf_counter()
        ranks = spawn_ranks(tp_rank, 4, "nccl", str(d), TP_FULL_TIMEOUT,
                            "tp_serve nccl x 4 full", "full")
        info = {"spawn_and_run_s": time.perf_counter() - t0,
                "moe_28_one_card": {"prefill_s": pre_s,
                                    "decode_ms_median":
                                    statistics.median(walls) * 1e3}}
        for name in ("yi_60", "gemma_46", "moe_28"):
            rows = [ranks[r][name] for r in range(4)]
            info[name] = rows[0]
            info[name]["peak_gb_max_rank"] = max(
                row.get("decode_peak_gb", row.get("peak_mem_gb", 0))
                for row in rows)
            print(json.dumps({"phase": "tp_serve", "nccl": name,
                              **info[name]}), flush=True)
            for r, row in enumerate(rows):
                if row["tokens"] != rows[0]["tokens"]:
                    raise AssertionError(f"tp_serve nccl {name}: rank {r}'s "
                                         f"tokens differ from rank 0's")
                if not row.get("finite", True):
                    raise AssertionError(f"tp_serve nccl {name}: rank {r} "
                                         f"gave non-finite logits")
                for got, plan in (("prefill_collectives", "prefill_plan"),
                                  ("decode_collectives", "decode_plan")):
                    if got in row and row[got] != {
                            k: v for k, v in row[plan].items() if v}:
                        raise AssertionError(f"tp_serve nccl {name}: rank {r} "
                                             f"{got} {row[got]} != "
                                             f"{row[plan]}")
        got = torch.load(d / "moe_logits.pt")
        if self.tp_keep is not None:   # the check's inputs, for a reader
            top2 = logits.topk(2, dim=-1).values
            torch.save({"routes": routes, "ranks_routes": got["routes"],
                        "tokens": toks, "ranks_tokens": torch.tensor(
                            info["moe_28"]["tokens"]),
                        "max_abs": (got["logits"] - logits).abs().amax(-1),
                        "margin": top2[..., 0] - top2[..., 1]},
                       Path(self.tp_keep) / "tp_moe_check.pt")
        info["moe_28"].update(tp_moe_check(torch, toks, logits, routes,
                                           info["moe_28"]["tokens"], got))
        print(json.dumps({"phase": "tp_serve", "nccl": "moe_28 check",
                          **{k: v for k, v in info["moe_28"].items()
                             if k.startswith("check_")}}), flush=True)
        return info

    def tp_serve_path(self, K):
        """Phase tp_serve: each TP_CASES case on one card, then TP_WORLD
        gloo ranks sharing card 0 on all of them against it; with four
        cards the full-depth cases over NCCL (``tp_full``)."""
        torch = self.torch
        t0 = time.perf_counter()
        cards = torch.cuda.device_count()
        info = {"phase": "tp_serve", "cards": cards, "world": TP_WORLD,
                "cases": {c[0]: {"arch": c[1], "layers": c[2]}
                          for c in TP_CASES},
                "batch": TP_BATCH, "seq": TP_SEQ, "decode": TP_DECODE,
                "tolerance": {"f32_decode": DECODE_TOL,
                              "bf16_prefill_frobenius": TP_BF16_FROB,
                              "token_margin": TP_TOKEN_MARGIN}}
        with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
            one = {}
            for case in TP_CASES:
                t1 = time.perf_counter()
                one[case[0]] = self.tp_one_card(case, tmp)
                print(json.dumps({"phase": "tp_serve", "one_card": case[0],
                                  "seconds": time.perf_counter() - t1}),
                      flush=True)
            t1 = time.perf_counter()
            ranks = spawn_ranks(tp_rank, TP_WORLD, "gloo", tmp,
                                TP_SPAWN_TIMEOUT,
                                f"tp_serve gloo x {TP_WORLD} phase", "phase")
            info["spawn_and_run_s"] = time.perf_counter() - t1
            info["gloo"] = self.tp_check(K, ranks, one, tmp)
            del one
            if cards >= 4:
                info["nccl"] = self.tp_full(K, tmp)
            else:
                print(json.dumps({"phase": "tp_serve", "nccl": "not run",
                                  "why": f"torch.cuda.device_count() is "
                                         f"{cards}: the full-depth cases run "
                                         f"a card a rank on four"}),
                      flush=True)
        path = self.launches["tp_serve"]
        for name in ("expert_tickets", "flash_attention"):
            if not path.get(name):
                raise AssertionError(f"tp_serve: {name} never launched")
        info["launches"] = path
        info["seconds"] = time.perf_counter() - t0
        return info

    # -- phase tp_train: the train step over "model" across ranks -------

    def tt_one_card(self, K, case):
        """A TT_CASES case's steps on one card in this process, from the
        ranks' seed and batches.  Returns (rows, the final master on the
        host)."""
        torch = self.torch
        from repro_torch.data import synth_batch
        from repro_torch.distributed import make_mesh
        from repro_torch.launch import train
        from repro_torch.models import init_params
        from repro_torch.optim import adamw
        from repro_torch.tree import flatten_with_paths
        label, _, _, rows_n, seq, n_steps, seed = case
        cfg, _, _, dcfg, ocfg = tt_setup(case, make_mesh(
            (1, TT_WORLD), ("data", "model")))
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(seed)
        state = adamw.init(init_params(cfg, gen, device=self.dev))
        want = dp_launch_plan(cfg, seq, 1)
        rows = []
        for i in range(n_steps):
            batch = train.batch_to_device(synth_batch(cfg, dcfg, i % 2),
                                          self.dev)
            torch.cuda.synchronize()
            K.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            state, m = train.train_step(cfg, ocfg, state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = {k: v for k, v in K.LAUNCHES.items() if v}
            if any(launches.get(k) != v for k, v in want.items()):
                raise AssertionError(f"tp_train one card {label} step {i}: "
                                     f"launches {launches}, want {want}")
            rows.append({"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "lr": float(m["lr"]), "wall_s": wall,
                         "tokens_per_s": rows_n * seq / wall,
                         "peak_mem_gb": torch.cuda.max_memory_allocated()
                         / 1e9})
        master = {k: v.cpu() for k, v in flatten_with_paths(state.master)}
        del state, batch
        return rows, master

    def tt_master_errors(self, case, specs, one, outdir):
        """Leaf by leaf, ||ranks' master - one card's|| / ||one card's -
        initial||, the ranks' blocks (``outdir/<case>_rank<r>.pt``) put
        together along each leaf's cut dimension on the card; a leaf the
        specs leave whole must be equal on every rank."""
        torch = self.torch
        from repro_torch.distributed import make_mesh
        from repro_torch.distributed.sharding import (_assemble, data_dim,
                                                      model_dim)
        from repro_torch.models import init_params
        from repro_torch.tree import flatten_with_paths
        label, seed = case[0], case[6]
        mesh = make_mesh((1, TT_WORLD), ("data", "model"))
        cfg = tt_setup(case, mesh)[0]
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(seed)
        init = dict(flatten_with_paths(init_params(cfg, gen,
                                                   device=self.dev)))
        blocks = [torch.load(Path(outdir) / f"{label}_rank{r}.pt",
                             mmap=True) for r in range(TT_WORLD)]
        errs, same = {}, []
        for k, spec in flatten_with_paths(specs.master):
            dd, md = data_dim(spec, mesh), model_dim(spec, mesh)
            parts = torch.stack([b[k].to(self.dev) for b in blocks])
            if dd is None and md is None:
                if any(not torch.equal(p, parts[0]) for p in parts):
                    raise AssertionError(f"tp_train {label}: the replicated "
                                         f"leaf {k} differs across ranks")
                same.append(k)
            got = _assemble(parts, dd, md, mesh)
            want = one[k].to(self.dev)
            errs[k] = float((got - want).norm() / (
                want - init[k].float()).norm().clamp(min=1e-30))
            del parts, got, want
        del init, blocks
        return errs, same

    def tp_train_path(self, K):
        """Phase tp_train: each TT_CASES case's one-card steps (its rows
        kept, its master on the host, the card emptied), then TT_WORLD gloo
        ranks sharing card 0 on all of them against it; B7 with its lse,
        the flash backward and B6 held against their plain versions on
        rank 0's own inputs; with four cards the NCCL cells
        (``tt_full``)."""
        torch = self.torch
        from repro_torch.distributed import make_mesh
        from repro_torch.models.moe import moe_capacity
        t0 = time.perf_counter()
        cards = torch.cuda.device_count()
        info = {"phase": "tp_train", "cards": cards, "world": TT_WORLD,
                "mesh": [1, TT_WORLD], "dtype": "bfloat16",
                "cases": {c[0]: {"arch": c[1], "layers": c[2],
                                 "batch": c[3], "seq": c[4], "steps": c[5]}
                          for c in TT_CASES},
                "tolerance": TT_TOL,
                "parent_allocated_gb": torch.cuda.memory_allocated() / 1e9}
        one = {}
        for case in TT_CASES:
            t1 = time.perf_counter()
            one[case[0]] = self.tt_one_card(K, case)
            torch.cuda.empty_cache()
            print(json.dumps({"phase": "tp_train", "one_card": case[0],
                              "rows": one[case[0]][0],
                              "seconds": time.perf_counter() - t1}),
                  flush=True)
        path = self.launches.setdefault("tp_train", {})
        mesh = make_mesh((1, TT_WORLD), ("data", "model"))
        with tempfile.TemporaryDirectory() as tmp:
            t1 = time.perf_counter()
            K.reset_launches()
            ranks = spawn_ranks(tt_rank, TT_WORLD, "gloo", tmp,
                                TT_SPAWN_TIMEOUT,
                                f"tp_train gloo x {TT_WORLD}", TT_CASES,
                                (1, TT_WORLD), True)
            info["spawn_and_run_s"] = time.perf_counter() - t1
            for case in TT_CASES:
                label, _, _, rows_n, seq, _, _ = case
                tag = f"tp_train gloo x {TT_WORLD} {label}"
                cfg, specs = tt_setup(case, mesh)[:2]
                want = dp_launch_plan(cfg, seq, 1)
                first = ranks[0][label]["rows"]
                for r, res in ranks.items():
                    for i, (row, base) in enumerate(zip(res[label]["rows"],
                                                        first)):
                        if (row["loss"], row["grad_norm"]) != (
                                base["loss"], base["grad_norm"]):
                            raise AssertionError(f"{tag}: rank {r} step {i} "
                                                 f"{row} != rank 0's")
                        if row["collectives"] != res[label]["plan"]:
                            raise AssertionError(
                                f"{tag}: rank {r} step {i} collectives "
                                f"{row['collectives']}, planned "
                                f"{res[label]['plan']}")
                        got = row["launches"]
                        if any(got.get(k) != v for k, v in want.items()):
                            raise AssertionError(f"{tag}: rank {r} step {i} "
                                                 f"launches {got}, want "
                                                 f"{want}")
                        for k, v in got.items():
                            path[k] = path.get(k, 0) + v
                rows1, master1 = one[label]
                for i, (a, b) in enumerate(zip(first, rows1)):
                    for k in ("loss", "grad_norm"):
                        tol = TT_TOL[k if i == 0 else f"later_{k}"]
                        if abs(a[k] - b[k]) > tol * abs(b[k]):
                            raise AssertionError(
                                f"{tag}: step {i} {k} {a[k]} against the "
                                f"one-card step's {b[k]} (rtol {tol})")
                    if a["lr"] != b["lr"]:
                        raise AssertionError(f"{tag}: step {i} lr")
                t2 = time.perf_counter()
                errs, same = self.tt_master_errors(case, specs, master1, tmp)
                worst = max(errs, key=errs.get)
                if errs[worst] > TT_TOL["master"][cfg.family]:
                    raise AssertionError(f"{tag}: the master's {worst} moved "
                                         f"{errs[worst]} off the one-card "
                                         f"master's change")
                cell = {"rows_rank0": first, "one_card_rows": rows1,
                        "plan": ranks[0][label]["plan"],
                        "init_s": ranks[0][label]["init_s"],
                        "state_gb_a_rank": ranks[0][label]["state_gb"],
                        "peak_mem_gb_a_rank": max(
                            row["peak_mem_gb"] for res in ranks.values()
                            for row in res[label]["rows"]),
                        "step_s": [row["wall_s"] for row in first],
                        "tokens_per_s": [row["tokens_per_s"]
                                         for row in first],
                        "first_step_rel_err": {
                            k: abs(first[0][k] - rows1[0][k])
                            / abs(rows1[0][k]) for k in ("loss",
                                                         "grad_norm")},
                        "master_change_err_max": [worst, errs[worst]],
                        "replicated_leaves_equal": len(same),
                        "ranks_equal": True,
                        "compare_s": time.perf_counter() - t2}
                inputs = torch.load(Path(tmp) / f"{label}_inputs.pt")
                q, k, v, kw = inputs["attn"]
                qkv = (q.to(self.dev), k.to(self.dev), v.to(self.dev), kw)
                bwd = self.bwd_inputs(K, qkv, 77)
                if label == "yi":
                    self.tp_bwd = bwd
                cell["b7_and_bwd_checked"] = {"q": list(q.shape),
                                              "kv_heads": k.shape[1],
                                              "window": kw["window"],
                                              "softcap": kw["softcap_val"]}
                if cfg.family == "moe":
                    ids, kw6 = inputs["tickets"]
                    if kw6["capacity"] != moe_capacity(ids.numel()
                                                       // cfg.top_k, cfg):
                        raise AssertionError(f"{tag}: rank 0's B6 ran with "
                                             f"{kw6}")
                    self.tickets_case(K, ids.to(self.dev),
                                      kw6["num_experts"], kw6["capacity"])
                    cell["b6_checked"] = {"pairs": ids.numel(), **kw6}
                info[label] = cell
                print(json.dumps({"phase": "tp_train", "case": label,
                                  **cell}), flush=True)
        del one
        torch.cuda.empty_cache()
        if cards >= 4:
            info["nccl"] = self.tt_full(K)
        else:
            print(json.dumps({"phase": "tp_train", "nccl": "not run",
                              "why": f"torch.cuda.device_count() is {cards}: "
                                     f"the NCCL cells run a card a rank on "
                                     f"four"}), flush=True)
        for name in ("expert_tickets", "flash_attention",
                     "flash_attention_bwd"):
            if not path.get(name):
                raise AssertionError(f"tp_train: {name} never launched")
        info["launches"] = path
        info["seconds"] = time.perf_counter() - t0
        return info

    def tt_full(self, K):
        """The four-card cells over NCCL (a card a rank): yi-34b and
        gemma2-27b on (1, 4) and (2, 2) at ``tt_full_layers``' cut,
        TT_FULL_STEPS steps each (batches 0, 1, 0); every rank's loss and
        norm equal, each step's collectives those of train_collectives,
        the loss finite and the last step's below the first's (the same
        batch after two updates).  Each cell's line is printed as it is
        checked."""
        torch = self.torch
        from repro_torch import configs
        info = {}
        for shape in ((1, 4), (2, 2)):
            cases = []
            for label, arch, _, rows_n, seq, _, seed in TT_CASES[:2]:
                layers = tt_full_layers(configs.get_config(arch), 4)
                cases.append((f"{label}_{layers}", arch, layers,
                              max(rows_n, shape[0]), seq, TT_FULL_STEPS,
                              seed))
            print(json.dumps({"phase": "tp_train", "nccl": shape,
                              "cases": cases, "parent_reserved_gb":
                              torch.cuda.memory_reserved(0) / 1e9}),
                  flush=True)
            with tempfile.TemporaryDirectory() as tmp:
                t1 = time.perf_counter()
                ranks = spawn_ranks(tt_rank, 4, "nccl", tmp, TT_FULL_TIMEOUT,
                                    f"tp_train nccl x 4 {shape}",
                                    tuple(cases), shape, False)
                spawn_s = time.perf_counter() - t1
            key = f"{shape[0]}x{shape[1]}"
            for case in cases:
                label = case[0]
                rows = ranks[0][label]["rows"]
                for r, res in ranks.items():
                    for i, (row, base) in enumerate(zip(res[label]["rows"],
                                                        rows)):
                        if (row["loss"], row["grad_norm"]) != (
                                base["loss"], base["grad_norm"]):
                            raise AssertionError(f"tp_train nccl {key} "
                                                 f"{label}: rank {r} step "
                                                 f"{i} != rank 0's")
                        if row["collectives"] != res[label]["plan"]:
                            raise AssertionError(
                                f"tp_train nccl {key} {label}: rank {r} step "
                                f"{i} collectives {row['collectives']}, "
                                f"planned {res[label]['plan']}")
                if not all(math.isfinite(row["loss"]) for row in rows) or \
                        not rows[-1]["loss"] < rows[0]["loss"]:
                    raise AssertionError(f"tp_train nccl {key} {label}: "
                                         f"losses {[r['loss'] for r in rows]}")
                cell = {"layers": case[2], "batch": case[3], "seq": case[4],
                        "rows_rank0": rows, "plan": ranks[0][label]["plan"],
                        "state_gb_a_rank": ranks[0][label]["state_gb"],
                        "peak_mem_gb_max_rank": max(
                            row["peak_mem_gb"] for res in ranks.values()
                            for row in res[label]["rows"]),
                        "spawn_and_run_s": spawn_s}
                info[f"{key}/{label}"] = cell
                print(json.dumps({"phase": "tp_train", "nccl": key,
                                  "case": label, **cell}), flush=True)
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

    def serve_checked(self, K, serving, models, cfg, params, label):
        """The request trace through ``ServingEngine`` with ``params`` on
        the card (the launch counters from 0, kept under ``label``), then
        at ``cfg``'s reduced width on the CPU: every request completes,
        and the admissions, decode steps, page stalls and the admission
        order agree (the schedule does not depend on the width).  Returns
        the card's engine and the run's line."""
        torch = self.torch
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        eng, metrics, serve_s = self.serve_run(serving, cfg, params, self.dev)
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        self.launches[label] = launches
        small = cfg.reduced()
        cpu_gen = torch.Generator()
        cpu_gen.manual_seed(0)
        ceng, cmetrics, cpu_s = self.serve_run(
            serving, small, models.init_params(small, cpu_gen, device="cpu"),
            "cpu")
        if (metrics["completed"], metrics["tokens_out"]) != (
                SERVE_REQUESTS, SERVE_REQUESTS * SERVE_NEW):
            raise AssertionError(f"{label}: {metrics}")
        keys = ("admitted", "decode_steps", "page_stalls")
        if [metrics[k] for k in keys] != [cmetrics[k] for k in keys] or \
                eng.admission_log != ceng.admission_log:
            raise AssertionError(f"{label}: card {metrics} "
                                 f"{eng.admission_log} != CPU {cmetrics} "
                                 f"{ceng.admission_log}")
        return eng, {
            "requests": SERVE_REQUESTS, "prompt_len": SERVE_PROMPT,
            "max_new": SERVE_NEW, "metrics": metrics,
            "admission_log": eng.admission_log, "run_s": serve_s,
            "tokens_out_per_s": metrics["tokens_out"] / serve_s,
            "decode_steps_per_s": metrics["decode_steps"] / serve_s,
            "readbacks": eng.host_syncs, "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "cpu_reduced_run": {"metrics": cmetrics, "run_s": cpu_s},
            "schedule_equals_cpu": True}

    def serve_path(self, K, configs, models, serving):
        """Phase 8; returns its line and the recorded kernel inputs of the
        prefill (for the rows of phase 7)."""
        np, torch = self.np, self.torch
        from repro_torch.models import layers
        # the module (the package exports a function of the same name)
        moe_route = importlib.import_module("repro_torch.kernels.moe_route")
        cfg = dataclasses.replace(configs.get_config(SERVE_ARCH),
                                  n_layers=SERVE_LAYERS)
        t0 = time.perf_counter()
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(0)
        params = models.init_params(cfg, gen, device=self.dev)
        torch.cuda.synchronize()
        n = n_params(params)
        if n != expected_params(cfg):
            raise AssertionError(f"serve: {n} parameters, the config "
                                 f"counts {cfg.param_count()}")
        info = {"phase": "serve", "arch": cfg.name, "params": n,
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
        eng, info["serve"] = self.serve_checked(K, serving, models, cfg,
                                                params, "serve")
        metrics, launches = (info["serve"]["metrics"],
                             info["serve"]["launches"])
        if launches.get("expert_tickets") != L * metrics["decode_steps"]:
            raise AssertionError(f"serve: expert_tickets launched "
                                 f"{launches.get('expert_tickets')} times in "
                                 f"{metrics['decode_steps']} steps")
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
        n = n_params(params)
        if n != expected_params(cfg):
            raise AssertionError(f"gemma: {n} parameters, the config "
                                 f"counts {cfg.param_count()}")
        info = {"phase": "prefill_gemma3", "arch": cfg.name,
                "params": n, "hd": cfg.hd,
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

    # -- phase train: the training path at full width ----------------------

    def close_lse(self, got, want):
        """B7's lse against the plain version's within ``LSE_TOL``,
        element by element and in the Frobenius norm; records each bound's
        largest share used."""
        if got.shape != want.shape or got.dtype != self.torch.float32:
            raise AssertionError(f"lse: {got.shape} {got.dtype}")
        bound = LSE_TOL["atol"] + LSE_TOL["rtol"] * want.abs()
        elem = float(((got - want).abs() / bound).max())
        frob = float((got - want).norm() / want.norm()) / LSE_TOL["frob"]
        used = self.lse_used
        used["element"] = max(used["element"], elem)
        used["frobenius"] = max(used["frobenius"], frob)
        if not (elem <= 1 and frob <= 1):
            raise AssertionError(f"flash_attention lse: {elem:.3g} of the "
                                 f"element bound, {frob:.3g} of the "
                                 f"Frobenius bound")

    def bwd_case(self, K, q, k, v, seed, **kw):
        """B7 with its lse and the backward kernel against their plain
        versions on (q, k, v) and a seeded dout; returns (out, lse,
        dout)."""
        torch = self.torch
        bq, bk = K.flash_attn.kernel_tiles(q.dtype, q.shape[-1])
        bq = bq if q.shape[2] % bq == 0 else q.shape[2]
        out, lse = K.flash_attention(q, k, v, return_lse=True, **kw)
        want, want_lse = K.flash_attention_plain(q, k, v, bq=bq, bk=bk,
                                                 return_lse=True, **kw)
        self.close("flash_attention", out, want)
        self.close_lse(lse, want_lse)
        g = torch.Generator(device=self.dev)
        g.manual_seed(seed)
        dout = torch.randn(out.shape, generator=g, device=self.dev).to(
            out.dtype)
        got = K.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
        again = K.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd: two calls on the "
                                 f"same inputs differ ({tuple(q.shape)}, "
                                 f"{kw})")
        self.bwd_same += 1
        ref = K.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
        for part, a, b in zip(("dq", "dk", "dv"), got, ref):
            self.close("flash_attention_bwd", a, b, tol=FLASH_BWD_TOL,
                       part=part)
        self.close_exact(got, q, k, v, dout, **kw)
        return out, lse, dout

    def close_exact(self, got, q, k, v, dout, **kw):
        """The kernel's (dq, dk, dv) against the exact gradient of every
        (batch, kv head) group within ``FLASH_BWD_EXACT_TOL``."""
        rep = q.shape[1] // k.shape[1]
        for bi in range(k.shape[0]):
            for gi in range(k.shape[1]):
                exact = self.exact_grads(q, k, v, dout, bi, gi, **kw)
                for part, a, e in zip(("dq", "dk", "dv"), got, exact):
                    a = (a[bi, gi * rep:(gi + 1) * rep] if part == "dq"
                         else a[bi, gi])
                    self.close("flash_attention_bwd_exact", a.double(), e,
                               tol=FLASH_BWD_EXACT_TOL, part=part)

    def exact_grads(self, q, k, v, dout, bi, gi, *, causal, window,
                    softcap_val):
        """The exact gradient (float64, dense attention under autograd) of
        batch ``bi``'s kv head ``gi`` and its query heads: (dq (rep, Sq,
        hd), dk (Sk, hd), dv (Sk, hd))."""
        torch = self.torch
        rep = q.shape[1] // k.shape[1]
        heads = slice(gi * rep, (gi + 1) * rep)
        qq, kk, vv = (x.double().requires_grad_()
                      for x in (q[bi, heads], k[bi, gi], v[bi, gi]))
        s = torch.einsum("rqd,kd->rqk", qq, kk) / q.shape[-1] ** 0.5
        if softcap_val:
            s = softcap_val * torch.tanh(s / softcap_val)
        qpos = torch.arange(q.shape[2], device=self.dev)[:, None]
        kpos = torch.arange(k.shape[2], device=self.dev)[None, :]
        ok = kpos <= qpos if causal else torch.ones_like(kpos <= qpos)
        if window:
            ok = ok & (kpos > qpos - window)
        s = torch.where(ok, s, -1e30)
        o = torch.einsum("rqk,kd->rqd", torch.softmax(s, -1), vv)
        return torch.autograd.grad(o, (qq, kk, vv),
                                   dout[bi, heads].double())

    def compare_flash_bwd(self, K):
        """(a) B7's lse and the flash backward against their plain versions
        on ``BWD_CASES`` (hd 32, 64, 80, 112, 128 and 256; causal and, at
        hd 80, 112 and 256, without a mask; a 1,024-key window; softcap
        50; rep 1, 2 and 4; S = 2,048 and 4,096, and 1,000), each backward
        called twice and the two results equal bit for bit; then
        three wrong results the checks must reject: the lse of one 64-row
        block shifted by 0.5, and one 64-key tile of v zeroed, each given
        to the kernel while the plain version keeps the true one (held
        against the plain version); and one row of dq in the last (batch,
        kv head) group moved by that group's rms (held against the exact
        gradient)."""
        torch = self.torch
        t0 = time.perf_counter()
        for i, (b, h, kv, s, hd, causal, win, cap) in enumerate(BWD_CASES):
            g = torch.Generator(device=self.dev)
            g.manual_seed(40 + i)
            q, k, v = ((torch.randn(shape, generator=g, device=self.dev)
                        * 0.5).to(torch.bfloat16)
                       for shape in ((b, h, s, hd), (b, kv, s, hd),
                                     (b, kv, s, hd)))
            kw = dict(causal=causal, window=win, softcap_val=cap)
            out, lse, dout = self.bwd_case(K, q, k, v, 50 + i, **kw)
            if i == 0:
                keep = (q, k, v, out, lse, dout, kw)
        q, k, v, out, lse, dout, kw = keep
        want = K.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
        bad_lse = lse.clone()
        bad_lse[:, :, 1024:1088] += 0.5
        v0 = v.clone()
        v0[:, :, 1024:1088] = 0
        rejected = {}
        for name, got in (
                ("lse_block", K.flash_attention_bwd(q, k, v, out, dout,
                                                    bad_lse, **kw)),
                ("value_tile", K.flash_attention_bwd(q, k, v0, out, dout,
                                                     lse, **kw))):
            shares = {}
            for part, a, w in zip(("dq", "dk", "dv"), got, want):
                _, elem, frob = self.bound_shares(a, w, FLASH_BWD_TOL)
                shares[part] = {"element": elem, "frobenius": frob}
            rejected[name] = shares
            if all(x["element"] <= 1 and x["frobenius"] <= 1
                   for x in shares.values()):
                raise AssertionError(f"flash_attention_bwd: the check passed "
                                     f"a wrong result ({name})")
        # one dq row of the last group, moved by the exact gradient's rms
        # in that group: the plain comparison's Frobenius term is blind to
        # it (one row of 2 x 32 x 4,096), the exact element check is not
        dq = K.flash_attention_bwd(q, k, v, out, dout, lse, **kw)[0].clone()
        rep = q.shape[1] // k.shape[1]
        bi, gi, row = k.shape[0] - 1, k.shape[1] - 1, q.shape[2] // 2 + 17
        e_dq = self.exact_grads(q, k, v, dout, bi, gi, **kw)[0]
        rms = float(e_dq.pow(2).mean().sqrt())
        dq[bi, (gi + 1) * rep - 1, row] += rms
        _, elem, frob = self.bound_shares(
            dq[bi, gi * rep:(gi + 1) * rep].double(), e_dq,
            FLASH_BWD_EXACT_TOL)
        rejected["dq_row"] = {
            "exact": {"element": elem, "frobenius": frob},
            "plain_frobenius": self.bound_shares(dq, want[0],
                                                 FLASH_BWD_TOL)[2]}
        if elem <= 1 and frob <= 1:
            raise AssertionError("flash_attention_bwd: the exact check passed "
                                 "a wrong dq row")
        torch.cuda.synchronize()
        return {"cases": [dict(zip(("batch", "heads", "kv_heads", "seq",
                                    "hd", "causal", "window", "softcap"), c))
                          for c in BWD_CASES],
                "tolerance": {"grads": FLASH_BWD_TOL,
                              "grads_exact": FLASH_BWD_EXACT_TOL,
                              "lse": LSE_TOL},
                "bound_used": self.bound_used["flash_attention_bwd"],
                "exact_bound_used": self.bound_used[
                    "flash_attention_bwd_exact"],
                "lse_bound_used": self.lse_used,
                "wrong_results_rejected": rejected,
                "calls_repeated_bit_for_bit": self.bwd_same,
                "seconds": time.perf_counter() - t0}

    def grads_vs_plain(self, cfg, state, batch):
        """The loss and every leaf's gradient at ``cast_params(master)``
        through the backward kernel, against the same through
        ``flash_attention_bwd_plain`` (swapped in for the autograd
        Function's backward): equal losses, each leaf within
        ``GRADS_VS_PLAIN`` of the plain path's in the Frobenius norm."""
        torch = self.torch
        from repro_torch.kernels import flash_attn
        from repro_torch.models import loss_fn
        from repro_torch.optim import adamw
        from repro_torch.tree import flatten_with_paths, tree_map
        real = flash_attn.flash_attention_bwd
        runs = []
        for bwd in (real, flash_attn.flash_attention_bwd_plain):
            flash_attn.flash_attention_bwd = bwd
            try:
                params = tree_map(lambda p: p.detach().requires_grad_(),
                                  adamw.cast_params(state.master))
                loss = loss_fn(params, batch, cfg)
                runs.append((float(loss.detach()), torch.autograd.grad(
                    loss, [t for _, t in flatten_with_paths(params)],
                    allow_unused=True, materialize_grads=True)))
                del params, loss
                torch.cuda.empty_cache()
            finally:
                flash_attn.flash_attention_bwd = real
        keys = [k for k, _ in flatten_with_paths(state.master)]
        rel = {k: float((a.float() - b.float()).norm()
                        / b.float().norm().clamp(min=1e-30))
               for k, a, b in zip(keys, runs[0][1], runs[1][1])}
        if runs[0][0] != runs[1][0] or max(rel.values()) > GRADS_VS_PLAIN:
            raise AssertionError(f"train: the gradients through the backward "
                                 f"kernel differ from the plain backward's: "
                                 f"losses {runs[0][0]} {runs[1][0]}, {rel}")
        return {"loss": runs[0][0], "rel_frobenius": rel,
                "tolerance": GRADS_VS_PLAIN}

    def train_lm(self, K, models, cfg, seed, steps, label, falls=True):
        """``cfg`` at its width and depth, from a torch.Generator seeded
        ``seed``: its step-0 gradients against the plain backward's
        (``grads_vs_plain``), then ``steps`` steps of
        ``launch.train.train_step`` (remat on, AdamW ``TRAIN_LR`` with
        ``TRAIN_WARMUP`` warm-up steps) on two recurring synth_batches of
        ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens (frames for the audio
        family), the last under the profiler.  A step launches B7 twice
        per attention call of the forward (the forward and its remat) and
        the backward once.  With ``falls`` the loss of step 4 must be
        below step 0's (both on batch 0).  Returns its line and the first
        attention call's inputs of the first step (each window's first
        call's go to ``attn_inputs[label]``); the launches go under
        ``label``."""
        torch = self.torch
        from repro_torch.data import DataConfig, synth_batch
        from repro_torch.launch import train
        from repro_torch.models import layers
        from repro_torch.optim import adamw
        t0 = time.perf_counter()
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(seed)
        params = models.init_params(cfg, gen, device=self.dev)
        n = n_params(params)
        if n != expected_params(cfg):
            raise AssertionError(f"{cfg.name}: {n} parameters, expected "
                                 f"{expected_params(cfg)}")
        state = adamw.init(params)
        del params
        torch.cuda.synchronize()
        info = {"arch": cfg.name, "params": n, "layers": cfg.n_layers,
                "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
                "hd": cfg.hd, "window": cfg.sliding_window,
                "causal": cfg.causal, "remat": cfg.remat,
                "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                "init_s": time.perf_counter() - t0,
                "state_gb": torch.cuda.memory_allocated() / 1e9}
        ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
        dcfg = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
        batches = [train.batch_to_device(synth_batch(cfg, dcfg, i), self.dev)
                   for i in range(2)]
        tokens = TRAIN_BATCH * TRAIN_SEQ
        t0 = time.perf_counter()
        info["grads_vs_plain"] = self.grads_vs_plain(cfg, state, batches[0])
        info["grads_vs_plain"]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        seen = {}
        real = layers.flash_attention_train

        def spy(q, k, v, **kw):
            if kw["window"] not in seen:    # each window's first call
                seen[kw["window"]] = (q.detach(), k.detach(), v.detach(), kw)
            return real(q, k, v, **kw)

        L, n_steps, steps, total = attention_calls(cfg), steps, [], {}
        for i in range(n_steps):
            profiled = i == n_steps - 1
            K.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            layers.flash_attention_train = spy if i == 0 else real
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            try:
                torch.cuda.synchronize()
                with (self.profile() if profiled
                      else contextlib.nullcontext()) as prof:
                    t1 = time.perf_counter()
                    ev[0].record()
                    state, m = train.train_step(cfg, ocfg, state,
                                                batches[i % 2])
                    ev[1].record()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t1
            finally:
                layers.flash_attention_train = real
            launches = {k: v for k, v in K.LAUNCHES.items() if v}
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            if (launches.get("flash_attention") != 2 * L
                    or launches.get("flash_attention_bwd") != L):
                raise AssertionError(f"train step {i}: launches {launches}, "
                                     f"expected {2 * L} flash_attention (the "
                                     f"forward and its remat) and {L} "
                                     f"flash_attention_bwd")
            row = {"step": i, "batch": i % 2, "loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
                   "wall_s": wall, "device_s": ev[0].elapsed_time(ev[1]) / 1e3,
                   "tokens_per_s": tokens / wall,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "launches": launches}
            if profiled:
                times = device_times(prof)
                info["bwd_split"] = kernel_split(prof, BWD_KERNELS)
                busy = sum(times.values()) / 1e6
                steady = statistics.median(r["wall_s"] for r in steps[1:])
                row.update(profiled=True, device_busy_s=busy,
                           idle_share=1 - busy / steady,
                           idle_share_of="the median unprofiled step",
                           top_device_ms=top_ms(times, 8))
            steps.append(row)
        self.launches[label] = total
        trace = [(r["loss"], r["grad_norm"]) for r in steps]
        if not all(math.isfinite(r["grad_norm"]) and math.isfinite(r["loss"])
                   for r in steps):
            raise AssertionError(f"{cfg.name}: a loss or grad norm is not "
                                 f"finite: {trace}")
        if falls and not steps[4]["loss"] < steps[0]["loss"]:
            raise AssertionError(f"{cfg.name}: the loss of step 4 is not "
                                 f"below step 0's on batch 0: {trace}")
        steady = steps[1:-1]
        info.update(steps=steps, loss_falls=falls,
                    step_s_median=statistics.median(r["wall_s"]
                                                    for r in steady),
                    tokens_per_s_median=statistics.median(
                        r["tokens_per_s"] for r in steady),
                    peak_mem_gb=max(r["peak_mem_gb"] for r in steps))
        del state, batches
        self.attn_inputs[label] = seen
        return info, next(iter(seen.values()))

    def train_mamba(self, K, configs, models):
        """(c) mamba2-130m at full width through ``launch.train``'s step
        under ``RestartManager`` and ``CheckpointManager`` (keep 2, in a
        temporary directory removed at the end): 12 steps of 4 x 4,096 on
        two recurring batches, a checkpoint every 5 steps, a fault at step
        7.  Then the trained float32 master weights prefill 2 x 4,096
        tokens and take 16 decode steps, held against ``forward`` over the
        same 4,352 tokens within ``DECODE_TOL``."""
        torch, np = self.torch, self.np
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.data import DataConfig, synth_batch
        from repro_torch.distributed import RestartManager
        from repro_torch.launch import train
        from repro_torch.optim import adamw
        cfg = configs.get_config(SSM_ARCH)
        t0 = time.perf_counter()
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(3)
        params = models.init_params(cfg, gen, device=self.dev)
        n = n_params(params)
        if n != expected_params(cfg):
            raise AssertionError(f"mamba2: {n} parameters")
        state = adamw.init(params)
        del params
        torch.cuda.synchronize()
        info = {"arch": cfg.name, "params": n, "layers": cfg.n_layers,
                "d_model": cfg.d_model, "state": cfg.ssm_state,
                "batch": SSM_BATCH, "seq": SSM_SEQ,
                "init_s": time.perf_counter() - t0}
        ocfg = adamw.AdamWConfig(lr=SSM_LR, warmup_steps=5,
                                 total_steps=SSM_STEPS)
        dcfg = DataConfig(seq_len=SSM_SEQ, global_batch=SSM_BATCH)
        batches = [train.batch_to_device(synth_batch(cfg, dcfg, i), self.dev)
                   for i in range(2)]
        runs = []

        def step_fn(state, i):
            t1 = time.perf_counter()
            state, m = train.train_step(cfg, ocfg, state, batches[i % 2])
            loss = float(m["loss"])
            runs.append({"step": i, "loss": loss,
                         "grad_norm": float(m["grad_norm"]),
                         "wall_s": time.perf_counter() - t1})
            return state

        K.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as d:
            ckpt = CheckpointManager(d, keep=SSM_KEEP)
            rm = RestartManager(ckpt, save_every=SSM_SAVE_EVERY)
            t1 = time.perf_counter()
            final, state = rm.run(state, step_fn, num_steps=SSM_STEPS,
                                  inject_fault_at=SSM_FAULT_AT)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t1
            kept = ckpt.list_steps()
            ckpt_gb = sum(f.stat().st_size for f in
                          Path(d, f"step_{kept[-1]:08d}").iterdir()) / 1e9
        self.launches["train_ssm"] = {k: v for k, v in K.LAUNCHES.items()
                                      if v}
        losses = {r["step"]: r["loss"] for r in runs}
        if (rm.restarts, final, int(state.step)) != (1, SSM_STEPS,
                                                     SSM_STEPS):
            raise AssertionError(f"mamba2: restarts {rm.restarts}, final "
                                 f"{final}, optimizer step "
                                 f"{int(state.step)}")
        if kept != [SSM_STEPS - 2, SSM_STEPS]:
            raise AssertionError(f"mamba2: checkpoints kept {kept}")
        if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                   for r in runs) or not losses[10] < losses[0]:
            raise AssertionError(f"mamba2: losses {losses}")
        info["train"] = {
            "steps_run": [r["step"] for r in runs], "runs": runs,
            "restarts": rm.restarts, "final_step": final,
            "optimizer_step": int(state.step), "checkpoints_kept": kept,
            "checkpoint_gb": ckpt_gb, "run_s": run_s,
            "tokens_per_s_median": statistics.median(
                SSM_BATCH * SSM_SEQ / r["wall_s"] for r in runs[1:]),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "loss_falls": [losses[0], losses[10]]}
        del batches

        # prefill and decode with the trained float32 master weights
        params = state.master
        toks = torch.as_tensor(np.random.default_rng(16).integers(
            0, cfg.vocab, (SSM_DECODE_BATCH, SSM_SEQ + 256)), device=self.dev)
        t1 = time.perf_counter()
        with torch.no_grad():
            full = models.forward(params, toks, cfg)
            want = full[:, SSM_SEQ - 1:SSM_SEQ + SSM_DECODE].clone()
            del full
            last, caches = models.prefill(params, toks[:, :SSM_SEQ], cfg)
            cache = [{"conv": caches["conv"][i], "ssm": caches["ssm"][i]}
                     for i in range(cfg.n_layers)]
            got = [last]
            for t in range(SSM_DECODE):
                pos = SSM_SEQ + t
                lg, cache = models.decode_step(params, cache,
                                               toks[:, pos:pos + 1], pos, cfg)
                got.append(lg)
            got = torch.cat(got, dim=1)
        torch.cuda.synchronize()
        bound = DECODE_TOL["atol"] + DECODE_TOL["rtol"] * want.abs()
        share = float(((got - want).abs() / bound).max())
        if not (bool(torch.isfinite(got).all()) and share <= 1):
            raise AssertionError(f"mamba2 decode: {share:.3g} of DECODE_TOL "
                                 f"against forward")
        info["decode"] = {"prefill": [SSM_DECODE_BATCH, SSM_SEQ],
                          "decode_steps": SSM_DECODE, "dtype": "float32",
                          "max_abs_err": float((got - want).abs().max()),
                          "bound_used": share, "tolerance": DECODE_TOL,
                          "seconds": time.perf_counter() - t1}
        del state, params, cache, caches
        return info

    def train_path(self, K, configs, models):
        """Phase train: (a) the flash backward's checks, (b) danube, (d)
        gemma3-4b at GEMMA_TRAIN_LAYERS layers, (c) mamba2, and the
        backward kernels on danube's own layer-0 q/k/v and on gemma3's
        first local and first global layer's.  Returns its line and
        {"danube": (q, k, v, kw, out, lse, dout), "gemma3_local": ...,
        "gemma3_global": ...} for the rows of phase 7."""
        info = {"phase": "train", "kernels": self.compare_flash_bwd(K)}
        info["danube"], qkv = self.train_lm(
            K, models, configs.get_config(TRAIN_ARCH), 2, TRAIN_STEPS,
            "train")
        self.torch.cuda.empty_cache()
        seen = {"danube": self.bwd_inputs(K, qkv, 60)}
        q, k, _, kw = seen["danube"][:4]
        self.bwd_split = info["danube"]["bwd_split"]
        info["kernels"]["danube_layer0"] = {
            "q": list(q.shape), "kv_heads": k.shape[1], **kw,
            "bound_used": self.bound_used["flash_attention_bwd"],
            "lse_bound_used": self.lse_used, "split": self.bwd_split}
        cfg = dataclasses.replace(configs.get_config(GEMMA_ARCH),
                                  n_layers=GEMMA_TRAIN_LAYERS)
        info["gemma3"], _ = self.train_lm(K, models, cfg, 8,
                                          GEMMA_TRAIN_STEPS, "train_gemma3")
        info["gemma3"]["of_layers"] = configs.get_config(
            GEMMA_ARCH).n_layers
        self.gemma_train_windows = [cfg.window_for_layer(i)
                                    for i in range(cfg.n_layers)]
        for key, seed in (("gemma3_local", 63), ("gemma3_global", 64)):
            window = cfg.sliding_window if key == "gemma3_local" else 0
            seen[key] = self.bwd_inputs(
                K, self.attn_inputs["train_gemma3"][window], seed)
        info["kernels"]["gemma3"] = {
            "q": list(seen["gemma3_local"][0].shape),
            "kv_heads": seen["gemma3_local"][1].shape[1],
            "windows": [cfg.sliding_window, 0],
            "bound_used": self.bound_used["flash_attention_bwd"],
            "lse_bound_used": self.lse_used}
        self.attn_inputs.clear()
        self.torch.cuda.empty_cache()
        info["mamba2"] = self.train_mamba(K, configs, models)
        self.torch.cuda.empty_cache()
        return info, seen

    # -- phase zoo: the hybrid, vlm and audio families at full width ---------

    def zoo_flash(self, K):
        """(a) B7 against its plain version on ``ZOO_FLASH_CASES`` (hd 112
        causal, with a window, softcap and rep 4, S off the tiles; hd 80
        and 112 without a mask), each in bfloat16 (the wgmma kernel) and
        float32 (the scalar kernel), within ``FLASH_TOL``."""
        torch = self.torch
        t0 = time.perf_counter()
        used = {}
        for i, (b, h, kv, s, hd, causal, win, cap) in enumerate(
                ZOO_FLASH_CASES):
            for dtype in (torch.bfloat16, torch.float32):
                g = torch.Generator(device=self.dev)
                g.manual_seed(70 + i)
                q, k, v = ((torch.randn(shape, generator=g, device=self.dev)
                            * 0.5).to(dtype)
                           for shape in ((b, h, s, hd), (b, kv, s, hd),
                                         (b, kv, s, hd)))
                kw = dict(causal=causal, window=win, softcap_val=cap)
                bq, bk = K.flash_attn.kernel_tiles(dtype, hd)
                bq = bq if s % bq == 0 else s      # rows are independent
                want = K.flash_attention_plain(q, k, v, bq=bq, bk=bk, **kw)
                got = K.flash_attention(q, k, v, **kw)
                _, elem, frob = self.bound_shares(got, want)
                key = str(dtype).split(".")[-1]
                u = used.setdefault(key, {"element": 0.0, "frobenius": 0.0})
                u["element"] = max(u["element"], elem)
                u["frobenius"] = max(u["frobenius"], frob)
                self.close("flash_attention", got, want)
                del q, k, v, want, got
        torch.cuda.synchronize()
        return {"cases": [dict(zip(("batch", "heads", "kv_heads", "seq",
                                    "hd", "causal", "window", "softcap"), c))
                          for c in ZOO_FLASH_CASES],
                "dtypes": ["bfloat16", "float32"], "tolerance": FLASH_TOL,
                "bound_used": used, "seconds": time.perf_counter() - t0}

    def zoo_params(self, models, cfg, seed):
        """``cfg``'s bfloat16 parameters from a torch.Generator on the card
        seeded ``seed``, counted against the config."""
        gen = self.torch.Generator(device=self.dev)
        gen.manual_seed(seed)
        params = models.init_params(cfg, gen, device=self.dev)
        if n_params(params) != expected_params(cfg):
            raise AssertionError(f"{cfg.name}: {n_params(params)} "
                                 f"parameters, expected "
                                 f"{expected_params(cfg)}")
        return params

    def zoo_prefill(self, K, label, run, calls, tokens):
        """``run()`` (a prefill's or an encode's logits, no gradient) once
        to warm up, once timed with the launch counters from 0 (kept under
        ``label``), once under the profiler: B7 must launch ``calls``
        times and the logits be finite; the kernel is held against its
        plain version on the first call's q, k and v (the model's strided
        views), which are returned with its options."""
        torch = self.torch
        from repro_torch.models import layers
        seen, real = [], layers.flash_attention

        def spy(q, k, v, **kw):
            if not seen:
                seen.append((q, k, v, kw))
            return real(q, k, v, **kw)

        with torch.no_grad():
            run()
            torch.cuda.synchronize()
            layers.flash_attention = spy
            try:
                K.reset_launches()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                logits = run()
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
                launches = {k: v for k, v in K.LAUNCHES.items() if v}
            finally:
                layers.flash_attention = real
            self.launches[label] = launches
            if launches.get("flash_attention", 0) != calls:
                raise AssertionError(f"{label}: launches {launches}, "
                                     f"expected {calls} flash_attention")
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{label}: logits not finite")
            line = {"batch": logits.shape[0], "run_s": run_s,
                    "tokens_per_s": tokens / run_s, "launches": launches,
                    "logits_finite": True,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            del logits
            q, k, v, kw = seen[0]
            self.flash_case(K, q, k, v, **kw)
            t0 = time.perf_counter()
            with self.profile() as prof:
                run()
                torch.cuda.synchronize()
        times = device_times(prof)
        busy = sum(times.values()) / 1e6
        line.update(kernel_held_on={"q": list(q.shape), **kw},
                    device_busy_s=busy, idle_share=1 - busy / run_s,
                    profile_s=time.perf_counter() - t0,
                    top_device_ms=top_ms(times, 6))
        return line, seen[0]

    def zoo_serve(self, K, serving, models, cfg, params, label):
        """``serve_checked`` on the first ``ZOO_SERVE_LAYERS`` layers of
        the full-width model (views into its stacked weights).  No image
        tokens: the engine decodes as the reference's does."""
        n = ZOO_SERVE_LAYERS[cfg.name]
        sliced = dict(params, layers={k: v[:n] for k, v in
                                      params["layers"].items()})
        _, line = self.serve_checked(K, serving, models,
                                     dataclasses.replace(cfg, n_layers=n),
                                     sliced, label)
        return dict(line, layers=n, of=cfg.n_layers)

    def zoo_decode(self, models, cfg, params, toks, img=None):
        """Float32 parameters: ``decode_step`` from an empty float32 cache,
        the tokens one at a time, each step's logits against ``forward``
        over the same tokens at that position within ``DECODE_TOL``."""
        torch = self.torch
        t0 = time.perf_counter()
        with torch.no_grad():
            want = models.forward(params, toks, cfg, img=img)
            cache = models.init_decode_cache(cfg, toks.shape[0],
                                             toks.shape[1], torch.float32,
                                             device=self.dev)
            got = []
            for t in range(toks.shape[1]):
                lg, cache = models.decode_step(params, cache,
                                               toks[:, t:t + 1], t, cfg,
                                               img=img)
                got.append(lg)
            got = torch.cat(got, dim=1)
        torch.cuda.synchronize()
        bound = DECODE_TOL["atol"] + DECODE_TOL["rtol"] * want.abs()
        share = float(((got - want).abs() / bound).max())
        if not (bool(torch.isfinite(got).all()) and share <= 1):
            raise AssertionError(f"{cfg.name} decode: {share:.3g} of "
                                 f"DECODE_TOL against forward")
        return {"steps": toks.shape[1], "batch": toks.shape[0],
                "dtype": "float32", "image_tokens": None if img is None
                else img.shape[1],
                "max_abs_err": float((got - want).abs().max()),
                "bound_used": share, "tolerance": DECODE_TOL,
                "seconds": time.perf_counter() - t0}

    def zoo_lm(self, K, models, serving, cfg, seed, label, img=None):
        """(b)/(c): ``cfg`` at full width and depth prefills ZOO_BATCH x
        ZOO_SEQ tokens (with ``img`` for the vlm family), serves at a cut
        depth, then, cast to float32 leaf by leaf, decodes ZOO_DECODE
        tokens against its forward.  Returns its line and the first B7
        call's inputs."""
        torch = self.torch
        t0 = time.perf_counter()
        params = self.zoo_params(models, cfg, seed)
        torch.cuda.synchronize()
        line = {"arch": cfg.name, "params": n_params(params),
                "layers": cfg.n_layers, "d_model": cfg.d_model,
                "heads": [cfg.n_heads, cfg.n_kv_heads], "hd": cfg.hd,
                "attention_calls": attention_calls(cfg),
                "init_s": time.perf_counter() - t0}
        tokens = torch.as_tensor(self.np.random.default_rng(seed).integers(
            0, cfg.vocab, (ZOO_BATCH, ZOO_SEQ)), device=self.dev)
        line["prefill"], held = self.zoo_prefill(
            K, label, lambda: models.prefill(params, tokens, cfg,
                                             img=img)[0],
            attention_calls(cfg), ZOO_BATCH * ZOO_SEQ)
        line["serve"] = self.zoo_serve(K, serving, models, cfg, params,
                                       label + "_serve")
        to_float32_(torch, params)
        line["decode"] = self.zoo_decode(
            models, cfg, params, tokens[:, :ZOO_DECODE],
            None if img is None else img.float())
        del params
        torch.cuda.empty_cache()
        return line, held

    def zoo_path(self, K, configs, models, serving):
        """Phase zoo, (a)-(e) of ``ZOO_*``'s comment.  Returns its line
        and the kernels' inputs at the families' shapes (for the rows of
        phase 7): B7's first call in each prefill or encode, and each
        training run's first call with B7's out and lse and a seeded
        dout, the backward held against its plain version there."""
        torch = self.torch
        info = {"phase": "zoo", "flash": self.zoo_flash(K)}
        seen = {}
        cfg = configs.get_config(ZOO_HYBRID)
        info["hybrid"], seen["hybrid"] = self.zoo_lm(K, models, serving, cfg,
                                                     4, "zoo_hybrid")
        cfg = configs.get_config(ZOO_VLM)
        g = torch.Generator(device=self.dev)
        g.manual_seed(5)
        img = torch.randn((ZOO_BATCH, cfg.n_image_tokens, cfg.d_model),
                          generator=g, device=self.dev).to(torch.bfloat16)
        info["vlm"], seen["vlm"] = self.zoo_lm(K, models, serving, cfg, 5,
                                               "zoo_vlm", img=img)
        info["vlm"]["image_tokens"] = cfg.n_image_tokens
        del img

        # (d) hubert-xlarge: the encoder, then training
        cfg = configs.get_config(ZOO_AUDIO)
        t0 = time.perf_counter()
        params = self.zoo_params(models, cfg, 6)
        frames = torch.randn((ZOO_BATCH, ZOO_SEQ, cfg.d_model), generator=g,
                             device=self.dev)
        line = {"arch": cfg.name, "params": n_params(params),
                "layers": cfg.n_layers, "d_model": cfg.d_model,
                "heads": [cfg.n_heads, cfg.n_kv_heads], "hd": cfg.hd,
                "causal": cfg.causal, "init_s": time.perf_counter() - t0}
        line["encode"], seen["audio"] = self.zoo_prefill(
            K, "zoo_audio", lambda: models.forward(params, None, cfg,
                                                   frames=frames),
            attention_calls(cfg), ZOO_BATCH * ZOO_SEQ)
        line["encode"]["frames_per_s"] = line["encode"].pop("tokens_per_s")
        del params, frames
        torch.cuda.empty_cache()
        line["train"], qkv = self.train_lm(K, models, cfg, 6,
                                           ZOO_AUDIO_STEPS, "zoo_audio_train")
        seen["audio_bwd"] = self.bwd_inputs(K, qkv, 61)
        info["audio"] = line
        torch.cuda.empty_cache()

        # (e) zamba2-7b training at a cut depth
        cfg = dataclasses.replace(configs.get_config(ZOO_HYBRID),
                                  n_layers=ZOO_HYBRID_TRAIN_LAYERS)
        info["hybrid_train"], qkv = self.train_lm(
            K, models, cfg, 7, ZOO_HYBRID_TRAIN_STEPS, "zoo_hybrid_train",
            falls=False)
        info["hybrid_train"]["of_layers"] = configs.get_config(
            ZOO_HYBRID).n_layers
        seen["hybrid_bwd"] = self.bwd_inputs(K, qkv, 62)
        torch.cuda.empty_cache()
        return info, seen

    # -- phase registry: the registry's untouched cells (A23) ---------------

    def reg_load(self, models, cfg, seed, dtype=None):
        """``cfg``'s parameters from a generator on the card seeded
        ``seed`` (the one model kept, freed before another is made), drawn
        in ``dtype`` (float32 for the float32 checks: no cast copy)."""
        torch = self.torch
        key = (cfg.name, cfg.n_layers, seed, str(dtype))
        if self.reg_params is not None and self.reg_params[0] == key:
            return self.reg_params[1]
        self.reg_params = None
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(seed)
        params = models.init_params(cfg, gen, device=self.dev,
                                    dtype=dtype or torch.bfloat16)
        if n_params(params) != expected_params(cfg):
            raise AssertionError(f"{cfg.name}: {n_params(params)} "
                                 f"parameters, expected "
                                 f"{expected_params(cfg)}")
        torch.cuda.synchronize()
        self.reg_init_s[f"{cfg.name}/{cfg.n_layers}/{dtype}"] = \
            time.perf_counter() - t0
        self.reg_params = (key, params)
        return params

    def reg_plan(self, dryrun, cfg, kind, batch, seq, dtype=None,
                 layers=None):
        """``launch.dryrun.plan_cut`` at the card's budget; raises where
        one period of layers does not fit."""
        torch = self.torch
        t0 = time.perf_counter()
        p = dryrun.plan_cut(cfg, kind, batch, seq, budget=self.reg_budget,
                            dtype=dtype or torch.bfloat16, layers=layers)
        p["plan_s"] = time.perf_counter() - t0
        self.reg_plan_s += p["plan_s"]
        if not p["fits"]:
            raise AssertionError(f"{cfg.name} {kind} {batch} x {seq}: one "
                                 f"period does not fit: {p}")
        return p

    def reg_tokens(self, cfg, shape, seed):
        return self.torch.as_tensor(self.np.random.default_rng(seed).integers(
            0, cfg.vocab, shape), device=self.dev)

    @contextlib.contextmanager
    def spy_tickets(self, seen):
        """B6's first call of the block: its expert ids (a copy) and
        options into ``seen``."""
        moe_route = importlib.import_module("repro_torch.kernels.moe_route")
        real = moe_route.expert_tickets

        def spy(ids, **kw):
            if not seen:
                seen.append((ids.clone(), kw))
            return real(ids, **kw)
        moe_route.expert_tickets = spy
        try:
            yield
        finally:
            moe_route.expert_tickets = real

    def dense_rows(self, q, k, v, out, kw):
        """B7's ``out`` against the exact float32 attention of DENSE_ROWS
        query rows at the start, the middle and the end of the sequence,
        for the first and the last (batch, head) pair and one between,
        within DENSE_TOL; the same rows read one row later must fail.
        Returns the bounds' largest shares."""
        torch = self.torch
        b, h, sq, hd = q.shape
        sk, rep = k.shape[2], h // k.shape[1]
        causal, win, cap = kw["causal"], kw["window"], kw["softcap_val"]
        starts = (0, sq // 2 // DENSE_ROWS * DENSE_ROWS, sq - DENSE_ROWS)
        pairs = sorted({(0, 0), (b - 1, h - 1), (b // 2, (h - 1) // 2)})
        kpos = torch.arange(sk, device=self.dev)
        used = {"element": 0.0, "frobenius": 0.0}
        moved = []
        for bi, hi in pairs:
            kk, vv = k[bi, hi // rep].float(), v[bi, hi // rep].float()
            for r0 in starts:
                qpos = torch.arange(r0, r0 + DENSE_ROWS, device=self.dev)
                s = q[bi, hi, r0:r0 + DENSE_ROWS].float() @ kk.T
                s = s * (1.0 / hd ** 0.5)
                if cap:
                    s = cap * torch.tanh(s / cap)
                ok = torch.ones_like(s, dtype=torch.bool)
                if causal:
                    ok &= kpos[None, :] <= qpos[:, None]
                if win:
                    ok &= kpos[None, :] > qpos[:, None] - win
                want = torch.softmax(s.masked_fill(~ok, float("-inf")),
                                     -1) @ vv
                _, elem, frob = self.bound_shares(
                    out[bi, hi, r0:r0 + DENSE_ROWS].float(), want, DENSE_TOL)
                used["element"] = max(used["element"], elem)
                used["frobenius"] = max(used["frobenius"], frob)
                if elem > 1 or frob > 1:
                    raise AssertionError(
                        f"B7 at {sk} keys: rows {r0}.. of (batch {bi}, head "
                        f"{hi}) use {elem:.3g} / {frob:.3g} of DENSE_TOL")
                r1 = r0 + 1 if r0 + DENSE_ROWS < sq else r0 - 1
                _, e1, f1 = self.bound_shares(
                    out[bi, hi, r1:r1 + DENSE_ROWS].float(), want, DENSE_TOL)
                if e1 <= 1 and f1 <= 1:
                    raise AssertionError(f"B7 at {sk} keys: rows moved by "
                                         f"one passed DENSE_TOL")
                moved.append(max(e1, f1))
        self.cases["flash_attention_dense_rows"] = self.cases.get(
            "flash_attention_dense_rows", 0) + len(pairs) * len(starts)
        return {"q": list(q.shape), "kv_heads": k.shape[1], "keys": sk,
                "causal": causal, "window": win, "softcap": cap,
                "row_starts": list(starts), "pairs": pairs,
                "tolerance": DENSE_TOL, "bound_used": used,
                "moved_rows_least_share": min(moved)}

    def reg_prefill(self, K, models, cfg, params, tokens, label, held=(0,)):
        """One prefill of ``tokens`` (no gradient) with the launch counters
        from 0 (kept under ``label``): B7 once a self-attention layer,
        held against the dense rows on the calls in ``held`` inside the
        call (no q, k or v outlives it; the check's seconds are left out
        of the prefill's); B6 once a MoE layer, its first call's ids kept.
        Returns (logits, K/V or states, line, [(ids, kw)])."""
        torch = self.torch
        from repro_torch.models import layers
        real = layers.flash_attention
        calls, checks, check_s, tickets = [0], {}, [0.0], []

        def spy(q, k, v, **kw):
            out = real(q, k, v, **kw)
            if calls[0] in held:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                checks[str(calls[0])] = self.dense_rows(q, k, v, out, kw)
                torch.cuda.synchronize()
                check_s[0] += time.perf_counter() - t0
            calls[0] += 1
            return out

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        layers.flash_attention = spy
        try:
            with self.spy_tickets(tickets), torch.no_grad():
                K.reset_launches()
                t0 = time.perf_counter()
                logits, caches = models.prefill(params, tokens, cfg)
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0 - check_s[0]
                launches = {k: v for k, v in K.LAUNCHES.items() if v}
        finally:
            layers.flash_attention = real
        self.launches[label] = launches
        self.reg_b7_record(label, cfg, *tokens.shape,
                           str(params["final_norm"].dtype).split(".")[-1])
        if launches.get("flash_attention", 0) != attention_calls(cfg) or (
                cfg.family == "moe"
                and launches.get("expert_tickets", 0) != cfg.n_layers):
            raise AssertionError(f"{label}: launches {launches}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{label}: logits not finite")
        if cfg.final_softcap and float(logits.abs().max()) > \
                cfg.final_softcap:
            raise AssertionError(f"{label}: logits past the final softcap")
        b, s = tokens.shape
        return logits, caches, {
            "batch": b, "seq": s, "layers": cfg.n_layers, "run_s": run_s,
            "tokens_per_s": b * s / run_s, "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "dense_rows": checks, "dense_check_s": check_s[0]}, tickets

    def reg_ring(self, t, keep, sc, shift):
        """A layer's cache of ``sc`` slots after ``keep`` positions of ``t``
        (B, >= keep, kv, hd): slot p % sc holds position p, for the last
        ``sc`` positions before ``keep``; with ``shift`` each position one
        slot later.  A global layer's cache is ``t`` itself, its slots
        from ``keep`` on zeroed (a decode step must write the position it
        reads), shifted in place: the shifted run comes last."""
        torch = self.torch
        if sc == t.shape[1]:
            t[:, keep:] = 0
            if shift:
                t[:, 1:keep] = t[:, :keep - 1].clone()
            return t
        out = torch.zeros((t.shape[0], sc) + tuple(t.shape[2:]),
                          dtype=t.dtype, device=t.device)
        lo = max(keep - sc, 0)
        pos = torch.arange(lo, keep, device=t.device)
        out[:, (pos + int(shift)) % sc] = t[:, lo:keep]
        return out

    def reg_cache(self, cfg, kv, shared, keep, n, shift):
        """The decode cache after ``keep`` of ``n`` tokens from a prefill's
        ``kv`` (K/V stacked, or the SSM states of a prefill of ``keep``
        tokens and ``shared``, the hybrid's shared-block K/V of that
        prefill); ``shift`` moves every position one later (an SSM
        layer's conv window too)."""
        cache = []
        if cfg.family in ("ssm", "hybrid"):
            blocks = iter(shared)
            for i in range(cfg.n_layers):
                conv = kv["conv"][i].clone()
                if shift:
                    conv[:, 1:] = conv[:, :-1].clone()
                e = {"conv": conv, "ssm": kv["ssm"][i].clone()}
                if cfg.family == "hybrid" and cfg.shared_attn_every and \
                        (i + 1) % cfg.shared_attn_every == 0:
                    k, v = next(blocks)
                    e["k"], e["v"] = (self.reg_ring(t, keep, n, shift)
                                      for t in (k, v))
                cache.append(e)
            return cache
        for i in range(cfg.n_layers):
            w = cfg.window_for_layer(i)
            sc = min(w, n) if w else n
            cache.append({key: self.reg_ring(kv[key][i], keep, sc, shift)
                          for key in ("k", "v")})
        return cache

    def against_prefill(self, K, models, cfg, params, tokens, tail, label,
                        held=(0,)):
        """A decode after a prefill against the prefill over all ``n``
        tokens: the cache holds the first ``n - tail`` positions (the
        attention families' from the prefill over all ``n``, the SSM
        families' states from a prefill of ``n - tail`` tokens), then
        ``tail`` decode steps.  The last step's logits against the
        prefill's last-token logits (float32: DECODE_TOL; bfloat16:
        LOGITS_TOL_BF16); each mixer layer's outputs (attention or SSM) at
        the ``tail`` steps against the prefill's rows at those positions,
        ||decode - prefill|| / ||prefill|| within LAYER_TOL (an attention
        family's first layer in bfloat16 within LAYER0_TOL_BF16); the K
        and V each step leaves in its slot against the ones it computed,
        within WRITE_TOL.  The same with the cache shifted by one position
        must fail, and so must a decode whose steps skip their cache write
        (a planted fault, where there is a cache).  B7 held against the
        dense rows on the calls in ``held``."""
        torch = self.torch
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T
        b, n = tokens.shape
        keep = n - tail
        dt = "float32" if params["final_norm"].dtype == torch.float32 \
            else "bfloat16"
        rows, shared, mode = [], [], ["full"]
        wrote, skip = [], [False]
        real_attn, real_ssm = T.attention, T.ssm_forward

        class NoWrite(torch.Tensor):
            """A cache whose item assignments are dropped: the planted
            decode's steps skip their K/V write."""
            @classmethod
            def __torch_function__(cls, func, types, args=(), kwargs=None):
                if func is torch.Tensor.__setitem__:
                    return None
                with torch._C.DisableTorchFunctionSubclass():
                    return func(*args, **(kwargs or {}))

        def record(out):
            if mode[0] == "full":
                rows.append(out[:, keep:].float())
            elif mode[0] == "decode":
                rows.append(out[:, -1:].float())

        def attn_spy(p, x, c, **kw):
            cache = kw.get("cache")
            if cache is not None and skip[0]:
                kw["cache"] = (cache[0].as_subclass(NoWrite),
                               cache[1].as_subclass(NoWrite), cache[2])
            out, kv = real_attn(p, x, c, **kw)
            record(out)
            if mode[0] == "decode" and cache is not None:
                # the step's own K and V, as attention computes them,
                # against what its slot holds after the step
                own = [(x @ p[w]).reshape(x.shape[0], 1, c.n_kv_heads,
                                          c.hd) for w in ("wk", "wv")]
                own[0] = L.rope(own[0], kw["positions"], c.rope_theta)
                slot = int(cache[2]) % cache[0].shape[1]
                wrote.append(max(
                    float((t[:, slot].float() - o[:, 0].float()).norm()
                          / o.float().norm()) / WRITE_TOL
                    for t, o in zip(cache[:2], own)))
            if mode[0] == "keep" and cfg.family == "hybrid":
                shared.append(kv)
            return out, kv

        def ssm_spy(p, x, c, **kw):
            out, st = real_ssm(p, x, c, **kw)
            record(out)
            return out, st

        T.attention, T.ssm_forward = attn_spy, ssm_spy
        try:
            want, kv, line, _ = self.reg_prefill(K, models, cfg, params,
                                                 tokens, label, held)
            want_rows = rows[:]
            del rows[:]
            with torch.no_grad():
                if cfg.family in ("ssm", "hybrid"):
                    mode[0] = "keep"
                    kv = models.prefill(params, tokens[:, :keep], cfg)[1]
                    torch.cuda.synchronize()

                def decode(shift, skip_write=False):
                    cache = self.reg_cache(cfg, kv, shared, keep, n, shift)
                    steps = []
                    del wrote[:]
                    mode[0], skip[0] = "decode", skip_write
                    t0 = time.perf_counter()
                    for t in range(tail):
                        del rows[:]
                        lg, cache = models.decode_step(
                            params, cache, tokens[:, keep + t:keep + t + 1],
                            keep + t, cfg)
                        steps.append(rows[:])
                    torch.cuda.synchronize()
                    mode[0], skip[0] = "off", False
                    return lg, [torch.cat(c, 1) for c in zip(*steps)], \
                        time.perf_counter() - t0, wrote[:]
                got, got_rows, decode_s, got_kv = decode(False)
                lost = decode(False, True) if got_kv else None
                bad, bad_rows, _, _ = decode(True)
        finally:
            T.attention, T.ssm_forward = real_attn, real_ssm

        def write_share(kv_wrote):
            """The largest share of WRITE_TOL among the steps' slots."""
            if len(kv_wrote) != attention_calls(cfg) * tail:
                raise AssertionError(f"{label}: {len(kv_wrote)} cache "
                                     f"writes, expected "
                                     f"{attention_calls(cfg)} x {tail}")
            return max(kv_wrote, default=0.0)

        def shares(lg, lrows):
            if dt == "float32":
                bound = DECODE_TOL["atol"] + DECODE_TOL["rtol"] * want.abs()
                logit = float(((lg - want).abs() / bound).max())
            else:
                logit = float((lg - want).norm() / want.norm()) \
                    / LOGITS_TOL_BF16
            if len(lrows) != len(want_rows):
                raise AssertionError(f"{label}: {len(lrows)} mixer calls a "
                                     f"step, the prefill {len(want_rows)}")
            layer = [float((g - w).norm() / w.norm()) / tol[i]
                     for i, (g, w) in enumerate(zip(lrows, want_rows))]
            return logit, max(layer, default=0.0), layer
        tol = [LAYER_TOL[dt]] * len(want_rows)
        if tol and dt == "bfloat16" and cfg.family not in ("ssm", "hybrid"):
            tol[0] = LAYER0_TOL_BF16
        ok, wrong = shares(got, got_rows), shares(bad, bad_rows)
        ok_write = write_share(got_kv)
        per_layer = {"ok": ok[2], "shifted": wrong[2]}
        if not bool(torch.isfinite(got).all()) or max(ok[:2]) > 1 or \
                ok_write > 1:
            raise AssertionError(f"{label}: decode against prefill uses "
                                 f"{ok[:2]} of (logits, layers) tolerances "
                                 f"and {ok_write} of the cache writes'; by "
                                 f"layer {per_layer}")
        if max(wrong[:2]) <= 1:
            raise AssertionError(f"{label}: a cache shifted by one passed "
                                 f"({wrong[:2]}); by layer {per_layer}")
        skipped = None
        if lost is not None:
            sk = shares(lost[0], lost[1])
            skipped = {"logits": sk[0], "layers": sk[1],
                       "cache_writes": write_share(lost[3])}
            if max(skipped.values()) <= 1:
                raise AssertionError(f"{label}: a decode that skips its "
                                     f"cache writes passed ({skipped})")
        line.update(tail=tail, kept=keep, dtype=dt, decode_s=decode_s,
                    bound_used={"logits": ok[0], "layers": ok[1],
                                "cache_writes": ok_write},
                    shifted_cache_shares={"logits": wrong[0],
                                          "layers": wrong[1]},
                    skipped_write_shares=skipped,
                    layer_shares=per_layer,
                    tolerance={"logits": DECODE_TOL if dt == "float32"
                               else {"frob": LOGITS_TOL_BF16},
                               "layers": {"frob": tol}})
        return line

    def decode_rate(self, K, models, cfg, params, batch, label):
        """D32_STEPS decode steps of ``batch`` rows with caches of D32_SEQ
        positions (zeros; every position counts as written), after one
        step to warm up: decode tokens out/s and the peak memory."""
        torch = self.torch
        with torch.no_grad():
            cache = models.init_decode_cache(cfg, batch, D32_SEQ,
                                             device=self.dev)
            tok = self.reg_tokens(cfg, (batch, 1), 41)
            cur = D32_SEQ - D32_STEPS - 1
            models.decode_step(params, cache, tok, cur, cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launches()
            t0 = time.perf_counter()
            for t in range(D32_STEPS):
                lg, cache = models.decode_step(params, cache, tok,
                                               cur + 1 + t, cfg)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        self.launches[label] = {k: v for k, v in K.LAUNCHES.items() if v}
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{label}: logits not finite")
        return {"batch": batch, "layers": cfg.n_layers,
                "cache_positions": D32_SEQ, "steps": D32_STEPS,
                "run_s": run_s, "step_ms": run_s / D32_STEPS * 1e3,
                "tokens_out_per_s": batch * D32_STEPS / run_s,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}

    def reg_b7_record(self, label, cfg, b, s, dtype):
        """A prefill's B7 calls (``cfg``, b x s tokens in ``dtype``),
        counted by window, for phase 7 to time at that shape."""
        calls = attention_calls(cfg)
        if not calls:
            return
        wins = ({0: calls} if cfg.family == "hybrid" else dict(
            collections.Counter(cfg.window_for_layer(i)
                                for i in range(cfg.n_layers))))
        self.reg_b7.append({"path": label, "q": [b, cfg.n_heads, s, cfg.hd],
                            "kv_heads": cfg.n_kv_heads, "dtype": dtype,
                            "causal": cfg.causal,
                            "softcap": cfg.attn_softcap, "windows": wins})

    def first_global(self, cfg):
        """The B7 call of a prefill on the first layer without a window
        (the hybrid's shared block: its first call)."""
        if cfg.family == "hybrid":
            return 0
        for i in range(cfg.n_layers):
            if not cfg.window_for_layer(i):
                return i
        return 0

    def reg_model_cells(self, K, dryrun, configs, models, serving, name,
                        seed):
        """(a), (b) and (c) of ``REG_*``'s comment for one config."""
        torch = self.torch
        cfg0 = configs.get_config(name)
        line = {"arch": name, "params": cfg0.param_count(),
                "layers": cfg0.n_layers, "d_model": cfg0.d_model,
                "heads": [cfg0.n_heads, cfg0.n_kv_heads], "hd": cfg0.hd}
        # (a) full width and depth, 2 x 4,096 in bfloat16
        params = self.reg_load(models, cfg0, seed)
        tokens = self.reg_tokens(cfg0, (REG_BATCH, REG_SEQ), seed)
        tickets = []
        with self.spy_tickets(tickets):
            line["prefill"], self.reg_seen[name] = self.zoo_prefill(
                K, f"reg_{name}", lambda: models.prefill(params, tokens,
                                                         cfg0)[0],
                attention_calls(cfg0), REG_BATCH * REG_SEQ)
        self.reg_b7_record(f"reg_{name}", cfg0, REG_BATCH, REG_SEQ,
                           "bfloat16")
        if cfg0.family == "moe":
            if line["prefill"]["launches"].get("expert_tickets") != \
                    cfg0.n_layers:
                raise AssertionError(f"{name}: B6 launches "
                                     f"{line['prefill']['launches']}")
            ids, kw = tickets[0]
            self.tickets_case(K, ids, kw["num_experts"], kw["capacity"],
                              calls=10)
            self.reg_tickets["prefill_4k"] = tickets[0]
            n = REG_SERVE_LAYERS
            sliced = dict(params, layers={k: v[:n] for k, v in
                                          params["layers"].items()})
            eng, serve = self.serve_checked(
                K, serving, models, dataclasses.replace(cfg0, n_layers=n),
                sliced, f"reg_{name}_serve")
            del eng                 # it holds views of the full model
            if serve["launches"].get("expert_tickets") != \
                    n * serve["metrics"]["decode_steps"]:
                raise AssertionError(f"{name} serve: B6 launches "
                                     f"{serve['launches']}")
            line["serve"] = dict(serve, layers=n, of=cfg0.n_layers)
            del sliced
        # (b) prefill_32k
        plan = self.reg_plan(dryrun, cfg0, "prefill", 1, P32_SEQ,
                             layers=P32_LAYERS)
        cfg = dryrun.with_layers(cfg0, plan["layers"])
        del params
        params = self.reg_load(models, cfg, seed)
        held = sorted({0, self.first_global(cfg)})
        logits, kv, p32, tickets = self.reg_prefill(
            K, models, cfg, params, self.reg_tokens(cfg, (plan["batch"],
                                                          P32_SEQ), seed),
            f"reg_{name}_p32k", held)
        del logits, kv
        if cfg.family == "moe":
            ids, kw = tickets[0]
            self.tickets_case(K, ids, kw["num_experts"], kw["capacity"],
                              calls=10)
            self.reg_tickets["prefill_32k"] = tickets[0]
        line["prefill_32k"] = dict(p32, plan=plan)
        self.reg_flash[f"{name}_32k"] = p32["dense_rows"]
        # (c) decode_32k: the rate at plan_cut's batch and depth
        if name in D32_ARCHS:
            plan = self.reg_plan(dryrun, cfg0, "decode", 128, D32_SEQ)
            cfg = dryrun.with_layers(cfg0, plan["layers"])
            del params
            params = self.reg_load(models, cfg, seed)
            line["decode_32k"] = dict(self.decode_rate(
                K, models, cfg, params, plan["batch"], f"reg_{name}_d32k"),
                plan=plan)
        del params
        self.reg_params = None
        # (a) the float32 decode against the forward, at plan_cut's depth
        plan = self.reg_plan(dryrun, cfg0, "decode", REG_BATCH, REG_DECODE,
                             dtype=torch.float32)
        cfg = dryrun.with_layers(cfg0, plan["layers"])
        params = self.reg_load(models, cfg, seed, torch.float32)
        line["decode_f32"] = dict(self.zoo_decode(
            models, cfg, params, tokens[:, :REG_DECODE]), plan=plan,
            layers=cfg.n_layers)
        del params
        # (c) decode against prefill at 32,768 positions, float32
        if name in D32_ARCHS:
            cfg = dryrun.with_layers(cfg0, D32_CHECK_LAYERS)
            params = self.reg_load(models, cfg, seed, torch.float32)
            line["decode_32k_check"] = self.against_prefill(
                K, models, cfg, params,
                self.reg_tokens(cfg, (1, D32_SEQ), seed + 1), D32_TAIL,
                f"reg_{name}_d32k_check",
                held=sorted({0, self.first_global(cfg)}))
            del params
        self.reg_params = None
        torch.cuda.empty_cache()
        return line

    def reg_long(self, K, dryrun, configs, models, name, seed):
        """(d) of ``REG_*``'s comment for one config."""
        torch = self.torch
        cfg0 = configs.get_config(name)
        f32 = cfg0.family == "ssm"
        dtype = torch.float32 if f32 else torch.bfloat16
        tail = L500_HYBRID_TAIL if cfg0.family == "hybrid" else L500_TAIL
        plan = self.reg_plan(dryrun, cfg0, "prefill", 1, L500_SEQ,
                             dtype=dtype, layers=L500_LAYERS.get(name))
        cfg = dryrun.with_layers(cfg0, plan["layers"])
        params = self.reg_load(models, cfg, seed, dtype)
        held = sorted({0, self.first_global(cfg)}) \
            if attention_calls(cfg) else []
        line = self.against_prefill(
            K, models, cfg, params, self.reg_tokens(cfg, (1, L500_SEQ),
                                                    seed),
            tail, f"reg_{name}_500k", held)
        self.reg_flash[f"{name}_500k"] = line["dense_rows"]
        self.reg_params = None
        del params
        torch.cuda.empty_cache()
        return dict(line, arch=name, plan=plan, of_layers=cfg0.n_layers)

    def registry_path(self, K, configs, models, serving):
        """Phase registry (``REG_*``'s comment).  Returns its line."""
        torch = self.torch
        from repro_torch.launch import dryrun
        t0 = time.perf_counter()
        self.reg_budget = dryrun.card_budget(self.dev)
        self.reg_params, self.reg_init_s, self.reg_plan_s = None, {}, 0.0
        self.reg_seen, self.reg_flash, self.reg_tickets = {}, {}, {}
        info = {"phase": "registry", "budget_bytes": self.reg_budget,
                "fit": dryrun.FIT}
        for i, name in enumerate(REG_ARCHS):
            info[name] = self.reg_model_cells(K, dryrun, configs, models,
                                              serving, name, 30 + i)
        info["long_500k"] = {
            name: self.reg_long(K, dryrun, configs, models, name, 40 + i)
            for i, name in enumerate(L500_ARCHS)}
        torch.cuda.synchronize()
        info["init_s"] = self.reg_init_s
        info["plan_s"] = self.reg_plan_s
        info["seconds"] = time.perf_counter() - t0
        return info

    def bwd_inputs(self, K, qkv, seed):
        """B7 with its lse and the backward against their plain versions
        (and the exact gradient) on a training run's first attention
        inputs; returns them with out, lse and dout for phase 7."""
        q, k, v, kw = qkv
        kw = {key: kw[key] for key in ("causal", "window", "softcap_val")}
        out, lse, dout = self.bwd_case(K, q, k, v, seed, **kw)
        return q, k, v, kw, out, lse, dout


def to_float32_(torch, tree) -> None:
    """Every tensor of a nested dict to float32 in place, a leaf at a
    time, each bfloat16 leaf given back to the card before the next (a
    full-width model's two copies need not fit together)."""
    for key in list(tree):
        if isinstance(tree[key], dict):
            to_float32_(torch, tree[key])
        else:
            tree[key] = tree[key].float()
            torch.cuda.empty_cache()


def n_params(params) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() for t in tree_leaves(params))


def expected_params(cfg) -> int:
    """``cfg.param_count()`` plus what the parameter tree holds beyond
    the analytic count: dt_bias (nh a Mamba2 layer), and a vlm's cross
    weights and ``cln``, which the tree stacks on every layer (as the
    reference's does) and the count keeps on the cross layers alone."""
    n = cfg.param_count()
    if cfg.family in ("ssm", "hybrid"):
        n += cfg.n_layers * cfg.ssm_nheads
    if cfg.family == "vlm":
        d, hd = cfg.d_model, cfg.hd
        cross = 2 * (d * cfg.n_heads * hd + d * cfg.n_kv_heads * hd) + d
        n += (cfg.n_layers - cfg.n_layers // cfg.cross_attn_every) * cross
    return n


def attention_calls(cfg) -> int:
    """The self-attention calls of one forward, each a B7 launch at a
    prompt of 2,048 tokens or more: one a layer, none in the ssm family,
    none on a vlm's cross layers (never the flash path), the hybrid's
    shared block once every ``shared_attn_every`` layers."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return L // cfg.shared_attn_every
    if cfg.family == "vlm":
        return L - L // cfg.cross_attn_every
    return L


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


def kernel_split(prof, names: dict) -> dict:
    """For each ``{label: name}``, the profiler's records of the kernels
    whose name holds ``name``: their count and mean device milliseconds."""
    from torch.autograd import DeviceType
    out = {label: {"records": 0, "ms": 0.0} for label in names}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        for label, name in names.items():
            if name in e.name():
                out[label]["records"] += 1
                out[label]["ms"] += e.duration_ns() / 1e6
    for x in out.values():
        x["ms"] = x["ms"] / x["records"] if x["records"] else None
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


# -- phase multicard: the queue meshes across processes ----------------------


def mc_admission_stream(torch, np, serving, mesh, dev, ticks):
    """ADM_TRAFFIC's first ``ticks`` ticks through ``ServingMeshEngine``
    on ``mesh`` (phase admission's stream, without its oracle and
    profiler): every tick's admitted list, then the drain.  Returns
    (result, rounds)."""
    traffic = dict(ADM_TRAFFIC, ticks=ticks)
    trace = serving.generate_trace(serving.TrafficConfig(**traffic))
    by_tick = {}
    for rid, a in enumerate(trace):
        by_tick.setdefault(a.tick, []).append(rid)
    need = [-(-(a.prompt_len + a.max_new_tokens) // ADM_PAGE_SIZE)
            for a in trace]
    e = serving.ServingMeshEngine(mesh=mesh, capacity_log2=ADM_CAP_LOG2,
                                  batch=ADM_BATCH, arity_log2=2,
                                  table_log2=ADM_TABLE_LOG2, device=dev)
    e.begin()
    free = list(range(e.table))[::-1]
    rid_of, seq, t, admitted = {}, 0, 0, []
    while t < ticks or e.occupancy() > 0:
        if t > ticks + 64:
            raise AssertionError("multicard admission: not drained")
        keys, idxs, needs = [], [], []
        for rid in by_tick.get(t, []):
            seq += 1
            urgent = trace[rid].priority == 0
            keys.append(2 * (seq + (0 if urgent else ADM_SLACK))
                        + (0 if urgent else 1))
            idx = free.pop()
            rid_of[idx] = rid
            idxs.append(idx)
            needs.append(need[rid])
        slots, pages = ((ADM_SLOTS, ADM_PAGES) if t < ticks
                        else (ADM_DRAIN_SLOTS, ADM_DRAIN_PAGES))
        adm = e.tick(keys, idxs, slots=slots, pages=pages, need=needs)
        admitted.append([rid_of.pop(i) for i in adm])
        free.extend(adm)
        t += 1
    if sum(len(a) for a in admitted) != len(trace):
        raise AssertionError("multicard admission: a request lost")
    return ({"ticks": t, "admitted": digest(np.asarray(
        [r for a in admitted for r in a] + [len(a) for a in admitted],
        np.int64)), "stats": [e.stats[k] for k in STATS]
        + [e.stats["host_syncs"]]}, e.stats["rounds"])


def mc_task_round(torch, np, mesh, dev, seeds):
    """Phase runtime's ``mesh_task_round`` tree (``seeds`` seeds on a ring
    of 2 x RT_RING_CAP slots whose tickets wrap 2^32, MESH_SHARDS x BATCH
    claims) on ``mesh``: one shard's rows a rank on a group-bound mesh,
    every shard's stacked on one card.  A round claims the first
    min(occupancy after its publish, S x BATCH) lanes in shard order; on
    a group-bound mesh the round's spawn total for that comes from one
    ``mesh_ticket_base``.  Returns (result, rounds)."""
    from repro_torch import core, runtime as rt
    from repro_torch.distributed import gather_rows, mesh_ticket_base
    vals = (np.random.default_rng(15).integers(0, 2 ** 27, seeds)
            << 4).astype(np.int32)
    step = fifo_tree_step(torch)
    s, me = mesh.shape["data"], mesh.rank
    lanes = torch.arange(s * BATCH, device=dev).reshape(s, BATCH)
    st = core.dist_queue_init(RT_RING_CAP, start=RT_START, device=dev)
    sv = torch.as_tensor(vals, device=dev).reshape(s, -1)
    sm = torch.ones_like(sv, dtype=torch.bool)
    if me is not None:
        sv, sm, lanes = sv[me], sm[me], lanes[me]
    acc = torch.zeros(4096, dtype=torch.int32, device=dev)
    rounds = pops = 0
    while True:
        spawned = (sm.sum() if me is None
                   else mesh_ticket_base(sm.sum(), mesh)[1])
        claim = lanes < st.occupancy.long() + spawned
        st, granted, cv, ok = rt.mesh_task_round(st, sv, sm, claim,
                                                 mesh=mesh)
        acc, cv, cm = step(acc, cv.reshape(-1), ok.reshape(-1))
        if me is None:
            sv, sm = cv.reshape(s, -1), cm.reshape(s, -1)
        else:
            sv, sm = cv.reshape(-1), cm.reshape(-1)
        rounds += 1
        # the round's one readback: occupancy, pops and pending spawns
        occ, got, more = torch.stack([
            st.occupancy.long(), ok.sum().long(),
            (sm.any() if me is None
             else mesh_ticket_base(sm.sum(), mesh)[1] > 0).long()]).tolist()
        pops += got
        if occ == 0 and not more:
            break
    if me is not None:
        acc = gather_rows(acc, mesh).sum(0, dtype=torch.int32)
        pops = int(mesh_ticket_base(torch.tensor(pops, device=dev),
                                    mesh)[1])
    return ({"rounds": rounds, "pops": pops,
             "acc": digest(acc.cpu().numpy()),
             "state": digest(*(p.cpu().numpy() for p in st[:4])),
             "head_tail": [int(st.head), int(st.tail)]}, rounds)


def mc_cells(torch, np, mesh, names, dev, cut=False, mark=None):
    """The multicard cells ``names`` on ``mesh`` (MESH_SHARDS, or 2 for
    ``goldens``, shards: one card's stacked mesh, or a group-bound one),
    with ``cut`` the MC_* sizes: {name: {"result": what is held bit for
    bit, "rounds", "s" (wall), "launches", "exchanges"}}.  The one-card
    engine is timed after a first run that captures its round; ranks
    issue their rounds from the host, capture nothing and run once.
    ``mark(stage)``, when given, is told each cell's start and end."""
    from repro_torch import obs, runtime as rt, serving
    from repro_torch.apps import bfs, sssp
    from repro_torch.distributed import COLLECTIVES
    from repro_torch.kernels import _build
    sum32 = lambda a: a.sum(0, dtype=torch.int32)  # noqa: E731
    zeros = lambda n: torch.zeros(n, dtype=torch.int32,  # noqa: E731
                                  device=dev)

    def stats_of(st):
        return [st[k] for k in STATS] + [st["host_syncs"]]

    def state_of(st):
        return digest(*(torch.as_tensor(p).cpu().numpy() for p in st))

    def goldens():
        out = {}
        tel = obs.Telemetry(capacity=256)
        r = rt.MeshRoundRunner(golden_tree_step(torch), mesh=mesh,
                               capacity_log2=8, batch=16, telemetry=tel,
                               combine=sum32, device=dev)
        acc, st = r.run([1], acc=zeros(80))
        out["mesh_fanout_2"] = {
            "stats": stats_of(r.stats), "acc": digest(acc.cpu().numpy()),
            "planes": state_of(st[:4]), "head_tail": [st.head, st.tail],
            "tel": tel_digest(tel)}
        d, stats = bfs.bfs_mesh_rounds(bfs.road_like(144), 0, mesh=mesh,
                                       batch=32, device=dev)
        out["mesh_bfs_2"] = {"stats": stats_of(stats), "dist": digest(d)}
        step = golden_pri_step(torch)
        for relaxed in (True, False):
            tel = obs.Telemetry(capacity=512)
            r = rt.PriorityMeshRoundRunner(step, mesh=mesh, capacity_log2=10,
                                           batch=16, relaxed=relaxed,
                                           telemetry=tel, combine=sum32,
                                           device=dev)
            acc, st = r.run([3, 1], [7, 11], acc=zeros(89))
            out["pmesh_relaxed_2" if relaxed else "pmesh_strict_2"] = {
                "stats": stats_of(r.stats), "acc": digest(acc.cpu().numpy()),
                "planes": state_of(st[:2]), "tel": tel_digest(tel)}
        tel = obs.Telemetry(capacity=256)
        e = serving.ServingMeshEngine(mesh=mesh, capacity_log2=6, batch=8,
                                      table_log2=6, pop_log=128,
                                      telemetry=tel, device=dev)
        e.begin()
        adm = list(e.tick([60, 10, 30, 20, 50, 40, 35, 25],
                          [0, 1, 2, 3, 4, 5, 6, 7], slots=4, pages=5,
                          need=[2] * 8))
        ticks = 1
        while e.occupancy() > 0 and ticks < 12:
            adm += e.tick([], [], slots=4, pages=4)
            ticks += 1
        hs = e.heap_state()
        out["serving_2"] = {
            "stats": stats_of(e.stats), "ticks": ticks, "admitted": adm,
            "planes": state_of(hs[:2]),
            "hist": digest(np.asarray(e.pop_history(), np.int32)),
            "tel": tel_digest(tel)}
        return out, sum(v["stats"][0] for v in out.values())

    def fifo_tree(sharded, compact=None):
        seeds = (np.random.default_rng(15).integers(
            0, 2 ** 27, MC_TREE_SEEDS if cut and sharded else
            MESH_TREE_SEEDS) << 4).astype(np.int32)
        r = rt.MeshRoundRunner(fifo_tree_step(torch), mesh=mesh,
                               capacity_log2=MESH_TREE_CAP_LOG2, batch=BATCH,
                               sharded=sharded, compact=compact,
                               combine=sum32, device=dev)

        def run():
            return r.run(seeds, acc=zeros(4096), max_rounds=1_000_000)
        return run, r

    def engine_result(r, out):
        acc, st = out
        return {"stats": stats_of(r.stats), "acc": digest(acc.cpu().numpy()),
                "state": state_of(st)}

    def bfs_road():
        # mesh BFS packs (d, v) in a payload: n (n + 2) < 2^31 caps the
        # graph at road 215^2 (phase mesh's)
        g = bfs.road_like(MESH_ROAD_SIDE * MESH_ROAD_SIDE)
        runner, init_fn = bfs.bfs_mesh_rounds_runner(g, mesh=mesh,
                                                     batch=BATCH, device=dev)

        def run():
            return runner.run([0], acc=init_fn(0), max_rounds=1_000_000)
        return run, runner

    def sssp_road():
        side = MC_SSSP_SIDE if cut else SSSP_SIDE
        g = bfs.road_like(side * side)
        w = sssp.with_weights(g, max_w=SSSP_MAX_W, seed=1)
        runner, init_fn = sssp.sssp_mesh_rounds_runner(
            g, w, mesh=mesh, batch=BATCH, delta=SSSP_DELTA, relaxed=True,
            split_payload=True, device=dev)

        def run():
            return runner.run([0], [0], acc=init_fn(0), max_rounds=1_000_000,
                              initial_aux=[0])
        return run, runner

    engines = {"fifo_tree": lambda: fifo_tree(False),
               "fifo_tree_sharded": lambda: fifo_tree(True),
               "fifo_tree_sharded_compact": lambda: fifo_tree(True, True),
               "bfs_road": bfs_road, "sssp_road": sssp_road}
    out = {}
    for name in names:
        if mark is not None:
            mark(f"{name} started")
        if name in engines:
            run, r = engines[name]()
            if mesh.group is None:
                run()                 # captures the round (one card)
        torch.cuda.synchronize()
        _build.reset_launches()
        ex = COLLECTIVES["exchange"]
        t0 = time.perf_counter()
        if name in engines:
            res = engine_result(r, run())
            rounds = r.stats["rounds"]
        elif name == "goldens":
            res, rounds = goldens()
        elif name == "task_round":
            res, rounds = mc_task_round(torch, np, mesh, dev,
                                        MC_RT_SEEDS if cut else RT_SEEDS)
        else:
            res, rounds = mc_admission_stream(
                torch, np, serving, mesh, dev,
                MC_ADM_TICKS if cut else ADM_TRAFFIC["ticks"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[name] = {"result": res, "rounds": rounds, "s": wall,
                     "us_per_round": wall / max(rounds, 1) * 1e6,
                     "exchanges": COLLECTIVES["exchange"] - ex,
                     "launches": {k: v for k, v in _build.LAUNCHES.items()
                                  if v}}
        if name in engines and getattr(r, "_engine", r).__dict__.get(
                "_loops"):
            out[name]["round_graph"] = graph_nodes(getattr(r, "_engine", r))
        if mark is not None:
            mark(f"{name} done")
    return out


def mc_rank(rank, world, backend, store, outdir, names, cut):
    """One rank of the multicard phase: a ``backend`` process group of
    ``world`` ranks over the ``file://`` store, card 0 (gloo) or card
    ``rank`` (NCCL), the cells on the group-bound mesh; writes its
    results to ``outdir/rank<rank>.json`` and its last stage to
    ``outdir/rank<rank>.stage``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.distributed import make_mesh

    def mark(stage):
        (Path(outdir) / f"rank{rank}.stage").write_text(stage)
    mark("started")
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method="file://" + store,
                            world_size=world, rank=rank)
    mark("process group initialized")
    try:
        mesh = make_mesh((world,), ("data",), group=dist.group.WORLD)
        out = mc_cells(torch, np, mesh, names, torch.device("cuda"), cut,
                       mark)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(Path(outdir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


def mc_spawn(world, backend, names, cut):
    """``mc_rank`` on ``world`` spawned ranks (``torch.multiprocessing``,
    joined before it returns, or killed after MC_SPAWN_TIMEOUT seconds,
    when it raises with each rank's last stage): {rank: results}."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            mc_rank, args=(world, backend, str(Path(tmp) / "store"), tmp,
                           names, cut), nprocs=world, join=False,
            start_method="spawn")
        deadline = time.perf_counter() + MC_SPAWN_TIMEOUT
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                for p in ctx.processes:
                    p.kill()
                for p in ctx.processes:
                    p.join()
                stages = {r: (Path(tmp) / f"rank{r}.stage").read_text()
                          if (Path(tmp) / f"rank{r}.stage").exists()
                          else "not started" for r in range(world)}
                raise TimeoutError(
                    f"multicard {backend} x {world}: the ranks did not "
                    f"finish in {MC_SPAWN_TIMEOUT} s; last stages {stages}")
        out = {}
        for r in range(world):
            with open(Path(tmp) / f"rank{r}.json") as f:
                out[r] = json.load(f)
    return out


def spawn_ranks(target, world, backend, outdir, timeout, tag, *args):
    """``target(rank, world, backend, store, outdir, *args)`` on ``world``
    spawned ranks (``torch.multiprocessing``), joined, or killed after
    ``timeout`` seconds; a rank that fails or runs out of time raises,
    named by ``tag``, with every rank's last stage
    (``outdir/rank<r>.stage``).  Returns {rank: its
    ``outdir/rank<r>.json``}."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(
        target, args=(world, backend, str(Path(outdir) / "store"), outdir)
        + args, nprocs=world, join=False, start_method="spawn")

    def stages():
        return {r: (Path(outdir) / f"rank{r}.stage").read_text()
                if (Path(outdir) / f"rank{r}.stage").exists()
                else "not started" for r in range(world)}

    deadline = time.perf_counter() + timeout
    try:
        while not ctx.join(timeout=2):
            if time.perf_counter() > deadline:
                raise TimeoutError(f"ran past {timeout} s")
    except Exception as e:
        seen = stages()
        for p in ctx.processes:
            p.kill()
        for p in ctx.processes:
            p.join()
        raise RuntimeError(f"{tag}: {e}; last stages {seen}") from e
    out = {}
    for r in range(world):
        with open(Path(outdir) / f"rank{r}.json") as f:
            out[r] = json.load(f)
    return out


# -- phase dp_train: the sharded train step across ranks ---------------------


def dp_setup(torch, case, world, mesh):
    """A dp_train case's config (full width, its depth), sanitized state
    and batch specs, data config and optimizer config."""
    from repro_torch import configs
    from repro_torch.data import DataConfig
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    _, arch, layers, tokens, _, _ = case
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers)
    specs = steps.sanitize_pspecs(steps.state_pspecs(cfg),
                                  steps.state_struct(cfg), mesh)
    bspecs = steps.sanitize_pspecs(
        steps.batch_pspecs(cfg, "train_4k", mesh, batch=world),
        steps.batch_struct(cfg, "train_4k", batch=world, seq=tokens), mesh)
    return (cfg, specs, bspecs, DataConfig(seq_len=tokens, global_batch=world),
            adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP))


def dp_launch_plan(cfg, seq, groups):
    """Kernel launches of one step: B7 twice an attention call (the
    forward and its remat) on sequences of 2,048 tokens or more and its
    backward once, B6 twice an MoE layer a dispatch group."""
    want = {}
    if seq >= 2048:
        n = attention_calls(cfg)
        want.update(flash_attention=2 * n, flash_attention_bwd=n)
    if cfg.family == "moe":
        want["expert_tickets"] = 2 * cfg.n_layers * groups
    return want


def dp_rank(rank, world, backend, store, outdir, cases, save):
    """One rank of phase dp_train: a ``backend`` group of ``world`` ranks,
    card 0 (gloo) or card ``rank`` (NCCL), every case's steps on this
    rank's blocks of the state and rows of the batch, then one more step
    with each collective timed (``dp_time_collectives``) where a case
    takes two steps or more; writes each case's rows to
    ``outdir/rank<rank>.json``, with ``save`` its master blocks (after
    the untimed steps) to ``outdir/<case>_rank<rank>.pt``, rank 0 the
    first B6 call's expert ids and options of an MoE case to
    ``outdir/<case>_tickets.pt``, and its last stage to
    ``outdir/rank<rank>.stage``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data import synth_batch
    from repro_torch.distributed import COLLECTIVES, make_mesh
    from repro_torch.distributed.sharding import shard
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    from repro_torch.launch.train import batch_to_device
    from repro_torch.tree import flatten_with_paths

    def mark(stage):
        (Path(outdir) / f"rank{rank}.stage").write_text(stage)
    mark("started")
    spent = collections.Counter()
    timing = dp_time_collectives(torch, spent)
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, init_method="file://" + store,
                            world_size=world, rank=rank)
    mark("process group initialized")
    out = {}
    try:
        mesh = make_mesh((world, 1), ("data", "model"),
                         group=dist.group.WORLD)
        for case in cases:
            label, _, _, tokens, n_steps, seed = case
            cfg, specs, bspecs, dcfg, ocfg = dp_setup(torch, case, world,
                                                      mesh)
            mark(f"{label}: init")
            t0 = time.perf_counter()
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            state = steps.init_state(cfg, specs.master, mesh, gen, device=dev)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            step = steps.make_train_step(cfg, ocfg, specs.master, mesh=mesh,
                                         batch_specs=bspecs)
            plan = steps.train_collectives(cfg, specs.master, mesh,
                                           world * tokens)

            def run(i, timed):
                batch = batch_to_device(synth_batch(cfg, dcfg, i % 2), dev)
                batch = {k: shard(v, bspecs[k], mesh).contiguous()
                         for k, v in batch.items()}
                torch.cuda.synchronize()
                _build.reset_launches()
                torch.cuda.reset_peak_memory_stats()
                before = dict(COLLECTIVES)
                spent.clear()
                timing["on"] = timed
                t1 = time.perf_counter()
                new, m = step(state, batch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
                timing["on"] = False
                return new, {
                    "loss": float(m["loss"]), "grad_norm": float(
                        m["grad_norm"]), "lr": float(m["lr"]), "wall_s": wall,
                    "tokens_per_s": world * tokens / wall,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": {k: v for k, v in _build.LAUNCHES.items()
                                 if v},
                    "collectives": {k: COLLECTIVES[k] - before[k]
                                    for k in plan}}
            rows = []
            for i in range(n_steps):
                mark(f"{label}: step {i}")
                seen = []
                spy = rank == 0 and i == 0 and cfg.family == "moe"
                undo = dp_spy_tickets(seen) if spy else (lambda: None)
                try:
                    state, row = run(i, False)
                finally:
                    undo()
                rows.append(row)
                if seen:
                    torch.save(seen[0], Path(outdir) / f"{label}_tickets.pt")
            mark(f"{label}: save")
            t1 = time.perf_counter()
            if save:
                torch.save({k: v.cpu() for k, v in
                            flatten_with_paths(state.master)},
                           Path(outdir) / f"{label}_rank{rank}.pt")
            save_s = time.perf_counter() - t1
            split = None
            if n_steps >= 2:
                mark(f"{label}: timed step")
                state, split = run(n_steps, True)
                split["collective_s"] = dict(spent)
            out[label] = {"rows": rows, "timed_step": split, "plan": plan,
                          "init_s": init_s, "save_s": save_s,
                          "state_gb": sum(
                              v.numel() * v.element_size()
                              for part in state[:3]
                              for _, v in flatten_with_paths(part)) / 1e9}
            del state, step
            torch.cuda.empty_cache()
        mark("barrier")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(Path(outdir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)
    mark("done")


def dp_spy_tickets(seen):
    """B6's first call of a rank's step into ``seen`` (its ids on the host
    and its options), whether through ``kernels.moe_route`` (a group of
    the rank's own tokens) or ``models.moe``'s own name (the one-group
    fallback); returns the undo."""
    mods = [importlib.import_module(f"repro_torch.{m}")
            for m in ("kernels.moe_route", "models.moe")]
    real = [m.expert_tickets for m in mods]

    def wrap(fn):
        def spy(ids, **kw):
            if not seen:
                seen.append((ids.cpu(), kw))
            return fn(ids, **kw)
        return spy
    for m, fn in zip(mods, real):
        m.expert_tickets = wrap(fn)

    def undo():
        for m, r in zip(mods, real):
            m.expert_tickets = r
    return undo


def dp_time_collectives(torch, spent):
    """Wrap the sharded steps' collectives (the gathers, the
    reduce-scatters, the all-reduces, the MoE's exchange; over "model"
    too, each under the ``kind`` its caller counts it as) so that, while
    the returned switch's ``"on"`` is true, each call's wall seconds, the
    card synchronised before and after, add to ``spent[kind]``; while it
    is false they run as they are."""
    from repro_torch.distributed import collectives, sharding
    from repro_torch.launch import train
    from repro_torch.models import moe
    from repro_torch.optim import adamw
    switch = {"on": False}

    def timed(kind, fn):
        def call(*a, **kw):
            if not switch["on"]:
                return fn(*a, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[kw.get("kind", kind)] += time.perf_counter() - t
            return out
        return call
    sharding._all_gather_bytes = timed("all_gather",
                                       sharding._all_gather_bytes)
    sharding._all_to_all_bytes = timed("reduce_scatter",
                                       sharding._all_to_all_bytes)
    collectives._sum = timed("reduce", collectives._sum)
    sharding.all_reduce_ = timed("reduce", sharding.all_reduce_)
    train.all_reduce_ = timed("reduce", train.all_reduce_)
    adamw.all_reduce_ = timed("reduce", adamw.all_reduce_)
    moe.mesh_round_gather = timed("exchange", moe.mesh_round_gather)
    return switch


# -- phase tp_serve: the serve steps over "model" across ranks --------------


def tp_setup(case, mesh):
    """A tp_serve case's config (full width, its depth, the prefill's
    sequence parallelism on) and its sanitized parameter specs."""
    from repro_torch import configs
    from repro_torch.launch import steps
    _, arch, layers, _ = case
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers,
                              seq_parallel=True)
    return cfg, steps.sanitize_pspecs(steps.param_specs(cfg),
                                      steps.params_struct(cfg), mesh)


def tp_gb(tree) -> float:
    """GB of a tree's tensors."""
    from repro_torch.tree import tree_leaves
    return sum(v.numel() * v.element_size() for v in tree_leaves(tree)) / 1e9


def tp_cache(torch, cfg, batch, max_seq, mesh, dtype, dev):
    """This rank's decode ring caches under ``cache_pspecs``' decode cell
    (sanitized), zeros."""
    from repro_torch import models
    from repro_torch.launch import steps
    struct = models.init_decode_cache(cfg, batch, max_seq, dtype,
                                      device="meta")
    specs = steps.sanitize_pspecs(steps.cache_pspecs(cfg, "decode_32k",
                                                     mesh), struct, mesh)
    return models.init_decode_cache(cfg, batch, max_seq, dtype, device=dev,
                                    specs=specs, mesh=mesh)


@contextlib.contextmanager
def tp_spies(seen):
    """Record the first B7 call's inputs (``seen["attn"]``), the first
    B6 call's ids and options (``seen["tickets"]``) and the first
    ``models.moe.route`` call's gates and slots (``seen["route"]``)."""
    from repro_torch.models import layers, moe
    real_attn, real_route = layers.flash_attention, moe.route

    def attn(q, k, v, **kw):
        seen.setdefault("attn", (q.detach().clone(), k.detach().clone(),
                                 v.detach().clone(), kw))
        return real_attn(q, k, v, **kw)

    def route(gates, *a, **kw):
        out = real_route(gates, *a, **kw)
        seen.setdefault("route", (gates.cpu(), out[0].cpu()))
        return out
    tickets = []
    undo = dp_spy_tickets(tickets)
    layers.flash_attention, moe.route = attn, route
    try:
        yield
    finally:
        layers.flash_attention, moe.route = real_attn, real_route
        undo()
        if tickets:
            seen["tickets"] = tickets[0]


def tp_steps(torch, cfg, specs, mesh):
    from repro_torch.launch import steps
    return (steps.make_prefill_step(cfg, specs, mesh=mesh),
            steps.make_serve_step(cfg, specs, mesh=mesh))


def tp_delta(before):
    from repro_torch.distributed import COLLECTIVES
    return {k: COLLECTIVES[k] - before[k] for k in COLLECTIVES
            if COLLECTIVES[k] - before[k]}


#: a tp_serve rank's collective timing: ``dp_time_collectives``' switch
#: and the seconds it adds up, set once a rank by ``tp_rank``
TP_TIMING: dict = {}


def tp_timed(torch, fn):
    """``fn()`` with every collective timed (``TP_TIMING``): (its wall
    seconds, seconds by kind)."""
    spent, switch = TP_TIMING["spent"], TP_TIMING["switch"]
    spent.clear()
    torch.cuda.synchronize()
    switch["on"] = True
    t = time.perf_counter()
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        switch["on"] = False
    return time.perf_counter() - t, dict(spent)


def tp_phase_case(torch, case, mesh, dev, outdir, rank):
    """One rank of a phase case (see TP_CASES): the bfloat16 prefill
    into the ring caches and TP_DECODE teacher-forced decode steps (the
    main path: launches and collectives counted), a prefill and a decode
    step again with the collectives timed, then TP_DECODE float32 steps
    from an empty cache.  Writes the numbers the parent holds to
    ``outdir/<label>_rank<rank>.pt``; returns the rank's row."""
    from repro_torch import models
    from repro_torch.distributed import COLLECTIVES
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    label, _, _, seed = case
    cfg, specs = tp_setup(case, mesh)
    inp = torch.load(Path(outdir) / f"{label}_inputs.pt")
    tokens, teach = inp["tokens"].to(dev), inp["teacher"].to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = models.init_params_block(cfg, specs, mesh, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pre, serve = tp_steps(torch, cfg, specs, mesh)
    b, s = tokens.shape
    plan_p = steps.serve_collectives(cfg, specs, mesh, b * s, seq=s)
    plan_d = steps.serve_collectives(cfg, specs, mesh, b, decode=True)
    cache = tp_cache(torch, cfg, b, s + TP_DECODE, mesh, torch.bfloat16, dev)
    seen = {}
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    before = dict(COLLECTIVES)
    with tp_spies(seen):
        t0 = time.perf_counter()
        logits, cache = pre(params, {"tokens": tokens}, into=cache)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        coll = [tp_delta(before)]
        argmax, walls = [logits.argmax(-1)], []
        for j in range(TP_DECODE):
            before = dict(COLLECTIVES)
            t0 = time.perf_counter()
            lj, cache = serve(params, cache, teach[:, j:j + 1], s + j)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            coll.append(tp_delta(before))
            argmax.append(lj.argmax(-1))
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = [{k: v for k, v in p.items() if v} for p in
            [plan_p] + [plan_d] * TP_DECODE]
    for i, (got, plan) in enumerate(zip(coll, want)):
        if got != plan:
            raise AssertionError(f"tp_serve {label} rank {rank}: step {i} "
                                 f"collectives {got}, planned {plan}")
    pre_s, pre_split = tp_timed(torch, lambda: pre(
        params, {"tokens": tokens}, into=cache))
    dec_s, dec_split = tp_timed(torch, lambda: serve(
        params, cache, teach[:, :1], s + TP_DECODE - 1))
    save = {"prefill": logits.float().cpu(),
            "argmax": torch.cat(argmax, 1).cpu(),
            "route": seen.get("route"), "tickets": seen.get("tickets"),
            "attn": seen.get("attn") if rank == 0 else None}
    del params, cache, logits, seen
    torch.cuda.empty_cache()
    gen.manual_seed(seed)
    params = models.init_params_block(cfg, specs, mesh, gen, device=dev,
                                      dtype=torch.float32)
    cache = tp_cache(torch, cfg, b, TP_DECODE, mesh, torch.float32, dev)
    f32 = []
    for j in range(TP_DECODE):
        lj, cache = serve(params, cache, tokens[:, j:j + 1], j)
        f32.append(lj.cpu())
    save["f32"] = torch.cat(f32, 1)
    torch.save(save, Path(outdir) / f"{label}_rank{rank}.pt")
    del params, cache
    torch.cuda.empty_cache()
    return {"init_s": init_s, "prefill_s": prefill_s,
            "prefill_tokens_per_s": b * s / prefill_s,
            "decode_ms_median": statistics.median(walls) * 1e3,
            "decode_tokens_per_s": b / statistics.median(walls),
            "peak_mem_gb": peak, "launches": launches, "plan_prefill":
            plan_p, "plan_decode": plan_d,
            "collectives_timed": {"prefill_s": pre_s,
                                  "prefill_collective_s": pre_split,
                                  "decode_step_s": dec_s,
                                  "decode_collective_s": dec_split}}


def tp_profile(torch, fn, on: bool = True):
    """One call of ``fn``, under the profiler where ``on`` (every rank
    calls it: ``fn`` runs collectives): its wall ms, the card's busy ms
    and the kernels with the most device time; None where not ``on``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    if not on:
        fn()
        torch.cuda.synchronize()
        return None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    times = device_times(prof)
    busy = sum(times.values()) / 1e3
    return {"wall_ms": wall * 1e3, "busy_ms": busy,
            "idle_share": 1 - busy / (wall * 1e3), "top_device_ms":
            top_ms(times, 8)}


def tp_full_yi(torch, mesh, dev, rank):
    """yi-34b at all 60 layers: TP_BATCH x TP_SEQ prefilled, then
    TP_FULL_STEPS decode steps at batch TP_YI_DECODE_BATCH over ring
    caches of TP_YI_CACHE positions filled with random values."""
    from repro_torch import models
    from repro_torch.distributed import COLLECTIVES
    from repro_torch.launch import steps
    case = ("yi_60", "yi-34b", 60, 41)
    cfg, specs = tp_setup(case, mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(case[3])
    t0 = time.perf_counter()
    params = models.init_params_block(cfg, specs, mesh, gen, device=dev)
    torch.cuda.synchronize()
    row = {"init_s": time.perf_counter() - t0, "weights_gb": tp_gb(params)}
    pre, serve = tp_steps(torch, cfg, specs, mesh)
    tg = torch.Generator().manual_seed(case[3])
    tokens = torch.randint(0, cfg.vocab, (TP_BATCH, TP_SEQ), generator=tg,
                           dtype=torch.int32).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre(params, {"tokens": tokens})        # the sub-groups' first use
    torch.cuda.synchronize()
    row["first_prefill_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    before = dict(COLLECTIVES)
    t0 = time.perf_counter()
    logits, _ = pre(params, {"tokens": tokens})
    torch.cuda.synchronize()
    row.update(prefill_s=time.perf_counter() - t0,
               prefill_collectives=tp_delta(before),
               prefill_plan=steps.serve_collectives(
                   cfg, specs, mesh, TP_BATCH * TP_SEQ, seq=TP_SEQ),
               prefill_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    row["prefill_tokens_per_s"] = TP_BATCH * TP_SEQ / row["prefill_s"]
    row["prefill_timed"] = tp_timed(torch, lambda: pre(
        params, {"tokens": tokens}))
    ok = bool(torch.isfinite(logits).all())
    del logits
    torch.cuda.empty_cache()
    b = TP_YI_DECODE_BATCH
    cache = tp_cache(torch, cfg, b, TP_YI_CACHE, mesh, torch.bfloat16, dev)
    for c in cache:
        for t in c.values():
            t.normal_(generator=gen)
    row["cache_gb"] = tp_gb(cache)
    tok = tokens[:1, :1].expand(b, 1).contiguous()
    torch.cuda.reset_peak_memory_stats()
    walls, coll, out = [], [], []
    for j in range(TP_FULL_STEPS):
        before = dict(COLLECTIVES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lj, cache = serve(params, cache, tok, TP_YI_CACHE - TP_FULL_STEPS + j)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        coll.append(tp_delta(before))
        tok = lj.argmax(-1).int()
        out.append(tok.cpu())
        ok = ok and bool(torch.isfinite(lj).all())
    row.update(decode_ms_median=statistics.median(walls) * 1e3,
               decode_tokens_per_s=b / statistics.median(walls),
               decode_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               decode_collectives=coll[-1],
               decode_plan=steps.serve_collectives(cfg, specs, mesh, b,
                                                   decode=True),
               decode_timed=tp_timed(torch, lambda: serve(
                   params, cache, tok, TP_YI_CACHE - 1)),
               decode_profile=tp_profile(torch, lambda: serve(
                   params, cache, tok, TP_YI_CACHE - 1), rank == 0),
               finite=ok, tokens=torch.cat(out, 1).tolist())
    return row


def tp_full_gemma(torch, mesh, dev, rank):
    """gemma2-27b at all 46 layers: TP_LONG tokens (long_500k, batch 1)
    prefilled with the residual stream split along the sequence into the
    ring caches (global layers TP_LONG + TP_FULL_STEPS positions, local
    ones their window), then TP_FULL_STEPS greedy decode steps."""
    from repro_torch import models
    from repro_torch.distributed import COLLECTIVES
    from repro_torch.launch import steps
    case = ("gemma_46", "gemma2-27b", 46, 42)
    cfg, specs = tp_setup(case, mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(case[3])
    t0 = time.perf_counter()
    params = models.init_params_block(cfg, specs, mesh, gen, device=dev)
    torch.cuda.synchronize()
    row = {"init_s": time.perf_counter() - t0, "weights_gb": tp_gb(params)}
    pre, serve = tp_steps(torch, cfg, specs, mesh)
    tg = torch.Generator().manual_seed(case[3])
    tokens = torch.randint(0, cfg.vocab, (1, TP_LONG), generator=tg,
                           dtype=torch.int32).to(dev)
    cache = tp_cache(torch, cfg, 1, TP_LONG + TP_FULL_STEPS, mesh,
                     torch.bfloat16, dev)
    row["cache_gb"] = tp_gb(cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre(params, {"tokens": tokens[:, :8192]})   # the sub-groups' first use
    torch.cuda.synchronize()
    row["warmup_prefill_8192_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = dict(COLLECTIVES)
    t0 = time.perf_counter()
    logits, cache = pre(params, {"tokens": tokens}, into=cache)
    torch.cuda.synchronize()
    row.update(prefill_s=time.perf_counter() - t0,
               prefill_collectives=tp_delta(before),
               prefill_plan=steps.serve_collectives(cfg, specs, mesh,
                                                    TP_LONG, seq=TP_LONG),
               prefill_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    row["prefill_tokens_per_s"] = TP_LONG / row["prefill_s"]
    ok = bool(torch.isfinite(logits).all())
    tok = logits.argmax(-1).int()
    walls, coll, out = [], [], [tok.cpu()]
    torch.cuda.reset_peak_memory_stats()
    for j in range(TP_FULL_STEPS):
        before = dict(COLLECTIVES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lj, cache = serve(params, cache, tok, TP_LONG + j)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        coll.append(tp_delta(before))
        tok = lj.argmax(-1).int()
        out.append(tok.cpu())
        ok = ok and bool(torch.isfinite(lj).all())
    row.update(decode_ms_median=statistics.median(walls) * 1e3,
               decode_tokens_per_s=1 / statistics.median(walls),
               decode_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               decode_collectives=coll[-1],
               decode_plan=steps.serve_collectives(cfg, specs, mesh, 1,
                                                   decode=True),
               decode_timed=tp_timed(torch, lambda: serve(
                   params, cache, tok, TP_LONG + TP_FULL_STEPS - 1)),
               decode_profile=tp_profile(torch, lambda: serve(
                   params, cache, tok, TP_LONG + TP_FULL_STEPS - 1),
                   rank == 0),
               finite=ok, tokens=torch.cat(out, 1).tolist())
    return row


def tp_moe_serve(torch, cfg, params, dev, serve_fns=None, into=None,
                 teacher=None, routes=None):
    """TP_MOE_REQUESTS requests of TP_MOE_PROMPT tokens prefilled as one
    batch and served TP_MOE_NEW greedy steps, each step's input the last
    step's argmax, or with ``teacher`` ((R, 1 + TP_MOE_NEW) tokens) the
    teacher's token: (the argmax tokens (R, 1 + TP_MOE_NEW), the float32
    logits (R, 1 + TP_MOE_NEW, V) on the host, wall seconds of the
    prefill and of each decode step).  ``routes``: each
    ``models.moe.route`` call's expert ids (T, k), keep mask (T, k) and
    gap between the k-th and (k+1)-th gate (T,) are appended, on the
    host."""
    from repro_torch import models
    from repro_torch.models import moe
    real = moe.route

    def spy(gates, cfg_, *a, **kw):
        out = real(gates, cfg_, *a, **kw)
        if routes is not None:
            top = gates.topk(cfg_.top_k + 1, dim=-1).values
            routes.append((out[1].cpu(), (out[0] >= 0).cpu(),
                           (top[:, -2] - top[:, -1]).cpu()))
        return out
    moe.route = spy
    try:
        return _tp_moe_serve(torch, cfg, params, dev, serve_fns, into,
                             teacher)
    finally:
        moe.route = real


def _tp_moe_serve(torch, cfg, params, dev, serve_fns, into, teacher):
    from repro_torch import models
    tg = torch.Generator().manual_seed(43)
    prompts = torch.randint(0, cfg.vocab, (TP_MOE_REQUESTS, TP_MOE_PROMPT),
                            generator=tg, dtype=torch.int32).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if serve_fns is None:
        logits, kv = models.prefill(params, prompts, cfg)
        cache = models.init_decode_cache(cfg, TP_MOE_REQUESTS,
                                         TP_MOE_PROMPT + TP_MOE_NEW,
                                         torch.float32, device=dev)
        for i in range(cfg.n_layers):
            models.transformer.fill_rings(cache, i, kv["k"][i], kv["v"][i])

        def serve(c, t, cur):
            return models.decode_step(params, c, t, cur, cfg)
    else:
        pre, step = serve_fns
        logits, cache = pre(params, {"tokens": prompts}, into=into)

        def serve(c, t, cur):
            return step(params, c, t, cur)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out, lg, walls = [logits.argmax(-1).int()], [logits.cpu()], []
    for j in range(TP_MOE_NEW):
        tok = out[-1] if teacher is None else teacher[:, j:j + 1].to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lj, cache = serve(cache, tok, TP_MOE_PROMPT + j)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        out.append(lj.argmax(-1).int())
        lg.append(lj.cpu())
    return torch.cat(out, 1).cpu(), torch.cat(lg, 1), prefill_s, walls


def tp_full_moe(torch, mesh, dev, rank, outdir):
    """deepseek-moe-16b at all 28 layers in float32: tp_moe_serve on the
    rank's blocks, teacher-forced with the one-card serve's tokens
    (``outdir/moe_teacher.pt``); rank 0 writes its logits to
    ``outdir/moe_logits.pt``."""
    from repro_torch import models
    from repro_torch.distributed import COLLECTIVES
    from repro_torch.launch import steps
    case = ("moe_28", "deepseek-moe-16b", 28, 44)
    cfg, specs = tp_setup(case, mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(case[3])
    params = models.init_params_block(cfg, specs, mesh, gen, device=dev,
                                      dtype=torch.float32)
    fns = tp_steps(torch, cfg, specs, mesh)
    cache = tp_cache(torch, cfg, TP_MOE_REQUESTS, TP_MOE_PROMPT + TP_MOE_NEW,
                     mesh, torch.float32, dev)
    teacher = torch.load(Path(outdir) / "moe_teacher.pt")
    torch.cuda.reset_peak_memory_stats()
    before = dict(COLLECTIVES)
    routes = []
    toks, logits, prefill_s, walls = tp_moe_serve(
        torch, cfg, params, dev, fns, into=cache, teacher=teacher,
        routes=routes)
    if rank == 0:
        torch.save({"logits": logits, "routes": routes},
                   Path(outdir) / "moe_logits.pt")
    return {"tokens": toks.tolist(), "prefill_s": prefill_s,
            "prefill_tokens_per_s": TP_MOE_REQUESTS * TP_MOE_PROMPT
            / prefill_s,
            "decode_ms_median": statistics.median(walls) * 1e3,
            "decode_tokens_per_s": TP_MOE_REQUESTS / statistics.median(walls),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "collectives": tp_delta(before),
            "plan": {"prefill": steps.serve_collectives(
                cfg, specs, mesh, TP_MOE_REQUESTS * TP_MOE_PROMPT,
                seq=TP_MOE_PROMPT), "decode": steps.serve_collectives(
                    cfg, specs, mesh, TP_MOE_REQUESTS, decode=True)}}


def tp_moe_check(torch, toks, logits, routes, got_tokens, got):
    """deepseek-moe-16b's serve on four ranks (teacher-forced) against one
    card's: every routing call's expert choices (each token's set of k
    experts; their order moves no slot) and keep masks equal, but
    where the one card's gap between its k-th and (k+1)-th gate is below
    TP_GATE_TIE (a tie the sums over "model" may break the other way), or
    in a request an earlier tie touched, or (keep masks) in a call with
    such a flip; a request so touched is left out, and every other
    request's
    float32 logits within TP_F32_LOGITS of one card's and its argmax
    equal wherever the one card's top two logits are TP_F32_MARGIN apart.
    At most TP_MOE_TIED requests may be left out.  Returns the check's
    numbers (``check_*``); raises on a failure."""
    r, n = TP_MOE_REQUESTS, TP_MOE_PROMPT
    mine = got["routes"]
    if len(mine) != len(routes):
        raise AssertionError(f"tp_serve nccl moe_28: {len(mine)} routing "
                             f"calls on the ranks, {len(routes)} on one "
                             f"card")
    def by_expert(e, k):   # a token's choices as a set: its k in any order
        order = e.argsort(-1)
        return e.gather(-1, order), k.gather(-1, order)
    tied, flips, largest_gap = set(), 0, None
    for i, ((e1, k1, gap), (e2, k2, _)) in enumerate(zip(routes, mine)):
        (e1, k1), (e2, k2) = by_expert(e1, k1), by_expert(e2, k2)
        flipped = (e1 != e2).any(-1)                          # (T,)
        moved = flipped | (k1 != k2).any(-1)
        if not bool(moved.any()):
            continue
        per_row = n if e1.shape[0] == r * n else 1            # prefill
        req = torch.arange(e1.shape[0]) // per_row
        known = torch.tensor([int(q) in tied for q in req])
        fresh = flipped & ~known      # a flip no earlier tie explains
        if bool(fresh.any()):
            g = float(gap[fresh].max())
            largest_gap = g if largest_gap is None else max(largest_gap, g)
            if g >= TP_GATE_TIE:
                raise AssertionError(
                    f"tp_serve nccl moe_28: routing call {i} chose other "
                    f"experts where the one card's gates are {g} apart")
        if not bool(flipped.any()):
            raise AssertionError(f"tp_serve nccl moe_28: routing call {i} "
                                 f"kept other pairs with the same experts")
        flips += int(fresh.sum())
        # a flip moves later tickets of its dispatch group, and a tied
        # request's later steps may route anywhere: every request whose
        # choice or keep mask moved is left out from here on
        tied |= {int(q) for q in req[moved]}
    if len(tied) > TP_MOE_TIED:
        raise AssertionError(f"tp_serve nccl moe_28: {len(tied)} requests "
                             f"touched by routing ties")
    keep = torch.tensor([i not in tied for i in range(r)])
    diff = float((got["logits"] - logits)[keep].abs().max())
    top2 = logits.topk(2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1]) >= TP_F32_MARGIN) & keep[:, None]
    same = torch.tensor(got_tokens) == toks
    if not diff <= TP_F32_LOGITS:
        raise AssertionError(f"tp_serve nccl moe_28: logits {diff} off the "
                             f"one-card serve's in the untied requests")
    if not bool(same[clear].all()):
        raise AssertionError("tp_serve nccl moe_28: a token differs from the "
                             "one-card serve's where its top two are "
                             f"{TP_F32_MARGIN} apart")
    return {"check_routing_calls": len(routes), "check_flipped_pairs": flips,
            "check_largest_gap_of_a_flip": largest_gap,
            "check_tied_requests": sorted(tied),
            "check_logits_max_abs_untied": diff,
            "check_logits_max_abs_all": float(
                (got["logits"] - logits).abs().max()),
            "check_tokens_checked": int(clear.sum()),
            "check_tokens_equal": int(same.sum()),
            "check_tokens": int(same.numel())}


def tp_rank(rank, world, backend, store, outdir, mode):
    """One rank of phase tp_serve: a ``backend`` group of ``world`` ranks
    on a (1, world) mesh, card 0 (gloo) or card ``rank`` (NCCL); ``mode``
    "phase" runs TP_CASES (``tp_phase_case``), "full" the four-card
    cases at full depth.  Writes its rows to ``outdir/rank<rank>.json``
    and its last stage to ``outdir/rank<rank>.stage``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.distributed import make_mesh

    def mark(stage):
        (Path(outdir) / f"rank{rank}.stage").write_text(stage)
    mark("started")
    spent = collections.Counter()
    TP_TIMING.update(spent=spent, switch=dp_time_collectives(torch, spent))
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, init_method="file://" + store,
                            world_size=world, rank=rank)
    out = {}
    try:
        mesh = make_mesh((1, world), ("data", "model"),
                         group=dist.group.WORLD)
        with torch.no_grad():
            if mode == "phase":
                for case in TP_CASES:
                    mark(case[0])
                    out[case[0]] = tp_phase_case(torch, case, mesh, dev,
                                                 outdir, rank)
            else:
                for name, fn in (("yi_60", tp_full_yi),
                                 ("gemma_46", tp_full_gemma),
                                 ("moe_28", lambda *a: tp_full_moe(
                                     *a, outdir))):
                    mark(name)
                    out[name] = fn(torch, mesh, dev, rank)
                    torch.cuda.empty_cache()
        mark("barrier")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(Path(outdir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)
    mark("done")


# -- phase tp_train: the train step over "model" across ranks ---------------


def tt_setup(case, mesh):
    """A tp_train case's config (full width, its depth, sequence
    parallelism on), sanitized state and batch specs, data config and
    optimizer config."""
    from repro_torch import configs
    from repro_torch.data import DataConfig
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    _, arch, layers, rows, seq, _, _ = case
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers,
                              seq_parallel=True)
    specs = steps.sanitize_pspecs(steps.state_pspecs(cfg),
                                  steps.state_struct(cfg), mesh)
    bspecs = steps.sanitize_pspecs(
        steps.batch_pspecs(cfg, "train_4k", mesh, batch=rows),
        steps.batch_struct(cfg, "train_4k", batch=rows, seq=seq), mesh)
    return (cfg, specs, bspecs, DataConfig(seq_len=seq, global_batch=rows),
            adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP))


def tt_full_layers(cfg, cards: int) -> int:
    """The deepest cut of ``cfg`` whose state, 16 bytes a parameter over
    ``cards`` cards, and TT_ACT_RESERVE of activations stay under
    TT_CARD_SHARE of a card."""
    import torch
    one = dataclasses.replace(cfg, n_layers=1).param_count()
    two = dataclasses.replace(cfg, n_layers=2).param_count()
    layer, outer = two - one, 2 * one - two
    room = (TT_CARD_SHARE * torch.cuda.get_device_properties(0).total_memory
            - TT_ACT_RESERVE - torch.cuda.memory_reserved(0)
            - 16 * outer / cards)
    return max(1, min(cfg.n_layers, int(room // (16 * layer / cards))))


def tt_rank(rank, world, backend, store, outdir, cases, shape, save):
    """One rank of phase tp_train: a ``backend`` group of ``world`` ranks
    on a ``shape`` ("data", "model") mesh, card 0 (gloo) or card ``rank``
    (NCCL), every case's steps on this rank's blocks of the state and its
    rows of the batch (launches, collectives, peak memory a step); rank 0
    keeps its first step's first B7 call's inputs (``flash_attention_train``,
    the training call) and first B6 call's ids.  Writes its rows to
    ``outdir/rank<rank>.json``, with ``save`` its master blocks to
    ``outdir/<case>_rank<rank>.pt``, rank 0's kernel inputs to
    ``outdir/<case>_inputs.pt``, and its last stage to
    ``outdir/rank<rank>.stage``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data import synth_batch
    from repro_torch.distributed import COLLECTIVES, make_mesh
    from repro_torch.distributed.sharding import shard
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import layers
    from repro_torch.tree import flatten_with_paths

    def mark(stage):
        (Path(outdir) / f"rank{rank}.stage").write_text(stage)
    mark("started")
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, init_method="file://" + store,
                            world_size=world, rank=rank)
    out = {}
    try:
        mesh = make_mesh(shape, ("data", "model"), group=dist.group.WORLD)
        for case in cases:
            label, _, _, rows, seq, n_steps, seed = case
            cfg, specs, bspecs, dcfg, ocfg = tt_setup(case, mesh)
            mark(f"{label}: init")
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            t0 = time.perf_counter()
            state = steps.init_state(cfg, specs.master, mesh, gen, device=dev)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            step = steps.make_train_step(cfg, ocfg, specs.master, mesh=mesh,
                                         batch_specs=bspecs)
            plan = steps.train_collectives(
                cfg, specs.master, mesh, rows * seq,
                batch_sharded=bspecs["labels"][0] is not None, seq=seq)
            plan = {k: v for k, v in plan.items() if v}
            res, seen, tickets = [], {}, []
            real = layers.flash_attention_train

            def spy(q, k, v, **kw):
                seen.setdefault("attn", (q.detach().clone(),
                                         k.detach().clone(),
                                         v.detach().clone(), kw))
                return real(q, k, v, **kw)
            for i in range(n_steps):
                mark(f"{label}: step {i}")
                batch = batch_to_device(synth_batch(cfg, dcfg, i % 2), dev)
                batch = {k: shard(v, bspecs[k], mesh).contiguous()
                         for k, v in batch.items()}
                first = rank == 0 and i == 0
                undo = dp_spy_tickets(tickets) if first else (lambda: None)
                if first:
                    layers.flash_attention_train = spy
                torch.cuda.synchronize()
                _build.reset_launches()
                torch.cuda.reset_peak_memory_stats()
                before = dict(COLLECTIVES)
                try:
                    t1 = time.perf_counter()
                    state, m = step(state, batch)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t1
                finally:
                    layers.flash_attention_train = real
                    undo()
                res.append({
                    "loss": float(m["loss"]), "grad_norm": float(
                        m["grad_norm"]), "lr": float(m["lr"]),
                    "wall_s": wall, "tokens_per_s": rows * seq / wall,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": {k: v for k, v in _build.LAUNCHES.items()
                                 if v},
                    "collectives": {k: COLLECTIVES[k] - before[k]
                                    for k in COLLECTIVES
                                    if COLLECTIVES[k] != before[k]}})
            if seen or tickets:
                torch.save({"attn": seen.get("attn"),
                            "tickets": tickets[0] if tickets else None},
                           Path(outdir) / f"{label}_inputs.pt")
            mark(f"{label}: save")
            if save:
                torch.save({k: v.cpu() for k, v in
                            flatten_with_paths(state.master)},
                           Path(outdir) / f"{label}_rank{rank}.pt")
            out[label] = {"rows": res, "plan": plan, "init_s": init_s,
                          "layers": cfg.n_layers, "state_gb": sum(
                              v.numel() * v.element_size()
                              for part in state[:3]
                              for _, v in flatten_with_paths(part)) / 1e9}
            del state, step, seen
            torch.cuda.empty_cache()
        mark("barrier")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(Path(outdir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)
    mark("done")


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
    # kernels whose ptxas report names spill stores or loads
    spills = {name: [ln.strip() for ln in log.splitlines()
                     if "spill" in ln and "0 bytes spill stores, 0 bytes "
                     "spill loads" not in ln]
              for name, log in info["ptxas"].items()}
    emit_phase({"phase": "build", "nvcc": info["nvcc"],
                "seconds": info["seconds"], "built": info["built"],
                "ptxas": regs,
                "spills": {k: v for k, v in spills.items() if v}})

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

    # multicard. the queue meshes across processes, one shard a rank:
    # gloo ranks sharing the card, NCCL ranks a card each where there are
    # two or more, each cell against the one-card stacked engine
    emit_phase(smoke.multicard_path(K))

    # dp_train. the sharded train step (ZeRO-3 over "data") on gloo ranks
    # sharing the card, each case against the one-card step
    torch.cuda.empty_cache()
    emit_phase(smoke.dp_train_path(K))

    # tp_serve. the serve steps over "model" (tensor, expert and vocabulary
    # parallelism, the prefill's sequence split) on gloo ranks sharing the
    # card, each case against the one-card steps on the same weights
    torch.cuda.empty_cache()
    emit_phase(smoke.tp_serve_path(K))

    # tp_train. the train step over "model" (tensor, expert and vocabulary
    # parallelism with their backward, the residual stream split along the
    # sequence) on gloo ranks sharing the card, each case against the
    # one-card step on the same weights
    torch.cuda.empty_cache()
    emit_phase(smoke.tp_train_path(K))

    # 9. gemma3-4b prefill at full width (granite's weights are freed)
    torch.cuda.empty_cache()
    gemma_info, seen_gemma = smoke.gemma_path(K, configs, models)
    emit_phase(gemma_info)

    # train. the flash backward's checks, h2o-danube-1.8b and mamba2-130m
    # trained at full width, mamba2's restart, prefill and decode
    torch.cuda.empty_cache()
    train_info, seen_train = smoke.train_path(K, configs, models)
    emit_phase(train_info)

    # zoo. zamba2-7b, llama-3.2-vision-11b and hubert-xlarge at full width:
    # B7 at hd 112 and unmasked, prefills, decodes, serves and training
    torch.cuda.empty_cache()
    zoo_info, seen_zoo = smoke.zoo_path(K, configs, models, serving)
    emit_phase(zoo_info)

    # registry. deepseek-moe-16b, gemma2-27b and yi-34b at full width,
    # prefill_32k, decode_32k and long_500k at launch.dryrun's cuts
    torch.cuda.empty_cache()
    emit_phase(smoke.registry_path(K, configs, models, serving))

    # 7. kernel times at the paths' shapes
    emit({"kernels": kernel_rows(smoke, K, road_info, kron_info, heap_info,
                                 (qkron, qkron_dist), seen, road,
                                 road_dist, seen_gemma, obs_info,
                                 mesh_info, pmesh_info, ray_info,
                                 adm_info, seen_train, seen_zoo)})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def registry_rows(smoke, K, bound):
    """Phase 7's times of B6 and B7 at phase registry's shapes: ({shape:
    entry}, lost ms) for each, every entry with the kernel's, the plain
    version's and the library call's ms, its bound and its launches by
    path.  ``bound(nbytes, ops, rate)`` is phase 7's."""
    torch, np, dev = smoke.torch, smoke.np, smoke.dev
    rng = np.random.default_rng(2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # B6 at deepseek-moe-16b's 64 experts (top-6, phase registry): the
    # expert ids of its first MoE layer at 2 x 4,096 tokens (49,152 pairs)
    # and at 1 x 32,768 (196,608), and a serve decode step's 4 rows x 6
    # (24 pairs, seeded); each path's launches charged at its shape
    reg6, reg6_excess = {}, 0.0
    moe = importlib.import_module("repro_torch.models.moe")
    from repro_torch import configs as configs_mod
    dcfg = configs_mod.get_config(REG_ARCHS[0])
    cases = dict(smoke.reg_tickets)
    cases["decode"] = (torch.as_tensor(rng.integers(0, dcfg.n_experts, 24,
                                                    dtype=np.int32),
                                       device=dev),
                       {"num_experts": dcfg.n_experts,
                        "capacity": moe.moe_capacity(4, dcfg)})
    paths6 = {"prefill_4k": [f"reg_{REG_ARCHS[0]}"],
              "prefill_32k": [f"reg_{REG_ARCHS[0]}_p32k"],
              "decode": [f"reg_{REG_ARCHS[0]}_serve"]}
    for key, (ids, kw) in cases.items():
        n, e = ids.shape[0], kw["num_experts"]
        oh = torch.nn.functional.one_hot(ids.long(), e).int().t() \
            .contiguous()
        kern = smoke.time_ms(lambda: None,
                             lambda a, i: K.expert_tickets(ids, **kw))
        plain = smoke.time_ms(lambda: None, lambda a, i:
                              K.expert_tickets_plain(ids, **kw),
                              iters=10, reps=3)
        lib = smoke.time_ms(lambda: None, lambda a, i: torch.cumsum(
            oh, 1, dtype=torch.int32))
        bnd, by = bound(8 * n, n, ALU_OPS_PER_S)
        launches = {p: smoke.launches.get(p, {}).get("expert_tickets", 0)
                    for p in paths6[key]}
        reg6_excess += sum(launches.values()) * (kern[0] - bnd)
        reg6[key] = {"pairs": n, "experts": e, "capacity": kw["capacity"],
                     "dropped": int((K.expert_tickets(ids, **kw) < 0).sum()),
                     "ms": kern[0], "plain_ms": plain[0],
                     "library_ms": lib[0], "bound_ms": bnd, "bound_by": by,
                     "wall_ms": {"kernel": kern[1], "plain": plain[1],
                                 "library": lib[1]}, "launches": launches}

    # phase registry's B7 calls (REG_*) at each path's shapes, grouped by
    # window: seeded q, k and v of the path's shape (the kernel's time
    # does not depend on the values).  The kernel 20 calls a batch up to
    # 4,096 keys, 3 at 32,768, one call at 524,288 (and in float32, the
    # scalar kernel of the float32 check), SDPA likewise; the plain
    # version once, up to
    # 4,096 keys and at 32,768 for yi-34b's rep of 7 (its tile loop is
    # seconds a call there; at 524,288 it is 1,048,576 tiles and not run:
    # the dense rows stand in); SDPA (with enable_gqa, or with k and v
    # repeated to the query heads where no backend takes float32 GQA; a
    # window shorter than the keys as a boolean band) on every shape: in
    # bfloat16 up to 32,768 keys with the softcap left out (gemma2-27b's
    # rows there time a function without one), once in float32 and at
    # 524,288 keys, where a softcap (SDPA takes none) or a band (s^2
    # bytes) leaves it null with a note.  Bound: q, k, v and out once;
    # two products of 2 hd flop per (query, key) pair the mask keeps, at
    # the bf16 tensor-core rate (float32: the ALU rate).
    def once(fn):
        """(device ms, wall ms) of one call, CUDA events around it."""
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        fn()
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1]), (time.perf_counter() - t0) * 1e3

    def b7_pairs(s, causal, w):
        if not causal:
            return s * s
        if not w or w >= s:
            return s * (s + 1) // 2
        return w * (w + 1) // 2 + (s - w) * w

    g7 = torch.Generator(device=dev)
    g7.manual_seed(19)

    def reg7_time(b, h, s, hd, kvh, dtype, w, cap, causal):
        dt = torch.float32 if dtype == "float32" else torch.bfloat16
        q = (torch.randn((b, h, s, hd), generator=g7, device=dev)
             * 0.5).to(dt)
        k, v = ((torch.randn((b, kvh, s, hd), generator=g7, device=dev)
                 * 0.5).to(dt) for _ in range(2))
        kw = dict(causal=causal, window=w, softcap_val=cap)
        pairs = b7_pairs(s, causal, w)
        rate = ALU_OPS_PER_S if dtype == "float32" else BF16_TC_FLOP_PER_S
        bnd, by = bound(q.element_size() * 2 * (b * h * s * hd
                                                + b * kvh * s * hd),
                        4 * b * h * pairs * hd, rate)
        call = lambda: K.flash_attention(q, k, v, **kw)  # noqa: E731
        if s > 32768 or dtype == "float32":
            kern = once(call)
        else:
            kern = smoke.time_ms(lambda: None, lambda a, i: call(),
                                 iters=20 if s <= 4096 else 3,
                                 reps=5 if s <= 4096 else 2)
        plain = (once(lambda: K.flash_attention_plain(q, k, v, **kw))
                 if dtype == "bfloat16" and (s <= 4096 or (
                     s <= 32768 and h == 7 * kvh)) else (None, None))
        lib, lib_note = (None, None), None
        big = s > 32768 or dtype == "float32"
        if big and cap:
            lib_note = "SDPA takes no softcap"
        elif s > 32768 and w and w < s:
            lib_note = f"the band as a boolean mask is {s}^2 bytes"
        else:
            mask = None
            if w and w < s:
                pos = torch.arange(s, device=dev)
                mask = (pos[None, :] <= pos[:, None]) & \
                    (pos[None, :] > pos[:, None] - w)
            notes = []
            for gqa in (True, False):
                kk, vv = ((k, v) if gqa else (
                    t.repeat_interleave(h // kvh, dim=1) for t in (k, v)))
                call_lib = lambda: sdpa(  # noqa: E731
                    q, kk, vv, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=gqa)
                try:
                    lib = (once(call_lib) if big else smoke.time_ms(
                        lambda: None, lambda a, i: call_lib(),
                        iters=20 if s <= 4096 else 3,
                        reps=5 if s <= 4096 else 2))
                    break
                except RuntimeError as e:  # out of memory or no backend
                    notes.append(f"enable_gqa={gqa}: {type(e).__name__}: "
                                 f"{str(e)[:160]}")
                del kk, vv
                torch.cuda.empty_cache()
            lib_note = "; ".join(notes) or None
            del mask
        del q, k, v
        torch.cuda.empty_cache()
        return {"q": [b, h, s, hd], "kv_heads": kvh, "dtype": dtype,
                "causal": causal, "window": w, "softcap": cap,
                "pairs": pairs, "ms": kern[0], "plain_ms": plain[0],
                "library_ms": lib[0], "library_note": lib_note,
                "bound_ms": bnd, "bound_by": by,
                "wall_ms": {"kernel": kern[1], "plain": plain[1],
                            "library": lib[1]}, "launches": {}}

    reg7, reg7_excess = {}, 0.0
    for rec in smoke.reg_b7:
        for w, calls in rec["windows"].items():
            b, h, s, hd = rec["q"]
            key = (f"{s}_{h}x{rec['kv_heads']}_hd{hd}_w{w}"
                   f"_cap{rec['softcap']:g}_{rec['dtype']}")
            if key not in reg7:
                reg7[key] = reg7_time(b, h, s, hd, rec["kv_heads"],
                                      rec["dtype"], w, rec["softcap"],
                                      rec["causal"])
            x = reg7[key]
            x["launches"][rec["path"]] = calls
            reg7_excess += calls * (x["ms"] - x["bound_ms"])
    return reg6, reg6_excess, reg7, reg7_excess


def kernel_rows(smoke, K, road, kron, heap, qkron, seen, road_g,
                road_dist, seen_gemma, obs_info, mesh_info, pmesh_info,
                ray_info, adm_info, seen_train, seen_zoo):
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
            "exact": smoke.err[name] == 0 and name not in (
                "flash_attention", "flash_attention_bwd"),
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
    # B4 past arity 8 (the runtime-arity instance, no shared-memory top):
    # the same pop and insert calls on a 2^20-slot heap of the same
    # occupancy at each wide arity; a pop level reads all d child keys
    wide4 = {}
    for a in HEAP_ARITIES:
        if a in K.TOP_ARITY_LOG2:
            continue
        d4 = 1 << a
        wk = torch.full((1 << c4,), KEY_INF, **card)
        wv = torch.full((1 << c4,), -1, **card)
        K.heap_apply(wk, wv, 0, torch.zeros(occ, **card), seed, seed,
                     cap_log2=c4, arity_log2=a)
        lv = max(int(np.ceil(np.log((d4 - 1) * occ + 1) / np.log(d4))), 1)

        def wide_setup(wk=wk, wv=wv):
            return [wk.clone(), wv.clone(), torch.tensor(occ, **card)]

        def wide_call(fn, batch, a=a):
            def launch(st, i):
                st[2] = fn(st[0], st[1], st[2], *batch, cap_log2=c4,
                           arity_log2=a)[2]
            return launch
        wide = {}
        for name, batch, nbytes, ops in (
                ("pop", pops, BATCH * (4 + 9 + 24 + lv * (4 * d4 + 12)) + 8,
                 BATCH * lv * d4),
                ("insert", inserts, ins_bytes, n_act4)):
            kern = smoke.time_ms(wide_setup, wide_call(K.heap_apply, batch),
                                 iters=10, reps=3)
            plain = smoke.time_ms(wide_setup,
                                  wide_call(K.heap_apply_plain, batch),
                                  iters=1, reps=1)
            b, by = bound(nbytes, ops, ALU_OPS_PER_S)
            wide[name] = {"ms": kern[0], "wall_ms": kern[1],
                          "plain_ms": plain[1], "bound_ms": b,
                          "bound_by": by}
        wide4[f"arity_log2_{a}"] = dict(wide, levels=lv)
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
         "chain_bound_ms": (pop_chain_ms + ins_chain_ms) / 2,
         "wide_arities": wide4})

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

    reg6, reg6_excess, reg7, reg7_excess = registry_rows(smoke, K, bound)

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
                             "bound_by": b6d_by},
         "registry_64_experts": reg6},
        # the prefill's calls at its shape, serve's decode calls at theirs
        excess=(smoke.launches["prefill"].get("expert_tickets", 0)
                * (prefill6[0] - bound(8 * n6, n6, ALU_OPS_PER_S)[0])
                + (smoke.launches["serve"].get("expert_tickets", 0)
                   + smoke.launches["runtime"].get("expert_tickets", 0))
                * (dec6[0] - b6d) + reg6_excess))

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
        if kw["window"]:
            raise AssertionError("flash_times: a window's pairs are "
                                 "counted by its caller")
        # the (query, key) pairs the mask keeps
        pairs = s * (s + 1) // 2 if kw["causal"] else s * s
        return (smoke.time_ms(lambda: None, lambda a, i: K.flash_attention(
                    q, k, v, **kw), iters=20),
                smoke.time_ms(lambda: None, lambda a, i:
                              K.flash_attention_plain(q, k, v, **kw),
                              iters=2, reps=2),
                smoke.time_ms(lambda: None, lambda a, i: sdpa(
                    q, k, v, is_causal=kw["causal"], enable_gqa=True),
                    iters=20),
                # q and out (B, H, S, hd), k and v (B, KV, S, hd),
                # bfloat16; two products of 2 * hd flop per kept
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
    def mask_pairs(s, kw):
        """The (query, key) pairs the mask keeps, and the band as a
        boolean mask where a window shorter than S cuts it (else None)."""
        if kw["window"] and kw["window"] < s:
            pos = torch.arange(s, device=dev)
            band = pos[None, :] > pos[:, None] - kw["window"]
            if kw["causal"]:
                band = band & (pos[None, :] <= pos[:, None])
            return int(band.sum()), band
        return (s * (s + 1) // 2 if kw["causal"] else s * s), None

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
    pairs10, band = mask_pairs(s10, kw10)
    hd256_local = sub(
        smoke.time_ms(lambda: None, lambda a, i: K.flash_attention(
            q10, k10, v10, **kw10), iters=20),
        smoke.time_ms(lambda: None, lambda a, i: K.flash_attention_plain(
            q10, k10, v10, **kw10), iters=2, reps=2),
        smoke.time_ms(lambda: None, lambda a, i: sdpa(
            q10, k10, v10, attn_mask=band, enable_gqa=True), iters=20),
        2 * (2 * b10 * h10 * s10 * hd10 + 2 * b10 * k10.shape[1] * s10
             * hd10), 4 * b10 * h10 * pairs10 * hd10,
        {"q": list(q10.shape), "kv_heads": k10.shape[1], "causal": True,
         "window": win, "pairs": pairs10, "layer": 0,
         "library": "scaled_dot_product_attention with the band as a "
                    "boolean mask"})
    # phase zoo's prefills and encode at their first call's inputs (the
    # model's strided views): zamba2-7b's shared block (hd 112, causal),
    # llama-3.2-vision-11b's self layers (hd 128, GQA 32/8, causal, B 2)
    # and hubert-xlarge's encoder (hd 80, no mask).  Training runs B7 with
    # the lse at the same shapes (zamba2 at 24 layers)
    zoo = {}
    for key, label, paths in (
            ("hybrid", "hd112", ("zoo_hybrid", "zoo_hybrid_train")),
            ("vlm", "vlm_hd128", ("zoo_vlm",)),
            ("audio", "hd80_unmasked", ("zoo_audio", "zoo_audio_train"))):
        qz, kz, vz, kwz = seen_zoo[key]
        zoo[label] = sub(*flash_times(qz, kz, vz, kwz),
                         {"q": list(qz.shape), "kv_heads": kz.shape[1],
                          "causal": kwz["causal"],
                          "launches": {p: smoke.launches[p].get(
                              "flash_attention", 0) for p in paths}})
    zoo_excess = sum(n * (x["ms"] - x["bound_ms"]) for x in zoo.values()
                     for n in x["launches"].values())
    kern7, plain7, lib7, bytes7, ops7 = flash_times(q7, k7, v7, kw7)
    b7, h7, s7, hd7 = q7.shape
    # the lse write (training's forward) at serving's shape, in turns with
    # the plain forward in one call: without, with, with, without
    lse_ms = {"without": [], "with": []}
    for key in ("without", "with", "with", "without"):
        lse_ms[key].append(smoke.time_ms(lambda: None, lambda a, i: (
            K.flash_attention(q7, k7, v7, return_lse=key == "with",
                              **kw7)), iters=20)[0])
    # training's forward at h2o-danube-1.8b's layer 0 (hd 80, with the
    # lse), the shape of its 2 x 24 launches a step
    qt, kt, vt, kwt, out_t, lse_t, dout_t = seen_train["danube"]
    bt, ht, st, hdt = qt.shape
    kvt = kt.shape[1]
    pairs_t = st * (st + 1) // 2
    train_fwd = smoke.time_ms(lambda: None, lambda a, i: K.flash_attention(
        qt, kt, vt, return_lse=True, **kwt), iters=20)
    b_tf, b_tf_by = bound(2 * (2 * bt * ht * st * hdt + 2 * bt * kvt * st
                               * hdt) + 4 * bt * ht * st,
                          4 * bt * ht * pairs_t * hdt, BF16_TC_FLOP_PER_S)
    gemma_train_b7 = smoke.launches["train_gemma3"].get("flash_attention", 0)
    row("flash_attention", csrc + "flash_wgmma.cu",
        "src/repro/kernels/flash_attn.py:38", kern7, plain7, lib7,
        bytes7, ops7,
        {"q": [b7, h7, s7, hd7], "kv_heads": k7.shape[1],
         "dtype": "bfloat16", "causal": kw7["causal"],
         "window": kw7["window"], "softcap": kw7["softcap_val"],
         "tolerance": FLASH_TOL,
         "bound_used": smoke.bound_used["flash_attention"],
         "layout": "(B, S, H, hd) strided", "hd128": hd128,
         "hd256_global": hd256, "hd256_local": hd256_local, **zoo,
         "registry": reg7,
         "lse_write_ms": {k: statistics.mean(v) for k, v in lse_ms.items()},
         "lse_write_turns_ms": lse_ms,
         "train_hd80_with_lse": {"ms": train_fwd[0],
                                 "wall_ms": train_fwd[1], "bound_ms": b_tf,
                                 "bound_by": b_tf_by, "q": [bt, ht, st, hdt],
                                 "kv_heads": kvt}},
        rate=BF16_TC_FLOP_PER_S,
        # granite's prefill at its shape; gemma3's local and global layers
        # each at their own; training's forward and remat at danube's
        excess=(smoke.launches["prefill"].get("flash_attention", 0)
                * (kern7[0] - bound(bytes7, ops7, BF16_TC_FLOP_PER_S)[0])
                + sum(1 for w in smoke.gemma_windows if w)
                * (hd256_local["ms"] - hd256_local["bound_ms"])
                + sum(1 for w in smoke.gemma_windows if not w)
                * (hd256["ms"] - hd256["bound_ms"])
                + smoke.launches["train"].get("flash_attention", 0)
                * (train_fwd[0] - b_tf) + zoo_excess
                # gemma3's training (forward and remat, with the lse) at
                # the prefill's local and global rows
                + gemma_train_b7 * sum(1 for w in smoke.gemma_train_windows
                                       if w) / len(smoke.gemma_train_windows)
                * (hd256_local["ms"] - hd256_local["bound_ms"])
                + gemma_train_b7 * sum(1 for w in smoke.gemma_train_windows
                                       if not w)
                / len(smoke.gemma_train_windows)
                * (hd256["ms"] - hd256["bound_ms"]) + reg7_excess))

    # the flash backward (csrc/flash_bwd.cu) at h2o-danube-1.8b's layer 0
    # of phase train: its q, k, v (the model's strided views), B7's out
    # and lse, a seeded dout.  Bound: q, k, v, out, dout and the lse read
    # once, dq, dk and dv written once; five products of 2 hd flop per
    # (query, key) pair the mask keeps and head, at the bf16 tensor-core
    # rate.  Library: scaled_dot_product_attention's backward on the same
    # inputs with the same mask (danube's window equals S, so its mask is
    # the causal one; a window shorter than S goes to SDPA as a boolean
    # band, as B7's local row does), timed here only.  The same at phase
    # zoo's training shapes: zamba2-7b's shared block (hd 112, causal)
    # under ``hd112``, hubert-xlarge's encoder (hd 80, no mask) under
    # ``hd80_unmasked``; and at gemma3-4b's training layers (hd 256, GQA
    # 8/4): a global layer under ``hd256_global``, a local one (window
    # 1,024) under ``hd256_local``.  The split between its dq and dk/dv
    # kernels is the profiler's device time of each over danube's
    # profiled step (24 calls at this shape).
    def bwd_times(q, k, v, kw, out, lse, dout):
        b, h, s, hd = q.shape
        kvh = k.shape[1]
        pairs, band = mask_pairs(s, kw)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        if band is None:
            o = sdpa(*leaves, is_causal=kw["causal"], enable_gqa=True)
        else:
            o = sdpa(*leaves, attn_mask=band, enable_gqa=True)
        return (smoke.time_ms(lambda: None, lambda a, i: K.flash_attention_bwd(
                    q, k, v, out, dout, lse, **kw), iters=10),
                smoke.time_ms(lambda: None, lambda a, i:
                              K.flash_attention_bwd_plain(
                                  q, k, v, out, dout, lse, **kw),
                              iters=2, reps=2),
                smoke.time_ms(lambda: None, lambda a, i: torch.autograd.grad(
                    o, leaves, dout, retain_graph=True), iters=10),
                2 * (3 * b * h * s * hd + 2 * b * kvh * s * hd)
                + 4 * b * h * s + 2 * (b * h * s * hd + 2 * b * kvh * s * hd),
                5 * 2 * hd * pairs * b * h)

    bwd_kw = dict(causal=kwt["causal"], window=kwt["window"],
                  softcap_val=kwt["softcap_val"])
    kern_b, plain_b, lib_b, bytes_b, ops_b = bwd_times(
        qt, kt, vt, bwd_kw, out_t, lse_t, dout_t)
    bwd_rows = {}
    seen_zoo = dict(seen_zoo, dp_bwd=smoke.dp_bwd, tp_bwd=smoke.tp_bwd)
    for key, label, path in (("hybrid_bwd", "hd112", "zoo_hybrid_train"),
                             ("audio_bwd", "hd80_unmasked",
                              "zoo_audio_train"),
                             ("dp_bwd", "hd128_dp_train", "dp_train"),
                             ("tp_bwd", "hd128_tp_train", "tp_train")):
        qz, kz, vz, kwz, oz, lz, dz = seen_zoo[key]
        bwd_rows[label] = sub(*bwd_times(qz, kz, vz, kwz, oz, lz, dz),
                              {"q": list(qz.shape), "kv_heads": kz.shape[1],
                               "causal": kwz["causal"],
                               "launches": {path: smoke.launches[path].get(
                                   "flash_attention_bwd", 0)}})
    # gemma3-4b's training: its launches split between its local and
    # global layers as its layer pattern does
    wins = smoke.gemma_train_windows
    n_gemma = smoke.launches["train_gemma3"].get("flash_attention_bwd", 0)
    for key, label, local in (("gemma3_global", "hd256_global", False),
                              ("gemma3_local", "hd256_local", True)):
        qg, kg, vg, kwg, og, lg, dg = seen_train[key]
        share = sum(1 for w in wins if bool(w) == local) / len(wins)
        bwd_rows[label] = sub(*bwd_times(qg, kg, vg, kwg, og, lg, dg),
                              {"q": list(qg.shape), "kv_heads": kg.shape[1],
                               "causal": kwg["causal"],
                               "window": kwg["window"],
                               "pairs": mask_pairs(qg.shape[2], kwg)[0],
                               "launches": {"train_gemma3": round(
                                   n_gemma * share)}})
    row("flash_attention_bwd", csrc + "flash_bwd.cu",
        "src/repro/models/layers.py:250 (_flash_core_bwd, XLA; no Pallas "
        "kernel)", kern_b, plain_b, lib_b, bytes_b, ops_b,
        {"q": [bt, ht, st, hdt], "kv_heads": kvt, "dtype": "bfloat16",
         **bwd_kw, "layout": "(B, S, H, hd) strided",
         "tolerance": FLASH_BWD_TOL,
         "bound_used": smoke.bound_used["flash_attention_bwd"],
         "exact_tolerance": FLASH_BWD_EXACT_TOL,
         "exact_bound_used": smoke.bound_used["flash_attention_bwd_exact"],
         "calls_repeated_bit_for_bit": smoke.bwd_same,
         "launches_per_call": 2, "split": smoke.bwd_split, **bwd_rows,
         "library": "scaled_dot_product_attention backward"},
        rate=BF16_TC_FLOP_PER_S,
        # danube's launches at its shape, the zoo's and gemma3's at theirs
        excess=(smoke.launches["train"].get("flash_attention_bwd", 0)
                * (kern_b[0] - bound(bytes_b, ops_b, BF16_TC_FLOP_PER_S)[0])
                + sum(n * (x["ms"] - x["bound_ms"])
                      for x in bwd_rows.values()
                      for n in x["launches"].values())))

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
