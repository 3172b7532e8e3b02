"""Sharded MPMC task fabric over the simulated queue algorithms (DESIGN.md § 4.1).

A copy of ``repro/runtime/taskpool.py`` (the port imports nothing of the JAX
package); only the imports and the docstrings differ.

The fabric is the runtime's work-distribution layer: K independent bounded
rings ("shards") per priority lane, each shard any algorithm from
``repro_torch.core.QUEUE_CLASSES``.  Task payloads are arbitrary Python objects
held in a host-side task table; the rings carry only the 31-bit task ids —
exactly the paper's index-indirection discipline ("move indices, not
payloads") applied at runtime scope.

Placement policy (the two halves of the paper's load-balancing story):

* **wave-affinity enqueue** — a thread spawns children onto the shard owned
  by its *wave* (``wave % K``), so a converged wave's ticket reservations hit
  one hot ring (maximal WAVEFAA batching) and child tasks stay near their
  producer.  External arrivals are sprayed round-robin instead.
* **work-stealing dequeue** — a consumer drains its home shard first; when
  the home ring reports EMPTY it scans the other shards in ring order and
  steals.  Disable with ``steal=False`` to measure the imbalance this
  repairs.

Priority lanes are strict: lane 0 (urgent) is scanned across all shards
before lane 1 ever is.

Every ring operation is bracketed with ``op_begin``/``op_end`` so the
scheduler's § IV history machinery sees the fabric traffic, and each event
is also filed into a per-(lane, shard) history so ``check_linearizable`` can
certify every shard independently (task ids are globally unique, hence the
histories are differentiated).

``HostTaskPool`` at the bottom is the same fabric for *real* host threads
(sharded ``HostRing``s + stealing + lanes) — the serving engine's admission
queue.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..core import QUEUE_CLASSES
from ..core.base import VAL_MASK
from ..core.sim import Ctx, DEQ, ENQ, HistoryEvent, Scheduler
from ..data.pipeline import HostRing
from ..obs.metrics import MetricsRegistry, metric_key
from ..sched.gpq import GPQ
from ..sched.policy import make_policy

OUTSTANDING = "rt_outstanding"   # quiescence counter (tasks queued or running)
HINTS = "rt_hints"               # per-ring occupancy hints (poll gating)
NEG1 = (1 << 64) - 1             # two's-complement -1 for FAA decrements


@dataclass
class TaskSpec:
    """What a handler returns to spawn a child task."""
    payload: Any
    priority: int = 1            # 0 = urgent class, 1 = normal class
    cost: int = 0                # simulated compute steps to execute
    deadline: Optional[int] = None   # absolute step deadline (EDF policies)


@dataclass
class TaskRecord:
    task_id: int
    payload: Any
    priority: int
    cost: int
    deadline: Optional[int] = None
    key: int = 0                 # policy-computed scheduling key (G-PQ min-key)
    enq_step: int = -1           # step of the successful queue install
    exec_step: int = -1          # step a worker acquired it for execution


@dataclass
class FabricMetrics:
    enqueues: int = 0
    dequeues: int = 0
    steals: int = 0              # successful dequeues off a non-home shard
    steal_scans: int = 0         # shards probed beyond home
    empty_scans: int = 0         # full acquire passes that found nothing
    enq_retries: int = 0         # backpressure retries (all shards full)
    per_shard_deq: Dict[Tuple[int, int], int] = field(default_factory=dict)

    def load_imbalance(self) -> float:
        """max/mean successful dequeues across shards (1.0 = perfectly even)."""
        counts = list(self.per_shard_deq.values())
        if not counts or sum(counts) == 0:
            return 1.0
        mean = sum(counts) / len(counts)
        return max(counts) / mean if mean else 1.0

    def publish(self, registry: MetricsRegistry, *,
                subsystem: str = "fabric") -> None:
        """Write this snapshot into ``registry`` under the stable
        ``fabric.*`` key scheme (DESIGN.md § 7.2): scalar totals as
        counters, ``load_imbalance`` as a gauge, and the per-(lane, shard)
        dequeue counts as ``fabric.deq[lane=L,shard=S]`` — replacing the
        ``(lane, shard)``-tuple-keyed dict consumers used to reach into."""
        for name in ("enqueues", "dequeues", "steals", "steal_scans",
                     "empty_scans", "enq_retries"):
            registry.counter(metric_key(subsystem, name), getattr(self, name))
        registry.gauge(metric_key(subsystem, "load_imbalance"),
                       self.load_imbalance())
        for (lane, shard), n in sorted(self.per_shard_deq.items()):
            registry.counter(metric_key(subsystem, "deq",
                                        lane=lane, shard=shard), n)


class _FabricBase:
    """State and lifecycle shared by ``TaskFabric`` and ``PriorityFabric``:
    placement helpers (wave-affinity homes + round-robin spray), the host
    task table, dynamic-spawn / OUTSTANDING quiescence accounting, and the
    per-class queue-wait (starvation) metrics.  Subclasses supply
    ``register``, ``enqueue_task``, ``acquire``, and ``validate_priority``."""

    def __init__(self, *, shards: int, wave_size: int) -> None:
        self.shards = shards
        self.wave_size = wave_size
        self.tasks: List[TaskRecord] = []
        self.metrics = FabricMetrics()
        self.waits: Dict[int, List[int]] = {}   # priority class -> queue waits
        self.sched: Optional[Scheduler] = None
        self._rr = itertools.count()          # round-robin arrival spray

    def validate_priority(self, priority: int) -> int:
        raise NotImplementedError

    def validate_deadline(self, deadline: Optional[int]) -> Optional[int]:
        """Fabrics with bounded key encodings override this; the lane
        fabric ignores deadlines."""
        return deadline

    # -- placement -----------------------------------------------------------

    def home_shard(self, tid: int) -> int:
        """Wave-affinity: all lanes of a wave share one home shard."""
        return (tid // self.wave_size) % self.shards

    def spray_shard(self) -> int:
        """Round-robin placement for external arrivals."""
        return next(self._rr) % self.shards

    # -- wait (starvation) accounting ----------------------------------------

    def _record_install(self, rec: TaskRecord) -> None:
        self.metrics.enqueues += 1
        if rec.enq_step < 0:
            rec.enq_step = self.sched.step_count

    def _record_acquire(self, rec: TaskRecord) -> None:
        rec.exec_step = self.sched.step_count
        if rec.enq_step >= 0:
            self.waits.setdefault(rec.priority, []).append(
                rec.exec_step - rec.enq_step)

    # -- spawn / quiescence (generator ops) ----------------------------------

    def spawn(self, ctx: Ctx, tid: int, spec: TaskSpec,
              shard: Optional[int] = None):
        """Register + account + enqueue a dynamically spawned task.  The
        OUTSTANDING increment happens *before* the install so the counter
        can never read zero while this task is invisible to consumers."""
        rec = self.register(spec.payload, spec.priority, spec.cost,
                            spec.deadline)
        yield from ctx.faa(OUTSTANDING, 0, 1)
        yield from self.enqueue_task(ctx, tid, rec, shard)
        return rec

    def complete(self, ctx: Ctx, tid: int):
        """Retire a task (decrement OUTSTANDING).  Call only after all of the
        task's children were spawned — spawn-before-complete is what makes
        the zero-read a sound quiescence certificate."""
        yield from ctx.faa(OUTSTANDING, 0, NEG1)

    def outstanding(self, ctx: Ctx, tid: int):
        v = yield from ctx.load(OUTSTANDING, 0)
        return v

    # -- reporting -----------------------------------------------------------

    def steal_rate(self) -> float:
        return self.metrics.steals / max(self.metrics.dequeues, 1)

    def wait_stats(self) -> Dict[str, float]:
        return _wait_stats(self.waits)


class TaskFabric(_FabricBase):
    """K shards × L priority lanes of bounded rings + the host task table.
    A host simulation over ``AtomicMemory``: it touches no device and
    takes no ``device``."""

    def __init__(self, *, algo: str = "glfq", shards: int = 4, lanes: int = 2,
                 capacity_per_shard: int = 256, num_threads: int = 32,
                 wave_size: int = 8, steal: bool = True,
                 queue_kw: Optional[dict] = None) -> None:
        if algo not in QUEUE_CLASSES:
            raise ValueError(f"unknown algo {algo!r}; pick from {list(QUEUE_CLASSES)}")
        super().__init__(shards=shards, wave_size=wave_size)
        self.algo = algo
        self.lanes = lanes
        self.capacity_per_shard = capacity_per_shard
        self.steal = steal
        qcls = QUEUE_CLASSES[algo]
        kw = dict(queue_kw or {})
        self.rings = {
            (lane, s): qcls(capacity_per_shard, num_threads,
                            tag=f"rt_{algo}_l{lane}s{s}", **kw)
            for lane in range(lanes) for s in range(shards)
        }
        self.shard_history: Dict[Tuple[int, int], List[HistoryEvent]] = {
            key: [] for key in self.rings
        }

    # -- lifecycle -----------------------------------------------------------

    def validate_priority(self, priority: int) -> int:
        if not 0 <= priority < self.lanes:
            raise ValueError(
                f"priority {priority} out of range [0, {self.lanes}) — "
                f"lanes are not clamped; pick a valid lane")
        return priority

    def init(self, mem, sched: Scheduler, initial_outstanding: int = 0) -> None:
        self.sched = sched
        for ring in self.rings.values():
            ring.init(mem)
        mem.alloc(OUTSTANDING, 1, fill=initial_outstanding)
        # Occupancy hints gate idle polling: a consumer only issues a real
        # dequeue against a ring whose hint is nonzero.  This is the
        # persistent-kernel analogue of sCQ's Threshold — without it, idle
        # workers hammer EMPTY dequeues, which on ticket-based designs
        # (G-WFQ-YMC's FAA head) burn unbounded tickets while the queue
        # sits empty.  The hint is conservative (incremented *after* a
        # successful install, decremented after a successful take), so a
        # skipped poll never hides a task for longer than one scan.
        mem.alloc(HINTS, self.lanes * self.shards, fill=0)

    def register(self, payload: Any, priority: int = 1, cost: int = 0,
                 deadline: Optional[int] = None) -> TaskRecord:
        self.validate_priority(priority)
        tid = len(self.tasks)
        assert tid <= VAL_MASK, "task table exceeded the 31-bit id space"
        rec = TaskRecord(tid, payload, priority, cost, deadline)
        self.tasks.append(rec)
        return rec

    # -- history plumbing ----------------------------------------------------

    def _file(self, lane: int, shard: int) -> None:
        # op_end just appended the event to the global history; cross-file it
        # under the ring it actually targeted for per-shard checking.
        if self.sched is not None and self.sched.history:
            self.shard_history[(lane, shard)].append(self.sched.history[-1])

    # -- generator ops (driven by the Scheduler) ------------------------------

    def enqueue_task(self, ctx: Ctx, tid: int, rec: TaskRecord,
                     shard: Optional[int] = None):
        """Place a task id onto its lane, home shard first, overflowing to
        the other shards, retrying (with backoff) under full backpressure.
        Never drops: returns only after the id is installed."""
        lane = rec.priority
        home = self.home_shard(tid) if shard is None else shard
        while True:
            for k in range(self.shards):
                s = (home + k) % self.shards
                ring = self.rings[(lane, s)]
                yield from ctx.op_begin(ENQ, rec.task_id)
                ok = yield from ring.enqueue(ctx, tid, rec.task_id)
                yield from ctx.op_end(ok, ok)
                self._file(lane, s)
                if ok:
                    yield from ctx.faa(HINTS, lane * self.shards + s, 1)
                    self._record_install(rec)
                    return s
            self.metrics.enq_retries += 1
            yield from ctx.step()      # every shard full: back off and retry

    def acquire(self, ctx: Ctx, tid: int):
        """Dequeue one task: urgent lane first, home shard first, stealing
        from sibling shards when enabled.  Returns a TaskRecord or None."""
        home = self.home_shard(tid)
        scan = self.shards if self.steal else 1
        for lane in range(self.lanes):
            for k in range(scan):
                s = (home + k) % self.shards
                hint = yield from ctx.load(HINTS, lane * self.shards + s)
                if hint == 0:
                    continue                  # poll gate: ring almost surely empty
                ring = self.rings[(lane, s)]
                yield from ctx.op_begin(DEQ, None)
                ok, v = yield from ring.dequeue(ctx, tid)
                yield from ctx.op_end(v if ok else None, ok)
                self._file(lane, s)
                if k > 0:
                    self.metrics.steal_scans += 1
                if ok:
                    yield from ctx.faa(HINTS, lane * self.shards + s, NEG1)
                    self.metrics.dequeues += 1
                    key = (lane, s)
                    self.metrics.per_shard_deq[key] = (
                        self.metrics.per_shard_deq.get(key, 0) + 1)
                    if k > 0:
                        self.metrics.steals += 1
                    rec = self.tasks[v]
                    self._record_acquire(rec)
                    return rec
        self.metrics.empty_scans += 1
        return None


def _wait_stats(waits: Dict[int, List[int]]) -> Dict[str, float]:
    """Queue-wait starvation metrics by class (0 = urgent, ≥1 = normal)."""
    def pct(xs: List[int], q: float) -> float:
        if not xs:
            return 0.0
        ys = sorted(xs)
        return float(ys[min(len(ys) - 1, int(q * len(ys)))])

    urgent = waits.get(0, [])
    normal = [w for cls, xs in waits.items() if cls != 0 for w in xs]
    return {
        "urgent_max_wait": float(max(urgent, default=0)),
        "urgent_p99_wait": pct(urgent, 0.99),
        "normal_max_wait": float(max(normal, default=0)),
        "normal_p99_wait": pct(normal, 0.99),
        "normal_mean_wait": (sum(normal) / len(normal)) if normal else 0.0,
    }


# ---------------------------------------------------------------------------
# Priority fabric (DESIGN.md § 5.4): policy-keyed G-PQ shards
# ---------------------------------------------------------------------------


class PriorityFabric(_FabricBase):
    """K shards of G-PQ min-heaps + the host task table — the priority
    replacement for ``TaskFabric``'s strict lanes.  Drop-in for
    ``TaskRuntime``: same generator protocol (``enqueue_task`` /
    ``acquire`` / ``spawn`` / ``complete`` / ``outstanding``).

    A ``PriorityPolicy`` (strict | weighted | edf, ``repro_torch.sched.policy``)
    maps each task's (class, deadline) to the integer min-key the shards
    order by, so lane semantics become a pure key encoding:

    * placement mirrors ``TaskFabric``: wave-affinity homes for spawned
      children, round-robin spray for external arrivals, overflow to
      sibling shards, retry under full backpressure;
    * **stealing is highest-priority-first**: an acquire reads every
      shard's min-key hint and scans shards in ascending-hint order
      (home shard breaks ties), so a steal always goes after the most
      urgent visible work rather than ring order;
    * every shard op is bracketed into the § IV history and filed
      per shard; each shard history is independently checkable with
      ``sched.check_p_linearizable`` at k = 0 (strict shards) or the
      shard's exact lazy bound.

    Starvation accounting: queue waits (install → acquire, in scheduler
    steps) are recorded per class; ``wait_stats()`` feeds the § V-C
    starvation metrics (max / p99 wait per class).

    A host simulation over ``AtomicMemory``: it touches no device and
    takes no ``device``.
    """

    def __init__(self, *, policy="edf", shards: int = 4,
                 capacity_per_shard: int = 256, num_threads: int = 32,
                 wave_size: int = 8, steal: bool = True, arity: int = 4,
                 lazy: int = 0) -> None:
        super().__init__(shards=shards, wave_size=wave_size)
        self.policy = make_policy(policy)
        self.capacity_per_shard = capacity_per_shard
        self.steal = steal
        self.lazy = lazy
        self.pqs = {
            s: GPQ(capacity_per_shard, num_threads,
                   tag=f"pf_{self.policy.name}_s{s}", arity=arity, lazy=lazy)
            for s in range(shards)
        }
        self.shard_history: Dict[int, List[HistoryEvent]] = {
            s: [] for s in range(shards)
        }

    # -- lifecycle -----------------------------------------------------------

    def init(self, mem, sched: Scheduler, initial_outstanding: int = 0) -> None:
        self.sched = sched
        for pq in self.pqs.values():
            pq.init(mem)
        mem.alloc(OUTSTANDING, 1, fill=initial_outstanding)

    def validate_priority(self, priority: int) -> int:
        return self.policy.validate(priority)

    def validate_deadline(self, deadline: Optional[int]) -> Optional[int]:
        fmt = next(iter(self.pqs.values())).fmt
        if deadline is not None and not 0 <= deadline < fmt.key_inf:
            raise ValueError(
                f"deadline {deadline} outside the node key range "
                f"[0, {fmt.key_inf})")
        return deadline

    def register(self, payload: Any, priority: int = 1, cost: int = 0,
                 deadline: Optional[int] = None) -> TaskRecord:
        self.validate_deadline(deadline)
        now = self.sched.step_count if self.sched is not None else 0
        key = self.policy.key(priority, deadline, now)  # validates the class
        tid = len(self.tasks)
        fmt = next(iter(self.pqs.values())).fmt
        if tid > fmt.idx_mask:
            raise ValueError("task table exceeded the node idx space")
        if not 0 <= key < fmt.key_inf:
            raise ValueError(f"policy key {key} exceeds the node key range "
                             f"[0, {fmt.key_inf})")
        rec = TaskRecord(tid, payload, priority, cost, deadline, key=key)
        self.tasks.append(rec)
        return rec

    def _file(self, shard: int) -> None:
        if self.sched is not None and self.sched.history:
            self.shard_history[shard].append(self.sched.history[-1])

    # -- generator ops -------------------------------------------------------

    def enqueue_task(self, ctx: Ctx, tid: int, rec: TaskRecord,
                     shard: Optional[int] = None):
        home = self.home_shard(tid) if shard is None else shard
        backoff = 1
        while True:
            for k in range(self.shards):
                s = (home + k) % self.shards
                ok = yield from self.pqs[s].insert(ctx, tid, rec.key,
                                                   rec.task_id)
                self._file(s)
                if ok:
                    self._record_install(rec)
                    return s
            self.metrics.enq_retries += 1
            # every shard full: exponential backoff so admission
            # backpressure does not burn steps hammering full heaps
            for _ in range(backoff):
                yield from ctx.step()
            backoff = min(backoff * 2, 64)

    def acquire(self, ctx: Ctx, tid: int):
        """Pop one task, most-urgent-visible shard first: scan order is
        ascending min-key hint (steal-highest-priority-first), home shard
        breaking ties."""
        home = self.home_shard(tid)
        if self.steal and self.shards > 1:
            order = []
            for s, pq in self.pqs.items():
                h = yield from pq.peek_hint(ctx, tid)
                order.append((h, (s - home) % self.shards, s))
            order.sort()
            scan = [s for _, _, s in order]
        else:
            scan = [home]
        for rank, s in enumerate(scan):
            ok, got = yield from self.pqs[s].delete_min(ctx, tid)
            self._file(s)
            if rank > 0:
                self.metrics.steal_scans += 1
            if ok:
                _, idx = got
                self.metrics.dequeues += 1
                self.metrics.per_shard_deq[(0, s)] = (
                    self.metrics.per_shard_deq.get((0, s), 0) + 1)
                if s != home:
                    self.metrics.steals += 1
                rec = self.tasks[idx]
                self._record_acquire(rec)
                return rec
        self.metrics.empty_scans += 1
        return None


# ---------------------------------------------------------------------------
# Host-thread twin (serving admission)
# ---------------------------------------------------------------------------


class HostTaskPool:
    """The same sharded/laned/stealing fabric for real host threads, built
    from ``HostRing``s (DESIGN.md § 4.5).  API mirrors ``HostRing`` so it
    drops into the serving engine: ``enqueue(item, timeout=, priority=)``,
    ``dequeue(timeout=, affinity=)``, ``empty()``.

    ``dequeue`` scans lane 0 across every shard before lane 1 (strict
    priority), starting from the caller's affinity shard and stealing in
    ring order."""

    def __init__(self, capacity: int, *, shards: int = 2, lanes: int = 2) -> None:
        self.shards = shards
        self.lanes = lanes
        per = max(1, -(-capacity // shards))
        self.rings = {(lane, s): HostRing(per)
                      for lane in range(lanes) for s in range(shards)}
        self.capacity = per * shards
        self.metrics = {"enqueues": 0, "dequeues": 0, "steals": 0,
                        "rejects": 0}
        self._rr = itertools.count()

    def enqueue(self, item, timeout: Optional[float] = None,
                priority: int = 1) -> bool:
        lane = min(max(priority, 0), self.lanes - 1)
        home = next(self._rr) % self.shards
        for k in range(self.shards):
            s = (home + k) % self.shards
            # only the last candidate shard gets the blocking timeout;
            # earlier ones are polled so overflow can migrate
            t = timeout if k == self.shards - 1 else 0.0
            if self.rings[(lane, s)].enqueue(item, timeout=t):
                self.metrics["enqueues"] += 1
                return True
        self.metrics["rejects"] += 1
        return False

    def _scan(self, home: int):
        for lane in range(self.lanes):
            for k in range(self.shards):
                s = (home + k) % self.shards
                item = self.rings[(lane, s)].dequeue(timeout=0.0)
                if item is not None:
                    self.metrics["dequeues"] += 1
                    self.metrics["steals"] += int(k > 0)
                    return item
        return None

    def dequeue(self, timeout: Optional[float] = None, affinity: int = 0):
        """Non-blocking priority scan; with a timeout, keep re-scanning all
        lanes/shards until the deadline so a late urgent arrival on any ring
        is seen (strict lane order is preserved on every scan)."""
        import time as _time
        home = affinity % self.shards
        item = self._scan(home)
        if item is not None or not timeout:
            return item
        deadline = _time.time() + timeout
        while _time.time() < deadline:
            _time.sleep(min(0.002, timeout))
            item = self._scan(home)
            if item is not None:
                return item
        return None

    def empty(self) -> bool:
        return all(r.empty() for r in self.rings.values())

    def close(self) -> None:
        for r in self.rings.values():
            r.close()
