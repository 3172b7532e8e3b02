"""Persistent-worker task executor on the interleaving simulator
(DESIGN.md § 4.2).

A copy of ``repro/runtime/executor.py`` (the port imports nothing of the JAX
package); only the imports and the docstrings differ.

Workers are generator threads on ``repro_torch.core.sim.Scheduler`` that loop
dequeue → execute → spawn-children until quiescence, exactly the paper's
persistent-kernel consumer pattern.  Dynamic task spawning goes through the
fabric's OUTSTANDING counter with the increment-children-before-retiring-
the-parent discipline, so a worker that loads OUTSTANDING == 0 holds a sound
termination certificate (Dijkstra–Scholten at counter granularity): every
task is counted from before it becomes visible until after its children are.

Arrival schedules (``at_step``) model open-loop workloads: a source thread
releases tasks into the fabric when the simulated clock reaches each
arrival, spraying them round-robin across shards; the OUTSTANDING counter is
pre-charged with the whole schedule so workers cannot conclude quiescence
between bursts.

Executor metrics extend the § V-C family: ``idle_steps`` (per-thread steps
burned in acquire passes that found no task, the WAIT/op analogue at runtime
scope), ``steal_rate``, and per-shard ``load_imbalance``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..core import AtomicMemory
from ..core.sim import Scheduler
from ..obs.metrics import MetricsRegistry, metric_key
from .taskpool import TaskFabric, TaskRecord, TaskSpec

# A handler executes a task on the host and returns the children to spawn.
Handler = Callable[[TaskRecord], Optional[Iterable[TaskSpec]]]


@dataclass
class ExecutorConfig:
    workers: int = 32
    sources: int = 1                # parallel arrival-release threads
    wave_size: int = 8
    policy: str = "gang"            # random | gang | rr
    seed: int = 0
    max_steps: int = 5_000_000
    backoff_cap: int = 8            # max idle backoff (steps) after an empty scan


@dataclass
class Arrival:
    at_step: int
    spec: TaskSpec
    affinity: Optional[int] = None   # target shard; None = round-robin spray


class TaskRuntime:
    """Owns the memory, the scheduler, the fabric, and the worker fleet for
    one task-parallel run.  A host simulation in plain Python: it touches
    no device and takes no ``device``; a handler may (``render_runtime``
    traces its batches on the card)."""

    def __init__(self, fabric: TaskFabric, handler: Handler,
                 cfg: Optional[ExecutorConfig] = None,
                 registry: Optional[MetricsRegistry] = None) -> None:
        self.fabric = fabric
        self.handler = handler
        self.cfg = cfg or ExecutorConfig()
        self.registry = registry
        self.arrivals: List[Arrival] = []
        self.executed: List[Tuple[int, int]] = []   # (task_id, worker tid)
        self.idle_steps = 0
        self.exec_steps = 0
        self.per_worker_executed: Dict[int, int] = {}
        self._sched: Optional[Scheduler] = None

    # -- workload construction ----------------------------------------------

    def add_task(self, payload: Any, *, priority: int = 1, cost: int = 0,
                 at_step: int = 0, affinity: Optional[int] = None,
                 deadline: Optional[int] = None) -> None:
        # Fail fast at workload-construction time: register() would raise
        # the same ValueError, but only mid-simulation inside the source
        # thread, after arbitrary simulated work.
        self.fabric.validate_priority(priority)
        self.fabric.validate_deadline(deadline)
        self.arrivals.append(
            Arrival(at_step, TaskSpec(payload, priority, cost, deadline),
                    affinity))

    # -- thread bodies -------------------------------------------------------

    def _source_body(self, ctx, tid, lane: int = 0):
        """Release scheduled arrivals at their step; OUTSTANDING was
        pre-charged with the full schedule, so no increment here.  With
        ``cfg.sources > 1`` the schedule is striped across that many
        source threads, so one arrival stalled on a full fabric (admission
        backpressure) does not head-of-line-block the rest of the open
        loop."""
        pending = sorted(self.arrivals,
                         key=lambda a: a.at_step)[lane::self.cfg.sources]
        for a in pending:
            while self._sched.step_count < a.at_step:
                yield from ctx.step()
            rec = self.fabric.register(a.spec.payload, a.spec.priority,
                                       a.spec.cost, a.spec.deadline)
            shard = (a.affinity % self.fabric.shards
                     if a.affinity is not None else self.fabric.spray_shard())
            yield from self.fabric.enqueue_task(ctx, tid, rec, shard=shard)

    def _worker_body(self, ctx, tid):
        backoff = 1
        while True:
            t0 = self._sched.threads[tid].steps
            rec = yield from self.fabric.acquire(ctx, tid)
            if rec is None:
                self.idle_steps += self._sched.threads[tid].steps - t0
                out = yield from self.fabric.outstanding(ctx, tid)
                if out == 0:
                    return                      # quiescent: no task anywhere
                for _ in range(backoff):
                    yield from ctx.step()
                self.idle_steps += backoff
                backoff = min(backoff * 2, self.cfg.backoff_cap)
                continue
            backoff = 1
            for _ in range(rec.cost):            # simulated compute
                yield from ctx.step()
            self.exec_steps += rec.cost
            children = self.handler(rec) or ()
            for spec in children:
                yield from self.fabric.spawn(ctx, tid, spec)
            yield from self.fabric.complete(ctx, tid)
            self.executed.append((rec.task_id, tid))
            self.per_worker_executed[tid] = self.per_worker_executed.get(tid, 0) + 1

    # -- run ------------------------------------------------------------------

    def run(self) -> Dict[str, float]:
        cfg = self.cfg
        mem = AtomicMemory()
        sched = Scheduler(mem, wave_size=cfg.wave_size, policy=cfg.policy,
                          seed=cfg.seed)
        self._sched = sched
        self.fabric.init(mem, sched, initial_outstanding=len(self.arrivals))
        if self.arrivals:
            for lane in range(min(cfg.sources, len(self.arrivals))):
                sched.spawn(self._source_body, lane)
        for _ in range(cfg.workers):
            sched.spawn(self._worker_body)
        completed = sched.run(cfg.max_steps)
        m = sched.metrics()
        execd = [n for _, n in sorted(self.per_worker_executed.items())]
        mean_exec = (sum(execd) / len(execd)) if execd else 0.0
        m.update({
            "completed": float(completed),
            "tasks_executed": len(self.executed),
            "idle_steps": self.idle_steps,
            "exec_steps": self.exec_steps,
            "idle_steps_per_task": self.idle_steps / max(len(self.executed), 1),
            "steals": self.fabric.metrics.steals,
            "steal_rate": self.fabric.steal_rate(),
            "enq_retries": self.fabric.metrics.enq_retries,
            "load_imbalance": self.fabric.metrics.load_imbalance(),
            "worker_imbalance": (max(execd) / mean_exec) if mean_exec else 1.0,
        })
        # Starvation metrics (per-class queue waits) when the fabric
        # tracks them — both TaskFabric and PriorityFabric do.
        wait_stats = getattr(self.fabric, "wait_stats", None)
        if wait_stats is not None:
            m.update(wait_stats())
        if self.registry is not None:
            self._publish(m)
        return m

    def _publish(self, m: Dict[str, float]) -> None:
        """Mirror the run's metrics into the shared registry under the
        stable ``runtime.*`` / ``fabric.*`` key scheme (DESIGN.md § 7.2):
        the free-form dict stays the return value, the registry is what
        exporters and benchmarks read."""
        reg = self.registry
        for name in ("tasks_executed", "idle_steps", "exec_steps",
                     "completed"):
            reg.counter(metric_key("runtime", name), m[name])
        for name in ("idle_steps_per_task", "steal_rate", "load_imbalance",
                     "worker_imbalance"):
            reg.gauge(metric_key("runtime", name), m[name])
        for tid, n in sorted(self.per_worker_executed.items()):
            reg.counter(metric_key("runtime", "executed", worker=tid), n)
        self.fabric.metrics.publish(reg)
        for prio, waits in sorted(self.fabric.waits.items()):
            key = metric_key("fabric", "wait", cls=prio)
            for w in waits:
                reg.observe(key, w)

    @property
    def scheduler(self) -> Scheduler:
        assert self._sched is not None, "run() first"
        return self._sched
