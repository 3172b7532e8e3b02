"""Fault tolerance: checkpoint/restart, straggler detection, elastic
re-mesh plans — the PyTorch twin of
``repro/distributed/fault_tolerance.py``, unchanged in behaviour.

* ``RestartManager`` wraps the train loop: periodic async checkpoints
  (atomic commit via ``checkpoint.manager``), restart from the latest
  committed step on an exception, a bounded retry budget, one injected
  fault for tests.
* ``StragglerDetector`` flags a pod whose step time exceeds ``threshold``
  x the median of the trailing window, with a plan that shifts batch
  share away from it.
* ``elastic_mesh_plan`` picks the largest (data, model) grid for a
  surviving device count.  On one card the plan is arithmetic only: the
  port restores onto the card it runs on.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from ..checkpoint.manager import CheckpointManager


@dataclasses.dataclass
class StragglerReport:
    step: int
    pod: int
    step_time: float
    median_time: float
    ratio: float


class StragglerDetector:
    """Deadline-based slow-pod detection over per-pod heartbeats."""

    def __init__(self, n_pods: int, *, window: int = 16,
                 threshold: float = 1.5) -> None:
        self.n_pods = n_pods
        self.window = window
        self.threshold = threshold
        self._hist: List[Deque[float]] = [deque(maxlen=window)
                                          for _ in range(n_pods)]
        self.reports: List[StragglerReport] = []

    def heartbeat(self, step: int, pod: int,
                  step_time: float) -> Optional[StragglerReport]:
        self._hist[pod].append(step_time)
        times = sorted(t for h in self._hist for t in h)
        if len(times) < self.n_pods * 2:
            return None
        med = times[len(times) // 2]
        if med > 0 and step_time > self.threshold * med:
            rep = StragglerReport(step, pod, step_time, med,
                                  step_time / med)
            self.reports.append(rep)
            return rep
        return None

    def mitigation_plan(self, rep: StragglerReport) -> Dict:
        """Shift batch share away from the slow pod proportionally to its
        slowdown (bounded at 50%)."""
        share = max(0.5, 1.0 / rep.ratio)
        shares = [1.0] * self.n_pods
        shares[rep.pod] = share
        total = sum(shares)
        return {"kind": "rebalance_batch",
                "pod_shares": [s / total for s in shares],
                "reason": dataclasses.asdict(rep)}


def elastic_mesh_plan(n_devices: int, *, tp: int = 16) -> Dict:
    """Largest (data, model) grid for the surviving device count; the TP
    degree is kept unless fewer than tp devices survive."""
    tp = min(tp, n_devices)
    while n_devices % tp:
        tp //= 2
    return {"data": n_devices // tp, "model": tp}


class RestartManager:
    """Run a step function with periodic checkpoints and crash-restart.

    ``step_fn(state, step_idx) -> state`` may raise; on failure the manager
    restores the latest committed checkpoint and resumes, up to
    ``max_restarts``.  ``inject_fault_at`` raises once at that step, so a
    test drives the whole restart path deterministically.
    """

    def __init__(self, ckpt: CheckpointManager, *, save_every: int = 10,
                 max_restarts: int = 3) -> None:
        self.ckpt = ckpt
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, state, step_fn: Callable, *, num_steps: int,
            start_step: int = 0,
            inject_fault_at: Optional[int] = None):
        step = start_step
        faults_left = 1 if inject_fault_at is not None else 0
        while step < num_steps:
            try:
                if faults_left and step == inject_fault_at:
                    faults_left = 0
                    raise RuntimeError("injected node failure")
                state = step_fn(state, step)
                step += 1
                if step % self.save_every == 0 or step == num_steps:
                    self.ckpt.save(step, state)
            except Exception:  # noqa: BLE001 — restart path
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    step = start_step
                    continue
                step, state = self.ckpt.restore(state, latest)
        self.ckpt.wait()
        return step, state
