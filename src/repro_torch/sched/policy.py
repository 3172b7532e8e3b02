"""Priority policies — how a task's class/deadline becomes a G-PQ key
(DESIGN.md § 5.4).  A copy of ``repro/sched/policy.py``, which the port
does not import.

A policy maps ``(priority class, optional absolute deadline, now, …)`` to
the integer min-key the fabric's heaps order by (smaller = served first).
Three policies cover the strict-lanes replacement:

* **strict** — ``key = class·STRIDE + arrival-seq``: every class-0 task
  outranks every class-1 task, FIFO within a class.  Exactly the old
  two-lane semantics, including its starvation: sustained class-0 arrivals
  postpone class-1 forever.
* **weighted** — weighted fair queuing by virtual finish time:
  ``key = n_c · (SCALE / w_c)`` for the class's n-th task, so classes share
  throughput ∝ weights.  Starvation-free: every class's keys advance, so
  any pending task is eventually minimal.
* **edf** — earliest deadline first: ``key = deadline`` (absolute, or
  ``now + slack[class]``).  Urgency *ages*: a waiting task's deadline
  stays put while new arrivals take later ones, so class-1 tasks drift
  toward the front instead of re-queuing at fixed rank.  Starvation-free
  with finite slacks.

Policies validate the class range (``0 ≤ priority < classes``) and raise
``ValueError`` otherwise — the fabric does not clamp.
"""

from __future__ import annotations

from typing import Optional, Sequence


class PriorityPolicy:
    """Base: subclasses implement ``key``; ``classes`` bounds the valid
    priority range."""

    name = "abstract"

    def __init__(self, classes: int = 2) -> None:
        self.classes = classes

    def validate(self, priority: int) -> int:
        if not 0 <= priority < self.classes:
            raise ValueError(
                f"priority {priority} out of range [0, {self.classes}) for "
                f"policy {self.name!r}")
        return priority

    def key(self, priority: int, deadline: Optional[int], now: int) -> int:
        raise NotImplementedError


class StrictPolicy(PriorityPolicy):
    """Class-major, FIFO within class — the old strict lanes as a key.

    The default stride (2^25) exceeds the fabric's 24-bit task-id space,
    so the within-class sequence cannot saturate before the task table
    itself overflows; custom strides assert the same headroom because a
    saturated sequence would silently degrade FIFO-within-class to
    arbitrary heap order."""

    name = "strict"

    def __init__(self, classes: int = 2, stride: int = 1 << 25) -> None:
        super().__init__(classes)
        self.stride = stride
        self._seq = 0

    def key(self, priority: int, deadline: Optional[int], now: int) -> int:
        self.validate(priority)
        self._seq += 1
        assert self._seq < self.stride, \
            "StrictPolicy sequence saturated: FIFO-within-class would break"
        return priority * self.stride + self._seq


class WeightedPolicy(PriorityPolicy):
    """Weighted fair queuing (start-time fair queuing flavour): each class
    carries a virtual-finish clock advanced by ``scale / weight`` per task,
    clamped below by real time — so an idle class accrues no banked credit,
    a backlogged class shares throughput ∝ its weight, and every class's
    keys advance (starvation-free)."""

    name = "weighted"

    def __init__(self, weights: Sequence[int] = (4, 1),
                 scale: int = 64) -> None:
        super().__init__(len(weights))
        assert all(w > 0 for w in weights)
        self.weights = tuple(weights)
        self.scale = scale
        self._finish = [0] * len(weights)

    def key(self, priority: int, deadline: Optional[int], now: int) -> int:
        self.validate(priority)
        start = max(self._finish[priority], now)
        step = -(-self.scale // self.weights[priority])
        self._finish[priority] = start + step
        return self._finish[priority]


class EDFPolicy(PriorityPolicy):
    """Earliest deadline first; per-class default slacks when a task
    carries no absolute deadline."""

    name = "edf"

    def __init__(self, slack: Sequence[int] = (0, 512)) -> None:
        super().__init__(len(slack))
        self.slack = tuple(slack)

    def key(self, priority: int, deadline: Optional[int], now: int) -> int:
        self.validate(priority)
        if deadline is not None:
            return deadline
        return now + self.slack[priority]


POLICIES = {"strict": StrictPolicy, "weighted": WeightedPolicy,
            "edf": EDFPolicy}


def make_policy(spec) -> PriorityPolicy:
    """'strict' | 'weighted' | 'edf' | an already-built policy object."""
    if isinstance(spec, PriorityPolicy):
        return spec
    if spec in POLICIES:
        return POLICIES[spec]()
    raise ValueError(f"unknown policy {spec!r}; pick from {list(POLICIES)}")
