"""Open-loop traffic generation for the serving harness — a copy of
``repro/serving/traffic.py`` (numpy only), so the port draws the same
traces from the same seeds.

Open-loop means arrival times are drawn ahead of time and never react to
service state — the engine falls behind under overload instead of the
generator politely slowing down, which is what makes goodput-vs-offered-
load curves meaningful (a closed loop self-throttles and hides the knee).

The process is bursty power-law on top of a Poisson floor: a baseline
``rate``-requests/tick Poisson stream, plus burst events every
``burst_period`` ticks in expectation whose sizes follow a discrete
Pareto tail ``P(size ≥ s) ∝ s^{-(alpha-1)}`` — the heavy-tailed
fine-grained arrival pattern Wang et al.'s dynamic load-balancing
argument targets (PAPERS.md).  Everything is driven by one
``numpy.random.default_rng(seed)``: the same config always replays the
same trace, so host-pool and device-admission runs see identical
arrivals and their admitted sets are comparable request-for-request.

Tenants round-robin over burst events (a burst is one tenant's flash
crowd, not uniformly smeared), and each arrival flips urgent with
``urgent_frac``.  ``slo_ticks`` defines goodput: a request counts iff it
completes within ``slo_ticks`` engine ticks of submission.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

__all__ = ["Arrival", "TrafficConfig", "generate_trace", "offered_load"]


@dataclasses.dataclass(frozen=True)
class Arrival:
    tick: int              # engine tick at which the request is submitted
    tenant: int
    priority: int          # 0 = urgent admission class
    prompt_len: int
    max_new_tokens: int


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    ticks: int = 200               # arrival horizon (engine ticks)
    rate: float = 0.5              # baseline offered load (requests/tick)
    burst_alpha: float = 2.2       # Pareto tail exponent (>1; lower=heavier)
    burst_period: int = 32         # mean ticks between burst events
    burst_max: int = 8             # burst-size clamp (bounded tails on CPU)
    tenants: int = 1
    urgent_frac: float = 0.25
    prompt_len: Tuple[int, int] = (4, 12)       # inclusive range
    max_new_tokens: Tuple[int, int] = (2, 8)    # inclusive range
    slo_ticks: int = 120           # completion deadline for goodput
    seed: int = 0


def _pareto_size(rng: np.random.Generator, alpha: float, clamp: int) -> int:
    """Discrete Pareto burst size ≥ 1: inverse-CDF of the continuous
    Pareto(alpha-1) tail, floored and clamped."""
    u = rng.random()
    s = int(np.floor((1.0 - u) ** (-1.0 / (alpha - 1.0))))
    return max(1, min(s, clamp))


def generate_trace(tc: TrafficConfig) -> List[Arrival]:
    """The full arrival list, sorted by tick (stable: arrivals within a
    tick keep generation order)."""
    rng = np.random.default_rng(tc.seed)
    out: List[Arrival] = []
    burst_tenant = 0

    def emit(tick: int, tenant: int) -> None:
        pri = 0 if rng.random() < tc.urgent_frac else 1
        plen = int(rng.integers(tc.prompt_len[0], tc.prompt_len[1] + 1))
        newt = int(rng.integers(tc.max_new_tokens[0],
                                tc.max_new_tokens[1] + 1))
        out.append(Arrival(tick, tenant, pri, plen, newt))

    for t in range(tc.ticks):
        for _ in range(int(rng.poisson(tc.rate))):
            emit(t, int(rng.integers(tc.tenants)))
        if rng.random() < 1.0 / tc.burst_period:
            # one tenant's flash crowd; tenants take turns so every lane
            # sees bursts even on short horizons
            for _ in range(_pareto_size(rng, tc.burst_alpha, tc.burst_max)):
                emit(t, burst_tenant)
            burst_tenant = (burst_tenant + 1) % tc.tenants
    out.sort(key=lambda a: a.tick)
    return out


def offered_load(trace: List[Arrival], tc: TrafficConfig) -> float:
    """Realized offered load (requests/tick) of a generated trace."""
    return len(trace) / max(1, tc.ticks)
