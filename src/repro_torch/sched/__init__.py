"""Host scheduling pools and priority policies — copies of
``repro.sched.hostpq`` and ``repro.sched.policy`` (the port imports
nothing of the JAX package)."""

from .hostpq import HostPriorityPool
from .policy import (EDFPolicy, POLICIES, PriorityPolicy, StrictPolicy,
                     WeightedPolicy, make_policy)

__all__ = ["EDFPolicy", "HostPriorityPool", "POLICIES", "PriorityPolicy",
           "StrictPolicy", "WeightedPolicy", "make_policy"]
