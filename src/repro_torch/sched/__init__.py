"""repro_torch.sched — G-PQ (copies of ``repro.sched``, plain Python on
the host): the wave-batched priority queue under the interleaving
scheduler, its k-relaxed multi-ring variant with the relaxation bound,
the priority-semantics history checker (and the mesh trace's history),
the scheduling policies (strict / weighted / EDF) of the runtime's
``PriorityFabric``, and the host-thread pool of the serving engine's EDF
admission.  The port imports nothing of the JAX package."""

from .gpq import DELMIN, GPQ, INS, NODE, NodeFormat
from .hostpq import HostPriorityPool
from .plinearizability import (check_p_linearizable,
                               check_p_linearizable_search,
                               mesh_trace_history)
from .policy import (EDFPolicy, POLICIES, PriorityPolicy, StrictPolicy,
                     WeightedPolicy, make_policy)
from .relaxed import RelaxedGPQ, mesh_relaxation_bound

__all__ = [
    "DELMIN", "EDFPolicy", "GPQ", "HostPriorityPool", "INS", "NODE",
    "NodeFormat", "POLICIES", "PriorityPolicy", "RelaxedGPQ", "StrictPolicy",
    "WeightedPolicy", "check_p_linearizable", "check_p_linearizable_search",
    "make_policy", "mesh_relaxation_bound", "mesh_trace_history",
]
