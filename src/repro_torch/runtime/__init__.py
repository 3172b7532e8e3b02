"""repro_torch.runtime — the deterministic device round engines of the
PyTorch port: ``RoundRunner`` over ``fusedrounds.RingEngine`` (FIFO) and
``PriorityRoundRunner`` over ``fusedrounds.HeapEngine`` (priority), each
fused by default with a legacy per-round loop under ``fused=False``, and
both configurations of ``enginecore.EngineCore``, and the FIFO mesh
(``meshrounds``: ``MeshRoundRunner`` over ``MeshRingEngine``, the
replicated ring, and ``ShardedMeshRingEngine``, one ring a shard) with
the shard axis as a tensor dimension on one card, and the priority
mesh (``PriorityMeshRoundRunner`` over ``MeshHeapEngine``: one heap a
shard, relaxed, or one heap popped in global order, strict).  The fused
engines carry ``repro_torch.obs`` trace and span planes when given
``telemetry=`` / ``spans=``.  ``rounds.mesh_task_round`` is the
functional mesh-scope task round over ``core.distqueue``.

The host face (copies of the reference's ``taskpool`` and ``executor``,
plain Python on no device): ``TaskFabric`` (sharded MPMC rings over the
simulated queues, wave-affinity placement, work stealing, priority
lanes), ``PriorityFabric`` (policy-keyed G-PQ shards) and
``HostTaskPool``, driven by ``TaskRuntime``'s persistent workers under
the adversarial interleaving scheduler."""

from .enginecore import (ENGINE_REGISTRY, EngineCore, EngineEntry,
                         PlaneGroup, PlaneRegistry, register_engine)
from .executor import Arrival, ExecutorConfig, Handler, TaskRuntime
from .fusedrounds import (IDX_BOT, HeapEngine, HeapState, PriorityStepFn,
                          RingEngine, RingState, StepFn, heap_init, ring_init)
from .meshrounds import (MeshHeapEngine, MeshRingEngine, MeshRoundRunner,
                         PriorityMeshRoundRunner, ShardedMeshRingEngine)
from .rounds import PriorityRoundRunner, RoundRunner, mesh_task_round
from .taskpool import (FabricMetrics, HostTaskPool, PriorityFabric,
                       TaskFabric, TaskRecord, TaskSpec)

__all__ = [
    "Arrival", "ENGINE_REGISTRY", "EngineCore", "EngineEntry",
    "ExecutorConfig", "FabricMetrics", "Handler", "HeapEngine",
    "HeapState", "HostTaskPool", "IDX_BOT", "MeshHeapEngine",
    "MeshRingEngine", "MeshRoundRunner", "PriorityFabric",
    "PriorityMeshRoundRunner", "PlaneGroup", "PlaneRegistry",
    "PriorityRoundRunner", "PriorityStepFn", "RingEngine", "RingState",
    "RoundRunner", "ShardedMeshRingEngine", "StepFn", "TaskFabric",
    "TaskRecord", "TaskRuntime", "TaskSpec", "heap_init",
    "mesh_task_round", "register_engine", "ring_init",
]
