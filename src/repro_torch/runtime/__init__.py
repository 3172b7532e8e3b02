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
``telemetry=`` / ``spans=``.  The host task-pool faces of
``repro.runtime`` come with a later slice."""

from .enginecore import (ENGINE_REGISTRY, EngineCore, EngineEntry,
                         PlaneGroup, PlaneRegistry, register_engine)
from .fusedrounds import (IDX_BOT, HeapEngine, HeapState, PriorityStepFn,
                          RingEngine, RingState, StepFn, heap_init, ring_init)
from .meshrounds import (MeshHeapEngine, MeshRingEngine, MeshRoundRunner,
                         PriorityMeshRoundRunner, ShardedMeshRingEngine)
from .rounds import PriorityRoundRunner, RoundRunner

__all__ = [
    "ENGINE_REGISTRY", "EngineCore", "EngineEntry", "HeapEngine",
    "HeapState", "IDX_BOT", "MeshHeapEngine", "MeshRingEngine",
    "MeshRoundRunner", "PriorityMeshRoundRunner",
    "PlaneGroup", "PlaneRegistry",
    "PriorityRoundRunner", "PriorityStepFn", "RingEngine", "RingState",
    "RoundRunner", "ShardedMeshRingEngine", "StepFn", "heap_init",
    "register_engine", "ring_init",
]
