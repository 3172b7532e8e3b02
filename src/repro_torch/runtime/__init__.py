"""repro_torch.runtime — the deterministic device round engine of the
PyTorch port: ``RoundRunner`` (fused by default, legacy per-round loop
with ``fused=False``) over ``fusedrounds.RingEngine``, a configuration of
``enginecore.EngineCore``.  The priority, mesh and host task-pool faces
of ``repro.runtime`` come with later slices."""

from .enginecore import (ENGINE_REGISTRY, EngineCore, EngineEntry,
                         PlaneGroup, PlaneRegistry, register_engine)
from .fusedrounds import IDX_BOT, RingEngine, RingState, StepFn, ring_init
from .rounds import RoundRunner

__all__ = [
    "ENGINE_REGISTRY", "EngineCore", "EngineEntry", "IDX_BOT", "PlaneGroup",
    "PlaneRegistry", "RingEngine", "RingState", "RoundRunner", "StepFn",
    "register_engine", "ring_init",
]
