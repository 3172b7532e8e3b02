"""The continuous-batching serving engine of the port (host-pool EDF
admission)."""

from .engine import DEADLINE_KEY_CAP, EngineConfig, Request, ServingEngine

__all__ = ["DEADLINE_KEY_CAP", "EngineConfig", "Request", "ServingEngine"]
