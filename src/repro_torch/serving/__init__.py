"""The continuous-batching serving engine of the port (host-pool or
device-mesh EDF admission), the device admission engine itself, and the
open-loop traffic generator."""

from .admission import DEADLINE_KEY_CAP, ServingMeshEngine
from .engine import EngineConfig, Request, ServingEngine
from .traffic import Arrival, TrafficConfig, generate_trace, offered_load

__all__ = ["Arrival", "DEADLINE_KEY_CAP", "EngineConfig", "Request",
           "ServingEngine", "ServingMeshEngine", "TrafficConfig",
           "generate_trace", "offered_load"]
