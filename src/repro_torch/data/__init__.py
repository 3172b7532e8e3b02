"""Host data structures of the port: the bounded host ring (the serving
engine's free pages, the training pipeline's batches), the synthetic
batches and the queue-fed pipeline."""

from .pipeline import DataConfig, DataPipeline, HostRing, synth_batch

__all__ = ["DataConfig", "DataPipeline", "HostRing", "synth_batch"]
