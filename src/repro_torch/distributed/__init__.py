"""repro_torch.distributed — the mesh of the PyTorch port on one card.

The reference (``repro/distributed``) runs one shard per device under
``shard_map`` and exchanges a round's requests with one psum.  On one
card the port runs the shard axis as the leading dimension of its
tensors: ``make_mesh`` names the axes and their sizes, and the
collectives act on stacked ``(S, ...)`` rows (``collectives``).
``compression`` (error-feedback int8 gradient compression) and
``fault_tolerance`` (restart, straggler detection, elastic plans) serve
the training path."""

from .collectives import Mesh, make_mesh, mesh_round_gather, mesh_ticket_base
from .compression import (compress_with_feedback, compression_ratio,
                          dequantize, init_feedback, quantize,
                          tree_compress_with_feedback)
from .fault_tolerance import (RestartManager, StragglerDetector,
                              StragglerReport, elastic_mesh_plan)

__all__ = ["Mesh", "RestartManager", "StragglerDetector", "StragglerReport",
           "compress_with_feedback", "compression_ratio", "dequantize",
           "elastic_mesh_plan", "init_feedback", "make_mesh",
           "mesh_round_gather", "mesh_ticket_base", "quantize",
           "tree_compress_with_feedback"]
