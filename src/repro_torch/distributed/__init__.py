"""repro_torch.distributed — the mesh of the PyTorch port.

The reference (``repro/distributed``) runs one shard per device under
``shard_map`` and exchanges a round's requests with one psum.  The port
runs a mesh in one of two forms (``collectives``): on one card the shard
axis is the leading dimension of its tensors and the collectives act on
stacked ``(S, ...)`` rows; with ``make_mesh(..., group=)`` a shard is a
rank of a ``torch.distributed`` process group and the psum is one
``all_reduce``.  The ranks are started by the caller (``torchrun`` or
``torch.multiprocessing.spawn``); importing this package starts no
process group.
``compression`` (error-feedback int8 gradient compression) and
``fault_tolerance`` (restart, straggler detection, elastic plans) serve
the training path."""

from .collectives import (COLLECTIVES, Mesh, allreduce_compressed,
                          allreduce_mean, bucketed_psum, gather_rows,
                          make_mesh, mesh_round_gather, mesh_ticket_base,
                          tree_allreduce_compressed)
from .compression import (compress_with_feedback, compression_ratio,
                          dequantize, init_feedback, quantize,
                          tree_compress_with_feedback)
from .fault_tolerance import (RestartManager, StragglerDetector,
                              StragglerReport, elastic_mesh_plan)

__all__ = ["COLLECTIVES", "Mesh", "RestartManager",
           "StragglerDetector", "StragglerReport",
           "allreduce_compressed", "allreduce_mean", "bucketed_psum",
           "compress_with_feedback", "compression_ratio", "dequantize",
           "elastic_mesh_plan", "gather_rows", "init_feedback", "make_mesh",
           "mesh_round_gather", "mesh_ticket_base", "quantize",
           "tree_allreduce_compressed", "tree_compress_with_feedback"]
