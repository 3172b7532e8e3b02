"""repro_torch.distributed — the mesh of the PyTorch port on one card.

The reference (``repro/distributed``) runs one shard per device under
``shard_map`` and exchanges a round's requests with one psum.  On one
card the port runs the shard axis as the leading dimension of its
tensors: ``make_mesh`` names the axes and their sizes, and the
collectives act on stacked ``(S, ...)`` rows (``collectives``)."""

from .collectives import Mesh, make_mesh, mesh_round_gather, mesh_ticket_base

__all__ = ["Mesh", "make_mesh", "mesh_round_gather", "mesh_ticket_base"]
