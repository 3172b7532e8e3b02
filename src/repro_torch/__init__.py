"""repro_torch — the PyTorch / CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
from it and no JAX.  Each module keeps its twin's path and public names
(``repro_torch.runtime.rounds`` ↔ ``repro.runtime.rounds``).  Every
Pallas kernel on a ported path is a CUDA kernel written by hand for
``sm_90a`` (``kernels/csrc/``), with a plain PyTorch version beside it.
Entry points run on the card by default (``device="cuda"``) and on the
CPU only when the caller passes ``device="cpu"``.

Ported so far: the G-LFQ and G-PQ round engines (``runtime``) with their
trace and span planes (``obs``), their kernels and the BFS frontier
kernel (``kernels``), round-engine, queue-driven and mesh BFS
(``apps.bfs``), the FIFO and the priority mesh (``core.distqueue``,
``distributed``, ``runtime.meshrounds``: the replicated and the sharded
ring, the relaxed and the strict heaps, the shard axis a tensor dimension
on one card or one shard a process of a ``torch.distributed`` group), serving over the model zoo
(``serving``, ``models``, ``configs``: all ten configurations, six
families), and training (``launch.train``, ``optim``, ``checkpoint``).
"""

__version__ = "0.1.0"
