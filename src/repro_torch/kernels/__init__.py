"""Hand-written Hopper kernels of the round engine, each beside its plain
PyTorch version.

A wrapper sends CPU tensors to the plain version and launches its CUDA
kernel (``csrc/``, built on first use by ``_build``) for CUDA tensors;
there is no fallback between the two.  ``ref`` holds the sequential
oracles.  Ported so far: ``wavefaa``, ``ring_enqueue``/``ring_dequeue``
and ``wave_compact``.
"""

from . import ref
from ._build import LAUNCHES, reset_launches
from .compact import compact_planes, compact_width, wave_compact
from .ring_slots import (cycle_lt, deq_planes, enq_planes, ring_dequeue,
                         ring_dequeue_plain, ring_enqueue, ring_enqueue_plain,
                         ticket_cycle)
from .wavefaa import LANES, wavefaa, wavefaa_plain

__all__ = ["LANES", "LAUNCHES", "compact_planes", "compact_width",
           "cycle_lt", "deq_planes", "enq_planes", "ref", "reset_launches",
           "ring_dequeue", "ring_dequeue_plain", "ring_enqueue",
           "ring_enqueue_plain", "ticket_cycle", "wave_compact", "wavefaa",
           "wavefaa_plain"]
