"""Hand-written Hopper kernels of the round engine, each beside its plain
PyTorch version.

A wrapper sends CPU tensors to the plain version and launches its CUDA
kernel (``csrc/``, built on first use by ``_build``) for CUDA tensors;
there is no fallback between the two.  ``ref`` holds the sequential
oracles.  Ported: ``wavefaa``, ``ring_enqueue``/``ring_dequeue``,
``wave_compact``, ``heap_apply``, ``frontier_expand``,
``expert_tickets`` (MoE dispatch) and ``flash_attention`` — every Pallas
kernel of the reference.
"""

from . import ref
from ._build import LAUNCHES, reset_launches
from .compact import compact_planes, compact_width, wave_compact
from .flash_attn import flash_attention, flash_attention_plain
from .frontier import (frontier_expand, frontier_expand_plain,
                       frontier_level, frontier_scratch)
from .heap_batch import (KEY_INF, OP_DELMIN, OP_INSERT, OP_NOP, heap_apply,
                         heap_apply_plain, heap_insert_masked, heap_planes,
                         heap_pop_count)
from .moe_route import (expert_tickets, expert_tickets_plain, moe_route,
                        top_k_stable)
from .ring_slots import (cycle_lt, deq_planes, enq_planes, ring_dequeue,
                         ring_dequeue_plain, ring_enqueue, ring_enqueue_plain,
                         ticket_cycle)
from .wavefaa import LANES, wavefaa, wavefaa_plain

__all__ = ["KEY_INF", "LANES", "LAUNCHES", "OP_DELMIN", "OP_INSERT", "OP_NOP",
           "compact_planes", "compact_width", "cycle_lt", "deq_planes",
           "enq_planes", "expert_tickets", "expert_tickets_plain",
           "flash_attention", "flash_attention_plain", "frontier_expand",
           "frontier_expand_plain", "frontier_level", "frontier_scratch",
           "heap_apply", "heap_apply_plain", "heap_insert_masked",
           "heap_planes", "heap_pop_count", "moe_route", "ref",
           "reset_launches", "ring_dequeue", "ring_dequeue_plain",
           "ring_enqueue", "ring_enqueue_plain", "ticket_cycle",
           "top_k_stable", "wave_compact", "wavefaa", "wavefaa_plain"]
