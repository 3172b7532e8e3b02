"""Hand-written Hopper kernels of the round engine, each beside its plain
PyTorch version.

A wrapper sends CPU tensors to the plain version and launches its CUDA
kernel (``csrc/``, built on first use by ``_build``) for CUDA tensors;
there is no fallback between the two.  ``ref`` holds the sequential
oracles.  Ported: ``wavefaa``, ``ring_enqueue``/``ring_dequeue`` (and a
round's queue side as ``ring_dequeue_wave``/``ring_enqueue_wave`` over an
S-shard lane grid: the mesh's round, and the single ring's at S = 1),
``wave_compact``, ``heap_apply``, ``frontier_expand``,
``expert_tickets`` (MoE dispatch) and ``flash_attention`` — every Pallas
kernel of the reference — and the flash backward (``flash_attention_bwd``,
the counterpart of the reference's XLA backward), with the span layer's instances of the ring
waves (packed birth stamps) and of ``heap_apply`` (a rider plane), the
standalone ring waves' masked instance (an explicit ``active``: the
functional faces ``enq_planes`` / ``deq_planes`` on the card), the
sharded instances of the round's waves (S rings, one a row) and
``heap_apply``'s shard grid (``heap_apply_grid``: S heaps, a pop or an
insert wave in one launch, the priority mesh's waves).
``csrc/loop.cu`` (the round engines' device loop) is driven from
``runtime/enginecore.py``, ``csrc/obs_record.cu`` (a round's trace and
span record) from ``obs/record.py``.
"""

from . import ref
from ._build import LAUNCHES, reset_launches
from .compact import (compact_planes, compact_scratch, compact_width,
                      wave_compact)
from .flash_attn import (flash_attention, flash_attention_bwd,
                         flash_attention_bwd_plain, flash_attention_plain,
                         flash_attention_train)
from .frontier import (frontier_buffer, frontier_expand,
                       frontier_expand_plain, frontier_level,
                       frontier_level_plain, frontier_scratch)
from .heap_batch import (KEY_INF, OP_DELMIN, OP_INSERT, OP_NOP,
                         TOP_ARITY_LOG2, heap_apply,
                         heap_apply_grid, heap_apply_grid_plain,
                         heap_apply_plain, heap_insert_masked, heap_planes,
                         heap_pop_count, heap_resident_max)
from .moe_route import (expert_tickets, expert_tickets_plain, moe_route,
                        top_k_stable)
from .ring_slots import (claim_schedule, cycle_lt, deq_planes, enq_planes,
                         priority_claim_schedule, ring_dequeue,
                         ring_dequeue_plain, ring_dequeue_wave,
                         ring_dequeue_wave_plain, ring_enqueue,
                         ring_enqueue_plain, ring_enqueue_wave,
                         ring_enqueue_wave_plain, ticket_cycle)
from .wavefaa import LANES, wavefaa, wavefaa_plain, wavefaa_scratch

__all__ = ["KEY_INF", "LANES", "LAUNCHES", "OP_DELMIN", "OP_INSERT", "OP_NOP",
           "TOP_ARITY_LOG2",
           "claim_schedule", "compact_planes", "compact_scratch",
           "compact_width", "cycle_lt",
           "deq_planes", "enq_planes", "expert_tickets", "expert_tickets_plain",
           "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_plain",
           "flash_attention_train", "frontier_buffer",
           "frontier_expand", "frontier_expand_plain", "frontier_level",
           "frontier_level_plain", "frontier_scratch", "heap_apply",
           "heap_apply_grid", "heap_apply_grid_plain", "heap_apply_plain",
           "heap_insert_masked", "heap_planes", "heap_pop_count",
           "heap_resident_max", "moe_route",
           "priority_claim_schedule", "ref", "reset_launches",
           "ring_dequeue", "ring_dequeue_plain",
           "ring_dequeue_wave", "ring_dequeue_wave_plain", "ring_enqueue",
           "ring_enqueue_plain", "ring_enqueue_wave",
           "ring_enqueue_wave_plain", "ticket_cycle",
           "top_k_stable", "wave_compact", "wavefaa", "wavefaa_plain",
           "wavefaa_scratch"]
