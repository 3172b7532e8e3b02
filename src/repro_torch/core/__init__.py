"""repro_torch.core — the port's twins of ``repro.core``: the paper's
queues (G-LFQ, G-WFQ, G-WFQ-YMC and the SFQ baseline) as per-thread
state machines over simulated 64-bit atomics, the adversarial
interleaving scheduler with WAVEFAA waves, the packed word layouts, the
history harness and the § IV linearizability checker (plain Python on
the host, copies of the reference's modules), and the mesh-level queues
(``distqueue``): the FIFO ring, replicated and sharded, and the priority
mesh's heap planes, as stacked tensors on one card."""

from .atomics import AtomicMemory
from .base import IndexedQueue, QueueAlgorithm
from .distqueue import (DistHeapState, DistQueueState, DistShardedQueueState,
                        IDX_BOT, claim_schedule, dist_claim_round,
                        dist_dequeue_round, dist_enqueue_round,
                        dist_heap_init, dist_priority_publish_compact_round,
                        dist_priority_publish_round,
                        dist_publish_compact_round, dist_publish_round,
                        dist_queue_init, dist_sharded_claim_round,
                        dist_sharded_publish_round, dist_sharded_queue_init,
                        priority_claim_schedule)
from .glfq import GLFQ
from .gwfq import GWFQ
from .histories import (FifoReport, fifo_conformance, run_balanced,
                        run_producer_consumer)
from .linearizability import check_linearizable, fast_violation_screen
from .packed import (ENTRY, GLOBAL, LOCAL, NOTE, REQ, RES, EntryFormat,
                     GlobalFormat, LocalFormat, MASK64)
from .sfq import SFQ
from .sim import Ctx, DEQ, ENQ, HistoryEvent, Scheduler
from .ymc import YMC

QUEUE_CLASSES = {"glfq": GLFQ, "gwfq": GWFQ, "gwfq-ymc": YMC, "sfq": SFQ}

__all__ = [
    "AtomicMemory", "IndexedQueue", "QueueAlgorithm", "GLFQ", "GWFQ", "YMC",
    "SFQ", "QUEUE_CLASSES", "Scheduler", "Ctx", "ENQ", "DEQ", "HistoryEvent",
    "check_linearizable", "fast_violation_screen", "fifo_conformance",
    "run_balanced", "run_producer_consumer", "FifoReport",
    "DistHeapState", "DistQueueState", "DistShardedQueueState",
    "IDX_BOT", "claim_schedule", "dist_claim_round",
    "dist_dequeue_round", "dist_enqueue_round", "dist_heap_init",
    "dist_priority_publish_compact_round",
    "dist_priority_publish_round", "dist_publish_compact_round",
    "dist_publish_round", "dist_queue_init",
    "dist_sharded_claim_round", "dist_sharded_publish_round",
    "dist_sharded_queue_init", "priority_claim_schedule",
]
