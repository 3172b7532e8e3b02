"""repro_torch.core — the port's twins of ``repro.core``: the mesh-level
queues (``distqueue``): the FIFO ring, replicated and sharded, and the
priority mesh's heap planes, as stacked tensors on one card."""

from .distqueue import (DistHeapState, DistQueueState, DistShardedQueueState,
                        IDX_BOT, claim_schedule, dist_claim_round,
                        dist_dequeue_round, dist_enqueue_round,
                        dist_heap_init, dist_priority_publish_compact_round,
                        dist_priority_publish_round,
                        dist_publish_compact_round, dist_publish_round,
                        dist_queue_init, dist_sharded_claim_round,
                        dist_sharded_publish_round, dist_sharded_queue_init,
                        priority_claim_schedule)

__all__ = ["DistHeapState", "DistQueueState", "DistShardedQueueState",
           "IDX_BOT", "claim_schedule", "dist_claim_round",
           "dist_dequeue_round", "dist_enqueue_round", "dist_heap_init",
           "dist_priority_publish_compact_round",
           "dist_priority_publish_round", "dist_publish_compact_round",
           "dist_publish_round", "dist_queue_init",
           "dist_sharded_claim_round", "dist_sharded_publish_round",
           "dist_sharded_queue_init", "priority_claim_schedule"]
