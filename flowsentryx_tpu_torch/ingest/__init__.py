"""Sharded parallel host ingest: N spawned drain workers, one per
feature-ring shard (``fsxd --shards N``), hand the engine sealed wire
buffers over shared-memory queues.

Counterpart of ``flowsentryx_tpu/ingest/``.  numpy only: importing this
package, the fleet (:mod:`.sharded`) or a worker (:mod:`.worker`) never
imports torch.
"""

from flowsentryx_tpu_torch.ingest.sharded import (  # noqa: F401
    SealedBatch,
    SeqTracker,
    ShardedIngest,
    WorkerCrash,
)
