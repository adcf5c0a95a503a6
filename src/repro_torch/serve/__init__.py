"""Walk-query serving (DESIGN.md §11, §18), PyTorch port of repro/serve
for one device.

* ``WalkQuery`` / ``QueryResult`` — the request model (per-request bias,
  max length, seed, start nodes).
* coalescer — shape-bucketed packing of many queries into one
  fixed-shape ``generate_walk_lanes`` batch, plus result slicing.
* ``SnapshotManager`` — window double buffer: serve against a consistent
  snapshot while the next ingest builds.
* ``WalkService`` — the service loop: fixed-capacity queue with
  backpressure + drop accounting, FIFO/EDF coalescing, p50/p99 latency
  and walks/s stats, and the async in-flight ring (``tick``/``pump``).

Alias-table (bias "table") and second-order (node2vec) queries run on
the grouped and fullwalk paths. Sharded serving (the reference's
``ShardedSnapshotManager``, ``PinnedShardedSnapshot``, ``lane_owners``)
is not yet ported.
"""
from repro_torch.serve.coalescer import (
    LaneSlice,
    bucketize,
    group_key,
    pack_queries,
    slice_result,
)
from repro_torch.serve.query import QueryResult, WalkQuery
from repro_torch.serve.service import (
    OversizeQuery,
    QueueFull,
    ServeStats,
    WalkService,
)
from repro_torch.serve.snapshot import PinnedSnapshot, SnapshotManager

__all__ = [
    "LaneSlice", "bucketize", "group_key", "pack_queries", "slice_result",
    "QueryResult", "WalkQuery", "OversizeQuery", "QueueFull", "ServeStats",
    "WalkService", "PinnedSnapshot", "SnapshotManager",
]
