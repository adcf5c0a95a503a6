"""Walk-query serving (DESIGN.md §11, §13, §18), PyTorch port of
repro/serve.

* ``WalkQuery`` / ``QueryResult`` — the request model (per-request bias,
  max length, seed, start nodes).
* coalescer — shape-bucketed packing of many queries into one
  fixed-shape ``generate_walk_lanes`` batch, plus result slicing.
* ``SnapshotManager`` — window double buffer: serve against a consistent
  snapshot while the next ingest builds.
* ``ShardedSnapshotManager`` — the same protocol over a node-partitioned
  window and the ts view of the whole window (DESIGN.md §13).
* ``WalkService`` — the service loop: fixed-capacity queue with
  backpressure + drop accounting, FIFO/EDF coalescing, p50/p99 latency
  and walks/s stats, and the async in-flight ring (``tick``/``pump``);
  one device by default, node-partitioned with ``num_shards``/``mesh``
  (or ``ServeConfig.num_shards``).

Alias-table (bias "table") and second-order (node2vec) queries run on
one device, on the grouped and fullwalk paths.
"""
from repro_torch.serve.coalescer import (
    LaneSlice,
    bucketize,
    group_key,
    lane_owners,
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
from repro_torch.serve.snapshot import (
    PinnedShardedSnapshot,
    PinnedSnapshot,
    ShardedSnapshotManager,
    SnapshotManager,
)

__all__ = [
    "LaneSlice", "bucketize", "group_key", "lane_owners", "pack_queries",
    "slice_result", "QueryResult", "WalkQuery", "OversizeQuery",
    "QueueFull", "ServeStats", "WalkService", "PinnedShardedSnapshot",
    "PinnedSnapshot", "ShardedSnapshotManager", "SnapshotManager",
]
