"""The streaming walk sampler: edge store, dual index, samplers, dispatch
plane and regroup, the walk engine (fullwalk, grouped, tiled and fused
paths; per-lane batches; reusable walk buffers), sliding window and
streaming replay."""
from repro_torch.core.edge_store import (
    EdgeBatch,
    EdgeStore,
    empty_store,
    make_batch,
    stack_batches,
    store_from_arrays,
)
from repro_torch.core.streaming import (
    StreamingEngine,
    StreamStats,
    replay_scan,
)
from repro_torch.core.temporal_index import TemporalIndex, build_index
from repro_torch.core.walk_engine import (
    LaneParams,
    WalkBuffers,
    WalkResult,
    alloc_walk_buffers,
    generate_walk_lanes,
    generate_walks,
    generate_walks_donated,
)
from repro_torch.core.window import WindowState, ingest, init_window

__all__ = [
    "EdgeBatch", "EdgeStore", "empty_store", "make_batch", "stack_batches",
    "store_from_arrays", "StreamingEngine", "StreamStats", "replay_scan",
    "TemporalIndex", "build_index", "LaneParams", "WalkBuffers",
    "WalkResult", "alloc_walk_buffers", "generate_walk_lanes",
    "generate_walks", "generate_walks_donated", "WindowState", "ingest",
    "init_window",
]
