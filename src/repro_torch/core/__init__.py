"""The streaming walk sampler: edge store, dual index, samplers, alias
tables, dispatch plane and regroup, the walk engine (fullwalk, grouped,
tiled and fused paths; per-lane batches; node2vec; reusable walk
buffers), sliding window and streaming replay; and the paper's host
baselines (``baselines``: TEA-style and static walkers)."""
from repro_torch.core.alias import (
    AliasTables,
    TableSpec,
    build_tables,
    spec_from_sampler,
    update_tables,
)
from repro_torch.core.baselines import (
    StaticWalker,
    TeaStyleSampler,
    temporal_validity,
)
from repro_torch.core.edge_store import (
    EdgeBatch,
    EdgeStore,
    empty_store,
    make_batch,
    stack_batches,
    store_from_arrays,
    store_nbytes,
)
from repro_torch.core.streaming import (
    StreamingEngine,
    StreamStats,
    ingest_and_walk,
    ingest_and_walk_donated,
    replay_scan,
    replay_scan_probed,
)
from repro_torch.core.temporal_index import (
    TemporalIndex,
    build_index,
    build_index_donated,
)
from repro_torch.core.walk_engine import (
    LaneParams,
    WalkBuffers,
    WalkResult,
    alloc_walk_buffers,
    generate_walk_lanes,
    generate_walks,
    generate_walks_donated,
)
from repro_torch.core.window import (
    WindowState,
    ingest,
    ingest_nodonate,
    ingest_sort,
    init_window,
)

__all__ = [
    "AliasTables", "TableSpec", "build_tables", "spec_from_sampler",
    "update_tables", "StaticWalker", "TeaStyleSampler",
    "temporal_validity", "EdgeBatch", "EdgeStore", "empty_store", "make_batch",
    "stack_batches", "store_from_arrays", "store_nbytes", "StreamingEngine",
    "StreamStats", "ingest_and_walk", "ingest_and_walk_donated",
    "replay_scan", "replay_scan_probed", "TemporalIndex", "build_index",
    "build_index_donated", "LaneParams", "WalkBuffers", "WalkResult",
    "alloc_walk_buffers", "generate_walk_lanes", "generate_walks",
    "generate_walks_donated", "WindowState", "ingest", "ingest_nodonate",
    "ingest_sort", "init_window",
]
