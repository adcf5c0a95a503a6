"""Walk-engine configuration dataclasses (PyTorch port).

Field names and defaults are those of the JAX package's
``repro/configs/base.py`` engine configs, copied so the port imports
nothing of it. Everything is a frozen dataclass, so configs hash.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple


@dataclass(frozen=True)
class WindowConfig:
    """Sliding-window semantics (paper §2.6)."""

    duration: float = 3600.0          # Δ, in timestamp units
    edge_capacity: int = 1 << 16      # static capacity of the edge store
    node_capacity: int = 1 << 12      # max node id + 1
    drop_late: bool = True            # drop edges older than t - Δ at merge


@dataclass(frozen=True)
class SamplerConfig:
    """Temporal bias sampling (paper §2.5).

    The port serves ``bias`` uniform | linear | exponential in both modes;
    ``core.walk_engine.check_capabilities`` raises "not yet ported" for
    ``bias="table"`` and node2vec (p, q) != (1, 1).
    """

    bias: str = "exponential"         # uniform | linear | exponential | table
    mode: str = "index"               # index (closed-form O(1)) | weight (exact, O(log n))
    start_bias: str = "uniform"       # bias over start edges (timestamp view)
    node2vec_p: float = 1.0
    node2vec_q: float = 1.0
    table_weight: Optional[Callable] = None
    table_radix: int = 4096
    table_degree_cap: int = 64


@dataclass(frozen=True)
class SchedulerConfig:
    """Per-hop dispatch (paper §2.4): every path and regroup of the
    reference."""

    path: str = "grouped"             # fullwalk | grouped | tiled | fused
    regroup: str = "bucket"           # bucket | lexsort
    regroup_time: bool = True         # conditional time subsort inside buckets
    solo_threshold: int = 4
    tile_walks: int = 256             # walks per tile (one CTA on the card)
    tile_edges: int = 1024            # edges per staged block; the panel is 2 blocks
    max_task_walks: int = 8192
    compact_threshold: float = 0.5


@dataclass(frozen=True)
class WalkConfig:
    """A walk-generation request (paper defaults: L=80, 10 walks/node)."""

    num_walks: int = 1024
    max_length: int = 80
    start_mode: str = "nodes"         # nodes | edges | all_nodes
    direction: str = "forward"


@dataclass(frozen=True)
class ServeConfig:
    """Walk-query serving layer (repro_torch.serve, DESIGN.md §11).

    A coalesced batch always runs at a bucketed (lane count, length), never
    at the exact query shape; buckets are sorted ascending and the largest
    lane bucket is the lane budget of one batch. ``max_inflight`` bounds
    the ring of launched, unharvested batches (1 is the synchronous loop);
    ``linger_s`` keeps a partly filled batch open to late same-group
    queries until its head query has waited that long; ``admission`` is
    the head-of-line order, ``"fifo"`` or ``"edf"`` (earliest
    ``WalkQuery.deadline_s`` first). ``num_shards`` > 0 (sharded serving)
    is not yet ported.
    """

    queue_capacity: int = 1024        # pending-query slots; beyond -> dropped
    lane_buckets: Tuple[int, ...] = (64, 256, 1024, 4096)
    length_buckets: Tuple[int, ...] = (4, 8, 16, 32, 80)
    drop_oversize: bool = True        # False: oversize submits raise (typed)
    num_shards: int = 0               # 0 = single window
    max_inflight: int = 4             # in-flight batch ring depth (>= 1)
    linger_s: float = 0.0             # continuous-batching seal deadline
    admission: str = "fifo"           # fifo | edf


@dataclass(frozen=True)
class ShardConfig:
    """Node-partitioned window knobs (kept for ``EngineConfig`` field
    parity; the port has no sharded window yet)."""

    num_shards: int = 0
    edge_capacity_per_shard: int = 1 << 16
    exchange_capacity: int = 1 << 12
    walk_slots: int = 1 << 12
    walk_bucket_capacity: int = 1 << 10
    placement: str = "range"
    hash_buckets: int = 256
    hot_k: int = 8


@dataclass(frozen=True)
class EngineConfig:
    window: WindowConfig = field(default_factory=WindowConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    shard: ShardConfig = field(default_factory=ShardConfig)
    timestamp_dtype: str = "int32"
    seed: int = 0
