"""Walk-query request model for the serving subsystem (DESIGN.md §11),
PyTorch port of repro/serve/query.py (plain Python and numpy).

A ``WalkQuery`` is one tenant's request against the current window
snapshot: its own start nodes (or start-edge bias), hop bias, maximum
length, and RNG seed. The coalescer packs many queries into one
fixed-shape lane batch; because every lane's randomness is a pure function
of (query seed, walk-within-query, step) — see
``walk_engine.LaneParams`` — the answer a query receives is bit-identical
whether it ran solo or packed with arbitrary other traffic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.samplers import BIAS_CODES

START_MODES = ("nodes", "edges")
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


@dataclass(frozen=True)
class WalkQuery:
    """One walk request.

    ``start_mode="nodes"``: one lane per entry of ``start_nodes``.
    ``start_mode="edges"``: ``num_walks`` lanes, each starting from an
    edge drawn under ``start_bias`` over the timestamp view.

    ``seed`` is the request's RNG identity: resubmitting the same query
    against the same snapshot reproduces the same walks exactly,
    regardless of what else shares the batch.
    """

    start_nodes: Tuple[int, ...] = ()
    bias: str = "exponential"          # uniform | linear | exponential | table
    max_length: int = 16               # per-walk hop budget (≤ edges emitted)
    seed: int = 0
    start_mode: str = "nodes"          # nodes | edges
    start_bias: str = "uniform"        # edges mode: bias over start edges
    num_walks: int = 0                 # edges mode: lane count
    # second-order node2vec return/in-out parameters (1.0, 1.0 disables;
    # any other pair turns on the rejection-sampled second-order draw for
    # this query's lanes only — co-batched first-order queries are
    # untouched, the solo/coalesced bit-identity holds either way)
    n2v_p: float = 1.0
    n2v_q: float = 1.0
    # SLO deadline (DESIGN.md §18), in seconds from submit; None = none.
    # A query still *queued* past its deadline is evicted (counted as a
    # ``deadline_expired`` drop) instead of wasting a dispatch on an
    # answer nobody will read. Once sealed into a batch it always
    # completes — eviction is an admission decision, not a cancellation.
    # Under ``ServeConfig.admission="edf"`` the deadline also orders the
    # queue (earliest first).
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if self.bias not in BIAS_CODES:
            raise ValueError(f"unknown bias {self.bias!r} "
                             f"(expected one of {sorted(BIAS_CODES)})")
        # "table" is a valid hop bias (the service checks it against the
        # snapshot's tables at submit) but never a start bias: alias
        # tables cover per-node neighborhood regions, not the global
        # timestamp view that start-edge draws sample.
        if self.start_bias == "table" or self.start_bias not in BIAS_CODES:
            raise ValueError(f"unknown start_bias {self.start_bias!r} "
                             "(expected 'uniform'|'linear'|'exponential')")
        if not (self.n2v_p > 0.0 and self.n2v_q > 0.0):
            raise ValueError(
                f"node2vec parameters must be positive, got "
                f"p={self.n2v_p}, q={self.n2v_q}")
        if self.start_mode not in START_MODES:
            raise ValueError(f"unknown start_mode {self.start_mode!r} "
                             f"(expected one of {START_MODES})")
        if self.deadline_s is not None and not self.deadline_s > 0.0:
            raise ValueError(
                f"deadline_s must be positive (got {self.deadline_s}); "
                "omit it (None) for no deadline")
        if self.max_length < 1:
            raise ValueError("max_length must be >= 1")
        # the lane arrays are int32: reject values that cannot round-trip
        # (otherwise pack_queries would throw mid-batch, after innocent
        # co-batched queries were already popped from the pending queue)
        if not _INT32_MIN <= self.seed <= _INT32_MAX:
            raise ValueError(f"seed {self.seed} does not fit int32")
        if self.start_mode == "nodes":
            if not self.start_nodes:
                raise ValueError("start_mode='nodes' requires start_nodes")
            for v in self.start_nodes:
                if not _INT32_MIN <= v <= _INT32_MAX:
                    raise ValueError(f"start node {v} does not fit int32")
        elif self.num_walks < 1:
            raise ValueError("start_mode='edges' requires num_walks >= 1")

    @property
    def num_lanes(self) -> int:
        """Walk lanes this query occupies in a coalesced batch."""
        return (len(self.start_nodes) if self.start_mode == "nodes"
                else self.num_walks)

    @property
    def second_order(self) -> bool:
        """True when this query's lanes draw under node2vec (p, q)."""
        return self.n2v_p != 1.0 or self.n2v_q != 1.0


@dataclass(frozen=True)
class QueryResult:
    """A completed query: per-walk arrays sliced back out of the coalesced
    batch, trimmed to the query's own ``max_length + 1`` columns.

    ``snapshot_version`` is the ``SnapshotManager.version`` the batch ran
    against — the snapshot-consistency handle: every edge in this result
    came from that one window version, never a mix across ``publish()``.
    """

    ticket: int
    query: WalkQuery
    nodes: np.ndarray        # int32[num_lanes, max_length+1], NODE_PAD tail
    times: np.ndarray        # int32[num_lanes, max_length+1]
    lengths: np.ndarray      # int32[num_lanes]
    latency_s: float         # submit -> completion wall time
    snapshot_version: int = -1
