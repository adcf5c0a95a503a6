"""Snapshot double buffer: serve walks against a consistent window while
the next ingest builds (DESIGN.md §11), PyTorch port of
repro/serve/snapshot.py for one device.

The port's ``window.ingest`` is out of place: it reads the current
``WindowState`` and returns a new one, writing nothing it was given. So

* ``current`` — the front buffer, which every coalesced batch reads, is
  never written once published;
* ``begin_ingest(batch)`` — enqueues the merge ingest and index rebuild
  on the current stream and returns at once; a CUDA event recorded after
  it marks the back buffer ready;
* ``publish()`` — waits on that event (not on the whole device) and
  swaps the back buffer in. Batches admitted before the swap read the old
  window, batches admitted after it the new one.

Ingest and walks share one stream: a walk batch launched between
``begin_ingest`` and ``publish`` runs on the device after the ingest
kernels, while the host goes on coalescing. Two windows are alive at the
swap; the old one is freed when the last batch pinned to it is harvested.

With ``table=`` (a ``TableSpec``) every ``begin_ingest`` also maintains
the window's alias tables (only the nodes whose region changed are
rebuilt), so a published snapshot carries tables consistent with its
window. The build reads nothing back from the device, so it stays
enqueued like the rest of the ingest.

``ShardedSnapshotManager`` is the same protocol one level up (DESIGN.md
§13): the front buffer is a node-partitioned ``ShardedWindowState`` plus
the ``TsView`` start directory of the whole window, advanced together by
the sharded ingest (one exchange, the eviction watermark agreed over the
shards) and the view merge. ``publish()`` swaps both at once, so a
sharded batch never sees the shards' windows and the start directory at
different versions. Two sharded windows and two views are alive at the
swap.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import EngineConfig
from repro_torch.core.alias import TableSpec
from repro_torch.core.edge_store import EdgeBatch
from repro_torch.core.window import (
    TsView,
    WindowState,
    advance_view,
    ingest,
    init_view,
)
from repro_torch.distributed.collectives import make_group
from repro_torch.distributed.placement import make_placement
from repro_torch.distributed.streaming_shard import (
    _warm_placement,
    ingest_sharded_nodonate,
    init_sharded_window,
)
from repro_torch.obs.registry import MetricsRegistry, get_registry


class PinnedSnapshot(NamedTuple):
    """A ``(window state, version)`` pair captured at launch time: an
    in-flight batch keeps the window it read alive and reports its
    version, whatever ``publish`` did meanwhile."""

    state: WindowState
    version: int


class PinnedShardedSnapshot(NamedTuple):
    """Sharded twin of ``PinnedSnapshot``: the (sharded window, ts view)
    pair always belongs to one published version, so an in-flight sharded
    batch never sees the two at different versions."""

    state: object
    view: TsView
    version: int


def ready_event(device: torch.device) -> Optional[torch.cuda.Event]:
    """A CUDA event recorded now on ``device``'s current stream, or None
    for the CPU (its work is done when the call returns)."""
    if device.type != "cuda":
        return None
    with torch.cuda.device(device):
        ev = torch.cuda.Event()
        ev.record()
    return ev


class SnapshotManager:
    """Double-buffered ``WindowState`` for the serving layer."""

    def __init__(self, state: WindowState, node_capacity: int,
                 registry: Optional[MetricsRegistry] = None,
                 table: Optional[TableSpec] = None):
        self.current = state
        self.node_capacity = node_capacity
        # fixed for the manager's life: incremental maintenance is valid
        # only against tables built under the same spec
        self.table = table
        self.registry = registry if registry is not None else get_registry()
        self.version = 0          # bumped at every publish
        self._next: Optional[WindowState] = None
        self._ready: Optional[torch.cuda.Event] = None

    @property
    def ingest_in_flight(self) -> bool:
        return self._next is not None

    def begin_ingest(self, batch: EdgeBatch) -> None:
        """Start building the next window; ``current`` stays serveable."""
        if self._next is not None:
            raise RuntimeError("an ingest is already in flight; publish() "
                               "or discard() it first")
        self._next = ingest(self.current, batch, self.node_capacity,
                            table=self.table)
        self._ready = ready_event(self._next.index.ns_ts.device)

    def publish(self) -> WindowState:
        """Wait for the in-flight ingest and swap it in as ``current``."""
        if self._next is None:
            raise RuntimeError("no ingest in flight; call begin_ingest first")
        if self._ready is not None:
            self._ready.synchronize()
        self.current, self._next, self._ready = self._next, None, None
        self.version += 1
        self.registry.inc("snapshot_publishes_total", 1,
                          help="serving snapshot buffer swaps")
        return self.current

    def discard(self) -> None:
        """Drop an in-flight ingest without publishing it."""
        self._next = self._ready = None

    def acquire(self) -> PinnedSnapshot:
        """Pin the current (state, version) pair for an async launch."""
        return PinnedSnapshot(self.current, self.version)

    def ingest(self, batch: EdgeBatch) -> WindowState:
        """Synchronous convenience: begin + publish in one call."""
        self.begin_ingest(batch)
        return self.publish()


class ShardedSnapshotManager:
    """Double-buffered node-partitioned window + ts view.

    The serving front of ``DistributedStreamingEngine``-style state:
    ``state`` (the shards' windows) and ``view`` (the start directory of
    the whole window) always belong to the same published version.
    Batches are split D ways on the batch axis as in the engine's ingest,
    the capacity rounded up to a multiple of D. One placement routes both
    the ingest and the lane claims, so the window's layout and the claim
    rule cannot diverge. The shards are ``mesh`` (a ``ShardGroup``), else
    the first ``num_shards`` (default ``cfg.shard.num_shards``, 0 for
    all) of ``devices`` (default: the visible CUDA devices); name a device
    D times to run D shards on it. ``begin_ingest`` records a CUDA event
    on each shard device and ``publish`` waits on those, not on the
    devices.
    """

    def __init__(self, cfg: EngineConfig, batch_capacity: int = 8192, *,
                 mesh=None, num_shards: int = 0, devices=None,
                 placement=None,
                 registry: Optional[MetricsRegistry] = None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_group(
            num_shards or cfg.shard.num_shards, devices)
        D = self.mesh.size
        self.num_shards = D
        self.placement = placement if placement is not None else \
            make_placement(cfg.shard.placement, D, cfg.window.node_capacity,
                           hash_buckets=cfg.shard.hash_buckets)
        if self.placement.num_shards != D:
            raise ValueError(
                f"placement covers {self.placement.num_shards} shards; "
                f"mesh has {D} devices")
        _warm_placement(self.placement, self.mesh)
        self.batch_slice = -(-batch_capacity // D)
        self.batch_capacity = self.batch_slice * D
        self.node_capacity = cfg.window.node_capacity
        self.state = init_sharded_window(
            D, cfg.shard.edge_capacity_per_shard, self.node_capacity,
            int(cfg.window.duration), mesh=self.mesh)
        self.view = init_view(cfg.window.edge_capacity, self.node_capacity,
                              int(cfg.window.duration),
                              device=self.mesh.devices[0])
        self.registry = registry if registry is not None else get_registry()
        self.version = 0          # bumped at every publish
        self._next = None
        self._ready = []

    @property
    def home(self) -> torch.device:
        """The first shard's device: batches, the view and results."""
        return self.mesh.devices[0]

    @property
    def ingest_in_flight(self) -> bool:
        return self._next is not None

    def begin_ingest(self, batch: EdgeBatch) -> None:
        """Start building the next (sharded window, view) pair; the
        current pair stays serveable until ``publish``."""
        if self._next is not None:
            raise RuntimeError("an ingest is already in flight; publish() "
                               "or discard() it first")
        if batch.src.shape[0] != self.batch_capacity:
            raise ValueError(
                f"batch capacity {batch.src.shape[0]} != manager capacity "
                f"{self.batch_capacity} (must be the D-rounded capacity)")

        def split(a):
            return a.reshape(self.num_shards, self.batch_slice)
        nstate = ingest_sharded_nodonate(
            self.state, split(batch.src), split(batch.dst), split(batch.ts),
            batch.count, mesh=self.mesh, node_capacity=self.node_capacity,
            shard_cfg=self.cfg.shard, placement=self.placement)
        nview = advance_view(self.view, batch, self.node_capacity)
        self._next = (nstate, nview)
        self._ready = [ready_event(d) for d in dict.fromkeys(
            self.mesh.devices)]

    def publish(self):
        """Wait for the in-flight ingest and swap both buffers in."""
        if self._next is None:
            raise RuntimeError("no ingest in flight; call begin_ingest first")
        for ev in self._ready:
            if ev is not None:
                ev.synchronize()
        self.state, self.view = self._next
        self._next, self._ready = None, []
        self.version += 1
        self.registry.inc("snapshot_publishes_total", 1,
                          help="serving snapshot buffer swaps")
        return self.state

    def discard(self) -> None:
        """Drop an in-flight ingest without publishing it."""
        self._next, self._ready = None, []

    def acquire(self) -> PinnedShardedSnapshot:
        """Pin the current (state, view, version) triple for an async
        launch: both halves from the same published version."""
        return PinnedShardedSnapshot(self.state, self.view, self.version)

    def ingest(self, batch: EdgeBatch):
        """Synchronous convenience: begin + publish in one call."""
        self.begin_ingest(batch)
        return self.publish()
