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
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.alias import TableSpec
from repro_torch.core.edge_store import EdgeBatch
from repro_torch.core.window import WindowState, ingest
from repro_torch.obs.registry import MetricsRegistry, get_registry


class PinnedSnapshot(NamedTuple):
    """A ``(window state, version)`` pair captured at launch time: an
    in-flight batch keeps the window it read alive and reports its
    version, whatever ``publish`` did meanwhile."""

    state: WindowState
    version: int


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
        if self._next.index.ns_ts.device.type == "cuda":
            self._ready = torch.cuda.Event()
            self._ready.record()

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
