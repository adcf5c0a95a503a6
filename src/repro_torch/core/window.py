"""Streaming ingestion and sliding-window management (paper §2.6),
PyTorch port of core/window.py.

The active window W(t) = {e : t − Δ ≤ t_e ≤ t}. Each incoming batch is
sorted by timestamp, advances t to max(t, batch max ts), drops batch edges
older than t − Δ, evicts the store prefix older than t − Δ, and is merged
with the surviving store suffix as two already-sorted runs (each element's
output position is its own index plus a ``searchsorted`` rank into the
other run). On overflow the oldest edges are dropped and counted. Then the
dual index is rebuilt in bulk. ``ingest_sort`` is the reference's seed
path (one global stable sort of store ++ batch), kept as the equivalence
reference; both give the same bytes.

With a ``TableSpec`` (``init_window(table=)``, ``ingest(table=)``) the
window carries alias tables (core/alias.py): each ingest rebuilds only the
nodes whose region changed (``_dirty_nodes``) and copies the rest; the
first ingest of a table-less state builds them from scratch.

``TsView`` (``init_view``/``advance_view``) is the window's store and
clock without the index: sharded serving's start directory.

Everything stays on the device with fixed shapes and 0-d tensors for the
counters, so the host never waits on an ingest.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.alias import (AliasTables, TableSpec, build_tables,
                                    update_tables)
from repro_torch.core.edge_store import (TS_PAD, EdgeBatch, EdgeStore,
                                         empty_store)
from repro_torch.core.temporal_index import TemporalIndex, build_index


class WindowState(NamedTuple):
    index: TemporalIndex
    t_now: torch.Tensor          # int32: max timestamp seen
    window: torch.Tensor         # int32: Δ
    ingested: torch.Tensor       # int32 running counters
    late_drops: torch.Tensor
    overflow_drops: torch.Tensor
    # alias tables (DESIGN.md §17), maintained by ingest when a TableSpec
    # is passed; None when table bias is off
    tables: Optional[AliasTables] = None


def init_window(edge_capacity: int, node_capacity: int, window: int,
                bias_scale: float = 1.0, table: Optional[TableSpec] = None,
                device=None) -> WindowState:
    store = empty_store(edge_capacity, node_capacity, device=device)
    index = build_index(store, node_capacity, bias_scale)
    tables = build_tables(index, table) if table is not None else None

    def z():
        return torch.zeros((), dtype=torch.int32, device=store.src.device)
    return WindowState(index=index, t_now=z(),
                       window=torch.tensor(window, dtype=torch.int32,
                                           device=store.src.device),
                       ingested=z(), late_drops=z(), overflow_drops=z(),
                       tables=tables)


def _arange(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=dev)


def _prepare_runs(store: EdgeStore, t_prev, window, batch: EdgeBatch,
                  node_capacity: int, watermark=None):
    """The two ts-sorted runs to merge (surviving store suffix, kept batch
    edges, each compacted to the front) plus bookkeeping scalars; the last
    is ``evict_to``, the length of the evicted store prefix, which the
    alias-table dirty rule reads.

    ``watermark`` (an int32 0-d tensor) is an externally agreed lower
    bound on the new ``t_now``: a node-partitioned window (DESIGN.md §12)
    passes the largest batch timestamp across all shards, so every shard
    evicts against the same cutoff t − Δ even when its own slice of the
    batch is older. It stays on the device."""
    E = store.capacity
    B = batch.src.shape[0]
    dev = store.src.device

    # (1) sort the batch by timestamp (stable); invalid slots get TS_PAD
    bvalid = _arange(B, dev) < batch.count
    bts = torch.where(bvalid, batch.ts, TS_PAD)
    border = torch.sort(bts, stable=True).indices
    bsrc, bdst, bts = batch.src[border], batch.dst[border], bts[border]

    # (2) advance time
    # a one-element index, not a 0-d one: indexing by a 0-d tensor reads
    # it on the host
    last = torch.where(batch.count > 0, bts.index_select(
        0, (batch.count.long() - 1).clamp(0, B - 1).reshape(1))[0], -TS_PAD)
    t_now = torch.maximum(t_prev, last)
    if watermark is not None:
        t_now = torch.maximum(t_now, watermark)
    cutoff = t_now - window

    # (3) late drops in the batch; compact kept edges to the front
    blate = bvalid & (bts < cutoff)
    bkeep = bvalid & ~blate
    late = blate.sum(dtype=torch.int32)
    bperm = torch.sort((~bkeep).to(torch.int32), stable=True).indices
    bsrc, bdst, bts = bsrc[bperm], bdst[bperm], bts[bperm]
    bn = bkeep.sum(dtype=torch.int32)
    bts = torch.where(_arange(B, dev) < bn, bts, TS_PAD)

    # (4) evict the store prefix older than the cutoff (prefix drop)
    evict_to = torch.searchsorted(store.ts, cutoff.reshape(1), side="left",
                                  out_int32=True)[0]
    evict_to = torch.minimum(evict_to, store.num_edges)
    keep_n = store.num_edges - evict_to
    idx = (_arange(E, dev) + evict_to).clamp(0, E - 1).long()
    live = _arange(E, dev) < keep_n
    ssrc = torch.where(live, store.src[idx], node_capacity)
    sdst = torch.where(live, store.dst[idx], 0)
    sts = torch.where(live, store.ts[idx], TS_PAD)
    return ((ssrc, sdst, sts, keep_n), (bsrc, bdst, bts, bn), t_now, late,
            evict_to)


def _merge_runs(run_s, run_b):
    """Stable two-run merge by rank; ties break store-first, exactly as a
    stable argsort over [store ++ batch] would."""
    ssrc, sdst, sts, _ = run_s
    bsrc, bdst, bts, _ = run_b
    E, B = sts.shape[0], bts.shape[0]
    dev = sts.device
    pos_s = (_arange(E, dev) + torch.searchsorted(
        bts, sts, side="left", out_int32=True)).long()
    pos_b = (_arange(B, dev) + torch.searchsorted(
        sts, bts, side="right", out_int32=True)).long()
    merged = []
    for s_col, b_col in ((ssrc, bsrc), (sdst, bdst), (sts, bts)):
        m = torch.empty(E + B, dtype=torch.int32, device=dev)
        m[pos_s] = s_col
        m[pos_b] = b_col
        merged.append(m)
    return tuple(merged)


def _clip_to_capacity(merged, keep_n, bn, E: int, node_capacity: int):
    """Overflow-clip the merged run to an E-capacity ts-sorted store,
    keeping the newest E edges."""
    msrc, mdst, mts = merged
    EM = msrc.shape[0]
    dev = msrc.device
    total = keep_n + bn
    overflow = (total - E).clamp(min=0)
    idx = (_arange(E, dev) + overflow).clamp(0, EM - 1).long()
    n_after = total.clamp(max=E)
    live = _arange(E, dev) < n_after
    store = EdgeStore(
        src=torch.where(live, msrc[idx], node_capacity),
        dst=torch.where(live, mdst[idx], 0),
        ts=torch.where(live, mts[idx], TS_PAD),
        num_edges=n_after.to(torch.int32),
    )
    return store, overflow


def _finalize(state: WindowState, merged, keep_n, bn, t_now, late,
              batch_count, node_capacity: int,
              bias_scale: float) -> WindowState:
    """Overflow-clip the merged run to capacity and rebuild the index."""
    store, overflow = _clip_to_capacity(
        merged, keep_n, bn, state.index.store.capacity, node_capacity)
    return WindowState(
        index=build_index(store, node_capacity, bias_scale),
        t_now=t_now.to(torch.int32), window=state.window,
        ingested=state.ingested + batch_count,
        late_drops=state.late_drops + late,
        overflow_drops=state.overflow_drops + overflow.to(torch.int32),
    )


def _dirty_nodes(state: WindowState, run_b, merged, keep_n, bn, evict_to,
                 node_capacity: int) -> torch.Tensor:
    """bool[N]: the nodes whose region content changed this advance — a
    source of a kept batch edge, of the evicted store prefix, or of a row
    the overflow clip dropped. The stable merge and the stable index sort
    keep every other node's region the same sequence, only shifted."""
    nc = node_capacity
    E = state.index.store.capacity
    dev = run_b[0].device
    # nc is a dump slot; index_fill_ takes its value as an argument (an
    # assignment of True would copy it from the host)
    dirty = torch.zeros(nc + 1, dtype=torch.bool, device=dev)
    bsrc = run_b[0]
    B = bsrc.shape[0]
    dirty.index_fill_(0, torch.where(_arange(B, dev) < bn, bsrc, nc).long(),
                      True)
    evicted = _arange(E, dev) < evict_to
    dirty.index_fill_(0, torch.where(evicted, state.index.store.src,
                                     nc).long(), True)
    msrc = merged[0]
    overflow = (keep_n + bn - E).clamp(min=0)
    clipped = _arange(msrc.shape[0], dev) < overflow
    dirty.index_fill_(0, torch.where(clipped, msrc, nc).long(), True)
    return dirty[:nc]


def ingest(state: WindowState, batch: EdgeBatch, node_capacity: int,
           bias_scale: float = 1.0,
           table: Optional[TableSpec] = None,
           watermark=None) -> WindowState:
    """Merge-based window advance by one batch; returns the new state and
    writes nothing it was given.

    ``table`` switches on alias-table maintenance: the dirty nodes are
    rebuilt against the new index and the clean ones copied. Pass the
    spec on every ingest of a table-carrying state: without it the
    returned state has no tables. ``watermark`` is the sharded window's
    eviction hook (see ``_prepare_runs``); one window leaves it None.
    """
    run_s, run_b, t_now, late, evict_to = _prepare_runs(
        state.index.store, state.t_now, state.window, batch, node_capacity,
        watermark=watermark)
    merged = _merge_runs(run_s, run_b)
    new = _finalize(state, merged, run_s[3], run_b[3], t_now, late,
                    batch.count, node_capacity, bias_scale)
    if table is None:
        return new
    if state.tables is None:
        tables = build_tables(new.index, table)
    else:
        dirty = _dirty_nodes(state, run_b, merged, run_s[3], run_b[3],
                             evict_to, node_capacity)
        tables = update_tables(new.index, table,
                               old_starts=state.index.node_starts,
                               old_tables=state.tables, dirty=dirty)
    return new._replace(tables=tables)


def ingest_sort(state: WindowState, batch: EdgeBatch, node_capacity: int,
                bias_scale: float = 1.0) -> WindowState:
    """The reference's seed path: store ++ batch ordered by one global
    stable sort on the timestamp, then clipped and indexed as ``ingest``
    does. Byte-equal to ``ingest``; carries no tables."""
    run_s, run_b, t_now, late, _ = _prepare_runs(
        state.index.store, state.t_now, state.window, batch, node_capacity)
    cols = [torch.cat([x, y]) for x, y in zip(run_s[:3], run_b[:3])]
    order = torch.sort(cols[2], stable=True).indices
    return _finalize(state, tuple(c[order] for c in cols), run_s[3],
                     run_b[3], t_now, late, batch.count, node_capacity,
                     bias_scale)


# the reference's names for the merge ingest; the port's ingest never
# writes its input, so it is also the serving buffer's non-donating one
ingest_merge = ingest
ingest_nodonate = ingest


# ---------------------------------------------------------------------------
# Timestamp view: the global window's (src, dst, ts) columns without a
# dual index (sharded serving's start directory, DESIGN.md §13)
# ---------------------------------------------------------------------------


class TsView(NamedTuple):
    """A bare timestamp-sorted store plus the window clock, no dual index.

    Advanced through the single-device merge stages, so ``store`` is
    byte-equal to the single-device window's store for the same batch
    stream. Sharded serving keeps one beside the node-partitioned window:
    a global start-edge draw (a position in the global ts view) resolves
    on any shard, while the dual indexes stay sharded. It costs 3 int32
    columns of the global edge capacity."""

    store: EdgeStore
    t_now: torch.Tensor          # int32: max timestamp seen
    window: torch.Tensor         # int32: Δ


def init_view(edge_capacity: int, node_capacity: int, window: int,
              device=None) -> TsView:
    """An empty view, on CUDA unless ``device`` names another."""
    store = empty_store(edge_capacity, node_capacity, device=device)
    dev = store.src.device
    return TsView(store=store,
                  t_now=torch.zeros((), dtype=torch.int32, device=dev),
                  window=torch.tensor(window, dtype=torch.int32,
                                      device=dev))


def advance_view(view: TsView, batch: EdgeBatch,
                 node_capacity: int) -> TsView:
    """Advance a view by one batch: the window ingest without the index
    build, the same store and ``t_now`` trajectory as ``ingest``. Writes
    nothing it was given, so the old view stays readable while the next
    one builds."""
    run_s, run_b, t_now, _, _ = _prepare_runs(
        view.store, view.t_now, view.window, batch, node_capacity)
    store, _ = _clip_to_capacity(_merge_runs(run_s, run_b), run_s[3],
                                 run_b[3], view.store.capacity,
                                 node_capacity)
    return TsView(store=store, t_now=t_now.to(torch.int32),
                  window=view.window)
