"""Streaming ingestion and sliding-window management (paper §2.6),
PyTorch port of core/window.py (merge path, no alias tables).

The active window W(t) = {e : t − Δ ≤ t_e ≤ t}. Each incoming batch is
sorted by timestamp, advances t to max(t, batch max ts), drops batch edges
older than t − Δ, evicts the store prefix older than t − Δ, and is merged
with the surviving store suffix as two already-sorted runs (each element's
output position is its own index plus a ``searchsorted`` rank into the
other run). On overflow the oldest edges are dropped and counted. Then the
dual index is rebuilt in bulk.

Everything stays on the device with fixed shapes and 0-d tensors for the
counters, so the host never waits on an ingest.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

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


def init_window(edge_capacity: int, node_capacity: int, window: int,
                bias_scale: float = 1.0, device=None) -> WindowState:
    store = empty_store(edge_capacity, node_capacity, device=device)
    index = build_index(store, node_capacity, bias_scale)

    def z():
        return torch.zeros((), dtype=torch.int32, device=store.src.device)
    return WindowState(index=index, t_now=z(),
                       window=torch.tensor(window, dtype=torch.int32,
                                           device=store.src.device),
                       ingested=z(), late_drops=z(), overflow_drops=z())


def _arange(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=dev)


def _prepare_runs(store: EdgeStore, t_prev, window, batch: EdgeBatch,
                  node_capacity: int):
    """The two ts-sorted runs to merge (surviving store suffix, kept batch
    edges, each compacted to the front) plus bookkeeping scalars."""
    E = store.capacity
    B = batch.src.shape[0]
    dev = store.src.device

    # (1) sort the batch by timestamp (stable); invalid slots get TS_PAD
    bvalid = _arange(B, dev) < batch.count
    bts = torch.where(bvalid, batch.ts, TS_PAD)
    border = torch.sort(bts, stable=True).indices
    bsrc, bdst, bts = batch.src[border], batch.dst[border], bts[border]

    # (2) advance time
    last = torch.where(batch.count > 0,
                       bts[(batch.count.long() - 1).clamp(0, B - 1)], -TS_PAD)
    t_now = torch.maximum(t_prev, last)
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
    return (ssrc, sdst, sts, keep_n), (bsrc, bdst, bts, bn), t_now, late


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


def ingest(state: WindowState, batch: EdgeBatch, node_capacity: int,
           bias_scale: float = 1.0) -> WindowState:
    """Merge-based window advance by one batch; returns the new state."""
    run_s, run_b, t_now, late = _prepare_runs(
        state.index.store, state.t_now, state.window, batch, node_capacity)
    merged = _merge_runs(run_s, run_b)
    store, overflow = _clip_to_capacity(
        merged, run_s[3], run_b[3], state.index.store.capacity, node_capacity)
    return WindowState(
        index=build_index(store, node_capacity, bias_scale),
        t_now=t_now.to(torch.int32), window=state.window,
        ingested=state.ingested + batch.count,
        late_drops=state.late_drops + late,
        overflow_drops=state.overflow_drops + overflow.to(torch.int32),
    )
