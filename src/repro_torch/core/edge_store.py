"""Shared edge store (paper §2.3), PyTorch port of core/edge_store.py.

One physical edge array, kept **timestamp-sorted**: window eviction is a
prefix drop and start-edge selection is a range sample. The store is
padded to ``edge_capacity``; padding edges carry ``ts = TS_PAD`` (int32
max) so every timestamp sort puts them last, and ``src = node_capacity``
so they land in a virtual trailing node bucket. All stored arrays are
int32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device

TS_PAD = int(np.iinfo(np.int32).max)


class EdgeBatch(NamedTuple):
    """An incoming (possibly unsorted) batch: fixed capacity + a count."""

    src: torch.Tensor      # int32[B_cap] (or [K, B_cap] when stacked)
    dst: torch.Tensor      # int32[B_cap]
    ts: torch.Tensor       # int32[B_cap]
    count: torch.Tensor    # int32 scalar (or [K]) — valid prefix length


class EdgeStore(NamedTuple):
    """Timestamp-sorted shared edge store."""

    src: torch.Tensor        # int32[E_cap]
    dst: torch.Tensor        # int32[E_cap]
    ts: torch.Tensor         # int32[E_cap], ascending; TS_PAD past num_edges
    num_edges: torch.Tensor  # int32 scalar

    @property
    def capacity(self) -> int:
        return self.src.shape[0]


def _pad_host(src, dst, ts, capacity: int):
    """Host-side batch padding: zeros for src/dst, TS_PAD for ts."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    ts = np.asarray(ts, np.int32)
    n = src.shape[0]
    if n > capacity:
        raise ValueError(f"batch of {n} exceeds capacity {capacity}")
    pad = capacity - n
    return (np.concatenate([src, np.zeros(pad, np.int32)]),
            np.concatenate([dst, np.zeros(pad, np.int32)]),
            np.concatenate([ts, np.full(pad, TS_PAD, np.int32)]),
            n)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int32)).to(device)


def make_batch(src, dst, ts, capacity: int | None = None,
               device=None) -> EdgeBatch:
    """Build an EdgeBatch from host arrays, padding to capacity."""
    device = resolve_device(device)
    n = np.asarray(src).shape[0]
    src, dst, ts, n = _pad_host(src, dst, ts, capacity or max(n, 1))
    return EdgeBatch(src=_i32(src, device), dst=_i32(dst, device),
                     ts=_i32(ts, device), count=_i32(n, device))


def stack_batches(batches, capacity: int, device=None) -> EdgeBatch:
    """Stack K host batches into one [K, capacity] EdgeBatch (+ count[K])
    with one host-to-device copy per column."""
    device = resolve_device(device)
    srcs, dsts, tss, counts = [], [], [], []
    for s, d, t in batches:
        s, d, t, n = _pad_host(s, d, t, capacity)
        srcs.append(s)
        dsts.append(d)
        tss.append(t)
        counts.append(n)
    if not srcs:
        raise ValueError("stack_batches needs at least one batch")
    return EdgeBatch(src=_i32(np.stack(srcs), device),
                     dst=_i32(np.stack(dsts), device),
                     ts=_i32(np.stack(tss), device),
                     count=_i32(counts, device))


def empty_store(edge_capacity: int, node_capacity: int,
                device=None) -> EdgeStore:
    device = resolve_device(device)
    return EdgeStore(
        src=torch.full((edge_capacity,), node_capacity, dtype=torch.int32,
                       device=device),
        dst=torch.zeros((edge_capacity,), dtype=torch.int32, device=device),
        ts=torch.full((edge_capacity,), TS_PAD, dtype=torch.int32,
                      device=device),
        num_edges=torch.zeros((), dtype=torch.int32, device=device),
    )


def store_from_arrays(src, dst, ts, edge_capacity: int, node_capacity: int,
                      device=None) -> EdgeStore:
    """Host-side constructor: sort by timestamp, pad to capacity."""
    device = resolve_device(device)
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    ts = np.asarray(ts, np.int32)
    order = np.argsort(ts, kind="stable")
    src, dst, ts = src[order], dst[order], ts[order]
    n = src.shape[0]
    if n > edge_capacity:
        raise ValueError(f"{n} edges exceed capacity {edge_capacity}")
    pad = edge_capacity - n
    return EdgeStore(
        src=_i32(np.concatenate([src, np.full(pad, node_capacity, np.int32)]),
                 device),
        dst=_i32(np.concatenate([dst, np.zeros(pad, np.int32)]), device),
        ts=_i32(np.concatenate([ts, np.full(pad, TS_PAD, np.int32)]), device),
        num_edges=_i32(n, device),
    )



def store_nbytes(store: EdgeStore) -> int:
    """Device bytes held by the store's ``src``, ``dst`` and ``ts`` (paper
    Fig. 11 memory accounting); the count is metadata, read nowhere."""
    return sum(a.numel() * a.element_size()
               for a in (store.src, store.dst, store.ts))
