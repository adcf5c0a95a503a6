"""Dual-index organization (paper §2.3), PyTorch port of
core/temporal_index.py — bulk reconstruction, O(m).

* **Timestamp-grouped view** — the physical store itself.
* **Node-and-timestamp-grouped view** — permutation ``ns_order`` sorting
  edges by (src, ts); ``node_starts[v]`` locates node v's region [a, b)
  and a ranged search inside it finds the temporal cutoff c, so
  Γ_t(v) = [c, b). ``ns_ts`` / ``ns_dst`` are gathered copies.
* **Adjacency view** — permutation sorting edges by (src, dst, ts), used by
  the causality validator.

Weight prefixes (exclusive, length E+1): ``pexp`` / ``pexp_store`` come
from the ``weight_prefix`` kernel, ``plin`` / ``plin_store`` from a plain
``torch.cumsum`` (the reference computes both outside any kernel).

The two ``jnp.lexsort`` calls of the reference are stable sorts here: ties
break by original index. Every stored array is int32 or float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.edge_store import TS_PAD, EdgeStore
from repro_torch.kernels.weight_prefix import weight_prefix


class TemporalIndex(NamedTuple):
    store: EdgeStore
    ns_order: torch.Tensor        # int32[E] position -> store index
    ns_src: torch.Tensor          # int32[E]
    ns_dst: torch.Tensor          # int32[E]
    ns_ts: torch.Tensor           # int32[E]
    node_starts: torch.Tensor     # int32[N+2] region of v = [ns[v], ns[v+1])
    node_group_counts: torch.Tensor  # int32[N] distinct timestamps per node
    pexp: torch.Tensor            # float32[E+1]
    plin: torch.Tensor            # float32[E+1]
    node_tref: torch.Tensor       # int32[N] max ts per node
    node_tbase: torch.Tensor      # int32[N] min ts per node
    pexp_store: torch.Tensor      # float32[E+1]
    plin_store: torch.Tensor      # float32[E+1]
    adj_order: torch.Tensor       # int32[E] sorted by (src, dst, ts)
    adj_dst: torch.Tensor         # int32[E]

    @property
    def num_edges(self) -> torch.Tensor:
        return self.store.num_edges

    @property
    def node_capacity(self) -> int:
        return self.node_starts.shape[0] - 2

    @property
    def edge_capacity(self) -> int:
        return self.ns_order.shape[0]


def _pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 key ordering lexicographically by (hi, lo) for int32 inputs."""
    return (hi.to(torch.int64) << 32) + (lo.to(torch.int64) + (1 << 31))


def _stable_argsort(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def build_index(store: EdgeStore, node_capacity: int,
                bias_scale: float = 1.0) -> TemporalIndex:
    """Bulk dual-index reconstruction (paper §2.6: two sorts + linear
    passes). Runs on the store's device."""
    E = store.capacity
    nc = node_capacity
    dev = store.src.device
    n_valid = store.num_edges
    valid = torch.arange(E, dtype=torch.int32, device=dev) < n_valid

    # ---- sort 1: (src, ts) — padding (src == nc, ts == TS_PAD) sorts last
    ns_order64 = _stable_argsort(_pair_key(store.src, store.ts))
    ns_order = ns_order64.to(torch.int32)
    ns_src = store.src[ns_order64]
    ns_dst = store.dst[ns_order64]
    ns_ts = store.ts[ns_order64]

    node_starts = torch.searchsorted(
        ns_src, torch.arange(nc + 2, dtype=torch.int32, device=dev),
        side="left", out_int32=True)

    # G axis: a timestamp group starts wherever src or ts changes. ns_src
    # is sorted, so a node's count is a difference of one running sum.
    prev_src = torch.cat([ns_src.new_full((1,), -1), ns_src[:-1]])
    prev_ts = torch.cat([ns_ts.new_full((1,), -1), ns_ts[:-1]])
    in_range = ns_src < nc
    group_start = ((ns_src != prev_src) | (ns_ts != prev_ts)) & in_range
    run = torch.cat([group_start.new_zeros(1, dtype=torch.int32),
                     torch.cumsum(group_start, 0, dtype=torch.int32)])
    node_group_counts = run[node_starts[1:nc + 1].long()] \
        - run[node_starts[:nc].long()]

    # per-node ts extrema: the first / last entry of each non-empty region
    # (ts ascends inside a region). Empty regions carry what the
    # reference's clipped segment reductions give them: its min sentinel
    # maps to 0; the max of an empty node is the int32-min identity, except
    # for node nc-1, which also receives the masked (-TS_PAD -> 0) padding
    # edges whenever the store is not full. Neither is ever read.
    big = TS_PAD
    a = node_starts[:nc].long()
    b = node_starts[1:nc + 1].long()
    nonempty = b > a
    node_tbase = torch.where(nonempty, ns_ts[a.clamp(max=E - 1)], big)
    empty_max = torch.full((nc,), -big - 1, dtype=torch.int32, device=dev)
    empty_max[nc - 1:] = torch.where(node_starts[nc] < E, -big, -big - 1)
    node_tref = torch.where(nonempty, ns_ts[(b - 1).clamp(min=0)], empty_max)
    node_tbase = torch.where(node_tbase == big, 0, node_tbase).to(torch.int32)
    node_tref = torch.where(node_tref == -big, 0, node_tref).to(torch.int32)

    # ---- weight prefix arrays (linear passes) ----------------------------
    src_c = ns_src.clamp(0, nc - 1).long()
    dt_exp = (ns_ts - node_tref[src_c]).to(torch.float32)
    pexp = weight_prefix(dt_exp, in_range, bias_scale)
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    elem_lin = (ns_ts - node_tbase[src_c] + 1).to(torch.float32)
    plin = torch.cat([zero, torch.cumsum(
        torch.where(in_range, elem_lin, 0.0), 0)])

    # store-level prefixes (start-edge selection over the whole window)
    t_hi = torch.where(n_valid > 0,
                       store.ts[(n_valid.long() - 1).clamp(min=0)], 0)
    t_lo = store.ts[0]
    pexp_store = weight_prefix((store.ts - t_hi).to(torch.float32), valid,
                               bias_scale)
    plin_store = torch.cat([zero, torch.cumsum(
        torch.where(valid, (store.ts - t_lo + 1).to(torch.float32), 0.0),
        0)])

    # ---- sort 2: (src, dst, ts) — adjacency view -------------------------
    by_ts = _stable_argsort(store.ts)
    adj_order64 = by_ts[_stable_argsort(
        _pair_key(store.src[by_ts], store.dst[by_ts]))]
    adj_order = adj_order64.to(torch.int32)
    adj_dst = store.dst[adj_order64]

    return TemporalIndex(
        store=store,
        ns_order=ns_order, ns_src=ns_src, ns_dst=ns_dst, ns_ts=ns_ts,
        node_starts=node_starts, node_group_counts=node_group_counts,
        pexp=pexp, plin=plin,
        node_tref=node_tref, node_tbase=node_tbase,
        pexp_store=pexp_store, plin_store=plin_store,
        adj_order=adj_order, adj_dst=adj_dst,
    )


# ---------------------------------------------------------------------------
# Ranged binary searches (fixed trip count)
# ---------------------------------------------------------------------------


def ranged_search(arr: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  target: torch.Tensor, *, strict: bool) -> torch.Tensor:
    """First index k in [lo, hi) with arr[k] > target (strict) or >= target.

    Vectorized over lo/hi/target; ``arr`` is 1-D. Returns hi if there is
    no such k. Fixed ceil(log2(len(arr)))+1 iterations.
    """
    n = arr.shape[0]
    steps = max(1, math.ceil(math.log2(max(n, 2))) + 1)
    lo = lo.to(torch.int32)
    hi = hi.to(torch.int32)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        v = arr[mid.clamp(0, n - 1).long()]
        pred = (v > target) if strict else (v >= target)
        open_ = lo < hi
        lo, hi = (torch.where(open_ & ~pred, mid + 1, lo),
                  torch.where(open_ & pred, mid, hi))
    return lo


def node_range(index: TemporalIndex, node: torch.Tensor):
    """[a, b) edge region of ``node`` in the node-ts view — O(1)."""
    v = node.clamp(0, index.node_capacity).long()
    return index.node_starts[v], index.node_starts[v + 1]


def temporal_cutoff(index: TemporalIndex, a: torch.Tensor, b: torch.Tensor,
                    t: torch.Tensor) -> torch.Tensor:
    """c = first position in [a, b) with ns_ts > t, so Γ_t(v) = [c, b)."""
    return ranged_search(index.ns_ts, a, b, t, strict=True)
