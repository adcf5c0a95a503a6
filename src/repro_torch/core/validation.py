"""Causality validation (paper §3.10), PyTorch port of core/validation.py.

For every emitted walk: **hop validity** — each hop (u -> v at time t) is
a real edge (u, v, t) of the active window and timestamps strictly
increase (the first hop of an edges-start walk repeats the start edge's
time) — and **walk validity** — all hops of the walk are valid.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.temporal_index import TemporalIndex, ranged_search
from repro_torch.core.walk_engine import WalkResult

_ROWS = 1 << 15           # walks validated per chunk (bounds temporaries)


class ValidityReport(NamedTuple):
    hop_valid_frac: float
    walk_valid_frac: float
    num_hops: int
    num_walks: int


def _edge_exists(index: TemporalIndex, adj_ts: torch.Tensor, u, v, t):
    """Membership of the exact triple (u, v, t) via the adjacency view."""
    E = index.edge_capacity
    node = u.clamp(0, index.node_capacity).long()
    a = index.node_starts[node]
    b = index.node_starts[node + 1]
    lo = ranged_search(index.adj_dst, a, b, v, strict=False)
    hi = ranged_search(index.adj_dst, a, b, v, strict=True)
    k = ranged_search(adj_ts, lo, hi, t, strict=False).clamp(0, E - 1).long()
    return (k < hi) & (adj_ts[k] == t) & (index.adj_dst[k] == v)


def validate_walks(index: TemporalIndex, result: WalkResult
                   ) -> ValidityReport:
    """Hop and walk validity of ``result`` against the window ``index``."""
    adj_ts = index.store.ts[index.adj_order.long()]
    nodes, times, lengths = result.nodes, result.times, result.lengths
    W, Lp1 = nodes.shape
    pos = torch.arange(Lp1 - 1, device=nodes.device)
    n_hops = hop_ok_sum = walk_ok_sum = n_walks = 0
    for r0 in range(0, W, _ROWS):
        nd, tm = nodes[r0:r0 + _ROWS], times[r0:r0 + _ROWS]
        ln = lengths[r0:r0 + _ROWS]
        u, v = nd[:, :-1], nd[:, 1:]
        t_prev, t = tm[:, :-1], tm[:, 1:]
        is_hop = (pos[None, :] + 1) < ln[:, None]
        exists = _edge_exists(index, adj_ts, u, v, t)
        increasing = (t > t_prev) | ((pos[None, :] == 0) & (t == t_prev))
        hop_ok = torch.where(is_hop, exists & increasing, True)
        has_hops = ln > 1
        n_hops += int(is_hop.sum())
        hop_ok_sum += int((hop_ok & is_hop).sum())
        walk_ok_sum += int((hop_ok.all(dim=1) & has_hops).sum())
        n_walks += int(has_hops.sum())
    return ValidityReport(
        hop_valid_frac=hop_ok_sum / max(n_hops, 1),
        walk_valid_frac=walk_ok_sum / max(n_walks, 1),
        num_hops=n_hops, num_walks=n_walks)
