"""Synthetic temporal graph generation (a copy of the JAX package's
``repro/data/synthetic.py``; the draws in numpy, the lookups and the
sort in torch).

Power-law (hub-skewed) degree distributions model the paper's datasets
(§2.4.1: "on hub-skewed temporal graphs this redundancy dominates");
the ``skew`` knob moves mass onto hubs to exercise the dispatch plane's
mega-hub column.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TemporalGraph(NamedTuple):
    src: np.ndarray
    dst: np.ndarray
    ts: np.ndarray
    num_nodes: int


def powerlaw_temporal_graph(num_nodes: int, num_edges: int, *,
                            skew: float = 1.2, t_max: int = 10_000,
                            seed: int = 0, ts_groups: int | None = None,
                            self_loops: bool = False,
                            device="cpu") -> TemporalGraph:
    """Edges with Zipf-ish endpoints and uniform timestamps in [0, t_max].

    ``ts_groups`` quantizes timestamps onto that many distinct values,
    reproducing the paper's high-frequency regime where "many events
    concentrate into each millisecond timestamp" (§3.3).

    The endpoints' inverse-CDF lookups and the stable sort by time run in
    torch on ``device`` (a large graph's on the card), on the reference's
    draws: numpy's ``Generator.choice(n, p=probs)`` is
    ``cdf.searchsorted(random(size), side="right")`` with ``cdf =
    cumsum(probs) / cumsum(probs)[-1]``, and a stable sort has one order,
    so the graph is the reference's bit for bit. The arrays come back as
    numpy.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    probs = ranks ** (-skew)
    probs /= probs.sum()
    cdf = probs.cumsum()
    cdf /= cdf[-1]
    cdf_t = torch.from_numpy(cdf).to(device)
    src, dst = (torch.searchsorted(
        cdf_t, torch.from_numpy(rng.random(num_edges)).to(device),
        right=True).to(torch.int32).cpu().numpy() for _ in range(2))
    if not self_loops:
        loops = src == dst
        dst[loops] = (dst[loops] + 1) % num_nodes
    ts = rng.integers(0, t_max + 1, size=num_edges).astype(np.int32)
    if ts_groups is not None:
        step = max(t_max // ts_groups, 1)
        ts = (ts // step) * step
    order = torch.sort(torch.from_numpy(ts).to(device),
                       stable=True).indices.cpu().numpy()
    return TemporalGraph(src[order], dst[order], ts[order].astype(np.int32),
                         num_nodes)


def chronological_batches(g: TemporalGraph, num_batches: int):
    """Split a temporal graph into chronological batches (paper §3.3)."""
    n = g.src.shape[0]
    bounds = np.linspace(0, n, num_batches + 1).astype(np.int64)
    for i in range(num_batches):
        s, e = bounds[i], bounds[i + 1]
        yield g.src[s:e], g.dst[s:e], g.ts[s:e]
