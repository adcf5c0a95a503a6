"""Baselines the paper compares against, a numpy copy of the JAX
package's ``repro/core/baselines.py``:

* ``TeaStyleSampler`` — a CPU temporal-walk engine in the style of
  TEA/TEA+ [EuroSys'23, TACO'24]: per-node alias tables over exponential
  edge weights built at ingest, with per-hop *rejection* against the
  temporal cutoff and an exact-method fallback (their "hybrid" sampling).
* ``StaticWalker`` — a time-agnostic random walk engine in the style of
  FlowWalker/ThunderRW used for Table 6: timestamps are discarded, hops
  sample uniformly from the full static adjacency, so causal validity of
  its output measures exactly what the paper's §3.10 measures.

They are host engines by design: single-threaded numpy isolates the
algorithmic structure (the paper's Table 5 caveat about differing
execution models), so they are not moved to torch. Given a
``np.random.Generator`` in the same state, they emit the reference's
walks exactly.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def build_alias(probs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vose alias table."""
    n = len(probs)
    scaled = probs * n / probs.sum()
    small = [i for i, p in enumerate(scaled) if p < 1.0]
    large = [i for i, p in enumerate(scaled) if p >= 1.0]
    prob = np.zeros(n)
    alias = np.zeros(n, np.int64)
    while small and large:
        s = small.pop()
        l = large.pop()  # noqa: E741
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    for i in large + small:
        prob[i] = 1.0
    return prob, alias


def alias_draw(prob, alias, rng) -> int:
    i = rng.integers(0, len(prob))
    return i if rng.random() < prob[i] else alias[i]


def _weights(t: np.ndarray, bias: str) -> np.ndarray:
    if bias == "exponential":
        return np.exp(t - t.max())
    if bias == "linear":
        return t - t.min() + 1.0
    return np.ones_like(t)


class TeaStyleSampler:
    def __init__(self, src, dst, ts, num_nodes: int,
                 bias: str = "exponential"):
        order = np.lexsort((ts, src))
        self.src = src[order]
        self.dst = dst[order]
        self.ts = ts[order]
        self.starts = np.searchsorted(self.src, np.arange(num_nodes + 1))
        self.num_nodes = num_nodes
        self.bias = bias
        self.alias = {}
        for v in range(num_nodes):
            a, b = self.starts[v], self.starts[v + 1]
            if b > a:
                w = _weights(self.ts[a:b].astype(np.float64), bias)
                self.alias[v] = build_alias(np.maximum(w, 1e-30))

    def _exact_pick(self, v, t, rng):
        a, b = self.starts[v], self.starts[v + 1]
        c = a + np.searchsorted(self.ts[a:b], t, side="right")
        if c >= b:
            return -1
        w = _weights(self.ts[c:b].astype(np.float64), self.bias)
        p = w / w.sum()
        return c + rng.choice(len(p), p=p)

    def walk(self, start: int, t0: int, length: int, rng,
             p: float = 1.0, q: float = 1.0):
        """Hybrid alias+rejection temporal walk; optional node2vec β."""
        nodes = [start]
        times = [t0]
        v, t = start, t0
        prev = -1
        for _ in range(length):
            if v not in self.alias:
                break
            a = self.starts[v]
            prob, alias = self.alias[v]
            k = -1
            for _try in range(8):            # rejection rounds
                cand = a + alias_draw(prob, alias, rng)
                if self.ts[cand] > t:
                    if p != 1.0 or q != 1.0:
                        w = self.dst[cand]
                        if w == prev:
                            beta = 1.0 / p
                        else:
                            # adjacency probe (unsorted dst -> linear scan)
                            adj = (prev >= 0 and w in
                                   self.dst[self.starts[prev]:
                                            self.starts[prev + 1]])
                            beta = 1.0 if adj else 1.0 / q
                        bmax = max(1.0 / p, 1.0, 1.0 / q)
                        if rng.random() * bmax > beta:
                            continue
                    k = cand
                    break
            if k < 0:
                k = self._exact_pick(v, t, rng)   # exact fallback
            if k < 0:
                break
            prev = v
            v = int(self.dst[k])
            t = int(self.ts[k])
            nodes.append(v)
            times.append(t)
        return nodes, times


class StaticWalker:
    """Time-agnostic walker (FlowWalker/ThunderRW abstraction level)."""

    def __init__(self, src, dst, ts, num_nodes: int):
        order = np.argsort(src)
        self.src = src[order]
        self.dst = dst[order]
        self.ts = ts[order]                 # kept only for post-hoc validity
        self.starts = np.searchsorted(self.src, np.arange(num_nodes + 1))
        self.num_nodes = num_nodes

    def walk(self, start: int, length: int, rng):
        nodes = [start]
        times = []
        v = start
        for _ in range(length):
            a, b = self.starts[v], self.starts[v + 1]
            if b <= a:
                break
            k = rng.integers(a, b)
            v = int(self.dst[k])
            nodes.append(v)
            times.append(int(self.ts[k]))   # timestamp it happens to carry
        return nodes, times


def temporal_validity(nodes, times) -> Tuple[int, int, bool]:
    """(valid_hops, total_hops, walk_valid) under strict monotonicity.

    Mirrors the paper's §3.10 post-processing: a greedy earliest-feasible
    timestamp assignment — since each hop carries the timestamp of the
    edge actually traversed, strict increase is the feasibility test.
    """
    total = len(times)
    if total == 0:
        return 0, 0, False
    valid = 0
    prev = -np.inf
    ok = True
    for t in times:
        if t > prev:
            valid += 1
        else:
            ok = False
        prev = t
    return valid, total, ok
