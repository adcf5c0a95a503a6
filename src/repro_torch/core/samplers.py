"""Temporal bias sampling (paper §2.5), PyTorch port of core/samplers.py.

* ``index`` mode — closed-form O(1) inverse CDFs over the ordinal position
  i ∈ [0, n): uniform ⌊u·n⌋, linear (w_i ∝ i+1, paper eq. 2) and
  exponential (w_i ∝ e^i, paper eq. 3, exact below n = 80 and log-domain
  asymptotic above).
* ``weight`` mode — exact inverse transform over the index's prefix arrays
  (``weighted_pick_exp``, ``weighted_pick_linear``), by a binary search
  with the reference's fixed step count.
* temporal node2vec — the second-order bias β(u, w) that the walk engine
  applies by rejection on the first-order proposal, with acceptance
  β/β_max, β_max = max(1/p, 1, 1/q) (``node2vec_beta`` and its lane form).

Every expression keeps the reference's float32 operation order, one
PyTorch op per reference op, so the picks are bit-identical. The square
root is taken in float64 and rounded once to float32, which is the
correctly rounded float32 square root the reference computes (PyTorch's
own float32 CPU square root is not always correctly rounded).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import SamplerConfig
from repro_torch.core.temporal_index import adjacency_contains

_EXP_EXACT_MAX_N = 80.0   # e^n fits float32 comfortably up to ~88

BIAS_UNIFORM = 0
BIAS_LINEAR = 1
BIAS_EXPONENTIAL = 2
BIAS_TABLE = 3

BIAS_CODES = {
    "uniform": BIAS_UNIFORM,
    "linear": BIAS_LINEAR,
    "exponential": BIAS_EXPONENTIAL,
    "table": BIAS_TABLE,
}


def bias_code(bias: str) -> int:
    """Map a bias name to its per-lane dispatch code."""
    try:
        return BIAS_CODES[bias]
    except KeyError:
        raise ValueError(f"unknown bias {bias!r} "
                         f"(expected one of {sorted(BIAS_CODES)})") from None


def _clip_pick(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """clip(i, 0, max(n - 1, 0)) as int32."""
    return torch.minimum(i.clamp(min=0), (n - 1).clamp(min=0)).to(torch.int32)


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def index_uniform(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    nf = n.to(torch.float32)
    return _clip_pick(torch.floor(u * nf).to(torch.int32), n)


def index_linear(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Inverse CDF for w_i ∝ (i+1), with the one-step boundary correction."""
    nf = n.to(torch.float32)
    i = torch.floor((-1.0 + _sqrt_f32(1.0 + 4.0 * u * nf * (nf + 1.0)))
                    / 2.0).to(torch.int32)
    target = u * nf * (nf + 1.0)
    if_ = i.to(torch.float32)
    i = torch.where(if_ * (if_ + 1.0) >= target, i - 1, i)
    if2 = i.to(torch.float32)
    i = torch.where((if2 + 1.0) * (if2 + 2.0) < target, i + 1, i)
    return _clip_pick(i, n)


def index_exponential(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Inverse CDF for w_i ∝ e^i (most recent position weighs most)."""
    nf = n.to(torch.float32)
    u = u.clamp(1e-30, 1.0)
    exact = torch.ceil(torch.log(u * torch.expm1(nf) + 1.0)) - 1.0
    asymptotic = torch.ceil(nf + torch.log(u)) - 1.0
    i = torch.where(nf <= _EXP_EXACT_MAX_N, exact, asymptotic)
    return _clip_pick(i.to(torch.int32), n)


_INDEX_SAMPLERS = {
    "uniform": index_uniform,
    "linear": index_linear,
    "exponential": index_exponential,
}


def index_pick(bias: str, u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return _INDEX_SAMPLERS[bias](u, n)


def index_pick_lanes(code: torch.Tensor, u: torch.Tensor,
                     n: torch.Tensor) -> torch.Tensor:
    """Per-lane index sampling: ``code[i]`` selects lane i's inverse CDF."""
    i_uni = index_uniform(u, n)
    i_lin = index_linear(u, n)
    i_exp = index_exponential(u, n)
    return torch.where(code == BIAS_UNIFORM, i_uni,
                       torch.where(code == BIAS_LINEAR, i_lin, i_exp))


def pick_in_neighborhood_lanes(index, code: torch.Tensor, c: torch.Tensor,
                               b: torch.Tensor,
                               u: torch.Tensor) -> torch.Tensor:
    """Per-lane-bias pick of k ∈ [c, b); index-mode closed forms only.
    Valid only where b > c (the caller masks empty neighbourhoods)."""
    return c + index_pick_lanes(code, u, b - c)


def pick_start_edges_lanes(index, code: torch.Tensor,
                           u: torch.Tensor) -> torch.Tensor:
    """Per-lane-bias start-edge sampling over the timestamp view."""
    n = index.num_edges.to(torch.int32).expand(u.shape)
    return index_pick_lanes(code, u, n)


def _shifted_lower_bound(prefix: torch.Tensor, lo: torch.Tensor,
                         hi: torch.Tensor, target: torch.Tensor
                         ) -> torch.Tensor:
    """Smallest k in [lo, hi) with prefix[k+1] >= target (hi if none)."""
    E = prefix.shape[0] - 1
    steps = max(1, math.ceil(math.log2(max(E + 1, 2))) + 1)
    lo = lo.to(torch.int32)
    hi = hi.to(torch.int32)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        pred = prefix[(mid + 1).clamp(0, E).long()] >= target
        open_ = lo < hi
        lo, hi = (torch.where(open_ & ~pred, mid + 1, lo),
                  torch.where(open_ & pred, mid, hi))
    return lo


def weighted_pick_exp(pexp: torch.Tensor, c: torch.Tensor, b: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """Smallest k in [c, b) with pexp[k+1] − pexp[c] ≥ u·(pexp[b] − pexp[c]);
    uniform over [c, b) when the mass underflows to zero."""
    p_c = pexp[c.long()]
    total = pexp[b.long()] - p_c
    target = p_c + u * total
    k = _shifted_lower_bound(pexp, c, b, target)
    fallback = c + index_uniform(u, b - c)
    k = torch.where(total > 0, k, fallback)
    return torch.minimum(torch.maximum(k, c), torch.maximum(b - 1, c))


def weighted_pick_linear(plin: torch.Tensor, ns_ts: torch.Tensor,
                         node_tbase_at: torch.Tensor, c: torch.Tensor,
                         b: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse CDF over w_k = ts_k − ts_c + 1 via the dual-prefix trick:
    S(k) = (plin[k+1] − plin[c]) − (k+1−c)·δ, δ = ts_c − t_base(v),
    searched for the smallest k in [c, b) with S(k) ≥ u·S(b−1); uniform
    over [c, b) when the mass is not positive."""
    E = ns_ts.shape[0]
    cl = c.long()
    ts_c = ns_ts[cl.clamp(0, E - 1)]
    delta = (ts_c - node_tbase_at).to(torch.float32)
    pl_c = plin[cl]
    total = (plin[b.long()] - pl_c) - (b - c).to(torch.float32) * delta
    r = u * total
    steps = max(1, math.ceil(math.log2(max(E + 1, 2))) + 1)
    lo = c.to(torch.int32)
    hi = b.to(torch.int32)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        s_mid = (plin[(mid + 1).clamp(0, E).long()] - pl_c) \
            - (mid + 1 - c).to(torch.float32) * delta
        pred = s_mid >= r
        open_ = lo < hi
        lo, hi = (torch.where(open_ & ~pred, mid + 1, lo),
                  torch.where(open_ & pred, mid, hi))
    k = torch.where(total > 0, lo, c + index_uniform(u, b - c))
    return torch.minimum(torch.maximum(k, c), torch.maximum(b - 1, c))


def pick_in_neighborhood(index, cfg: SamplerConfig, c: torch.Tensor,
                         b: torch.Tensor, u: torch.Tensor,
                         node: torch.Tensor) -> torch.Tensor:
    """Pick a position k ∈ [c, b) under the configured bias. Valid only
    where b > c (the caller masks empty neighbourhoods)."""
    n = b - c
    if cfg.mode == "index":
        return c + index_pick(cfg.bias, u, n)
    if cfg.mode == "weight":
        if cfg.bias == "uniform":
            return c + index_uniform(u, n)
        if cfg.bias == "exponential":
            return weighted_pick_exp(index.pexp, c, b, u)
        if cfg.bias == "linear":
            nc = index.node_capacity
            tbase = index.node_tbase[node.clamp(0, nc - 1).long()]
            return weighted_pick_linear(index.plin, index.ns_ts, tbase, c,
                                        b, u)
        raise ValueError(f"unknown bias {cfg.bias!r}")
    raise ValueError(f"unknown sampler mode {cfg.mode!r}")


def pick_start_edges(index, cfg: SamplerConfig,
                     u: torch.Tensor) -> torch.Tensor:
    """Sample start edges from the timestamp-grouped view (store order)."""
    b = index.num_edges.to(torch.int32).expand(u.shape)
    zero = torch.zeros_like(b)
    n = b
    if cfg.start_bias == "uniform":
        return index_uniform(u, n)
    if cfg.mode == "index":
        return index_pick(cfg.start_bias, u, n)
    if cfg.start_bias == "exponential":
        return weighted_pick_exp(index.pexp_store, zero, b, u)
    if cfg.start_bias == "linear":
        # store-level linear uses t_base = global min ts => delta = 0
        total = index.plin_store[b.long()]
        k = _shifted_lower_bound(index.plin_store, zero, b, u * total)
        return torch.where(total > 0, k, index_uniform(u, n))
    return index_uniform(u, n)


# ---------------------------------------------------------------------------
# Temporal node2vec (second-order bias by rejection, paper §2.5)
# ---------------------------------------------------------------------------


def node2vec_beta(index, prev: torch.Tensor, cand: torch.Tensor, p: float,
                  q: float) -> torch.Tensor:
    """β(u, w): 1/p if w == prev (return), 1 if w is adjacent to prev,
    1/q otherwise; 1/p and 1/q divide in Python double, then round to
    float32, as the reference's weakly typed scalars do."""
    is_return = cand == prev
    is_common = adjacency_contains(index, prev, cand)
    return torch.where(is_return, 1.0 / p,
                       torch.where(is_common, 1.0, 1.0 / q)).to(
                           torch.float32)


def node2vec_max_beta(p: float, q: float) -> float:
    return max(1.0 / p, 1.0, 1.0 / q)


def node2vec_beta_lanes(index, prev: torch.Tensor, cand: torch.Tensor,
                        p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-lane β(u, w) with float32 (p, q) arrays: 1/p and 1/q divide in
    float32."""
    is_return = cand == prev
    is_common = adjacency_contains(index, prev, cand)
    one = torch.ones((), dtype=torch.float32, device=p.device)
    return torch.where(is_return, one / p,
                       torch.where(is_common, one, one / q))


def node2vec_max_beta_lanes(p: torch.Tensor, q: torch.Tensor
                            ) -> torch.Tensor:
    one = torch.ones((), dtype=torch.float32, device=p.device)
    return torch.maximum(torch.maximum(one / p, one), one / q)
