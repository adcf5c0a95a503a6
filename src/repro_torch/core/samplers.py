"""Temporal bias sampling (paper §2.5), PyTorch port of core/samplers.py.

* ``index`` mode — closed-form O(1) inverse CDFs over the ordinal position
  i ∈ [0, n): uniform ⌊u·n⌋, linear (w_i ∝ i+1, paper eq. 2) and
  exponential (w_i ∝ e^i, paper eq. 3, exact below n = 80 and log-domain
  asymptotic above).
* ``weight`` mode — exact inverse transform over the index's prefix arrays.

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
