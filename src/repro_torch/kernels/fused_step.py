"""Fused convergence-tiered walk step (paper §2.4.3-§2.4.4, DESIGN.md §14).

One hop for lanes grouped by node: temporal cutoff, per-lane branchless
biased draw (int32 bias code per lane), and the neighbour ``dst``/``ts``
gather, in two kernels on the card:

* **tier S** — lanes whose region fits the tile's staged ``2·tile_edges``
  panel (``fused_tier_s``, csrc/fused_step.cu);
* **tier L** — the rest, one thread per lane over its own region
  (``fused_tier_l``).

The tier split is the reference's (kernels/fused_step.py:360-370): each
walk tile is anchored at ``base = clip(min(a)//TE, 0, E//TE − 2)·TE`` and
a lane is tier L when its region leaves ``[base, base + 2·TE)``. The
``tiers`` statistic is computed exactly as the reference computes it,
including the ``bhi − blo + 1`` blocks a tile's tier-L sweep would cover.

Each tier wrapper sends CUDA tensors to its kernel and CPU tensors to the
plain version ``fused_step_plain`` — the tier-free semantics of the
reference oracle kernels/ref.py::fused_step_ref, counting over each
lane's own region in bounded chunks. Both compute identical bits.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.configs.base import SchedulerConfig
from repro_torch.core.samplers import (
    BIAS_LINEAR,
    BIAS_UNIFORM,
    index_pick_lanes,
    index_uniform,
)
from repro_torch.core.temporal_index import TemporalIndex, node_range
from repro_torch.kernels import runtime

_P = ctypes.c_void_p
_I = ctypes.c_int
_TIER_S_ARGS = [_I] + [_P] * 12 + [_I, _I, _I] + [_P] * 4 + [_P]
_TIER_L_ARGS = [_I] + [_P] * 11 + [_I] + [_P] * 4 + [_P]
_CHUNK = 1 << 22          # (lane, position) pairs per plain-version chunk


class FusedStepResult(NamedTuple):
    """Per-lane hop outputs plus the tier split of this dispatch."""

    k: torch.Tensor       # int32[W] global pick position (0 where n <= 0)
    n: torch.Tensor       # int32[W] neighbourhood size |Γ_t(v)|
    dst: torch.Tensor     # int32[W] picked neighbour (0 where n <= 0)
    ts: torch.Tensor      # int32[W] picked edge timestamp (0 where n <= 0)
    tiers: torch.Tensor   # int32[3]: tier-S lanes, tier-L lanes, swept blocks


# ---------------------------------------------------------------------------
# Plain PyTorch version (tier-free)
# ---------------------------------------------------------------------------


def _region_count(lo: torch.Tensor, hi: torch.Tensor, pred) -> torch.Tensor:
    """counts[i] = #{p ∈ [lo_i, hi_i) : pred(i, p)}, over the flattened
    (lane, position) pairs in chunks of at most ``_CHUNK``."""
    length = (hi.long() - lo.long()).clamp(min=0)
    ends = torch.cumsum(length, 0)
    counts = torch.zeros(lo.shape[0], dtype=torch.int64, device=lo.device)
    total = int(ends[-1]) if lo.shape[0] else 0
    for s in range(0, total, _CHUNK):
        idx = torch.arange(s, min(s + _CHUNK, total), device=lo.device)
        lane = torch.searchsorted(ends, idx, right=True)
        pos = lo.long()[lane] + idx - (ends[lane] - length[lane])
        counts.index_add_(0, lane, pred(lane, pos).long())
    return counts.to(torch.int32)


def fused_step_plain(ns_ts, ns_dst, pexp, plin, a, b, time, code, u, tbase,
                     *, mode: str):
    """Tier-free fused hop: returns (k_global, n, dst, ts), dead lanes 0."""
    E = ns_ts.shape[0]
    c = a + _region_count(a, b, lambda l, p: ns_ts[p] <= time[l])
    n = b - c
    if mode == "index":
        k = c + index_pick_lanes(code, u, n)
    elif mode == "weight":
        fb = c + index_uniform(u, n)
        cl, bl = c.long(), b.long()
        # exponential (samplers.weighted_pick_exp expression order)
        pe_c = pexp[cl]
        total_e = pexp[bl] - pe_c
        target_e = pe_c + u * total_e
        k_exp = c + _region_count(
            c, b, lambda l, p: pexp[p + 1] < target_e[l])
        k_exp = torch.where(total_e > 0, k_exp, fb)
        # linear: S(j) = (PL(j+1) − PL(c)) − (j+1−c)·δ
        delta = (ns_ts[cl.clamp(0, E - 1)] - tbase).to(torch.float32)
        pl_c = plin[cl]
        total_l = (plin[bl] - pl_c) - n.to(torch.float32) * delta
        r = u * total_l
        k_lin = c + _region_count(
            c, b, lambda l, p: ((plin[p + 1] - pl_c[l])
                                - (p + 1 - cl[l]).to(torch.float32)
                                * delta[l]) < r[l])
        k_lin = torch.where(total_l > 0, k_lin, fb)
        k = torch.where(code == BIAS_UNIFORM, fb,
                        torch.where(code == BIAS_LINEAR, k_lin, k_exp))
        k = torch.minimum(torch.maximum(k, c), torch.maximum(b - 1, c))
    else:
        raise ValueError(f"unknown sampler mode {mode!r}")
    k = k.clamp(0, E - 1)
    has = n > 0
    k = torch.where(has, k, 0).to(torch.int32)
    kl = k.long()
    return (k, n.to(torch.int32), torch.where(has, ns_dst[kl], 0),
            torch.where(has, ns_ts[kl], 0))


def _plain_into(out, lanes, ns_ts, ns_dst, pexp, plin, a, b, time, code, u,
                tbase, mode):
    """Run the plain version on ``lanes`` and write its rows of ``out``."""
    sub = lambda x: None if x is None else x[lanes]   # noqa: E731
    res = fused_step_plain(ns_ts, ns_dst, pexp, plin, sub(a), sub(b),
                           sub(time), sub(code), sub(u), sub(tbase),
                           mode=mode)
    for o, r in zip(out, res):
        o[lanes] = r


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_lane_inputs(W, dev, a, b, big, time, u, code, tbase, weight):
    for name, t in (("a", a), ("b", b), ("time", time), ("code", code)):
        runtime.expect(t, name, torch.int32, (W,), dev)
    runtime.expect(big, "big", torch.bool, (W,), dev)
    runtime.expect(u, "u", torch.float32, (W,), dev)
    if weight:
        runtime.expect(tbase, "tbase", torch.int32, (W,), dev)


def _check_edge_inputs(E, dev, ns_ts, ns_dst, pexp, plin, weight):
    runtime.expect(ns_ts, "ns_ts", torch.int32, (E,), dev)
    runtime.expect(ns_dst, "ns_dst", torch.int32, (E,), dev)
    if weight:
        runtime.expect(pexp, "pexp", torch.float32, (E + 1,), dev)
        runtime.expect(plin, "plin", torch.float32, (E + 1,), dev)


def fused_tier_s(base_blocks, a, b, big, time, u, code, tbase, ns_ts, ns_dst,
                 pexp, plin, *, mode: str, tile_walks: int, tile_edges: int,
                 out) -> None:
    """Tier-S lanes (``~big``) of one hop, written into ``out`` =
    (k, n, dst, ts). One CTA per tile of ``tile_walks`` lanes stages the
    tile's ``2·tile_edges`` panel, anchored at ``base_blocks[t]``."""
    weight = mode == "weight"
    if a.device.type == "cpu":
        _plain_into(out, ~big, ns_ts, ns_dst, pexp, plin, a, b, time, code,
                    u, tbase, mode)
        return
    W, E, dev = a.shape[0], ns_ts.shape[0], a.device
    _check_lane_inputs(W, dev, a, b, big, time, u, code, tbase, weight)
    _check_edge_inputs(E, dev, ns_ts, ns_dst, pexp, plin, weight)
    runtime.expect(base_blocks, "base_blocks", torch.int32,
                   (W // tile_walks,), dev)
    for i, o in enumerate(out):
        runtime.expect(o, f"out[{i}]", torch.int32, (W,), dev)
    if W == 0:
        return
    fn = runtime.kernel("repro_fused_tier_s", _TIER_S_ARGS)
    p = runtime.ptr
    status = fn(int(weight), p(base_blocks), p(a), p(b), p(big), p(time),
                p(u), p(code), p(tbase if weight else None), p(ns_ts),
                p(ns_dst), p(pexp if weight else None),
                p(plin if weight else None), W, tile_walks, tile_edges,
                *map(p, out), runtime.stream())
    runtime.check(status, "fused_tier_s")
    runtime.LAUNCHES["fused_tier_s"] += 1


def fused_tier_l(a, b, big, time, u, code, tbase, ns_ts, ns_dst, pexp, plin,
                 *, mode: str, out) -> None:
    """Tier-L lanes (``big``) of one hop, written into ``out``: one thread
    per lane over the lane's own region."""
    weight = mode == "weight"
    if a.device.type == "cpu":
        _plain_into(out, big, ns_ts, ns_dst, pexp, plin, a, b, time, code,
                    u, tbase, mode)
        return
    W, E, dev = a.shape[0], ns_ts.shape[0], a.device
    _check_lane_inputs(W, dev, a, b, big, time, u, code, tbase, weight)
    _check_edge_inputs(E, dev, ns_ts, ns_dst, pexp, plin, weight)
    for i, o in enumerate(out):
        runtime.expect(o, f"out[{i}]", torch.int32, (W,), dev)
    if W == 0:
        return
    fn = runtime.kernel("repro_fused_tier_l", _TIER_L_ARGS)
    p = runtime.ptr
    status = fn(int(weight), p(a), p(b), p(big), p(time), p(u), p(code),
                p(tbase if weight else None), p(ns_ts), p(ns_dst),
                p(pexp if weight else None), p(plin if weight else None), W,
                *map(p, out), runtime.stream())
    runtime.check(status, "fused_tier_l")
    runtime.LAUNCHES["fused_tier_l"] += 1


# ---------------------------------------------------------------------------
# Dispatch: tier split, both tiers, statistics
# ---------------------------------------------------------------------------


class TierSplit(NamedTuple):
    a: torch.Tensor             # int32[W] global region start
    b: torch.Tensor             # int32[W] global region end
    base_blocks: torch.Tensor   # int32[T] panel anchor block per tile
    big: torch.Tensor           # bool[W] tier-L lanes
    tiers: torch.Tensor         # int32[3]


def tier_split(index: TemporalIndex, s_node: torch.Tensor,
               cfg: SchedulerConfig) -> TierSplit:
    """The reference's tile-anchored tier split and its statistics."""
    W = s_node.shape[0]
    E = index.edge_capacity
    TW, TE = cfg.tile_walks, cfg.tile_edges
    if W % TW or E % TE:
        raise ValueError(f"walks {W} / edges {E} not multiples of tile "
                         f"({TW}, {TE})")
    if E // TE < 2:
        raise ValueError(f"edge capacity {E} must span >= 2 tiles of {TE}")
    T, MAXB = W // TW, E // TE
    a, b = node_range(index, s_node)
    a_t, b_t = a.reshape(T, TW), b.reshape(T, TW)
    base_blocks = (a_t.amin(dim=1) // TE).clamp(0, MAXB - 2).to(torch.int32)
    base = (base_blocks * TE)[:, None]
    big = ((a_t - base < 0) | (b_t - base > 2 * TE)).reshape(W)

    ab_blk = a_t // TE
    bb_blk = torch.maximum(b_t - 1, a_t) // TE
    big_t = big.reshape(T, TW)
    has_big = big_t.any(dim=1)
    blo = torch.where(has_big,
                      torch.where(big_t, ab_blk, MAXB - 1).amin(dim=1), 0)
    bhi = torch.where(has_big, torch.where(big_t, bb_blk, 0).amax(dim=1), 0)
    bhi = torch.maximum(bhi, blo)
    n_big = big.sum(dtype=torch.int32)
    tiers = torch.stack([W - n_big, n_big,
                         torch.where(has_big, bhi - blo + 1, 0)
                         .sum(dtype=torch.int32)]).to(torch.int32)
    return TierSplit(a=a, b=b, base_blocks=base_blocks, big=big, tiers=tiers)


def fused_walk_step(index: TemporalIndex, s_node: torch.Tensor,
                    s_time: torch.Tensor, code: torch.Tensor, u: torch.Tensor,
                    mode: str, cfg: SchedulerConfig) -> FusedStepResult:
    """Fused hop for walks sorted by node, with per-lane int32 bias codes.
    Returns global pick positions, neighbourhood sizes, the gathered
    ``dst``/``ts`` and the tier statistics."""
    if mode not in ("index", "weight"):
        raise ValueError(f"unknown sampler mode {mode!r}")
    sp = tier_split(index, s_node, cfg)
    W = s_node.shape[0]
    E = index.edge_capacity
    nc = index.node_capacity
    dev = s_node.device
    tbase = index.node_tbase[s_node.clamp(0, nc - 1).long()]
    out = tuple(torch.empty(W, dtype=torch.int32, device=dev)
                for _ in range(4))
    ns_ts, ns_dst = index.ns_ts[:E], index.ns_dst[:E]
    s_time = s_time.to(torch.int32).contiguous()
    code = code.to(torch.int32).contiguous()
    u = u.contiguous()
    fused_tier_s(sp.base_blocks, sp.a, sp.b, sp.big, s_time, u, code, tbase,
                 ns_ts, ns_dst, index.pexp, index.plin, mode=mode,
                 tile_walks=cfg.tile_walks, tile_edges=cfg.tile_edges,
                 out=out)
    fused_tier_l(sp.a, sp.b, sp.big, s_time, u, code, tbase, ns_ts, ns_dst,
                 index.pexp, index.plin, mode=mode, out=out)
    return FusedStepResult(*out, tiers=sp.tiers)
