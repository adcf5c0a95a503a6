"""Fused convergence-tiered walk step (paper §2.4.3-§2.4.4, DESIGN.md §14).

One hop for lanes grouped by node: temporal cutoff, per-lane branchless
biased draw (int32 bias code per lane), and the neighbour ``dst``/``ts``
gather. The reference runs it as two Pallas kernels behind a tier split:

* **tier S** — lanes whose region fits the tile's staged ``2·tile_edges``
  panel;
* **tier L** — the rest (hubs), swept block by block.

The tier split is the reference's (kernels/fused_step.py:360-370): each
walk tile is anchored at ``base = clip(min(a)//TE, 0, E//TE − 2)·TE`` and
a lane is tier L when its region leaves ``[base, base + 2·TE)``. The
``tiers`` statistic is computed exactly as the reference computes it,
including the ``bhi − blo + 1`` blocks a tile's tier-L sweep would cover.

On the card ``fused_walk_step`` is one launch of ``fused_hop``
(csrc/fused_step.cu), which serves both tiers and computes the anchors,
the split and ``tiers`` itself. On CPU tensors it runs the plain versions:
``tier_split`` and ``fused_step_plain`` — the tier-free semantics of the
reference oracle kernels/ref.py::fused_step_ref, counting over each lane's
own region in bounded chunks. Both compute identical bits.
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
from repro_torch.core.scheduler import tile_table
from repro_torch.core.temporal_index import TemporalIndex
from repro_torch.kernels import runtime

_P = ctypes.c_void_p
_I = ctypes.c_int
_HOP_ARGS = [_I] + [_P] * 10 + [_I] * 5 + [_P] * 5 + [_P]
_MAX_TILE_WALKS = 1024    # kMaxThreads in csrc/fused_step.cu
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


def region_count(lo: torch.Tensor, hi: torch.Tensor, pred) -> torch.Tensor:
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
    c = a + region_count(a, b, lambda l, p: ns_ts[p] <= time[l])
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
        k_exp = c + region_count(
            c, b, lambda l, p: pexp[p + 1] < target_e[l])
        k_exp = torch.where(total_e > 0, k_exp, fb)
        # linear: S(j) = (PL(j+1) − PL(c)) − (j+1−c)·δ
        delta = (ns_ts[cl.clamp(0, E - 1)] - tbase).to(torch.float32)
        pl_c = plin[cl]
        total_l = (plin[bl] - pl_c) - n.to(torch.float32) * delta
        r = u * total_l
        k_lin = c + region_count(
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


# ---------------------------------------------------------------------------
# Dispatch: tier split and statistics (plain), the hop
# ---------------------------------------------------------------------------


class TierSplit(NamedTuple):
    a: torch.Tensor             # int32[W] global region start
    b: torch.Tensor             # int32[W] global region end
    base_blocks: torch.Tensor   # int32[T] panel anchor block per tile
    big: torch.Tensor           # bool[W] tier-L lanes
    tiers: torch.Tensor         # int32[3]


def tier_split(index: TemporalIndex, s_node: torch.Tensor,
               cfg: SchedulerConfig) -> TierSplit:
    """The reference's tile-anchored tier split and its statistics: the
    plain version of what ``fused_hop`` computes in the kernel."""
    tiles = tile_table(index, s_node, cfg)
    W = s_node.shape[0]
    TW, TE = cfg.tile_walks, cfg.tile_edges
    T, MAXB = W // TW, index.edge_capacity // TE
    a_t, b_t = tiles.a.reshape(T, TW), tiles.b.reshape(T, TW)
    big = tiles.oversize
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
    return TierSplit(a=tiles.a, b=tiles.b, base_blocks=tiles.base_blocks,
                     big=big, tiers=tiers)


def fused_walk_step(index: TemporalIndex, s_node: torch.Tensor,
                    s_time: torch.Tensor, code: torch.Tensor, u: torch.Tensor,
                    mode: str, cfg: SchedulerConfig) -> FusedStepResult:
    """Fused hop for walks sorted by node, with per-lane int32 bias codes.
    Returns global pick positions, neighbourhood sizes, the gathered
    ``dst``/``ts`` and the tier statistics.

    CUDA tensors go to one ``fused_hop`` launch (``s_node``/``s_time``/
    ``code`` int32[W], ``u`` float32[W], contiguous); CPU tensors to
    ``tier_split`` and ``fused_step_plain``."""
    if mode not in ("index", "weight"):
        raise ValueError(f"unknown sampler mode {mode!r}")
    E = index.edge_capacity
    if s_node.device.type == "cpu":
        sp = tier_split(index, s_node, cfg)
        nc = index.node_capacity
        tbase = index.node_tbase[s_node.clamp(0, nc - 1).long()]
        out = fused_step_plain(index.ns_ts[:E], index.ns_dst[:E], index.pexp,
                               index.plin, sp.a, sp.b,
                               s_time.to(torch.int32), code.to(torch.int32),
                               u, tbase, mode=mode)
        return FusedStepResult(*out, tiers=sp.tiers)
    return _launch(index, s_node, s_time, code, u, mode, cfg)


def _launch(index: TemporalIndex, s_node, s_time, code, u, mode: str,
            cfg: SchedulerConfig) -> FusedStepResult:
    """Check the arguments and launch csrc/fused_step.cu once."""
    weight = mode == "weight"
    W, E, nc = s_node.shape[0], index.edge_capacity, index.node_capacity
    TW, TE = cfg.tile_walks, cfg.tile_edges
    dev = s_node.device
    if W % TW or E % TE:
        raise ValueError(f"walks {W} / edges {E} not multiples of tile "
                         f"({TW}, {TE})")
    if E // TE < 2:
        raise ValueError(f"edge capacity {E} must span >= 2 tiles of {TE}")
    if TW > _MAX_TILE_WALKS:
        raise ValueError(f"tile_walks {TW} exceeds {_MAX_TILE_WALKS} "
                         "(one thread per lane of a tile)")
    for name, t in (("s_node", s_node), ("s_time", s_time), ("code", code)):
        runtime.expect(t, name, torch.int32, (W,), dev)
    runtime.expect(u, "u", torch.float32, (W,), dev)
    runtime.expect(index.node_starts, "node_starts", torch.int32, (nc + 2,),
                   dev)
    ns_ts, ns_dst = index.ns_ts[:E], index.ns_dst[:E]
    staged = [("ns_ts", ns_ts), ("ns_dst", ns_dst)]
    for name, t in staged:
        runtime.expect(t, name, torch.int32, (E,), dev)
    if weight:
        runtime.expect(index.node_tbase, "node_tbase", torch.int32, (nc,),
                       dev)
        staged += [("pexp", index.pexp), ("plin", index.plin)]
        for name, t in staged[2:]:
            runtime.expect(t, name, torch.float32, (E + 1,), dev)
    for name, t in staged:     # the bulk copies read 16-byte aligned rows
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    out = torch.empty((4, W), dtype=torch.int32, device=dev)
    tiers = torch.zeros(3, dtype=torch.int32, device=dev)
    if W == 0:
        return FusedStepResult(*out, tiers=tiers)
    fn = runtime.kernel("repro_fused_hop", _HOP_ARGS)
    p = runtime.ptr
    status = fn(int(weight), p(s_node), p(s_time), p(u), p(code),
                p(index.node_starts), p(index.node_tbase if weight else None),
                p(ns_ts), p(ns_dst), p(index.pexp if weight else None),
                p(index.plin if weight else None), W, TW, TE, E, nc,
                *map(p, out), p(tiers), runtime.stream())
    runtime.check(status, "fused_hop")
    runtime.LAUNCHES["fused_hop"] += 1
    return FusedStepResult(*out, tiers=tiers)
