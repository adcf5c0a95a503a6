"""Temporal random-walk engine (paper §2.4), PyTorch port of
core/walk_engine.py for first-order walks.

Execution paths (``SchedulerConfig.path``), as in the reference:

* ``fullwalk`` — every walk advances independently, in walk order.
* ``grouped`` — each hop regroups lanes by (node, time); equal runs share
  one temporal cutoff, computed at the run's head.
* ``tiled`` — grouped lanes, with the hop's search and sample in one
  launch of the ``walk_step_tiled`` kernel (kernels/ops.py), which serves
  oversize lanes through the reference's global fallback.
* ``fused`` — grouped lanes, with the whole hop in the fused kernels
  (kernels/fused_step.py).

The regroup (``SchedulerConfig.regroup``) is ``bucket`` — the permutation
is carried across hops (DESIGN.md §10) — or ``lexsort``, a fresh stable
sort by (node, time) and its inverse every hop.

Random draws are generated in walk order and indexed through the
lane→walk map, with the reference's key schedule: ``split`` into
(start, walk) keys, ``fold_in(walk_key, step)`` per hop and
``uniform(hop_key, (W,))[lane]``. Walks are therefore byte-identical to
the reference's for the same key, on every path of the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import random as prng
from repro_torch.configs.base import SamplerConfig, SchedulerConfig, WalkConfig
from repro_torch.core import scheduler as sched
from repro_torch.core.samplers import (
    BIAS_CODES,
    bias_code,
    pick_in_neighborhood,
    pick_start_edges,
)
from repro_torch.core.temporal_index import (
    TemporalIndex,
    pair_key,
    node_range,
    temporal_cutoff,
)
from repro_torch.kernels.fused_step import fused_walk_step
from repro_torch.kernels.ops import walk_step

NODE_PAD = -1          # sentinel in emitted walks beyond walk length

_CAP = "unsupported sampler capability: "


def check_capabilities(scfg: SamplerConfig, path: str) -> None:
    """Validate a (sampler config, path) combination for the port, with the
    reference's refusal messages (core/walk_engine.py::check_capabilities).
    Raises ``ValueError`` when refused, ``NotImplementedError`` for what
    the port does not run yet: alias tables and node2vec."""
    if scfg.bias not in BIAS_CODES:
        raise ValueError(
            _CAP + f"unknown bias {scfg.bias!r} "
            f"(expected one of {sorted(BIAS_CODES)})")
    if scfg.start_bias == "table" or scfg.start_bias not in BIAS_CODES:
        raise ValueError(
            _CAP + f"start-edge bias {scfg.start_bias!r} is not supported; "
            "start draws use the closed forms 'uniform'|'linear'|"
            "'exponential' (alias tables cover neighborhood regions, not "
            "the timestamp view)")
    if scfg.bias == "table":
        if scfg.mode != "index":
            raise ValueError(
                _CAP + "bias='table' requires SamplerConfig.mode='index' "
                f"(the alias draw replaces the mode dispatch; got "
                f"mode={scfg.mode!r})")
        if path in ("tiled", "fused"):
            raise ValueError(
                _CAP + f"path={path!r} does not support bias='table' (the "
                "Pallas kernels dispatch the closed-form inverse CDFs "
                "only); use 'fullwalk'|'grouped'")
    if scfg.node2vec_p != 1.0 or scfg.node2vec_q != 1.0:
        if path == "fused":
            raise ValueError(
                _CAP + "path='fused' does not support node2vec "
                "second-order bias (the rejection loop re-draws outside "
                "the kernel); use 'fullwalk'|'grouped'")
        if path == "tiled":
            raise ValueError(
                _CAP + "path='tiled' does not support node2vec "
                "second-order bias (the walk-step kernel draws first-"
                "order only); use 'fullwalk'|'grouped'")
    if scfg.bias == "table":
        raise NotImplementedError(
            "bias='table' (alias tables) is not yet ported to PyTorch")
    if scfg.node2vec_p != 1.0 or scfg.node2vec_q != 1.0:
        raise NotImplementedError(
            "node2vec second-order bias is not yet ported to PyTorch")


class WalkResult(NamedTuple):
    nodes: torch.Tensor     # int32[W, L+1], NODE_PAD beyond length
    times: torch.Tensor     # int32[W, L+1]
    lengths: torch.Tensor   # int32[W] number of nodes recorded
    stats: Optional[torch.Tensor] = None   # float32[hops, NUM_STATS]


class _Carry(NamedTuple):
    # cur_node/cur_time/prev_node/alive are in *lane* order; ``lane`` maps
    # lane -> walk id. nodes/times/lengths stay in walk order.
    cur_node: torch.Tensor
    cur_time: torch.Tensor
    prev_node: torch.Tensor
    alive: torch.Tensor
    lane: torch.Tensor
    nodes: torch.Tensor
    times: torch.Tensor
    lengths: torch.Tensor


def start_walks(index: TemporalIndex, wcfg: WalkConfig, scfg: SamplerConfig,
                key) -> _Carry:
    """Walk starts for start modes ``nodes``, ``edges`` and ``all_nodes``."""
    W, L = wcfg.num_walks, wcfg.max_length
    dev = index.ns_ts.device
    i32 = dict(dtype=torch.int32, device=dev)
    nodes = torch.full((W, L + 1), NODE_PAD, **i32)
    times = torch.full((W, L + 1), NODE_PAD, **i32)
    lane = torch.arange(W, **i32)
    nc = index.node_capacity
    t_floor = torch.where(index.num_edges > 0, index.store.ts[0] - 1, 0)
    no_prev = torch.full((W,), -1, **i32)

    if wcfg.start_mode == "edges":
        u = prng.uniform(key, (W,), dev)
        e = pick_start_edges(index, scfg, u).clamp(0, index.edge_capacity - 1)
        e = e.long()
        src = index.store.src[e]
        cur = index.store.dst[e]
        cur_time = index.store.ts[e]
        alive = (index.num_edges > 0).expand(W)
        nodes[:, 0] = torch.where(alive, src, NODE_PAD)
        times[:, 0] = torch.where(alive, cur_time, NODE_PAD)
        nodes[:, 1] = torch.where(alive, cur, NODE_PAD)
        times[:, 1] = torch.where(alive, cur_time, NODE_PAD)
        return _Carry(cur, cur_time, src, alive, lane, nodes, times,
                      torch.where(alive, 2, 0).to(torch.int32))
    if wcfg.start_mode == "all_nodes":
        cur = torch.arange(W, **i32) % nc
        cl = cur.long()
        alive = (index.node_starts[cl + 1] - index.node_starts[cl]) > 0
    elif wcfg.start_mode == "nodes":
        # uniform over active nodes via cumulative-count inversion
        deg = index.node_starts[1:nc + 1] - index.node_starts[:nc]
        cum = torch.cumsum((deg > 0).to(torch.int32), 0, dtype=torch.int32)
        num_active = cum[-1]
        u = prng.uniform(key, (W,), dev)
        j = torch.floor(u * num_active.to(torch.float32)).to(torch.int32)
        j = torch.minimum(j.clamp(min=0), (num_active - 1).clamp(min=0))
        cur = torch.searchsorted(cum, j, side="right", out_int32=True)
        alive = (num_active > 0).expand(W)
    else:
        raise ValueError(f"unknown start_mode {wcfg.start_mode!r}")
    cur_time = t_floor.to(torch.int32).expand(W)
    nodes[:, 0] = torch.where(alive, cur, NODE_PAD)
    times[:, 0] = torch.where(alive, cur_time, NODE_PAD)
    return _Carry(cur, cur_time, no_prev, alive, lane, nodes, times,
                  alive.to(torch.int32))


# ---------------------------------------------------------------------------
# Layouts: fullwalk, lexsort, bucket
# ---------------------------------------------------------------------------


def _segment_cutoff(index: TemporalIndex, s_node, s_time):
    """(b, c) for lanes grouped by (node, time): Γ_t(v) = [c, b). Segment
    heads are re-derived from the order — contiguous equal (node, time)
    runs share the cutoff computed at their head — so any permutation is
    correct."""
    W = s_node.shape[0]
    pad = s_node.new_full((1,), -2)
    head = (s_node != torch.cat([pad, s_node[:-1]])) \
        | (s_time != torch.cat([pad, s_time[:-1]]))
    seg_id = torch.cumsum(head.to(torch.int32), 0) - 1
    a, b = node_range(index, s_node)
    c_head = temporal_cutoff(index, a, b, s_time)
    c = torch.zeros(W, dtype=torch.int32, device=s_node.device).scatter_reduce(
        0, seg_id.long(), torch.where(head, c_head, 0), "amax")
    return b, c[seg_id.long()]


def _lexsort_prologue(index: TemporalIndex, carry: _Carry):
    """``jnp.lexsort((cur_time, node_key))``: the stable order by (node,
    time), dead lanes last. Returns the permutation and the permuted
    per-lane state."""
    node_key = torch.where(carry.alive, carry.cur_node,
                           index.node_capacity + 1)
    perm = torch.sort(pair_key(node_key, carry.cur_time),
                      stable=True).indices
    return (perm, carry.cur_node[perm], carry.cur_time[perm],
            carry.prev_node[perm], carry.alive[perm])


def _unsort(perm: torch.Tensor, *xs):
    """Lane-order arrays back in walk order."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return tuple(x[inv] for x in xs)


def _bucket_prologue(index: TemporalIndex, sched_cfg: SchedulerConfig,
                     carry: _Carry):
    """Regroup lanes by current node and permute the per-lane state."""
    nc = index.node_capacity
    node_key = torch.where(carry.alive, carry.cur_node, nc + 1)
    pp = sched.bucket_regroup(node_key, carry.cur_time, nc,
                              time_subsort=sched_cfg.regroup_time).long()
    return (carry.lane[pp], carry.cur_node[pp], carry.cur_time[pp],
            carry.prev_node[pp], carry.alive[pp])


def _advance(carry: _Carry, step: int, next_node, next_time,
             has_next) -> _Carry:
    """Advance with lanes in walk order (fullwalk / lexsort layouts)."""
    carry.nodes[:, step + 1] = torch.where(has_next, next_node, NODE_PAD)
    carry.times[:, step + 1] = torch.where(has_next, next_time, NODE_PAD)
    return carry._replace(
        cur_node=torch.where(has_next, next_node, carry.cur_node),
        cur_time=torch.where(has_next, next_time, carry.cur_time),
        prev_node=torch.where(has_next, carry.cur_node, carry.prev_node),
        alive=has_next,
        lengths=carry.lengths + has_next.to(torch.int32))


def _advance_lanes(carry: _Carry, lane, step: int, s_node, s_time, s_prev,
                   next_node, next_time, has_next) -> _Carry:
    """Advance with lanes in grouped order; walk rows scatter via lane."""
    li = lane.long()
    nodes, times = carry.nodes, carry.times
    nodes[li, step + 1] = torch.where(has_next, next_node, NODE_PAD)
    times[li, step + 1] = torch.where(has_next, next_time, NODE_PAD)
    lengths = carry.lengths.index_add(0, li, has_next.to(torch.int32))
    return _Carry(
        cur_node=torch.where(has_next, next_node, s_node),
        cur_time=torch.where(has_next, next_time, s_time),
        prev_node=torch.where(has_next, s_node, s_prev),
        alive=has_next, lane=lane, nodes=nodes, times=times,
        lengths=lengths)


# ---------------------------------------------------------------------------
# One hop per (path, regroup)
# ---------------------------------------------------------------------------


def _draws(hop_key, order: torch.Tensor) -> torch.Tensor:
    """Per-lane uniforms in lane order: drawn in walk order and indexed
    through ``order``, so they do not depend on the lane layout."""
    return prng.uniform(hop_key, (order.shape[0],), order.device)[
        order.long()]


def _gather(index: TemporalIndex, k: torch.Tensor):
    k = k.clamp(0, index.edge_capacity - 1).long()
    return index.ns_dst[k], index.ns_ts[k]


def _hop_fullwalk(index, scfg, sched_cfg, carry: _Carry, step: int,
                  hop_key) -> _Carry:
    """Every walk advances on its own, in walk order."""
    a, b = node_range(index, carry.cur_node)
    c = temporal_cutoff(index, a, b, carry.cur_time)
    u = prng.uniform(hop_key, (carry.cur_node.shape[0],),
                     carry.cur_node.device)
    k = pick_in_neighborhood(index, scfg, c, b, u, carry.cur_node)
    return _advance(carry, step, *_gather(index, k),
                    carry.alive & (b - c > 0))


def _hop_grouped(index, scfg, sched_cfg, carry: _Carry, step: int,
                 hop_key) -> _Carry:
    """Fresh stable sort by (node, time) + inverse, shared cutoffs."""
    perm, s_node, s_time, _, s_alive = _lexsort_prologue(index, carry)
    b, c = _segment_cutoff(index, s_node, s_time)
    k = pick_in_neighborhood(index, scfg, c, b, _draws(hop_key, perm), s_node)
    nn, nt = _gather(index, k)
    return _advance(carry, step, *_unsort(perm, nn, nt,
                                          s_alive & (b - c > 0)))


def _hop_grouped_bucket(index, scfg, sched_cfg, carry: _Carry, step: int,
                        hop_key) -> _Carry:
    """Carried bucket regroup, shared cutoffs (the reference's default)."""
    lane, s_node, s_time, s_prev, s_alive = _bucket_prologue(
        index, sched_cfg, carry)
    b, c = _segment_cutoff(index, s_node, s_time)
    k = pick_in_neighborhood(index, scfg, c, b, _draws(hop_key, lane), s_node)
    nn, nt = _gather(index, k)
    return _advance_lanes(carry, lane, step, s_node, s_time, s_prev, nn, nt,
                          s_alive & (b - c > 0))


def _hop_tiled(index, scfg, sched_cfg, carry: _Carry, step: int,
               hop_key) -> _Carry:
    """Lexsort layout with the ``walk_step_tiled`` kernel."""
    perm, s_node, s_time, _, s_alive = _lexsort_prologue(index, carry)
    k, n = walk_step(index, s_node, s_time, _draws(hop_key, perm), scfg,
                     sched_cfg)
    nn, nt = _gather(index, k)
    return _advance(carry, step, *_unsort(perm, nn, nt, s_alive & (n > 0)))


def _hop_tiled_bucket(index, scfg, sched_cfg, carry: _Carry, step: int,
                      hop_key) -> _Carry:
    """Bucket layout with the ``walk_step_tiled`` kernel."""
    lane, s_node, s_time, s_prev, s_alive = _bucket_prologue(
        index, sched_cfg, carry)
    k, n = walk_step(index, s_node, s_time, _draws(hop_key, lane), scfg,
                     sched_cfg)
    nn, nt = _gather(index, k)
    return _advance_lanes(carry, lane, step, s_node, s_time, s_prev, nn, nt,
                          s_alive & (n > 0))


def _fused_codes(scfg: SamplerConfig, hop_key, order: torch.Tensor):
    """Per-lane (bias code, uniform) in lane order for the fused kernels."""
    code = torch.full((order.shape[0],), bias_code(scfg.bias),
                      dtype=torch.int32, device=order.device)
    return code, _draws(hop_key, order)


def _hop_fused(index, scfg, sched_cfg, carry: _Carry, step: int,
               hop_key) -> _Carry:
    """Lexsort layout through the fused kernels."""
    perm, s_node, s_time, _, s_alive = _lexsort_prologue(index, carry)
    code, u = _fused_codes(scfg, hop_key, perm)
    out = fused_walk_step(index, s_node, s_time, code, u, scfg.mode,
                          sched_cfg)
    return _advance(carry, step, *_unsort(perm, out.dst, out.ts,
                                          s_alive & (out.n > 0)))


def _hop_fused_bucket(index, scfg, sched_cfg, carry: _Carry, step: int,
                      hop_key) -> _Carry:
    """Bucket layout through the fused kernels (DESIGN.md §14)."""
    lane, s_node, s_time, s_prev, s_alive = _bucket_prologue(
        index, sched_cfg, carry)
    code, u = _fused_codes(scfg, hop_key, lane)
    out = fused_walk_step(index, s_node, s_time, code, u, scfg.mode,
                          sched_cfg)
    return _advance_lanes(carry, lane, step, s_node, s_time, s_prev,
                          out.dst, out.ts, s_alive & (out.n > 0))


# (path, bucket regroup) -> hop; fullwalk has no regroup
HOPS = {
    ("fullwalk", True): _hop_fullwalk,
    ("fullwalk", False): _hop_fullwalk,
    ("grouped", True): _hop_grouped_bucket,
    ("grouped", False): _hop_grouped,
    ("tiled", True): _hop_tiled_bucket,
    ("tiled", False): _hop_tiled,
    ("fused", True): _hop_fused_bucket,
    ("fused", False): _hop_fused,
}


def generate_walks(index: TemporalIndex, key, wcfg: WalkConfig,
                   scfg: SamplerConfig, sched_cfg: SchedulerConfig,
                   collect_stats: bool = False) -> WalkResult:
    """Generate ``wcfg.num_walks`` temporal walks of ≤ ``max_length`` hops
    on the index's device. ``key`` is a ``repro_torch.random`` key. With
    ``collect_stats``, ``WalkResult.stats`` holds ``dispatch_stats`` of
    every hop, float32[hops, NUM_STATS]."""
    check_capabilities(scfg, sched_cfg.path)
    if sched_cfg.regroup not in ("bucket", "lexsort"):
        raise ValueError(f"unknown regroup {sched_cfg.regroup!r}")
    try:
        hop = HOPS[sched_cfg.path, sched_cfg.regroup == "bucket"]
    except KeyError:
        raise ValueError(
            f"unknown scheduler path {sched_cfg.path!r}") from None
    start_key, walk_key = prng.split(key)
    carry = start_walks(index, wcfg, scfg, start_key)
    edges = wcfg.start_mode == "edges"
    hops = wcfg.max_length - 1 if edges else wcfg.max_length
    stats = []
    for step in range(hops):
        if collect_stats:
            stats.append(sched.dispatch_stats(index, carry.cur_node,
                                              carry.alive, sched_cfg))
        carry = hop(index, scfg, sched_cfg, carry, step + int(edges),
                    prng.fold_in(walk_key, step))
    if collect_stats:
        stats = torch.stack(stats) if stats else torch.zeros(
            (0, sched.NUM_STATS), dtype=torch.float32,
            device=index.ns_ts.device)
    return WalkResult(nodes=carry.nodes, times=carry.times,
                      lengths=carry.lengths,
                      stats=stats if collect_stats else None)
