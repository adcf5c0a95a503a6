"""Temporal random-walk engine (paper §2.4), PyTorch port of
core/walk_engine.py for the fused path.

The port runs ``SchedulerConfig(path="fused", regroup="bucket")``: each
hop regroups lanes by current node (the permutation is carried across
hops, DESIGN.md §10), then one fused hop — temporal cutoff, per-lane
biased draw and neighbour gather — runs in the Hopper kernels
(kernels/fused_step.py). Other paths raise "not yet ported".

Random draws are generated in walk order and indexed through the
lane→walk map, with the reference's key schedule: ``split`` into
(start, walk) keys, ``fold_in(walk_key, step)`` per hop and
``uniform(hop_key, (W,))[lane]``. Walks are therefore byte-identical to
the reference's for the same key, on every path of the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as prng
from repro_torch.configs.base import SamplerConfig, SchedulerConfig, WalkConfig
from repro_torch.core import scheduler as sched
from repro_torch.core.samplers import BIAS_CODES, bias_code, pick_start_edges
from repro_torch.core.temporal_index import TemporalIndex
from repro_torch.kernels.fused_step import fused_walk_step

NODE_PAD = -1          # sentinel in emitted walks beyond walk length

_CAP = "unsupported sampler capability: "


def check_capabilities(scfg: SamplerConfig, path: str) -> None:
    """Validate a (sampler config, path) combination for the port, with the
    reference's refusal messages (core/walk_engine.py::check_capabilities).
    Raises ``ValueError`` when refused, ``NotImplementedError`` for a path
    the port does not run yet."""
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
    if path != "fused":
        raise NotImplementedError(
            f"scheduler path {path!r} is not yet ported to PyTorch; the "
            "port runs path='fused'")
    if scfg.bias == "table":
        raise NotImplementedError("bias='table' is not yet ported")


class WalkResult(NamedTuple):
    nodes: torch.Tensor     # int32[W, L+1], NODE_PAD beyond length
    times: torch.Tensor     # int32[W, L+1]
    lengths: torch.Tensor   # int32[W] number of nodes recorded


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


def _bucket_prologue(index: TemporalIndex, sched_cfg: SchedulerConfig,
                     carry: _Carry):
    """Regroup lanes by current node and permute the per-lane state."""
    nc = index.node_capacity
    node_key = torch.where(carry.alive, carry.cur_node, nc + 1)
    pp = sched.bucket_regroup(node_key, carry.cur_time, nc,
                              time_subsort=sched_cfg.regroup_time).long()
    return (carry.lane[pp], carry.cur_node[pp], carry.cur_time[pp],
            carry.prev_node[pp], carry.alive[pp])


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


def _fused_draws(scfg: SamplerConfig, hop_key, order: torch.Tensor):
    """Per-lane (bias code, uniform) in lane order: the draws are made in
    walk order and indexed through ``order``, so they do not depend on the
    lane layout."""
    W = order.shape[0]
    code = torch.full((W,), bias_code(scfg.bias), dtype=torch.int32,
                      device=order.device)
    return code, prng.uniform(hop_key, (W,), order.device)[order.long()]


def _hop_fused_bucket(index, scfg, sched_cfg, carry: _Carry, step: int,
                      hop_key):
    """Bucket-regrouped lanes through the fused kernels (DESIGN.md §14)."""
    lane, s_node, s_time, s_prev, s_alive = _bucket_prologue(
        index, sched_cfg, carry)
    code, u = _fused_draws(scfg, hop_key, lane)
    out = fused_walk_step(index, s_node, s_time, code, u, scfg.mode,
                          sched_cfg)
    has_next = s_alive & (out.n > 0)
    return _advance_lanes(carry, lane, step, s_node, s_time, s_prev,
                          out.dst, out.ts, has_next)


def generate_walks(index: TemporalIndex, key, wcfg: WalkConfig,
                   scfg: SamplerConfig, sched_cfg: SchedulerConfig
                   ) -> WalkResult:
    """Generate ``wcfg.num_walks`` temporal walks of ≤ ``max_length`` hops
    on the index's device. ``key`` is a ``repro_torch.random`` key."""
    check_capabilities(scfg, sched_cfg.path)
    if sched_cfg.regroup != "bucket":
        raise NotImplementedError(
            f"regroup {sched_cfg.regroup!r} is not yet ported to PyTorch; "
            "the port runs regroup='bucket'")
    start_key, walk_key = prng.split(key)
    carry = start_walks(index, wcfg, scfg, start_key)
    edges = wcfg.start_mode == "edges"
    hops = wcfg.max_length - 1 if edges else wcfg.max_length
    for step in range(hops):
        carry = _hop_fused_bucket(index, scfg, sched_cfg, carry,
                                  step + int(edges),
                                  prng.fold_in(walk_key, step))
    return WalkResult(nodes=carry.nodes, times=carry.times,
                      lengths=carry.lengths)
