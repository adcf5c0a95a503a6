"""Temporal random-walk engine (paper §2.4), PyTorch port of
core/walk_engine.py.

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

**Per-lane batches** (``LaneParams`` / ``generate_walk_lanes``, DESIGN.md
§11) carry bias, maximum length and RNG seed per lane, so the serving
coalescer can pack many queries into one fixed-shape batch. Lane w draws
from ``fold_in(fold_in(fold_in(key, rid[w]), wid[w]), tag)`` with tag 0
for the start draw and tag s+1 for hop s, so a lane's walk does not
depend on the batch it rides in. They run on ``fullwalk``, ``grouped``
and ``fused``; the fused kernel dispatches the bias code per lane.

**Alias tables and node2vec** (DESIGN.md §17) run on ``fullwalk`` and
``grouped``, as in the reference. ``bias="table"`` (or lanes coded
"table") draws through ``alias.alias_pick`` over the window's
``AliasTables``, passed as ``tables=``. Temporal node2vec rejects the
first-order proposal N2V_ROUNDS times with acceptance β/β_max: config
(p, q) draw their uniforms as ``uniform(hop_key, (N2V_ROUNDS, 2, W))``,
second-order lanes from the ``N2V_TAG_BASE`` substreams of their own
keys, so first-order streams are untouched.

``generate_walks(..., buffers=)``, ``generate_walk_lanes(...,
buffers=)`` and ``generate_walks_donated`` write the walks into the
caller's ``WalkBuffers`` in place (every cell is overwritten) and return
them as the result's ``nodes``/``times``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch import random as prng
from repro_torch.configs.base import SamplerConfig, SchedulerConfig, WalkConfig
from repro_torch.core import scheduler as sched
from repro_torch.core.alias import AliasTables, alias_pick
from repro_torch.core.samplers import (
    BIAS_CODES,
    BIAS_TABLE,
    bias_code,
    node2vec_beta,
    node2vec_beta_lanes,
    node2vec_max_beta,
    node2vec_max_beta_lanes,
    pick_in_neighborhood,
    pick_in_neighborhood_lanes,
    pick_start_edges,
    pick_start_edges_lanes,
)
from repro_torch.core.temporal_index import (
    TemporalIndex,
    pair_key,
    node_range,
    temporal_cutoff,
)
from repro_torch.kernels.fused_step import fused_walk_step
from repro_torch.kernels.ops import walk_step
from repro_torch.kernels.runtime import resolve_device

NODE_PAD = -1          # sentinel in emitted walks beyond walk length
N2V_ROUNDS = 8         # rejection-sampling rounds per hop
# Second-order lanes draw their rejection uniforms from tags
# N2V_TAG_BASE + step·(2·N2V_ROUNDS) + 2r + j, far above any per-step tag
# (s+1 for hop s) a first-order lane uses.
N2V_TAG_BASE = 1 << 20
# second-order lane uniforms drawn in one pass: at most this many
_N2V_DRAWS_PER_PASS = 1 << 22


@dataclass(frozen=True)
class LaneFeatures:
    """Static summary of what a coalesced lane batch needs from the
    engine: ``table`` — lanes with bias code "table" (alias tables);
    ``second_order`` — per-lane node2vec (p, q) with a lane ≠ 1."""

    table: bool = False
    second_order: bool = False


_CAP = "unsupported sampler capability: "


def check_capabilities(scfg: SamplerConfig, path: str,
                       lanes: Optional[LaneFeatures] = None, *,
                       sharded: bool = False,
                       have_tables: bool = False) -> None:
    """Validate a (sampler config, path, lane features) combination.

    Refuses with the reference's ``ValueError`` and message wherever
    core/walk_engine.py::check_capabilities refuses, and runs everything
    else."""
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
    use_n2v = scfg.node2vec_p != 1.0 or scfg.node2vec_q != 1.0

    if scfg.bias == "table":
        if scfg.mode != "index":
            raise ValueError(
                _CAP + "bias='table' requires SamplerConfig.mode='index' "
                f"(the alias draw replaces the mode dispatch; got "
                f"mode={scfg.mode!r})")
        if sharded:
            raise ValueError(
                _CAP + "sharded streaming walks do not support bias="
                "'table' (per-shard alias tables cover resident regions "
                "only; a migrating walk's draw would need its owner's "
                "table)")
        if not have_tables:
            raise ValueError(
                _CAP + "bias='table' requires alias tables: build the "
                "window with a TableSpec (init_window(..., table=spec) / "
                "ingest(..., table=spec)) and pass state.tables into the "
                "walk entry point")
        if path in ("tiled", "fused"):
            raise ValueError(
                _CAP + f"path={path!r} does not support bias='table' (the "
                "Pallas kernels dispatch the closed-form inverse CDFs "
                "only); use 'fullwalk'|'grouped'")

    if use_n2v:
        if sharded:
            raise ValueError(
                _CAP + "sharded streaming walks do not support node2vec "
                "second-order bias (the β probe needs the previous node's "
                "adjacency, which lives on a different shard)")
        if lanes is not None:
            raise ValueError(
                _CAP + "per-lane batches do not support config-level "
                "node2vec second-order bias; second-order lanes carry "
                "their own (n2v_p, n2v_q) arrays (set node2vec_p="
                "node2vec_q=1.0)")
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

    if lanes is not None:
        if scfg.mode != "index":
            raise ValueError(
                _CAP + "per-lane batches require SamplerConfig.mode="
                "'index': the per-lane dispatch selects over the closed-"
                f"form inverse CDFs (got mode={scfg.mode!r})")
        if path == "tiled":
            raise ValueError(
                _CAP + "per-lane batches support paths 'fullwalk'|"
                "'grouped'|'fused'; the tiled Pallas kernel compiles a "
                "single bias per dispatch (the fused kernel dispatches "
                "per-lane bias codes)")
        if lanes.table:
            if sharded:
                raise ValueError(
                    _CAP + "sharded lane serving does not support bias "
                    "code 'table' (per-shard alias tables cover resident "
                    "regions only; a migrating lane's draw would need its "
                    "owner's table)")
            if not have_tables:
                raise ValueError(
                    _CAP + "lane bias code 'table' requires alias tables: "
                    "ingest with a TableSpec and pass state.tables into "
                    "generate_walk_lanes")
            if path == "fused":
                raise ValueError(
                    _CAP + "path='fused' does not serve lane bias code "
                    "'table' (the fused kernel dispatches the closed-form "
                    "codes only); use 'fullwalk'|'grouped'")
        if lanes.second_order:
            if sharded:
                raise ValueError(
                    _CAP + "sharded lane serving does not support "
                    "node2vec second-order lanes (the β probe needs the "
                    "previous node's adjacency, which lives on a "
                    "different shard)")
            if path == "fused":
                raise ValueError(
                    _CAP + "path='fused' does not support node2vec "
                    "second-order lanes (the rejection loop re-draws "
                    "outside the kernel); use 'fullwalk'|'grouped'")


class WalkResult(NamedTuple):
    nodes: torch.Tensor     # int32[W, L+1], NODE_PAD beyond length
    times: torch.Tensor     # int32[W, L+1]
    lengths: torch.Tensor   # int32[W] number of nodes recorded
    stats: Optional[torch.Tensor] = None   # float32[hops, NUM_STATS]


class WalkBuffers(NamedTuple):
    """Reusable walk output buffers: the two int32[W, L+1] arrays of a
    ``WalkResult``. The walk loop overwrites every cell, so their contents
    on entry are dead."""

    nodes: torch.Tensor
    times: torch.Tensor


def alloc_walk_buffers(wcfg: WalkConfig, device=None) -> WalkBuffers:
    """Walk buffers for ``generate_walks_donated`` round-trips, on CUDA
    unless ``device`` names another."""
    shape = (wcfg.num_walks, wcfg.max_length + 1)
    dev = resolve_device(device)
    return WalkBuffers(
        *(torch.full(shape, NODE_PAD, dtype=torch.int32, device=dev)
          for _ in range(2)))


class LaneParams(NamedTuple):
    """Per-lane sampler parameters of a coalesced batch (DESIGN.md §11),
    [W] tensors in walk order on the index's device. ``rid``/``wid`` drive
    the lane's RNG stream (see the module docstring); ``active`` marks
    real lanes against bucket padding. ``n2v_p``/``n2v_q`` (float32) are
    the second-order node2vec parameters, 1.0 disabling them; they are
    read only by a run with ``second_order=True``."""

    start_node: torch.Tensor   # int32[W] start node (start_mode="nodes")
    bias: torch.Tensor         # int32[W] hop-bias code (samplers.BIAS_CODES)
    start_bias: torch.Tensor   # int32[W] start-edge bias code ("edges")
    max_len: torch.Tensor      # int32[W] per-lane hop budget
    rid: torch.Tensor          # int32[W] request seed folded into the RNG
    wid: torch.Tensor          # int32[W] walk index within the request
    active: torch.Tensor       # bool[W] real lane vs bucket padding
    n2v_p: Optional[torch.Tensor] = None
    n2v_q: Optional[torch.Tensor] = None


def _lane_keys(key, lanes: LaneParams) -> torch.Tensor:
    """Per-lane keys, int64[W, 2]: the base key folded by request seed,
    then by walk id."""
    return prng.fold_in_lanes(prng.fold_in_lanes(key, lanes.rid), lanes.wid)


def _lane_uniform(lane_keys: torch.Tensor, tag) -> torch.Tensor:
    """One U[0, 1) draw per lane from the step-``tag`` substream: float32
    [W] for an int ``tag``, [T, W] for an integer tensor of tags [T, 1]."""
    return prng.uniform_lanes(prng.fold_in_lanes(lane_keys, tag))


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
                key, walk_offset: int = 0,
                buffers: Optional[WalkBuffers] = None,
                lanes: Optional[LaneParams] = None,
                lane_keys: Optional[torch.Tensor] = None) -> _Carry:
    """Walk starts for start modes ``nodes``, ``edges`` and ``all_nodes``;
    with ``lanes``, per-lane starts in modes ``nodes`` and ``edges``.
    ``walk_offset`` shifts the ``all_nodes`` assignment for walk-axis
    sharding: walk w of shard s starts where global walk s·Wd + w would."""
    W, L = wcfg.num_walks, wcfg.max_length
    dev = index.ns_ts.device
    i32 = dict(dtype=torch.int32, device=dev)
    if buffers is None:
        nodes = torch.full((W, L + 1), NODE_PAD, **i32)
        times = torch.full((W, L + 1), NODE_PAD, **i32)
    else:
        nodes, times = buffers
    lane = torch.arange(W, **i32)
    nc = index.node_capacity
    t_floor = torch.where(index.num_edges > 0, index.store.ts[0] - 1, 0)
    no_prev = torch.full((W,), -1, **i32)

    if lanes is not None and wcfg.start_mode not in ("nodes", "edges"):
        raise ValueError(
            f"lane batches support start_mode 'nodes'|'edges', "
            f"got {wcfg.start_mode!r}")
    if wcfg.start_mode == "edges":
        if lanes is None:
            u = prng.uniform(key, (W,), dev)
            e = pick_start_edges(index, scfg, u)
            alive = (index.num_edges > 0).expand(W)
        else:
            # per-lane biased start edges; padding lanes stay dead
            e = pick_start_edges_lanes(index, lanes.start_bias,
                                       _lane_uniform(lane_keys, 0))
            alive = lanes.active & (index.num_edges > 0)
        e = e.clamp(0, index.edge_capacity - 1).long()
        src = index.store.src[e]
        cur = index.store.dst[e]
        cur_time = index.store.ts[e]
        nodes[:, 0] = torch.where(alive, src, NODE_PAD)
        times[:, 0] = torch.where(alive, cur_time, NODE_PAD)
        nodes[:, 1] = torch.where(alive, cur, NODE_PAD)
        times[:, 1] = torch.where(alive, cur_time, NODE_PAD)
        return _Carry(cur, cur_time, src, alive, lane, nodes, times,
                      torch.where(alive, 2, 0).to(torch.int32))
    if lanes is not None:
        # explicit per-lane start nodes; a start node out of range or
        # without in-window edges, and a padding lane, yield an empty walk
        cur = lanes.start_node.clamp(0, nc - 1)
        cl = cur.long()
        alive = (lanes.active
                 & ((index.node_starts[cl + 1] - index.node_starts[cl]) > 0)
                 & (lanes.start_node >= 0) & (lanes.start_node < nc))
    elif wcfg.start_mode == "all_nodes":
        cur = (walk_offset + torch.arange(W, **i32)) % nc
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
    """(a, b, c) for lanes grouped by (node, time): the region [a, b) and
    Γ_t(v) = [c, b). Segment heads are re-derived from the order —
    contiguous equal (node, time) runs share the cutoff computed at their
    head — so any permutation is correct."""
    W = s_node.shape[0]
    pad = s_node.new_full((1,), -2)
    head = (s_node != torch.cat([pad, s_node[:-1]])) \
        | (s_time != torch.cat([pad, s_time[:-1]]))
    seg_id = torch.cumsum(head.to(torch.int32), 0) - 1
    a, b = node_range(index, s_node)
    c_head = temporal_cutoff(index, a, b, s_time)
    c = torch.zeros(W, dtype=torch.int32, device=s_node.device).scatter_reduce(
        0, seg_id.long(), torch.where(head, c_head, 0), "amax")
    return a, b, c[seg_id.long()]


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


def _f32(x: float) -> float:
    """A Python float rounded to float32 (the reference's weakly typed
    scalar against a float32 array)."""
    return torch.tensor(x, dtype=torch.float32).item()


def _pick_config(index, scfg, tables, a, c, b, u, node):
    """First-order pick under the config bias."""
    if scfg.bias == "table":
        return alias_pick(tables, a, c, b, u, radix=scfg.table_radix,
                          degree_cap=scfg.table_degree_cap)
    return pick_in_neighborhood(index, scfg, c, b, u, node)


def _pick_lane_codes(index, scfg, tables, code, a, c, b, u):
    """First-order pick under per-lane bias codes: the closed forms, with
    the alias draw overlaid on lanes coded "table" when ``tables`` are
    given — elementwise in (code, u, region), so a lane's pick does not
    depend on its batch."""
    k = pick_in_neighborhood_lanes(index, code, c, b, u)
    if tables is not None:
        k_tab = alias_pick(tables, a, c, b, u, radix=scfg.table_radix,
                           degree_cap=scfg.table_degree_cap)
        k = torch.where(code == BIAS_TABLE, k_tab, k)
    return k


def _rounds(x):
    """A per-lane tensor repeated once per rejection round (round-major),
    None kept."""
    return None if x is None else x.repeat(N2V_ROUNDS)


def _proposals(index, pick, beta_of, prev, us, beta_max):
    """Every rejection round at once: the proposals ``pick(us[r, 0])``
    and whether each is accepted (``us[r, 1]·β_max ≤ β(candidate)``, or
    the lane has no previous node), both [N2V_ROUNDS, W]. ``pick`` and
    ``beta_of`` take the rounds' inputs stacked round-major ([R·W]); the
    arithmetic of each element is that of a round on its own."""
    R, _, W = us.shape
    k = pick(us[:, 0].reshape(-1))
    beta = beta_of(index.ns_dst[k.clamp(0, index.edge_capacity - 1).long()])
    ok = (us[:, 1] * beta_max <= beta.view(R, W)) | (prev < 0)
    return k.view(R, W), ok


def _rejection(index, pick, beta_of, prev, us, beta_max):
    """Node2vec rejection over the first-order proposal stream: the first
    accepted round's proposal, the round-0 one when every round rejects
    (the reference's round loop, taken over all rounds at once)."""
    k, ok = _proposals(index, pick, beta_of, prev, us, beta_max)
    first = ok.to(torch.int8).argmax(0, keepdim=True)
    return torch.where(ok.any(0), k.gather(0, first)[0], k[0])


def _lane_second_order(index, scfg, tables, lane_bias, a, c, b, prev,
                       k_plain, n2v):
    """Per-lane node2vec rejection. ``n2v = (p, q, us2)`` with us2
    [N2V_ROUNDS, 2, W] from the N2V_TAG_BASE substreams, in the caller's
    lane layout; lanes with p == q == 1 keep ``k_plain``."""
    p, q, us2 = n2v
    k_rej = _rejection(
        index,
        lambda u: _pick_lane_codes(index, scfg, tables, _rounds(lane_bias),
                                   _rounds(a), _rounds(c), _rounds(b), u),
        lambda cand: node2vec_beta_lanes(index, _rounds(prev), cand,
                                         _rounds(p), _rounds(q)),
        prev, us2, node2vec_max_beta_lanes(p, q))
    return torch.where((p != 1.0) | (q != 1.0), k_rej, k_plain)


def _draw_pick(index, scfg, hop_key, a, c, b, s_node, s_prev, order,
               lane_bias=None, lane_u=None, tables=None, lane_n2v=None):
    """Positions k ∈ [c, b) for lanes in ``order`` (lane -> walk id, None
    for walk order). The config bias draws the hop's uniforms (node2vec:
    ``uniform(hop_key, (N2V_ROUNDS, 2, W))``) in walk order and reads them
    through ``order``; with ``lane_bias``/``lane_u`` (walk-order arrays)
    each lane uses its own code and draw, and ``lane_n2v`` its own
    second-order parameters and uniforms."""
    o = None if order is None else order.long()
    if lane_u is not None:
        if o is not None:
            lane_bias, lane_u = lane_bias[o], lane_u[o]
        k = _pick_lane_codes(index, scfg, tables, lane_bias, a, c, b, lane_u)
        if lane_n2v is not None:
            p, q, us2 = lane_n2v
            if o is not None:
                p, q, us2 = p[o], q[o], us2[:, :, o]
            k = _lane_second_order(index, scfg, tables, lane_bias, a, c, b,
                                   s_prev, k, (p, q, us2))
        return k
    W = s_node.shape[0]
    dev = s_node.device
    if scfg.node2vec_p == 1.0 and scfg.node2vec_q == 1.0:
        u = prng.uniform(hop_key, (W,), dev)
        return _pick_config(index, scfg, tables, a, c, b,
                            u if o is None else u[o], s_node)
    p, q = scfg.node2vec_p, scfg.node2vec_q
    us = prng.uniform(hop_key, (N2V_ROUNDS, 2, W), dev)
    return _rejection(
        index,
        lambda u: _pick_config(index, scfg, tables, _rounds(a), _rounds(c),
                               _rounds(b), u, _rounds(s_node)),
        lambda cand: node2vec_beta(index, _rounds(s_prev), cand, p, q),
        s_prev, us if o is None else us[:, :, o],
        _f32(node2vec_max_beta(p, q)))


def _limit(has_next, lane_limit, order=None):
    """``has_next`` within each lane's own budget (walk-order
    ``lane_limit`` seen through ``order``)."""
    if lane_limit is None:
        return has_next
    return has_next & (lane_limit if order is None
                       else lane_limit[order.long()])


def _gather(index: TemporalIndex, k: torch.Tensor):
    k = k.clamp(0, index.edge_capacity - 1).long()
    return index.ns_dst[k], index.ns_ts[k]


def _hop_fullwalk(index, scfg, sched_cfg, carry: _Carry, step: int,
                  hop_key, lane_bias=None, lane_u=None,
                  lane_limit=None, tables=None, lane_n2v=None) -> _Carry:
    """Every walk advances on its own, in walk order."""
    a, b = node_range(index, carry.cur_node)
    c = temporal_cutoff(index, a, b, carry.cur_time)
    k = _draw_pick(index, scfg, hop_key, a, c, b, carry.cur_node,
                   carry.prev_node, None, lane_bias, lane_u, tables,
                   lane_n2v)
    return _advance(carry, step, *_gather(index, k),
                    _limit(carry.alive & (b - c > 0), lane_limit))


def _hop_grouped(index, scfg, sched_cfg, carry: _Carry, step: int,
                 hop_key, lane_bias=None, lane_u=None,
                 lane_limit=None, tables=None, lane_n2v=None) -> _Carry:
    """Fresh stable sort by (node, time) + inverse, shared cutoffs."""
    perm, s_node, s_time, s_prev, s_alive = _lexsort_prologue(index, carry)
    a, b, c = _segment_cutoff(index, s_node, s_time)
    k = _draw_pick(index, scfg, hop_key, a, c, b, s_node, s_prev, perm,
                   lane_bias, lane_u, tables, lane_n2v)
    nn, nt = _gather(index, k)
    return _advance(carry, step, *_unsort(
        perm, nn, nt, _limit(s_alive & (b - c > 0), lane_limit, perm)))


def _hop_grouped_bucket(index, scfg, sched_cfg, carry: _Carry, step: int,
                        hop_key, lane_bias=None, lane_u=None,
                        lane_limit=None, tables=None,
                        lane_n2v=None) -> _Carry:
    """Carried bucket regroup, shared cutoffs (the reference's default)."""
    lane, s_node, s_time, s_prev, s_alive = _bucket_prologue(
        index, sched_cfg, carry)
    a, b, c = _segment_cutoff(index, s_node, s_time)
    k = _draw_pick(index, scfg, hop_key, a, c, b, s_node, s_prev, lane,
                   lane_bias, lane_u, tables, lane_n2v)
    nn, nt = _gather(index, k)
    return _advance_lanes(carry, lane, step, s_node, s_time, s_prev, nn, nt,
                          _limit(s_alive & (b - c > 0), lane_limit, lane))


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


def _fused_codes(scfg: SamplerConfig, hop_key, order: torch.Tensor,
                 lane_bias=None, lane_u=None):
    """Per-lane (bias code, uniform) in lane order for the fused kernel:
    the config bias and the hop's draws, or the lanes' own."""
    if lane_u is not None:
        o = order.long()
        return lane_bias[o], lane_u[o]
    code = torch.full((order.shape[0],), bias_code(scfg.bias),
                      dtype=torch.int32, device=order.device)
    return code, _draws(hop_key, order)


def _hop_fused(index, scfg, sched_cfg, carry: _Carry, step: int,
               hop_key, lane_bias=None, lane_u=None,
               lane_limit=None) -> _Carry:
    """Lexsort layout through the fused kernel."""
    perm, s_node, s_time, _, s_alive = _lexsort_prologue(index, carry)
    code, u = _fused_codes(scfg, hop_key, perm, lane_bias, lane_u)
    out = fused_walk_step(index, s_node, s_time, code, u, scfg.mode,
                          sched_cfg)
    return _advance(carry, step, *_unsort(
        perm, out.dst, out.ts, _limit(s_alive & (out.n > 0), lane_limit,
                                      perm)))


def _hop_fused_bucket(index, scfg, sched_cfg, carry: _Carry, step: int,
                      hop_key, lane_bias=None, lane_u=None,
                      lane_limit=None) -> _Carry:
    """Bucket layout through the fused kernel (DESIGN.md §14)."""
    lane, s_node, s_time, s_prev, s_alive = _bucket_prologue(
        index, sched_cfg, carry)
    code, u = _fused_codes(scfg, hop_key, lane, lane_bias, lane_u)
    out = fused_walk_step(index, s_node, s_time, code, u, scfg.mode,
                          sched_cfg)
    return _advance_lanes(carry, lane, step, s_node, s_time, s_prev,
                          out.dst, out.ts,
                          _limit(s_alive & (out.n > 0), lane_limit, lane))


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


def _check_buffers(buffers: WalkBuffers, wcfg: WalkConfig,
                   device: torch.device) -> None:
    shape = (wcfg.num_walks, wcfg.max_length + 1)
    for name, t in zip(WalkBuffers._fields, buffers):
        if (tuple(t.shape) != shape or t.dtype != torch.int32
                or t.device != device or not t.is_contiguous()):
            raise ValueError(
                f"buffers.{name} must be contiguous int32{list(shape)} on "
                f"{device}, got {t.dtype}{list(t.shape)} on {t.device}")


def _check_lane_support(wcfg: WalkConfig, scfg: SamplerConfig,
                        sched_cfg: SchedulerConfig, lanes: LaneParams,
                        tables: Optional[AliasTables] = None,
                        second_order: bool = False) -> None:
    """Validation of a per-lane batch (DESIGN.md §11): shapes here,
    everything capability-shaped through ``check_capabilities``."""
    check_capabilities(
        scfg, sched_cfg.path,
        LaneFeatures(table=tables is not None, second_order=second_order),
        have_tables=tables is not None)
    if lanes.start_node.shape[0] != wcfg.num_walks:
        raise ValueError(
            f"lane arrays have {lanes.start_node.shape[0]} lanes but "
            f"wcfg.num_walks={wcfg.num_walks}")
    if second_order and (lanes.n2v_p is None or lanes.n2v_q is None):
        raise ValueError(
            "second_order=True requires LaneParams.n2v_p/n2v_q arrays "
            "(the coalescer packs them; see serve/coalescer.py)")


def _n2v_lane_draws(lane_keys: torch.Tensor, hops: int):
    """Hop s's second-order uniforms [N2V_ROUNDS, 2, W], from tags
    N2V_TAG_BASE + s·2·N2V_ROUNDS + 2r + j, drawn a block of hops per
    pass (at most ``_N2V_DRAWS_PER_PASS`` uniforms)."""
    W = lane_keys.shape[0]
    per = 2 * N2V_ROUNDS
    block = max(1, _N2V_DRAWS_PER_PASS // (per * W))
    for s0 in range(0, hops, block):
        n = min(block, hops - s0)
        tags = N2V_TAG_BASE + s0 * per + torch.arange(
            n * per, device=lane_keys.device)[:, None]
        us = _lane_uniform(lane_keys, tags).reshape(n, N2V_ROUNDS, 2, W)
        yield from us


def _generate_walks_impl(index: TemporalIndex, key, wcfg: WalkConfig,
                         scfg: SamplerConfig, sched_cfg: SchedulerConfig,
                         collect_stats: bool = False,
                         buffers: Optional[WalkBuffers] = None,
                         lanes: Optional[LaneParams] = None,
                         tables: Optional[AliasTables] = None,
                         second_order: bool = False,
                         walk_offset: int = 0) -> WalkResult:
    """Shared body of every walk entry point. ``tables`` threads the
    window's alias tables (config bias "table" or lanes coded "table");
    ``second_order`` runs the per-lane node2vec rejection; ``walk_offset``
    shifts the ``all_nodes`` starts (distributed/walks.py)."""
    if lanes is not None:
        _check_lane_support(wcfg, scfg, sched_cfg, lanes, tables,
                            second_order)
    else:
        check_capabilities(scfg, sched_cfg.path,
                           have_tables=tables is not None)
    if sched_cfg.regroup not in ("bucket", "lexsort"):
        raise ValueError(f"unknown regroup {sched_cfg.regroup!r}")
    try:
        hop = HOPS[sched_cfg.path, sched_cfg.regroup == "bucket"]
    except KeyError:
        raise ValueError(
            f"unknown scheduler path {sched_cfg.path!r}") from None
    if buffers is not None:
        _check_buffers(buffers, wcfg, index.ns_ts.device)
    if lanes is not None:
        # one base key; lane streams are folds of it, never a split, so a
        # lane's draws do not depend on the batch it rides in
        lane_keys = _lane_keys(key, lanes)
        start_key = walk_key = key
    else:
        lane_keys = None
        start_key, walk_key = prng.split(key)
    carry = start_walks(index, wcfg, scfg, start_key,
                        walk_offset=walk_offset, buffers=buffers,
                        lanes=lanes, lane_keys=lane_keys)
    edges = wcfg.start_mode == "edges"
    hops = wcfg.max_length - 1 if edges else wcfg.max_length
    # tables reach the hop only where a draw reads them (the tiled and
    # fused hops take none: check_capabilities refuses them there)
    extra = {}
    if tables is not None and (scfg.bias == "table" or lanes is not None):
        extra["tables"] = tables
    if lanes is not None and hops > 0:
        # every hop's lane draws at once: tag s+1 for hop s (tag 0 was the
        # start draw), one pass over [hops, W] instead of one per hop
        lane_us = _lane_uniform(lane_keys, torch.arange(
            1, hops + 1, device=lane_keys.device)[:, None])
        n2v_us = _n2v_lane_draws(lane_keys, hops) if second_order else None
    stats = []
    for step in range(hops):
        write_pos = step + int(edges)
        if collect_stats:
            stats.append(sched.dispatch_stats(index, carry.cur_node,
                                              carry.alive, sched_cfg))
        if lanes is None:
            carry = hop(index, scfg, sched_cfg, carry, write_pos,
                        prng.fold_in(walk_key, step), **extra)
        else:
            if n2v_us is not None:
                extra["lane_n2v"] = (lanes.n2v_p, lanes.n2v_q, next(n2v_us))
            # column write_pos+1 is written only within the lane's own
            # max_len
            carry = hop(index, scfg, sched_cfg, carry, write_pos, None,
                        lane_bias=lanes.bias, lane_u=lane_us[step],
                        lane_limit=(write_pos + 1) <= lanes.max_len, **extra)
    if collect_stats:
        stats = torch.stack(stats) if stats else torch.zeros(
            (0, sched.NUM_STATS), dtype=torch.float32,
            device=index.ns_ts.device)
    return WalkResult(nodes=carry.nodes, times=carry.times,
                      lengths=carry.lengths,
                      stats=stats if collect_stats else None)


def generate_walks(index: TemporalIndex, key, wcfg: WalkConfig,
                   scfg: SamplerConfig, sched_cfg: SchedulerConfig,
                   collect_stats: bool = False,
                   buffers: Optional[WalkBuffers] = None,
                   tables: Optional[AliasTables] = None) -> WalkResult:
    """Generate ``wcfg.num_walks`` temporal walks of ≤ ``max_length`` hops
    on the index's device. ``key`` is a ``repro_torch.random`` key. With
    ``collect_stats``, ``WalkResult.stats`` holds ``dispatch_stats`` of
    every hop, float32[hops, NUM_STATS]. With ``buffers``, the walks are
    written into them and they are the result's ``nodes``/``times``.
    ``tables`` (the window's ``AliasTables``) serves ``bias="table"``."""
    return _generate_walks_impl(index, key, wcfg, scfg, sched_cfg,
                                collect_stats=collect_stats,
                                buffers=buffers, tables=tables)


def generate_walks_donated(index: TemporalIndex, key, buffers: WalkBuffers,
                           wcfg: WalkConfig, scfg: SamplerConfig,
                           sched_cfg: SchedulerConfig,
                           tables: Optional[AliasTables] = None
                           ) -> WalkResult:
    """Steady-state form of ``generate_walks`` (DESIGN.md §10): the walks
    of this round are written into the previous round's ``buffers``,
    which the caller gives up."""
    return _generate_walks_impl(index, key, wcfg, scfg, sched_cfg,
                                buffers=buffers, tables=tables)


def generate_walk_lanes(index: TemporalIndex, key, lanes: LaneParams,
                        wcfg: WalkConfig, scfg: SamplerConfig,
                        sched_cfg: SchedulerConfig,
                        buffers: Optional[WalkBuffers] = None,
                        tables: Optional[AliasTables] = None,
                        second_order: bool = False) -> WalkResult:
    """A coalesced heterogeneous batch (DESIGN.md §11): one fixed-shape
    run of ``wcfg.num_walks`` lanes with bias, maximum length and RNG
    seed per lane, on paths ``fullwalk``, ``grouped`` and ``fused``.
    ``tables`` serves lanes coded "table" and ``second_order`` the lanes'
    node2vec (p, q), both on ``fullwalk`` and ``grouped``."""
    return _generate_walks_impl(index, key, wcfg, scfg, sched_cfg,
                                buffers=buffers, lanes=lanes, tables=tables,
                                second_order=second_order)
