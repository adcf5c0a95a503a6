"""Node-partitioned sliding window: sharded streaming ingest and walks
and serving (DESIGN.md §12, §13), PyTorch port of
repro/distributed/streaming_shard.py.

* **Ownership** — nodes are partitioned by a ``Placement``
  (distributed/placement.py; default range). Shard d holds the
  merge-sorted window slice of edges whose source it owns, so Γ_t(v) is
  always served locally. Ingest bucketing, walk start claims, per-hop
  migration and ``reshard`` all consult the same placement object.
* **Sharded ingest** — each shard takes a 1/D slice of the incoming batch,
  buckets it by edge-source owner, and one ``all_to_all``
  (``exchange_by_owner``) delivers every edge to its owner, which
  compacts its received edges by one stable ts sort (ties keep (sender,
  sender position), i.e. global batch order) and runs the single-device
  merge ingest locally.
* **Watermark agreement** — the new ``t`` is the largest batch timestamp
  over all shards (one ``pmax`` before the exchange), passed to the
  ingest's ``watermark`` hook, so every shard evicts against the same
  cutoff t − Δ.
* **Sharded walks** — per batch, walks start on their start node's owner
  and migrate every hop (``hop_resident`` + ``exchange_by_owner``). The
  hop draw is the streaming engine's own, ``uniform(fold_in(walk_key,
  step), (W,))`` indexed by walk id: it does not depend on the placement,
  so for ``SamplerConfig.mode="index"`` the replay is bit-identical to
  the single-device ``StreamingEngine.replay_device`` at any shard count
  and under any placement, as long as nothing is dropped. The draw is
  made once per step and device and shared by the shards there.
* **Traces** — every trace cell is written by at most one shard, so the
  shards on one device write one shared walk-order ``[W, L+1]`` buffer;
  shards on different devices are reassembled by ``PAD + Σ(x − PAD)``.
  Lengths are the written cells of a row. Migration moves 3 ints a walk.
* **Sharded serving** — ``serve_lanes_sharded`` walks one coalesced lane
  batch: a lane starts on the owner of its start node (nodes mode) or of
  its start edge's destination, drawn from the ts view of the whole
  window (edges mode), and migrates every hop. Its draws are the lane's
  own streams, so the batch equals the single-device
  ``generate_walk_lanes`` at any shard count when nothing drops.

Shards are emulated by a ``ShardGroup`` (distributed/collectives.py):
each shard step is split at its collectives into per-shard phases, and
``devices=[dev] * D`` runs D shards on one device. All capacities are
static (``ShardConfig``): exchange buckets, resident walk slots and walk
buckets drop on overflow and count the event per shard.

Nothing here reads a device value on the host inside the batch loop:
``DistributedStreamingEngine.replay_device`` reads its statistics,
counters and probes back in one copy at the end, and the walks in three.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.configs.base import (
    EngineConfig,
    SamplerConfig,
    ShardConfig,
    WalkConfig,
)
from repro_torch.core.distributed import (
    exchange_by_owner,
    hop_resident,
    hop_resident_lanes,
)
from repro_torch.core.edge_store import (
    TS_PAD,
    EdgeBatch,
    EdgeStore,
    make_batch,
    stack_batches,
)
from repro_torch.core.samplers import index_pick_lanes
from repro_torch.core.streaming import ReplayStats
from repro_torch.core.temporal_index import build_index
from repro_torch.core.walk_engine import (
    NODE_PAD,
    LaneFeatures,
    LaneParams,
    WalkResult,
    _lane_keys,
    _lane_uniform,
    check_capabilities,
)
from repro_torch.core.window import TsView, WindowState, ingest, init_window
from repro_torch.distributed.collectives import (
    ShardGroup,
    make_group,
    tree_to,
    visible_devices,
)
from repro_torch.distributed.placement import (
    Placement,
    RangePlacement,
    SkewPlacement,
    make_placement,
)
from repro_torch.obs.probes import (
    NUM_REPLAY_PROBES,
    NUM_SERVE_PROBES,
    RP_WALKS_EMITTED,
    SP_HOPS,
    SP_LANES_CLAIMED,
    SP_WALK_DROPS,
    flush_replay_probes,
    replay_probe_update,
    replay_probe_zeros,
)
from repro_torch.obs.registry import MetricsRegistry, count_drop, get_registry


class ShardedWindowState(NamedTuple):
    """Per-shard window slices: one ``WindowState`` per shard, on its
    device. Their counters are shard-local: summed over shards,
    ``late_drops``/``overflow_drops`` equal the single-device window's,
    and ``ingested`` counts edges delivered (it lags the global count by
    the exchange drops)."""

    window: Tuple[WindowState, ...]
    exchange_drops: Tuple[torch.Tensor, ...]   # int32 cumulative, per shard


class DistReplayStats(NamedTuple):
    """Distributed replay statistics: ``replay`` is the global per-batch
    trajectory in the single-device ``ReplayStats`` layout (equal field by
    field when no shard dropped anything); the drop counters are per
    batch and shard, [K, D] (senders count their own exchange overflow)."""

    replay: ReplayStats
    exchange_drops: np.ndarray   # int32[K, D] batch-edge exchange overflow
    walk_drops: np.ndarray       # int32[K, D] walk migration + slot overflow


def window_mesh(num_shards: int = 0, devices=None) -> ShardGroup:
    """A group over the first ``num_shards`` (default: all) of ``devices``
    (default: the visible CUDA devices). More shards than devices is
    refused; name a device D times to run D shards on it."""
    return make_group(num_shards, devices)


def _per_device(group: ShardGroup, make):
    """``make(device)`` once per distinct device of the group, one entry
    per shard."""
    made = {}
    for d in group.devices:
        if d not in made:
            made[d] = make(d)
    return tuple(made[d] for d in group.devices)


def init_sharded_window(num_shards: int, edge_capacity_per_shard: int,
                        node_capacity: int, window: int,
                        bias_scale: float = 1.0,
                        mesh: Optional[ShardGroup] = None,
                        table=None) -> ShardedWindowState:
    """D empty per-shard windows on the group's devices (default: one
    shard per visible device). ``table`` (a ``core.alias.TableSpec``)
    makes every shard's window carry alias tables over its resident
    regions, maintained by ``ingest_sharded`` given the same spec.
    Shards on one device share one empty window: an ingest never writes
    the state it is given."""
    group = mesh if mesh is not None else window_mesh(num_shards)
    if group.size != num_shards:
        raise ValueError(f"{num_shards} shards on a group of {group.size}")
    windows = _per_device(group, lambda d: init_window(
        edge_capacity_per_shard, node_capacity, window, bias_scale,
        table=table, device=d))
    return ShardedWindowState(
        window=windows,
        exchange_drops=tuple(torch.zeros((), dtype=torch.int32, device=d)
                             for d in group.devices))


# ---------------------------------------------------------------------------
# Shard steps: per-shard phases around the group's collectives
# ---------------------------------------------------------------------------


def _merge_received(wstate: WindowState, received, watermark, *,
                    node_capacity: int, bias_scale: float, table=None
                    ) -> WindowState:
    """One shard's ingest after the exchange: compact the received edges
    to a ts-sorted prefix and run the single-device merge against the
    agreed watermark. Empty exchange slots carry TS_PAD, so one stable
    ts sort both drops them to the back and keeps ties in (sender,
    sender position) order, the global batch order."""
    r_src, r_dst, r_ts = received
    order = torch.sort(r_ts, stable=True).indices
    cnt = (r_ts != TS_PAD).sum(dtype=torch.int32)
    batch = EdgeBatch(src=r_src[order], dst=r_dst[order], ts=r_ts[order],
                      count=cnt)
    return ingest(wstate, batch, node_capacity, bias_scale, table=table,
                  watermark=watermark)


def _shard_ingest(group: ShardGroup, wstates, bsrc, bdst, bts, bvalid, *,
                  placement: Placement, exchange_capacity: int,
                  node_capacity: int, bias_scale: float, table=None):
    """Every shard's window advance for its slice of one batch (per-shard
    sequences ``bsrc[d]`` …): batch slice → owner buckets → all_to_all →
    compact → local merge, the eviction watermark agreed before the
    exchange so that it reflects every arriving edge, even one a full
    bucket drops. Returns (new per-shard states, per-shard drops)."""
    D = group.size
    # (1) watermark agreement: the largest batch timestamp on any shard
    watermark = group.pmax([torch.where(bvalid[d], bts[d], -TS_PAD).amax()
                            for d in range(D)])
    # (2) bucket by edge-source owner, one all_to_all
    received, _, x_drop = exchange_by_owner(
        group, exchange_capacity, [placement.owner(s) for s in bsrc], bvalid,
        [(bsrc[d], bdst[d], bts[d]) for d in range(D)], (0, 0, TS_PAD))
    # (3) + (4) compact and merge shard-locally
    new = tuple(_merge_received(wstates[d], received[d], watermark[d],
                                node_capacity=node_capacity,
                                bias_scale=bias_scale, table=table)
                for d in range(D))
    return new, x_drop


def _claim_slots(mine: torch.Tensor, ids: torch.Tensor, Ws: int):
    """One shard's claimed rows into its first resident slots, in row
    order: (slot ids int32[Ws], -1 for a free slot; the count of claimed
    rows past the last slot)."""
    rank = torch.cumsum(mine, 0, dtype=torch.int32) - 1
    w = torch.full((Ws + 1,), -1, dtype=torch.int32, device=mine.device)
    w[torch.where(mine, rank, Ws).clamp(max=Ws).long()] = ids
    return w[:Ws], (mine.sum(dtype=torch.int32) - Ws).clamp(min=0)


def _migrate(group: ShardGroup, placement: Placement, bucket_capacity: int,
             Ws: int, wid, moved):
    """Send every walk that hopped (``moved[d]`` = (node, time, has) of
    shard d's slots) to its new node's owner; dead walks free their slot,
    their trace is already written. Returns per shard (wid, node, time,
    alive) of the new resident slots and the walks dropped: bucket
    overflow at the sender plus arrivals past the last slot."""
    D = group.size
    i32 = torch.int32
    received, _, n_drop = exchange_by_owner(
        group, bucket_capacity, [placement.owner(m[0]) for m in moved],
        [m[2] for m in moved],
        [(wid[d], moved[d][0], moved[d][1]) for d in range(D)], (-1, 0, 0))
    out = []
    for d in range(D):
        r_wid, r_node, r_time = received[d]
        dev = r_wid.device
        inc_valid = r_wid >= 0
        dest = torch.where(inc_valid,
                           torch.cumsum(inc_valid, 0, dtype=i32) - 1, Ws)
        recv_drop = (inc_valid & (dest >= Ws)).sum(dtype=i32)
        dl = dest.clamp(max=Ws).long()

        def place(fill, payload, dtype=i32):
            buf = torch.full((Ws + 1,), fill, dtype=dtype, device=dev)
            buf[dl] = payload
            return buf[:Ws]

        out.append((place(-1, r_wid), place(0, r_node), place(0, r_time),
                    place(False, inc_valid, torch.bool),
                    n_drop[d] + recv_drop))
    return out


def _gather_traces(group: ShardGroup, traces, rows: int):
    """The shared trace buffers' first ``rows`` rows as (nodes, times,
    lengths) on the first shard's device: one device's buffers as they
    are, several devices' by ``PAD + Σ(x − PAD)`` (each cell is written
    by one shard). Lengths are the written cells of a row."""
    home = group.devices[0]
    devs = list(dict.fromkeys(group.devices))
    if len(devs) == 1:
        nodes, times = (x[:rows] for x in traces[0])
    else:
        parts = [traces[group.devices.index(dv)] for dv in devs]
        nodes, times = (NODE_PAD + sum((p[j][:rows] - NODE_PAD).to(home)
                                       for p in parts) for j in range(2))
    return nodes, times, (nodes != NODE_PAD).sum(1, dtype=torch.int32)


def _shard_walks(group: ShardGroup, idxs, walk_key, wcfg: WalkConfig,
                 scfg: SamplerConfig, *, placement: Placement,
                 walk_slots: int, walk_bucket_capacity: int,
                 count_hops: bool = False):
    """One batch's walks over the sharded window (start_mode="all_nodes").

    Returns (nodes, times, lengths) in walk order on the first shard's
    device — the exact single-device ``WalkResult`` when nothing dropped —
    with each shard's drop count and, with ``count_hops``, the hop cells
    it executed."""
    D = group.size
    W, L = wcfg.num_walks, wcfg.max_length
    nc = idxs[0].node_capacity
    Ws = walk_slots
    i32 = torch.int32

    # global t_floor: the smallest in-window timestamp over all shards,
    # minus one (an empty shard's store starts with TS_PAD)
    any_edges = group.pmax([i.num_edges for i in idxs])
    global_min = group.pmin([i.store.ts[0] for i in idxs])
    t_floor = [torch.where(any_edges[d] > 0, global_min[d] - 1, 0)
               for d in range(D)]

    # walk-order traces, one pair per device, row W a sink for the rows
    # a shard does not write
    traces = _per_device(group, lambda dev: tuple(
        torch.full((W + 1, L + 1), NODE_PAD, dtype=i32, device=dev)
        for _ in range(2)))

    wid, node, cur_time, alive, drops = [], [], [], [], []
    hops = [None] * D
    for d in range(D):
        dev = group.devices[d]
        idx = idxs[d]
        # place walk w (start node w % nc) on its start node's owner
        w_all = torch.arange(W, dtype=i32, device=dev)
        w, drop = _claim_slots(placement.owner(w_all % nc) == d, w_all, Ws)
        drops.append(drop)
        v = torch.where(w >= 0, w % nc, 0)
        vc = v.clamp(0, nc - 1).long()
        deg = idx.node_starts[vc + 1] - idx.node_starts[vc]
        a = (w >= 0) & (deg > 0)
        t = t_floor[d].to(i32).expand(Ws)
        tn, tt = traces[d]
        row0 = torch.where(a, w, W).long()
        tn[row0, 0] = v
        tt[row0, 0] = t
        wid.append(w)
        node.append(v)
        cur_time.append(t)
        alive.append(a)
        if count_hops:
            hops[d] = torch.zeros((), dtype=i32, device=dev)

    def record_hop(step: int):
        # the streaming engine's hop draw: one walk-order [W] vector per
        # step (drawn once per device), indexed by walk id
        u_full = group.replicate(prng.uniform(
            prng.fold_in(walk_key, step), (W,), device=group.devices[0]))
        out = []
        for d in range(D):
            u = u_full[d][wid[d].clamp(0, W - 1).long()]
            nn, nt, has = hop_resident(idxs[d], scfg, node[d], cur_time[d],
                                       alive[d], u)
            tn, tt = traces[d]
            row = torch.where(has, wid[d], W).long()
            tn[row, step + 1] = nn
            tt[row, step + 1] = nt
            if count_hops:
                hops[d] = hops[d] + has.sum(dtype=i32)
            out.append((nn, nt, has))
        return out

    # L-1 migrating hops, then one hop that only records: the last hop's
    # migration would place walks nobody advances
    for step in range(max(L - 1, 0)):
        moved = _migrate(group, placement, walk_bucket_capacity, Ws, wid,
                         record_hop(step))
        for d, (w, v, t, a, dropped) in enumerate(moved):
            wid[d], node[d], cur_time[d], alive[d] = w, v, t, a
            drops[d] = drops[d] + dropped
    if L >= 1:
        record_hop(L - 1)
    return _gather_traces(group, traces, W) + (drops, hops)


def _shard_walk_lanes(group: ShardGroup, idxs, views, lanes, draws,
                      wcfg: WalkConfig, *, placement: Placement,
                      walk_slots: int, walk_bucket_capacity: int):
    """One coalesced lane batch's walks over the sharded window.

    The serving twin of ``_shard_walks``. ``views``, ``lanes`` and
    ``draws`` hold one copy per shard of the ts view, the ``LaneParams``
    and the lanes' uniforms (row t: tag t of every lane), so any shard
    can evaluate any lane's next draw; each lane is claimed by exactly
    one shard per step (its current node's owner), so every trace cell is
    written by at most one shard and the traces are the single-device
    ``generate_walk_lanes`` result.

    Start claims: nodes mode places lane i on owner(start_node[i]) when
    the node has in-window out-edges (the owner holds its full degree);
    edges mode computes the global start-edge pick from the view, bitwise
    the single-device pick since the view's store is, and places the lane
    on owner(dst). Migration carries 3 ints (lane id, node, time); the
    bias, budget and draws are recovered by lane id at every hop.

    Returns (nodes, times, lengths) on the first shard's device and, per
    shard, the lanes dropped (start slots and migration), the start lanes
    claimed and the hop cells executed.
    """
    D = group.size
    S, L = wcfg.num_walks, wcfg.max_length
    nc = idxs[0].node_capacity
    Ws = walk_slots
    i32 = torch.int32
    edges_mode = wcfg.start_mode == "edges"
    # edges mode: the start draw (tag 0) writes two cells, L-1 hops follow
    hops_n, offset = (max(L - 1, 0), 1) if edges_mode else (L, 0)

    traces = _per_device(group, lambda dev: tuple(
        torch.full((S + 1, L + 1), NODE_PAD, dtype=i32, device=dev)
        for _ in range(2)))
    wid, node, cur_time, alive, drops, claims, hops = ([] for _ in range(7))
    for d in range(D):
        dev = group.devices[d]
        lane, gstore = lanes[d], views[d].store
        lane_ids = torch.arange(S, dtype=i32, device=dev)
        tn, tt = traces[d]
        if edges_mode:
            n_glob = gstore.num_edges.to(i32).expand(S)
            e = index_pick_lanes(lane.start_bias, draws[d][0], n_glob)
            e = e.clamp(0, gstore.capacity - 1).long()
            s_src, s_cur, s_ts = gstore.src[e], gstore.dst[e], gstore.ts[e]
            mine = (lane.active & (gstore.num_edges > 0)
                    & (placement.owner(s_cur) == d))
            row0 = torch.where(mine, lane_ids, S).long()
            tn[row0, 0] = s_src
            tt[row0, 0] = s_ts
            tn[row0, 1] = s_cur
            tt[row0, 1] = s_ts
            start_node, start_time = s_cur, s_ts
        else:
            v = lane.start_node
            vc = v.clamp(0, nc - 1)
            deg = (idxs[d].node_starts[vc.long() + 1]
                   - idxs[d].node_starts[vc.long()])
            t_floor = torch.where(gstore.num_edges > 0, gstore.ts[0] - 1, 0)
            mine = (lane.active & (v >= 0) & (v < nc) & (deg > 0)
                    & (placement.owner(vc) == d))
            row0 = torch.where(mine, lane_ids, S).long()
            start_node, start_time = vc, t_floor.to(i32).expand(S)
            tn[row0, 0] = start_node
            tt[row0, 0] = start_time
        claims.append(mine.sum(dtype=i32))
        w, drop = _claim_slots(mine, lane_ids, Ws)
        wc = w.clamp(0, S - 1).long()
        wid.append(w)
        node.append(torch.where(w >= 0, start_node[wc], 0))
        cur_time.append(torch.where(w >= 0, start_time[wc], 0))
        alive.append(w >= 0)
        drops.append(drop)
        hops.append(torch.zeros((), dtype=i32, device=dev))

    def record_hop(step: int):
        # the lane's draw of tag step + 1 (tag 0 was the start draw) and
        # its bias and budget, recovered by lane id
        write = step + offset + 1
        out = []
        for d in range(D):
            wc = wid[d].clamp(0, S - 1).long()
            lane = lanes[d]
            nn, nt, has = hop_resident_lanes(
                idxs[d], lane.bias[wc], node[d], cur_time[d], alive[d],
                draws[d][step + 1][wc])
            has = has & (write <= lane.max_len[wc])
            tn, tt = traces[d]
            row = torch.where(has, wid[d], S).long()
            tn[row, write] = nn
            tt[row, write] = nt
            hops[d] = hops[d] + has.sum(dtype=i32)
            out.append((nn, nt, has))
        return out

    # hops-1 migrating hops and one that only records, as in _shard_walks
    for step in range(max(hops_n - 1, 0)):
        moved = _migrate(group, placement, walk_bucket_capacity, Ws, wid,
                         record_hop(step))
        for d, (w, v, t, a, dropped) in enumerate(moved):
            wid[d], node[d], cur_time[d], alive[d] = w, v, t, a
            drops[d] = drops[d] + dropped
    if hops_n >= 1:
        record_hop(hops_n - 1)
    return _gather_traces(group, traces, S) + (drops, claims, hops)


# ---------------------------------------------------------------------------
# Standalone sharded ingest: advance the window by one batch (no walks)
# ---------------------------------------------------------------------------


def _batch_valid(group: ShardGroup, batch_slice: int, count):
    """Each shard's valid mask: its slice covers global batch positions
    [d·Bd, (d+1)·Bd)."""
    return [(d * batch_slice + torch.arange(batch_slice, dtype=torch.int32,
                                            device=dev)) < count.to(dev)
            for d, dev in enumerate(group.devices)]


def _slices(group: ShardGroup, a: torch.Tensor):
    """Shard d's slice ``a[..., d, :]`` on its device."""
    return [a.select(-2, d).to(dev) for d, dev in enumerate(group.devices)]


def ingest_sharded(state: ShardedWindowState, bsrc, bdst, bts, count, *,
                   mesh: ShardGroup, node_capacity: int,
                   shard_cfg: ShardConfig, bias_scale: float = 1.0,
                   placement: Optional[Placement] = None,
                   table=None) -> ShardedWindowState:
    """Advance the sharded window by one batch: ``bsrc/bdst/bts`` are
    [D, Bd] (the batch axis pre-split per shard), ``count`` the global
    valid prefix length. Returns the new state; writes nothing it was
    given."""
    D = mesh.size
    if placement is None:
        placement = RangePlacement(num_shards=D, node_capacity=node_capacity)
    bvalid = _batch_valid(mesh, bsrc.shape[-1], count)
    new, x_drop = _shard_ingest(
        mesh, state.window, _slices(mesh, bsrc), _slices(mesh, bdst),
        _slices(mesh, bts), bvalid, placement=placement,
        exchange_capacity=shard_cfg.exchange_capacity,
        node_capacity=node_capacity, bias_scale=bias_scale, table=table)
    return ShardedWindowState(
        window=new, exchange_drops=tuple(
            x + dx for x, dx in zip(state.exchange_drops, x_drop)))


# the reference's non-donating twin, which the sharded serving snapshot
# double buffer advances through: the port's ingest_sharded already
# writes nothing it was given
ingest_sharded_nodonate = ingest_sharded


# ---------------------------------------------------------------------------
# Sharded replay: every batch on the device, one read back at the end
# ---------------------------------------------------------------------------


def _check_supported(wcfg: WalkConfig, scfg: SamplerConfig, *,
                     lanes: bool = False) -> None:
    """Validation of a sharded walk dispatch: the start-mode checks here,
    every sampler-capability refusal through
    ``walk_engine.check_capabilities(..., sharded=True)``."""
    if lanes:
        if wcfg.start_mode not in ("nodes", "edges"):
            raise ValueError(
                "sharded lane serving supports start_mode 'nodes'|'edges' "
                f"(got {wcfg.start_mode!r})")
    elif wcfg.start_mode != "all_nodes":
        raise ValueError(
            "sharded streaming walks require start_mode='all_nodes' (start "
            "placement must be owner-computable without global state; got "
            f"{wcfg.start_mode!r})")
    check_capabilities(scfg, "grouped",
                       LaneFeatures() if lanes else None, sharded=True)


def serve_lanes_sharded(state: ShardedWindowState, view: TsView, key,
                        lanes: LaneParams, *, mesh: ShardGroup,
                        node_capacity: int, wcfg: WalkConfig,
                        scfg: SamplerConfig, shard_cfg: ShardConfig,
                        placement: Optional[Placement] = None,
                        with_probes: bool = False):
    """One coalesced lane batch over the node-partitioned window.

    ``state`` is the sharded window (read, never written: the serving
    snapshot keeps it readable across launches), ``view`` the ts view of
    the same window version, ``key`` the service's stable base key and
    ``lanes`` the packed per-lane params on the first shard's device.
    Returns (nodes, times, lengths, drops, claims) on that device: the
    walks shaped like the single-device ``generate_walk_lanes`` result,
    and two int32[D] counters, ``drops`` (start-slot + migration
    overflow; 0 under healthy provisioning, as the bit-identity guarantee
    needs) and ``claims`` (start lanes claimed by each shard, the source
    of ``ServeStats.lanes_by_shard`` in both start modes).
    ``with_probes=True`` appends the serve-probe matrix int32[D,
    NUM_SERVE_PROBES] (claims, drops, hop cells per shard) for
    ``obs.flush_serve_probes``; the walks do not change. Reads nothing
    back to the host.
    """
    _check_supported(wcfg, scfg, lanes=True)
    D = mesh.size
    if placement is None:
        placement = RangePlacement(num_shards=D, node_capacity=node_capacity)
    home = mesh.devices[0]
    # every draw of the batch at once: row t is tag t (the start draw,
    # then one per hop) of each lane, the single-device lane streams
    lane_keys = _lane_keys(key, lanes)
    tags = torch.arange(wcfg.max_length + 1, device=lane_keys.device)
    draws = mesh.replicate(_lane_uniform(lane_keys, tags[:, None]))
    nodes, times, lengths, drops, claims, hops = _shard_walk_lanes(
        mesh, [w.index for w in state.window],
        _per_device(mesh, lambda dev: tree_to(view, dev)),
        _per_device(mesh, lambda dev: tree_to(lanes, dev)), draws, wcfg,
        placement=placement, walk_slots=shard_cfg.walk_slots,
        walk_bucket_capacity=shard_cfg.walk_bucket_capacity)

    def stack(xs):
        return torch.stack([x.to(home) for x in xs])
    outs = (nodes, times, lengths, stack(drops), stack(claims))
    if with_probes:
        sp = torch.zeros((D, NUM_SERVE_PROBES), dtype=torch.int32,
                         device=home)
        sp[:, SP_LANES_CLAIMED] = outs[4]
        sp[:, SP_WALK_DROPS] = outs[3]
        sp[:, SP_HOPS] = stack(hops)
        outs = outs + (sp,)
    return outs


def _replay_scan_sharded(state: ShardedWindowState, bsrc, bdst, bts, bcount,
                         key, *, mesh: ShardGroup, node_capacity: int,
                         wcfg: WalkConfig, scfg: SamplerConfig,
                         shard_cfg: ShardConfig, bias_scale: float = 1.0,
                         placement: Optional[Placement] = None,
                         with_probes: bool = False):
    """Replay K stacked batches over the sharded window on the device.

    ``bsrc/bdst/bts`` are [K, D, Bd] (the batch axis pre-split per
    shard), ``bcount`` [K]. Returns (new state, per-batch ``ReplayStats``
    of [K] tensors, exchange drops [K, D], walk drops [K, D], final-batch
    nodes, times, lengths) on the first shard's device; ``with_probes``
    appends the probe matrix int32[D, NUM_REPLAY_PROBES] (shard-local
    counters, the emitted-walk count on shard 0). The key chain is the
    single-device ``replay_scan``'s.
    """
    D = mesh.size
    if placement is None:
        placement = RangePlacement(num_shards=D, node_capacity=node_capacity)
    home = mesh.devices[0]
    K, Bd = bsrc.shape[0], bsrc.shape[-1]
    wstates = state.window
    xdrops = state.exchange_drops
    pv = ([replay_probe_zeros(dev) for dev in mesh.devices]
          if with_probes else None)
    rows, x_rows, w_rows = [], [], []
    walks = None
    for i in range(K):
        key, sub = prng.split(key)
        w0 = wstates
        wstates, x_drop = _shard_ingest(
            mesh, wstates, _slices(mesh, bsrc[i]), _slices(mesh, bdst[i]),
            _slices(mesh, bts[i]), _batch_valid(mesh, Bd, bcount[i]),
            placement=placement,
            exchange_capacity=shard_cfg.exchange_capacity,
            node_capacity=node_capacity, bias_scale=bias_scale)
        xdrops = tuple(x + dx for x, dx in zip(xdrops, x_drop))
        # the single-device replay's key chain
        walk_key = prng.split(sub)[1]
        walks = _shard_walks(
            mesh, [w.index for w in wstates], walk_key, wcfg, scfg,
            placement=placement, walk_slots=shard_cfg.walk_slots,
            walk_bucket_capacity=shard_cfg.walk_bucket_capacity,
            count_hops=with_probes)
        nodes, times, lengths, w_drop, hops = walks

        def total(values):
            return mesh.psum(list(values))[0]
        rows.append((total(w.index.num_edges for w in wstates),
                     wstates[0].t_now,
                     total(w.ingested for w in wstates),
                     total(w.late_drops for w in wstates),
                     total(w.overflow_drops for w in wstates),
                     lengths.sum().to(torch.float32) / lengths.shape[0]))
        x_rows.append(torch.stack([x.to(home) for x in x_drop]))
        w_rows.append(torch.stack([x.to(home) for x in w_drop]))
        if with_probes:
            emitted = (lengths >= 2).sum(dtype=torch.int32)
            for d in range(D):
                pv[d] = replay_probe_update(
                    pv[d],
                    ingested_delta=wstates[d].ingested - w0[d].ingested,
                    late_delta=wstates[d].late_drops - w0[d].late_drops,
                    overflow_delta=(wstates[d].overflow_drops
                                    - w0[d].overflow_drops),
                    exchange_drops=x_drop[d], walk_drops=w_drop[d],
                    hops=hops[d])
            # the emitted-walk count is global: shard 0 records it
            pv[0][RP_WALKS_EMITTED] += emitted.to(pv[0].device)
    stats = ReplayStats(*(torch.stack([r[j].to(home) for r in rows])
                          for j in range(len(ReplayStats._fields))))
    new_state = ShardedWindowState(window=wstates, exchange_drops=xdrops)
    nodes, times, lengths = walks[:3]
    outs = (new_state, stats, torch.stack(x_rows), torch.stack(w_rows),
            nodes, times, lengths)
    if with_probes:
        outs = outs + (torch.stack([p.to(home) for p in pv]),)
    return outs


def _warm_placement(placement: Placement, group: ShardGroup) -> None:
    """Put the placement's constant tables on every shard device now, so
    no owner lookup inside a replay copies them from the host."""
    for dev in dict.fromkeys(group.devices):
        placement.owner(torch.zeros(1, dtype=torch.int32, device=dev))


class DistributedStreamingEngine:
    """Streaming ingest → rebuild → walk over a node-partitioned window.

    The distributed counterpart of ``StreamingEngine.replay_device``: the
    window is sharded over ``mesh`` (per-shard capacity
    ``cfg.shard.edge_capacity_per_shard``), batches ingest through one
    exchange per batch, and walks migrate between owners every hop. For
    ``SamplerConfig.mode="index"`` the replay is bit-identical to the
    single-device engine for the same seed, at any shard count and under
    any placement, provided nothing drops (see ``DistReplayStats``).

    The shards are ``mesh`` (a ``ShardGroup``), else the first
    ``num_shards`` (default ``cfg.shard.num_shards``, 0 for all) of
    ``devices`` (default: the visible CUDA devices). ``devices`` is also
    the pool a reshard to more shards draws from: ``devices=[dev] * 8``
    with ``num_shards=4`` runs four shards on one device and may grow to
    eight there.
    """

    def __init__(self, cfg: EngineConfig, batch_capacity: int, *,
                 mesh: Optional[ShardGroup] = None, num_shards: int = 0,
                 devices=None, placement: Optional[Placement] = None,
                 registry: Optional[MetricsRegistry] = None,
                 probes: bool = True):
        self.cfg = cfg
        self.registry = registry if registry is not None else get_registry()
        self.probes = probes
        if mesh is not None:
            self._pool = list(mesh.devices)
        else:
            self._pool = (list(devices) if devices is not None
                          else visible_devices())
            mesh = make_group(num_shards or cfg.shard.num_shards, self._pool)
        self.mesh = mesh
        D = mesh.size
        self.num_shards = D
        if placement is None:
            placement = make_placement(
                cfg.shard.placement, D, cfg.window.node_capacity,
                hash_buckets=cfg.shard.hash_buckets)
        if placement.num_shards != D:
            raise ValueError(
                f"placement covers {placement.num_shards} shards; mesh has "
                f"{D} devices")
        if placement.node_capacity != cfg.window.node_capacity:
            raise ValueError(
                f"placement node_capacity {placement.node_capacity} != "
                f"window node_capacity {cfg.window.node_capacity}")
        self.placement = placement
        _warm_placement(placement, mesh)
        # per-shard batch slice: the capacity rounded up to a D multiple
        self._requested_batch_capacity = batch_capacity
        self.batch_slice = -(-batch_capacity // D)
        self.batch_capacity = self.batch_slice * D
        self.state = init_sharded_window(
            D, cfg.shard.edge_capacity_per_shard, cfg.window.node_capacity,
            int(cfg.window.duration), mesh=mesh)
        self.key = prng.PRNGKey(cfg.seed)

    @property
    def home(self) -> torch.device:
        return self.mesh.devices[0]

    def _sync(self) -> None:
        for dev in dict.fromkeys(self.mesh.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def ingest_batch(self, src, dst, ts) -> None:
        """Advance the sharded window by one batch (no walks)."""
        batch = make_batch(src, dst, ts, capacity=self.batch_capacity,
                           device=self.home)

        def split(a):
            return a.reshape(self.num_shards, self.batch_slice)
        self.state = ingest_sharded(
            self.state, split(batch.src), split(batch.dst), split(batch.ts),
            batch.count, mesh=self.mesh,
            node_capacity=self.cfg.window.node_capacity,
            shard_cfg=self.cfg.shard, placement=self.placement)

    def replay_device(self, batches, wcfg: WalkConfig):
        """All batches on the device; the statistics, drop counters, probe
        matrix and shard loads come back in one copy at the end. Returns
        (DistReplayStats, final-batch WalkResult of numpy arrays, wall
        seconds)."""
        _check_supported(wcfg, self.cfg.sampler)
        stacked = stack_batches(batches, self.batch_capacity,
                                device=self.home)
        K, D = stacked.src.shape[0], self.num_shards

        def split(a):
            return a.reshape(K, D, self.batch_slice)
        self.key, sub = prng.split(self.key)
        self._sync()
        t0 = time.perf_counter()
        outs = _replay_scan_sharded(
            self.state, split(stacked.src), split(stacked.dst),
            split(stacked.ts), stacked.count, sub, mesh=self.mesh,
            node_capacity=self.cfg.window.node_capacity, wcfg=wcfg,
            scfg=self.cfg.sampler, shard_cfg=self.cfg.shard,
            placement=self.placement, with_probes=self.probes)
        (self.state, stats, x_drops, w_drops, nodes, times,
         lengths) = outs[:7]
        # one int32 copy: the stats rows (mean_len by its bits), the drop
        # counters, the probe matrix and the shard loads
        words = [torch.stack([a if a.dtype == torch.int32
                              else a.view(torch.int32) for a in stats])
                 .reshape(-1), x_drops.reshape(-1), w_drops.reshape(-1),
                 torch.stack([w.index.num_edges.to(self.home)
                              for w in self.state.window])]
        if self.probes:
            words.append(outs[7].reshape(-1))
        host = torch.cat(words).cpu().numpy()
        elapsed = time.perf_counter() - t0
        nf = len(ReplayStats._fields)
        rows = host[:nf * K].reshape(nf, K)
        replay = ReplayStats(*(
            rows[i].view(np.float32) if f == "mean_len" else rows[i]
            for i, f in enumerate(ReplayStats._fields)))
        at = nf * K
        x_host = host[at:at + K * D].reshape(K, D)
        w_host = host[at + K * D:at + 2 * K * D].reshape(K, D)
        at += 2 * K * D
        loads = host[at:at + D]
        if self.probes:
            pv = host[at + D:].reshape(D, NUM_REPLAY_PROBES)
            self._publish_replay(pv, replay, elapsed, loads)
        dstats = DistReplayStats(replay=replay, exchange_drops=x_host,
                                 walk_drops=w_host)
        walks = WalkResult(nodes=nodes.cpu().numpy(),
                           times=times.cpu().numpy(),
                           lengths=lengths.cpu().numpy(), stats=None)
        return dstats, walks, elapsed

    def _publish_replay(self, pv, replay: ReplayStats, elapsed: float,
                        loads) -> None:
        """Flush the per-shard probe rows and the window gauges after a
        replay's one copy back."""
        reg = self.registry
        for d in range(pv.shape[0]):
            flush_replay_probes(reg, pv[d], driver="sharded", shard=d)
        for d, v in enumerate(loads):
            reg.set_gauge("shard_edges_active", int(v),
                          labels={"shard": str(d)},
                          help="resident window edges per shard")
        cap = self.cfg.shard.edge_capacity_per_shard * self.num_shards
        edges = int(replay.edges_active[-1]) if replay.edges_active.size \
            else 0
        reg.set_gauge("window_edges_active", edges,
                      help="edges resident in the temporal window")
        reg.set_gauge("window_t_now",
                      int(replay.t_now[-1]) if replay.t_now.size else 0,
                      help="watermark timestamp of the window")
        reg.set_gauge("window_occupancy", edges / cap,
                      help="window fill fraction (edges_active / capacity)")
        reg.observe("replay_seconds", elapsed, labels={"driver": "sharded"},
                    help="wall time per replay_device call")

    # ------------------------------------------------------------------
    # Placement control plane: measured load -> new placement -> reshard
    # ------------------------------------------------------------------

    def node_loads(self) -> np.ndarray:
        """Per-node in-window out-degree [node_capacity] (host-side): the
        skew signal ``SkewPlacement.from_loads`` reads."""
        nc = self.cfg.window.node_capacity
        ns = np.stack([w.index.node_starts.cpu().numpy().astype(np.int64)
                       for w in self.state.window])
        return (ns[:, 1:] - ns[:, :-1]).sum(axis=0)[:nc]

    def shard_loads(self) -> np.ndarray:
        """Resident window edges per shard [D] (the imbalance metric)."""
        return torch.stack([w.index.num_edges.to(self.home)
                            for w in self.state.window]).cpu().numpy()

    def reshard_to(self, new_placement: Placement) -> None:
        """Live reshard: re-bucket the resident window onto
        ``new_placement`` (another policy and/or shard count) through one
        exchange; ingest and replay go on against the new layout with
        the walk RNG chain untouched."""
        before = int(sum(int(x) for x in self.state.exchange_drops))
        Dm = max(self.num_shards, new_placement.num_shards)
        self.state, self.mesh = reshard(
            self.state, self.placement, new_placement,
            mesh=make_group(Dm, self._pool))
        # the reshard's own contribution is the per-shard capacity clip
        after = int(sum(int(x) for x in self.state.exchange_drops))
        count_drop(self.registry, "reshard_clip", max(0, after - before))
        self.registry.inc("reshards_total", 1,
                          help="live placement reshards executed")
        self.placement = new_placement
        _warm_placement(new_placement, self.mesh)
        D = new_placement.num_shards
        self.num_shards = D
        self.batch_slice = -(-self._requested_batch_capacity // D)
        self.batch_capacity = self.batch_slice * D

    def rebalance(self, k: Optional[int] = None) -> Placement:
        """Measure per-node load, build a top-K hub override placement on
        the current base policy, and reshard onto it. Returns the new
        placement."""
        base = (self.placement.base
                if isinstance(self.placement, SkewPlacement)
                else self.placement)
        new = SkewPlacement.from_loads(
            base, self.node_loads(),
            k=k if k is not None else self.cfg.shard.hot_k)
        self.reshard_to(new)
        return new


# ---------------------------------------------------------------------------
# Live resharding: re-bucket a resident window under a new placement
# ---------------------------------------------------------------------------


def _pad_shards(state: ShardedWindowState, devices) -> ShardedWindowState:
    """Append one empty shard slice per entry of ``devices`` (same Δ,
    zeroed clock and counters), for a reshard that grows the shard
    count. Their t_now starts at 0 and is repaired by the reshard's
    ``pmax``."""
    w = state.window[0]
    E = w.index.store.capacity
    nc = w.index.node_capacity
    delta = int(w.window)
    pad = tuple(init_window(E, nc, delta, device=d) for d in devices)
    return ShardedWindowState(
        window=state.window + pad,
        exchange_drops=state.exchange_drops + tuple(
            torch.zeros((), dtype=torch.int32, device=d) for d in devices))


def _reshard_impl(state: ShardedWindowState, *, mesh: ShardGroup,
                  placement: Placement, bias_scale: float = 1.0
                  ) -> ShardedWindowState:
    """The reshard over a max(D_old, D_new)-shard group.

    Each shard sends every resident edge to ``placement.owner(src)`` with
    (sender, destination) capacity E: a sender holds at most E edges, so
    the exchange never drops. The receiver re-merges by the canonical
    rule: received runs in old-shard order with sender positions kept,
    one stable ts sort (ties break by (old shard, position)), then a clip
    keeping the newest E edges, its loss counted in ``exchange_drops``.
    The counters' sums (``ingested``, ``late_drops``, ``overflow_drops``,
    ``exchange_drops``) move onto shard 0, zeros elsewhere."""
    Dm = mesh.size
    nc = placement.node_capacity
    stores = [w.index.store for w in state.window]
    E = stores[0].capacity
    i32 = torch.int32
    received, _, x_drop = exchange_by_owner(
        mesh, E, [placement.owner(s.src) for s in stores],
        [torch.arange(E, dtype=i32, device=s.src.device) < s.num_edges
         for s in stores],
        [(s.src, s.dst, s.ts) for s in stores], (nc, 0, TS_PAD))
    del stores
    # clock: pmax repairs padded shards' zero t_now / Δ
    t_now = mesh.pmax([w.t_now for w in state.window])
    delta = mesh.pmax([w.window for w in state.window])
    sums = {f: mesh.psum([getattr(w, f) for w in state.window])
            for f in ("ingested", "late_drops", "overflow_drops")}
    x_sum = mesh.psum([x + dx for x, dx in zip(state.exchange_drops,
                                               x_drop)])
    windows, xdrops = [], []
    for d in range(Dm):
        r_src, r_dst, r_ts = received[d]
        received[d] = None
        dev = r_ts.device
        order = torch.sort(r_ts, stable=True).indices
        cnt = (r_ts != TS_PAD).sum(dtype=i32)
        overflow = (cnt - E).clamp(min=0)
        ar = torch.arange(E, dtype=i32, device=dev)
        gidx = (ar + overflow).clamp(0, Dm * E - 1).long()
        live = ar < cnt.clamp(max=E)
        rows = order[gidx]
        store = EdgeStore(
            src=torch.where(live, r_src[rows], nc),
            dst=torch.where(live, r_dst[rows], 0),
            ts=torch.where(live, r_ts[rows], TS_PAD),
            num_edges=cnt.clamp(max=E).to(i32))
        del order, rows, r_src, r_dst, r_ts
        zero = torch.zeros((), dtype=i32, device=dev)
        windows.append(WindowState(
            index=build_index(store, nc, bias_scale), t_now=t_now[d],
            window=delta[d],
            **{f: (s[d] if d == 0 else zero) for f, s in sums.items()}))
        xdrops.append((x_sum[d] if d == 0 else zero) + overflow)
    return ShardedWindowState(window=tuple(windows),
                              exchange_drops=tuple(xdrops))


def reshard(state: ShardedWindowState, old_placement: Placement,
            new_placement: Placement, *, mesh: Optional[ShardGroup] = None,
            bias_scale: float = 1.0):
    """Re-bucket a resident sharded window from one placement to another.

    One exchange and a per-shard canonical re-merge (``_reshard_impl``).
    A shard-count change runs the exchange over max(D_old, D_new) shards
    (``mesh``, default the visible devices): a growing window gains
    empty slices first, a shrinking one is truncated after (shards past
    D_new receive nothing, since every owner is below D_new). Nothing is
    lost but the counted per-shard capacity clip. Returns
    ``(new_state, new_mesh)``, the latter the first D_new shards."""
    D_old = len(state.window)
    D_new = new_placement.num_shards
    if old_placement.num_shards != D_old:
        raise ValueError(
            f"old placement covers {old_placement.num_shards} shards; "
            f"state has {D_old}")
    if old_placement.node_capacity != new_placement.node_capacity:
        raise ValueError("placements disagree on node_capacity")
    Dm = max(D_old, D_new)
    if mesh is None:
        mesh = window_mesh(Dm)
    elif mesh.size != Dm:
        raise ValueError(
            f"reshard mesh must span max(D_old, D_new) = {Dm} devices "
            f"(got {mesh.size})")
    # each shard on the group's device for it
    state = ShardedWindowState(*(
        tuple(tree_to(x, dev) for x, dev in zip(leaves, mesh.devices))
        for leaves in state))
    if D_old < Dm:
        state = _pad_shards(state, mesh.devices[D_old:])
    new_state = _reshard_impl(state, mesh=mesh, placement=new_placement,
                              bias_scale=bias_scale)
    if D_new < Dm:
        new_state = ShardedWindowState(
            window=new_state.window[:D_new],
            exchange_drops=new_state.exchange_drops[:D_new])
    return new_state, mesh.sub(D_new)


def reshard_host(state: ShardedWindowState, new_placement: Placement,
                 bias_scale: float = 1.0, *,
                 mesh: Optional[ShardGroup] = None) -> ShardedWindowState:
    """Numpy mirror of ``reshard``'s canonical merge (no exchange): per new
    shard, the old shards' owned edges concatenated in old-shard order
    (positions kept), one stable ts sort, a clip keeping the newest E.
    Device and host reshards agree bitwise. The new shards' indexes are
    built on ``mesh``'s devices (default: the visible devices)."""
    w = state.window
    src = [x.index.store.src.cpu().numpy() for x in w]
    dst = [x.index.store.dst.cpu().numpy() for x in w]
    ts = [x.index.store.ts.cpu().numpy() for x in w]
    n = [int(x.index.store.num_edges) for x in w]
    D_old, E = len(w), src[0].shape[0]
    D_new = new_placement.num_shards
    nc = new_placement.node_capacity
    group = mesh if mesh is not None else window_mesh(D_new)
    if group.size != D_new:
        raise ValueError(f"{D_new} shards on a group of {group.size}")

    owners = [new_placement.owner_np(src[s][:n[s]]) for s in range(D_old)]
    t_now = max(int(x.t_now) for x in w)
    delta = max(int(x.window) for x in w)
    totals = {f: sum(int(getattr(x, f)) for x in w)
              for f in ("ingested", "late_drops", "overflow_drops")}
    windows, xdrops = [], np.zeros(D_new, np.int64)
    for d in range(D_new):
        dev = group.devices[d]
        sel = [owners[s] == d for s in range(D_old)]
        csrc = np.concatenate([src[s][:n[s]][sel[s]] for s in range(D_old)])
        cdst = np.concatenate([dst[s][:n[s]][sel[s]] for s in range(D_old)])
        cts = np.concatenate([ts[s][:n[s]][sel[s]] for s in range(D_old)])
        order = np.argsort(cts, kind="stable")
        csrc, cdst, cts = csrc[order], cdst[order], cts[order]
        overflow = max(len(cts) - E, 0)
        xdrops[d] = overflow
        csrc, cdst, cts = csrc[overflow:], cdst[overflow:], cts[overflow:]
        cnt = len(cts)

        def col(a, fill):
            return torch.as_tensor(np.pad(a, (0, E - cnt),
                                          constant_values=fill)
                                   .astype(np.int32)).to(dev)

        def z(v):
            return torch.tensor(v, dtype=torch.int32).to(dev)
        store = EdgeStore(src=col(csrc, nc), dst=col(cdst, 0),
                          ts=col(cts, TS_PAD), num_edges=z(cnt))
        windows.append(WindowState(
            index=build_index(store, nc, bias_scale), t_now=z(t_now),
            window=z(delta),
            **{f: z(v if d == 0 else 0) for f, v in totals.items()}))
    xdrops[0] += sum(int(x) for x in state.exchange_drops)
    return ShardedWindowState(
        window=tuple(windows),
        exchange_drops=tuple(torch.tensor(int(v), dtype=torch.int32)
                             .to(group.devices[d])
                             for d, v in enumerate(xdrops)))
