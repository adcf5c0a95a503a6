"""Distributed walk engine: node-partitioned edge store and per-step walk
migration, PyTorch port of core/distributed.py.

* Nodes are partitioned across shards by a ``Placement``
  (distributed/placement.py; default range). Each shard holds the dual
  index of exactly its nodes' out-edges, so a resident walk's Γ_t(v) is
  always served locally.
* Each step: a local hop (``hop_resident``), walks bucketed by their
  destination's owner, one ``all_to_all`` moving the payloads (id, node,
  time and trace), and the received walks compacted into free slots.
* RNG is keyed by (walk id, step) through ``fold_in``, so the walks do
  not depend on the placement or the shard count.
* Buckets have a fixed capacity; overflow drops are counted.

Each shard step is written as per-shard phases around the collective
(distributed/collectives.py): ``bucket_slots`` ranks one shard's rows and
``send_buffer`` fills its send buffers, ``ShardGroup.all_to_all`` moves
them, and the receiver's compaction runs on its own tensors.
``exchange_by_owner`` is that sequence over every shard of a group. A sharded value is a tuple with
one entry per shard, each on its shard's device.

``exchange_by_owner`` and ``hop_resident`` are shared with the streaming
side of the same partition (distributed/streaming_shard.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.configs.base import SamplerConfig
from repro_torch.core.edge_store import store_from_arrays
from repro_torch.core.samplers import (
    pick_in_neighborhood,
    pick_in_neighborhood_lanes,
)
from repro_torch.core.temporal_index import (
    TemporalIndex,
    build_index,
    node_range,
    temporal_cutoff,
)
from repro_torch.core.walk_engine import NODE_PAD
from repro_torch.distributed.collectives import ShardGroup, make_group


class ShardedWalkState(NamedTuple):
    """Resident walk rows of every shard: each field a tuple of D
    per-shard tensors (``dropped`` of 0-d int32 counters)."""

    walk_id: Tuple[torch.Tensor, ...]    # int32[Wd] each (-1 = empty slot)
    cur_node: Tuple[torch.Tensor, ...]   # int32[Wd]
    cur_time: Tuple[torch.Tensor, ...]   # int32[Wd]
    alive: Tuple[torch.Tensor, ...]      # bool[Wd]
    trace_n: Tuple[torch.Tensor, ...]    # int32[Wd, L+1]
    trace_t: Tuple[torch.Tensor, ...]    # int32[Wd, L+1]
    length: Tuple[torch.Tensor, ...]     # int32[Wd]
    dropped: Tuple[torch.Tensor, ...]    # int32 bucket-overflow counter


def _group(mesh: Optional[ShardGroup], num_shards: int) -> ShardGroup:
    return mesh if mesh is not None else make_group(num_shards)


def partition_edges(src, dst, ts, num_nodes: int, num_shards: int,
                    edge_capacity_per_shard: int, placement=None, *,
                    mesh: Optional[ShardGroup] = None):
    """Host-side: partition edges by their source's owner (``placement``,
    default range) and build one TemporalIndex per shard, each on its
    shard's device (``mesh``, default the visible devices). Returns
    (tuple of indexes, placement)."""
    if placement is None:
        from repro_torch.distributed.placement import RangePlacement
        placement = RangePlacement(num_shards=num_shards,
                                   node_capacity=num_nodes)
    group = _group(mesh, num_shards)
    owners = placement.owner_np(np.asarray(src))
    indexes = []
    for d in range(num_shards):
        sel = owners == d
        store = store_from_arrays(
            np.asarray(src)[sel], np.asarray(dst)[sel], np.asarray(ts)[sel],
            edge_capacity=edge_capacity_per_shard, node_capacity=num_nodes,
            device=group.devices[d])
        indexes.append(build_index(store, num_nodes))
    return tuple(indexes), placement


def init_sharded_walks(num_shards: int, walks_per_shard: int,
                       max_length: int, start_nodes, start_times,
                       placement, *, mesh: Optional[ShardGroup] = None
                       ) -> ShardedWalkState:
    """Place walks on their start node's owner (host-side)."""
    D, Wd, L = num_shards, walks_per_shard, max_length
    wid = np.full((D, Wd), -1, np.int32)
    node = np.zeros((D, Wd), np.int32)
    tme = np.zeros((D, Wd), np.int32)
    alive = np.zeros((D, Wd), bool)
    tn = np.full((D, Wd, L + 1), NODE_PAD, np.int32)
    tt = np.full((D, Wd, L + 1), NODE_PAD, np.int32)
    ln = np.zeros((D, Wd), np.int32)
    fill = np.zeros(D, np.int32)
    start_owner = placement.owner_np(np.asarray(start_nodes))
    for i, (v, t) in enumerate(zip(np.asarray(start_nodes),
                                   np.asarray(start_times))):
        d = int(start_owner[i])
        s = fill[d]
        if s >= Wd:
            raise ValueError(f"shard {d} start overflow")
        wid[d, s] = i
        node[d, s] = v
        tme[d, s] = t
        alive[d, s] = True
        tn[d, s, 0] = v
        tt[d, s, 0] = t
        ln[d, s] = 1
        fill[d] += 1
    group = _group(mesh, num_shards)

    def put(a):
        return tuple(torch.as_tensor(a[d]).to(group.devices[d])
                     for d in range(D))
    return ShardedWalkState(
        walk_id=put(wid), cur_node=put(node), cur_time=put(tme),
        alive=put(alive), trace_n=put(tn), trace_t=put(tt), length=put(ln),
        dropped=put(np.zeros(D, np.int32)))


def owner_range_size(num_nodes: int, num_shards: int) -> int:
    """Node-range width per shard: owner(v) = v // owner_range_size(...)."""
    return math.ceil(num_nodes / num_shards)


def hop_resident(idx: TemporalIndex, scfg: SamplerConfig, node, time, alive,
                 u):
    """One local hop for resident rows given per-row uniforms: Γ_t(v)
    lives entirely on v's owner, so the cutoff, the pick and the gather
    are shard-local. Returns (next_node, next_time, has_next); rows
    without a next hop keep their (node, time)."""
    a, b = node_range(idx, node)
    c = temporal_cutoff(idx, a, b, time)
    has = alive & (b - c > 0)
    k = pick_in_neighborhood(idx, scfg, c, b, u, node)
    k = k.clamp(0, idx.edge_capacity - 1).long()
    return (torch.where(has, idx.ns_dst[k], node),
            torch.where(has, idx.ns_ts[k], time), has)


def hop_resident_lanes(idx: TemporalIndex, code, node, time, alive, u):
    """``hop_resident`` with a per-row bias code instead of a config bias
    (sharded lane serving, DESIGN.md §13): the pick is a pure function of
    (code, u, |Γ_t(v)|), as in the single-device lane engine."""
    a, b = node_range(idx, node)
    c = temporal_cutoff(idx, a, b, time)
    has = alive & (b - c > 0)
    k = pick_in_neighborhood_lanes(idx, code, c, b, u)
    k = k.clamp(0, idx.edge_capacity - 1).long()
    return (torch.where(has, idx.ns_dst[k], node),
            torch.where(has, idx.ns_ts[k], time), has)


def bucket_slots(num_shards: int, capacity: int, owner, valid):
    """One shard's ranking before the collective: each valid row's rank
    within its destination bucket, in row order. A row ranked at or past
    ``capacity`` is not sent. Returns (flat send slot of each row —
    ``owner·capacity + rank``, or the sink ``num_shards·capacity`` — the
    ``fits`` mask of rows sent, and the int32 count of valid rows not
    sent)."""
    D = num_shards
    n = owner.shape[0]
    dev = owner.device
    owner = torch.where(valid, owner.to(torch.int32), D)
    # a stable sort by owner keeps row order inside each bucket
    sorted_owner, order = torch.sort(owner, stable=True)
    first = torch.searchsorted(sorted_owner, sorted_owner, side="left",
                               out_int32=True)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    rank[order] = torch.arange(n, dtype=torch.int32, device=dev) - first
    fits = (rank < capacity) & valid
    n_drop = (valid & ~fits).sum(dtype=torch.int32)
    slot = torch.where(fits, owner.to(torch.int64) * capacity + rank,
                       D * capacity)
    return slot, fits, n_drop


def send_buffer(slot, num_shards: int, capacity: int,
                payload: torch.Tensor, fill) -> torch.Tensor:
    """One payload's send buffer ``[num_shards, capacity, ...]``, unsent
    rows scattered into a sink slot that is cut off."""
    sink = num_shards * capacity
    tail = tuple(payload.shape[1:])
    buf = torch.full((sink + 1,) + tail, fill, dtype=payload.dtype,
                     device=payload.device)
    buf[slot] = payload
    return buf[:sink].view((num_shards, capacity) + tail)


def exchange_by_owner(group: ShardGroup, capacity: int, owners, valids,
                      payloads, fills):
    """Bucket every shard's rows by destination shard and move them with
    one ``all_to_all`` per payload.

    ``owners[s]``/``valids[s]`` are shard s's [n] destination ids and live
    mask, ``payloads[s]`` its tuple of [n, ...] tensors, ``fills`` the
    padding value of each payload. Each (sender, destination) bucket holds
    ``capacity`` rows; a valid row ranked past it is not sent and is
    counted. Returns (received payload tuples ``[D * capacity, ...]`` per
    shard, ``fits`` per shard, drop count per shard). Receivers see each
    sender's rows contiguously, in sender order and sender position order.
    The send buffers of one payload are freed before the next is built.
    """
    D = group.size
    ranked = [bucket_slots(D, capacity, owners[s], valids[s])
              for s in range(D)]
    moved = [group.all_to_all([
        send_buffer(ranked[s][0], D, capacity, payloads[s][j], fills[j])
        for s in range(D)]) for j in range(len(fills))]
    received = [tuple(m[d] for m in moved) for d in range(D)]
    return received, [r[1] for r in ranked], [r[2] for r in ranked]


def _walker_uniforms(wid: torch.Tensor, step: int) -> torch.Tensor:
    """The static walker's per-(walk, step) draw:
    ``uniform(fold_in(fold_in(PRNGKey(0), step), w), ())``."""
    base = prng.fold_in(prng.PRNGKey(0), step)     # host key: no copy
    return prng.uniform_lanes(prng.fold_in_lanes(base, wid))


def make_distributed_walker(mesh: ShardGroup, index_shards, scfg:
                            SamplerConfig, *, placement, max_length: int,
                            bucket_capacity: int):
    """Returns a function advancing all walks ``max_length`` steps over
    the shards of ``mesh`` (``index_shards[d]`` on shard d)."""
    D = mesh.size
    indexes = tuple(index_shards)

    def step_fn(leaves, step: int):
        (wid, node, time, alive, tn, tt, ln, dropped) = leaves
        sends = []
        kept = []
        for d in range(D):
            u = _walker_uniforms(wid[d], step)
            nn, nt, has = hop_resident(indexes[d], scfg, node[d], time[d],
                                       alive[d], u)
            # record the hop locally before migration
            col = torch.arange(tn[d].shape[1], device=nn.device)
            at = has[:, None] & (col == ln[d][:, None])
            tn_d = torch.where(at, nn[:, None], tn[d])
            tt_d = torch.where(at, nt[:, None], tt[d])
            ln_d = ln[d] + has.to(torch.int32)
            occupied = wid[d] >= 0
            # dead-but-occupied walks stay put (their trace lives here);
            # only alive walks migrate to their destination's owner
            sends.append((placement.owner(nn), has & occupied,
                          (wid[d], nn, nt, tn_d, tt_d, ln_d)))
            kept.append((occupied, has, tn_d, tt_d, ln_d))
        received, fits, n_drop = exchange_by_owner(
            mesh, bucket_capacity, [s[0] for s in sends],
            [s[1] for s in sends], [s[2] for s in sends],
            (-1, 0, 0, NODE_PAD, NODE_PAD, 0))
        out = [[] for _ in range(8)]
        for d in range(D):
            occupied, has, tn_d, tt_d, ln_d = kept[d]
            r_wid, r_node, r_time, r_tn, r_tt, r_ln = received[d]
            Wd = wid[d].shape[0]
            dev = r_wid.device
            # bucket-overflow walks stay resident but stop
            keep = occupied & (~has | ~fits[d])
            wid_d = torch.where(keep, wid[d], -1)
            free = wid_d < 0
            free_rank = torch.cumsum(free, 0, dtype=torch.int32) - 1
            slot_of_free_rank = torch.full((Wd + 1,), Wd, dtype=torch.int32,
                                           device=dev)
            slot_of_free_rank[torch.where(free, free_rank, Wd).long()] = \
                torch.arange(Wd, dtype=torch.int32, device=dev)
            inc_valid = r_wid >= 0
            inc_rank = torch.cumsum(inc_valid, 0, dtype=torch.int32) - 1
            # an incoming walk ranked past the last slot is dropped
            dest = torch.where(inc_valid & (inc_rank < Wd),
                               slot_of_free_rank[inc_rank.clamp(
                                   0, Wd - 1).long()], Wd)
            recv_drop = (inc_valid & (dest >= Wd)).sum(dtype=torch.int32)
            dl = dest.long()

            def place(cur, payload):
                buf = torch.cat([cur, cur[:1]])
                buf[dl] = payload
                return buf[:Wd]

            out[0].append(place(wid_d, r_wid))
            out[1].append(place(torch.where(keep, node[d], 0), r_node))
            out[2].append(place(torch.where(keep, time[d], 0), r_time))
            out[3].append(place(torch.zeros_like(alive[d]), inc_valid))
            out[4].append(place(torch.where(keep[:, None], tn_d, NODE_PAD),
                                r_tn))
            out[5].append(place(torch.where(keep[:, None], tt_d, NODE_PAD),
                                r_tt))
            out[6].append(place(torch.where(keep, ln_d, 0), r_ln))
            out[7].append(dropped[d] + n_drop[d] + recv_drop)
        return tuple(tuple(o) for o in out)

    def run(state: ShardedWalkState) -> ShardedWalkState:
        leaves = (state.walk_id, state.cur_node, state.cur_time, state.alive,
                  state.trace_n, state.trace_t, state.length, state.dropped)
        for step in range(max_length):
            leaves = step_fn(leaves, step)
        return ShardedWalkState(*leaves)

    return run


def gather_walks(state: ShardedWalkState, num_walks: int):
    """Assemble (nodes, times, lengths) in walk-id order (host-side)."""
    wid = np.concatenate([w.cpu().numpy() for w in state.walk_id])
    tn = np.concatenate([t.cpu().numpy() for t in state.trace_n])
    tt = np.concatenate([t.cpu().numpy() for t in state.trace_t])
    ln = np.concatenate([t.cpu().numpy() for t in state.length])
    L1 = tn.shape[-1]
    nodes = np.full((num_walks, L1), NODE_PAD, np.int32)
    times = np.full((num_walks, L1), NODE_PAD, np.int32)
    lengths = np.zeros((num_walks,), np.int32)
    for i, w in enumerate(wid):
        if w >= 0:
            nodes[w] = tn[i]
            times[w] = tt[i]
            lengths[w] = ln[i]
    return nodes, times, lengths
