"""Dispatch plane (paper §2.4.4) and per-hop lane regrouping (DESIGN.md
§10), PyTorch port of core/scheduler.py: ``dispatch_stats`` (per-hop tier
statistics and the modeled fullwalk / grouped memory traffic),
``bucket_regroup``, and two tile tables: ``tile_table``, which the fused
hop runs (the tiled hop runs its ``task_bases``), and the reference's
``build_task_table``, which no hop of either package runs.

The reference's ``segment_sum`` is a ``scatter_add`` here; every float
statistic is a float32 sum, as in the reference.

The reference groups lanes with LSD counting passes: first over a
span-scaled 16-bit quantized relative time (only when some occupied node
carries mixed times), then over the node-id digits. Each pass is stable,
so the result is the stable order of lanes by (node, quantized time) —
or by node alone. Here that is one stable sort of an int64 key
``node << 16 | time_bits``, which yields the same permutation. The
permutation is purely an execution layout (the emitted walks do not
depend on it), but the fused hop's tier split, and with it the ``tiers``
statistic, does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import SchedulerConfig
from repro_torch.core.temporal_index import node_range

# stats vector layout (per step)
STAT_ALIVE = 0            # alive walks
STAT_UNIQUE_NODES = 1     # distinct nodes carrying walks
STAT_SOLO = 2             # tasks dispatched solo (W <= solo_threshold)
STAT_GROUP_SMEM = 3       # grouped tasks whose G fits the staged tile
STAT_GROUP_GLOBAL = 4     # grouped tasks needing the global fallback
STAT_MEGA = 5             # mega-hub sub-tasks (ceil(W / max_task_walks))
STAT_BYTES_FULLWALK = 6   # modeled device bytes, per-walk layout
STAT_BYTES_GROUPED = 7    # modeled device bytes, grouped layout
STAT_FUSED_SMALL = 8      # fused tier-S lanes (span fits the staged window)
STAT_FUSED_BIG = 9        # fused tier-L lanes
STAT_FUSED_BLOCKS = 10    # modeled tier-L swept edge blocks
NUM_STATS = 11

_BYTES_PER_EDGE_ROW = 8   # (dst, ts) int32 pair
_BYTES_PER_OFFSET = 4
_TIME_SUBSORT_BITS = 16


def dispatch_stats(index, cur_node: torch.Tensor, alive: torch.Tensor,
                   cfg: SchedulerConfig) -> torch.Tensor:
    """Per-step dispatch-plane statistics, float32[NUM_STATS] (the
    reference's layout and arithmetic)."""
    nc = index.node_capacity
    node = cur_node.clamp(0, nc - 1).long()
    w_per_node = torch.zeros(nc, dtype=torch.int32, device=node.device) \
        .scatter_add_(0, node, alive.to(torch.int32))
    occupied = w_per_node > 0
    g = index.node_group_counts

    solo = occupied & (w_per_node <= cfg.solo_threshold)
    grouped = occupied & (w_per_node > cfg.solo_threshold) \
        & (w_per_node <= cfg.max_task_walks)
    mega_tasks = torch.where(
        occupied & (w_per_node > cfg.max_task_walks),
        -(-w_per_node // cfg.max_task_walks), 0)
    fits_tile = g <= cfg.tile_edges

    deg = index.node_starts[1:nc + 1] - index.node_starts[:nc]
    # modeled bytes: the search touches ~log2(deg) edge rows + 2 offsets
    probes = torch.ceil(torch.log2(deg.clamp(min=2).to(torch.float32)))
    per_lookup = probes * _BYTES_PER_EDGE_ROW + 2 * _BYTES_PER_OFFSET
    wf = w_per_node.to(torch.float32)
    bytes_full = (wf * (per_lookup + _BYTES_PER_EDGE_ROW)).sum()
    bytes_grp = (torch.where(occupied, per_lookup, 0.0)
                 + wf * _BYTES_PER_EDGE_ROW).sum()

    deg_at = deg[node]
    fused_small = alive & (deg_at <= 2 * cfg.tile_edges)
    fused_big = alive & (deg_at > 2 * cfg.tile_edges)
    fused_blocks = torch.where(fused_big,
                               -(-deg_at // cfg.tile_edges) + 1, 0)

    f32 = lambda x: x.to(torch.float32).sum()   # noqa: E731
    return torch.stack([
        f32(alive), f32(occupied), f32(solo), f32(grouped & fits_tile),
        f32(grouped & ~fits_tile), f32(mega_tasks), bytes_full, bytes_grp,
        f32(fused_small), f32(fused_big), f32(fused_blocks)])


def bucket_regroup(node_key: torch.Tensor, time_key: torch.Tensor,
                   node_capacity: int, *, time_subsort: bool = True
                   ) -> torch.Tensor:
    """Permutation (output position -> input lane) grouping lanes by
    ``node_key``; dead lanes are keyed ``node_capacity + 1``. With
    ``time_subsort``, lanes of one node are further ordered by quantized
    relative time when any occupied node carries mixed times."""
    key = node_key.to(torch.int64) << _TIME_SUBSORT_BITS
    if time_subsort and node_key.numel() > 0:
        # mixed: some occupied node holds two lanes at different times
        by_node = torch.sort(key, stable=True).indices
        s_node = node_key[by_node]
        s_time = time_key[by_node]
        same = (s_node[1:] == s_node[:-1]) & (s_node[1:] < node_capacity)
        mixed = (same & (s_time[1:] != s_time[:-1])).any()
        # span-scaled quantization: the observed span fits the subsort
        # bits; the shift is monotone, so equal times share a key
        tlo = time_key.min()
        span = (time_key.max() - tlo).clamp(min=1)
        shift = (torch.floor(torch.log2(span.to(torch.float32)))
                 .to(torch.int32) - (_TIME_SUBSORT_BITS - 1)).clamp(min=0)
        rel = ((time_key - tlo) >> shift).clamp(
            0, (1 << _TIME_SUBSORT_BITS) - 1)
        key = key + torch.where(mixed, rel, 0).to(torch.int64)
    return torch.sort(key, stable=True).indices.to(torch.int32)


class TaskTable(NamedTuple):
    """Fixed-shape task table: each task covers one tile of
    ``tile_walks`` sorted walk lanes plus the edge window
    ``[edge_base, edge_base + tile_edges)``."""

    edge_base: torch.Tensor   # int32[T] base offset into the ns view
    walk_lo: torch.Tensor     # int32[W] per-walk tile-local region start
    walk_hi: torch.Tensor     # int32[W] per-walk tile-local region end
    oversize: torch.Tensor    # bool[W] region exceeds the tile => fallback


def build_task_table(index, s_node: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, cfg: SchedulerConfig) -> TaskTable:
    """Tile table for walks sorted by node: each tile is anchored at the
    smallest region start among its walks; a walk whose region leaves
    ``tile_edges`` rows from there is oversize.

    Kept as the reference's public tile table; no hop of either package
    runs it. The tiled and fused hops anchor at a TE block and stage
    ``2·TE`` rows: see ``tile_table``."""
    W = s_node.shape[0]
    tw = cfg.tile_walks
    T = W // tw
    a_tiles = a.reshape(T, tw)
    b_tiles = b.reshape(T, tw)
    base = a_tiles.amin(dim=1)
    span_ok = (b_tiles - base[:, None]) <= cfg.tile_edges
    walk_lo = (a_tiles - base[:, None]).reshape(W)
    walk_hi = (b_tiles - base[:, None]).reshape(W)
    base = base.clamp(0, max(index.edge_capacity - cfg.tile_edges, 0))
    return TaskTable(
        edge_base=base.to(torch.int32),
        walk_lo=walk_lo.clamp(0, cfg.tile_edges).to(torch.int32),
        walk_hi=walk_hi.clamp(0, cfg.tile_edges).to(torch.int32),
        oversize=~span_ok.reshape(W))


class Tiles(NamedTuple):
    """The task table of one tiled hop."""

    a: torch.Tensor             # int32[W] global region start
    b: torch.Tensor             # int32[W] global region end
    base_blocks: torch.Tensor   # int32[T] staged block per task (units of TE)
    lo_raw: torch.Tensor        # int32[W] tile-local region start, unclipped
    hi_raw: torch.Tensor        # int32[W] tile-local region end, unclipped
    oversize: torch.Tensor      # bool[W] region leaves the panel: fallback


def task_bases(a: torch.Tensor, E: int, cfg: SchedulerConfig
               ) -> torch.Tensor:
    """Staged block of each tile of node-sorted lanes with region starts
    ``a``: ``clip(min(a) // TE, 0, E // TE − 2)``, int32[W // TW]."""
    W = a.shape[0]
    TW, TE = cfg.tile_walks, cfg.tile_edges
    if W % TW or E % TE:
        raise ValueError(f"walks {W} / edges {E} not multiples of tile "
                         f"({TW}, {TE})")
    if E // TE < 2:
        raise ValueError(f"edge capacity {E} must span >= 2 tiles of {TE}")
    return (a.reshape(W // TW, TW).amin(dim=1) // TE) \
        .clamp(0, E // TE - 2).to(torch.int32)


def tile_table(index, s_node: torch.Tensor,
               cfg: SchedulerConfig) -> Tiles:
    """Anchor each tile of node-sorted lanes at a TE block,
    ``clip(min(a) // TE, 0, E // TE − 2)``, and flag the lanes whose
    region does not fit its ``2·TE`` panel (kernels/ops.py:36-55 of the
    reference; the fused tier split uses the same rule)."""
    W = s_node.shape[0]
    TW, TE = cfg.tile_walks, cfg.tile_edges
    a, b = node_range(index, s_node)
    base_blocks = task_bases(a, index.edge_capacity, cfg)
    T = W // TW
    a_t, b_t = a.reshape(T, TW), b.reshape(T, TW)
    base = (base_blocks * TE)[:, None]
    lo = (a_t - base).reshape(W)
    hi = (b_t - base).reshape(W)
    # a region ending exactly at the panel's edge (hi == 2·TE) fits
    return Tiles(a=a, b=b, base_blocks=base_blocks, lo_raw=lo, hi_raw=hi,
                 oversize=(lo < 0) | (hi > 2 * TE))


def panel_bounds(tiles: Tiles, cfg: SchedulerConfig):
    """Tile-local ``(lo, hi)`` of each lane, int32 clipped to
    ``[0, 2·TE]``, as the kernel reads them: an empty end-of-window
    region stays empty, and an oversize lane keeps the prefix of its
    region that the panel holds."""
    P = 2 * cfg.tile_edges
    return (tiles.lo_raw.clamp(0, P).to(torch.int32),
            tiles.hi_raw.clamp(0, P).to(torch.int32))
