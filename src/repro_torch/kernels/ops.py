"""Dispatch wrapper of the tiled path, PyTorch port of kernels/ops.py.

``walk_step`` is the hop primitive of ``SchedulerConfig(path="tiled")``:
it builds the fixed-shape task table, runs the ``walk_step_tiled`` kernel
for in-tile lanes, and serves oversize lanes (regions wider than the
staged panel — the paper's G-axis "global" fallback tier) through the
plain-torch pick, merging by mask.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SamplerConfig, SchedulerConfig
from repro_torch.core.samplers import pick_in_neighborhood
from repro_torch.core.scheduler import panel_bounds, tile_table
from repro_torch.core.temporal_index import TemporalIndex, temporal_cutoff
from repro_torch.kernels.walk_step import walk_step_tiled


def walk_step(index: TemporalIndex, s_node: torch.Tensor,
              s_time: torch.Tensor, u: torch.Tensor, scfg: SamplerConfig,
              cfg: SchedulerConfig):
    """Hop search+sample for lanes sorted by node. Returns (k_global, n)."""
    E = index.edge_capacity
    TE = cfg.tile_edges
    tiles = tile_table(index, s_node, cfg)
    lo, hi = panel_bounds(tiles, cfg)
    prefix = index.plin if (scfg.mode == "weight"
                            and scfg.bias == "linear") else index.pexp
    nc = index.node_capacity
    tbase = index.node_tbase[s_node.clamp(0, nc - 1).long()]
    k_loc, n_k, _, _ = walk_step_tiled(
        index.ns_ts[:E], index.ns_dst[:E], prefix[:E], prefix[1:E + 1],
        tiles.base_blocks, s_time.to(torch.int32).contiguous(), lo, hi,
        u.contiguous(), tbase, mode=scfg.mode, bias=scfg.bias,
        tile_walks=cfg.tile_walks, tile_edges=TE)
    k_kernel = (tiles.base_blocks * TE).repeat_interleave(cfg.tile_walks) \
        + k_loc

    # global fallback for oversize lanes (the paper's G-cap fallback)
    c = temporal_cutoff(index, tiles.a, tiles.b, s_time)
    k_fb = pick_in_neighborhood(index, scfg, c, tiles.b, u, s_node)
    k = torch.where(tiles.oversize, k_fb, k_kernel)
    n = torch.where(tiles.oversize, tiles.b - c, n_k)
    return k, n
