"""Dispatch wrapper of the tiled path, PyTorch port of kernels/ops.py.

``walk_step`` is the hop primitive of ``SchedulerConfig(path="tiled")``:
it builds the fixed-shape task table and runs ``walk_step_hop``, which
serves in-tile lanes from the staged panel and oversize lanes (regions
wider than the staged panel — the paper's G-axis "global" fallback tier)
through the reference's global fallback, in one launch on the card.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SamplerConfig, SchedulerConfig
from repro_torch.core.scheduler import task_bases
from repro_torch.core.temporal_index import TemporalIndex, node_range
from repro_torch.kernels.walk_step import walk_step_hop


def walk_step(index: TemporalIndex, s_node: torch.Tensor,
              s_time: torch.Tensor, u: torch.Tensor, scfg: SamplerConfig,
              cfg: SchedulerConfig):
    """Hop search+sample for lanes sorted by node. Returns (k_global, n)."""
    E = index.edge_capacity
    a, b = node_range(index, s_node)
    linear = scfg.mode == "weight" and scfg.bias == "linear"
    prefix = index.plin if linear else index.pexp
    tbase = None
    if linear:
        nc = index.node_capacity
        tbase = index.node_tbase[s_node.clamp(0, nc - 1).long()]
    k, n, _, _ = walk_step_hop(
        index.ns_ts[:E], index.ns_dst[:E], prefix,
        task_bases(a, E, cfg), s_time.to(torch.int32).contiguous(), a, b,
        u.contiguous(), tbase, mode=scfg.mode, bias=scfg.bias,
        tile_walks=cfg.tile_walks, tile_edges=cfg.tile_edges)
    return k, n
