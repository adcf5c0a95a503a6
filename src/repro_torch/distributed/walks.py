"""Walk-axis sharding over a replicated index (DESIGN.md §10), PyTorch
port of repro/distributed/walks.py.

The other regime beside core/distributed.py: the window fits on one
device and throughput is the constraint, so the dual index is replicated
and the walk axis is sharded. Shard s folds s into the key and runs the
whole scheduler path (fullwalk, grouped, tiled or fused; bucket or
lexsort regroup) on its W/D walks, exactly as a single-device
``generate_walks`` of W/D walks would, with no communication between
shards. ``all_nodes`` starts keep their global assignment through
``walk_offset``: shard s's walk w starts where global walk s·W/D + w
would. A D-shard run is deterministic for a fixed (key, D) but is not
the 1-shard run's bits.

On ``path="fused"`` or ``"tiled"`` each shard launches the ``fused_hop``
or ``walk_step_hop`` kernel once per hop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import random as prng
from repro_torch.configs.base import SamplerConfig, SchedulerConfig, WalkConfig
from repro_torch.core.temporal_index import TemporalIndex
from repro_torch.core.walk_engine import WalkResult, _generate_walks_impl
from repro_torch.distributed.collectives import (ShardGroup, make_group,
                                                 tree_to)


def walk_mesh(devices=None) -> ShardGroup:
    """A group over all (or the given) devices for walk-axis sharding; to
    run D shards on one device, name it D times."""
    return make_group(0, devices)


def generate_walks_sharded(index: TemporalIndex, key, wcfg: WalkConfig,
                           scfg: SamplerConfig, sched_cfg: SchedulerConfig,
                           *, mesh: Optional[ShardGroup] = None
                           ) -> WalkResult:
    """Generate ``wcfg.num_walks`` walks sharded over the group's shards
    (default: one per visible device) against the replicated index.
    Returns the walks in global walk order on the first shard's device,
    without stats."""
    if mesh is None:
        mesh = walk_mesh()
    D = mesh.size
    if wcfg.num_walks % D:
        raise ValueError(f"num_walks {wcfg.num_walks} not divisible by "
                         f"{D} shards")
    wd = dataclasses.replace(wcfg, num_walks=wcfg.num_walks // D)
    replicas = {}
    parts = []
    for s, dev in enumerate(mesh.devices):
        if dev not in replicas:
            replicas[dev] = tree_to(index, dev)
        parts.append(_generate_walks_impl(
            replicas[dev], prng.fold_in(key, s), wd, scfg, sched_cfg,
            walk_offset=s * wd.num_walks))
    home = mesh.devices[0]
    return WalkResult(
        *(torch.cat([getattr(p, f).to(home) for p in parts])
          for f in ("nodes", "times", "lengths")), stats=None)
