"""Streaming replay (paper §3.3 regime), PyTorch port of core/streaming.py.

``ingest_and_walk`` is one batch of the streaming main path: merge ingest,
dual-index rebuild (with the weight-prefix kernel), then walk generation
through the fused hop kernels. ``replay_scan`` runs it over K stacked batches
and keeps the per-batch statistics on the device; ``StreamingEngine.
replay_device`` reads them with one host synchronisation at the end —
the reference's ``replay_scan``, with its ``lax.scan`` written as a
Python loop over device-resident batches.

The engine has ``probes=False`` semantics: no metrics registry yet.
"""
from __future__ import annotations

import time
from typing import Iterable, NamedTuple

import torch

from repro_torch import random as prng
from repro_torch.configs.base import (
    EngineConfig,
    SamplerConfig,
    SchedulerConfig,
    WalkConfig,
)
from repro_torch.core.edge_store import EdgeBatch, stack_batches
from repro_torch.core.walk_engine import WalkResult, generate_walks
from repro_torch.core.window import WindowState, ingest, init_window
from repro_torch.kernels.runtime import resolve_device


class ReplayStats(NamedTuple):
    """Per-batch statistics of a replay ([K] arrays)."""

    edges_active: torch.Tensor     # int32[K] store population after each batch
    t_now: torch.Tensor            # int32[K]
    ingested: torch.Tensor         # int32[K] cumulative counters
    late_drops: torch.Tensor       # int32[K]
    overflow_drops: torch.Tensor   # int32[K]
    mean_len: torch.Tensor         # float32[K] mean walk length per batch


def ingest_and_walk(state: WindowState, batch: EdgeBatch, key,
                    node_capacity: int, wcfg: WalkConfig,
                    scfg: SamplerConfig, sched_cfg: SchedulerConfig):
    """One batch: ingest + rebuild + walks. Returns (state, WalkResult)."""
    state = ingest(state, batch, node_capacity)
    return state, generate_walks(state.index, key, wcfg, scfg, sched_cfg)


def replay_scan(state: WindowState, batches: EdgeBatch, key,
                node_capacity: int, wcfg: WalkConfig, scfg: SamplerConfig,
                sched_cfg: SchedulerConfig):
    """Replay K stacked batches ([K, B_cap] arrays) on the device.

    Returns ``(final_state, ReplayStats, final_walks)`` with everything
    still on the device; nothing here waits for it.
    """
    rows = []
    walks = None
    for i in range(batches.src.shape[0]):
        key, sub = prng.split(key)
        batch = EdgeBatch(batches.src[i], batches.dst[i], batches.ts[i],
                          batches.count[i])
        state, walks = ingest_and_walk(state, batch, sub, node_capacity,
                                       wcfg, scfg, sched_cfg)
        rows.append((state.index.num_edges, state.t_now, state.ingested,
                     state.late_drops, state.overflow_drops,
                     walks.lengths.sum().to(torch.float32)
                     / walks.lengths.shape[0]))
    stats = ReplayStats(*(torch.stack(col) for col in zip(*rows)))
    return state, stats, walks


class StreamingEngine:
    """Tempest's end-to-end loop: ingest -> rebuild -> walk, on ``device``
    (CUDA unless the caller names another)."""

    def __init__(self, cfg: EngineConfig, batch_capacity: int, device=None):
        self.cfg = cfg
        self.batch_capacity = batch_capacity
        self.device = resolve_device(device)
        self.state: WindowState = init_window(
            cfg.window.edge_capacity, cfg.window.node_capacity,
            int(cfg.window.duration), device=self.device)
        self.key = prng.PRNGKey(cfg.seed)

    def ingest_batch(self, src, dst, ts) -> None:
        batch = stack_batches([(src, dst, ts)], self.batch_capacity,
                              device=self.device)
        self.state = ingest(self.state, EdgeBatch(*(x[0] for x in batch)),
                            self.cfg.window.node_capacity)

    def replay_device(self, batches: Iterable, wcfg: WalkConfig,
                      return_walks: bool = False):
        """All batches on the device, one host sync at the end. Returns
        (ReplayStats of numpy arrays, wall seconds), or (stats, final-batch
        WalkResult of numpy arrays, seconds) with ``return_walks``."""
        stacked = stack_batches(batches, self.batch_capacity,
                                device=self.device)
        self.key, sub = prng.split(self.key)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        self.state, stats, walks = replay_scan(
            self.state, stacked, sub, self.cfg.window.node_capacity, wcfg,
            self.cfg.sampler, self.cfg.scheduler)
        host_stats = ReplayStats(*(a.cpu().numpy() for a in stats))
        elapsed = time.perf_counter() - t0
        if return_walks:
            host_walks = WalkResult(nodes=walks.nodes.cpu().numpy(),
                                    times=walks.times.cpu().numpy(),
                                    lengths=walks.lengths.cpu().numpy())
            return host_stats, host_walks, elapsed
        return host_stats, elapsed
