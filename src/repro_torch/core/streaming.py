"""Streaming replay (paper §3.3 regime), PyTorch port of core/streaming.py.

``ingest_and_walk`` is one batch of the streaming main path: merge ingest,
dual-index rebuild (with the weight-prefix kernel), then walk generation
through the fused hop kernels. ``replay_scan`` runs it over K stacked batches
and keeps the per-batch statistics on the device; ``StreamingEngine.
replay_device`` reads them with one host synchronisation at the end —
the reference's ``replay_scan``, with its ``lax.scan`` written as a
Python loop over device-resident batches.

``replay_scan_probed`` is ``replay_scan`` plus a probe vector
(obs/probes.py) updated on the device per batch; a ``StreamingEngine``
with ``probes=True`` (the default) reads it in the same one copy as the
statistics, so the probed replay emits the same bits and adds no host
sync.

``StreamingEngine.replay`` is the host loop: one ingest and one
walk batch per edge batch, each waited for, so ``StreamStats`` holds
per-batch stage times; ``sample_walks``/``sample_walks_donated`` draw one
walk batch from the current window. They publish into the metrics
registry (``obs/registry.py``).

A config with ``bias="table"`` (or a ``table_weight``) maintains alias
tables through every ingest (``spec_from_sampler``, core/alias.py) and
draws its walks from them; ``table=`` does the same for the functions.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.configs.base import (
    EngineConfig,
    SamplerConfig,
    SchedulerConfig,
    WalkConfig,
)
from repro_torch.core.alias import TableSpec, spec_from_sampler
from repro_torch.core.edge_store import EdgeBatch, make_batch, stack_batches
from repro_torch.core.walk_engine import (
    WalkBuffers,
    WalkResult,
    alloc_walk_buffers,
    generate_walks,
    generate_walks_donated,
)
from repro_torch.core.window import (WindowState, ingest, ingest_sort,
                                     init_window)
from repro_torch.kernels.runtime import resolve_device
from repro_torch.obs.probes import (
    NUM_REPLAY_PROBES,
    flush_replay_probes,
    replay_probe_update,
    replay_probe_zeros,
)
from repro_torch.obs.registry import MetricsRegistry, count_drop, get_registry
from repro_torch.obs.tracing import span

# sample_walks_sharded replicates the index per shard device; past this
# size a one-time warning points at the node-partitioned engine
# (DESIGN.md §12).
REPLICATED_INDEX_WARN_BYTES = 256 << 20


@dataclass
class StreamStats:
    """Per-batch host-loop timings (``StreamingEngine.replay``)."""

    ingest_s: List[float] = field(default_factory=list)
    sample_s: List[float] = field(default_factory=list)
    edges_active: List[int] = field(default_factory=list)
    walks_valid: List[float] = field(default_factory=list)

    @property
    def cumulative_ingest(self):
        return np.cumsum(self.ingest_s)

    @property
    def cumulative_sample(self):
        return np.cumsum(self.sample_s)


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
                    scfg: SamplerConfig, sched_cfg: SchedulerConfig,
                    table: Optional[TableSpec] = None):
    """One batch: ingest + rebuild (+ alias tables with ``table``) +
    walks. Returns (state, WalkResult)."""
    state = ingest(state, batch, node_capacity, table=table)
    return state, generate_walks(state.index, key, wcfg, scfg, sched_cfg,
                                 tables=state.tables)


def _replay_scan_impl(state: WindowState, batches: EdgeBatch, key,
                      node_capacity: int, wcfg: WalkConfig,
                      scfg: SamplerConfig, sched_cfg: SchedulerConfig,
                      table: Optional[TableSpec], with_probes: bool):
    rows = []
    walks = None
    pv = replay_probe_zeros(batches.src.device) if with_probes else None
    for i in range(batches.src.shape[0]):
        key, sub = prng.split(key)
        batch = EdgeBatch(batches.src[i], batches.dst[i], batches.ts[i],
                          batches.count[i])
        prev = state
        state, walks = ingest_and_walk(state, batch, sub, node_capacity,
                                       wcfg, scfg, sched_cfg, table=table)
        rows.append((state.index.num_edges, state.t_now, state.ingested,
                     state.late_drops, state.overflow_drops,
                     walks.lengths.sum().to(torch.float32)
                     / walks.lengths.shape[0]))
        if with_probes:
            pv = replay_probe_update(
                pv, ingested_delta=state.ingested - prev.ingested,
                late_delta=state.late_drops - prev.late_drops,
                overflow_delta=state.overflow_drops - prev.overflow_drops,
                lengths=walks.lengths)
    stats = ReplayStats(*(torch.stack(col) for col in zip(*rows)))
    if with_probes:
        return state, stats, walks, pv
    return state, stats, walks


def replay_scan(state: WindowState, batches: EdgeBatch, key,
                node_capacity: int, wcfg: WalkConfig, scfg: SamplerConfig,
                sched_cfg: SchedulerConfig,
                table: Optional[TableSpec] = None):
    """Replay K stacked batches ([K, B_cap] arrays) on the device.

    Returns ``(final_state, ReplayStats, final_walks)`` with everything
    still on the device; nothing here waits for it.
    """
    return _replay_scan_impl(state, batches, key, node_capacity, wcfg,
                             scfg, sched_cfg, table, with_probes=False)


def replay_scan_probed(state: WindowState, batches: EdgeBatch, key,
                       node_capacity: int, wcfg: WalkConfig,
                       scfg: SamplerConfig, sched_cfg: SchedulerConfig,
                       table: Optional[TableSpec] = None):
    """``replay_scan`` plus a replay probe vector (DESIGN.md §16): returns
    ``(final_state, ReplayStats, final_walks, probes)`` with ``probes`` an
    int32[NUM_REPLAY_PROBES] device tensor accumulated over the batches.
    Walks and statistics are those of ``replay_scan``, bit for bit."""
    return _replay_scan_impl(state, batches, key, node_capacity, wcfg,
                             scfg, sched_cfg, table, with_probes=True)


class StreamingEngine:
    """Tempest's end-to-end loop: ingest -> rebuild -> walk, on ``device``
    (CUDA unless the caller names another).

    ``ingest_impl`` selects the host loop's window advance: ``"merge"``
    (default) or ``"sort"`` (the reference's seed path). ``probes=False``
    runs ``replay_device`` without the probe vector and publishes nothing
    from it.
    """

    def __init__(self, cfg: EngineConfig, batch_capacity: int,
                 ingest_impl: str = "merge", device=None,
                 registry: Optional[MetricsRegistry] = None,
                 probes: bool = True):
        if ingest_impl not in ("merge", "sort"):
            raise ValueError(f"unknown ingest_impl {ingest_impl!r}")
        self.cfg = cfg
        self.batch_capacity = batch_capacity
        self.device = resolve_device(device)
        self._ingest = ingest if ingest_impl == "merge" else ingest_sort
        # bias='table' configs maintain alias tables through every ingest
        self._table = spec_from_sampler(cfg.sampler)
        if self._table is not None and ingest_impl == "sort":
            raise ValueError(
                "alias-table maintenance (bias='table') requires the merge "
                "ingest path; the 'sort' reference path does not thread "
                "table state")
        self.state: WindowState = init_window(
            cfg.window.edge_capacity, cfg.window.node_capacity,
            int(cfg.window.duration), table=self._table, device=self.device)
        self.key = prng.PRNGKey(cfg.seed)
        self.stats = StreamStats()
        self.registry = registry if registry is not None else get_registry()
        self.probes = probes
        # window-counter baselines: the state's counters are cumulative,
        # the registry takes deltas
        self._ingested_seen = 0
        self._late_seen = 0
        self._overflow_seen = 0
        self._rebuilt_seen = 0
        # walk-buffer pool for sample_walks_donated, keyed by (W, L)
        self._walk_bufs: dict = {}
        self._warned_replicated_index = False

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _publish_window(self) -> None:
        """Window gauges and drop deltas from the synchronised state."""
        reg = self.registry
        num_edges = int(self.state.index.num_edges)
        reg.set_gauge("window_edges_active", num_edges,
                      help="edges resident in the temporal window")
        reg.set_gauge("window_t_now", int(self.state.t_now),
                      help="watermark timestamp of the window")
        reg.set_gauge("window_occupancy",
                      num_edges / self.cfg.window.edge_capacity,
                      help="window fill fraction (edges_active / capacity)")
        ingested = int(self.state.ingested)
        late = int(self.state.late_drops)
        overflow = int(self.state.overflow_drops)
        reg.inc("stream_edges_ingested_total",
                max(0, ingested - self._ingested_seen),
                labels={"driver": "host"},
                help="edges delivered into the window")
        count_drop(reg, "ingest_late", max(0, late - self._late_seen))
        count_drop(reg, "window_overflow",
                   max(0, overflow - self._overflow_seen))
        self._ingested_seen = ingested
        self._late_seen = late
        self._overflow_seen = overflow
        if self.state.tables is not None:
            self._publish_tables(int(self.state.tables.rebuilt))

    def _publish_tables(self, rebuilt: int) -> None:
        """Alias-table maintenance counter: node rebuilds the incremental
        update performed (``rebuilt`` is the tables' cumulative count)."""
        self.registry.inc("alias_nodes_rebuilt_total",
                          max(0, rebuilt - self._rebuilt_seen),
                          help="alias-table node rebuilds performed by "
                               "incremental window maintenance")
        self._rebuilt_seen = rebuilt

    def _publish_window_from_replay(self, stats: ReplayStats,
                                    rebuilt: Optional[int]) -> None:
        """Window gauges after a device replay; the ingest and drop
        counters came from the probe vector, so only the baselines
        advance here."""
        if stats.edges_active.size == 0:
            return
        reg = self.registry
        edges = int(stats.edges_active[-1])
        reg.set_gauge("window_edges_active", edges,
                      help="edges resident in the temporal window")
        reg.set_gauge("window_t_now", int(stats.t_now[-1]),
                      help="watermark timestamp of the window")
        reg.set_gauge("window_occupancy",
                      edges / self.cfg.window.edge_capacity,
                      help="window fill fraction (edges_active / capacity)")
        self._ingested_seen = int(stats.ingested[-1])
        self._late_seen = int(stats.late_drops[-1])
        self._overflow_seen = int(stats.overflow_drops[-1])
        if rebuilt is not None:
            self._publish_tables(rebuilt)

    def ingest_batch(self, src, dst, ts) -> None:
        """Ingest one host batch and wait for it (a host-loop stage)."""
        batch = make_batch(src, dst, ts, capacity=self.batch_capacity,
                           device=self.device)
        t0 = time.perf_counter()
        with span("ingest_merge", self.registry):
            if self._table is not None:
                self.state = self._ingest(self.state, batch,
                                          self.cfg.window.node_capacity,
                                          table=self._table)
            else:
                self.state = self._ingest(self.state, batch,
                                          self.cfg.window.node_capacity)
            self._sync()
        self.stats.ingest_s.append(time.perf_counter() - t0)
        self.stats.edges_active.append(int(self.state.index.num_edges))
        self.registry.inc("stream_batches_total", 1,
                          labels={"driver": "host"},
                          help="batches replayed through the streaming "
                               "drivers")
        self._publish_window()

    def sample_walks(self, wcfg: WalkConfig,
                     collect_stats: bool = False) -> WalkResult:
        """One walk batch from the current window, waited for."""
        self.key, sub = prng.split(self.key)
        t0 = time.perf_counter()
        res = generate_walks(self.state.index, sub, wcfg, self.cfg.sampler,
                             self.cfg.scheduler, collect_stats=collect_stats,
                             tables=self.state.tables)
        self._finish_sample(res, t0, path="host")
        return res

    def sample_walks_donated(self, wcfg: WalkConfig) -> WalkResult:
        """Like ``sample_walks``, but the walks are written into a
        per-shape buffer pool (DESIGN.md §10): the previous result returned
        for the same (num_walks, max_length) is overwritten by this call,
        so copy it first if it must outlive the next round."""
        shape_key = (wcfg.num_walks, wcfg.max_length)
        bufs = self._walk_bufs.pop(shape_key, None)
        if bufs is None:
            bufs = alloc_walk_buffers(wcfg, device=self.device)
        self.key, sub = prng.split(self.key)
        t0 = time.perf_counter()
        res = generate_walks_donated(self.state.index, sub, bufs, wcfg,
                                     self.cfg.sampler, self.cfg.scheduler,
                                     tables=self.state.tables)
        self._finish_sample(res, t0, path="donated")
        self._walk_bufs[shape_key] = WalkBuffers(res.nodes, res.times)
        return res

    def sample_walks_sharded(self, wcfg: WalkConfig, mesh=None
                             ) -> WalkResult:
        """Walk-axis sharding over the group's shards (default: one per
        visible device) against the replicated window index — see
        repro_torch.distributed.walks (DESIGN.md §10).

        Memory cost: every shard device holds a copy of the full dual
        index (shards on one device share one), so the window must still
        fit on one device. Past ``REPLICATED_INDEX_WARN_BYTES`` a one-time
        warning points at the node-partitioned
        ``repro_torch.distributed.streaming_shard.
        DistributedStreamingEngine``, which shards the window itself.
        """
        from repro_torch.distributed.walks import generate_walks_sharded
        self._warn_replicated_index()
        self.key, sub = prng.split(self.key)
        t0 = time.perf_counter()
        res = generate_walks_sharded(self.state.index, sub, wcfg,
                                     self.cfg.sampler, self.cfg.scheduler,
                                     mesh=mesh)
        self._finish_sample(res, t0, path="sharded")
        return res

    def _warn_replicated_index(self) -> None:
        """One-time warning when the replicated-index sharding is used
        with an index too large to replicate comfortably."""
        if self._warned_replicated_index:
            return
        index = self.state.index
        nbytes = sum(t.numel() * t.element_size()
                     for t in (*index.store, *index[1:]))
        if nbytes > REPLICATED_INDEX_WARN_BYTES:
            import warnings
            warnings.warn(
                f"sample_walks_sharded replicates the full window index "
                f"(~{nbytes / 2**20:.0f} MiB) onto every device of the "
                f"mesh; for windows of this size consider the "
                f"node-partitioned "
                f"repro_torch.distributed.streaming_shard.Distributed"
                f"StreamingEngine (DESIGN.md §12), which shards the window "
                f"itself.", stacklevel=3)
            self._warned_replicated_index = True

    def _finish_sample(self, res: WalkResult, t0: float,
                       path: str = "host") -> float:
        """Shared tail of the sample_walks entry points: wait, record wall
        time and the valid-walk fraction, publish into the registry."""
        lengths = res.lengths.cpu().numpy()
        elapsed = time.perf_counter() - t0
        self.stats.sample_s.append(elapsed)
        frac = float(np.mean(lengths >= 2)) if lengths.size else 0.0
        self.stats.walks_valid.append(frac)
        reg = self.registry
        reg.inc("walks_dispatched_total", int(lengths.size),
                labels={"path": path},
                help="walk slots dispatched, by sampling path")
        reg.inc("walks_emitted_total", int(np.sum(lengths >= 2)),
                labels={"driver": "host"},
                help="walks with at least one hop")
        reg.inc("walk_hops_total",
                int(np.sum(np.maximum(lengths.astype(np.int64) - 1, 0))),
                labels={"source": "replay"}, help="hop cells executed")
        reg.observe("walk_sample_seconds", elapsed, labels={"path": path},
                    help="wall time per sample_walks dispatch")
        return elapsed

    def replay(self, batches: Iterable, wcfg: WalkConfig,
               on_batch: Optional[Callable] = None) -> StreamStats:
        """The host loop: per-batch ingest + walks, each waited for."""
        for bs, bd, bt in batches:
            self.ingest_batch(bs, bd, bt)
            res = self.sample_walks(wcfg)
            if on_batch is not None:
                on_batch(self, res)
        return self.stats

    def replay_device(self, batches: Iterable, wcfg: WalkConfig,
                      return_walks: bool = False):
        """All batches on the device, one host sync at the end: the
        statistics, the probe vector and the tables' rebuild count come
        back in one copy. Returns (ReplayStats of numpy arrays, wall
        seconds), or (stats, final-batch WalkResult of numpy arrays,
        seconds) with ``return_walks``."""
        stacked = stack_batches(batches, self.batch_capacity,
                                device=self.device)
        self.key, sub = prng.split(self.key)
        self._sync()
        t0 = time.perf_counter()
        scan = replay_scan_probed if self.probes else replay_scan
        out = scan(self.state, stacked, sub, self.cfg.window.node_capacity,
                   wcfg, self.cfg.sampler, self.cfg.scheduler,
                   table=self._table)
        self.state, stats, walks = out[:3]
        # one int32 copy: the stats rows (mean_len by its bits), then the
        # probes and the rebuild count where there are any
        words = [torch.stack([a if a.dtype == torch.int32
                              else a.view(torch.int32) for a in stats])
                 .reshape(-1)]
        if self.probes:
            words.append(out[3])
        if self.state.tables is not None:
            words.append(self.state.tables.rebuilt.reshape(1))
        host = torch.cat(words).cpu().numpy()
        elapsed = time.perf_counter() - t0
        K = stats.edges_active.shape[0]
        rows = host[:len(stats) * K].reshape(len(stats), K)
        host_stats = ReplayStats(*(
            rows[i].view(np.float32) if f == "mean_len" else rows[i]
            for i, f in enumerate(ReplayStats._fields)))
        tail = host[len(stats) * K:]
        rebuilt = int(tail[-1]) if self.state.tables is not None else None
        if self.probes:
            flush_replay_probes(self.registry, tail[:NUM_REPLAY_PROBES],
                                driver="device")
            self.registry.observe("replay_seconds", elapsed,
                                  labels={"driver": "device"},
                                  help="wall time per replay_device call")
            self._publish_window_from_replay(host_stats, rebuilt)
        if return_walks:
            host_walks = WalkResult(nodes=walks.nodes.cpu().numpy(),
                                    times=walks.times.cpu().numpy(),
                                    lengths=walks.lengths.cpu().numpy())
            return host_stats, host_walks, elapsed
        return host_stats, elapsed
