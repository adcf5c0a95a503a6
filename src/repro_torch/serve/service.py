"""Multi-tenant walk-query service over the streaming window (DESIGN.md
§11, §13, §18), PyTorch port of repro/serve/service.py.

Many callers submit small heterogeneous ``WalkQuery``s; the service
queues them (fixed capacity, backpressure by drop + accounting),
coalesces compatible queries into one fixed-shape ``generate_walk_lanes``
batch, slices each tenant's rows back out, and tracks p50/p99
submit→complete latency plus walks/s throughput.

Coalescing policy: the head query (oldest under FIFO admission,
earliest-deadline under EDF) fixes the group key, then same-group
queries fold in along the admission order until the first one that does
not fit the lane budget seals the scan (the *prefix rule*), so no query
is ever overtaken by a younger same-group query.

**Async runtime** (DESIGN.md §18): a sealed batch is enqueued on the
device and joins a bounded ring of in-flight batches, each pinned to the
snapshot version it launched against, with a CUDA event recorded right
after its last kernel. ``pump()`` harvests completions oldest first,
``tick()`` is the one-call event loop (evict expired → harvest ready →
seal + launch while the ring has room), and a partly filled batch
*lingers* up to ``ServeConfig.linger_s``. The launch reads nothing back
from the device, so the host goes on coalescing while batches run.
``step()`` is the synchronous baseline (force-seal one batch, block until
the ring is empty).

Determinism: results are bit-identical to running each query solo
(``run_query_solo``), and to the reference's service, because lane RNG
folds by (query seed, walk id, step) and the per-lane bias/length
dispatch is pure per lane.

On a CUDA device the batches run on the fused path through the
``fused_hop`` kernel when ``SchedulerConfig.path == "fused"``. A config
with ``bias="table"`` or a ``table_weight`` keeps alias tables in the
snapshot buffers (rebuilt incrementally by each ``begin_ingest``), so
table-coded queries draw from them; they and second-order (node2vec)
queries run on the ``grouped`` and ``fullwalk`` paths, as in the
reference.

**Sharded serving** (DESIGN.md §13): with ``ServeConfig.num_shards > 0``
(or an explicit ``mesh``/``num_shards``) the same service runs against a
node-partitioned window: the snapshots double-buffer a
``ShardedWindowState`` and its ts view, and each coalesced batch runs
through ``serve_lanes_sharded`` (start lanes claimed by their owner
shards, per-hop migration), with the same bit-identity against
single-device solo runs. Its drop, claim and probe counters stay on the
device until the batch's harvest.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.configs.base import EngineConfig, ServeConfig, WalkConfig
from repro_torch.core.alias import spec_from_sampler
from repro_torch.core.edge_store import make_batch
from repro_torch.core.walk_engine import (
    LaneFeatures,
    LaneParams,
    check_capabilities,
    generate_walk_lanes,
)
from repro_torch.core.window import WindowState, init_window
from repro_torch.distributed.streaming_shard import serve_lanes_sharded
from repro_torch.kernels.runtime import resolve_device
from repro_torch.obs.probes import NUM_SERVE_PROBES, flush_serve_probes
from repro_torch.obs.registry import (
    RESERVOIR_SIZE,
    MetricsRegistry,
    Reservoir,
    count_drop,
    get_registry,
)
from repro_torch.obs.tracing import span
from repro_torch.serve.coalescer import (
    bucketize,
    group_key,
    pack_queries,
    result_arrays,
    slice_result,
)
from repro_torch.serve.query import QueryResult, WalkQuery
from repro_torch.serve.snapshot import (
    ShardedSnapshotManager,
    SnapshotManager,
    ready_event,
)


class QueueFull(RuntimeError):
    """Raised by ``submit(..., strict=True)`` when the queue is at capacity."""


class OversizeQuery(ValueError):
    """Raised by ``submit`` for a query exceeding the largest shape bucket
    when the service is configured (or asked) not to drop it silently —
    ``strict=True``, or ``ServeConfig.drop_oversize=False``. Unlike
    ``QueueFull`` this can never succeed on retry."""


@dataclass(frozen=True)
class _Pending:
    """One queued query: ticket, arrival clock, absolute deadline."""

    ticket: int
    arrival: float                   # time.perf_counter() at submit
    query: WalkQuery
    deadline: Optional[float] = None  # absolute perf_counter time, or None


@dataclass
class _InFlight:
    """One launched, unharvested batch of the async ring. ``raw`` holds the
    device outputs (a ``WalkResult`` on one device, the
    ``serve_lanes_sharded`` tuple sharded), which only ``pump`` reads
    back; ``ready`` is the CUDA event recorded after the batch's last
    kernel (None on the CPU, where the batch is done when the launch
    returns); ``version`` is the snapshot version the batch was pinned
    to."""

    raw: object
    ready: Optional[torch.cuda.Event]
    taken: List[_Pending]
    slices: List[object]
    lane_bucket: int
    lanes: int
    version: int
    t0: float                        # launch clock


# latency/batch samples backing p50/p99 live in a bounded reservoir
STATS_WINDOW = RESERVOIR_SIZE


@dataclass
class ServeStats:
    """Serving counters + latency/throughput accounting."""

    submitted: int = 0
    completed: int = 0
    dropped_backpressure: int = 0   # queue at capacity
    dropped_oversize: int = 0       # exceeds the largest shape bucket
    #   (silent drops AND the typed refusals drop_oversize=False raises on
    #   non-strict submits; strict raises are not counted)
    dropped_deadline: int = 0       # queued past deadline_s -> evicted
    batches: int = 0                # coalesced launches
    lanes_dispatched: int = 0       # incl. bucket padding
    lanes_live: int = 0             # real query lanes
    walks: int = 0                  # walks returned to callers
    hops: int = 0                   # edges traversed in returned walks
    solo_queries: int = 0           # run_query_solo runs (accounted into
    #   walks/hops/busy_s like served traffic)
    busy_s: float = 0.0             # total launch->harvest wall time; with
    #   max_inflight > 1 the intervals overlap, so busy_s can exceed wall
    #   time and walks_per_s under-reports the overlapped rate
    shard_walk_drops: int = 0       # sharded: capacity-overflow lanes
    exchange_drops: int = 0         # sharded: ingest-exchange drops
    # ^ cumulative; both refresh at every harvest (exchange_drops also at
    #   publish). Bit-identity needs both at zero: walk drops lose lanes,
    #   exchange drops lose window edges.
    lanes_by_shard: Dict[int, int] = field(default_factory=dict)
    # ^ sharded, both start modes: start lanes claimed per owner shard,
    #   counted on the device by serve_lanes_sharded
    latencies_s: Reservoir = field(
        default_factory=lambda: Reservoir(STATS_WINDOW))
    sample_s: Reservoir = field(
        default_factory=lambda: Reservoir(STATS_WINDOW))

    @property
    def dropped(self) -> int:
        return (self.dropped_backpressure + self.dropped_oversize
                + self.dropped_deadline)

    def latency_percentile(self, q: float) -> float:
        """q-th percentile of submit→complete latency over the bounded
        reservoir, in seconds (nan when empty)."""
        return self.latencies_s.percentile(q)

    @property
    def p50_ms(self) -> float:
        return 1e3 * self.latency_percentile(50)

    @property
    def p99_ms(self) -> float:
        return 1e3 * self.latency_percentile(99)

    @property
    def walks_per_s(self) -> float:
        return self.walks / self.busy_s if self.busy_s > 0 else 0.0

    @property
    def steps_per_s(self) -> float:
        return self.hops / self.busy_s if self.busy_s > 0 else 0.0

    @property
    def lane_occupancy(self) -> float:
        """Live fraction of dispatched lanes (bucket-padding overhead)."""
        return (self.lanes_live / self.lanes_dispatched
                if self.lanes_dispatched else 0.0)


class WalkService:
    """Walk-query serving over a snapshot double-buffered window, on one
    device (CUDA unless ``device`` names another, or the device of a
    ``state`` given) or sharded (``num_shards``, ``ServeConfig.num_shards``
    or ``mesh``): ``mesh`` is a ``ShardGroup``, else the shards are the
    first ``num_shards`` visible CUDA devices, or ``num_shards`` shards on
    ``device`` when one is named. ``placement`` (sharded only) routes
    ingest and lane claims, by default ``cfg.shard.placement``.
    ``probes`` switches the sharded serving probe matrix
    (``obs.flush_serve_probes``); a single-device service has none, as in
    the reference.

    The service owns a ``SnapshotManager`` (feed it edges via ``ingest`` /
    ``begin_ingest`` + ``publish``) and a fixed-capacity queue of pending
    queries. ``submit`` enqueues (or drops, under backpressure);
    ``tick``/``pump`` run the async ring; ``step`` serves one batch;
    ``drain`` loops until empty.
    """

    def __init__(self, cfg: EngineConfig,
                 serve_cfg: ServeConfig = ServeConfig(),
                 state: Optional[WindowState] = None,
                 batch_capacity: int = 8192, *,
                 mesh=None, num_shards: int = 0, placement=None,
                 registry: Optional[MetricsRegistry] = None,
                 probes: bool = True, device=None):
        if list(serve_cfg.lane_buckets) != sorted(serve_cfg.lane_buckets) \
                or list(serve_cfg.length_buckets) != sorted(
                    serve_cfg.length_buckets):
            raise ValueError("ServeConfig buckets must be sorted ascending")
        if serve_cfg.max_inflight < 1:
            raise ValueError("ServeConfig.max_inflight must be >= 1 "
                             f"(got {serve_cfg.max_inflight})")
        if serve_cfg.linger_s < 0:
            raise ValueError("ServeConfig.linger_s must be >= 0 "
                             f"(got {serve_cfg.linger_s})")
        if serve_cfg.admission not in ("fifo", "edf"):
            raise ValueError("ServeConfig.admission must be 'fifo'|'edf' "
                             f"(got {serve_cfg.admission!r})")
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        # the tiled kernel takes one bias per launch; serve on the grouped
        # path instead (same walks). The fused kernel dispatches per-lane
        # bias codes, so path="fused" serves heterogeneous batches.
        self.sched_cfg = (dataclasses.replace(cfg.scheduler, path="grouped")
                          if cfg.scheduler.path == "tiled" else cfg.scheduler)
        # bias='table' (or a table_weight) opts the snapshot buffers into
        # alias-table maintenance
        self._table = spec_from_sampler(cfg.sampler)
        self._rebuilt_seen = 0
        ns = num_shards or serve_cfg.num_shards
        self.sharded = mesh is not None or ns > 0
        # every serving batch is a per-lane batch: validate the config
        # against lane capabilities up front
        check_capabilities(cfg.sampler, self.sched_cfg.path, LaneFeatures(),
                           sharded=self.sharded,
                           have_tables=self._table is not None)
        self.probes = probes
        self.registry = registry if registry is not None else get_registry()
        if self.sharded:
            if state is not None:
                raise ValueError(
                    "sharded serving builds its own node-partitioned "
                    "window; the state= override is single-device only")
            self.snapshots = ShardedSnapshotManager(
                cfg, batch_capacity, mesh=mesh, num_shards=ns,
                devices=None if device is None
                else [resolve_device(device)] * ns,
                placement=placement, registry=self.registry)
            self.device = self.snapshots.home
            self.batch_capacity = self.snapshots.batch_capacity
            self.num_shards = self.snapshots.num_shards
        else:
            if placement is not None:
                raise ValueError("placement= requires sharded serving "
                                 "(num_shards > 0 or mesh=)")
            self.device = (state.index.ns_ts.device
                           if state is not None and device is None
                           else resolve_device(device))
            self.batch_capacity = batch_capacity
            self.num_shards = 0
            self.snapshots = SnapshotManager(
                state if state is not None else init_window(
                    cfg.window.edge_capacity, cfg.window.node_capacity,
                    int(cfg.window.duration), table=self._table,
                    device=self.device),
                cfg.window.node_capacity, registry=self.registry,
                table=self._table)
        self.placement = self.snapshots.placement if self.sharded else None
        # NOT split per call: lane RNG identity lives in (seed, walk, step)
        # folds, and solo/coalesced bit-equality needs a stable base
        self.base_key = prng.PRNGKey(cfg.seed)
        self.stats = ServeStats()
        # drop-delta baseline: stats.exchange_drops is cumulative and may
        # be reset by callers, the registry needs monotonic deltas
        self._exchange_drops_seen = 0
        self._pending: Deque[_Pending] = deque()
        self._inflight: Deque[_InFlight] = deque()
        self._results: Dict[int, QueryResult] = {}
        self._next_ticket = 0
        # while a drain() runs, the tickets it harvests land here
        self._harvest_log: Optional[List[int]] = None

    # ------------------------------------------------------------------
    # Ingest side (snapshot double buffer)
    # ------------------------------------------------------------------

    def ingest(self, src, dst, ts) -> None:
        """Advance the window synchronously (begin + publish)."""
        self.begin_ingest(src, dst, ts)
        self.publish()

    def begin_ingest(self, src, dst, ts) -> None:
        """Start building the next window; serving continues against the
        current snapshot until ``publish``."""
        batch = make_batch(src, dst, ts, capacity=self.batch_capacity,
                           device=self.device)
        with span("ingest_merge", self.registry):
            self.snapshots.begin_ingest(batch)

    def publish(self) -> None:
        with span("snapshot_publish", self.registry):
            self.snapshots.publish()
        self.registry.set_gauge("snapshot_version", self.snapshots.version,
                                help="published serving snapshot version")
        if self.sharded:
            self._refresh_exchange_drops()
        elif self.snapshots.current.tables is not None:
            # incremental maintenance work per advance (publish has
            # already waited for the ingest)
            rebuilt = int(self.snapshots.current.tables.rebuilt)
            self.registry.inc("alias_nodes_rebuilt_total",
                              max(0, rebuilt - self._rebuilt_seen),
                              help="alias-table node rebuilds performed by "
                                   "incremental window maintenance")
            self._rebuilt_seen = rebuilt

    def _refresh_exchange_drops(self, total: Optional[int] = None) -> None:
        """Pull the sharded ingest's cumulative exchange-drop count
        (``total``, read from the device if not given) into the stats
        view and the registry. Called at every publish and harvest, so
        ``exchange_drops`` advances in lockstep with
        ``shard_walk_drops``."""
        if total is None:
            total = sum(int(x) for x in self.snapshots.state.exchange_drops)
        self.stats.exchange_drops = total
        count_drop(self.registry, "exchange_clip",
                   max(0, total - self._exchange_drops_seen))
        self._exchange_drops_seen = max(total, self._exchange_drops_seen)

    # ------------------------------------------------------------------
    # Query side
    # ------------------------------------------------------------------

    def _oversize(self, query: WalkQuery) -> bool:
        return (bucketize(query.num_lanes, self.serve_cfg.lane_buckets)
                is None
                or bucketize(query.max_length, self.serve_cfg.length_buckets)
                is None)

    def submit(self, query: WalkQuery, strict: bool = False) -> Optional[int]:
        """Enqueue a query; returns its ticket, or None when dropped.

        Oversize contract: ``strict=False, drop_oversize=True`` drops
        silently (counted); ``strict=False, drop_oversize=False`` raises
        ``OversizeQuery`` (counted); ``strict=True`` raises
        ``OversizeQuery`` (not counted). Backpressure drops with
        ``strict=False`` and raises ``QueueFull`` with ``strict=True``.
        Queued queries past their deadline are evicted first.

        Table-bias and second-order queries are validated against the
        service's capabilities here, always by a raise.
        """
        if query.bias == "table" or query.second_order:
            check_capabilities(
                self.cfg.sampler, self.sched_cfg.path,
                LaneFeatures(table=query.bias == "table",
                             second_order=query.second_order),
                sharded=self.sharded,
                have_tables=(not self.sharded
                             and self.snapshots.current.tables is not None))
        now = time.perf_counter()
        self._evict_expired(now)
        if self._oversize(query):
            msg = (f"query needs {query.num_lanes} lanes × "
                   f"{query.max_length} hops; largest bucket is "
                   f"{self.serve_cfg.lane_buckets[-1]} × "
                   f"{self.serve_cfg.length_buckets[-1]}")
            if strict:
                raise OversizeQuery(msg)
            self.stats.dropped_oversize += 1
            count_drop(self.registry, "oversize")
            if not self.serve_cfg.drop_oversize:
                raise OversizeQuery(
                    msg + " (drop_oversize=False: refusing instead of "
                          "silently dropping)")
            return None
        if len(self._pending) >= self.serve_cfg.queue_capacity:
            if strict:
                raise QueueFull(
                    f"{len(self._pending)} queries pending "
                    f"(capacity {self.serve_cfg.queue_capacity})")
            self.stats.dropped_backpressure += 1
            count_drop(self.registry, "queue_backpressure")
            return None
        ticket = self._next_ticket
        self._next_ticket += 1
        deadline = (now + query.deadline_s
                    if query.deadline_s is not None else None)
        self._pending.append(_Pending(ticket, now, query, deadline))
        self.stats.submitted += 1
        self.registry.inc("serve_submitted_total", 1,
                          help="queries accepted into the serving queue")
        self.registry.set_gauge("serve_queue_depth", len(self._pending),
                                help="queries pending in the serving queue")
        return ticket

    def _evict_expired(self, now: float) -> int:
        """Evict queued queries past their deadline (DESIGN.md §18). Only
        queued queries: a query sealed into a batch always completes."""
        if not any(e.deadline is not None for e in self._pending):
            return 0
        kept: Deque[_Pending] = deque()
        evicted = 0
        for e in self._pending:
            if e.deadline is not None and now > e.deadline:
                evicted += 1
            else:
                kept.append(e)
        if evicted:
            self._pending = kept
            self.stats.dropped_deadline += evicted
            count_drop(self.registry, "deadline_expired", evicted)
            self.registry.set_gauge("serve_queue_depth", len(self._pending))
        return evicted

    def poll(self, ticket: int) -> Optional[QueryResult]:
        """Fetch (and forget) a completed query's result."""
        return self._results.pop(ticket, None)

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    def _group_key(self, query: WalkQuery):
        return group_key(query, self.serve_cfg.length_buckets)

    def _admission_order(self) -> List[_Pending]:
        """Queue view in head-of-line order: arrival order under FIFO,
        (deadline, ticket) under EDF — deadline-free queries sort last and
        keep FIFO order among themselves."""
        if self.serve_cfg.admission == "fifo":
            return list(self._pending)
        return sorted(self._pending,
                      key=lambda e: (e.deadline if e.deadline is not None
                                     else math.inf, e.ticket))

    def _scan_group(self, order: Sequence[_Pending]):
        """The head query fixes the group key; same-group queries fold in
        along the admission order until the first one that does not fit
        the lane budget seals the scan (the prefix rule)."""
        head_key = self._group_key(order[0].query)
        budget = self.serve_cfg.lane_buckets[-1]
        take: List[_Pending] = []
        lanes, sealed = 0, False
        for e in order:
            if self._group_key(e.query) != head_key:
                continue
            if lanes + e.query.num_lanes > budget:
                sealed = True
                break
            take.append(e)
            lanes += e.query.num_lanes
        return head_key, take, lanes, sealed

    def _form_batch(self, now: float, force: bool):
        """Seal one batch if the linger rule allows; returns ``(group
        key, taken, lanes)`` (removing the taken queries from the queue)
        or None while the head batch keeps lingering. A batch seals when
        it cannot grow, when its head query has lingered ``linger_s``, or
        when forced (``step``/``drain``)."""
        if not self._pending:
            return None
        order = self._admission_order()
        head_key, take, lanes, sealed = self._scan_group(order)
        budget = self.serve_cfg.lane_buckets[-1]
        if not (force or sealed or lanes >= budget
                or now - take[0].arrival >= self.serve_cfg.linger_s):
            return None
        taken_tickets = {e.ticket for e in take}
        self._pending = deque(e for e in self._pending
                              if e.ticket not in taken_tickets)
        return head_key, take, lanes

    def _take_batch(self):
        """Force-seal one batch now (the synchronous entry point)."""
        return self._form_batch(time.perf_counter(), force=True)

    def _launch_lanes(self, params: LaneParams, wcfg: WalkConfig, pin,
                      use_tables: bool = False, second_order: bool = False):
        """Enqueue one packed lane batch against the pinned snapshot
        without waiting for it; returns the raw device outputs (a
        ``WalkResult`` on one device, the ``serve_lanes_sharded`` tuple
        sharded). ``use_tables``/``second_order`` say whether a lane of
        the batch is coded "table" / has (p, q) != (1, 1); a batch without
        such lanes runs the first-order program. Submit-time validation
        keeps both False when sharded."""
        if self.sharded:
            snap = self.snapshots
            return serve_lanes_sharded(
                pin.state, pin.view, self.base_key, params, mesh=snap.mesh,
                node_capacity=self.cfg.window.node_capacity, wcfg=wcfg,
                scfg=self.cfg.sampler, shard_cfg=self.cfg.shard,
                placement=snap.placement, with_probes=self.probes)
        snap = pin.state
        return generate_walk_lanes(snap.index, self.base_key, params, wcfg,
                                   self.cfg.sampler, self.sched_cfg,
                                   tables=snap.tables if use_tables else None,
                                   second_order=second_order)

    def _materialize(self, raw):
        """Bring one launched batch to the host: its (nodes, times,
        lengths) arrays, and when sharded the drop, claim and probe
        counters (and the exchange drops) in the same copy as the
        lengths, at this, the batch's only, host sync."""
        if not self.sharded:
            return result_arrays(raw)
        nodes, times, lengths, drops, claims = raw[:5]
        S, D = lengths.shape[0], self.num_shards
        words = [lengths, drops, claims]
        if self.probes:
            xdrops = self.snapshots.state.exchange_drops
            words += [raw[5].reshape(-1),
                      torch.stack([x.to(self.device) for x in xdrops])]
        host = torch.cat(words).cpu().numpy()
        drops_h, claims_h = host[S:S + D], host[S + D:S + 2 * D]
        self.stats.shard_walk_drops += int(drops_h.sum())
        if self.probes:
            flush_serve_probes(self.registry, host[S + 2 * D:-D].reshape(
                D, NUM_SERVE_PROBES))
            self._refresh_exchange_drops(int(host[-D:].sum()))
        for d, n in enumerate(claims_h):
            if n:
                self.stats.lanes_by_shard[d] = \
                    self.stats.lanes_by_shard.get(d, 0) + int(n)
        return nodes.cpu().numpy(), times.cpu().numpy(), host[:S]

    def _dispatch_lanes(self, params: LaneParams, wcfg: WalkConfig,
                        use_tables: bool = False,
                        second_order: bool = False):
        """Blocking form (the solo path): launch one lane batch against the
        current snapshot and bring its arrays to the host."""
        return self._materialize(self._launch_lanes(
            params, wcfg, self.snapshots.acquire(), use_tables=use_tables,
            second_order=second_order))

    # ------------------------------------------------------------------
    # Async runtime: launch ring + pump loop (DESIGN.md §18)
    # ------------------------------------------------------------------

    def _launch(self, batch) -> int:
        """Pack a sealed batch and enqueue it on the device; the batch
        joins the in-flight ring pinned to the current snapshot version.
        Reads nothing back from the device. Returns the number of queries
        admitted into it."""
        reg = self.registry
        (start_mode, len_bucket), taken, lanes = batch
        with span("coalesce", reg):
            lane_bucket = bucketize(lanes, self.serve_cfg.lane_buckets)
            queries = [e.query for e in taken]
            params, slices = pack_queries(queries, lane_bucket, len_bucket,
                                          device=self.device)
        wcfg = WalkConfig(num_walks=lane_bucket, max_length=len_bucket,
                          start_mode=start_mode)
        pin = self.snapshots.acquire()
        t0 = time.perf_counter()
        with span("dispatch", reg):
            raw = self._launch_lanes(
                params, wcfg, pin,
                use_tables=any(q.bias == "table" for q in queries),
                second_order=any(q.second_order for q in queries))
            ready = ready_event(self.device)
        self._inflight.append(_InFlight(
            raw=raw, ready=ready, taken=list(taken), slices=list(slices),
            lane_bucket=lane_bucket, lanes=lanes, version=pin.version,
            t0=t0))
        self.stats.batches += 1
        self.stats.lanes_dispatched += lane_bucket
        self.stats.lanes_live += lanes
        reg.inc("serve_batches_total", 1,
                help="coalesced serving dispatches")
        reg.inc("walks_dispatched_total", lane_bucket,
                labels={"path": "serve"},
                help="walk slots dispatched, by sampling path")
        reg.set_gauge("serve_lane_occupancy", self.stats.lane_occupancy,
                      help="live fraction of dispatched lanes")
        reg.set_gauge("serve_queue_depth", len(self._pending))
        reg.set_gauge("serve_inflight_depth", len(self._inflight),
                      help="dispatched batches not yet harvested")
        return len(taken)

    @staticmethod
    def _batch_ready(fl: _InFlight) -> bool:
        """Non-blocking readiness probe on one in-flight batch."""
        return fl.ready is None or fl.ready.query()

    def _harvest(self, fl: _InFlight) -> int:
        """Bring one in-flight batch to the host and deliver its results."""
        reg = self.registry
        nodes, times, lengths = self._materialize(fl.raw)
        done_t = time.perf_counter()
        elapsed = done_t - fl.t0
        self.stats.sample_s.append(elapsed)
        self.stats.busy_s += elapsed
        reg.observe("serve_batch_seconds", elapsed,
                    help="launch -> harvest wall time per coalesced batch")
        with span("result_slice", reg):
            for e, sl in zip(fl.taken, fl.slices):
                qn, qt, ql = slice_result(nodes, times, lengths, sl, e.query)
                self._results[e.ticket] = QueryResult(
                    ticket=e.ticket, query=e.query, nodes=qn, times=qt,
                    lengths=ql, latency_s=done_t - e.arrival,
                    snapshot_version=fl.version)
                if self._harvest_log is not None:
                    self._harvest_log.append(e.ticket)
                self.stats.completed += 1
                self.stats.walks += e.query.num_lanes
                self.stats.hops += int(np.sum(np.clip(ql - 1, 0, None)))
                self.stats.latencies_s.append(done_t - e.arrival)
                reg.observe("serve_latency_seconds", done_t - e.arrival,
                            help="submit -> complete latency per query")
        reg.inc("serve_completed_total", len(fl.taken),
                help="queries completed")
        reg.set_gauge("serve_inflight_depth", len(self._inflight))
        return len(fl.taken)

    @property
    def inflight_count(self) -> int:
        return len(self._inflight)

    def pump(self, block: bool = False) -> int:
        """Harvest completed in-flight batches, oldest first; returns the
        number of queries completed. ``block=False`` stops at the first
        batch still running on the device; ``block=True`` waits for the
        whole ring."""
        done = 0
        while self._inflight:
            if not block and not self._batch_ready(self._inflight[0]):
                break
            done += self._harvest(self._inflight.popleft())
        return done

    def tick(self, now: Optional[float] = None) -> int:
        """One turn of the async event loop: evict expired queries,
        harvest every ready batch, then seal + launch batches while the
        in-flight ring has room and the linger rule allows. Never blocks.
        Returns the number of queries completed this tick."""
        if now is None:
            now = time.perf_counter()
        self._evict_expired(now)
        done = self.pump(block=False)
        while (self._pending
               and len(self._inflight) < self.serve_cfg.max_inflight):
            batch = self._form_batch(now, force=False)
            if batch is None:
                break                      # head batch keeps lingering
            self._launch(batch)
        return done

    def step(self) -> int:
        """Serve one coalesced batch synchronously; returns the number of
        queries in it. Force-seals, then blocks until every in-flight
        batch — including any launched by earlier ``tick`` calls — is
        harvested."""
        self._evict_expired(time.perf_counter())
        if not self._pending:
            self.pump(block=True)
            return 0
        if len(self._inflight) >= self.serve_cfg.max_inflight:
            self.pump(block=True)
        n = self._launch(self._take_batch())
        self.pump(block=True)
        return n

    def drain(self) -> List[QueryResult]:
        """Serve until the queue and the in-flight ring are empty; return
        the results of exactly the queries completed during THIS drain
        (popped). Results of earlier ``step``/``tick`` calls stay
        poll-able."""
        log: List[int] = []
        outer = self._harvest_log
        self._harvest_log = log
        try:
            while self._pending or self._inflight:
                self._evict_expired(time.perf_counter())
                if (self._pending
                        and len(self._inflight)
                        < self.serve_cfg.max_inflight):
                    batch = self._form_batch(time.perf_counter(),
                                             force=True)
                    if batch is not None:
                        self._launch(batch)
                        continue
                self.pump(block=True)
        finally:
            self._harvest_log = outer
        if outer is not None:
            outer.extend(log)
        return [self._results.pop(t) for t in log if t in self._results]

    # ------------------------------------------------------------------
    # Reference path
    # ------------------------------------------------------------------

    def run_query_solo(self, query: WalkQuery):
        """Run one query alone at its exact shape (no coalescing, no
        bucketing) against the current snapshot: bit-identical to the same
        query served coalesced (and, sharded, to the single-device
        service's solo run). Accounted into ``solo_queries`` and the
        shared walks / hops / busy_s totals, not into the queue/latency
        stats."""
        params, (sl,) = pack_queries([query], query.num_lanes,
                                     query.max_length, device=self.device)
        wcfg = WalkConfig(num_walks=query.num_lanes,
                          max_length=query.max_length,
                          start_mode=query.start_mode)
        t0 = time.perf_counter()
        out = slice_result(
            *self._dispatch_lanes(params, wcfg,
                                  use_tables=query.bias == "table",
                                  second_order=query.second_order),
            sl, query)
        elapsed = time.perf_counter() - t0
        self.stats.solo_queries += 1
        self.stats.walks += query.num_lanes
        self.stats.hops += int(np.sum(np.clip(out[2] - 1, 0, None)))
        self.stats.busy_s += elapsed
        self.stats.sample_s.append(elapsed)
        self.registry.inc("walks_dispatched_total", query.num_lanes,
                          labels={"path": "solo"},
                          help="walk slots dispatched, by sampling path")
        return out
