"""The port's serving path against the JAX reference's, on the CPU.

* ``pack_queries`` lays out the same lane arrays as the reference's.
* ``WalkService`` of both packages, on the same stream, queries and seed:
  equal ``nodes``/``times``/``lengths``/``snapshot_version`` for every
  ticket and the same batch accounting, under FIFO and EDF admission,
  with linger, and across an overlapped ``begin_ingest``/``publish``. The
  port serves on its grouped and its fused path; the reference on its
  grouped path (its own tests hold its fused path to the same walks).
* Within the port: coalesced == solo, async (tick/pump) == sync (step).
* The policy cases of the reference's serving tests give the same drop
  accounting in both packages: backpressure, oversize, deadline eviction,
  and the in-flight ring bounded by ``max_inflight``.
* Table-coded and second-order (node2vec) queries: the reference's
  tickets on the grouped and fullwalk paths, with uniform and linear
  table weights, coalesced == solo.
* Refusals: the reference's ``ValueError`` where it refuses; what it runs
  and the port does not yet (sharded serving) raises
  ``NotImplementedError``.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.data.synthetic import chronological_batches, powerlaw_temporal_graph
from repro.obs.registry import DropCounters as JDropCounters
from repro.obs.registry import MetricsRegistry as JMetricsRegistry
from repro import serve as jserve
from repro_torch import serve as tserve
from repro_torch.configs import base as tcfg
from repro_torch.core.walk_engine import generate_walk_lanes
from repro_torch.obs.registry import DropCounters, MetricsRegistry

NC = 128
BIASES = ("uniform", "linear", "exponential")
TILES = dict(tile_walks=8, tile_edges=256)
SERVE = dict(lane_buckets=(8, 16, 64), length_buckets=(4, 8))


def _engine_cfg(pkg, path="grouped", tiles=TILES):
    return pkg.EngineConfig(
        window=pkg.WindowConfig(duration=4000, edge_capacity=4096,
                                node_capacity=NC),
        sampler=pkg.SamplerConfig(mode="index"),
        scheduler=pkg.SchedulerConfig(path=path, **tiles))


def _stream(n=4):
    g = powerlaw_temporal_graph(100, 4000, seed=11)
    return list(chronological_batches(g, n))


def _services(path="grouped", batches=3, tiles=TILES, **serve_kw):
    """(reference service, port service) with the same config, fed the
    first ``batches`` batches of the stream."""
    kw = {**SERVE, **serve_kw}
    j = jserve.WalkService(_engine_cfg(jcfg), jcfg.ServeConfig(**kw),
                           registry=JMetricsRegistry())
    t = tserve.WalkService(_engine_cfg(tcfg, path, tiles),
                           tcfg.ServeConfig(**kw),
                           registry=MetricsRegistry(), device="cpu")
    for b in _stream()[:batches]:
        j.ingest(*b)
        t.ingest(*b)
    return j, t


def _queries(n=12, seed0=500, deadlines=False):
    """Mixed traffic: nodes and edges mode, all three biases, lengths
    that span both length buckets, and start nodes out of range."""
    qs = []
    for i in range(n):
        dl = dict(deadline_s=60.0 - i) if deadlines and i % 2 else {}
        if i % 3 == 2:
            qs.append(jserve.WalkQuery(
                num_walks=2 + i % 5, start_mode="edges", bias=BIASES[i % 3],
                start_bias=BIASES[(i + 1) % 3], max_length=3 + i % 6,
                seed=seed0 + i, **dl))
        else:
            starts = tuple((5 * i + 3 * j) % (NC + 4) - 2
                           for j in range(1 + i % 5))
            qs.append(jserve.WalkQuery(
                start_nodes=starts, bias=BIASES[i % 3],
                max_length=2 + i % 7, seed=seed0 - 7 * i, **dl))
    return qs


def _port_query(q):
    return tserve.WalkQuery(**dataclasses.asdict(q))


def _drive(svc, queries, batch4, to_port=False, linger=False):
    """The same traffic on either package: a wave, an overlapped ingest
    (begin_ingest, a second wave, publish), a third wave, then drain.
    Returns ({ticket: result}, whether the head batch lingered)."""
    conv = _port_query if to_port else (lambda q: q)
    waves = (queries[:4], queries[4:8], queries[8:])
    tickets = [svc.submit(conv(q), strict=True) for q in waves[0]]
    if linger:
        head = svc._pending[0].arrival
        svc.tick(now=head)
        lingered = svc.inflight_count == 0 and svc.pending_count > 0
        svc.tick(now=head + svc.serve_cfg.linger_s)
    else:
        lingered = None
        svc.tick()
    svc.begin_ingest(*batch4)
    tickets += [svc.submit(conv(q), strict=True) for q in waves[1]]
    svc.tick(now=time.perf_counter() + svc.serve_cfg.linger_s)
    svc.publish()
    tickets += [svc.submit(conv(q), strict=True) for q in waves[2]]
    got = {r.ticket: r for r in svc.drain()}
    for t in tickets:
        r = svc.poll(t)
        if r is not None:
            got[t] = r
    assert sorted(got) == sorted(tickets)
    return got, lingered


_REF_CACHE = {}

SCENARIOS = {
    "fifo": dict(serve=dict(max_inflight=8), deadlines=False, linger=False),
    "edf": dict(serve=dict(max_inflight=8, admission="edf"),
                deadlines=True, linger=False),
    "linger": dict(serve=dict(max_inflight=8, linger_s=5.0),
                   deadlines=False, linger=True),
}


def _reference_run(name):
    if name not in _REF_CACHE:
        sc = SCENARIOS[name]
        j, _ = _services(**sc["serve"])
        res, lingered = _drive(
            j, _queries(deadlines=sc["deadlines"]), _stream()[3],
            linger=sc["linger"])
        _REF_CACHE[name] = (res, j.stats, lingered)
    return _REF_CACHE[name]


@pytest.mark.parametrize("path", ["grouped", "fused"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_service_matches_reference(scenario, path):
    sc = SCENARIOS[scenario]
    want, want_stats, want_lingered = _reference_run(scenario)
    _, t = _services(path=path, **sc["serve"])
    got, lingered = _drive(
        t, _queries(deadlines=sc["deadlines"]), _stream()[3], to_port=True,
        linger=sc["linger"])
    assert lingered == want_lingered
    assert sorted(got) == sorted(want)
    versions = set()
    for ticket, w in want.items():
        g = got[ticket]
        for f in ("nodes", "times", "lengths"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f"{ticket} {f}")
        assert g.snapshot_version == w.snapshot_version, ticket
        versions.add(g.snapshot_version)
    assert versions == {3, 4}          # the publish split the traffic
    for f in ("submitted", "completed", "batches", "lanes_dispatched",
              "lanes_live", "walks", "hops", "dropped"):
        assert getattr(t.stats, f) == getattr(want_stats, f), f
    reg = t.registry
    assert reg.value("serve_batches_total") == t.stats.batches
    assert reg.value("stage_calls_total", {"stage": "dispatch"}) == \
        t.stats.batches
    assert reg.value("snapshot_publishes_total") == 4
    assert reg.get_family("serve_latency_seconds").series[()].count == \
        len(want)
    assert any(r.lengths.max() > 2 for r in got.values())


def test_windows_match_reference():
    """The service's double-buffered window equals the reference's, and
    ``begin_ingest`` never writes the front buffer."""
    j, t = _services()
    front = [x.clone() for x in t.snapshots.current.index.store]
    t.begin_ingest(*_stream()[3])
    j.begin_ingest(*_stream()[3])
    assert t.snapshots.ingest_in_flight
    for x, y in zip(t.snapshots.current.index.store, front):
        assert torch.equal(x, y)
    t.publish()
    j.publish()
    assert t.snapshots.version == j.snapshots.version == 4
    ti, ji = t.snapshots.current.index, j.snapshots.current.index
    for f in ("ns_order", "ns_src", "ns_dst", "ns_ts", "node_starts",
              "adj_order", "adj_dst"):
        np.testing.assert_array_equal(getattr(ti, f).numpy(),
                                      np.asarray(getattr(ji, f)), err_msg=f)
    for f in ("t_now", "ingested", "late_drops", "overflow_drops"):
        assert int(getattr(t.snapshots.current, f)) == int(
            getattr(j.snapshots.current, f)), f
    with pytest.raises(RuntimeError, match="no ingest in flight"):
        t.publish()
    t.begin_ingest(*_stream()[0])
    with pytest.raises(RuntimeError, match="already in flight"):
        t.begin_ingest(*_stream()[0])
    t.snapshots.discard()
    assert not t.snapshots.ingest_in_flight


@pytest.mark.parametrize("edges_mode", [False, True])
def test_pack_queries_matches_reference(edges_mode):
    if edges_mode:
        qs = [jserve.WalkQuery(num_walks=n, start_mode="edges",
                               bias=BIASES[n % 3],
                               start_bias=BIASES[(n + 1) % 3],
                               max_length=1 + n, seed=-n * 1000)
              for n in (1, 3, 2)]
    else:
        qs = [jserve.WalkQuery(start_nodes=(1, -1, NC + 9), bias="linear",
                               max_length=3, seed=(1 << 31) - 1),
              jserve.WalkQuery(start_nodes=(7,), bias="uniform",
                               max_length=8, seed=-(1 << 31)),
              jserve.WalkQuery(start_nodes=(0, 5), max_length=2)]
    want, wsl = jserve.pack_queries(qs, 16, 8)
    got, gsl = tserve.pack_queries([_port_query(q) for q in qs], 16, 8,
                                   device="cpu")
    assert [(s.offset, s.count) for s in gsl] == \
        [(s.offset, s.count) for s in wsl]
    for f in want._fields:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(bool): torch.bool,
                           np.dtype(np.float32): torch.float32}[w.dtype], f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
    with pytest.raises(ValueError, match="exceed"):
        tserve.pack_queries([_port_query(qs[0])] * 17, 16, 8,
                            device="cpu")
    with pytest.raises(ValueError, match="length bucket"):
        tserve.pack_queries([_port_query(qs[0])], 16, 1, device="cpu")


def test_shape_buckets_and_group_key():
    for n, want in ((1, 8), (8, 8), (9, 16), (17, None)):
        assert tserve.bucketize(n, (8, 16)) == want
    q = tserve.WalkQuery(start_nodes=(1,), max_length=5)
    assert tserve.group_key(q, (4, 8)) == ("nodes", 8)
    assert tserve.group_key(_port_query(jserve.WalkQuery(
        num_walks=2, start_mode="edges", max_length=9)), (4, 8)) == \
        ("edges", None)


def test_coalesced_equals_solo_and_async_equals_sync():
    # one-lane tiles: a solo run has the query's own lane count, which the
    # fused hop takes only in whole tiles
    one = dict(tile_walks=1, tile_edges=256)
    _, t = _services(path="fused", tiles=one, max_inflight=4)
    queries = [_port_query(q) for q in _queries(n=15, seed0=90)]
    tickets = [t.submit(q, strict=True) for q in queries]
    while t.pending_count or t.inflight_count:
        t.tick()
    async_res = {k: t.poll(k) for k in tickets}
    _, s = _services(path="fused", tiles=one, max_inflight=1)
    sync_t = [s.submit(q, strict=True) for q in queries]
    while s.pending_count:
        s.step()
    for a, b, q in zip(tickets, sync_t, queries):
        ra, rb = async_res[a], s.poll(b)
        solo = t.run_query_solo(q)
        for x, y, z in zip((ra.nodes, ra.times, ra.lengths),
                           (rb.nodes, rb.times, rb.lengths), solo):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
    assert t.stats.solo_queries == len(queries)
    assert s.stats.batches > 1


def test_served_walks_are_valid_and_padded():
    from repro_torch.core.validation import validate_walks
    from repro_torch.core.walk_engine import WalkResult
    _, t = _services(path="fused")
    qs = [tserve.WalkQuery(start_nodes=tuple(range(40)), bias=b,
                           max_length=8, seed=i)
          for i, b in enumerate(BIASES)]
    tickets = [t.submit(q, strict=True) for q in qs]
    served = t.drain()
    assert sorted(r.ticket for r in served) == tickets
    for r in served:
        rep = validate_walks(t.snapshots.current.index, WalkResult(
            *(torch.from_numpy(x) for x in (r.nodes, r.times, r.lengths))))
        assert rep.num_hops > 0 and rep.hop_valid_frac == 1.0
        assert r.lengths.max() <= r.query.max_length + 1
        for w in range(r.nodes.shape[0]):
            assert np.all(r.nodes[w, r.lengths[w]:] == -1)


# ---------------------------------------------------------------------------
# Policy cases: the same drop accounting as the reference
# ---------------------------------------------------------------------------


def _case_backpressure(svc, W):
    qs = [W(start_nodes=(i % NC,), max_length=4, seed=i) for i in range(5)]
    tickets = [svc.submit(q) for q in qs]
    strict_raised = False
    try:
        svc.submit(qs[0], strict=True)
    except RuntimeError:
        strict_raised = True
    served = len(svc.drain())
    again = svc.submit(qs[3]) is not None
    return tickets, strict_raised, served, again


def _case_oversize(svc, W):
    out = []
    for q in (W(start_nodes=tuple(range(65)), max_length=4),
              W(start_nodes=(1,), max_length=9)):
        for strict in (False, True):
            try:
                out.append(svc.submit(q, strict=strict))
            except ValueError as e:
                out.append(type(e).__name__ + ":" + str(e))
    return out


def _case_deadline(svc, W):
    t_dead = svc.submit(W(start_nodes=(1,), max_length=4, seed=1,
                          deadline_s=1e-4), strict=True)
    t_live = svc.submit(W(start_nodes=(2,), max_length=4, seed=2),
                        strict=True)
    time.sleep(0.01)
    drained = sorted(r.ticket for r in svc.drain())
    dead_polled = svc.poll(t_dead) is None
    t3 = svc.submit(W(start_nodes=(3,), max_length=4, seed=3,
                      deadline_s=1e-4), strict=True)
    svc.tick(now=svc._pending[0].arrival)     # launched before expiry
    time.sleep(0.01)
    svc.pump(block=True)
    return drained, t_live, dead_polled, svc.poll(t3) is not None


def _case_ring(svc, W):
    qs = [W(start_nodes=(2 * i, 2 * i + 1), max_length=4, seed=i)
          for i in range(6)]
    tickets = [svc.submit(q, strict=True) for q in qs]
    depths = []
    while svc.pending_count or svc.inflight_count:
        svc.tick()
        depths.append(svc.inflight_count)
    svc.pump(block=True)
    return max(depths) <= 2, all(svc.poll(t) is not None for t in tickets)


POLICY_CASES = {
    "backpressure": (_case_backpressure, dict(queue_capacity=3)),
    "oversize_drop": (_case_oversize, dict(drop_oversize=True)),
    "oversize_refuse": (_case_oversize, dict(drop_oversize=False)),
    "deadline": (_case_deadline, {}),
    "ring": (_case_ring, dict(max_inflight=2, lane_buckets=(2,))),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_accounting_matches_reference(case):
    run, serve_kw = POLICY_CASES[case]
    j, t = _services(batches=1, **serve_kw)
    want = run(j, jserve.WalkQuery)
    got = run(t, tserve.WalkQuery)
    assert got == want
    for f in ("submitted", "completed", "dropped_backpressure",
              "dropped_oversize", "dropped_deadline", "batches"):
        assert getattr(t.stats, f) == getattr(j.stats, f), f
    assert DropCounters.from_registry(t.registry).as_dict() == \
        JDropCounters.from_registry(j.registry).as_dict()


def test_latency_percentile_degenerate_histories():
    s = tserve.ServeStats()
    assert np.isnan(s.latency_percentile(50)) and np.isnan(s.p99_ms)
    assert s.walks_per_s == 0.0 and s.lane_occupancy == 0.0
    s.latencies_s.append(0.25)
    for q in (0, 50, 99, 100):
        assert s.latency_percentile(q) == pytest.approx(0.25)
    with pytest.raises(ValueError):
        s.latency_percentile(101)


def test_step_and_drain_scoping():
    """step() harvests batches earlier ticks launched; drain() returns
    exactly what it completed and leaves earlier results poll-able."""
    _, t = _services(max_inflight=4, lane_buckets=(2,))
    W = tserve.WalkQuery
    ta = t.submit(W(start_nodes=(1, 2), max_length=4, seed=1), strict=True)
    t.tick()
    assert t.inflight_count == 1
    tb = t.submit(W(start_nodes=(3, 4), max_length=4, seed=2), strict=True)
    assert t.step() == 1 and t.inflight_count == 0
    tc = t.submit(W(start_nodes=(5, 6), max_length=4, seed=3), strict=True)
    t.tick()
    td = t.submit(W(start_nodes=(7, 8), max_length=4, seed=4), strict=True)
    drained = t.drain()
    assert {r.ticket for r in drained} == {tc, td}
    assert t.poll(ta) is not None and t.poll(tb) is not None
    assert t.drain() == []


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def test_query_validation_matches_reference():
    bad = [dict(start_nodes=(), start_mode="nodes"),
           dict(start_nodes=(1,), bias="gaussian"),
           dict(start_nodes=(1,), max_length=0),
           dict(start_mode="edges", num_walks=0),
           dict(start_nodes=(1,), seed=1 << 31),
           dict(start_nodes=(1 << 31,)),
           dict(start_nodes=(1,), start_bias="table"),
           dict(start_nodes=(1,), n2v_p=0.0),
           dict(start_nodes=(1,), deadline_s=0.0)]
    for kw in bad:
        with pytest.raises(ValueError) as want:
            jserve.WalkQuery(**kw)
        with pytest.raises(ValueError, match=str(want.value)[:20]):
            tserve.WalkQuery(**kw)
    assert tserve.WalkQuery(start_mode="edges", num_walks=5).num_lanes == 5


def test_service_refusals():
    cfg = _engine_cfg(tcfg)
    dev = dict(device="cpu")
    for bad, match in ((dict(max_inflight=0), "max_inflight"),
                       (dict(linger_s=-0.5), "linger_s"),
                       (dict(admission="lifo"), "admission"),
                       (dict(lane_buckets=(16, 8)), "sorted")):
        with pytest.raises(ValueError, match=match):
            tserve.WalkService(cfg, tcfg.ServeConfig(**bad), **dev)
    # refused as the reference refuses them
    for sampler in (tcfg.SamplerConfig(mode="weight"),
                    tcfg.SamplerConfig(mode="index", node2vec_p=2.0)):
        with pytest.raises(ValueError, match="unsupported sampler"):
            tserve.WalkService(dataclasses.replace(cfg, sampler=sampler),
                               **dev)
    with pytest.raises(ValueError, match="placement"):
        tserve.WalkService(cfg, placement=object(), **dev)
    # the tiled path serves on grouped; the engine refuses a tiled batch
    svc = tserve.WalkService(dataclasses.replace(
        cfg, scheduler=tcfg.SchedulerConfig(path="tiled")), **dev)
    assert svc.sched_cfg.path == "grouped"
    params, _ = tserve.pack_queries(
        [tserve.WalkQuery(start_nodes=(1,), max_length=4)], 8, 4, **dev)
    with pytest.raises(ValueError, match="per-lane batches support"):
        generate_walk_lanes(svc.snapshots.current.index, svc.base_key,
                            params, tcfg.WalkConfig(num_walks=8,
                                                    max_length=4),
                            tcfg.SamplerConfig(mode="index"),
                            tcfg.SchedulerConfig(path="tiled"))
    # what the reference runs and the port does not yet: sharded serving
    not_yet = [
        lambda: tserve.WalkService(cfg, tcfg.ServeConfig(num_shards=2),
                                   **dev),
        lambda: tserve.WalkService(cfg, num_shards=2, **dev),
        lambda: tserve.WalkService(cfg, mesh=object(), **dev),
    ]
    for call in not_yet:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            call()
    # alias tables and node2vec run: a table query is refused only where
    # the window has no tables, with the reference's message
    j_svc = jserve.WalkService(_engine_cfg(jcfg), registry=JMetricsRegistry())
    with pytest.raises(ValueError) as want:
        j_svc.submit(jserve.WalkQuery(start_nodes=(1,), bias="table"))
    with pytest.raises(ValueError) as got:
        svc.submit(tserve.WalkQuery(start_nodes=(1,), bias="table"))
    assert str(got.value) == str(want.value)
    for sampler in (tcfg.SamplerConfig(mode="index", bias="table"),
                    tcfg.SamplerConfig(mode="index",
                                       table_weight="exponential")):
        tsvc = tserve.WalkService(dataclasses.replace(cfg, sampler=sampler),
                                  **dev)
        assert tsvc.snapshots.current.tables is not None
        assert tsvc.submit(tserve.WalkQuery(start_nodes=(1,),
                                            bias="table")) == 0
    j, t = _services()
    for q in (jserve.WalkQuery(start_nodes=(1, 5, 9), n2v_q=0.5, seed=3,
                               max_length=6),
              jserve.WalkQuery(start_nodes=(2, 7), n2v_p=2.0, seed=4,
                               bias="linear", max_length=5)):
        for a, b in zip(t.run_query_solo(_port_query(q)),
                        j.run_query_solo(q)):
            np.testing.assert_array_equal(a, b)
    assert svc.pending_count == 0


# ---------------------------------------------------------------------------
# Alias-table and second-order (node2vec) queries
# ---------------------------------------------------------------------------


def _table_queries(n=12):
    """Table-coded, second-order, both, and closed-form queries in turn,
    in both start modes (t_max 1,000 keeps every table sum exact)."""
    pq = (0.5, 1.0, 2.0)
    qs = []
    for i in range(n):
        kind = i % 4
        kw = dict(max_length=2 + i % 6, seed=900 + 13 * i,
                  bias="table" if kind in (0, 2) else BIASES[i % 3])
        if kind in (1, 2):
            kw.update(n2v_p=pq[i % 3], n2v_q=pq[(i + 1) % 3])
            if kw["n2v_p"] == kw["n2v_q"] == 1.0:
                kw["n2v_q"] = 2.0
        if kind == 2:
            qs.append(jserve.WalkQuery(num_walks=2 + i % 3,
                                       start_mode="edges", **kw))
        else:
            qs.append(jserve.WalkQuery(
                start_nodes=tuple((7 * i + 5 * j) % NC
                                  for j in range(1 + i % 4)), **kw))
    return qs


@pytest.mark.parametrize("path", ["grouped", "fullwalk"])
@pytest.mark.parametrize("weight", ["uniform", "linear"])
def test_table_and_node2vec_tickets_match_reference(weight, path):
    g = powerlaw_temporal_graph(100, 4000, seed=12, t_max=1000)
    stream = list(chronological_batches(g, 4))
    svcs = []
    for pkg, srv, reg, dev in ((jcfg, jserve, JMetricsRegistry, {}),
                               (tcfg, tserve, MetricsRegistry,
                                dict(device="cpu"))):
        cfg = dataclasses.replace(
            _engine_cfg(pkg, path),
            sampler=pkg.SamplerConfig(mode="index", table_weight=weight))
        svc = srv.WalkService(cfg, pkg.ServeConfig(max_inflight=8, **SERVE),
                              registry=reg(), **dev)
        for b in stream[:3]:
            svc.ingest(*b)
        svcs.append(svc)
    j, t = svcs
    queries = _table_queries()
    want, _ = _drive(j, queries, stream[3])
    got, _ = _drive(t, queries, stream[3], to_port=True)
    assert sorted(got) == sorted(want)
    for ticket, w in want.items():
        g_ = got[ticket]
        for f in ("nodes", "times", "lengths"):
            np.testing.assert_array_equal(getattr(g_, f), getattr(w, f),
                                          err_msg=f"{ticket} {f}")
        assert g_.snapshot_version == w.snapshot_version
    for f in ("thresh", "partner", "ptab", "rebuilt"):
        np.testing.assert_array_equal(
            getattr(t.snapshots.current.tables, f).numpy(),
            np.asarray(getattr(j.snapshots.current.tables, f)), err_msg=f)
    assert t.registry.value("alias_nodes_rebuilt_total") == \
        j.registry.value("alias_nodes_rebuilt_total") > 0
    # coalesced == solo, on the window every ticket of the last wave read
    for ticket in sorted(got)[-4:]:
        r = got[ticket]
        for a, b in zip(t.run_query_solo(r.query),
                        (r.nodes, r.times, r.lengths)):
            np.testing.assert_array_equal(a, b)
    assert any(r.lengths.max() > 2 for r in got.values())
