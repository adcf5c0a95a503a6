"""The port's sharded serving (repro_torch/serve, DESIGN.md §13) against
the JAX reference, in one process, bitwise.

* The coalesced sharded service at D ∈ {1, 2, 4} under range, hash and
  skew placement equals the reference's single-device solo runs for the
  reference's query grid (three biases × two start modes); so does the
  sharded service's own solo path. Its ts view is byte-equal to the
  single-device store; no lane and no edge drops; the device-counted
  claims and the serve probes account for every started lane and hop.
* At D = 1 it also equals the reference's own sharded service: tickets,
  ``ServeStats`` and the registry's counters.
* The double buffer keeps the old version serveable until ``publish``,
  and a batch in flight across ``publish`` keeps its pinned version.
* The refusals equal the reference's ``ValueError``s; under-provisioned
  exchange buckets and walk slots show up in ``ServeStats`` as the
  reference counts them; ``ServeConfig.num_shards`` switches sharding on;
  ``lane_owners`` equals ``owner_np`` and the reference's.
* ``slow``: the reference with 8 forced host devices in a subprocess,
  under-provisioned walk slots, against the port at D = 8.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs import base as jcfg
from repro.data.synthetic import chronological_batches, powerlaw_temporal_graph
from repro.distributed import placement as jp
from repro.distributed import streaming_shard as jss
from repro.obs.registry import MetricsRegistry as JRegistry
from repro_torch import serve as tserve
from repro_torch.configs import base as tcfg
from repro_torch.core.edge_store import make_batch
from repro_torch.distributed import placement as tp
from repro_torch.distributed import streaming_shard as tss
from repro_torch.distributed.collectives import ShardGroup
from repro_torch.obs.registry import MetricsRegistry as TRegistry

ROOT = Path(__file__).resolve().parent.parent
NC = 128
BIASES = ("uniform", "linear", "exponential")
SHARD = dict(edge_capacity_per_shard=4096, exchange_capacity=4096,
             walk_slots=256, walk_bucket_capacity=256)


def _cfg(pkg, **shard):
    return pkg.EngineConfig(
        window=pkg.WindowConfig(duration=4000, edge_capacity=4096,
                                node_capacity=NC),
        sampler=pkg.SamplerConfig(mode="index"),
        scheduler=pkg.SchedulerConfig(path="grouped"),
        shard=pkg.ShardConfig(**{**SHARD, **shard}))


def _serve_cfg(pkg, **kw):
    return pkg.ServeConfig(lane_buckets=(8, 16, 64),
                           length_buckets=(4, 8, 16), **kw)


def _query_grid(pkg):
    """3 bias codes × 2 start modes, varied lengths, fan-outs and seeds
    (the reference's grid, tests/test_serve_sharded.py)."""
    queries = []
    for i, b in enumerate(BIASES):
        queries.append(pkg.WalkQuery(
            start_nodes=(1 + i, 30 + i, 60 + i, 99 - i), bias=b,
            max_length=5 + i, seed=100 + i))
        queries.append(pkg.WalkQuery(
            num_walks=3 + i, start_mode="edges", bias=b,
            start_bias=BIASES[(i + 1) % 3], max_length=4 + i, seed=200 + i))
    return queries


def _graph(edges=3000, seed=11):
    return powerlaw_temporal_graph(100, edges, seed=seed)


def _placement(kind, D):
    p = tp.make_placement(kind, D, NC)
    if kind == "skew":
        loads = np.bincount(_graph().src, minlength=NC)
        p = tp.SkewPlacement.from_loads(p, loads, k=6)
        assert p.hot_nodes
    return p


def _service(D, placement=None, shard=None, **kw):
    svc = tserve.WalkService(_cfg(tcfg, **(shard or {})), _serve_cfg(tcfg),
                             num_shards=D, device="cpu", placement=placement,
                             registry=TRegistry(), **kw)
    for bs, bd, bt in chronological_batches(_graph(), 3):
        svc.ingest(bs, bd, bt)
    return svc


def _j_service(shard=None, **kw):
    svc = jserve.WalkService(_cfg(jcfg, **(shard or {})), _serve_cfg(jcfg),
                             registry=JRegistry(), **kw)
    for bs, bd, bt in chronological_batches(_graph(), 3):
        svc.ingest(bs, bd, bt)
    return svc


def _serve_grid(svc, pkg):
    queries = _query_grid(pkg)
    tickets = [svc.submit(q, strict=True) for q in queries]
    while svc.pending_count:
        svc.step()
    return [svc.poll(t) for t in tickets]


def _assert_result(got, want, what=""):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(what))


@pytest.fixture(scope="module")
def reference():
    """The reference's single-device service over the stream, and its solo
    runs of the query grid."""
    ref = _j_service()
    return ref, [ref.run_query_solo(q) for q in _query_grid(jserve)]


@pytest.mark.parametrize("kind", ["range", "hash", "skew"])
@pytest.mark.parametrize("D", [1, 2, 4])
def test_coalesced_sharded_matches_single_device_solo(reference, D, kind):
    ref, want = reference
    svc = _service(D, _placement(kind, D))
    assert svc.sharded and svc.num_shards == D
    # the ts view is byte-equal to the single-device store
    rs, vs = ref.snapshots.current.index.store, svc.snapshots.view.store
    assert int(vs.num_edges) == int(rs.num_edges)
    for f in ("src", "dst", "ts"):
        np.testing.assert_array_equal(getattr(vs, f).numpy(),
                                      np.asarray(getattr(rs, f)), err_msg=f)
    results = _serve_grid(svc, tserve)
    for r, w in zip(results, want):
        assert r is not None
        _assert_result((r.nodes, r.times, r.lengths), w, (D, kind, r.query))
    st = svc.stats
    assert st.shard_walk_drops == 0 and st.exchange_drops == 0
    assert st.completed == len(results)
    # every started lane was claimed by one shard, on the device
    started = sum(int((r.lengths > 0).sum()) for r in results)
    assert sum(st.lanes_by_shard.values()) == started
    if D > 1 and kind != "range":
        assert len(st.lanes_by_shard) > 1
    # the serve probes: claims per shard, hop cells beyond the start cells
    reg = svc.registry
    for d, n in st.lanes_by_shard.items():
        assert reg.value("serve_lane_claims_total", {"shard": str(d)}) == n
    hops = sum(int(np.clip(r.lengths - (2 if r.query.start_mode == "edges"
                                        else 1), 0, None).sum())
               for r in results)
    assert sum(reg.value("walk_hops_total",
                         {"source": "serve", "shard": str(d)}, default=0)
               for d in range(D)) == hops
    # the sharded service's own solo path, query by query
    for q, w in zip(_query_grid(tserve), want):
        _assert_result(svc.run_query_solo(q), w, (D, kind, "solo", q))


def _leaves(tree):
    from repro_torch.train.checkpoint import _flatten_with_paths
    return [(k, x.clone()) for k, x in _flatten_with_paths(tree)]


def test_sharded_ingest_and_view_advance_leave_their_inputs():
    """``ingest_sharded_nodonate`` and ``advance_view`` return new state
    and write nothing they were given: the old version stays readable
    while the next one builds."""
    from repro_torch.core.window import advance_view
    svc = _service(4, _placement("hash", 4))
    snaps = svc.snapshots
    state, view = snaps.state, snaps.view
    before_state, before_view = _leaves(state), _leaves(view)
    g = _graph(1024, seed=5)
    batch = make_batch(g.src, g.dst, g.ts + 10_000,
                       capacity=snaps.batch_capacity, device="cpu")
    split = [a.reshape(4, snaps.batch_slice) for a in batch[:3]]
    new = tss.ingest_sharded_nodonate(
        state, *split, batch.count, mesh=snaps.mesh, node_capacity=NC,
        shard_cfg=svc.cfg.shard, placement=snaps.placement)
    new_view = advance_view(view, batch, NC)
    assert tss.ingest_sharded_nodonate is tss.ingest_sharded
    for (k, a), (_, b) in zip(before_state + before_view,
                              _leaves(state) + _leaves(view)):
        assert torch.equal(a, b), k
    assert int(new_view.t_now) > int(view.t_now)
    assert sum(int(w.index.num_edges) for w in new.window) == \
        int(new_view.store.num_edges)


def _series(reg):
    out = {}
    for fam in reg.families():
        if fam.kind == "histogram":
            continue
        for key, inst in fam.series.items():
            out[(fam.name, key)] = inst.value
    return out


def test_one_shard_matches_reference_sharded_service():
    t = _service(1)
    j = _j_service(num_shards=1)
    got, want = _serve_grid(t, tserve), _serve_grid(j, jserve)
    for g, w in zip(got, want):
        _assert_result((g.nodes, g.times, g.lengths),
                       (w.nodes, w.times, w.lengths), g.query)
        assert g.snapshot_version == w.snapshot_version
    for f in ("submitted", "completed", "batches", "lanes_dispatched",
              "lanes_live", "walks", "hops", "shard_walk_drops",
              "exchange_drops", "lanes_by_shard"):
        assert getattr(t.stats, f) == getattr(j.stats, f), f
    assert _series(t.registry) == _series(j.registry)


def test_sharded_snapshot_double_buffer_and_pinned_versions():
    """begin_ingest keeps the current (state, view) pair serveable;
    publish swaps both and bumps the version; a batch launched before
    publish and harvested after it keeps its version and its window;
    protocol errors raise as in the reference."""
    g = _graph(1500, seed=3)
    batches = list(chronological_batches(g, 3))
    svc = tserve.WalkService(_cfg(tcfg), _serve_cfg(tcfg), num_shards=2,
                             device="cpu", registry=TRegistry())
    old = jserve.WalkService(_cfg(jcfg), _serve_cfg(jcfg),
                             registry=JRegistry())
    for bs, bd, bt in batches[:-1]:
        svc.ingest(bs, bd, bt)
        old.ingest(bs, bd, bt)
    bs, bd, bt = batches[-1]
    v0 = svc.snapshots.version
    old_n = int(svc.snapshots.view.store.num_edges)
    pin = svc.snapshots.acquire()
    svc.begin_ingest(bs, bd, bt)
    assert svc.snapshots.ingest_in_flight
    with pytest.raises(RuntimeError, match="already in flight"):
        svc.begin_ingest(bs, bd, bt)
    # the front buffer still serves while the back buffer builds; the
    # batch launched now is harvested after the publish
    q_old = tserve.WalkQuery(start_nodes=(1, 2, 3), max_length=4, seed=1)
    t_old = svc.submit(q_old, strict=True)
    svc.tick()
    assert svc.inflight_count == 1
    assert int(svc.snapshots.view.store.num_edges) == old_n
    svc.publish()
    assert svc.snapshots.version == v0 + 1
    assert not svc.snapshots.ingest_in_flight
    assert int(svc.snapshots.view.store.num_edges) != old_n
    # the pinned pair is the old version's, untouched by the ingest
    assert pin.version == v0 and int(pin.view.store.num_edges) == old_n
    q_new = tserve.WalkQuery(num_walks=4, start_mode="edges", max_length=4,
                             seed=2)
    t_new = svc.submit(q_new, strict=True)
    svc.step()
    r_old, r_new = svc.poll(t_old), svc.poll(t_new)
    assert r_old.snapshot_version == v0
    assert r_new.snapshot_version == v0 + 1
    _assert_result((r_old.nodes, r_old.times, r_old.lengths),
                   old.run_query_solo(jserve.WalkQuery(
                       start_nodes=(1, 2, 3), max_length=4, seed=1)))
    old.ingest(bs, bd, bt)
    _assert_result((r_new.nodes, r_new.times, r_new.lengths),
                   old.run_query_solo(jserve.WalkQuery(
                       num_walks=4, start_mode="edges", max_length=4,
                       seed=2)))
    with pytest.raises(RuntimeError, match="no ingest in flight"):
        svc.publish()
    svc.begin_ingest(bs, bd, bt)
    svc.snapshots.discard()
    assert not svc.snapshots.ingest_in_flight


def test_sharded_serving_refusals_match_reference():
    def both(j_fn, t_fn):
        with pytest.raises(ValueError) as want:
            j_fn()
        with pytest.raises(ValueError) as got:
            t_fn()
        assert str(got.value) == str(want.value)

    cpu = dict(device="cpu")
    for sampler in (dict(mode="weight"), dict(mode="index", node2vec_p=2.0),
                    dict(mode="index", bias="table")):
        both(lambda: jserve.WalkService(dataclasses.replace(
                 _cfg(jcfg), sampler=jcfg.SamplerConfig(**sampler)),
                 num_shards=1),
             lambda: tserve.WalkService(dataclasses.replace(
                 _cfg(tcfg), sampler=tcfg.SamplerConfig(**sampler)),
                 num_shards=1, **cpu))
    # the state= override belongs to the single-device path
    from repro.core.window import init_window as j_init_window
    from repro_torch.core.window import init_window as t_init_window
    both(lambda: jserve.WalkService(_cfg(jcfg), _serve_cfg(jcfg),
                                    state=j_init_window(4096, NC, 4000),
                                    num_shards=1),
         lambda: tserve.WalkService(_cfg(tcfg), _serve_cfg(tcfg),
                                    state=t_init_window(4096, NC, 4000,
                                                        device="cpu"),
                                    num_shards=1, **cpu))
    # placement= needs sharding
    both(lambda: jserve.WalkService(_cfg(jcfg),
                                    placement=jp.make_placement("hash", 1,
                                                                NC)),
         lambda: tserve.WalkService(_cfg(tcfg),
                                    placement=tp.make_placement("hash", 1,
                                                                NC), **cpu))
    # more shards than devices
    n = len(jax.devices())
    both(lambda: jserve.ShardedSnapshotManager(_cfg(jcfg), num_shards=n + 1),
         lambda: tserve.ShardedSnapshotManager(
             _cfg(tcfg), num_shards=n + 1, devices=["cpu"] * n))
    # the lane walker refuses non-lane start modes and modes != index
    for wcfg, sampler in ((dict(start_mode="all_nodes"), dict(mode="index")),
                          (dict(start_mode="nodes"), dict(mode="weight"))):
        both(lambda: jss._check_supported(jcfg.WalkConfig(**wcfg),
                                          jcfg.SamplerConfig(**sampler),
                                          lanes=True),
             lambda: tss._check_supported(tcfg.WalkConfig(**wcfg),
                                          tcfg.SamplerConfig(**sampler),
                                          lanes=True))
    # a batch of the wrong capacity
    both(lambda: jserve.ShardedSnapshotManager(
             _cfg(jcfg), batch_capacity=1024, num_shards=1).begin_ingest(
             _j_batch()),
         lambda: tserve.ShardedSnapshotManager(
             _cfg(tcfg), batch_capacity=1024, num_shards=1,
             devices=["cpu"]).begin_ingest(
             make_batch([1], [2], [3], capacity=16, device="cpu")))
    # table-coded and second-order queries are refused at submit
    j, t = (jserve.WalkService(_cfg(jcfg), num_shards=1),
            tserve.WalkService(_cfg(tcfg), num_shards=1, **cpu))
    for kw in (dict(bias="table"), dict(n2v_p=2.0)):
        both(lambda: j.submit(jserve.WalkQuery(start_nodes=(1,), **kw)),
             lambda: t.submit(tserve.WalkQuery(start_nodes=(1,), **kw)))


def _j_batch():
    from repro.core.edge_store import make_batch as j_make_batch
    return j_make_batch([1], [2], [3], capacity=16)


@pytest.mark.parametrize("shard, counter", [
    (dict(exchange_capacity=8), "exchange_drops"),
    (dict(walk_slots=2), "shard_walk_drops")])
def test_under_provisioned_drops_match_reference(shard, counter):
    """Tight exchange buckets lose window edges, tight walk slots lose
    lanes: both counted in ``ServeStats`` as the reference counts them at
    D = 1, the tickets equal; D = 4 drops too; a healthy service stays at
    zero."""
    t, j = _service(1, shard=shard), _j_service(shard=shard, num_shards=1)
    got, want = _serve_grid(t, tserve), _serve_grid(j, jserve)
    assert getattr(j.stats, counter) > 0
    for f in ("exchange_drops", "shard_walk_drops", "lanes_by_shard"):
        assert getattr(t.stats, f) == getattr(j.stats, f), f
    for g, w in zip(got, want):
        _assert_result((g.nodes, g.times, g.lengths),
                       (w.nodes, w.times, w.lengths), g.query)
    drops = {k: v for k, v in _series(t.registry).items()
             if k[0] == "drops_total"}
    assert drops == {k: v for k, v in _series(j.registry).items()
                     if k[0] == "drops_total"}
    t4 = _service(4, shard=shard)
    _serve_grid(t4, tserve)
    assert getattr(t4.stats, counter) > 0
    healthy = _service(4)
    _serve_grid(healthy, tserve)
    assert healthy.stats.exchange_drops == healthy.stats.shard_walk_drops == 0


@pytest.mark.parametrize("num_shards", [1, 2])
def test_serve_config_num_shards_switch(num_shards):
    """ServeConfig.num_shards flips the service into sharded mode."""
    svc = tserve.WalkService(_cfg(tcfg), _serve_cfg(
        tcfg, num_shards=num_shards), device="cpu", registry=TRegistry())
    assert svc.sharded and svc.num_shards == num_shards
    assert isinstance(svc.snapshots, tserve.ShardedSnapshotManager)
    assert svc.placement is svc.snapshots.placement
    g = _graph(800, seed=9)
    svc.ingest(g.src, g.dst, g.ts)
    t = svc.submit(tserve.WalkQuery(start_nodes=(3, 4), max_length=4,
                                    seed=7), strict=True)
    svc.step()
    assert svc.poll(t) is not None
    # a mesh names the shards' devices itself
    meshed = tserve.WalkService(_cfg(tcfg), _serve_cfg(tcfg),
                                mesh=ShardGroup(["cpu"] * 3),
                                registry=TRegistry())
    assert meshed.num_shards == 3 and meshed.snapshots.mesh.size == 3


@pytest.mark.parametrize("kind", ["range", "hash", "skew"])
@pytest.mark.parametrize("D", [1, 3, 8])
def test_lane_owners_matches_owner_np(D, kind):
    queries_t = [tserve.WalkQuery(start_nodes=(0, 5, NC - 1, -1, NC + 3)),
                 tserve.WalkQuery(start_nodes=tuple(range(0, NC, 7)))]
    queries_j = [jserve.WalkQuery(start_nodes=q.start_nodes)
                 for q in queries_t]
    params_t, _ = tserve.pack_queries(queries_t, 32, 80, device="cpu")
    params_j, _ = jserve.pack_queries(queries_j, 32, 80)
    tplc = _placement(kind, D)
    jplc = jp.placement_from_manifest(tplc.describe())
    got = tserve.lane_owners(params_t, tplc)
    np.testing.assert_array_equal(got, jserve.lane_owners(params_j, jplc))
    active = params_t.active.numpy()
    starts = np.clip(params_t.start_node.numpy(), 0, NC - 1)
    np.testing.assert_array_equal(got[active], tplc.owner_np(starts[active]))
    assert (got[~active] == -1).all()


SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
from repro.configs.base import (EngineConfig, SamplerConfig, SchedulerConfig,
                                ServeConfig, ShardConfig, WindowConfig)
from repro.data.synthetic import chronological_batches, powerlaw_temporal_graph
from repro.serve import WalkQuery, WalkService
cfg = EngineConfig(
    window=WindowConfig(duration=4000, edge_capacity=4096, node_capacity=%d),
    sampler=SamplerConfig(mode="index"),
    scheduler=SchedulerConfig(path="grouped"),
    shard=ShardConfig(**%r))
svc = WalkService(cfg, ServeConfig(lane_buckets=(8, 16, 64),
                                   length_buckets=(4, 8, 16)), num_shards=8)
g = powerlaw_temporal_graph(100, 3000, seed=11)
for bs, bd, bt in chronological_batches(g, 3):
    svc.ingest(bs, bd, bt)
queries = [WalkQuery(start_nodes=tuple(range(32)), max_length=4, seed=1),
           WalkQuery(num_walks=24, start_mode="edges", max_length=4, seed=9)]
tickets = [svc.submit(q, strict=True) for q in queries]
while svc.pending_count:
    svc.step()
out = dict(drops=svc.stats.shard_walk_drops,
           claims={str(k): v for k, v in svc.stats.lanes_by_shard.items()},
           results=[[np.asarray(x).tolist() for x in
                     (r.nodes, r.times, r.lengths)]
                    for r in (svc.poll(t) for t in tickets)])
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.mark.slow      # 8-device reference subprocess
def test_walk_slot_overflow_matches_8_device_reference(tmp_path):
    shard = dict(SHARD, exchange_capacity=1024, walk_slots=2)
    path = tmp_path / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", SCRIPT % (NC, shard),
                          str(path)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(path.read_text())
    svc = _service(8, shard=dict(exchange_capacity=1024, walk_slots=2))
    queries = [tserve.WalkQuery(start_nodes=tuple(range(32)), max_length=4,
                                seed=1),
               tserve.WalkQuery(num_walks=24, start_mode="edges",
                                max_length=4, seed=9)]
    tickets = [svc.submit(q, strict=True) for q in queries]
    while svc.pending_count:
        svc.step()
    assert want["drops"] > 0
    assert svc.stats.shard_walk_drops == want["drops"]
    assert {str(k): v for k, v in svc.stats.lanes_by_shard.items()} == \
        want["claims"]
    for t, w in zip(tickets, want["results"]):
        r = svc.poll(t)
        _assert_result((r.nodes, r.times, r.lengths), w)
