"""The port's sharded-window checkpoints (repro_torch/train/checkpoint.py)
and stream supervisor (repro_torch/distributed/fault_tolerance.py)
against the JAX reference, in one process.

* A port checkpoint of a sharded window round-trips byte for byte, and
  its files (every ``.npy``, ``manifest.json``) are byte-equal to the
  reference's for the same window.
* Cross-format, both directions: a checkpoint written by
  ``repro.train.checkpoint.save_sharded_window`` restores in the port to
  the same leaves, placement and walk key (and, elastically, to the
  port's own reshard); one written by the port restores in the reference.
* Elastic restores 4 → 2 and 2 → 4 under ``StreamSupervisor`` keep the
  edge multiset and the counters, and the continued replay finishes
  bit-equal, in walk key, ``ReplayStats`` and window, to an uninterrupted
  run at the target count, and to the reference's single-device replay.
* ``StragglerPolicy`` gives the reference's verdicts on the same step
  times; ``health_snapshot(engine=)`` the reference's per-shard section.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import base as jcfg
from repro.core.streaming import StreamingEngine as JStreamingEngine
from repro.data.synthetic import powerlaw_temporal_graph
from repro.distributed import fault_tolerance as jft
from repro.distributed import placement as jp
from repro.distributed import streaming_shard as jss
from repro.train import checkpoint as jck
from repro_torch import interop
from repro_torch import obs as tobs
from repro_torch.configs import base as tcfg
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.distributed import placement as tp
from repro_torch.distributed import streaming_shard as tss
from repro_torch.distributed.collectives import ShardGroup
from repro_torch.train import checkpoint as tck

N, E, NB = 128, 2000, 5
BS = E // NB
POOL = ["cpu"] * 8
WALKS = dict(num_walks=256, max_length=8, start_mode="all_nodes")


def _cfg(pkg):
    return pkg.EngineConfig(
        window=pkg.WindowConfig(duration=5000, edge_capacity=4096,
                                node_capacity=N),
        sampler=pkg.SamplerConfig(bias="exponential", mode="index"),
        scheduler=pkg.SchedulerConfig(path="grouped", regroup="bucket"),
        shard=pkg.ShardConfig(edge_capacity_per_shard=4096,
                              exchange_capacity=1024, walk_slots=512,
                              walk_bucket_capacity=512))


def _batches():
    """Five batches with distinct timestamps: the canonical reshard merge
    sorts stably by ts, so every per-shard order is determined."""
    g = powerlaw_temporal_graph(N, E, seed=7)
    ts = np.arange(E, dtype=g.ts.dtype)
    return [(g.src[i * BS:(i + 1) * BS], g.dst[i * BS:(i + 1) * BS],
             ts[i * BS:(i + 1) * BS]) for i in range(NB)]


def _engine(D, placement=None):
    return tss.DistributedStreamingEngine(
        _cfg(tcfg), BS, num_shards=D, devices=POOL, placement=placement,
        registry=tobs.new_registry())


def _edge_multiset(state):
    out = []
    for w in state.window:
        n, s = int(w.index.num_edges), w.index.store
        out += list(zip(s.src[:n].tolist(), s.dst[:n].tolist(),
                        s.ts[:n].tolist()))
    return sorted(out)


def _counters(state):
    out = {f: sum(int(getattr(w, f)) for w in state.window)
           for f in ("ingested", "late_drops", "overflow_drops")}
    out["exchange_drops"] = sum(int(x) for x in state.exchange_drops)
    return out


def _assert_same_state(a, b):
    la, lb = tck._flatten_with_paths(a), tck._flatten_with_paths(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def _files(path):
    """{name: bytes} of a checkpoint directory, without the reference's
    leftover temporary files."""
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path)) if not f.endswith(".tmp")}


@pytest.mark.parametrize("kind", ["range", "hash", "skew"])
def test_round_trip_is_byte_equal(tmp_path, kind):
    eng = _engine(4, tp.make_placement(kind, 4, N))
    eng.replay_device(_batches()[:3], tcfg.WalkConfig(**WALKS))
    if kind == "skew":
        eng.rebalance(k=4)
    first, again = str(tmp_path / "first"), str(tmp_path / "again")
    tck.save_sharded_window(first, eng.state, eng.placement, 3,
                            walk_key=eng.key)
    assert tck.latest_step(first) == 3
    meta = tck.load_placement_manifest(first)
    assert meta["placement"] == eng.placement.describe()
    assert (meta["num_shards"], meta["edge_capacity_per_shard"],
            meta["node_capacity"], meta["window"]) == (4, 4096, N, 5000)
    state, plc, key = tck.restore_sharded_window(first, devices=POOL)
    assert plc == eng.placement
    assert torch.equal(key, eng.key)
    _assert_same_state(state, eng.state)
    # saved again, the files are the same bytes
    tck.save_sharded_window(again, state, plc, 3, walk_key=key)
    assert _files(again) == _files(first)


def test_reference_checkpoint_restores_in_port(tmp_path):
    j = jss.DistributedStreamingEngine(_cfg(jcfg), BS, num_shards=1,
                                       registry=jobs.new_registry())
    j.replay_device(_batches()[:3], jcfg.WalkConfig(**WALKS))
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    jck.save_sharded_window(ref_dir, j.state, j.placement, 3,
                            walk_key=j.key)
    state, plc, key = tck.restore_sharded_window(ref_dir, devices=POOL)
    want = interop.sharded_window_from_ref(j.state, device="cpu")
    _assert_same_state(state, want)
    assert plc.describe() == j.placement.describe()
    assert key.tolist() == np.asarray(j.key).astype(np.int64).tolist()
    # the port writes the reference's bytes for the same window
    tck.save_sharded_window(port_dir, state, plc, 3, walk_key=key)
    assert _files(port_dir) == _files(ref_dir)
    # an elastic restore equals the port's own host reshard
    for D, kind in ((4, "range"), (2, "hash")):
        target = tp.make_placement(kind, D, N)
        got, gplc, _ = tck.restore_sharded_window(ref_dir, placement=target,
                                                  devices=POOL)
        assert gplc == target
        _assert_same_state(got, tss.reshard_host(
            want, target, mesh=ShardGroup(POOL[:D])))
        assert _edge_multiset(got) == _edge_multiset(want)


@pytest.mark.parametrize("D", [1, 4])
def test_port_checkpoint_restores_in_reference(tmp_path, D):
    eng = _engine(D, tp.make_placement("hash", D, N))
    eng.replay_device(_batches()[:3], tcfg.WalkConfig(**WALKS))
    tck.save_sharded_window(str(tmp_path), eng.state, eng.placement, 3,
                            walk_key=eng.key)
    jstate, jplc, jkey = jck.restore_sharded_window(str(tmp_path))
    assert jplc.describe() == eng.placement.describe()
    assert np.asarray(jkey).tolist() == [int(x) for x in eng.key]
    # the reference's leaves [D, ...] split per shard are the port's
    _assert_same_state(interop.sharded_window_from_ref(jstate, device="cpu"),
                       eng.state)
    # and the reference restores it elastically onto one shard
    jone, _, _ = jck.restore_sharded_window(str(tmp_path), num_shards=1)
    assert int(np.asarray(jone.window.index.num_edges).sum()) == \
        sum(int(w.index.num_edges) for w in eng.state.window)


@pytest.fixture(scope="module")
def single_device():
    """The reference's single-device engine, replayed one batch a call."""
    eng = JStreamingEngine(_cfg(jcfg), batch_capacity=BS)
    wcfg = jcfg.WalkConfig(**WALKS)
    stats = [eng.replay_device([b], wcfg, return_walks=True)[:2]
             for b in _batches()]
    n = int(eng.state.index.store.num_edges)
    s = eng.state.index.store
    edges = sorted(zip(np.asarray(s.src)[:n].tolist(),
                       np.asarray(s.dst)[:n].tolist(),
                       np.asarray(s.ts)[:n].tolist()))
    return stats, edges


@pytest.mark.parametrize("D_save, D_load", [(4, 2), (2, 4)])
def test_supervisor_elastic_restore_matches_uninterrupted(
        tmp_path, single_device, D_save, D_load):
    (stats_ref, edges_ref) = single_device
    batches = _batches()
    wcfg = tcfg.WalkConfig(**WALKS)
    sup = tft.StreamSupervisor(str(tmp_path), save_every=3,
                               registry=tobs.new_registry())
    e1 = _engine(D_save)
    sup.run(e1, batches[:3], wcfg)
    assert sup.resume_batch() == 3
    assert sup.registry.value("checkpoints_total", {"kind": "window"}) == 1
    e2 = sup.checkpointer.restore_engine(_cfg(tcfg), BS, num_shards=D_load,
                                         devices=POOL)
    assert e2.num_shards == D_load == e2.mesh.size
    assert _edge_multiset(e2.state) == _edge_multiset(e1.state)
    assert _counters(e2.state) == _counters(e1.state)
    out, step = sup.run(e2, batches, wcfg, start_batch=3)
    assert step == NB

    # uninterrupted at the target count, the same per-batch call pattern
    # (the walk key splits once per call)
    r2 = _engine(D_load)
    for b in batches[:-1]:
        r2.replay_device([b], wcfg)
    rs, rw, _ = r2.replay_device([batches[-1]], wcfg)
    assert torch.equal(e2.key, r2.key)
    assert _edge_multiset(e2.state) == _edge_multiset(r2.state) == edges_ref
    assert _counters(e2.state) == _counters(r2.state)
    for f in rs.replay._fields:
        np.testing.assert_array_equal(getattr(out[-1].replay, f),
                                      getattr(rs.replay, f), err_msg=f)
        np.testing.assert_array_equal(getattr(out[-1].replay, f),
                                      np.asarray(getattr(stats_ref[-1][0], f)),
                                      err_msg=f)
    assert int(out[-1].walk_drops.sum()) == 0


def test_straggler_policy_matches_reference():
    rng = np.random.default_rng(5)
    times = np.concatenate([rng.uniform(0.9, 1.1, 12), [5.0, 6.0, 0.9],
                            rng.uniform(0.9, 1.1, 4), [7.0, 8.0, 9.0, 10.0],
                            rng.uniform(0.9, 1.1, 40), [30.0] * 5])
    for kw in (dict(), dict(threshold=2.0, window=8, max_flags=2)):
        t, j = tft.StragglerPolicy(**kw), jft.StragglerPolicy(**kw)
        got = [t.observe(float(x)) for x in times]
        assert got == [j.observe(float(x)) for x in times]
        assert {"ok", "straggler", "remesh"} <= set(got)


def test_health_snapshot_engine_matches_reference(tmp_path):
    wt, wj = tcfg.WalkConfig(**WALKS), jcfg.WalkConfig(**WALKS)
    t1 = _engine(1)
    j1 = jss.DistributedStreamingEngine(_cfg(jcfg), BS, num_shards=1,
                                        registry=jobs.new_registry())
    t1.replay_device(_batches()[:3], wt)
    j1.replay_device(_batches()[:3], wj)
    got = tobs.health_snapshot(t1.registry, engine=t1)
    want = jobs.health_snapshot(j1.registry, engine=j1)
    assert got["shards"] == want["shards"]
    # four shards: the fresh loads, as the reference reads any engine
    t4 = _engine(4)
    t4.replay_device(_batches()[:3], wt)
    loads = t4.shard_loads()
    got = tobs.health_snapshot(tobs.new_registry(), engine=t4)
    want = jobs.health_snapshot(jobs.new_registry(), engine=t4)
    assert got["shards"] == want["shards"]
    assert got["shards"]["edges_active"] == {str(d): int(v)
                                             for d, v in enumerate(loads)}
    # the supervisor's periodic dumps validate and carry the loads
    sup = tft.StreamSupervisor(str(tmp_path), save_every=100,
                               health_every=1, registry=t4.registry)
    sup.run(t4, _batches()[3:], wt)
    dumps = sorted(os.listdir(sup.health_dir))
    assert dumps == ["health_000001.json", "health_000002.json"]
    doc = json.load(open(os.path.join(sup.health_dir, dumps[-1])))
    tobs.validate_health(doc)
    assert doc["shards"]["edges_active"] == {
        str(d): int(v) for d, v in enumerate(t4.shard_loads())}


def test_restore_refusals_match_reference(tmp_path):
    eng = _engine(2)
    eng.replay_device(_batches()[:1], tcfg.WalkConfig(**WALKS))
    tck.save_sharded_window(str(tmp_path), eng.state, eng.placement, 1)
    with pytest.raises(ValueError) as want:
        jck.restore_sharded_window(
            str(tmp_path), placement=jp.make_placement("range", 2, N + 1))
    with pytest.raises(ValueError) as got:
        tck.restore_sharded_window(
            str(tmp_path), placement=tp.make_placement("range", 2, N + 1),
            devices=POOL)
    assert str(got.value) == str(want.value)
    # no walk key was saved
    assert tck.restore_sharded_window(str(tmp_path), devices=POOL)[2] is None
    # a target of another shape is refused by the leaf reader
    with pytest.raises(ValueError, match="checkpoint shape"):
        tck.restore(str(tmp_path), {"state": tck._stacked_target(
            3, 4096, N, 5000)})
    with pytest.raises(KeyError, match="walk_key"):
        tck.restore(str(tmp_path), {"walk_key": torch.empty(2)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tck.restore_sharded_window(str(tmp_path))
