"""The port's node-partitioned streaming window
(repro_torch/distributed/streaming_shard.py) against the JAX reference,
in one process, bitwise.

* ``DistributedStreamingEngine.replay_device`` at D ∈ {1, 2, 8} under
  range, hash and skew placement equals the reference's single-device
  ``StreamingEngine.replay_device`` (walks and every ``ReplayStats``
  field), with no drops; so does a group whose shards sit on distinct
  devices, across a reshard.
* At D = 1 it also equals the reference's own ``DistributedStreamingEngine``
  (``num_shards=1``, a one-CPU mesh): ``DistReplayStats``, the window it
  leaves (through ``interop.sharded_window_from_ref``), the probe rows and
  every counter and gauge series of the registry.
* ``ingest_batch``, ``reshard``, ``reshard_host`` and ``rebalance`` at
  D = 1 equal the reference's; a replay across a live reshard 4 → 2 → 8
  and across ``rebalance`` stays equal to the single-device replay;
  the device reshard equals ``reshard_host``.
* An under-provisioned configuration drops and counts; at D = 1 its
  drops and walks equal the reference's, and a port run continued from
  the reference's sharded window equals the reference's continuation.
* The refusals equal the reference's.
* ``slow``: the reference with 8 forced host devices in a subprocess,
  under-provisioned, against the port at D = 2 and D = 8 (per-shard
  ``exchange_drops``/``walk_drops`` and the walks).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import base as jcfg
from repro.core.streaming import StreamingEngine as JStreamingEngine
from repro.data.synthetic import chronological_batches, powerlaw_temporal_graph
from repro.distributed import placement as jp
from repro.distributed import streaming_shard as jss
from repro_torch import interop
from repro_torch import obs as tobs
from repro_torch.configs import base as tcfg
from repro_torch.core.streaming import StreamingEngine
from repro_torch.core.temporal_index import TemporalIndex
from repro_torch.distributed import placement as tp
from repro_torch.distributed import streaming_shard as tss
from repro_torch.distributed.collectives import ShardGroup
from repro_torch.kernels import runtime

ROOT = Path(__file__).resolve().parent.parent
N, EDGES, K, BATCH = 128, 3000, 5, 1024
WALKS = dict(num_walks=256, max_length=8, start_mode="all_nodes")
SHARD = dict(edge_capacity_per_shard=4096, exchange_capacity=1024,
             walk_slots=512, walk_bucket_capacity=512)
# small enough that the exchange and the walk buckets overflow
TIGHT = dict(edge_capacity_per_shard=4096, exchange_capacity=96,
             walk_slots=96, walk_bucket_capacity=24)


def _cfg(pkg, shard=SHARD, **window):
    return pkg.EngineConfig(
        window=pkg.WindowConfig(**{"duration": 3000, "edge_capacity": 4096,
                                   "node_capacity": N, **window}),
        sampler=pkg.SamplerConfig(bias="exponential", mode="index"),
        scheduler=pkg.SchedulerConfig(path="grouped", regroup="bucket"),
        shard=pkg.ShardConfig(**shard))


def _batches():
    return chronological_batches(powerlaw_temporal_graph(N, EDGES, seed=7),
                                 K)


def _engine(D, shard=SHARD, pool=None, **kw):
    return tss.DistributedStreamingEngine(
        _cfg(tcfg, shard), BATCH, num_shards=D,
        devices=["cpu"] * (pool or D), registry=tobs.new_registry(), **kw)


def _j_engine(shard=SHARD, **kw):
    return jss.DistributedStreamingEngine(
        _cfg(jcfg, shard), BATCH, num_shards=1, registry=jobs.new_registry(),
        **kw)


def _assert_walks(got, want, what=""):
    for f in ("nodes", "times", "lengths"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{what} {f}")


def _assert_stats(got, want, what=""):
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{what} {f}")


@pytest.fixture(scope="module")
def single_device():
    """The reference's single-device replay over the whole stream and over
    its two halves."""
    wcfg = jcfg.WalkConfig(**WALKS)
    whole = JStreamingEngine(_cfg(jcfg), batch_capacity=BATCH)
    full = whole.replay_device(_batches(), wcfg, return_walks=True)
    halves = JStreamingEngine(_cfg(jcfg), batch_capacity=BATCH)
    bs = list(_batches())
    first = halves.replay_device(bs[:2], wcfg, return_walks=True)
    second = halves.replay_device(bs[2:], wcfg, return_walks=True)
    third = halves.replay_device(bs[:1], wcfg, return_walks=True)
    return full, (first, second, third)


@pytest.mark.parametrize("kind", ["range", "hash", "skew"])
@pytest.mark.parametrize("D", [1, 2, 8])
def test_replay_matches_single_device_reference(single_device, D, kind):
    (rstats, rwalks, _), _ = single_device
    placement = tp.make_placement(kind, D, N)
    if kind == "skew":
        # a real override table: the hubs of the whole stream, spread
        g = powerlaw_temporal_graph(N, EDGES, seed=7)
        placement = tp.SkewPlacement.from_loads(
            placement, np.bincount(g.src, minlength=N), k=6)
        assert placement.hot_nodes
    eng = _engine(D, placement=placement)
    dstats, dwalks, elapsed = eng.replay_device(_batches(),
                                                tcfg.WalkConfig(**WALKS))
    assert elapsed > 0
    assert dstats.exchange_drops.shape == (K, D)
    assert int(dstats.exchange_drops.sum()) == 0
    assert int(dstats.walk_drops.sum()) == 0
    _assert_stats(dstats.replay, rstats, f"D={D} {kind}")
    _assert_walks(dwalks, rwalks, f"D={D} {kind}")
    loads = eng.shard_loads()
    assert loads.sum() == rstats.edges_active[-1]
    np.testing.assert_array_equal(eng.node_loads().sum(), loads.sum())
    if D > 1:
        assert (loads > 0).sum() > 1      # the window really is split


def test_replay_on_distinct_devices(single_device):
    """Shards on devices that differ (``cpu`` and ``cpu:0`` compare
    unequal) take the copying collectives and the trace reassembly
    PAD + Σ(x − PAD); the replay is the same, also across a reshard."""
    (rstats, rwalks, _), ((s1, w1, _), (s2, w2, _), _) = single_device
    devices = ["cpu", "cpu:0"] * 2
    eng = tss.DistributedStreamingEngine(
        _cfg(tcfg), BATCH, devices=devices, registry=tobs.new_registry(),
        placement=tp.make_placement("hash", 4, N))
    assert not eng.mesh.one_device and eng.num_shards == 4
    bs = list(_batches())
    dstats, dwalks, _ = eng.replay_device(bs[:2], tcfg.WalkConfig(**WALKS))
    _assert_stats(dstats.replay, s1)
    _assert_walks(dwalks, w1)
    eng.reshard_to(tp.make_placement("range", 2, N))
    dstats, dwalks, _ = eng.replay_device(bs[2:], tcfg.WalkConfig(**WALKS))
    _assert_stats(dstats.replay, s2)
    _assert_walks(dwalks, w2)


def _series(reg, skip=("replay_seconds",)):
    out = {}
    for fam in reg.families():
        if fam.kind == "histogram" or fam.name in skip:
            continue
        for key, inst in fam.series.items():
            out[(fam.name, key)] = inst.value
    return out


def _assert_shard_states(got, want):
    """Port ShardedWindowState against the reference's (leaves [D, ...])."""
    ref = interop.sharded_window_from_ref(want, device="cpu")
    assert len(got.window) == len(ref.window)
    for g, r in zip(got.exchange_drops, ref.exchange_drops):
        assert int(g) == int(r)
    for d, (g, r) in enumerate(zip(got.window, ref.window)):
        for f in ("t_now", "window", "ingested", "late_drops",
                  "overflow_drops"):
            assert int(getattr(g, f)) == int(getattr(r, f)), (d, f)
        for f in ("src", "dst", "ts", "num_edges"):
            np.testing.assert_array_equal(
                getattr(g.index.store, f).numpy(),
                getattr(r.index.store, f).numpy(), err_msg=f"{d} {f}")
        for f in TemporalIndex._fields[1:]:
            a, b = getattr(g.index, f).numpy(), getattr(r.index, f).numpy()
            if a.dtype == np.float32:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4,
                                           err_msg=f"{d} {f}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{d} {f}")


def test_one_shard_matches_reference_sharded_engine():
    t, j = _engine(1), _j_engine()
    wt, wj = tcfg.WalkConfig(**WALKS), jcfg.WalkConfig(**WALKS)
    tstats, twalks, _ = t.replay_device(_batches(), wt)
    jstats, jwalks, _ = j.replay_device(_batches(), wj)
    _assert_stats(tstats.replay, jstats.replay)
    np.testing.assert_array_equal(tstats.exchange_drops,
                                  jstats.exchange_drops)
    np.testing.assert_array_equal(tstats.walk_drops, jstats.walk_drops)
    _assert_walks(twalks, jwalks)
    _assert_shard_states(t.state, j.state)
    want, got = _series(j.registry), _series(t.registry)
    assert got == want
    # the per-shard probe rows landed under the shard label
    assert got[("walk_hops_total", (("shard", "0"), ("source", "replay")))] \
        > 0
    assert t.registry.value("stream_batches_total",
                            {"driver": "sharded", "shard": "0"}) == K
    # a second replay continues both engines the same way
    tstats, twalks, _ = t.replay_device(list(_batches())[:2], wt)
    jstats, jwalks, _ = j.replay_device(list(_batches())[:2], wj)
    _assert_stats(tstats.replay, jstats.replay)
    _assert_walks(twalks, jwalks)
    assert _series(t.registry) == _series(j.registry)


def test_ingest_batch_matches_reference():
    t1, j1 = _engine(1), _j_engine()
    t4 = _engine(4)
    single = StreamingEngine(_cfg(tcfg), BATCH, device="cpu",
                             registry=tobs.new_registry())
    for bs, bd, bt in list(_batches())[:3]:
        t1.ingest_batch(bs, bd, bt)
        j1.ingest_batch(bs, bd, bt)
        t4.ingest_batch(bs, bd, bt)
        single.ingest_batch(bs, bd, bt)
    _assert_shard_states(t1.state, j1.state)
    # the four shards partition the single window's store by owner
    st = single.state.index.store
    n = int(st.num_edges)
    owners = t4.placement.owner_np(st.src[:n].numpy())
    for d, w in enumerate(t4.state.window):
        m = int(w.index.store.num_edges)
        sel = owners == d
        assert m == sel.sum()
        for f in ("src", "dst", "ts"):
            np.testing.assert_array_equal(
                getattr(w.index.store, f)[:m].numpy(),
                getattr(st, f)[:n].numpy()[sel])
        assert int(w.t_now) == int(single.state.t_now)
    assert sum(int(w.late_drops) for w in t4.state.window) == \
        int(single.state.late_drops)


def test_reshard_and_rebalance_match_reference_at_one_shard(single_device):
    _, ((s1, w1, _), (s2, w2, _), _) = single_device
    t, j = _engine(1), _j_engine()
    wt, wj = tcfg.WalkConfig(**WALKS), jcfg.WalkConfig(**WALKS)
    bs = list(_batches())
    t.replay_device(bs[:2], wt)
    j.replay_device(bs[:2], wj)
    # the host mirror, from the same state, onto a hash placement
    th = tp.make_placement("hash", 1, N)
    jh = jp.make_placement("hash", 1, N)
    _assert_shard_states(tss.reshard_host(t.state, th, mesh=ShardGroup(
        ["cpu"])), jss.reshard_host(j.state, jh))
    state, mesh = tss.reshard(t.state, t.placement, th,
                              mesh=ShardGroup(["cpu"]))
    jstate, _ = jss.reshard(j.state, j.placement, jh)
    assert mesh.size == 1
    _assert_shard_states(state, jstate)
    # rebalance: the same overrides, the same window, the same replay
    tnew, jnew = t.rebalance(k=4), j.rebalance(k=4)
    assert tnew.describe() == jnew.describe()
    assert t.registry.value("reshards_total") == 1
    _assert_shard_states(t.state, j.state)
    tstats, twalks, _ = t.replay_device(bs[2:], wt)
    jstats, jwalks, _ = j.replay_device(bs[2:], wj)
    _assert_stats(tstats.replay, jstats.replay)
    _assert_walks(twalks, jwalks)
    _assert_stats(tstats.replay, s2)
    _assert_walks(twalks, w2)


def test_reshard_shard_counts_keep_replay_identical(single_device):
    """4 → 2 → 8 shards between replays, on one device: every segment
    equals the single-device replay of the same batches; the device
    reshard equals the host mirror."""
    _, ((s1, w1, _), (s2, w2, _), (s3, w3, _)) = single_device
    eng = _engine(4, pool=8)
    wt = tcfg.WalkConfig(**WALKS)
    bs = list(_batches())
    for segment, (want_s, want_w), D_next in (
            (bs[:2], (s1, w1), 2), (bs[2:], (s2, w2), 8),
            (bs[:1], (s3, w3), None)):
        dstats, dwalks, _ = eng.replay_device(segment, wt)
        _assert_stats(dstats.replay, want_s, f"D={eng.num_shards}")
        _assert_walks(dwalks, want_w, f"D={eng.num_shards}")
        assert int(dstats.walk_drops.sum()) == 0
        if D_next is None:
            break
        new = tp.make_placement("hash" if D_next == 2 else "range",
                                D_next, N)
        host = tss.reshard_host(eng.state, new,
                                mesh=ShardGroup(["cpu"] * D_next))
        before = eng.shard_loads().sum()
        eng.reshard_to(new)
        assert eng.num_shards == D_next == eng.mesh.size
        assert eng.shard_loads().sum() == before
        _assert_shard_pair(eng.state, host)


def _assert_shard_pair(a, b):
    for x, y in zip(a.exchange_drops, b.exchange_drops):
        assert int(x) == int(y)
    for wa, wb in zip(a.window, b.window):
        for f in ("t_now", "window", "ingested", "late_drops",
                  "overflow_drops"):
            assert int(getattr(wa, f)) == int(getattr(wb, f)), f
        for f in TemporalIndex._fields[1:]:
            assert torch.equal(getattr(wa.index, f), getattr(wb.index, f)), f
        for f in wa.index.store._fields:
            assert torch.equal(getattr(wa.index.store, f),
                               getattr(wb.index.store, f)), f


def test_under_provisioned_drops_match_reference():
    """At D = 1 the tight buckets drop in both packages alike; D = 4 drops
    and counts per shard; a port engine started from the reference's
    sharded window continues as the reference does."""
    t, j = _engine(1, shard=TIGHT), _j_engine(shard=TIGHT)
    wt, wj = tcfg.WalkConfig(**WALKS), jcfg.WalkConfig(**WALKS)
    bs = list(_batches())
    tstats, twalks, _ = t.replay_device(bs[:3], wt)
    jstats, jwalks, _ = j.replay_device(bs[:3], wj)
    assert int(jstats.exchange_drops.sum()) > 0
    assert int(jstats.walk_drops.sum()) > 0
    np.testing.assert_array_equal(tstats.exchange_drops,
                                  jstats.exchange_drops)
    np.testing.assert_array_equal(tstats.walk_drops, jstats.walk_drops)
    _assert_stats(tstats.replay, jstats.replay)
    _assert_walks(twalks, jwalks)
    # continue from the reference's window in the port
    cont = _engine(1, shard=TIGHT)
    cont.state = interop.sharded_window_from_ref(j.state, device="cpu")
    cont.key = interop.key_from_words(j.key)
    cstats, cwalks, _ = cont.replay_device(bs[3:], wt)
    jstats, jwalks, _ = j.replay_device(bs[3:], wj)
    np.testing.assert_array_equal(cstats.walk_drops, jstats.walk_drops)
    _assert_stats(cstats.replay, jstats.replay)
    _assert_walks(cwalks, jwalks)
    d4, _, _ = _engine(4, shard=TIGHT).replay_device(bs, wt)
    assert d4.exchange_drops.shape == (K, 4)
    assert int(d4.exchange_drops.sum()) > 0 and int(d4.walk_drops.sum()) > 0


def test_refusals_match_reference():
    def both(j_fn, t_fn):
        with pytest.raises(ValueError) as want:
            j_fn()
        with pytest.raises(ValueError) as got:
            t_fn()
        assert str(got.value) == str(want.value)

    both(lambda: jss.DistributedStreamingEngine(
             _cfg(jcfg), BATCH, num_shards=1,
             placement=jp.make_placement("range", 2, N)),
         lambda: _engine(1, placement=tp.make_placement("range", 2, N)))
    both(lambda: jss.DistributedStreamingEngine(
             _cfg(jcfg), BATCH, num_shards=1,
             placement=jp.make_placement("range", 1, N + 1)),
         lambda: _engine(1, placement=tp.make_placement("range", 1, N + 1)))
    both(lambda: jss.window_mesh(len(jax.devices()) + 1),
         lambda: tss.window_mesh(len(jax.devices()) + 1,
                                 devices=["cpu"] * len(jax.devices())))
    j, t = _j_engine(), _engine(1)
    both(lambda: jss.reshard(j.state, jp.make_placement("range", 2, N),
                             jp.make_placement("range", 1, N)),
         lambda: tss.reshard(t.state, tp.make_placement("range", 2, N),
                             tp.make_placement("range", 1, N),
                             mesh=ShardGroup(["cpu"])))
    both(lambda: jss.reshard(j.state, j.placement,
                             jp.make_placement("range", 1, N + 1)),
         lambda: tss.reshard(t.state, t.placement,
                             tp.make_placement("range", 1, N + 1),
                             mesh=ShardGroup(["cpu"])))
    for wcfg in (dict(WALKS, start_mode="nodes"),
                 dict(WALKS, start_mode="edges")):
        both(lambda: j.replay_device(_batches(), jcfg.WalkConfig(**wcfg)),
             lambda: t.replay_device(_batches(), tcfg.WalkConfig(**wcfg)))
    # more shards than the devices named is refused; without a card and
    # without devices the engine raises instead of running on the CPU
    with pytest.raises(ValueError, match="8 shards > 4 devices"):
        _engine(8, pool=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tss.DistributedStreamingEngine(_cfg(tcfg), BATCH, num_shards=1)


def test_weight_prefix_runs_twice_per_shard_ingest_on_cpu():
    """On CPU tensors the index rebuilds take the plain prefix and count
    no launch (the card test counts 2·D per sharded ingest)."""
    runtime.reset_launches()
    eng = _engine(2)
    eng.ingest_batch(*next(iter(_batches())))
    assert runtime.LAUNCHES["weight_prefix"] == 0
    assert sum(int(w.index.num_edges) for w in eng.state.window) > 0


SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
from repro.configs.base import (EngineConfig, SamplerConfig, SchedulerConfig,
                                ShardConfig, WalkConfig, WindowConfig)
from repro.data.synthetic import chronological_batches, powerlaw_temporal_graph
from repro.distributed.streaming_shard import DistributedStreamingEngine
cfg = EngineConfig(
    window=WindowConfig(duration=3000, edge_capacity=4096, node_capacity=%d),
    sampler=SamplerConfig(bias="exponential", mode="index"),
    scheduler=SchedulerConfig(path="grouped", regroup="bucket"),
    shard=ShardConfig(**%r))
out = {}
for D in (2, 8):
    eng = DistributedStreamingEngine(cfg, batch_capacity=%d, num_shards=D)
    g = powerlaw_temporal_graph(%d, %d, seed=7)
    s, w, _ = eng.replay_device(chronological_batches(g, %d),
                                WalkConfig(**%r))
    out[D] = dict(x=np.asarray(s.exchange_drops).tolist(),
                  w=np.asarray(s.walk_drops).tolist(),
                  nodes=np.asarray(w.nodes).tolist(),
                  times=np.asarray(w.times).tolist(),
                  lengths=np.asarray(w.lengths).tolist())
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.mark.slow      # 8-device reference subprocess
def test_under_provisioned_matches_8_device_reference(tmp_path):
    path = tmp_path / "ref.json"
    code = SCRIPT % (N, TIGHT, BATCH, N, EDGES, K, WALKS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(path.read_text())
    for D in (2, 8):
        want = ref[str(D)]
        stats, walks, _ = _engine(D, shard=TIGHT).replay_device(
            _batches(), tcfg.WalkConfig(**WALKS))
        np.testing.assert_array_equal(stats.exchange_drops, want["x"])
        np.testing.assert_array_equal(stats.walk_drops, want["w"])
        assert np.asarray(want["w"]).sum() > 0
        for f in ("nodes", "times", "lengths"):
            np.testing.assert_array_equal(getattr(walks, f),
                                          np.asarray(want[f]), err_msg=f)
