"""The port's probes and exporters (obs/probes.py, obs/export.py) against
the JAX reference's, mirroring tests/test_obs_probes.py.

* A probed ``replay_device`` emits the same bits as an unprobed one (and
  as the reference's), and its probe vector equals the reference's and
  agrees with the replay's own ``ReplayStats``.
* ``replay_probe_update`` and the flushes, slot for slot.
* The exporters' documents validate against the reference's validators,
  and equal registries render the same Prometheus text in both packages.
* ``validate_walks_np`` agrees with the reference's.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import base as jcfg
from repro.core.streaming import StreamingEngine as JStreamingEngine
from repro.core.streaming import replay_scan_probed as j_replay_scan_probed
from repro.core.validation import validate_walks_np as j_validate_walks_np
from repro.core.edge_store import stack_batches as j_stack_batches
from repro.core.window import init_window as j_init_window
from repro.data.synthetic import chronological_batches, powerlaw_temporal_graph
from repro_torch import interop
from repro_torch import obs as tobs
from repro_torch import serve as tserve
from repro_torch.configs import base as tcfg
from repro_torch.core.edge_store import stack_batches
from repro_torch.core.streaming import StreamingEngine, replay_scan_probed
from repro_torch.core.validation import validate_walks_np
from repro_torch.core.window import init_window

N = 96


def _cfg(pkg, **sampler):
    return pkg.EngineConfig(
        window=pkg.WindowConfig(duration=2500, edge_capacity=2048,
                                node_capacity=N),
        sampler=pkg.SamplerConfig(**{"bias": "exponential", "mode": "index",
                                     **sampler}),
        scheduler=pkg.SchedulerConfig(path="grouped", regroup="bucket"))


def _graph():
    return powerlaw_temporal_graph(N, 2000, seed=13)


WCFG = dict(num_walks=128, max_length=8, start_mode="nodes")


def _replay(eng, pkg):
    return eng.replay_device(chronological_batches(_graph(), 4),
                             pkg.WalkConfig(**WCFG), return_walks=True)


@pytest.mark.parametrize("sampler", [
    dict(), dict(bias="table", table_weight="uniform")])
def test_probed_replay_bit_identical(sampler):
    """probes on == probes off == the reference: stats, walks, window
    and (table config) alias tables."""
    base = StreamingEngine(_cfg(tcfg, **sampler), 512, device="cpu",
                           registry=tobs.new_registry(), probes=False)
    probed = StreamingEngine(_cfg(tcfg, **sampler), 512, device="cpu",
                             registry=tobs.new_registry(), probes=True)
    ref = JStreamingEngine(_cfg(jcfg, **sampler), 512,
                           registry=jobs.new_registry(), probes=False)
    runs = [_replay(e, pkg) for e, pkg in ((base, tcfg), (probed, tcfg),
                                           (ref, jcfg))]
    for stats, walks, _ in runs[1:]:
        for f in stats._fields:
            np.testing.assert_array_equal(np.asarray(getattr(stats, f)),
                                          getattr(runs[0][0], f), err_msg=f)
        for f in ("nodes", "times", "lengths"):
            np.testing.assert_array_equal(np.asarray(getattr(walks, f)),
                                          getattr(runs[0][1], f), err_msg=f)
    assert torch.equal(base.state.index.store.ts,
                       probed.state.index.store.ts)
    if sampler:
        for f in ("thresh", "partner", "ptab", "rebuilt"):
            want = np.asarray(getattr(ref.state.tables, f))
            for eng in (base, probed):
                np.testing.assert_array_equal(
                    getattr(eng.state.tables, f).numpy(), want, err_msg=f)
    assert runs[0][0].mean_len[-1] > 1.5


def test_probe_counters_agree_with_stats_and_reference():
    """The flushed probe vector reproduces the replay's own cumulative
    accounting, and the registry the reference's probed engine fills."""
    regs = (tobs.new_registry(), jobs.new_registry())
    t = StreamingEngine(_cfg(tcfg, bias="table", table_weight="linear"),
                        512, device="cpu", registry=regs[0])
    j = JStreamingEngine(_cfg(jcfg, bias="table", table_weight="linear"),
                         512, registry=regs[1])
    stats, walks, _ = _replay(t, tcfg)
    _replay(j, jcfg)
    reg = regs[0]
    assert reg.value("stream_edges_ingested_total",
                     labels={"driver": "device"}) == int(stats.ingested[-1])
    assert reg.value("drops_total", labels={"kind": "ingest_late"},
                     default=0) == int(stats.late_drops[-1])
    assert reg.value("drops_total", labels={"kind": "window_overflow"},
                     default=0) == int(stats.overflow_drops[-1])
    assert reg.value("walks_emitted_total",
                     labels={"driver": "device"}) > 0
    assert reg.value("stream_batches_total", {"driver": "device"}) == 4
    final_hops = int(np.maximum(walks.lengths.astype(np.int64) - 1, 0).sum())
    assert reg.value("walk_hops_total", {"source": "replay"}) >= final_hops
    for name, labels in (
            ("stream_batches_total", {"driver": "device"}),
            ("stream_edges_ingested_total", {"driver": "device"}),
            ("walks_emitted_total", {"driver": "device"}),
            ("walk_hops_total", {"source": "replay"}),
            ("drops_total", {"kind": "ingest_late"}),
            ("alias_nodes_rebuilt_total", None),
            ("window_edges_active", None), ("window_t_now", None),
            ("window_occupancy", None)):
        assert regs[0].value(name, labels) == regs[1].value(name, labels), \
            name


def test_probe_vector_matches_reference():
    batches = list(chronological_batches(_graph(), 4))
    key = jax.random.PRNGKey(5)
    wc = dict(num_walks=64, max_length=6)
    j_out = j_replay_scan_probed(
        j_init_window(2048, N, 2500), j_stack_batches(batches, 512), key, N,
        jcfg.WalkConfig(**wc), jcfg.SamplerConfig(mode="index"),
        jcfg.SchedulerConfig())
    t_out = replay_scan_probed(
        init_window(2048, N, 2500, device="cpu"),
        stack_batches(batches, 512, device="cpu"),
        interop.key_from_words(key), N, tcfg.WalkConfig(**wc),
        tcfg.SamplerConfig(mode="index"), tcfg.SchedulerConfig())
    np.testing.assert_array_equal(t_out[3].numpy(), np.asarray(j_out[3]))
    assert t_out[3].dtype == torch.int32
    assert int(t_out[3][tobs.RP_BATCHES]) == 4


def test_probe_update_and_flushes_match_reference():
    rng = np.random.default_rng(0)
    lengths = rng.integers(0, 9, 200).astype(np.int32)
    scal = {k: int(rng.integers(0, 100)) for k in (
        "ingested_delta", "late_delta", "overflow_delta", "exchange_drops",
        "walk_drops")}
    for hops in (None, 17):
        kw = dict(scal, hops=hops)
        jv = jobs.replay_probe_update(
            jobs.replay_probe_zeros(), lengths=jnp.asarray(lengths),
            **{k: None if v is None else jnp.asarray(v, jnp.int32)
               for k, v in kw.items()})
        tv = tobs.replay_probe_update(
            tobs.replay_probe_zeros(), lengths=torch.as_tensor(lengths),
            **{k: None if v is None else torch.tensor(v) for k, v in
               kw.items()})
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    regs = (tobs.new_registry(), jobs.new_registry())
    tobs.flush_replay_probes(regs[0], tv, driver="device")
    jobs.flush_replay_probes(regs[1], np.asarray(jv), driver="device")
    sp = rng.integers(0, 5, (3, tobs.NUM_SERVE_PROBES))
    tobs.flush_serve_probes(regs[0], torch.as_tensor(sp))
    jobs.flush_serve_probes(regs[1], sp)
    assert tobs.to_prometheus(regs[0]) == jobs.to_prometheus(regs[1])
    for bad in (np.zeros(3), np.zeros((2, 2))):
        with pytest.raises(ValueError):
            tobs.flush_replay_probes(regs[0], bad, driver="device")
        with pytest.raises(ValueError):
            tobs.flush_serve_probes(regs[0], bad)
    assert tobs.serve_probe_zeros().shape == (tobs.NUM_SERVE_PROBES,)


def _fill(reg):
    reg.inc("serve_submitted_total", 5, help="queries accepted")
    reg.inc("walks_dispatched_total", 64, labels={"path": "serve"})
    reg.inc("walks_dispatched_total", 8, labels={"path": "solo"})
    reg.set_gauge("window_edges_active", 1234)
    reg.set_gauge("window_occupancy", 0.25)
    for v in (0.002, 0.004, 0.3):
        reg.observe("serve_latency_seconds", v, help="latency")
    reg.inc("drops_total", 2, labels={"kind": "oversize"})


def test_exporters_validate_with_reference(tmp_path):
    regs = (tobs.new_registry(), jobs.new_registry())
    for r in regs:
        _fill(r)
    assert tobs.to_prometheus(regs[0]) == jobs.to_prometheus(regs[1])
    doc = tobs.export_json(regs[0])
    jobs.validate_snapshot(doc)
    want = jobs.export_json(regs[1])
    assert doc["metrics"] == want["metrics"]
    health = tobs.health_snapshot(regs[0])
    jobs.validate_health(health)
    want = jobs.health_snapshot(regs[1])
    for section in ("ingest", "window", "shards", "dispatch", "serving",
                    "drops"):
        assert health[section] == want[section], section
    path = tmp_path / "health.json"
    dumped = tobs.dump_health(str(path), regs[0])
    assert json.loads(path.read_text()) == json.loads(json.dumps(dumped))
    rows = [dict(name="replay", us_per_call=12.5, derived="x=1")]
    bench = tobs.bench_doc("port", rows, config=dict(walks=8),
                           results=dict(ok=True))
    jobs.validate_bench(bench)
    assert bench["config"] == dict(walks=8, backend=tobs.BACKEND)
    for bad in (dict(bench, schema="other/v1"), dict(bench, rows=[{}])):
        with pytest.raises(ValueError, match="schema validation"):
            tobs.validate_bench(bad)
        with pytest.raises(ValueError, match="schema validation"):
            jobs.validate_bench(bad)
    with pytest.raises(ValueError, match="schema validation"):
        tobs.validate_health(dict(health, drops={}))


def test_health_snapshot_reads_a_service():
    svc = tserve.WalkService(_cfg(tcfg), tcfg.ServeConfig(),
                             registry=tobs.new_registry(), device="cpu")
    for b in chronological_batches(_graph(), 2):
        svc.ingest(*b)
    svc.submit(tserve.WalkQuery(start_nodes=(1, 2, 3), max_length=4))
    svc.drain()
    doc = tobs.health_snapshot(svc.registry, service=svc)
    jobs.validate_health(doc)
    assert doc["serving"]["completed"] == 1
    assert doc["serving"]["latency"]["count"] == 1
    assert doc["serving"]["batches"] == 1 and doc["serving"]["queue_depth"] == 0


def test_validate_walks_np_matches_reference():
    g = _graph()
    eng = StreamingEngine(_cfg(tcfg), 2048, device="cpu",
                          registry=tobs.new_registry())
    eng.ingest_batch(g.src, g.dst, g.ts)
    res = eng.sample_walks(tcfg.WalkConfig(**WCFG))
    walks = [x.numpy().copy() for x in (res.nodes, res.times, res.lengths)]
    edges = (g.src, g.dst, g.ts)
    got = validate_walks_np(edges, *walks)
    assert got == j_validate_walks_np(edges, *walks) and got[0] == 1.0
    walks[1][walks[2] > 2, 2] += 1           # break a hop's time
    got = validate_walks_np(edges, *walks)
    assert got == j_validate_walks_np(edges, *walks) and got[0] < 1.0
