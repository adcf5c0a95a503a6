"""The port's scale-out primitives against the JAX reference, in one
process, bitwise.

* The collectives of a ``ShardGroup`` (distributed/collectives.py): the
  one-device ``all_to_all`` is the transpose of the stacked send buffers,
  the reductions equal numpy's, and a group refuses more shards than
  devices.
* ``exchange_by_owner`` equals a numpy model of the reference's rule:
  rank within a bucket in row order, a valid row ranked at or past the
  capacity not sent but counted, receivers seeing each sender's rows
  contiguously in sender order — dropped rows included.
* ``make_distributed_walker`` at D ∈ {1, 2, 4, 8} equals the reference's
  walker at D = 1 (a one-CPU mesh; its walks do not depend on placement).
* ``generate_walks_sharded`` at D ∈ {1, 2, 4} on every path equals the
  concatenation of the reference's ``_generate_walks_impl(index,
  fold_in(key, s), W/D, ..., walk_offset=s·W/D)``; at D = 1
  ``StreamingEngine.sample_walks_sharded`` equals the reference engine's,
  warning included.
* ``ingest(watermark=)`` equals the reference's ``ingest_impl(watermark=)``.
* The sharded refusals (``_check_supported``, ``check_capabilities``)
  equal the reference's; what the reference runs, the port runs.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import base as jcfg
from repro.core import distributed as jdist
from repro.core import streaming as jstreaming
from repro.core.edge_store import make_batch as j_make_batch
from repro.core.edge_store import store_from_arrays as j_store_from_arrays
from repro.core.temporal_index import build_index as j_build_index
from repro.core.walk_engine import _generate_walks_impl as j_walks_impl
from repro.core.window import ingest_impl as j_ingest_impl
from repro.core.window import init_window as j_init_window
from repro.data.synthetic import chronological_batches, powerlaw_temporal_graph
from repro.distributed import streaming_shard as jss
from repro_torch import interop
from repro_torch import random as prng
from repro_torch.configs import base as tcfg
from repro_torch.core import distributed as tdist
from repro_torch.core import streaming as tstreaming
from repro_torch.core.edge_store import make_batch, store_from_arrays
from repro_torch.core.temporal_index import build_index
from repro_torch.core.window import ingest, init_window
from repro_torch.distributed import streaming_shard as tss
from repro_torch.distributed.collectives import ShardGroup, make_group
from repro_torch.distributed.placement import make_placement
from repro_torch.distributed.walks import generate_walks_sharded
from repro_torch.obs import new_registry

TILES = dict(tile_walks=32, tile_edges=256)


def _cpu(D: int) -> ShardGroup:
    return ShardGroup(["cpu"] * D)


# ---------------------------------------------------------------------------
# Collectives and the owner exchange
# ---------------------------------------------------------------------------


def test_collectives_on_one_device():
    g = _cpu(3)
    sends = [torch.arange(24, dtype=torch.int32).reshape(3, 4, 2) + 100 * s
             for s in range(3)]
    got = g.all_to_all(sends)
    for d in range(3):
        want = np.concatenate([sends[s][d].numpy() for s in range(3)])
        np.testing.assert_array_equal(got[d].numpy(), want)
    xs = [torch.tensor(v, dtype=torch.int32) for v in (5, -2, 9)]
    for op, want in ((g.psum, 12), (g.pmax, 9), (g.pmin, -2)):
        out = op(xs)
        assert len(out) == 3 and all(int(o) == want for o in out)
        assert out[0].dtype == torch.int32
    assert g.sub(2).size == 2 and g.one_device
    with pytest.raises(ValueError, match="3 shards > 2 devices"):
        make_group(3, ["cpu", "cpu"])
    assert make_group(0, ["cpu"] * 4).size == 4


def _exchange_model(owners, valids, payloads, fills, D, cap):
    """The reference's exchange rule, one row at a time."""
    recv = [[np.full((D * cap,) + p.shape[1:], f, p.dtype)
             for p, f in zip(payloads[0], fills)] for _ in range(D)]
    fits, drops = [], []
    for s in range(D):
        count = np.zeros(D, np.int64)
        f = np.zeros(len(owners[s]), bool)
        n_drop = 0
        for i, (o, v) in enumerate(zip(owners[s], valids[s])):
            if not v:
                continue
            if count[o] < cap:
                for j, p in enumerate(payloads[s]):
                    recv[o][j][s * cap + count[o]] = p[i]
                f[i] = True
            else:
                n_drop += 1
            count[o] += 1
        fits.append(f)
        drops.append(n_drop)
    return recv, fits, drops


@pytest.mark.parametrize("D,cap,n", [(1, 8, 8), (2, 3, 10), (3, 4, 9),
                                     (4, 16, 12), (8, 2, 20)])
def test_exchange_by_owner_matches_reference_rule(D, cap, n):
    rng = np.random.default_rng(D * 100 + cap)
    owners = [rng.integers(0, D, n).astype(np.int32) for _ in range(D)]
    valids = [rng.random(n) < 0.8 for _ in range(D)]
    payloads = [(rng.integers(0, 1000, n).astype(np.int32),
                 rng.integers(-5, 5, (n, 3)).astype(np.int32))
                for _ in range(D)]
    fills = (-1, 7)
    want_recv, want_fits, want_drops = _exchange_model(
        owners, valids, payloads, fills, D, cap)
    recv, fits, drops = tdist.exchange_by_owner(
        _cpu(D), cap, [torch.as_tensor(o) for o in owners],
        [torch.as_tensor(v) for v in valids],
        [tuple(torch.as_tensor(x) for x in p) for p in payloads], fills)
    for d in range(D):
        for j in range(2):
            np.testing.assert_array_equal(recv[d][j].numpy(),
                                          want_recv[d][j])
        np.testing.assert_array_equal(fits[d].numpy(), want_fits[d])
        assert int(drops[d]) == want_drops[d]
        assert drops[d].dtype == torch.int32
    if cap < n:
        assert sum(want_drops) > 0        # the overflow is exercised


# ---------------------------------------------------------------------------
# The static walker with per-step migration
# ---------------------------------------------------------------------------

N_W, L_W, W_W = 256, 10, 128


@pytest.fixture(scope="module")
def walker_ref():
    g = powerlaw_temporal_graph(N_W, 4000, seed=4)
    rng = np.random.default_rng(0)
    starts = rng.integers(0, N_W, W_W).astype(np.int32)
    times = np.full(W_W, -1, np.int32)
    scfg = jcfg.SamplerConfig(bias="exponential", mode="index")
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    idx, placement = jdist.partition_edges(g.src, g.dst, g.ts, N_W, 1,
                                           edge_capacity_per_shard=8192)
    state = jdist.init_sharded_walks(1, W_W, L_W, starts, times, placement)
    run = jdist.make_distributed_walker(mesh, "data", idx, scfg,
                                        placement=placement,
                                        max_length=L_W, bucket_capacity=W_W)
    out = run(state)
    assert int(np.asarray(out.dropped).sum()) == 0
    return g, starts, times, jdist.gather_walks(out, W_W)


@pytest.mark.parametrize("kind", ["range", "hash"])
@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_distributed_walker_matches_reference(walker_ref, D, kind):
    g, starts, times, want = walker_ref
    group = _cpu(D)
    placement = make_placement(kind, D, N_W)
    idxs, _ = tdist.partition_edges(g.src, g.dst, g.ts, N_W, D,
                                    edge_capacity_per_shard=4096,
                                    placement=placement, mesh=group)
    state = tdist.init_sharded_walks(D, 160, L_W, starts, times, placement,
                                     mesh=group)
    run = tdist.make_distributed_walker(
        group, idxs, tcfg.SamplerConfig(bias="exponential", mode="index"),
        placement=placement, max_length=L_W, bucket_capacity=128)
    out = run(state)
    assert sum(int(x) for x in out.dropped) == 0
    got = tdist.gather_walks(out, W_W)
    for a, b, f in zip(got, want, ("nodes", "times", "lengths")):
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (want[2] > 1).sum() > W_W // 4      # the walks do move


def test_distributed_walker_counts_bucket_overflow():
    """Under-provisioned buckets stop the walks that do not fit and count
    them; the walks that fit are still the reference's prefixes."""
    g = powerlaw_temporal_graph(N_W, 4000, seed=4)
    D = 4
    group = _cpu(D)
    placement = make_placement("range", D, N_W)
    idxs, _ = tdist.partition_edges(g.src, g.dst, g.ts, N_W, D, 4096,
                                    placement=placement, mesh=group)
    starts = np.arange(W_W, dtype=np.int32) % N_W
    state = tdist.init_sharded_walks(D, W_W, L_W, starts,
                                     np.full(W_W, -1, np.int32), placement,
                                     mesh=group)
    run = tdist.make_distributed_walker(
        group, idxs, tcfg.SamplerConfig(), placement=placement,
        max_length=L_W, bucket_capacity=4)
    out = run(state)
    assert sum(int(x) for x in out.dropped) > 0
    with pytest.raises(ValueError, match="start overflow"):
        tdist.init_sharded_walks(D, 2, L_W, starts,
                                 np.full(W_W, -1, np.int32), placement,
                                 mesh=group)


def test_hop_resident_matches_reference(replicated):
    """One resident hop, config bias and per-row bias codes, on rows with
    and without a next hop."""
    j_idx, t_idx = replicated
    rng = np.random.default_rng(3)
    n = 512
    node = rng.integers(0, N_S, n).astype(np.int32)
    time = rng.integers(-10, 2500, n).astype(np.int32)
    alive = rng.random(n) < 0.9
    u = rng.random(n).astype(np.float32)
    code = rng.integers(0, 3, n).astype(np.int32)
    t = [torch.as_tensor(x) for x in (node, time, alive, u)]
    for bias in ("uniform", "linear", "exponential"):
        want = jdist.hop_resident(j_idx, jcfg.SamplerConfig(bias=bias),
                                  node, time, alive, u)
        got = tdist.hop_resident(t_idx, tcfg.SamplerConfig(bias=bias), *t)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = jdist.hop_resident_lanes(j_idx, code, node, time, alive, u)
    got = tdist.hop_resident_lanes(t_idx, torch.as_tensor(code), *t)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < int(got[2].sum()) < n


def test_distributed_walker_drops_arrivals_past_the_last_slot():
    """Eight walks from shards 0 and 2 all hop onto shard 1, whose four
    slots are free: four are placed and four dropped and counted (the
    reference lands them all on the last slot, uncounted: ROADMAP queue 3
    item 7)."""
    D, N, Wd = 3, 6, 4
    group = _cpu(D)
    placement = make_placement("range", D, N)
    src = np.array([0, 1, 4, 5], np.int32)
    dst = np.array([2, 2, 3, 3], np.int32)
    idxs, _ = tdist.partition_edges(src, dst, np.ones(4, np.int32), N, D,
                                    8, placement=placement, mesh=group)
    starts = np.array([0, 0, 1, 1, 4, 4, 5, 5], np.int32)
    state = tdist.init_sharded_walks(D, Wd, 1, starts,
                                     np.zeros(8, np.int32), placement,
                                     mesh=group)
    out = tdist.make_distributed_walker(
        group, idxs, tcfg.SamplerConfig(), placement=placement,
        max_length=1, bucket_capacity=Wd)(state)
    assert [int(x) for x in out.dropped] == [0, 4, 0]
    nodes, _, lengths = tdist.gather_walks(out, 8)
    assert (lengths == 2).sum() == 4 and (lengths == 0).sum() == 4
    assert set(nodes[lengths == 2, 1].tolist()) <= {2, 3}


# ---------------------------------------------------------------------------
# Walk-axis sharding over a replicated index
# ---------------------------------------------------------------------------

N_S, E_S = 128, 2048


@pytest.fixture(scope="module")
def replicated():
    g = powerlaw_temporal_graph(N_S, E_S - 100, seed=7)
    j = j_build_index(j_store_from_arrays(g.src, g.dst, g.ts,
                                          edge_capacity=E_S,
                                          node_capacity=N_S), N_S)
    t = build_index(store_from_arrays(g.src, g.dst, g.ts, E_S, N_S,
                                      device="cpu"), N_S)
    return j, t


@pytest.mark.parametrize("path", ["fullwalk", "grouped", "tiled", "fused"])
@pytest.mark.parametrize("D", [1, 2, 4])
def test_generate_walks_sharded_matches_reference(replicated, D, path):
    j_idx, t_idx = replicated
    W, L = 256, 6
    key = jax.random.PRNGKey(11)
    kw = dict(start_mode="all_nodes", max_length=L)
    scfg = dict(bias="exponential", mode="index")
    sched = dict(path=path, regroup="bucket", **TILES)
    want = [j_walks_impl(j_idx, jax.random.fold_in(key, s),
                         jcfg.WalkConfig(num_walks=W // D, **kw),
                         jcfg.SamplerConfig(**scfg),
                         jcfg.SchedulerConfig(**sched),
                         walk_offset=s * (W // D)) for s in range(D)]
    got = generate_walks_sharded(
        t_idx, interop.key_from_words(key),
        tcfg.WalkConfig(num_walks=W, **kw), tcfg.SamplerConfig(**scfg),
        tcfg.SchedulerConfig(**sched), mesh=_cpu(D))
    assert got.stats is None
    for f in ("nodes", "times", "lengths"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy(),
            np.concatenate([np.asarray(getattr(w, f)) for w in want]),
            err_msg=f)
    # the global all_nodes assignment survives the split
    n0 = got.nodes[:, 0].numpy()
    live = n0 >= 0
    assert live.any()
    np.testing.assert_array_equal(n0[live], (np.arange(W) % N_S)[live])


def test_generate_walks_sharded_refuses_uneven_split(replicated):
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        generate_walks_sharded(
            replicated[1], prng.PRNGKey(0),
            tcfg.WalkConfig(num_walks=256, max_length=4),
            tcfg.SamplerConfig(), tcfg.SchedulerConfig(), mesh=_cpu(3))


def _engine_cfg(pkg):
    return pkg.EngineConfig(
        window=pkg.WindowConfig(duration=2500, edge_capacity=2048,
                                node_capacity=96),
        sampler=pkg.SamplerConfig(bias="exponential", mode="index"),
        scheduler=pkg.SchedulerConfig(path="grouped", regroup="bucket"))


def test_sample_walks_sharded_matches_reference_engine(monkeypatch):
    g = powerlaw_temporal_graph(96, 1500, seed=2)
    j = jstreaming.StreamingEngine(_engine_cfg(jcfg), batch_capacity=1024)
    t = tstreaming.StreamingEngine(_engine_cfg(tcfg), batch_capacity=1024,
                                   device="cpu", registry=new_registry())
    for bs, bd, bt in chronological_batches(g, 2):
        j.ingest_batch(bs, bd, bt)
        t.ingest_batch(bs, bd, bt)
    kw = dict(num_walks=64, max_length=5, start_mode="nodes")
    monkeypatch.setattr(jstreaming, "REPLICATED_INDEX_WARN_BYTES", 0)
    monkeypatch.setattr(tstreaming, "REPLICATED_INDEX_WARN_BYTES", 0)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("walks",))
    with pytest.warns(UserWarning, match="DistributedStreamingEngine"):
        want = j.sample_walks_sharded(jcfg.WalkConfig(**kw), mesh=mesh)
    with pytest.warns(UserWarning, match="DistributedStreamingEngine"):
        got = t.sample_walks_sharded(tcfg.WalkConfig(**kw), mesh=_cpu(1))
    for f in ("nodes", "times", "lengths"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert t.stats.walks_valid[-1] == j.stats.walks_valid[-1]
    assert t.registry.value("walks_dispatched_total",
                            {"path": "sharded"}) == 64
    # the warning is given once
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t.sample_walks_sharded(tcfg.WalkConfig(**kw), mesh=_cpu(2))


# ---------------------------------------------------------------------------
# The watermark hook and the refusals
# ---------------------------------------------------------------------------


def test_ingest_watermark_matches_reference():
    rng = np.random.default_rng(5)
    E, N, B = 512, 32, 128
    j_state = j_init_window(E, N, 300)
    t_state = init_window(E, N, 300, device="cpu")
    for it in range(8):
        n = int(rng.integers(0, B + 1))
        src = rng.integers(0, N, n)
        dst = rng.integers(0, N, n)
        ts = rng.integers(it * 100 - 300, it * 100 + 50, n)
        # a watermark above, at and below the batch's own maximum
        wm = int(ts.max(initial=0)) + int(rng.integers(-200, 400))
        j_state = j_ingest_impl(j_state, j_make_batch(src, dst, ts,
                                                      capacity=B), N,
                                watermark=jax.numpy.int32(wm))
        t_state = ingest(t_state, make_batch(src, dst, ts, capacity=B,
                                             device="cpu"), N,
                         watermark=torch.tensor(wm, dtype=torch.int32))
        for f in ("t_now", "ingested", "late_drops", "overflow_drops"):
            assert int(getattr(t_state, f)) == int(getattr(j_state, f)), f
        for f in ("src", "dst", "ts", "num_edges"):
            np.testing.assert_array_equal(
                getattr(t_state.index.store, f).numpy(),
                np.asarray(getattr(j_state.index.store, f)), err_msg=f)
    assert int(t_state.late_drops) > 0


def _outcome(fn):
    try:
        fn()
    except ValueError as e:
        return "refused", str(e)
    return "runs", None


@pytest.mark.parametrize("start_mode", ["nodes", "edges", "all_nodes"])
@pytest.mark.parametrize("sampler", [
    dict(), dict(mode="weight", bias="linear"), dict(node2vec_q=2.0),
    dict(bias="table")])
def test_check_supported_matches_reference(sampler, start_mode):
    for lanes in (False, True):
        want = _outcome(lambda: jss._check_supported(
            jcfg.WalkConfig(start_mode=start_mode),
            jcfg.SamplerConfig(**sampler), lanes=lanes))
        got = _outcome(lambda: tss._check_supported(
            tcfg.WalkConfig(start_mode=start_mode),
            tcfg.SamplerConfig(**sampler), lanes=lanes))
        assert got == want
