"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without an NVIDIA GPU (and ``nvcc`` to build the
kernels) every test skips. Run on a machine with an H100 from the root of
a checkout:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the port does
not need.) This file imports neither JAX nor the reference package.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import (EngineConfig, SamplerConfig,
                                      SchedulerConfig, WalkConfig,
                                      WindowConfig)
from repro_torch.core.edge_store import store_from_arrays
from repro_torch.core.scheduler import panel_bounds, task_bases, tile_table
from repro_torch.core.streaming import StreamingEngine
from repro_torch.core.temporal_index import build_index
from repro_torch.data.synthetic import (chronological_batches,
                                        powerlaw_temporal_graph)
from repro_torch.kernels import fused_step as kf
from repro_torch.kernels import runtime
from repro_torch.kernels import walk_step as kw
from repro_torch.kernels.weight_prefix import (TOL_U, error_in_u,
                                               weight_prefix,
                                               weight_prefix_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _index(device, N=256, num_edges=15000, E=16384, seed=0):
    g = powerlaw_temporal_graph(N, num_edges, seed=seed)
    return build_index(store_from_arrays(g.src, g.dst, g.ts, E, N,
                                         device=device), N)


def _fused_cases(card):
    """(index, s_node, s_time, u, code, cfg): a power-law graph at the
    default tiles, the same graph at 64-lane tiles with most lanes dead,
    mixed tiles on the boundary graph (both tiers, exact fits, empty
    regions at the store's end), and one-lane tiles there."""
    rng = np.random.default_rng(1)
    W = 2048
    idx = _index(card)
    nodes = np.sort(rng.integers(0, 256, W)).astype(np.int32)
    times = rng.integers(0, 10_000, W).astype(np.int32)
    u = rng.uniform(size=W).astype(np.float32)
    code = rng.integers(0, 3, W).astype(np.int32)
    yield idx, nodes, times, u, code, SchedulerConfig(
        path="fused", tile_walks=256, tile_edges=1024)
    late = np.where(rng.uniform(size=W) < 0.9, 1 << 30, times)
    yield idx, nodes, late.astype(np.int32), u, code, SchedulerConfig(
        path="fused", tile_walks=64, tile_edges=256)
    nodes = np.asarray([0, 0, 3, 3, 1, 2, 3, 5, 4, 5, 5, 7, 5, 5, 6, 7],
                       np.int32)
    times = np.asarray([-1, 30, 305, 400, 0, 203, 299, 515, 410, 499, 531,
                        0, 501, 530, 0, 999], np.int32)
    yield _boundary_index(card), nodes, times, u[:16], code[:16], \
        SchedulerConfig(path="fused", tile_walks=4, tile_edges=8)
    yield _boundary_index(card), nodes, times, u[:16], code[:16], \
        SchedulerConfig(path="fused", tile_walks=1, tile_edges=8)


@pytest.mark.parametrize("mode", ["index", "weight"])
def test_fused_kernels_match_plain(card, mode):
    """One fused_hop launch per call; k/n/dst/ts equal fused_step_plain on
    every lane and ``tiers`` equals tier_split's."""
    tiers = []
    for idx, *lanes, cfg in _fused_cases(card):
        nodes, times, u, code = (torch.as_tensor(x, device=card)
                                 for x in lanes)
        before = runtime.LAUNCHES["fused_hop"]
        got = kf.fused_walk_step(idx, nodes, times, code, u, mode, cfg)
        torch.cuda.synchronize()
        assert runtime.LAUNCHES["fused_hop"] == before + 1
        sp = kf.tier_split(idx, nodes, cfg)
        tiers.append(sp.tiers.tolist())
        tbase = idx.node_tbase[nodes.long()]
        want = kf.fused_step_plain(idx.ns_ts, idx.ns_dst, idx.pexp,
                                   idx.plin, sp.a, sp.b, times, code, u,
                                   tbase, mode=mode)
        for g, w in zip(got[:4], want):
            assert torch.equal(g, w)
        assert torch.equal(got.tiers, sp.tiers)
    assert all(s > 0 and big > 0 for s, big, _ in tiers[:3]), tiers


def _boundary_index(device):
    """The crafted graph of tests/test_tile_boundary.py (E = 64, TE = 8):
    exact-fit regions at the head and at the end of the store, an empty
    region, a small one and an oversize one."""
    degs = {0: 16, 2: 4, 3: 20, 4: 8, 5: 16}
    src, dst, ts = [], [], []
    for j, d in degs.items():
        for i in range(d):
            src.append(j)
            dst.append((j + 1 + i) % 8)
            ts.append(j * 100 + 2 * i)
    return build_index(store_from_arrays(np.asarray(src), np.asarray(dst),
                                         np.asarray(ts), 64, 8,
                                         device=device), 8)


def _walk_step_cases(card):
    rng = np.random.default_rng(3)
    W = 2048
    nodes = np.sort(rng.integers(0, 256, W)).astype(np.int32)
    times = rng.integers(0, 10_000, W).astype(np.int32)
    u = rng.uniform(size=W).astype(np.float32)
    yield _index(card), nodes, times, u, SchedulerConfig(tile_walks=64,
                                                         tile_edges=256)
    nodes = np.asarray([0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 3, 3, 5, 5, 7, 7],
                       np.int32)
    times = np.asarray([-1, 15, 29, 30, 0, 1000, 199, 203, 299, 305, 321,
                        400, 499, 515, 0, 999], np.int32)
    u = rng.uniform(size=16).astype(np.float32)
    u[0], u[12] = 0.0, 0.999999
    yield _boundary_index(card), nodes, times, u, SchedulerConfig(
        tile_walks=4, tile_edges=8)


@pytest.mark.parametrize("mode,bias", [
    ("index", "uniform"), ("index", "linear"), ("index", "exponential"),
    ("weight", "uniform"), ("weight", "linear"), ("weight", "exponential")])
def test_walk_step_kernel_matches_plain(card, mode, bias):
    """walk_step_tiled on the card == walk_step_plain, every lane, on a
    power-law graph with oversize lanes and on the boundary lanes."""
    for idx, nodes, times, u, cfg in _walk_step_cases(card):
        s_node, s_time, su = (torch.as_tensor(x, device=card)
                              for x in (nodes, times, u))
        tiles = tile_table(idx, s_node, cfg)
        lo, hi = panel_bounds(tiles, cfg)
        assert bool(tiles.oversize.any())
        E = idx.edge_capacity
        prefix = idx.plin if (mode, bias) == ("weight", "linear") \
            else idx.pexp
        args = (idx.ns_ts[:E], idx.ns_dst[:E], prefix[:E], prefix[1:E + 1],
                tiles.base_blocks, s_time, lo, hi, su,
                idx.node_tbase[s_node.clamp(0, idx.node_capacity - 1)
                               .long()])
        kwargs = dict(mode=mode, bias=bias, tile_walks=cfg.tile_walks,
                      tile_edges=cfg.tile_edges)
        before = runtime.LAUNCHES["walk_step_tiled"]
        got = kw.walk_step_tiled(*args, **kwargs)
        torch.cuda.synchronize()
        assert runtime.LAUNCHES["walk_step_tiled"] == before + 1
        want = kw.walk_step_plain(*args, **kwargs)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("mode,bias", [
    ("index", "uniform"), ("index", "linear"), ("index", "exponential"),
    ("weight", "uniform"), ("weight", "linear"), ("weight", "exponential")])
def test_walk_step_hop_matches_plain(card, mode, bias):
    """walk_step_hop (one launch, oversize lanes served in the kernel) ==
    walk_step_hop_plain on every lane, on a power-law graph with oversize
    lanes and on the boundary lanes."""
    for idx, nodes, times, u, cfg in _walk_step_cases(card):
        s_node, s_time, su = (torch.as_tensor(x, device=card)
                              for x in (nodes, times, u))
        tiles = tile_table(idx, s_node, cfg)
        assert bool(tiles.oversize.any())
        E = idx.edge_capacity
        prefix = idx.plin if (mode, bias) == ("weight", "linear") \
            else idx.pexp
        args = (idx.ns_ts[:E], idx.ns_dst[:E], prefix,
                task_bases(tiles.a, E, cfg), s_time, tiles.a, tiles.b, su,
                idx.node_tbase[s_node.clamp(0, idx.node_capacity - 1)
                               .long()])
        kwargs = dict(mode=mode, bias=bias, tile_walks=cfg.tile_walks,
                      tile_edges=cfg.tile_edges)
        before = runtime.LAUNCHES["walk_step_tiled"]
        got = kw.walk_step_hop(*args, **kwargs)
        torch.cuda.synchronize()
        assert runtime.LAUNCHES["walk_step_tiled"] == before + 1
        want = kw.walk_step_hop_plain(*args, **kwargs)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_small_replay_paths_agree_on_card(card):
    """Every first-order layout replays the same stream to the same walks
    on the card."""
    g = powerlaw_temporal_graph(512, 1 << 14, seed=5, t_max=100_000)
    batches = list(chronological_batches(g, 3))
    wcfg = WalkConfig(num_walks=512, max_length=12)
    out = []
    for path, regroup in (("fullwalk", "bucket"), ("grouped", "bucket"),
                          ("grouped", "lexsort"), ("tiled", "bucket"),
                          ("tiled", "lexsort"), ("fused", "bucket"),
                          ("fused", "lexsort")):
        cfg = EngineConfig(
            window=WindowConfig(duration=50_000.0, edge_capacity=1 << 13,
                                node_capacity=512),
            sampler=SamplerConfig(bias="exponential", mode="index"),
            scheduler=SchedulerConfig(path=path, regroup=regroup,
                                      tile_walks=64, tile_edges=256))
        out.append(StreamingEngine(cfg, 1 << 13, device=card).replay_device(
            batches, wcfg, return_walks=True))
    for stats, walks, _ in out[1:]:
        for a, b in zip(stats, out[0][0]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(walks[:3], out[0][1][:3]):
            np.testing.assert_array_equal(a, b)


def test_weight_prefix_kernel_matches_plain(card):
    rng = np.random.default_rng(2)
    E = 100_003
    dt = torch.as_tensor(-rng.exponential(3.0, E).astype(np.float32),
                         device=card)
    valid = torch.as_tensor(rng.uniform(size=E) < 0.9, device=card)
    got = weight_prefix(dt, valid)
    want = weight_prefix_plain(dt, valid)
    assert got[0].item() == 0.0
    assert bool((got[1:] >= got[:-1]).all())
    assert error_in_u(got, want) <= TOL_U


@pytest.mark.parametrize("E", [0, 1, 4095, 4097, 8191, 8193, 1 << 22])
def test_weight_prefix_kernel_is_deterministic_and_monotone(card, E):
    """One launch per call; three calls give the same bits; the output is
    non-decreasing and within TOL_U of the plain version, at ragged sizes
    and at 2^22 edges with a long masked tail."""
    rng = np.random.default_rng(E % 1000)
    dt = torch.as_tensor(-rng.uniform(0.0, 87.0, E).astype(np.float32),
                         device=card)
    valid = torch.as_tensor(rng.uniform(size=E) < 0.95, device=card)
    valid[int(E * 0.7):] = False
    before = runtime.LAUNCHES["weight_prefix"]
    runs = [weight_prefix(dt, valid) for _ in range(3)]
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["weight_prefix"] == before + (3 if E else 0)
    for r in runs[1:]:
        assert torch.equal(r.view(torch.int32), runs[0].view(torch.int32))
    got = runs[0]
    assert got.shape == (E + 1,) and got[0].item() == 0.0
    assert bool((got[1:] >= got[:-1]).all())
    assert error_in_u(got, weight_prefix_plain(dt, valid)) <= TOL_U


def test_small_replay_card_equals_cpu(card):
    g = powerlaw_temporal_graph(512, 1 << 14, seed=3, t_max=100_000)
    batches = list(chronological_batches(g, 3))
    cfg = EngineConfig(
        window=WindowConfig(duration=50_000.0, edge_capacity=1 << 13,
                            node_capacity=512),
        sampler=SamplerConfig(bias="linear", mode="index"),
        scheduler=SchedulerConfig(path="fused", tile_walks=64,
                                  tile_edges=256))
    wcfg = WalkConfig(num_walks=512, max_length=12, start_mode="edges")
    out = [StreamingEngine(cfg, 1 << 13, device=d).replay_device(
        batches, wcfg, return_walks=True) for d in ("cuda", "cpu")]
    for a, b in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(out[0][1][:3], out[1][1][:3]):
        np.testing.assert_array_equal(a, b)


def _served(device, queries, max_inflight):
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serve import WalkService
    g = powerlaw_temporal_graph(512, 1 << 14, seed=4, t_max=100_000)
    cfg = EngineConfig(
        window=WindowConfig(duration=50_000.0, edge_capacity=1 << 13,
                            node_capacity=512),
        sampler=SamplerConfig(mode="index"),
        scheduler=SchedulerConfig(path="fused", tile_walks=64,
                                  tile_edges=256))
    svc = WalkService(cfg, ServeConfig(max_inflight=max_inflight),
                      batch_capacity=1 << 13, device=device)
    for b in chronological_batches(g, 3):
        svc.ingest(*b)
    hops = []
    launch = svc._launch_lanes

    def counted(params, wcfg, pin, **kw):
        # a batch runs one hop per column after its start: L in nodes
        # mode, L - 1 in edges mode, with L its length bucket
        hops.append(wcfg.max_length - (wcfg.start_mode == "edges"))
        return launch(params, wcfg, pin, **kw)
    svc._launch_lanes = counted
    runtime.reset_launches()
    tickets = [svc.submit(q, strict=True) for q in queries]
    while svc.pending_count or svc.inflight_count:
        svc.tick()
    return ([svc.poll(t) for t in tickets], sum(hops),
            dict(runtime.LAUNCHES))


def test_served_batches_card_equal_cpu(card):
    """The same traffic served on the card (fused_hop, async ring) and on
    the CPU (plain version): equal results per ticket; the card launched
    fused_hop once per hop of every served batch and nothing else."""
    from repro_torch.serve import WalkQuery
    rng = np.random.default_rng(5)
    biases = ("uniform", "linear", "exponential")
    queries = []
    for i in range(24):
        if i % 3 == 2:
            queries.append(WalkQuery(
                num_walks=int(rng.integers(16, 100)), start_mode="edges",
                bias=biases[i % 3], start_bias=biases[(i + 1) % 3],
                max_length=int(rng.integers(3, 40)), seed=7 * i - 50))
        else:
            queries.append(WalkQuery(
                start_nodes=tuple(int(v) for v in rng.integers(
                    -2, 520, int(rng.integers(1, 64)))),
                bias=biases[i % 3], max_length=int(rng.integers(3, 40)),
                seed=1000 + i))
    got, hops, launches = _served(card, queries, max_inflight=4)
    want, _, _ = _served("cpu", queries, max_inflight=1)
    for g, w in zip(got, want):
        for f in ("nodes", "times", "lengths", "snapshot_version"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
    assert hops > 80
    assert launches == dict(fused_hop=hops, weight_prefix=0,
                            walk_step_tiled=0)


@pytest.mark.parametrize("weight", ["uniform", "linear", "exponential"])
def test_alias_tables_card_equal_cpu(card, weight):
    """Alias tables maintained through a replay with eviction on the card
    equal the CPU's bit for bit (the fixed-order row sums and prefix scan,
    and exp in float64 for the exponential weight), and so do the table
    walks drawn from them; the weight_prefix kernel ran twice a batch."""
    g = powerlaw_temporal_graph(512, 1 << 14, seed=6, t_max=100_000)
    batches = list(chronological_batches(g, 3))
    cfg = EngineConfig(
        window=WindowConfig(duration=50_000.0, edge_capacity=1 << 13,
                            node_capacity=512),
        sampler=SamplerConfig(mode="index", bias="table",
                              table_weight=weight),
        scheduler=SchedulerConfig(path="grouped"))
    wcfg = WalkConfig(num_walks=512, max_length=12)
    out = []
    for d in ("cuda", "cpu"):
        runtime.reset_launches()
        eng = StreamingEngine(cfg, 1 << 13, device=d)
        out.append((eng.replay_device(batches, wcfg, return_walks=True),
                    eng.state.tables, dict(runtime.LAUNCHES)))
    (card_run, card_tab, launches), (cpu_run, cpu_tab, _) = out
    for f in ("thresh", "partner", "ptab", "rebuilt"):
        assert torch.equal(getattr(card_tab, f).cpu(), getattr(cpu_tab, f))
    for a, b in zip(card_run[1][:3], cpu_run[1][:3]):
        np.testing.assert_array_equal(a, b)
    assert launches["weight_prefix"] == 2 * (len(batches) + 1)
    assert launches["fused_hop"] == launches["walk_step_tiled"] == 0


@pytest.mark.parametrize("path", ["fullwalk", "grouped"])
def test_node2vec_walks_card_equal_cpu(card, path):
    """Config node2vec walks (table-biased and closed-form) and
    second-order lanes on the card equal the CPU's."""
    from repro_torch import random as prng
    from repro_torch.core.alias import TableSpec, build_tables
    from repro_torch.core.walk_engine import (LaneParams, generate_walk_lanes,
                                              generate_walks)
    rng = np.random.default_rng(8)
    W = 1024
    lanes = dict(
        start_node=rng.integers(0, 256, W).astype(np.int32),
        bias=rng.integers(0, 4, W).astype(np.int32),
        start_bias=np.zeros(W, np.int32),
        max_len=rng.integers(1, 16, W).astype(np.int32),
        rid=rng.integers(0, 99, W).astype(np.int32),
        wid=(np.arange(W) % 7).astype(np.int32),
        active=np.ones(W, bool),
        n2v_p=rng.choice([1.0, 0.5, 2.0], W).astype(np.float32),
        n2v_q=rng.choice([1.0, 0.25, 4.0], W).astype(np.float32))
    sched = SchedulerConfig(path=path)
    wcfg = WalkConfig(num_walks=W, max_length=16)
    out = []
    for d in ("cuda", "cpu"):
        idx = _index(d)
        tables = build_tables(idx, TableSpec())
        key = prng.PRNGKey(3)
        res = [generate_walks(idx, key, wcfg, SamplerConfig(
            mode="index", bias=bias, node2vec_p=0.5, node2vec_q=2.0), sched,
            tables=tables) for bias in ("table", "exponential")]
        params = LaneParams(**{k: torch.as_tensor(v, device=d)
                               for k, v in lanes.items()})
        res.append(generate_walk_lanes(idx, key, params, wcfg,
                                       SamplerConfig(mode="index"), sched,
                                       tables=tables, second_order=True))
        out.append(res)
    for a, b in zip(*out):
        for f in ("nodes", "times", "lengths"):
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f))


def _sharded_engine(device, D, shard_kw=None):
    from repro_torch.configs.base import ShardConfig
    from repro_torch.distributed.placement import make_placement
    from repro_torch.distributed.streaming_shard import (
        DistributedStreamingEngine)
    from repro_torch.obs.registry import MetricsRegistry
    cfg = EngineConfig(
        window=WindowConfig(duration=50_000.0, edge_capacity=1 << 15,
                            node_capacity=512),
        sampler=SamplerConfig(bias="exponential", mode="index"),
        shard=ShardConfig(**(shard_kw or dict(
            edge_capacity_per_shard=1 << 15, exchange_capacity=1 << 13,
            walk_slots=1024, walk_bucket_capacity=1024))))
    return DistributedStreamingEngine(
        cfg, 1 << 13, num_shards=D, devices=[device] * D,
        placement=make_placement("hash", D, 512), registry=MetricsRegistry())


@pytest.mark.parametrize("D,tight", [(2, False), (4, True)])
def test_sharded_replay_card_equals_cpu(card, D, tight):
    """A small sharded replay, D shards on the card against D on the CPU:
    statistics, walks and per-shard drops equal; ``weight_prefix`` runs
    twice per shard and ingest on the card."""
    g = powerlaw_temporal_graph(512, 1 << 15, seed=2, t_max=100_000)
    batches = list(chronological_batches(g, 4))
    wcfg = WalkConfig(num_walks=1024, max_length=12, start_mode="all_nodes")
    shard_kw = dict(edge_capacity_per_shard=1 << 15, exchange_capacity=256,
                    walk_slots=256, walk_bucket_capacity=64) if tight \
        else None
    out = {}
    for d in ("cuda", "cpu"):
        eng = _sharded_engine(d, D, shard_kw)
        runtime.reset_launches()
        out[d] = eng.replay_device(batches, wcfg)[:2]
        if d == "cuda":
            assert runtime.LAUNCHES["weight_prefix"] == 2 * D * len(batches)
            runtime.reset_launches()
            eng.ingest_batch(*batches[0])
            assert runtime.LAUNCHES["weight_prefix"] == 2 * D
    (cs, cw), (ps, pw) = out["cuda"], out["cpu"]
    for a, b in zip(cs.replay, ps.replay):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(cs.exchange_drops, ps.exchange_drops)
    np.testing.assert_array_equal(cs.walk_drops, ps.walk_drops)
    assert (int(cs.walk_drops.sum()) > 0) == tight
    for a, b in zip(cw[:3], pw[:3]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path", ["fused", "tiled"])
def test_sharded_walks_card_equal_cpu(card, path):
    """``generate_walks_sharded`` with 4 shards on the card launches the
    path's hop kernel once per shard and hop, and equals the CPU run."""
    from repro_torch import random as prng
    from repro_torch.distributed.collectives import ShardGroup
    from repro_torch.distributed.walks import generate_walks_sharded
    wcfg = WalkConfig(num_walks=1024, max_length=10, start_mode="all_nodes")
    sched = SchedulerConfig(path=path, tile_walks=64, tile_edges=256)
    name = "fused_hop" if path == "fused" else "walk_step_tiled"
    out = {}
    for d in ("cuda", "cpu"):
        runtime.reset_launches()
        out[d] = generate_walks_sharded(
            _index(d), prng.PRNGKey(5), wcfg,
            SamplerConfig(bias="linear", mode="index"), sched,
            mesh=ShardGroup([d] * 4))
        if d == "cuda":
            assert runtime.LAUNCHES[name] == 4 * wcfg.max_length
    for f in ("nodes", "times", "lengths"):
        np.testing.assert_array_equal(getattr(out["cuda"], f).cpu().numpy(),
                                      getattr(out["cpu"], f).numpy())


@pytest.mark.parametrize("D,kind", [(2, "hash"), (4, "range")])
def test_sharded_serving_card_equals_cpu(card, D, kind):
    """The same queries through ``WalkService(num_shards=D)`` on the card
    and on the CPU, with batch 4 ingested while serving: equal tickets and
    versions, equal per-shard claims, no drops; each ``begin_ingest``
    launches ``weight_prefix`` twice per shard on the card."""
    from repro_torch.configs.base import ServeConfig, ShardConfig
    from repro_torch.distributed.placement import make_placement
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.serve import WalkQuery, WalkService
    g = powerlaw_temporal_graph(512, 1 << 15, seed=2, t_max=100_000)
    batches = list(chronological_batches(g, 4))
    cfg = EngineConfig(
        window=WindowConfig(duration=50_000.0, edge_capacity=1 << 15,
                            node_capacity=512),
        sampler=SamplerConfig(mode="index"),
        scheduler=SchedulerConfig(path="grouped"),
        shard=ShardConfig(edge_capacity_per_shard=1 << 15,
                          exchange_capacity=1 << 13, walk_slots=2048,
                          walk_bucket_capacity=2048))
    rng = np.random.default_rng(4)
    queries = [WalkQuery(start_nodes=tuple(int(v) for v in rng.integers(
                   0, 512, 16)), bias=b, max_length=12, seed=i)
               for i, b in enumerate(("uniform", "linear", "exponential"))]
    queries += [WalkQuery(num_walks=24, start_mode="edges", bias=b,
                          max_length=9, seed=10 + i)
                for i, b in enumerate(("linear", "exponential"))]
    out = {}
    for d in ("cuda", "cpu"):
        svc = WalkService(cfg, ServeConfig(), batch_capacity=1 << 13,
                          num_shards=D, device=d,
                          placement=make_placement(kind, D, 512),
                          registry=MetricsRegistry())
        for b in batches[:3]:
            svc.ingest(*b)
        first = [svc.submit(q) for q in queries]
        svc.tick()
        runtime.reset_launches()
        svc.begin_ingest(*batches[3])
        if d == "cuda":
            assert runtime.LAUNCHES["weight_prefix"] == 2 * D
        svc.publish()
        second = [svc.submit(q) for q in queries]
        svc.pump(block=True)
        while svc.pending_count:
            svc.step()
        out[d] = ([svc.poll(t) for t in first + second],
                  dict(svc.stats.lanes_by_shard))
        assert svc.stats.shard_walk_drops == svc.stats.exchange_drops == 0
    assert out["cuda"][1] == out["cpu"][1]
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        assert a.snapshot_version == b.snapshot_version
        for f in ("nodes", "times", "lengths"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_sharded_checkpoint_round_trip_from_card(card, tmp_path):
    """A sharded window checkpointed from the card restores on the card
    byte-equal and equal to its CPU restore; an elastic restore 4 → 2 on
    the card equals the same restore on the CPU, and the restored engine
    replays on as the CPU one does."""
    from repro_torch.distributed.fault_tolerance import WindowCheckpointer
    from repro_torch.train import checkpoint as ckpt
    g = powerlaw_temporal_graph(512, 1 << 15, seed=2, t_max=100_000)
    batches = list(chronological_batches(g, 4))
    wcfg = WalkConfig(num_walks=1024, max_length=12, start_mode="all_nodes")
    eng = _sharded_engine("cuda", 4)
    eng.replay_device(batches[:2], wcfg)
    saver = WindowCheckpointer(str(tmp_path))
    saver.save(eng, 2)
    restored = {d: ckpt.restore_sharded_window(saver.window_dir,
                                               devices=[d] * 4)
                for d in ("cuda", "cpu")}
    for state, _, key in restored.values():
        assert torch.equal(key, eng.key)
        for a, b in zip(ckpt._flatten_with_paths(state),
                        ckpt._flatten_with_paths(eng.state)):
            assert torch.equal(a[1].cpu(), b[1].cpu()), a[0]
    runs = {}
    for d in ("cuda", "cpu"):
        e2 = saver.restore_engine(eng.cfg, 1 << 13, num_shards=2,
                                  devices=[d] * 4)
        assert e2.num_shards == 2 and e2.home.type == d
        runs[d] = e2.replay_device(batches[2:], wcfg)[:2]
    (cs, cw), (ps, pw) = runs["cuda"], runs["cpu"]
    for a, b in zip(cs.replay, ps.replay):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(cw[:3], pw[:3]):
        np.testing.assert_array_equal(a, b)


# tables and losses: card vs CPU, as the CPU is held to the reference
# (tests/test_torch_train.py)
TRAIN_RTOL, TRAIN_ATOL = 1e-5, 1e-7


def _train_walks(device):
    """Three walk batches of a small stream on ``device`` (fused path)."""
    g = powerlaw_temporal_graph(512, 1 << 15, seed=2, t_max=100_000)
    eng = StreamingEngine(EngineConfig(
        window=WindowConfig(duration=50_000.0, edge_capacity=1 << 14,
                            node_capacity=512),
        scheduler=SchedulerConfig(path="fused", tile_walks=64,
                                  tile_edges=256)), 1 << 13, device=device)
    walks = []
    for bs, bd, bt in list(chronological_batches(g, 4))[:3]:
        eng.ingest_batch(bs, bd, bt)
        walks.append(eng.sample_walks(WalkConfig(num_walks=1024,
                                                 max_length=16)))
    return g, walks


def test_skipgram_step_card_equals_cpu(card):
    """Negatives bitwise; loss and tables within the training tolerance;
    unread rows unchanged; two card runs bitwise equal."""
    from repro_torch import random as prng
    from repro_torch.train import embeddings as emb
    rng = np.random.default_rng(5)
    c = torch.from_numpy(rng.integers(0, 512, 4096).astype(np.int32))
    x = torch.from_numpy(rng.integers(0, 512, 4096).astype(np.int32))
    init = emb.init_skipgram(1 << 14, 16, prng.PRNGKey(1), device="cpu")
    init = emb.SkipgramState(init.emb_in, init.emb_in.flip(0) * 0.5)
    out = {}
    for run, dev in (("cpu", "cpu"), ("cuda", card), ("cuda2", card)):
        state = emb.SkipgramState(*(t.clone().to(dev) for t in init))
        key, losses = prng.PRNGKey(3), []
        for _ in range(3):
            key, sub = prng.split(key)
            state, loss = emb.skipgram_step(state, c.to(dev), x.to(dev),
                                            sub)
            losses.append(float(loss))
        negs = prng.randint(sub, (4096, 5), 0, 1 << 14, dev)
        out[run] = (state, losses, negs.cpu())
    assert torch.equal(out["cuda"][2], out["cpu"][2])
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1],
                               rtol=TRAIN_RTOL)
    for a, b, c2, t0 in zip(out["cuda"][0], out["cpu"][0], out["cuda2"][0],
                            init):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
        assert torch.equal(a, c2)
        unread = (b == t0).all(1) & (a.cpu() == t0).all(1)
        assert unread.any()


def test_train_on_walks_card_equals_cpu(card):
    """Walks, pairs and negatives bitwise; losses and tables within the
    training tolerance; the AUC within 1e-3."""
    from repro_torch import random as prng
    from repro_torch.data.walk_dataset import skipgram_pairs
    from repro_torch.train import embeddings as emb
    res = {}
    for dev in ("cuda", "cpu"):
        g, walks = _train_walks(dev)
        state = emb.init_skipgram(512, 16, prng.PRNGKey(1), device="cpu")
        state = emb.SkipgramState(*(t.to(dev) for t in state))
        key, losses, pairs = prng.PRNGKey(2), [], []
        for w in walks:
            key, sub = prng.split(key)
            pairs.append([t.cpu() for t in skipgram_pairs(w.nodes,
                                                          w.lengths)])
            state, loss = emb.train_on_walks(state, w.nodes, w.lengths, sub,
                                             batch_pairs=2048)
            losses.append(loss)
        n_test = int(0.85 * len(g.src))
        auc = emb.link_prediction_auc(state, g.src[n_test:], g.dst[n_test:],
                                      512)
        res[dev] = (walks, pairs, losses, state, auc)
    (cw, cp, cl, cs, ca), (pw, pp, pl, ps, pa) = res["cuda"], res["cpu"]
    for a, b in zip(cw, pw):
        assert torch.equal(a.nodes.cpu(), b.nodes)
    for a, b in zip(cp, pp):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    np.testing.assert_allclose(cl, pl, rtol=TRAIN_RTOL)
    for a, b in zip(cs, ps):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    assert abs(ca - pa) <= 1e-3


def test_apply_updates_int8_card_equals_cpu(card):
    """20 AdamW steps with int8 compression: the residuals (so the codes)
    bitwise; params and moments within 1e-6 of each leaf's largest
    magnitude."""
    from repro_torch.train import optimizer as opt
    rng = np.random.default_rng(7)
    shapes = {"a": (256, 64), "b": (1000,)}
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=40,
                          compression="int8")
    p0 = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for k, s in shapes.items()}
    grads = [{k: torch.from_numpy((0.3 * rng.normal(size=s))
                                  .astype(np.float32))
              for k, s in shapes.items()} for _ in range(20)]
    out = {}
    for dev in ("cuda", "cpu"):
        p = {k: v.to(dev) for k, v in p0.items()}
        st = opt.init_opt_state(p, cfg)
        for g in grads:
            p, st, _ = opt.apply_updates(p, {k: v.to(dev)
                                             for k, v in g.items()}, st, cfg)
        out[dev] = (p, st)
    (cp, cs), (pp, ps) = out["cuda"], out["cpu"]
    for k in shapes:
        assert torch.equal(cs.error[k].cpu(), ps.error[k]), k
        for a, b in ((cp[k], pp[k]), (cs.mu[k], ps.mu[k]),
                     (cs.nu[k], ps.nu[k])):
            gap = (a.cpu() - b).abs().max()
            assert gap <= 1e-6 * b.abs().max(), k


def _lm(arch, device, **kw):
    """A reduced LM of ``arch`` (``configs.reduced``) drawn on the CPU and
    carried to ``device``, with a numpy batch."""
    import dataclasses
    from repro_torch import random as prng
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    cfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    host = M.init_params(cfg, prng.PRNGKey(0), "cpu")
    model = M.TransformerLM(cfg, None, device)
    M.bind_params(model, {n: t.to(device)
                          for n, t in M.params_of(host).items()})
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32))
                                 .astype(np.int32)).to(device)
             for k in ("tokens", "labels")}
    return model, batch


def test_lm_train_bf16_remat_on_card(card):
    """``lm_train_full``'s small case: bf16 compute from float32 masters,
    remat per block, 6 AdamW steps on one batch: finite, the loss falls,
    the masters stay float32."""
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step
    model, batch = _lm("olmo-1b", card, dtype="bfloat16", remat="block")
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=6)
    step = make_train_step(model, cfg)
    p = M.params_of(model)
    o = init_opt_state(p, cfg)
    losses = []
    for _ in range(6):
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(t.dtype == torch.float32
               and t.device.type == torch.device(card).type
               for t in p.values())


def test_lm_decode_bf16_makes_no_host_sync(card):
    """``lm_serve_full``'s small case: a served bf16 model decodes with no
    host sync, the position on the card; the prompt's last decode logits
    are the prefill's within bf16 rounding."""
    from repro_torch.models import model as M
    from repro_torch.train.train_loop import (make_prefill_step,
                                              make_serve_step)
    model, batch = _lm("qwen2-0.5b", card, dtype="bfloat16")
    M.cast_for_serving(model)
    p = M.params_of(model)
    toks = batch["tokens"]
    pre = make_prefill_step(model)(p, {"tokens": toks})
    state = M.init_decode_state(model, 2, 48)
    with torch.no_grad():
        for t in range(toks.shape[1]):
            lg, state = M.decode_step(model, toks[:, t:t + 1], state)
    assert (lg.float() - pre.float()).abs().max() <= 0.1
    serve = make_serve_step(model)
    tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(8):
            tok, state = serve(p, tok, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(state.pos) == toks.shape[1] + 8


def test_lm_card_equals_cpu(card):
    """``lm_cuda_equals_cpu``'s small case: reduced qwen2-0.5b in float32,
    TF32 off: loss rtol 1e-5, gradients within 1e-4 of each leaf's
    largest magnitude, 8 decode steps' logits within 1e-4 of the largest,
    the same greedy tokens."""
    from repro_torch.models import model as M
    from repro_torch.train.train_loop import make_serve_step
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = {}
        for dev in ("cuda", "cpu"):
            model, batch = _lm("qwen2-0.5b", dev)
            loss = M.loss_fn(model, batch)
            names = [n for n, _ in model.named_parameters()]
            grads = torch.autograd.grad(loss, list(model.parameters()))
            state = M.init_decode_state(model, 2, 16)
            logits = []
            with torch.no_grad():
                for t in range(8):
                    lg, state = M.decode_step(
                        model, batch["tokens"][:, t:t + 1], state)
                    logits.append(lg.cpu())
            serve, tok, gen = make_serve_step(model), lg[:, -1].argmax(-1) \
                .to(torch.int32)[:, None], []
            for _ in range(4):
                tok, state = serve(M.params_of(model), tok, state)
                gen.append(tok.cpu())
            runs[dev] = (float(loss), dict(zip(names, grads)),
                         torch.cat(logits), torch.cat(gen, 1))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (cl, cg, clg, cgen), (hl, hg, hlg, hgen) = runs["cuda"], runs["cpu"]
    assert abs(cl - hl) <= 1e-5 * abs(hl)
    for n, g in hg.items():
        assert (cg[n].cpu() - g).abs().max() <= 1e-4 * g.abs().max(), n
    assert (clg - hlg).abs().max() <= 1e-4 * hlg.abs().max()
    assert torch.equal(cgen, hgen)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "arctic-480b"])
def test_moe_layer_card_equals_cpu(card, arch):
    """An MoE layer of reduced ``arch`` in float32, TF32 off, at
    ``num_groups`` 1 and 4: the routing integers equal (a token whose CPU
    gap between its k-th and (k+1)-th probability is below 1e-5 may
    route apart; the check then holds the other tokens' experts and
    skips the ranks), output and aux within 1e-5, input and leaf
    gradients within 1e-4 of each leaf's largest."""
    import dataclasses
    from repro_torch import random as prng
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.moe import MoE, routing_margin
    cfg = reduced(get_config(arch))
    host = MoE(prng.PRNGKey(2), cfg, cfg.moe, "cpu")
    dev_moe = MoE(None, cfg, cfg.moe, card)
    with torch.no_grad():
        for (n, p), (_, q) in zip(dev_moe.named_parameters(),
                                  host.named_parameters()):
            p.copy_(q)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for g in (1, 4):
            runs = {}
            for mod, d in ((dev_moe, card), (host, "cpu")):
                xd = x.to(d).requires_grad_()
                _, r, _ = mod.route(xd, g)
                y, aux = mod(xd, g)
                grads = torch.autograd.grad(y.square().sum() + aux,
                                            [xd] + list(mod.parameters()))
                runs[d] = (r, y, aux, grads)
            (rc, yc, ac, gc), (rh, yh, ah, gh) = runs[card], runs["cpu"]
            xg = x.reshape(g, -1, cfg.d_model)
            near = routing_margin(xg @ host.router.detach(),
                                  cfg.moe.top_k) < 1e-5
            both = rc.keep.cpu() & rh.keep
            top_c = torch.where(both, rc.e_idx.cpu(), -1)
            top_h = torch.where(both, rh.e_idx, -1)
            assert torch.equal(top_c[~near], top_h[~near])
            if bool(near.any()):
                continue
            for f in ("e_idx", "r_idx", "keep"):
                assert torch.equal(getattr(rc, f).cpu(), getattr(rh, f)), f
            torch.testing.assert_close(yc.cpu(), yh, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(ac.cpu(), ah, rtol=1e-5, atol=1e-5)
            for a, b in zip(gc, gh):
                assert (a.cpu() - b).abs().max() <= 1e-4 * b.abs().max()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def test_mla_moe_decode_card_equals_cpu_without_host_sync(card):
    """Reduced deepseek-v2 (MLA, shared and routed experts) in float32,
    TF32 off: 8 decode steps' logits within 1e-4 of the largest, card
    against CPU; then a bf16 served copy decodes 8 greedy tokens under
    ``set_sync_debug_mode("error")``."""
    from repro_torch.models import model as M
    from repro_torch.train.train_loop import make_serve_step
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        logits = {}
        for dev in (card, "cpu"):
            model, batch = _lm("deepseek-v2-236b", dev)
            state = M.init_decode_state(model, 2, 16)
            out = []
            with torch.no_grad():
                for t in range(8):
                    lg, state = M.decode_step(
                        model, batch["tokens"][:, t:t + 1], state,
                        num_groups=2)
                    out.append(lg.cpu())
            logits[dev] = torch.cat(out, 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    lc, lh = logits[card], logits["cpu"]
    assert (lc - lh).abs().max() <= 1e-4 * lh.abs().max()
    model, batch = _lm("deepseek-v2-236b", card, dtype="bfloat16")
    M.cast_for_serving(model)
    p = M.params_of(model)
    state = M.init_decode_state(model, 2, 32)
    serve = make_serve_step(model)
    tok = batch["tokens"][:, :1]
    serve(p, tok, state)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(8):
            tok, state = serve(p, tok, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(state.pos) == 9


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_ssm_block_card_equals_cpu(card, kind):
    """A reduced recurrent block (jamba's mamba, xlstm's mLSTM and sLSTM)
    in float32, TF32 off, card against CPU: the forward's output and
    final state (the mLSTM in both forms, 96 tokens: three 32-token
    chunks) within 1e-5 of the largest, then 8 one-token ``decode``
    steps from an 88-token state, each output and state likewise; the
    card's decode makes no host sync and writes its state in place."""
    from repro_torch import random as prng
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import ssm
    cfg = reduced(get_config("jamba-v0.1-52b" if kind == "mamba"
                             else "xlstm-125m"))
    host = ssm.SSM_BLOCKS[kind](prng.PRNGKey(3), cfg, cfg.ssm, "cpu")
    dev_blk = ssm.SSM_BLOCKS[kind](None, cfg, cfg.ssm, card)
    with torch.no_grad():
        for p, q in zip(dev_blk.parameters(), host.parameters()):
            p.copy_(q)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 96, cfg.d_model)).astype(np.float32))
    xc = x.to(card)

    def close(a, b):
        assert (a.cpu() - b).abs().max() <= 1e-5 * b.abs().max()

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            for chunked in ((False, True) if kind == "mlstm" else (False,)):
                kw = {"chunked": chunked} if kind == "mlstm" else {}
                (yc, sc), (yh, sh) = dev_blk(xc, **kw), host(x, **kw)
                close(yc, yh)
                for a, b in zip(sc, sh):
                    close(a, b)
            _, sc = dev_blk(xc[:, :88])
            _, sh = host(x[:, :88])
            ptrs = [t.data_ptr() for t in sc]
            for t in range(88, 92):
                close(dev_blk.decode(xc[:, t:t + 1], sc),
                      host.decode(x[:, t:t + 1], sh))
                for a, b in zip(sc, sh):
                    close(a, b)
            torch.cuda.set_sync_debug_mode("error")
            try:
                ys = [dev_blk.decode(xc[:, t:t + 1], sc)
                      for t in range(92, 96)]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            for t, y in zip(range(92, 96), ys):
                close(y, host.decode(x[:, t:t + 1], sh))
            for a, b in zip(sc, sh):
                close(a, b)
            assert [t.data_ptr() for t in sc] == ptrs
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_ssm_model_decode_bf16_makes_no_host_sync(card, arch):
    """Reduced xlstm-125m and jamba (a mamba layer first, the slot taken
    from its attention layer) served in bf16: 8 greedy steps under
    ``set_sync_debug_mode("error")``."""
    from repro_torch.models import model as M
    from repro_torch.train.train_loop import make_serve_step
    model, batch = _lm(arch, card, dtype="bfloat16")
    M.cast_for_serving(model)
    p = M.params_of(model)
    state = M.init_decode_state(model, 2, 32)
    serve = make_serve_step(model)
    tok = batch["tokens"][:, :1]
    tok, state = serve(p, tok, state)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(8):
            tok, state = serve(p, tok, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(state.pos) == 9


def test_cross_attention_block_card_equals_cpu(card):
    """A reduced seamless-m4t-medium decoder block (self-attention, then
    cross-attention over 16 frames, then its MLP) in float32, TF32 off,
    card against CPU: the output at 1 and 8 query tokens and its
    gradients to the input and to the memory within 1e-5 of the largest;
    then 4 one-token ``decode`` steps over the memory, each output and
    the cache likewise, with no host sync on the card."""
    from repro_torch import random as prng
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as tfm
    from repro_torch.models.attention import decode_slot
    cfg = reduced(get_config("seamless-m4t-medium"))
    spec = tfm.LayerSpec("attn", "dense")
    host = tfm.Block(prng.PRNGKey(3), cfg, spec, "cpu",
                     cross_attention=True)
    dev_blk = tfm.Block(None, cfg, spec, card, cross_attention=True)
    with torch.no_grad():
        for p, q in zip(dev_blk.parameters(), host.parameters()):
            p.copy_(q)
    rng = np.random.default_rng(5)
    enc = torch.from_numpy((0.1 * rng.standard_normal(
        (2, 16, cfg.d_model))).astype(np.float32))

    def close(a, b):
        assert (a.detach().cpu() - b).abs().max() <= 1e-5 * b.abs().max()

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for Sq in (1, 8):
            x = torch.from_numpy(rng.standard_normal(
                (2, Sq, cfg.d_model)).astype(np.float32))
            out = {}
            for name, blk, d in (("card", dev_blk, card),
                                 ("cpu", host, "cpu")):
                xs = x.to(d).requires_grad_()
                es = enc.to(d).requires_grad_()
                y, _ = blk(xs, None, memory=tfm.Memory(es, None))
                out[name] = (y, *torch.autograd.grad(y.square().sum(),
                                                     (xs, es)))
            for a, b in zip(out["card"], out["cpu"]):
                close(a, b)
        caches = {d: tfm.init_layer_cache(cfg, spec, 2, 16, torch.float32,
                                          d) for d in (card, "cpu")}
        x = torch.from_numpy(rng.standard_normal(
            (2, 4, cfg.d_model)).astype(np.float32))
        mem = {d: tfm.Memory(enc.to(d), None) for d in (card, "cpu")}
        xs = {d: x.to(d) for d in (card, "cpu")}
        with torch.no_grad():
            for t in range(4):
                ys = {}
                for d, blk in ((card, dev_blk), ("cpu", host)):
                    pos = torch.tensor(t, dtype=torch.int32, device=d)
                    at = decode_slot(pos, 16, 0)
                    torch.cuda.set_sync_debug_mode(
                        "error" if d is card else 0)
                    try:
                        ys[d] = blk.decode(xs[d][:, t:t + 1], caches[d], at,
                                           None, memory=mem[d])
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                close(ys[card], ys["cpu"])
                for a, b in zip(caches[card], caches["cpu"]):
                    close(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
