"""Per-lane walk batches of the port against the JAX reference.

* The per-lane RNG: ``fold_in_lanes``/``uniform_lanes`` bitwise against
  ``jax.vmap(jax.random.fold_in)`` and ``jax.random.uniform(k, ())``, over
  request and walk ids at 0, negative and the int32 extremes.
* ``generate_walk_lanes`` byte-identical to the reference's for one
  packed batch (fed to the port through ``interop.lanes_from_ref``), on
  {fullwalk, grouped, fused} × {bucket, lexsort} × {nodes, edges}, with
  mixed bias codes, per-lane ``max_len``, inactive padding lanes, start
  nodes −1 and ≥ node capacity, and on an empty window. The reference's
  fused path runs its Pallas kernel in interpret mode.
* ``generate_walks(..., buffers=)`` / ``generate_walks_donated`` equal a
  call without buffers and write the buffers they were given.
* The capability matrix: every combination the reference refuses is
  refused with its message; what it runs the port runs, except sharded
  walks, which raise ``NotImplementedError``.
* ``StreamingEngine``'s host loop (``replay``, ``sample_walks``,
  ``sample_walks_donated``): the reference engine's walks, window counts
  and registry counters.
"""
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core import walk_engine as jwe
from repro.core.edge_store import store_from_arrays as j_store_from_arrays
from repro.core.temporal_index import build_index as j_build_index
from repro.data.synthetic import powerlaw_temporal_graph
from repro_torch import interop
from repro_torch import random as prng
from repro_torch.configs import base as tcfg
from repro_torch.core import walk_engine as twe
from repro_torch.core.edge_store import store_from_arrays
from repro_torch.core.temporal_index import build_index

N, E = 128, 2048
W, L = 64, 8
TILES = dict(tile_walks=64, tile_edges=256)
I32_EDGES = (0, 1, -1, -7, (1 << 31) - 1, -(1 << 31), 123456789)


@pytest.fixture(scope="module")
def graph():
    g = powerlaw_temporal_graph(N - 8, E - 200, seed=5, t_max=4000)
    return g.src, g.dst, g.ts


def _indexes(graph, empty=False):
    src, dst, ts = (x[:0] for x in graph) if empty else graph
    j = j_build_index(j_store_from_arrays(src, dst, ts, edge_capacity=E,
                                          node_capacity=N), N)
    t = build_index(store_from_arrays(src, dst, ts, E, N, device="cpu"), N)
    return j, t


@pytest.fixture(scope="module")
def indexes(graph):
    return _indexes(graph)


@pytest.fixture(scope="module")
def empty_indexes(graph):
    return _indexes(graph, empty=True)


def _ref_lanes(seed=0):
    """A packed batch as the coalescer lays it out: 52 live lanes of
    mixed codes, lengths and seeds, start nodes out of range on two of
    them, then 12 inactive padding lanes."""
    rng = np.random.default_rng(seed)
    live = 52
    start = rng.integers(0, N, W).astype(np.int32)
    start[3], start[9] = -1, N + 5
    active = np.arange(W) < live
    rid = np.repeat(np.asarray(I32_EDGES + (42,), np.int32), 8)[:W]
    wid = (np.arange(W) % 8).astype(np.int32)
    return jwe.LaneParams(
        start_node=jax.numpy.asarray(np.where(active, start, 0)),
        bias=jax.numpy.asarray(rng.integers(0, 3, W).astype(np.int32)),
        start_bias=jax.numpy.asarray(rng.integers(0, 3, W).astype(np.int32)),
        max_len=jax.numpy.asarray(np.where(
            active, rng.integers(1, L + 1, W), 0).astype(np.int32)),
        rid=jax.numpy.asarray(np.where(active, rid, 0)),
        wid=jax.numpy.asarray(np.where(active, wid, 0)),
        active=jax.numpy.asarray(active),
        n2v_p=jax.numpy.ones(W, np.float32),
        n2v_q=jax.numpy.ones(W, np.float32))


def _assert_same(ref, got):
    for f in ("nodes", "times", "lengths"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# Per-lane RNG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, -3, (1 << 31) - 1])
def test_lane_keys_and_uniforms_bitwise(seed):
    rid, wid = (np.asarray(x, np.int32) for x in zip(
        *itertools.product(I32_EDGES, I32_EDGES)))
    key = jax.random.PRNGKey(seed)
    jk = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, rid)
    jk = jax.vmap(jax.random.fold_in)(jk, wid)
    lanes = twe.LaneParams(*(torch.from_numpy(x) for x in (
        rid, rid, rid, rid, rid, wid, rid > 0)))
    tk = twe._lane_keys(interop.key_from_words(key), lanes)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk, np.int64))
    # every hop's draws at once, as generate_walk_lanes takes them
    all_tags = twe._lane_uniform(tk, torch.arange(12)[:, None])
    for tag in range(0, 12):
        ju = jax.vmap(lambda k: jax.random.uniform(k, ()))(
            jax.vmap(jax.random.fold_in, in_axes=(0, None))(jk, tag))
        for tu in (twe._lane_uniform(tk, tag), all_tags[tag]):
            np.testing.assert_array_equal(tu.numpy().view(np.int32),
                                          np.asarray(ju).view(np.int32),
                                          err_msg=f"tag {tag}")


def test_fold_in_lanes_takes_one_key_or_many():
    key = prng.PRNGKey(3)
    data = torch.tensor([0, 5, -1], dtype=torch.int32)
    many = prng.fold_in_lanes(key, data)
    for i, d in enumerate(data.tolist()):
        np.testing.assert_array_equal(many[i].numpy(),
                                      prng.fold_in(key, d).numpy())
    again = prng.fold_in_lanes(many, 9)
    np.testing.assert_array_equal(again[1].numpy(),
                                  prng.fold_in(many[1], 9).numpy())


# ---------------------------------------------------------------------------
# generate_walk_lanes against the reference
# ---------------------------------------------------------------------------


def _lane_walks(j_idx, t_idx, path, regroup, start_mode, seed=0):
    key = jax.random.PRNGKey(seed)
    lanes = _ref_lanes(seed)
    wcfg = dict(num_walks=W, max_length=L, start_mode=start_mode)
    sched = dict(path=path, regroup=regroup, **TILES)
    ref = jwe.generate_walk_lanes(
        j_idx, key, lanes, jcfg.WalkConfig(**wcfg),
        jcfg.SamplerConfig(mode="index"), jcfg.SchedulerConfig(**sched))
    got = twe.generate_walk_lanes(
        t_idx, interop.key_from_words(key),
        interop.lanes_from_ref(lanes, device="cpu"),
        tcfg.WalkConfig(**wcfg), tcfg.SamplerConfig(mode="index"),
        tcfg.SchedulerConfig(**sched))
    return ref, got, lanes


@pytest.mark.parametrize("start_mode", ["nodes", "edges"])
@pytest.mark.parametrize("regroup", ["bucket", "lexsort"])
@pytest.mark.parametrize("path", ["fullwalk", "grouped", "fused"])
def test_walk_lanes_match_reference(indexes, path, regroup, start_mode):
    ref, got, lanes = _lane_walks(*indexes, path, regroup, start_mode)
    _assert_same(ref, got)
    lengths = got.lengths.numpy()
    active = np.asarray(lanes.active)
    assert (lengths[~active] == 0).all()          # padding stays dead
    assert (lengths[active] > 2).any()            # and real lanes walked
    # no lane writes past its own budget (edges emitted <= max_len)
    assert (lengths <= np.asarray(lanes.max_len) + 1).all()
    if start_mode == "nodes":
        assert lengths[3] == 0 and lengths[9] == 0   # start −1 and ≥ N


@pytest.mark.parametrize("start_mode", ["nodes", "edges"])
@pytest.mark.parametrize("path", ["grouped", "fused"])
def test_walk_lanes_on_empty_window(empty_indexes, path, start_mode):
    ref, got, _ = _lane_walks(*empty_indexes, path, "bucket", start_mode)
    _assert_same(ref, got)
    assert (got.lengths.numpy() == 0).all()


def test_walk_lanes_do_not_depend_on_the_batch(indexes):
    """A lane's walk is a function of (seed, rid, wid) alone: the same
    lanes reversed in the batch give the same rows, reversed."""
    _, t_idx = indexes
    lanes = interop.lanes_from_ref(_ref_lanes(1), device="cpu")
    flipped = twe.LaneParams(*(x.flip(0) for x in lanes))
    args = (tcfg.WalkConfig(num_walks=W, max_length=L),
            tcfg.SamplerConfig(mode="index"),
            tcfg.SchedulerConfig(path="fused", **TILES))
    key = prng.PRNGKey(4)
    a = twe.generate_walk_lanes(t_idx, key, lanes, *args)
    b = twe.generate_walk_lanes(t_idx, key, flipped, *args)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y.flip(0))


def test_walk_lanes_refuse_bad_shapes(indexes):
    _, t_idx = indexes
    lanes = interop.lanes_from_ref(_ref_lanes(), device="cpu")
    sc = tcfg.SamplerConfig(mode="index")
    key = prng.PRNGKey(0)
    with pytest.raises(ValueError, match="lane arrays have 64 lanes"):
        twe.generate_walk_lanes(t_idx, key, lanes,
                                tcfg.WalkConfig(num_walks=32), sc,
                                tcfg.SchedulerConfig(path="grouped"))
    with pytest.raises(ValueError, match="start_mode 'nodes'\\|'edges'"):
        twe.generate_walk_lanes(
            t_idx, key, lanes,
            tcfg.WalkConfig(num_walks=W, start_mode="all_nodes"), sc,
            tcfg.SchedulerConfig(path="grouped"))


# ---------------------------------------------------------------------------
# Walk buffers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start_mode", ["nodes", "edges", "all_nodes"])
def test_buffers_are_written_in_place(indexes, start_mode):
    _, t_idx = indexes
    wcfg = tcfg.WalkConfig(num_walks=128, max_length=L,
                           start_mode=start_mode)
    args = (tcfg.SamplerConfig(mode="index"),
            tcfg.SchedulerConfig(path="fused", **TILES))
    key = prng.PRNGKey(2)
    plain = twe.generate_walks(t_idx, key, wcfg, *args)
    bufs = twe.alloc_walk_buffers(wcfg, device="cpu")
    for b in bufs:
        b.fill_(12345)                 # stale contents must not show
    got = twe.generate_walks(t_idx, key, wcfg, *args, buffers=bufs)
    assert got.nodes is bufs.nodes and got.times is bufs.times
    for x, y in zip(plain[:3], got[:3]):
        assert torch.equal(x, y)
    # steady state: the next round reuses this round's arrays
    again = twe.generate_walks_donated(
        t_idx, key, twe.WalkBuffers(got.nodes, got.times), wcfg, *args)
    assert again.nodes.data_ptr() == bufs.nodes.data_ptr()
    for x, y in zip(plain[:3], again[:3]):
        assert torch.equal(x, y)


def test_bad_buffers_are_refused(indexes):
    _, t_idx = indexes
    wcfg = tcfg.WalkConfig(num_walks=W, max_length=L)
    args = (tcfg.SamplerConfig(mode="index"),
            tcfg.SchedulerConfig(path="grouped"))
    key = prng.PRNGKey(5)
    short = twe.alloc_walk_buffers(
        tcfg.WalkConfig(num_walks=W, max_length=L - 1), device="cpu")
    with pytest.raises(ValueError, match="buffers.nodes"):
        twe.generate_walks(t_idx, key, wcfg, *args, buffers=short)
    bufs = twe.alloc_walk_buffers(wcfg, device="cpu")
    wide = twe.WalkBuffers(bufs.nodes, bufs.times.long())
    with pytest.raises(ValueError, match="buffers.times"):
        twe.generate_walks_donated(t_idx, key, wide, wcfg, *args)


# ---------------------------------------------------------------------------
# Capability matrix
# ---------------------------------------------------------------------------


PATHS = ("fullwalk", "grouped", "tiled", "fused")


def _sweep():
    lane_opts = (None, (False, False), (True, False), (False, True),
                 (True, True))
    for mode, bias, path, lanes, sharded, have_tables, n2v in \
            itertools.product(("index", "weight"),
                              ("uniform", "linear", "exponential", "table"),
                              PATHS, lane_opts, (False, True),
                              (False, True), (1.0, 2.0)):
        yield mode, bias, path, lanes, sharded, have_tables, n2v


def _outcome(check, scfg, path, lanes, sharded, have_tables):
    try:
        check(scfg, path, lanes, sharded=sharded, have_tables=have_tables)
    except ValueError as e:
        return "refused", str(e)
    except NotImplementedError as e:
        return "not yet ported", str(e)
    return "runs", None


def test_capability_matrix_matches_reference():
    """Every combination, the default ``have_tables`` included: the port
    runs or refuses (same message) as the reference does; only sharded
    combinations the reference runs are "not yet ported"."""
    counts = {}
    for mode, bias, path, lanes, sharded, have_tables, n2v in _sweep():
        j_lanes = None if lanes is None else jwe.LaneFeatures(*lanes)
        t_lanes = None if lanes is None else twe.LaneFeatures(*lanes)
        want, want_msg = _outcome(
            jwe.check_capabilities,
            jcfg.SamplerConfig(mode=mode, bias=bias, node2vec_p=n2v),
            path, j_lanes, sharded, have_tables)
        got, got_msg = _outcome(
            twe.check_capabilities,
            tcfg.SamplerConfig(mode=mode, bias=bias, node2vec_p=n2v),
            path, t_lanes, sharded, have_tables)
        combo = (mode, bias, path, lanes, sharded, have_tables, n2v)
        if want == "refused":
            assert (got, got_msg) == (want, want_msg), combo
        else:
            assert got == ("not yet ported" if sharded else "runs"), combo
            if sharded:
                assert "not yet ported" in got_msg
        counts[got] = counts.get(got, 0) + 1
    assert sum(counts.values()) == 2 * 4 * 4 * 5 * 2 * 2 * 2
    assert counts["runs"] > 0 and counts["not yet ported"] > 0
    # the default have_tables is the reference's (False): a table request
    # without tables is refused with the reference's message
    for scfg, lanes in ((dict(bias="table"), None), (dict(), (True, False))):
        with pytest.raises(ValueError) as want:
            jwe.check_capabilities(
                jcfg.SamplerConfig(**scfg), "grouped",
                None if lanes is None else jwe.LaneFeatures(*lanes))
        with pytest.raises(ValueError) as got:
            twe.check_capabilities(
                tcfg.SamplerConfig(**scfg), "grouped",
                None if lanes is None else twe.LaneFeatures(*lanes))
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Host-loop sampling of StreamingEngine
# ---------------------------------------------------------------------------


def test_host_loop_sampling_matches_reference():
    """``replay`` (ingest + sample_walks per batch), then
    ``sample_walks_donated`` twice: the same walks, window counts and
    registry counters as the reference's engine."""
    from repro.core.streaming import StreamingEngine as JEngine
    from repro.data.synthetic import chronological_batches
    from repro.obs.registry import MetricsRegistry as JRegistry
    from repro_torch.core.streaming import StreamingEngine
    from repro_torch.obs.registry import MetricsRegistry
    g = powerlaw_temporal_graph(200, 6000, seed=3, t_max=3000)
    batches = list(chronological_batches(g, 3))
    window = dict(duration=1000.0, edge_capacity=4096, node_capacity=256)
    sched = dict(path="fused", **TILES)
    j = JEngine(jcfg.EngineConfig(
        window=jcfg.WindowConfig(**window),
        sampler=jcfg.SamplerConfig(bias="linear"),
        scheduler=jcfg.SchedulerConfig(**sched)), 2048,
        registry=JRegistry(), probes=False)
    t = StreamingEngine(tcfg.EngineConfig(
        window=tcfg.WindowConfig(**window),
        sampler=tcfg.SamplerConfig(bias="linear"),
        scheduler=tcfg.SchedulerConfig(**sched)), 2048, device="cpu",
        registry=MetricsRegistry())
    walks = {"j": [], "t": []}
    wcfg = dict(num_walks=128, max_length=6)
    j.replay(batches, jcfg.WalkConfig(**wcfg),
             on_batch=lambda e, r: walks["j"].append(r))
    t.replay(batches, tcfg.WalkConfig(**wcfg),
             on_batch=lambda e, r: walks["t"].append(r))
    for name in ("j", "t"):
        eng = j if name == "j" else t
        cfg = jcfg if name == "j" else tcfg
        first = eng.sample_walks_donated(cfg.WalkConfig(**wcfg))
        kept = [np.array(x) for x in first[:3]]
        second = eng.sample_walks_donated(cfg.WalkConfig(**wcfg))
        walks[name] += [kept, second]
    # the second round was written into the first round's arrays
    assert second.nodes.data_ptr() == first.nodes.data_ptr()
    for ref, got in zip(walks["j"], walks["t"]):
        for a, b in zip(ref[:3], got[:3]):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert t.stats.edges_active == j.stats.edges_active
    assert t.stats.walks_valid == j.stats.walks_valid
    assert len(t.stats.ingest_s) == 3 and len(t.stats.sample_s) == 5
    for name, labels in (("walks_dispatched_total", {"path": "host"}),
                         ("walks_dispatched_total", {"path": "donated"}),
                         ("walk_hops_total", {"source": "replay"}),
                         ("stream_edges_ingested_total", {"driver": "host"}),
                         ("drops_total", {"kind": "ingest_late"}),
                         ("window_edges_active", None)):
        assert t.registry.value(name, labels) == j.registry.value(
            name, labels), (name, labels)
