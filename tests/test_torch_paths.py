"""Every first-order scheduler path of the port vs the JAX reference.

* ``generate_walks`` for path ∈ {fullwalk, grouped, tiled, fused} ×
  regroup ∈ {bucket, lexsort} × the three biases gives ``nodes``,
  ``times`` and ``lengths`` byte-identical to the reference's walks for
  the same key: index mode on the port's own index, weight mode on the
  reference's index brought over by ``interop`` (the prefixes are float
  sums). The tiled path runs the Pallas kernel in interpret mode on the
  reference side and ``walk_step_plain`` on the port's.
* A hub graph whose regions overflow the staged panel (oversize lanes on
  the tiled path, tier L on the fused path), and the three start modes.
* Inside the port, every path × regroup equals ``fullwalk`` (the
  reference's own contract, tests/test_walk_engine.py), with hop validity
  1.0.
* ``dispatch_stats``, ``generate_walks(collect_stats=True).stats`` and
  ``build_task_table`` against the reference.
* The reference's refusals on tiled and fused; ``StreamingEngine`` with
  the default ``SchedulerConfig()`` (grouped, bucket).

The walk times span less than 2^16 ticks, where the bucket regroup's
time-key shift agrees between XLA on the CPU and the port (ROADMAP,
queue 3); the lane order, and with it which lanes are oversize, then
agree too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core import scheduler as j_sched
from repro.core.edge_store import store_from_arrays as j_store_from_arrays
from repro.core.streaming import StreamingEngine as JStreamingEngine
from repro.core.temporal_index import build_index as j_build_index
from repro.core.temporal_index import node_range as j_node_range
from repro.core.walk_engine import check_capabilities as j_check_capabilities
from repro.core.walk_engine import generate_walks as j_generate_walks
from repro.data.synthetic import chronological_batches, powerlaw_temporal_graph
from repro_torch import interop
from repro_torch import random as prng
from repro_torch.configs import base as tcfg
from repro_torch.core.alias import TableSpec, build_tables
from repro_torch.core import scheduler as t_sched
from repro_torch.core.edge_store import store_from_arrays
from repro_torch.core.streaming import StreamingEngine
from repro_torch.core.temporal_index import build_index, node_range
from repro_torch.core.validation import validate_walks
from repro_torch.core.walk_engine import (check_capabilities, generate_walks,
                                          start_walks, _bucket_prologue)

BIASES = ["uniform", "linear", "exponential"]
PATHS = ["fullwalk", "grouped", "tiled", "fused"]
REGROUPS = ["bucket", "lexsort"]
TILES = dict(tile_walks=64, tile_edges=256)
E, N = 2048, 128


def _graph(N, num_edges, seed, skew=1.2):
    g = powerlaw_temporal_graph(N, num_edges, seed=seed, skew=skew)
    return g.src % N, g.dst % N, g.ts


@pytest.fixture(scope="module")
def indexes():
    """(reference index, port-built index, reference index in the port)."""
    src, dst, ts = _graph(N, E - 100, 7)
    j = j_build_index(j_store_from_arrays(src, dst, ts, edge_capacity=E,
                                          node_capacity=N), N)
    t = build_index(store_from_arrays(src, dst, ts, E, N, device="cpu"), N)
    return j, t, interop.index_from_ref(j, device="cpu")


@pytest.fixture(scope="module")
def hub_indexes():
    Nh, Eh = 64, 8192
    src, dst, ts = _graph(Nh, 8000, 3, skew=2.0)
    j = j_build_index(j_store_from_arrays(src, dst, ts, edge_capacity=Eh,
                                          node_capacity=Nh), Nh)
    t = build_index(store_from_arrays(src, dst, ts, Eh, Nh, device="cpu"),
                    Nh)
    return j, t, interop.index_from_ref(j, device="cpu")


def _walks(j_idx, t_idx, seed, wcfg, scfg, sched, collect_stats=False):
    key = jax.random.PRNGKey(seed)
    ref = j_generate_walks(j_idx, key, jcfg.WalkConfig(**wcfg),
                           jcfg.SamplerConfig(**scfg),
                           jcfg.SchedulerConfig(**sched),
                           collect_stats=collect_stats)
    got = generate_walks(t_idx, interop.key_from_words(key),
                         tcfg.WalkConfig(**wcfg), tcfg.SamplerConfig(**scfg),
                         tcfg.SchedulerConfig(**sched),
                         collect_stats=collect_stats)
    return ref, got


def _assert_same_walks(ref, got, what=""):
    for f in ("nodes", "times", "lengths"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f"{what} {f}")


@pytest.mark.parametrize("bias", BIASES)
@pytest.mark.parametrize("regroup", REGROUPS)
@pytest.mark.parametrize("path", PATHS)
def test_index_paths_match_reference(indexes, path, regroup, bias):
    j_idx, t_idx, _ = indexes
    ref, got = _walks(j_idx, t_idx, 0, dict(num_walks=256, max_length=8),
                      dict(bias=bias, mode="index"),
                      dict(path=path, regroup=regroup, **TILES))
    _assert_same_walks(ref, got, f"{path}/{regroup}/{bias}")
    assert int(got.lengths.max()) > 4


@pytest.mark.parametrize("bias", BIASES)
@pytest.mark.parametrize("regroup", REGROUPS)
@pytest.mark.parametrize("path", PATHS)
def test_weight_paths_match_reference(indexes, path, regroup, bias):
    j_idx, _, t_ref = indexes
    ref, got = _walks(j_idx, t_ref, 1, dict(num_walks=256, max_length=8),
                      dict(bias=bias, mode="weight"),
                      dict(path=path, regroup=regroup, **TILES))
    _assert_same_walks(ref, got, f"{path}/{regroup}/{bias}")


@pytest.mark.parametrize("mode,bias", [("index", "exponential"),
                                       ("weight", "linear"),
                                       ("weight", "exponential")])
@pytest.mark.parametrize("regroup", REGROUPS)
def test_hub_graph_tiled_matches_reference(hub_indexes, regroup, mode, bias):
    """Hubs wider than the 2·TE panel: the tiled path's oversize lanes take
    the plain-torch fallback, and the walks still match."""
    j_idx, t_idx, t_ref = hub_indexes
    wcfg = dict(num_walks=256, max_length=8)
    scfg = dict(bias=bias, mode=mode)
    ref, got = _walks(j_idx, t_idx if mode == "index" else t_ref, 2, wcfg,
                      scfg, dict(path="tiled", regroup=regroup, **TILES))
    _assert_same_walks(ref, got, f"hub {regroup}/{mode}/{bias}")
    # the first hop's tiles do hold oversize lanes
    sched = tcfg.SchedulerConfig(path="tiled", **TILES)
    carry = start_walks(t_idx, tcfg.WalkConfig(**wcfg),
                        tcfg.SamplerConfig(**scfg), prng.PRNGKey(0))
    s_node = _bucket_prologue(t_idx, sched, carry)[1]
    assert bool(t_sched.tile_table(t_idx, s_node, sched).oversize.any())


@pytest.mark.parametrize("start_mode", ["nodes", "edges", "all_nodes"])
def test_start_modes_match_reference(indexes, start_mode):
    j_idx, t_idx, t_ref = indexes
    for mode, idx in (("index", t_idx), ("weight", t_ref)):
        ref, got = _walks(j_idx, idx, 3,
                          dict(num_walks=128, max_length=6,
                               start_mode=start_mode),
                          dict(bias="linear", mode=mode,
                               start_bias="exponential"),
                          dict(path="tiled", **TILES))
        _assert_same_walks(ref, got, f"{start_mode}/{mode}")


@pytest.mark.parametrize("regroup", REGROUPS)
@pytest.mark.parametrize("path", PATHS)
def test_paths_agree_with_fullwalk(hub_indexes, path, regroup):
    """The reference's contract inside the port: every layout emits the
    fullwalk walks for the same key, and every hop is causal."""
    _, t_idx, t_ref = hub_indexes
    key = prng.PRNGKey(5)
    wcfg = tcfg.WalkConfig(num_walks=256, max_length=10)
    for mode, bias in (("index", "exponential"), ("index", "linear"),
                       ("weight", "linear"), ("weight", "exponential")):
        idx = t_idx if mode == "index" else t_ref
        scfg = tcfg.SamplerConfig(bias=bias, mode=mode)
        ref = generate_walks(idx, key, wcfg, scfg,
                             tcfg.SchedulerConfig(path="fullwalk"))
        got = generate_walks(idx, key, wcfg, scfg, tcfg.SchedulerConfig(
            path=path, regroup=regroup, **TILES))
        _assert_same_walks(ref, got, f"{path}/{regroup}/{mode}/{bias}")
        rep = validate_walks(idx, got)
        assert rep.num_hops > 0 and rep.hop_valid_frac == 1.0


# ---------------------------------------------------------------------------
# Statistics and the task table
# ---------------------------------------------------------------------------

_COUNT_STATS = [i for i in range(t_sched.NUM_STATS)
                if i not in (t_sched.STAT_BYTES_FULLWALK,
                             t_sched.STAT_BYTES_GROUPED)]
_BYTE_STATS = [t_sched.STAT_BYTES_FULLWALK, t_sched.STAT_BYTES_GROUPED]


def _assert_stats(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got[..., _COUNT_STATS],
                                  want[..., _COUNT_STATS])
    np.testing.assert_allclose(got[..., _BYTE_STATS], want[..., _BYTE_STATS],
                               rtol=1e-6)


@pytest.mark.parametrize("path", PATHS)
def test_collect_stats_matches_reference(hub_indexes, path):
    j_idx, t_idx, _ = hub_indexes
    ref, got = _walks(j_idx, t_idx, 4,
                      dict(num_walks=256, max_length=6, start_mode="edges"),
                      dict(mode="index"), dict(path=path, **TILES),
                      collect_stats=True)
    _assert_same_walks(ref, got, path)
    assert got.stats.shape == (5, t_sched.NUM_STATS)
    _assert_stats(got.stats, ref.stats)
    assert float(got.stats[0, t_sched.STAT_FUSED_BIG]) > 0


@pytest.mark.parametrize("solo,max_task", [(4, 8192), (1, 8), (16, 32)])
def test_dispatch_stats_matches_reference(hub_indexes, solo, max_task):
    j_idx, t_idx, _ = hub_indexes
    rng = np.random.default_rng(solo)
    W = 1024
    node = rng.integers(-3, 70, W).astype(np.int32)     # out-of-range too
    alive = rng.uniform(size=W) < 0.8
    kw = dict(solo_threshold=solo, max_task_walks=max_task, tile_walks=64,
              tile_edges=128)
    want = j_sched.dispatch_stats(j_idx, jnp.asarray(node),
                                  jnp.asarray(alive),
                                  jcfg.SchedulerConfig(**kw))
    got = t_sched.dispatch_stats(t_idx, torch.from_numpy(node),
                                 torch.from_numpy(alive),
                                 tcfg.SchedulerConfig(**kw))
    _assert_stats(got, want)


@pytest.mark.parametrize("tile_walks,tile_edges", [(64, 256), (128, 64),
                                                   (1, 8192)])
def test_build_task_table_matches_reference(hub_indexes, tile_walks,
                                            tile_edges):
    j_idx, t_idx, _ = hub_indexes
    rng = np.random.default_rng(tile_walks)
    nodes = np.sort(rng.integers(0, 64, 512)).astype(np.int32)
    cfg = dict(tile_walks=tile_walks, tile_edges=tile_edges)
    a, b = j_node_range(j_idx, jnp.asarray(nodes))
    want = j_sched.build_task_table(j_idx, jnp.asarray(nodes), a, b,
                                    jcfg.SchedulerConfig(**cfg))
    ta, tb = node_range(t_idx, torch.from_numpy(nodes))
    got = t_sched.build_task_table(t_idx, torch.from_numpy(nodes), ta, tb,
                                   tcfg.SchedulerConfig(**cfg))
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# Refusals and the default engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["tiled", "fused"])
@pytest.mark.parametrize("what", ["table", "node2vec"])
def test_refusals_match_reference(indexes, path, what):
    kw = dict(bias="table") if what == "table" else dict(node2vec_p=0.5)
    with pytest.raises(ValueError) as want:
        j_check_capabilities(jcfg.SamplerConfig(**kw), path,
                             have_tables=True)
    with pytest.raises(ValueError) as got:
        check_capabilities(tcfg.SamplerConfig(**kw), path,
                           have_tables=True)
    assert str(got.value) == str(want.value)
    tables = (build_tables(indexes[1], TableSpec()) if what == "table"
              else None)
    with pytest.raises(ValueError, match=f"path='{path}' does not support"):
        generate_walks(indexes[1], prng.PRNGKey(0),
                       tcfg.WalkConfig(num_walks=64, max_length=4),
                       tcfg.SamplerConfig(**kw),
                       tcfg.SchedulerConfig(path=path, **TILES),
                       tables=tables)


def test_unknown_path_and_regroup_raise(indexes):
    t_idx = indexes[1]
    wcfg = tcfg.WalkConfig(num_walks=64, max_length=4)
    with pytest.raises(ValueError, match="unknown scheduler path"):
        generate_walks(t_idx, prng.PRNGKey(0), wcfg, tcfg.SamplerConfig(),
                       tcfg.SchedulerConfig(path="warp"))
    with pytest.raises(ValueError, match="unknown regroup"):
        generate_walks(t_idx, prng.PRNGKey(0), wcfg, tcfg.SamplerConfig(),
                       tcfg.SchedulerConfig(regroup="radix"))


def test_default_engine_replays_like_reference():
    """``EngineConfig()`` — the default grouped/bucket scheduler — replays
    on the port and matches the reference's replay."""
    g = powerlaw_temporal_graph(3000, 9000, seed=4, t_max=30_000)
    batches = list(chronological_batches(g, 3))
    wcfg = dict(num_walks=256, max_length=8)
    j_eng = JStreamingEngine(jcfg.EngineConfig(), 4096, probes=False)
    t_eng = StreamingEngine(tcfg.EngineConfig(), 4096, device="cpu")
    assert t_eng.cfg.scheduler.path == "grouped"
    j_stats, j_walks, _ = j_eng.replay_device(
        batches, jcfg.WalkConfig(**wcfg), return_walks=True)
    t_stats, t_walks, _ = t_eng.replay_device(
        batches, tcfg.WalkConfig(**wcfg), return_walks=True)
    for f in j_stats._fields:
        np.testing.assert_array_equal(getattr(t_stats, f),
                                      np.asarray(getattr(j_stats, f)),
                                      err_msg=f)
    _assert_same_walks(j_walks, t_walks._replace(
        nodes=torch.from_numpy(t_walks.nodes),
        times=torch.from_numpy(t_walks.times),
        lengths=torch.from_numpy(t_walks.lengths)))
    assert int(t_stats.late_drops[-1]) > 0
    assert float(t_stats.mean_len[-1]) > 1.5
