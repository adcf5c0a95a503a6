"""The slice as a whole: the port's fused-path walks and streaming replay
vs the JAX reference, byte for byte.

* ``generate_walks`` in index mode, 3 biases × start modes {nodes, edges,
  all_nodes}, on the port's own index: identical to the reference's walks
  for the same key on its grouped-bucket path and on its fused path
  (Pallas in interpret mode).
* Weight mode: identical when the reference's index is fed in through
  ``interop`` (the float prefixes are then the same bits).
* A K=3 replay: ``ReplayStats`` and the final walks equal to the
  reference's ``StreamingEngine(..., probes=False).replay_device``.
"""
import jax
import numpy as np
import pytest

from repro.configs import base as jcfg
from repro.core.edge_store import store_from_arrays as j_store_from_arrays
from repro.core.streaming import StreamingEngine as JStreamingEngine
from repro.core.temporal_index import build_index as j_build_index
from repro.core.validation import validate_walks as j_validate_walks
from repro.core.walk_engine import WalkResult as JWalkResult
from repro.core.walk_engine import generate_walks as j_generate_walks
from repro.data.synthetic import chronological_batches, powerlaw_temporal_graph
from repro_torch import interop
from repro_torch import random as prng
from repro_torch.configs import base as tcfg
from repro_torch.core.edge_store import store_from_arrays
from repro_torch.core.streaming import StreamingEngine
from repro_torch.core.temporal_index import build_index
from repro_torch.core.validation import validate_walks
from repro_torch.core.walk_engine import generate_walks

BIASES = ["uniform", "linear", "exponential"]
TILES = dict(tile_walks=64, tile_edges=256)
E, N = 2048, 128


@pytest.fixture(scope="module")
def graph():
    g = powerlaw_temporal_graph(N, E - 100, seed=7)
    return g.src % N, g.dst % N, g.ts


@pytest.fixture(scope="module")
def j_index(graph):
    return j_build_index(j_store_from_arrays(*graph, edge_capacity=E,
                                             node_capacity=N), N)


@pytest.fixture(scope="module")
def t_index(graph):
    return build_index(store_from_arrays(*graph, E, N, device="cpu"), N)


def _assert_same_walks(ref, got):
    for f in ("nodes", "times", "lengths"):
        g = getattr(got, f)
        g = g.numpy() if hasattr(g, "numpy") else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(getattr(ref, f)),
                                      err_msg=f)


def _walk(index, key, wcfg, scfg, path, j=True, **tiles):
    if j:
        return j_generate_walks(index, key, jcfg.WalkConfig(**wcfg),
                                jcfg.SamplerConfig(**scfg),
                                jcfg.SchedulerConfig(path=path, **tiles))
    return generate_walks(index, interop.key_from_words(key),
                          tcfg.WalkConfig(**wcfg), tcfg.SamplerConfig(**scfg),
                          tcfg.SchedulerConfig(path="fused", **tiles))


@pytest.mark.parametrize("start_mode", ["nodes", "edges", "all_nodes"])
@pytest.mark.parametrize("bias", BIASES)
def test_index_walks_match_grouped_bucket(j_index, t_index, bias, start_mode):
    key = jax.random.PRNGKey(0)
    wcfg = dict(num_walks=256, max_length=8, start_mode=start_mode)
    scfg = dict(bias=bias, mode="index")
    ref = _walk(j_index, key, wcfg, scfg, "grouped", **TILES)
    got = _walk(t_index, key, wcfg, scfg, "fused", j=False, **TILES)
    _assert_same_walks(ref, got)
    assert int(got.lengths.max()) > 2


@pytest.mark.parametrize("start_mode", ["nodes", "edges", "all_nodes"])
@pytest.mark.parametrize("bias", BIASES)
def test_index_walks_match_reference_fused(j_index, t_index, bias,
                                           start_mode):
    key = jax.random.PRNGKey(3)
    wcfg = dict(num_walks=128, max_length=5, start_mode=start_mode)
    scfg = dict(bias=bias, mode="index")
    ref = _walk(j_index, key, wcfg, scfg, "fused", **TILES)
    got = _walk(t_index, key, wcfg, scfg, "fused", j=False, **TILES)
    _assert_same_walks(ref, got)


@pytest.mark.parametrize("start_mode,start_bias", [
    ("nodes", "uniform"), ("edges", "uniform"), ("edges", "exponential"),
    ("edges", "linear")])
@pytest.mark.parametrize("bias", BIASES)
def test_weight_walks_match_on_reference_index(j_index, bias, start_mode,
                                               start_bias):
    key = jax.random.PRNGKey(1)
    t_idx = interop.index_from_ref(j_index, device="cpu")
    wcfg = dict(num_walks=256, max_length=8, start_mode=start_mode)
    scfg = dict(bias=bias, mode="weight", start_bias=start_bias)
    ref = _walk(j_index, key, wcfg, scfg, "grouped", **TILES)
    got = _walk(t_idx, key, wcfg, scfg, "fused", j=False, **TILES)
    _assert_same_walks(ref, got)


def test_default_tiles_single_walk_tile(j_index, t_index):
    """Default 256 × 1024 tiles (E = 2·TE), and W == TW == 1 end to end."""
    key = jax.random.PRNGKey(4)
    for W, tiles in ((256, {}), (1, dict(tile_walks=1, tile_edges=1024))):
        wcfg = dict(num_walks=W, max_length=6)
        ref = _walk(j_index, key, wcfg, dict(mode="index"), "grouped",
                    **tiles)
        got = _walk(t_index, key, wcfg, dict(mode="index"), "fused",
                    j=False, **tiles)
        _assert_same_walks(ref, got)


def _engines(bias, mode, path):
    window = dict(duration=1000.0, edge_capacity=4096, node_capacity=256)
    j = jcfg.EngineConfig(window=jcfg.WindowConfig(**window),
                          sampler=jcfg.SamplerConfig(bias=bias, mode=mode),
                          scheduler=jcfg.SchedulerConfig(path=path, **TILES))
    t = tcfg.EngineConfig(window=tcfg.WindowConfig(**window),
                          sampler=tcfg.SamplerConfig(bias=bias, mode=mode),
                          scheduler=tcfg.SchedulerConfig(path="fused",
                                                         **TILES))
    return JStreamingEngine(j, 2048, probes=False), \
        StreamingEngine(t, 2048, device="cpu")


@pytest.mark.parametrize("bias,path", [("exponential", "fused"),
                                       ("uniform", "grouped"),
                                       ("linear", "grouped"),
                                       ("exponential", "grouped")])
def test_replay_matches_reference(bias, path):
    g = powerlaw_temporal_graph(200, 6000, seed=3, t_max=3000)
    batches = list(chronological_batches(g, 3))
    j_eng, t_eng = _engines(bias, "index", path)
    W = jcfg.WalkConfig(num_walks=256, max_length=8)
    j_stats, j_walks, _ = j_eng.replay_device(batches, W, return_walks=True)
    t_stats, t_walks, _ = t_eng.replay_device(
        batches, tcfg.WalkConfig(num_walks=256, max_length=8),
        return_walks=True)
    for f in j_stats._fields:
        np.testing.assert_array_equal(getattr(t_stats, f),
                                      np.asarray(getattr(j_stats, f)),
                                      err_msg=f)
    _assert_same_walks(j_walks, t_walks)
    assert int(t_stats.late_drops[-1]) > 0      # the window did slide
    # the engines' keys advanced identically: a second replay agrees too
    j_stats2, _ = j_eng.replay_device(batches[:1], W)
    t_stats2, _ = t_eng.replay_device(
        batches[:1], tcfg.WalkConfig(num_walks=256, max_length=8))
    np.testing.assert_array_equal(t_stats2.mean_len,
                                  np.asarray(j_stats2.mean_len))


def test_validate_walks_matches_reference(j_index, t_index):
    key = jax.random.PRNGKey(2)
    wcfg = dict(num_walks=256, max_length=8, start_mode="edges")
    got = _walk(t_index, key, wcfg, dict(mode="index"), "fused", j=False,
                **TILES)
    rep = validate_walks(t_index, got)
    want = j_validate_walks(j_index, JWalkResult(
        nodes=got.nodes.numpy(), times=got.times.numpy(),
        lengths=got.lengths.numpy(), stats=None))
    assert rep.hop_valid_frac == 1.0 and rep.walk_valid_frac == 1.0
    assert rep.num_hops == int(want.num_hops) > 0
    assert rep.num_walks == int(want.num_walks)
    # a corrupted hop is caught by both validators
    bad = got._replace(times=got.times.clone())
    row = int(np.argmax(got.lengths.numpy() > 3))
    bad.times[row, 2] += 1
    rep_bad = validate_walks(t_index, bad)
    want_bad = j_validate_walks(j_index, JWalkResult(
        nodes=bad.nodes.numpy(), times=bad.times.numpy(),
        lengths=bad.lengths.numpy(), stats=None))
    assert rep_bad.hop_valid_frac < 1.0
    assert rep_bad.hop_valid_frac == pytest.approx(
        float(want_bad.hop_valid_frac))


def test_capability_refusals(t_index):
    key = prng.PRNGKey(0)
    wcfg = tcfg.WalkConfig(num_walks=64, max_length=4)
    fused = tcfg.SchedulerConfig(path="fused", **TILES)
    with pytest.raises(ValueError, match="path='fused' does not support "
                                         "node2vec"):
        generate_walks(t_index, key, wcfg,
                       tcfg.SamplerConfig(node2vec_p=0.5), fused)
    with pytest.raises(ValueError, match="does not support bias='table'"):
        generate_walks(t_index, key, wcfg, tcfg.SamplerConfig(bias="table"),
                       fused)
    with pytest.raises(ValueError, match="unknown bias"):
        generate_walks(t_index, key, wcfg, tcfg.SamplerConfig(bias="zipf"),
                       fused)
    for sched in (tcfg.SchedulerConfig(path="grouped"),
                  tcfg.SchedulerConfig(path="fused", regroup="lexsort")):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            generate_walks(t_index, key, wcfg, tcfg.SamplerConfig(), sched)
