"""Port samplers and lane regrouping vs the JAX reference: the three
closed-form index samplers exactly on a (u, n) grid that includes the
n > 80 asymptotic branch, the start-edge picks in both modes, and
``bucket_regroup`` giving the same permutation."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SamplerConfig as JSamplerConfig
from repro.core import edge_store as j_es
from repro.core import samplers as j_s
from repro.core import temporal_index as j_ti
from repro.core.scheduler import bucket_regroup as j_bucket_regroup
from repro.data.synthetic import powerlaw_temporal_graph
from repro_torch import interop
from repro_torch.configs.base import SamplerConfig
from repro_torch.core import samplers as t_s
from repro_torch.core.scheduler import bucket_regroup


def _grid():
    rng = np.random.default_rng(0)
    us = np.concatenate([
        np.float32([0.0, 1e-38, 1e-30, 1e-12, 1e-7, 0.25, 0.5, 0.75,
                    np.nextafter(np.float32(1), np.float32(0))]),
        rng.uniform(size=300).astype(np.float32)])
    ns = np.concatenate([np.arange(0, 200), [255, 1000, 4097, 65536,
                                            (1 << 20) + 3, 1 << 24]])
    u, n = np.meshgrid(us, ns.astype(np.int32), indexing="ij")
    return u.ravel(), n.ravel()


@pytest.mark.parametrize("bias", ["uniform", "linear", "exponential"])
def test_index_samplers_exact(bias):
    u, n = _grid()
    want = np.asarray(getattr(j_s, f"index_{bias}")(jnp.asarray(u),
                                                    jnp.asarray(n)))
    got = getattr(t_s, f"index_{bias}")(torch.from_numpy(u),
                                        torch.from_numpy(n))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_index_pick_lanes_exact():
    u, n = _grid()
    code = (np.arange(u.shape[0]) % 3).astype(np.int32)
    want = np.asarray(j_s.index_pick_lanes(jnp.asarray(code), jnp.asarray(u),
                                           jnp.asarray(n)))
    got = t_s.index_pick_lanes(torch.from_numpy(code), torch.from_numpy(u),
                               torch.from_numpy(n))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["index", "weight"])
@pytest.mark.parametrize("start_bias", ["uniform", "linear", "exponential"])
def test_pick_start_edges_exact(mode, start_bias):
    g = powerlaw_temporal_graph(100, 1500, seed=6)
    j_idx = j_ti.build_index(j_es.store_from_arrays(
        g.src, g.dst, g.ts, edge_capacity=2048, node_capacity=128), 128)
    t_idx = interop.index_from_ref(j_idx, device="cpu")
    u = np.random.default_rng(1).uniform(size=777).astype(np.float32)
    want = j_s.pick_start_edges(j_idx, JSamplerConfig(mode=mode,
                                                      start_bias=start_bias),
                                jnp.asarray(u))
    got = t_s.pick_start_edges(t_idx, SamplerConfig(mode=mode,
                                                    start_bias=start_bias),
                               torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_weighted_pick_exp_exact():
    g = powerlaw_temporal_graph(60, 1800, seed=8)
    j_idx = j_ti.build_index(j_es.store_from_arrays(
        g.src, g.dst, g.ts, edge_capacity=2048, node_capacity=64), 64)
    t_idx = interop.index_from_ref(j_idx, device="cpu")
    rng = np.random.default_rng(2)
    nodes = rng.integers(0, 64, 500).astype(np.int32)
    a, b = j_ti.node_range(j_idx, jnp.asarray(nodes))
    c = j_ti.temporal_cutoff(j_idx, a, b, jnp.asarray(
        rng.integers(0, 10_000, 500).astype(np.int32)))
    u = rng.uniform(size=500).astype(np.float32)
    want = j_s.weighted_pick_exp(j_idx.pexp, c, b, jnp.asarray(u))
    got = t_s.weighted_pick_exp(t_idx.pexp, torch.tensor(np.asarray(c)),
                                torch.tensor(np.asarray(b)),
                                torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _regroup_case(seed, W, nc, mixed, dead_frac, t_span):
    rng = np.random.default_rng(seed)
    node = rng.integers(0, nc, W).astype(np.int32)
    if mixed:
        time = rng.integers(0, t_span, W).astype(np.int32)
    else:
        # one time per node: no occupied node carries mixed times
        time = (node * 7 % t_span).astype(np.int32)
    dead = rng.uniform(size=W) < dead_frac
    node_key = np.where(dead, nc + 1, node).astype(np.int32)
    return node_key, time


@pytest.mark.parametrize("time_subsort", [True, False])
@pytest.mark.parametrize("seed,W,nc,mixed,dead,span", [
    (0, 512, 64, True, 0.1, 10_000),
    (1, 512, 64, False, 0.2, 10_000),
    (2, 1000, 300, True, 0.0, 1 << 20),       # span > 2^16: shifted keys
    (3, 256, 16, True, 0.9, 50),
    (4, 64, 1000, True, 0.0, 1 << 12),
])
def test_bucket_regroup_same_permutation(time_subsort, seed, W, nc, mixed,
                                         dead, span):
    node_key, time = _regroup_case(seed, W, nc, mixed, dead, span)
    want = j_bucket_regroup(jnp.asarray(node_key), jnp.asarray(time), nc,
                            time_subsort=time_subsort)
    got = bucket_regroup(torch.from_numpy(node_key), torch.from_numpy(time),
                         nc, time_subsort=time_subsort)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bucket_regroup_composes_like_reference():
    """Carried across hops, the composed lane maps stay equal."""
    rng = np.random.default_rng(5)
    W, nc = 384, 40
    lane_j = jnp.arange(W, dtype=jnp.int32)
    lane_t = torch.arange(W, dtype=torch.int32)
    for _ in range(4):
        node_key = rng.integers(0, nc + 2, W).astype(np.int32)
        time = rng.integers(0, 500, W).astype(np.int32)
        pj = j_bucket_regroup(jnp.asarray(node_key)[lane_j],
                              jnp.asarray(time)[lane_j], nc)
        pt = bucket_regroup(torch.from_numpy(node_key)[lane_t.long()],
                            torch.from_numpy(time)[lane_t.long()], nc)
        lane_j = lane_j[pj]
        lane_t = lane_t[pt.long()]
        np.testing.assert_array_equal(lane_t.numpy(), np.asarray(lane_j))


def test_bias_codes_match():
    assert t_s.BIAS_CODES == j_s.BIAS_CODES
    with pytest.raises(ValueError, match="unknown bias"):
        t_s.bias_code("nope")
