"""Port fused hop (repro_torch.kernels.fused_step) vs the JAX reference.

On the CPU ``fused_walk_step`` takes the plain versions (``tier_split``
and ``fused_step_plain``). Its k/n/dst/ts and the ``tiers`` statistic must
equal, bitwise, the Pallas kernel run in
interpret mode (as tests/test_fused_step.py runs it) and the tier-free
oracle kernels/ref.py::fused_step_ref, in both sampler modes: on random
graphs with mixed bias codes, on the crafted tile-boundary lanes of
tests/test_tile_boundary.py (exact-fit ``hi == 2·TE``, empty
end-of-window, oversize), with W == TW == 1, and on an empty window. The
reference's own index is fed in through ``interop`` so both sides read
the same prefix floats.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SchedulerConfig as JSchedulerConfig
from repro.core.edge_store import store_from_arrays as j_store_from_arrays
from repro.core.temporal_index import build_index as j_build_index
from repro.core.temporal_index import node_range as j_node_range
from repro.data.synthetic import powerlaw_temporal_graph
from repro.kernels import ref as kref
from repro.kernels.fused_step import fused_walk_step as j_fused_walk_step
from repro_torch import interop
from repro_torch.configs.base import SchedulerConfig
from repro_torch.core.edge_store import store_from_arrays
from repro_torch.core.temporal_index import build_index
from repro_torch.kernels import fused_step as kf
from repro_torch.kernels import runtime

from test_tile_boundary import TE as BTE
from test_tile_boundary import TW as BTW
from test_tile_boundary import _lanes as _boundary_lanes
from test_tile_boundary import _make_index as _boundary_index


def _lane_inputs(seed, W, N, t_lo=-100, t_hi=10_000):
    rng = np.random.default_rng(seed)
    nodes = np.sort(rng.integers(0, N, W)).astype(np.int32)
    times = rng.integers(t_lo, t_hi, W).astype(np.int32)
    u = rng.uniform(size=W).astype(np.float32)
    code = rng.integers(0, 3, W).astype(np.int32)
    return nodes, times, u, code


def _graph_index(N, num_edges, seed, E=2048):
    g = powerlaw_temporal_graph(N, num_edges, seed=seed)
    return j_build_index(j_store_from_arrays(
        g.src % N, g.dst % N, g.ts, edge_capacity=E, node_capacity=N), N)


def _assert_matches_reference(j_idx, nodes, times, u, code, mode, TW, TE):
    """Port plain hop == Pallas interpret == oracle, bitwise."""
    t_idx = interop.index_from_ref(j_idx, device="cpu")
    E = j_idx.edge_capacity
    jn, jt, ju, jc = map(jnp.asarray, (nodes, times, u, code))
    want = j_fused_walk_step(j_idx, jn, jt, jc, ju, mode,
                             JSchedulerConfig(path="fused", tile_walks=TW,
                                              tile_edges=TE),
                             interpret=True)
    a, b = j_node_range(j_idx, jn)
    tbase = j_idx.node_tbase[jnp.clip(jn, 0, j_idx.node_capacity - 1)]
    oracle = kref.fused_step_ref(j_idx.ns_ts[:E], j_idx.ns_dst[:E],
                                 j_idx.pexp, j_idx.plin, a, b, jt, jc, ju,
                                 tbase, mode=mode)
    before = dict(runtime.LAUNCHES)
    got = kf.fused_walk_step(
        t_idx, torch.from_numpy(nodes), torch.from_numpy(times),
        torch.from_numpy(code), torch.from_numpy(u), mode,
        SchedulerConfig(path="fused", tile_walks=TW, tile_edges=TE))
    assert runtime.LAUNCHES == before      # CPU tensors: plain version
    for name, g, w, o in zip(("k", "n", "dst", "ts"), got[:4], want[:4],
                             oracle):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"{mode}/{name} vs pallas")
        np.testing.assert_array_equal(g.numpy(), np.asarray(o),
                                      err_msg=f"{mode}/{name} vs oracle")
    np.testing.assert_array_equal(got.tiers.numpy(), np.asarray(want.tiers),
                                  err_msg=f"{mode}/tiers")
    return got


@pytest.mark.parametrize("mode", ["index", "weight"])
@pytest.mark.parametrize("TW,TE", [(128, 256), (64, 512), (256, 128)])
def test_fused_matches_reference(mode, TW, TE):
    j_idx = _graph_index(128, 1948, seed=2)
    got = _assert_matches_reference(j_idx, *_lane_inputs(2, 512, 128),
                                    mode, TW, TE)
    tiers = got.tiers.numpy()
    assert tiers[0] > 0 and tiers[1] > 0, tiers
    assert tiers[0] + tiers[1] == 512


@pytest.mark.parametrize("mode", ["index", "weight"])
@pytest.mark.parametrize("seed,N,num_edges,TW,TE", [
    (11, 8, 1800, 32, 128),
    (12, 40, 600, 64, 1024),
    (13, 160, 1500, 128, 256),
])
def test_fused_random_graphs(mode, seed, N, num_edges, TW, TE):
    j_idx = _graph_index(N, num_edges, seed)
    _assert_matches_reference(j_idx, *_lane_inputs(seed, 128, N), mode, TW,
                              TE)


@pytest.mark.parametrize("mode", ["index", "weight"])
def test_fused_boundary_lanes(mode):
    j_idx = _boundary_index()
    s_node, s_time, u = (np.array(x) for x in _boundary_lanes())
    code = np.asarray([i % 3 for i in range(16)], np.int32)
    got = _assert_matches_reference(j_idx, s_node, s_time, u, code, mode,
                                    BTW, BTE)
    assert got.tiers.numpy()[1] == 4          # the oversize node-3 lanes


def test_fused_single_walk():
    """W == TW == 1: one lane, one tile."""
    j_idx = _boundary_index()
    for node, t in ((3, 305), (0, 15), (7, 0)):
        for mode in ("index", "weight"):
            _assert_matches_reference(
                j_idx, np.asarray([node], np.int32),
                np.asarray([t], np.int32), np.asarray([0.7], np.float32),
                np.asarray([2], np.int32), mode, 1, BTE)


def test_fused_empty_window():
    j_idx = j_build_index(j_store_from_arrays([], [], [], edge_capacity=512,
                                              node_capacity=8), 8)
    W = 8
    nodes = (np.arange(W) % 8).astype(np.int32)
    for mode in ("index", "weight"):
        got = _assert_matches_reference(
            j_idx, nodes, np.zeros(W, np.int32), np.full(W, 0.5, np.float32),
            (np.arange(W) % 3).astype(np.int32), mode, 4, 128)
        assert int(got.n.sum()) == 0 and int(got.dst.abs().sum()) == 0


def test_fused_on_port_built_index():
    """Index mode reads only integer arrays, so the port's own index gives
    the reference's hop exactly."""
    g = powerlaw_temporal_graph(128, 1948, seed=2)
    j_idx = j_build_index(j_store_from_arrays(
        g.src % 128, g.dst % 128, g.ts, edge_capacity=2048,
        node_capacity=128), 128)
    t_idx = build_index(store_from_arrays(g.src % 128, g.dst % 128, g.ts,
                                          2048, 128, device="cpu"), 128)
    nodes, times, u, code = _lane_inputs(4, 256, 128)
    want = j_fused_walk_step(
        j_idx, *map(jnp.asarray, (nodes, times, code, u)), "index",
        JSchedulerConfig(path="fused", tile_walks=64, tile_edges=256),
        interpret=True)
    got = kf.fused_walk_step(
        t_idx, *map(torch.from_numpy, (nodes, times, code, u)), "index",
        SchedulerConfig(path="fused", tile_walks=64, tile_edges=256))
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))


def test_fused_rejects_bad_shapes():
    j_idx = _graph_index(128, 1948, seed=2)
    t_idx = interop.index_from_ref(j_idx, device="cpu")
    nodes = torch.zeros(100, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiples of tile"):
        kf.fused_walk_step(t_idx, nodes, nodes, nodes,
                           torch.zeros(100), "index", SchedulerConfig())
    with pytest.raises(ValueError, match="unknown sampler mode"):
        kf.fused_walk_step(t_idx, nodes[:64], nodes[:64], nodes[:64],
                           torch.zeros(64), "bogus",
                           SchedulerConfig(tile_walks=64, tile_edges=256))
