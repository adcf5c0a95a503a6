"""Port tiled hop (repro_torch.kernels.walk_step / ops) and weight-mode
samplers vs the JAX reference.

* ``walk_step_plain`` equals the Pallas ``walk_step_tiled`` run in
  interpret mode on **all** lanes (oversize lanes included), and
  ``kernels/ref.py::walk_step_ref`` on in-tile lanes, bitwise: the six
  (mode, bias) pairs × the tile shapes of tests/test_kernels.py, and the
  crafted boundary lanes of tests/test_tile_boundary.py (exact fit
  ``hi == 2·TE``, an empty end-of-window region, oversize).
* ``ops.walk_step`` equals the reference's ``ops.walk_step`` on every lane
  of a hub graph where some lanes are oversize.
* ``walk_step_hop_plain`` (the plain version of the one-launch hop) equals
  the reference's ``ops.walk_step`` ``(k, n)`` bitwise in all six
  (mode, bias), on a hub graph and on the boundary lanes (oversize,
  exact fit ``hi == 2·TE``, empty end-of-window), and gathers ``dst``/``ts``
  at ``k`` where ``n > 0``.
* ``weighted_pick_linear`` and ``pick_in_neighborhood`` equal the
  reference on shared (c, b, u) grids.
* The unclipped weight-mode pick: the target ``p_c ⊕ (u ⊗ (p_hi ⊖ p_c))``
  never rounds above ``p_hi`` (shown over the half-ulp tie cases where it
  comes closest), so the Pallas kernels' missing clip into
  ``[c, max(b−1, c)]`` is never reached; a hand-made prefix at that
  closest approach gives the region's last edge from all six picks.

Weight mode reads the reference's own index (``interop``), so both sides
see the same prefix floats. Inputs are made from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SamplerConfig as JSamplerConfig
from repro.configs.base import SchedulerConfig as JSchedulerConfig
from repro.core import samplers as j_s
from repro.core.edge_store import store_from_arrays as j_store_from_arrays
from repro.core.temporal_index import build_index as j_build_index
from repro.core.temporal_index import node_range as j_node_range
from repro.core.temporal_index import temporal_cutoff as j_temporal_cutoff
from repro.data.synthetic import powerlaw_temporal_graph
from repro.kernels import ops as j_ops
from repro.kernels import ref as kref
from repro.kernels.fused_step import fused_walk_step as j_fused_walk_step
from repro.kernels.walk_step import walk_step_tiled as j_walk_step_tiled
from repro_torch import interop
from repro_torch.configs.base import SamplerConfig, SchedulerConfig
from repro_torch.core import samplers as t_s
from repro_torch.core import scheduler as t_sched
from repro_torch.core.temporal_index import node_range, temporal_cutoff
from repro_torch.kernels import fused_step as kf
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import runtime
from repro_torch.kernels.walk_step import (walk_step_hop,
                                           walk_step_hop_plain,
                                           walk_step_plain, walk_step_tiled)

from test_tile_boundary import E as BE
from test_tile_boundary import TE as BTE
from test_tile_boundary import TW as BTW
from test_tile_boundary import _lanes as _boundary_lanes
from test_tile_boundary import _make_index as _boundary_index


def _t(x):
    return torch.from_numpy(np.array(x))


MODES = [("index", "uniform"), ("index", "linear"), ("index", "exponential"),
         ("weight", "uniform"), ("weight", "exponential"),
         ("weight", "linear")]


def _graph_index(N=128, num_edges=1948, E=2048, seed=2, skew=1.2):
    g = powerlaw_temporal_graph(N, num_edges, seed=seed, skew=skew)
    return j_build_index(j_store_from_arrays(
        g.src % N, g.dst % N, g.ts, edge_capacity=E, node_capacity=N), N)


def _lanes(seed, W, N, t_hi=10_000):
    rng = np.random.default_rng(seed)
    nodes = np.sort(rng.integers(0, N, W)).astype(np.int32)
    times = rng.integers(-100, t_hi, W).astype(np.int32)
    u = rng.uniform(size=W).astype(np.float32)
    return nodes, times, u


def _tile_args(j_idx, nodes, times, u, mode, bias, TW, TE):
    """The reference wrapper's tile inputs (kernels/ops.py:36-63), as numpy
    arrays, plus the oversize mask."""
    E = j_idx.edge_capacity
    W = nodes.shape[0]
    a, b = (np.asarray(x) for x in j_node_range(j_idx, jnp.asarray(nodes)))
    T = W // TW
    base_blocks = np.clip(a.reshape(T, TW).min(1) // TE, 0, E // TE - 2)
    base = np.repeat(base_blocks * TE, TW)
    lo, hi = a - base, b - base
    oversize = (lo < 0) | (hi > 2 * TE)
    lin = mode == "weight" and bias == "linear"
    prefix = np.asarray(j_idx.plin if lin else j_idx.pexp)
    tbase = np.asarray(j_idx.node_tbase)[np.clip(nodes, 0,
                                                 j_idx.node_capacity - 1)]
    args = (np.asarray(j_idx.ns_ts[:E]), np.asarray(j_idx.ns_dst[:E]),
            prefix[:E], prefix[1:E + 1], base_blocks.astype(np.int32),
            times, np.clip(lo, 0, 2 * TE).astype(np.int32),
            np.clip(hi, 0, 2 * TE).astype(np.int32), u, tbase)
    return args, oversize


def _assert_plain_matches(j_idx, nodes, times, u, mode, bias, TW, TE):
    args, oversize = _tile_args(j_idx, nodes, times, u, mode, bias, TW, TE)
    kw = dict(mode=mode, bias=bias, tile_walks=TW, tile_edges=TE)
    pallas = j_walk_step_tiled(*map(jnp.asarray, args), interpret=True, **kw)
    oracle = kref.walk_step_ref(*map(jnp.asarray, args), **kw)
    before = dict(runtime.LAUNCHES)
    got = walk_step_tiled(*map(_t, args), **kw)
    assert runtime.LAUNCHES == before          # CPU tensors: plain version
    ok = ~oversize
    for name, g, p, o in zip(("k", "n", "dst", "ts"), got, pallas, oracle):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(p),
                                      err_msg=f"{mode}/{bias}/{name}")
        np.testing.assert_array_equal(g.numpy()[ok], np.asarray(o)[ok],
                                      err_msg=f"{mode}/{bias}/{name} oracle")
    return got, oversize


@pytest.mark.parametrize("mode,bias", MODES)
@pytest.mark.parametrize("TW,TE", [(128, 256), (64, 512), (256, 128)])
def test_walk_step_plain_matches_reference(mode, bias, TW, TE):
    got, oversize = _assert_plain_matches(
        _graph_index(), *_lanes(2, 512, 128), mode, bias, TW, TE)
    assert int((got[1] > 0).sum()) > 100
    if TE < 512:
        assert oversize.any()


@pytest.mark.parametrize("mode,bias", MODES)
def test_walk_step_plain_boundary_lanes(mode, bias):
    """Exact fit (hi == 2·TE), empty end-of-window (lo == hi == 2·TE) and
    oversize lanes of the boundary graph."""
    j_idx = _boundary_index()
    nodes, times, u = (np.array(x) for x in _boundary_lanes())
    got, oversize = _assert_plain_matches(j_idx, nodes, times, u, mode, bias,
                                          BTW, BTE)
    args, _ = _tile_args(j_idx, nodes, times, u, mode, bias, BTW, BTE)
    lo, hi = args[6], args[7]
    assert ((hi == 2 * BTE) & ~oversize).sum() == 8 and oversize.sum() == 4
    assert ((lo == 2 * BTE) & (hi == 2 * BTE)).sum() == 2
    assert (got[1].numpy()[(lo == hi)] == 0).all()


@pytest.mark.parametrize("mode,bias", MODES)
def test_walk_step_wrapper_matches_reference(mode, bias):
    """ops.walk_step (task table + kernel + oversize fallback) on a hub
    graph: (k, n) on every lane."""
    j_idx = _graph_index(N=64, num_edges=8000, E=8192, seed=3, skew=2.0)
    t_idx = interop.index_from_ref(j_idx, device="cpu")
    nodes, times, u = _lanes(5, 512, 64)
    cfg = dict(path="tiled", tile_walks=128, tile_edges=256)
    want = j_ops.walk_step(j_idx, *map(jnp.asarray, (nodes, times, u)),
                           JSamplerConfig(bias=bias, mode=mode),
                           JSchedulerConfig(**cfg), interpret=True)
    got = t_ops.walk_step(t_idx, *map(torch.from_numpy, (nodes, times, u)),
                          SamplerConfig(bias=bias, mode=mode),
                          SchedulerConfig(**cfg))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    tiles = t_sched.tile_table(t_idx, torch.from_numpy(nodes),
                             SchedulerConfig(**cfg))
    assert 0 < int(tiles.oversize.sum()) < 512


def _hop_cases():
    """(reference index, nodes, times, u, tile config): a hub graph whose
    lanes are mostly oversize, and the boundary graph's crafted lanes."""
    yield (_graph_index(N=64, num_edges=8000, E=8192, seed=3, skew=2.0),
           *_lanes(6, 512, 64), dict(tile_walks=128, tile_edges=256))
    yield (_boundary_index(), *(np.array(x) for x in _boundary_lanes()),
           dict(tile_walks=BTW, tile_edges=BTE))


@pytest.mark.parametrize("mode,bias", MODES)
def test_walk_step_hop_plain_matches_reference_ops(mode, bias):
    """walk_step_hop_plain == the reference's ops.walk_step (k, n) on every
    lane, bitwise; dst/ts are the rows at k where n > 0, else 0; the CPU
    route of walk_step_hop is the plain version and counts no launch."""
    seen = dict(oversize=0, exact_fit=0, empty_at_end=0)
    for j_idx, nodes, times, u, tiles in _hop_cases():
        t_idx = interop.index_from_ref(j_idx, device="cpu")
        want = j_ops.walk_step(j_idx, *map(jnp.asarray, (nodes, times, u)),
                               JSamplerConfig(bias=bias, mode=mode),
                               JSchedulerConfig(path="tiled", **tiles),
                               interpret=True)
        E = t_idx.edge_capacity
        tn, tt, tu = map(torch.from_numpy, (nodes, times, u))
        a, b = node_range(t_idx, tn)
        prefix = t_idx.plin if (mode, bias) == ("weight", "linear") \
            else t_idx.pexp
        tbase = t_idx.node_tbase[tn.clamp(0, t_idx.node_capacity - 1).long()]
        args = (t_idx.ns_ts[:E], t_idx.ns_dst[:E], prefix,
                t_sched.task_bases(a, E, SchedulerConfig(**tiles)), tt, a, b,
                tu, tbase)
        kw = dict(mode=mode, bias=bias, **tiles)
        got = walk_step_hop_plain(*args, **kw)
        for name, g, w in zip(("k", "n"), got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{mode}/{bias}/{name}")
        k, n, dst, ts = got
        has = n > 0
        kc = k.clamp(0, E - 1).long()
        assert torch.equal(dst, torch.where(has, t_idx.ns_dst[kc], 0))
        assert torch.equal(ts, torch.where(has, t_idx.ns_ts[kc], 0))
        before = dict(runtime.LAUNCHES)
        for g, w in zip(walk_step_hop(*args, **kw), got):
            assert torch.equal(g, w)
        assert runtime.LAUNCHES == before
        tl = t_sched.tile_table(t_idx, tn, SchedulerConfig(**tiles))
        lo, hi = t_sched.panel_bounds(tl, SchedulerConfig(**tiles))
        P = 2 * tiles["tile_edges"]
        seen["oversize"] += int(tl.oversize.sum())
        seen["exact_fit"] += int((~tl.oversize & (hi == P) & (lo < P)).sum())
        seen["empty_at_end"] += int((~tl.oversize & (lo == P)
                                     & (hi == P)).sum())
    assert all(v > 0 for v in seen.values()), seen


def test_tile_table_matches_reference_task_inputs():
    j_idx = _graph_index()
    t_idx = interop.index_from_ref(j_idx, device="cpu")
    nodes, _, _ = _lanes(9, 512, 128)
    args, oversize = _tile_args(j_idx, nodes, nodes, nodes, "index",
                                "uniform", 64, 256)
    cfg = SchedulerConfig(tile_walks=64, tile_edges=256)
    tiles = t_sched.tile_table(t_idx, torch.from_numpy(nodes), cfg)
    lo, hi = t_sched.panel_bounds(tiles, cfg)
    np.testing.assert_array_equal(tiles.base_blocks.numpy(), args[4])
    np.testing.assert_array_equal(lo.numpy(), args[6])
    np.testing.assert_array_equal(hi.numpy(), args[7])
    np.testing.assert_array_equal(tiles.oversize.numpy(), oversize)
    with pytest.raises(ValueError, match="multiples of tile"):
        t_sched.tile_table(t_idx, torch.zeros(100, dtype=torch.int32),
                         SchedulerConfig(tile_walks=64, tile_edges=256))
    with pytest.raises(ValueError, match=">= 2 tiles"):
        t_sched.tile_table(t_idx, torch.zeros(64, dtype=torch.int32),
                         SchedulerConfig(tile_walks=64, tile_edges=2048))


def test_walk_step_rejects_unknown_mode_and_bias():
    j_idx = _graph_index()
    args, _ = _tile_args(j_idx, *_lanes(1, 128, 128), "index", "uniform",
                         64, 256)
    targs = tuple(map(_t, args))
    with pytest.raises(ValueError, match="unknown sampler mode"):
        walk_step_plain(*targs, mode="bogus", bias="uniform", tile_walks=64,
                        tile_edges=256)
    with pytest.raises(ValueError, match="draws"):
        walk_step_plain(*targs, mode="index", bias="table", tile_walks=64,
                        tile_edges=256)


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------


def _cbu_grid(j_idx, seed=4):
    """(node, c, b, u) over every node and several cutoffs, endpoints of u
    included."""
    rng = np.random.default_rng(seed)
    N = j_idx.node_capacity
    nodes = np.repeat(np.arange(N, dtype=np.int32), 12)
    times = rng.integers(-10, 10_500, nodes.shape[0]).astype(np.int32)
    u = rng.uniform(size=nodes.shape[0]).astype(np.float32)
    u[::12] = 0.0
    u[1::12] = np.nextafter(np.float32(1), np.float32(0))
    a, b = j_node_range(j_idx, jnp.asarray(nodes))
    c = j_temporal_cutoff(j_idx, a, b, jnp.asarray(times))
    return nodes, np.asarray(c), np.asarray(b), u


def test_weighted_pick_linear_matches_reference():
    j_idx = _graph_index()
    t_idx = interop.index_from_ref(j_idx, device="cpu")
    nodes, c, b, u = _cbu_grid(j_idx)
    tb = np.asarray(j_idx.node_tbase)[nodes]
    want = j_s.weighted_pick_linear(j_idx.plin, j_idx.ns_ts, jnp.asarray(tb),
                                    jnp.asarray(c), jnp.asarray(b),
                                    jnp.asarray(u))
    got = t_s.weighted_pick_linear(t_idx.plin, t_idx.ns_ts, _t(tb), _t(c),
                                   _t(b), _t(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (b > c).sum() > 500


@pytest.mark.parametrize("mode,bias", MODES)
def test_pick_in_neighborhood_matches_reference(mode, bias):
    j_idx = _graph_index()
    t_idx = interop.index_from_ref(j_idx, device="cpu")
    nodes, c, b, u = _cbu_grid(j_idx, seed=5)
    want = j_s.pick_in_neighborhood(
        j_idx, JSamplerConfig(bias=bias, mode=mode), jnp.asarray(c),
        jnp.asarray(b), jnp.asarray(u), jnp.asarray(nodes))
    got = t_s.pick_in_neighborhood(
        t_idx, SamplerConfig(bias=bias, mode=mode), _t(c), _t(b), _t(u),
        _t(nodes))
    live = b > c
    np.testing.assert_array_equal(got.numpy()[live], np.asarray(want)[live])


# ---------------------------------------------------------------------------
# The unclipped weight-mode pick
# ---------------------------------------------------------------------------
#
# The Pallas kernels count ps[j] < target over [c, hi) and do not clip k
# into [c, max(hi−1, c)]; k == hi would need target > p_hi = ps[hi−1]. With
# round-to-nearest-even, 0 <= p_c <= p_hi and 0 <= u < 1 that cannot happen:
# d = p_hi ⊖ p_c overshoots p_hi − p_c by at most half an ulp of d, so
# p_c ⊕ d can round above p_hi only on a tie (overshoot exactly half an ulp
# of p_hi, d in p_hi's binade, p_hi odd). A tie makes d even and above the
# binade's power of two (the difference just below a power of two is
# representable), and then u ⊗ d <= d − ulp for every float32 u < 1, so
# p_c ⊕ (u ⊗ d) <= p_hi ⊖ ulp/2 rounds to at most p_hi. The linear target
# u ⊗ S(hi−1) is at most S(hi−1) itself, the last term counted.


def _tie_cases(n=4000, seed=11):
    """(p_c, p_hi) where p_hi ⊖ p_c rounds up by exactly half an ulp into an
    even d of p_hi's binade, p_hi odd: the only way the target can reach
    above p_hi."""
    rng = np.random.default_rng(seed)
    exp = rng.integers(-30, 30, n)
    mant = (rng.integers(1 << 22, 1 << 23, n) * 2 + 1)      # odd, 24 bits
    p_hi = np.ldexp(mant.astype(np.float64), exp - 23).astype(np.float32)
    ulp = np.ldexp(1.0, exp - 23)
    k = rng.integers(0, 1 << 12, n) * 2 + 1                  # odd k: d even
    p_c = ((k + 0.5) * ulp).astype(np.float32)
    d = (p_hi - p_c).astype(np.float32)
    tie = (d.astype(np.float64) - (p_hi.astype(np.float64)
                                   - p_c.astype(np.float64))) == ulp / 2
    assert tie.mean() > 0.9                                  # built as ties
    return p_c[tie], p_hi[tie]


def test_weight_target_never_rounds_above_p_hi():
    p_c, p_hi = _tie_cases()
    top = np.nextafter(np.float32(1), np.float32(0))
    us = np.concatenate([top - np.arange(512, dtype=np.float32)
                         * np.float32(2 ** -24),
                         np.random.default_rng(3).uniform(size=512)
                         .astype(np.float32)]).astype(np.float32)
    pc, ph, uu = (np.broadcast_arrays(p_c[:, None], p_hi[:, None],
                                      us[None, :]))
    # numpy float32 (IEEE round-to-nearest-even) and the port's torch ops
    target = (pc + uu * (ph - pc).astype(np.float32)).astype(np.float32)
    assert (target <= ph).all()
    tc, th, tu = (torch.from_numpy(np.ascontiguousarray(x))
                  for x in (pc, ph, uu))
    assert bool((tc + tu * (th - tc) <= th).all())
    # the overshoot is real: p_c ⊕ d alone lands above p_hi on these ties
    d = (p_hi - p_c).astype(np.float32)
    assert ((p_c + d).astype(np.float32) > p_hi).mean() > 0.9


def _closest_prefix():
    """A pexp in which node 2's region [16, 20) of the boundary graph, cut
    at c = 17, has p_c = 3·2^-24 and p_hi = 1 + 3·2^-23: p_hi ⊖ p_c rounds
    up by half an ulp (the tie above), and the last edge carries 3·2^-23 of
    the mass."""
    p = np.zeros(BE + 1, np.float32)
    p[17] = np.float32(3 * 2.0 ** -24)
    p[18:20] = 1.0
    p[20:] = np.float32(1 + 3 * 2.0 ** -23)
    return p


def test_unclipped_pick_lands_on_the_last_edge():
    """At the closest approach, u = 1 − 2^-24 picks the region's last edge
    (b − 1 = 19) from all six picks: Pallas walk_step_tiled, walk_step_ref,
    the port's walk_step_plain, Pallas fused tier S, fused_step_ref and the
    port's fused plain version."""
    j_idx = _boundary_index()._replace(pexp=jnp.asarray(_closest_prefix()))
    t_idx = interop.index_from_ref(j_idx, device="cpu")
    top = np.nextafter(np.float32(1), np.float32(0))
    nodes = np.full(BTW, 2, np.int32)
    times = np.full(BTW, 201, np.int32)           # c = 17, b = 20
    u = np.asarray([top, top - np.float32(2 ** -24), 0.5, 0.0], np.float32)
    want_k = np.asarray([19, 19, 17, 17])
    args, oversize = _tile_args(j_idx, nodes, times, u, "weight",
                                "exponential", BTW, BTE)
    assert not oversize.any()
    base = int(args[4][0]) * BTE
    got, _ = _assert_plain_matches(j_idx, nodes, times, u, "weight",
                                   "exponential", BTW, BTE)
    np.testing.assert_array_equal(got[0].numpy() + base, want_k)

    code = np.full(BTW, 2, np.int32)
    jn, jt, jc, ju = map(jnp.asarray, (nodes, times, code, u))
    pallas = j_fused_walk_step(j_idx, jn, jt, jc, ju, "weight",
                               JSchedulerConfig(path="fused", tile_walks=BTW,
                                                tile_edges=BTE),
                               interpret=True)
    a, b = j_node_range(j_idx, jn)
    oracle = kref.fused_step_ref(j_idx.ns_ts, j_idx.ns_dst, j_idx.pexp,
                                 j_idx.plin, a, b, jt, jc, ju,
                                 j_idx.node_tbase[jn], mode="weight")
    port = kf.fused_walk_step(t_idx, *map(torch.from_numpy,
                                          (nodes, times, code, u)),
                              "weight", SchedulerConfig(tile_walks=BTW,
                                                        tile_edges=BTE))
    for k in (pallas.k, oracle[0], port.k):
        np.testing.assert_array_equal(np.asarray(k), want_k)
    # the port's own cutoff agrees with the region used above
    ta, tb = node_range(t_idx, torch.from_numpy(nodes))
    assert int(temporal_cutoff(t_idx, ta, tb, torch.from_numpy(times))[0]) \
        == 17 and int(tb[0]) == 20
