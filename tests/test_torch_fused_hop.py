"""The one-launch fused hop (csrc/fused_step.cu, ``fused_hop``), on the CPU.

The card kernel cannot run here. Two things are checked instead:

* ``fused_walk_step`` on CPU tensors (``tier_split`` + ``fused_step_plain``)
  equals the reference's ``fused_walk_step`` (Pallas, interpret mode),
  ``tiers`` included, on crafted tiles that mix tier-S and tier-L lanes,
  exact-fit regions (``hi == 2·TE``) and dead lanes (empty regions, and
  times at or past a region's last timestamp), and on power-law graphs
  whose lanes cluster at hubs as real walks do.
* A numpy model of the kernel's own arithmetic, step by step as the CUDA
  source takes it: per tile the anchor, the tier split, the one-load test
  for n > 0, the staged span of live tier-S lanes (16-byte widened bulk
  part plus thread-loaded tail rows) with tier-S searches and counts read
  only from that span, tier-L lanes' binary searches in global memory for
  the cutoff and the exponential pick, and the per-tile ``tiers`` sums.
  The model must equal the plain version on every lane, and its binary
  searches must equal the plain counts on ascending arrays with ties.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SchedulerConfig as JSchedulerConfig
from repro.core.edge_store import store_from_arrays as j_store_from_arrays
from repro.core.temporal_index import build_index as j_build_index
from repro.data.synthetic import powerlaw_temporal_graph
from repro.kernels.fused_step import fused_walk_step as j_fused_walk_step
from repro_torch import interop
from repro_torch.configs.base import SchedulerConfig
from repro_torch.core.edge_store import store_from_arrays
from repro_torch.core.samplers import index_pick_lanes
from repro_torch.core.temporal_index import build_index
from repro_torch.kernels import fused_step as kf

from test_tile_boundary import _make_index as _boundary_index

F = np.float32


# ---------------------------------------------------------------------------
# Lanes
# ---------------------------------------------------------------------------


def _hub_lanes(node_starts, ns_ts, W, seed, dead_share=0.3):
    """W node-sorted lanes drawn in proportion to out-degree (so hubs hold
    runs of lanes, as on a real hop), a few on empty nodes, and about
    ``dead_share`` of them at or past their region's last timestamp."""
    rng = np.random.default_rng(seed)
    nc = node_starts.shape[0] - 2
    deg = np.diff(node_starts[:nc + 1]).astype(np.float64)
    p = (deg + 0.05) / (deg + 0.05).sum()
    nodes = np.sort(rng.choice(nc, size=W, p=p)).astype(np.int32)
    a, b = node_starts[nodes], node_starts[nodes + 1]
    first = np.where(b > a, ns_ts[np.minimum(a, len(ns_ts) - 1)], 0)
    last = np.where(b > a, ns_ts[np.maximum(b - 1, 0)], 0)
    frac = rng.uniform(size=W)
    times = (first - 1 + frac * (last - first + 2)).astype(np.int64)
    dead = rng.uniform(size=W) < dead_share
    times = np.where(dead, last + rng.integers(0, 3, W), times)
    u = rng.uniform(size=W).astype(np.float32)
    code = rng.integers(0, 3, W).astype(np.int32)
    return nodes, times.astype(np.int32), u, code


def _graph(N, num_edges, seed):
    g = powerlaw_temporal_graph(N, num_edges, seed=seed)
    return g.src % N, g.dst % N, g.ts


# ---------------------------------------------------------------------------
# fused_walk_step (CPU) against the reference
# ---------------------------------------------------------------------------


def _assert_equals_reference(j_idx, nodes, times, u, code, mode, TW, TE):
    t_idx = interop.index_from_ref(j_idx, device="cpu")
    want = j_fused_walk_step(
        j_idx, *map(jnp.asarray, (nodes, times, code, u)), mode,
        JSchedulerConfig(path="fused", tile_walks=TW, tile_edges=TE),
        interpret=True)
    got = kf.fused_walk_step(
        t_idx, *map(torch.from_numpy, (nodes, times, code, u)), mode,
        SchedulerConfig(path="fused", tile_walks=TW, tile_edges=TE))
    for name, g, w in zip(("k", "n", "dst", "ts", "tiers"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"{mode}/{name}")
    return got


# (node, time) per lane, TW = 4, on the boundary graph (E = 64, TE = 8):
# node 0 [0, 16) ts 0..30, 1 empty at 16, 2 [16, 20), 3 [20, 40) ts
# 300..338, 4 [40, 48), 5 [48, 64) ts 500..530, 6 and 7 empty at E.
_MIXED_TILES = [
    # exact fit (hi == 2·TE) live and dead, hub live and dead
    [(0, -1), (0, 30), (3, 305), (3, 400)],
    # empty region, small in-tile, hub crossing the panel, region past it
    [(1, 0), (2, 203), (3, 299), (5, 515)],
    # in-tile, a hub to the store's end, an empty region at E (tier L)
    [(4, 410), (5, 499), (5, 531), (7, 0)],
    # exact fit at the store's end, empty regions at E that fit
    [(5, 501), (5, 530), (6, 0), (7, 999)],
]


@pytest.mark.parametrize("mode", ["index", "weight"])
def test_mixed_tiles_match_reference(mode):
    """Tiles that mix both tiers, exact-fit and dead lanes: outputs and
    ``tiers`` equal the reference's."""
    lanes = [x for tile in _MIXED_TILES for x in tile]
    nodes = np.asarray([v for v, _ in lanes], np.int32)
    times = np.asarray([t for _, t in lanes], np.int32)
    rng = np.random.default_rng(5)
    u = rng.uniform(size=len(lanes)).astype(np.float32)
    code = (np.arange(len(lanes)) % 3).astype(np.int32)
    got = _assert_equals_reference(_boundary_index(), nodes, times, u, code,
                                   mode, 4, 8)
    n = got.n.numpy()
    assert (n == 0).sum() >= 6 and (n > 0).sum() >= 6
    tiers = got.tiers.numpy()
    assert tiers[0] > 0 and tiers[1] > 0 and tiers[2] > 0


@pytest.mark.parametrize("mode", ["index", "weight"])
@pytest.mark.parametrize("seed,N,num_edges,W,TW,TE", [
    (21, 64, 1900, 256, 32, 64),
    (22, 256, 3900, 512, 128, 128),
    (23, 32, 1000, 128, 64, 256),
])
def test_hub_lanes_match_reference(mode, seed, N, num_edges, W, TW, TE):
    """Lanes clustered at hubs, a third of them dead."""
    E = 4096 if num_edges > 2000 else 2048
    src, dst, ts = _graph(N, num_edges, seed)
    j_idx = j_build_index(j_store_from_arrays(
        src, dst, ts, edge_capacity=E, node_capacity=N), N)
    lanes = _hub_lanes(np.asarray(j_idx.node_starts), np.asarray(j_idx.ns_ts),
                       W, seed)
    got = _assert_equals_reference(j_idx, *lanes, mode, TW, TE)
    assert int(got.tiers[1]) > 0 and bool((got.n == 0).any())


# ---------------------------------------------------------------------------
# numpy model of csrc/fused_step.cu
# ---------------------------------------------------------------------------


def upper_bound(pred, lo, hi):
    """upper_bound of samplers.cuh, and the lower-bound search of
    weight_pick<true>: first j in [lo, hi) with pred(j), hi if none, for a
    pred that reads false then true over [lo, hi)."""
    while lo < hi:
        mid = lo + ((hi - lo) >> 1)
        if pred(mid):
            hi = mid
        else:
            lo = mid + 1
    return lo


def bulk_end(end, length):
    return min((end + 3) & ~3, length & ~3)


class Span:
    """Rows [lo, hi) of a global array, as staged in shared memory; reading
    any other row fails."""

    def __init__(self, arr, lo, hi):
        self.arr, self.lo, self.hi = arr, lo, hi

    def __getitem__(self, g):
        assert self.lo <= g < self.hi, f"row {g} not staged [{self.lo}, " \
                                       f"{self.hi})"
        return self.arr[g]


def wrap_i32(x):
    return (int(x) + (1 << 31)) % (1 << 32) - (1 << 31)


def index_uniform(u, n):
    i = int(np.floor(F(u) * F(n)))
    return min(max(i, 0), max(n - 1, 0))


def weight_pick(pe, pl, ts, c, hi, u, code, tbase, exp_search=None):
    """weight_pick of samplers.cuh over [c, hi); ``exp_search(target)``
    replaces the exponential count by weight_pick<true>'s binary search."""
    n = hi - c
    k = c + index_uniform(u, n)
    if code == 1:
        delta = F(wrap_i32(ts[c] - tbase))
        pl_c = pl[c]
        total = F(F(pl[hi] - pl_c) - F(F(n) * delta))
        if total > 0:
            r = F(F(u) * total)
            k = c + sum(F(F(pl[j + 1] - pl_c) - F(F(j + 1 - c) * delta)) < r
                        for j in range(c, hi))
    elif code != 0:
        pe_c = pe[c]
        total = F(pe[hi] - pe_c)
        if total > 0:
            target = F(pe_c + F(F(u) * total))
            if exp_search is None:
                k = c + sum(pe[j + 1] < target for j in range(c, hi))
            else:
                k = exp_search(target)
    return min(max(k, c), max(hi - 1, c))


def model_fused_hop(node_starts, node_tbase, ns_ts, ns_dst, pexp, plin,
                    s_node, s_time, code, u, mode, TW, TE, log):
    """The kernel's tile loop on numpy arrays. Returns (c, n, k, dst, ts,
    tiers); c is the cutoff (k of index-mode lanes is filled in by the
    caller from the closed forms). ``log`` collects what the test checks
    was exercised."""
    E, nc, W = len(ns_ts), len(node_starts) - 2, len(s_node)
    P, MAXB = 2 * TE, E // TE
    rows = (2 * TE + 8 + 3) // 4 * 4
    weight = mode == "weight"
    c_out, n_out, k_out, d_out, t_out = (np.zeros(W, np.int64)
                                         for _ in range(5))
    tiers = [0, 0, 0]
    for t in range(W // TW):
        ids = range(t * TW, (t + 1) * TW)
        v = np.clip(s_node[t * TW:(t + 1) * TW], 0, nc)
        a, b = node_starts[v], node_starts[v + 1]
        base = min(max(int(a.min()) // TE, 0), MAXB - 2) * TE
        big = (a - base < 0) | (b - base > P)
        live = np.array([ai < bi and ns_ts[bi - 1] > s_time[i]
                         for ai, bi, i in zip(a, b, ids)], bool)
        # tiers: per tile, as the reference
        nbig = int(big.sum())
        blo = min([MAXB - 1] + [ai // TE for ai in a[big]])
        bhi = max([0] + [max(bi - 1, ai) // TE
                         for ai, bi in zip(a[big], b[big])])
        tiers[0] += TW - nbig
        tiers[1] += nbig
        tiers[2] += max(bhi, blo) - blo + 1 if nbig else 0
        # staging: rows [min a, max b) of live tier-S lanes
        small = live & ~big
        ts_buf = dst_buf = pe_buf = pl_buf = None
        if small.any():
            mn, mx = int(a[small].min()), int(b[small].max())
            assert mx - mn <= P
            g0 = mn & ~3
            rows_end, pre_end = bulk_end(mx, E), bulk_end(mx + 1, E + 1)
            assert rows_end >= g0 and (rows_end - g0) % 4 == 0
            assert mx - rows_end <= 3 and mx + 1 - pre_end <= 3
            top = max(rows_end, mx)
            top_pre = max(pre_end, mx + 1) if weight else g0
            assert max(top, top_pre) - g0 <= rows       # fits the buffer
            ts_buf, dst_buf = Span(ns_ts, g0, top), Span(ns_dst, g0, top)
            if weight:
                pe_buf = Span(pexp, g0, top_pre)
                pl_buf = Span(plin, g0, top_pre)
            log["staged"] += 1
        else:
            log["unstaged"] += 1
        for j, i in enumerate(ids):
            if not live[j]:
                n_out[i] = min(b[j] - a[j], 0)
                log["dead"] += 1
                continue
            lo, hi = int(a[j]), int(b[j])
            tb = node_tbase[min(max(s_node[i], 0), nc - 1)]
            if big[j]:
                # tier L: binary searches in global memory; live, so the
                # cutoff lies in [lo, hi - 1]
                c = upper_bound(lambda x: ns_ts[x] > s_time[i], lo, hi - 1)
                c_out[i], n_out[i] = c, hi - c
                if weight:
                    k = weight_pick(
                        pexp, plin, ns_ts, c, hi, u[i], code[i], tb,
                        exp_search=lambda tg: upper_bound(
                            lambda x: pexp[x + 1] >= tg, c, hi))
                    k_out[i], d_out[i], t_out[i] = k, ns_dst[k], ns_ts[k]
                log["tier_l"] += 1
                continue
            # tier S: binary search and picks in the staged rows only
            c = upper_bound(lambda x: ts_buf[x] > s_time[i], lo, hi)
            c_out[i], n_out[i] = c, hi - c
            if weight:
                k = weight_pick(pe_buf, pl_buf, ts_buf, c, hi, u[i], code[i],
                                tb)
                k_out[i], d_out[i], t_out[i] = k, dst_buf[k], ts_buf[k]
            log["tier_s"] += 1
    return c_out, n_out, k_out, d_out, t_out, tiers


@pytest.mark.parametrize("mode", ["index", "weight"])
@pytest.mark.parametrize("seed,N,num_edges,E,W,TW,TE,dead", [
    (31, 64, 3900, 4096, 512, 64, 128, 0.3),
    (32, 64, 1000, 1024, 256, 256, 256, 0.3),
    (33, 512, 3000, 4096, 96, 32, 256, 0.3),
    (34, 8, 2000, 2048, 40, 1, 128, 0.3),
    (31, 64, 3900, 4096, 512, 64, 128, 0.93),
    (36, 1024, 4000, 4096, 1024, 256, 128, 0.93),
])
def test_kernel_model_equals_plain(mode, seed, N, num_edges, E, W, TW, TE,
                                   dead):
    """The numpy model of fused_hop, reading tier-S rows only from its
    staged span, equals fused_step_plain on every lane and tier_split's
    ``tiers``, with a third or almost all of the lanes dead."""
    src, dst, ts = _graph(N, num_edges, seed)
    idx = build_index(store_from_arrays(src, dst, ts, E, N, device="cpu"), N)
    ns_ts, ns_dst = idx.ns_ts.numpy(), idx.ns_dst.numpy()
    pexp, plin = idx.pexp.numpy(), idx.plin.numpy()
    node_starts, node_tbase = idx.node_starts.numpy(), idx.node_tbase.numpy()
    assert bool((np.diff(pexp) >= 0).all())          # the search needs it
    nodes, times, u, code = _hub_lanes(node_starts, ns_ts, W, seed, dead)
    log = dict(staged=0, unstaged=0, dead=0, tier_s=0, tier_l=0)
    c, n, k, d, t, tiers = model_fused_hop(
        node_starts, node_tbase, ns_ts, ns_dst, pexp, plin, nodes, times,
        code, u, mode, TW, TE, log)
    if mode == "index":
        live = n > 0
        k = np.where(live, c + index_pick_lanes(
            torch.from_numpy(code), torch.from_numpy(u),
            torch.from_numpy(n.astype(np.int32))).numpy(), 0)
        d, t = np.where(live, ns_dst[k], 0), np.where(live, ns_ts[k], 0)
    want = kf.fused_walk_step(idx, *map(torch.from_numpy,
                                        (nodes, times, code, u)), mode,
                              SchedulerConfig(path="fused", tile_walks=TW,
                                              tile_edges=TE))
    for name, g, w in zip(("k", "n", "dst", "ts", "tiers"),
                          (k, n, d, t, np.asarray(tiers)), want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    assert log["dead"] > 0 and log["tier_l"] > 0 and log["tier_s"] > 0
    assert log["staged"] > 0


@pytest.mark.parametrize("n", [0, 1, 2, 33, 1000, 5000])
def test_upper_bound_equals_count(n):
    """Cutoff: the binary search over an ascending region with ties equals
    the plain count lo + #{ts <= t}, for t below, inside and above the
    region."""
    rng = np.random.default_rng(n)
    for trial in range(100):
        ts = np.sort(rng.integers(0, max(n // 3, 2), n + 8))
        lo = int(rng.integers(0, 5))
        hi = lo + n
        region = ts[lo:hi]
        for t in (-5, 10**9, *(rng.choice(region, 3) if n else ()),
                  *(rng.integers(-1, max(n // 3, 2) + 1, 3))):
            want = lo + int((region <= t).sum())
            assert want == lo + int(np.searchsorted(region, t, "right"))
            assert upper_bound(lambda j: ts[j] > t, lo, hi) == want, (n, t)


@pytest.mark.parametrize("zero_share", [0.0, 0.3, 0.9])
def test_exponential_search_equals_count(zero_share):
    """Exponential pick: over a non-decreasing float32 prefix with flat
    runs (zero weights), the lower bound of P(j+1) >= target equals the
    plain count #{P(j+1) < target}."""
    rng = np.random.default_rng(int(zero_share * 10))
    for trial in range(200):
        n = int(rng.choice([1, 2, 31, 32, 33, 500, 4000]))
        w = np.where(rng.uniform(size=n) < zero_share, 0.0,
                     rng.exponential(size=n)).astype(F)
        pe = np.concatenate([[F(0)], np.cumsum(w, dtype=F)])
        pe = np.maximum.accumulate(pe)
        c = int(rng.integers(0, n))
        for u in rng.uniform(size=4).astype(F):
            total = F(pe[n] - pe[c])
            target = F(pe[c] + F(u * total))
            want = c + int((pe[c + 1:n + 1] < target).sum())
            assert upper_bound(lambda j: pe[j + 1] >= target, c, n) == want
