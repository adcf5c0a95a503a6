"""The port's temporal node2vec (second-order bias by rejection) against
the JAX reference's, mirroring tests/test_node2vec_law.py.

* ``node2vec_beta``/``node2vec_max_beta`` and their lane forms, and
  ``adjacency_contains``, equal to the reference's on random probes.
* Config node2vec walks (3 biases, fullwalk and grouped, both regroups,
  two start modes) byte-equal to the reference's.
* Second-order lanes: ``generate_walk_lanes(..., second_order=True)``
  byte-equal to the reference's on fullwalk and grouped, with mixed
  (p, q), first-order lanes beside them, padding lanes, and table-coded
  lanes when ``tables=`` is given; ``buffers=`` writes in place.
* The per-lane rejection scan against the dense oracle
  ``kernels.ref.node2vec_step_ref`` fed the same uniforms.
* The law: hop-2 frequencies on a controlled graph match the closed form
  of the R-round rejection sampler on both paths, which agree bitwise;
  hops with no history follow the first-order law.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core import alias as ja
from repro.core import samplers as js
from repro.core import walk_engine as jwe
from repro.core.edge_store import store_from_arrays as j_store_from_arrays
from repro.core.temporal_index import adjacency_contains as j_adjacency
from repro.core.temporal_index import build_index as j_build_index
from repro.data.synthetic import powerlaw_temporal_graph
from repro.kernels.ref import node2vec_step_ref
from repro_torch import interop
from repro_torch.configs import base as tcfg
from repro_torch.core import alias as ta
from repro_torch.core import samplers as ts
from repro_torch.core import walk_engine as twe
from repro_torch.core.edge_store import store_from_arrays
from repro_torch.core.temporal_index import (adjacency_contains, build_index,
                                             node_range, temporal_cutoff)
from tests.test_samplers import chi2_crit

N, E = 96, 2048
BIASES = ("uniform", "linear", "exponential")
PQ = ((0.5, 2.0), (2.0, 0.25), (1.0, 3.0))


def _indexes(src, dst, ts_, ec=E, nc=N):
    j = j_build_index(j_store_from_arrays(src, dst, ts_, edge_capacity=ec,
                                          node_capacity=nc), nc)
    t = build_index(store_from_arrays(src, dst, ts_, ec, nc, device="cpu"),
                    nc)
    return j, t


@pytest.fixture(scope="module")
def indexes():
    g = powerlaw_temporal_graph(N - 6, E - 300, seed=21, t_max=3000)
    return _indexes(g.src, g.dst, g.ts)


def _same(ref, got, what=""):
    for f in ("nodes", "times", "lengths"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f"{what} {f}")


def test_beta_and_adjacency_match_reference(indexes):
    j_idx, t_idx = indexes
    rng = np.random.default_rng(0)
    W = 4096
    prev = rng.integers(-1, N, W).astype(np.int32)
    cand = np.where(rng.uniform(size=W) < 0.3, prev,
                    rng.integers(0, N, W)).astype(np.int32)
    np.testing.assert_array_equal(
        adjacency_contains(t_idx, torch.as_tensor(prev),
                           torch.as_tensor(cand)).numpy(),
        np.asarray(j_adjacency(j_idx, jnp.asarray(prev), jnp.asarray(cand))))
    for p, q in PQ + ((0.3, 0.7),):
        np.testing.assert_array_equal(
            ts.node2vec_beta(t_idx, torch.as_tensor(prev),
                             torch.as_tensor(cand), p, q).numpy(),
            np.asarray(js.node2vec_beta(j_idx, jnp.asarray(prev),
                                        jnp.asarray(cand), p, q)))
        assert ts.node2vec_max_beta(p, q) == js.node2vec_max_beta(p, q)
    pl = rng.choice([0.3, 0.5, 1.0, 2.0, 7.0], W).astype(np.float32)
    ql = rng.choice([0.25, 1.0, 3.0, 0.7], W).astype(np.float32)
    np.testing.assert_array_equal(
        ts.node2vec_beta_lanes(t_idx, torch.as_tensor(prev),
                               torch.as_tensor(cand), torch.as_tensor(pl),
                               torch.as_tensor(ql)).numpy(),
        np.asarray(js.node2vec_beta_lanes(j_idx, jnp.asarray(prev),
                                          jnp.asarray(cand), jnp.asarray(pl),
                                          jnp.asarray(ql))))
    np.testing.assert_array_equal(
        ts.node2vec_max_beta_lanes(torch.as_tensor(pl),
                                   torch.as_tensor(ql)).numpy(),
        np.asarray(js.node2vec_max_beta_lanes(jnp.asarray(pl),
                                              jnp.asarray(ql))))


@pytest.mark.parametrize("path", ["fullwalk", "grouped"])
@pytest.mark.parametrize("bias", BIASES)
def test_config_node2vec_walks_match_reference(indexes, bias, path):
    j_idx, t_idx = indexes
    key = jax.random.PRNGKey(2)
    for (p, q), regroup, start_mode in (
            (PQ[0], "bucket", "nodes"), (PQ[1], "lexsort", "edges"),
            (PQ[2], "bucket", "all_nodes")):
        wc = dict(num_walks=256, max_length=7, start_mode=start_mode)
        sc = dict(mode="index", bias=bias, node2vec_p=p, node2vec_q=q)
        ref = jwe.generate_walks(j_idx, key, jcfg.WalkConfig(**wc),
                                 jcfg.SamplerConfig(**sc),
                                 jcfg.SchedulerConfig(path=path,
                                                      regroup=regroup))
        got = twe.generate_walks(t_idx, interop.key_from_words(key),
                                 tcfg.WalkConfig(**wc),
                                 tcfg.SamplerConfig(**sc),
                                 tcfg.SchedulerConfig(path=path,
                                                      regroup=regroup))
        _same(ref, got, f"{regroup} {start_mode}")
        assert int(got.lengths.max()) > 3


def _ref_lanes(W=64, seed=0, codes=3):
    """52 live lanes of mixed codes, lengths, seeds and (p, q) — a third
    of them first-order (1, 1) — then 12 padding lanes."""
    rng = np.random.default_rng(seed)
    live = np.arange(W) < 52
    menu = np.array([[1.0, 1.0], *PQ], np.float32)
    pq = menu[rng.integers(0, len(menu), W)]
    pq[~live] = 1.0
    return jwe.LaneParams(
        start_node=jnp.asarray(np.where(live, rng.integers(0, N, W), 0)
                               .astype(np.int32)),
        bias=jnp.asarray(rng.integers(0, codes, W).astype(np.int32)),
        start_bias=jnp.asarray(rng.integers(0, 3, W).astype(np.int32)),
        max_len=jnp.asarray(np.where(live, rng.integers(1, 9, W), 0)
                            .astype(np.int32)),
        rid=jnp.asarray(np.where(live, rng.integers(-50, 50, W), 0)
                        .astype(np.int32)),
        wid=jnp.asarray((np.arange(W) % 5).astype(np.int32)),
        active=jnp.asarray(live),
        n2v_p=jnp.asarray(pq[:, 0]), n2v_q=jnp.asarray(pq[:, 1]))


@pytest.mark.parametrize("path", ["fullwalk", "grouped"])
@pytest.mark.parametrize("start_mode", ["nodes", "edges"])
def test_second_order_lanes_match_reference(indexes, start_mode, path):
    j_idx, t_idx = indexes
    key = jax.random.PRNGKey(4)
    lanes = _ref_lanes()
    for regroup in ("bucket", "lexsort"):
        wc = dict(num_walks=64, max_length=8, start_mode=start_mode)
        sched = dict(path=path, regroup=regroup)
        ref = jwe.generate_walk_lanes(
            j_idx, key, lanes, jcfg.WalkConfig(**wc),
            jcfg.SamplerConfig(mode="index"), jcfg.SchedulerConfig(**sched),
            second_order=True)
        bufs = twe.alloc_walk_buffers(tcfg.WalkConfig(**wc), device="cpu")
        got = twe.generate_walk_lanes(
            t_idx, interop.key_from_words(key),
            interop.lanes_from_ref(lanes, device="cpu"),
            tcfg.WalkConfig(**wc), tcfg.SamplerConfig(mode="index"),
            tcfg.SchedulerConfig(**sched), buffers=bufs, second_order=True)
        _same(ref, got, regroup)
        assert got.nodes.data_ptr() == bufs.nodes.data_ptr()
    # the second-order program leaves first-order lanes as they were
    plain = twe.generate_walk_lanes(
        t_idx, interop.key_from_words(key),
        interop.lanes_from_ref(lanes, device="cpu"), tcfg.WalkConfig(**wc),
        tcfg.SamplerConfig(mode="index"), tcfg.SchedulerConfig(**sched))
    first = (np.asarray(lanes.n2v_p) == 1) & (np.asarray(lanes.n2v_q) == 1)
    np.testing.assert_array_equal(plain.nodes.numpy()[first],
                                  got.nodes.numpy()[first])
    assert not np.array_equal(plain.nodes.numpy()[~first],
                              got.nodes.numpy()[~first])


@pytest.mark.parametrize("path", ["fullwalk", "grouped"])
def test_table_coded_second_order_lanes_match_reference(indexes, path):
    """Lanes coded "table" (uniform table weights) beside closed-form
    ones, with and without second-order (p, q), over ``tables=``."""
    j_idx, t_idx = indexes
    j_tab = ja.build_tables(j_idx, ja.TableSpec(weight=ja.weight_uniform))
    t_tab = ta.build_tables(t_idx, ta.TableSpec(weight=ta.weight_uniform))
    for f in ("thresh", "partner", "ptab", "rebuilt"):
        np.testing.assert_array_equal(getattr(t_tab, f).numpy(),
                                      np.asarray(getattr(j_tab, f)))
    key = jax.random.PRNGKey(6)
    lanes = _ref_lanes(seed=3, codes=4)
    assert (np.asarray(lanes.bias) == 3).any()
    wc = dict(num_walks=64, max_length=8, start_mode="nodes")
    for second_order in (False, True):
        ref = jwe.generate_walk_lanes(
            j_idx, key, lanes, jcfg.WalkConfig(**wc),
            jcfg.SamplerConfig(mode="index"),
            jcfg.SchedulerConfig(path=path), tables=j_tab,
            second_order=second_order)
        got = twe.generate_walk_lanes(
            t_idx, interop.key_from_words(key),
            interop.lanes_from_ref(lanes, device="cpu"),
            tcfg.WalkConfig(**wc), tcfg.SamplerConfig(mode="index"),
            tcfg.SchedulerConfig(path=path), tables=t_tab,
            second_order=second_order)
        _same(ref, got, f"second_order={second_order}")


def test_lane_rejection_matches_oracle_per_u(indexes):
    """``_lane_second_order`` against the dense oracle fed the same
    proposal and accept uniforms: equal accepted picks on node2vec lanes,
    the plain pick kept on (1, 1) lanes, round 0 on no-history lanes."""
    j_idx, t_idx = indexes
    rng = np.random.default_rng(42)
    W, R = 512, twe.N2V_ROUNDS
    cur = torch.as_tensor(rng.integers(0, N, W).astype(np.int32))
    a, b = node_range(t_idx, cur)
    c = temporal_cutoff(t_idx, a, b, torch.as_tensor(
        rng.integers(0, 3000, W).astype(np.int32)))
    prev = rng.integers(0, N, W).astype(np.int32)
    prev[rng.uniform(size=W) < 0.3] = -1
    menu = np.array([[1.0, 1.0], [0.5, 2.0], [4.0, 0.25], [1.0, 3.0]],
                    np.float32)
    pq = menu[rng.integers(0, len(menu), W)]
    p, q = torch.as_tensor(pq[:, 0]), torch.as_tensor(pq[:, 1])
    us2 = torch.as_tensor(rng.uniform(size=(R, 2, W)).astype(np.float32))
    n = b - c
    k_plain = c + ts.index_uniform(torch.as_tensor(
        rng.uniform(size=W).astype(np.float32)), n)
    code = torch.zeros(W, dtype=torch.int32)
    k = twe._lane_second_order(t_idx, tcfg.SamplerConfig(), None, code, a,
                               c, b, torch.as_tensor(prev), k_plain,
                               (p, q, us2)).numpy()
    ks = np.stack([(c + ts.index_uniform(us2[r, 0], n)).numpy()
                   for r in range(R)])
    valid = jnp.arange(E) < j_idx.num_edges
    k_ref = np.asarray(node2vec_step_ref(
        j_idx.ns_src, j_idx.ns_dst, valid, jnp.asarray(prev),
        jnp.asarray(ks), jnp.asarray(us2[:, 1].numpy()), jnp.asarray(pq[:, 0]),
        jnp.asarray(pq[:, 1])))
    is_n2v = (pq[:, 0] != 1) | (pq[:, 1] != 1)
    live = (n > 0).numpy()
    assert (is_n2v & live).sum() > 100 and (~is_n2v & live).any()
    np.testing.assert_array_equal(k[is_n2v & live], k_ref[is_n2v & live])
    np.testing.assert_array_equal(k[~is_n2v], k_plain.numpy()[~is_n2v])
    nohist = is_n2v & (prev < 0) & live
    assert nohist.any()
    np.testing.assert_array_equal(k[nohist], ks[0][nohist])


def _rejection_law(pi, beta, p, q):
    """Closed-form law of the R-round rejection sampler
    (tests/test_node2vec_law.py)."""
    beta_max = ts.node2vec_max_beta(p, q)
    alpha = pi * beta / beta_max
    A = alpha.sum()
    r = 1.0 - A
    R = twe.N2V_ROUNDS
    return alpha * (1.0 - r ** R) / A + pi * (1.0 - beta / beta_max) \
        * r ** (R - 1)


@pytest.mark.statistical
def test_second_order_law_exact():
    """Node 1's hop-2 neighbourhood (prev = 0) holds one return, one
    common and one far candidate: frequencies match the closed form on
    both paths, the paths agree bitwise and equal the reference."""
    j_idx, t_idx = _indexes([0, 0, 1, 1, 1], [1, 2, 0, 2, 3],
                            [10, 5, 11, 12, 13], ec=64, nc=4)
    p, q = 0.5, 2.0
    wc = dict(num_walks=32_768, max_length=3, start_mode="all_nodes")
    sc = dict(mode="index", bias="uniform", node2vec_p=p, node2vec_q=q)
    key = jax.random.PRNGKey(11)
    per_path = {}
    for path in ("fullwalk", "grouped"):
        per_path[path] = twe.generate_walks(
            t_idx, interop.key_from_words(key), tcfg.WalkConfig(**wc),
            tcfg.SamplerConfig(**sc), tcfg.SchedulerConfig(path=path))
    _same(jwe.generate_walks(j_idx, key, jcfg.WalkConfig(**wc),
                             jcfg.SamplerConfig(**sc),
                             jcfg.SchedulerConfig(path="grouped")),
          per_path["grouped"])
    for f in ("nodes", "lengths"):
        assert torch.equal(getattr(per_path["fullwalk"], f),
                           getattr(per_path["grouped"], f))
    nodes = per_path["fullwalk"].nodes.numpy()
    lens = per_path["fullwalk"].lengths.numpy()
    cond = (nodes[:, 0] == 0) & (lens >= 3) & (nodes[:, 1] == 1)
    hops = nodes[cond, 2]
    assert cond.sum() > 2000 and set(np.unique(hops).tolist()) <= {0, 2, 3}
    law = _rejection_law(np.full(3, 1 / 3), np.array([1 / p, 1.0, 1 / q]),
                         p, q)
    counts = np.array([(hops == w).sum() for w in (0, 2, 3)], np.float64)
    expect = law * cond.sum()
    chi2 = np.sum((counts - expect) ** 2 / expect)
    assert chi2 < chi2_crit(2), (chi2, counts, expect)


@pytest.mark.statistical
def test_second_order_law_no_history_is_first_order():
    _, t_idx = _indexes([0] * 4, [1, 2, 3, 4], [10, 11, 12, 13], ec=64,
                        nc=8)
    res = twe.generate_walks(
        t_idx, interop.key_from_words(jax.random.PRNGKey(12)),
        tcfg.WalkConfig(num_walks=65_536, max_length=2,
                        start_mode="all_nodes"),
        tcfg.SamplerConfig(mode="index", bias="uniform", node2vec_p=0.25,
                           node2vec_q=4.0),
        tcfg.SchedulerConfig(path="fullwalk"))
    nodes = res.nodes.numpy()
    hops = nodes[nodes[:, 0] == 0, 1]
    counts = np.array([(hops == w).sum() for w in (1, 2, 3, 4)], np.float64)
    expect = np.full(4, len(hops) / 4)
    chi2 = np.sum((counts - expect) ** 2 / expect)
    assert chi2 < chi2_crit(3), (chi2, counts)
