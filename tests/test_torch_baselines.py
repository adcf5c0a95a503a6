"""The port's host baselines (repro_torch/core/baselines.py) against the
JAX package's, in one process: given a ``np.random.Generator`` in the
same state, ``build_alias``, ``TeaStyleSampler`` (uniform, linear and
exponential bias, with and without node2vec β) and ``StaticWalker`` emit
the reference's tables and walks exactly and leave the generator in the
same state; ``temporal_validity`` gives the reference's verdicts."""
import numpy as np
import pytest

from repro.core import baselines as jb
from repro.data.synthetic import powerlaw_temporal_graph
from repro_torch.core import baselines as tb

N = 128


@pytest.fixture(scope="module")
def graph():
    return powerlaw_temporal_graph(N, 2000, seed=6, t_max=500)


def test_build_alias_matches_reference():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 64):
        probs = rng.exponential(size=n)
        for got, want in zip(tb.build_alias(probs), jb.build_alias(probs)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bias", ["uniform", "linear", "exponential"])
@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.5, 2.0)])
def test_tea_walks_match_reference(graph, bias, p, q):
    g = graph
    ref = jb.TeaStyleSampler(g.src, g.dst, g.ts, N, bias=bias)
    got = tb.TeaStyleSampler(g.src, g.dst, g.ts, N, bias=bias)
    for v in ref.alias:
        for a, b in zip(got.alias[v], ref.alias[v]):
            np.testing.assert_array_equal(a, b)
    assert got.alias.keys() == ref.alias.keys()
    rj, rt = np.random.default_rng(1), np.random.default_rng(1)
    starts = np.random.default_rng(2).integers(0, N, 40)
    for i, v in enumerate(starts):
        t0 = -1 if i % 2 else int(g.ts[i * 40])
        want = ref.walk(int(v), t0, 12, rj, p=p, q=q)
        assert got.walk(int(v), t0, 12, rt, p=p, q=q) == want
        assert tb.temporal_validity(*want) == jb.temporal_validity(*want)
    assert rt.random() == rj.random()


def test_static_walker_and_validity_match_reference(graph):
    g = graph
    ref = jb.StaticWalker(g.src, g.dst, g.ts, N)
    got = tb.StaticWalker(g.src, g.dst, g.ts, N)
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    invalid = 0
    for v in np.random.default_rng(4).integers(0, N, 60):
        nodes, times = ref.walk(int(v), 10, rj)
        assert got.walk(int(v), 10, rt) == (nodes, times)
        verdict = tb.temporal_validity(nodes, times)
        assert verdict == jb.temporal_validity(nodes, times)
        invalid += not verdict[2]
    assert invalid > 0               # time-agnostic walks break causality
    assert tb.temporal_validity([3], []) == jb.temporal_validity([3], [])
