"""Port edge store, dual index and weight_prefix vs the JAX reference.

Integer arrays are byte-equal. The float prefixes are cumulative sums
whose summation order differs by backend, so they are held to the
tolerance of tests/test_kernels.py (rtol 1e-5, atol 1e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import edge_store as j_es
from repro.core import temporal_index as j_ti
from repro.data.synthetic import powerlaw_temporal_graph
from repro.kernels.ref import weight_prefix_ref
from repro.kernels.weight_prefix import weight_prefix as j_weight_prefix
from repro_torch.core import edge_store as es
from repro_torch.core import temporal_index as ti
from repro_torch.kernels import runtime
from repro_torch.kernels.weight_prefix import (TOL_U, error_in_u,
                                               weight_prefix,
                                               weight_prefix_plain)

RTOL, ATOL = 1e-5, 1e-4
FLOATS = ("pexp", "plin", "pexp_store", "plin_store")


def _graph(kind: str):
    if kind == "powerlaw":
        g = powerlaw_temporal_graph(200, 3000, seed=1)
        return g.src, g.dst, g.ts, 4096, 256
    if kind == "hub":
        g = powerlaw_temporal_graph(64, 8000, skew=2.0, seed=3)
        return g.src, g.dst, g.ts, 8192, 64
    if kind == "ties":
        g = powerlaw_temporal_graph(50, 1500, seed=4, ts_groups=20)
        return g.src, g.dst, g.ts, 2048, 64
    if kind == "negative_ts":
        rng = np.random.default_rng(5)
        n = 700
        return (rng.integers(0, 30, n), rng.integers(0, 30, n),
                rng.integers(-500, 500, n), 1024, 32)
    if kind == "empty":
        return [], [], [], 512, 8
    raise ValueError(kind)


KINDS = ["powerlaw", "hub", "ties", "negative_ts", "empty"]


@pytest.mark.parametrize("kind", KINDS)
def test_store_from_arrays_byte_equal(kind):
    src, dst, ts, E, N = _graph(kind)
    want = j_es.store_from_arrays(src, dst, ts, edge_capacity=E,
                                  node_capacity=N)
    got = es.store_from_arrays(src, dst, ts, E, N, device="cpu")
    for f in es.EdgeStore._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.dtype == np.int32, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("kind", KINDS)
def test_build_index_matches_reference(kind):
    src, dst, ts, E, N = _graph(kind)
    want = j_ti.build_index(j_es.store_from_arrays(
        src, dst, ts, edge_capacity=E, node_capacity=N), N)
    got = ti.build_index(es.store_from_arrays(src, dst, ts, E, N,
                                              device="cpu"), N)
    for f in ti.TemporalIndex._fields:
        if f == "store":
            continue
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, f
        if f in FLOATS:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("scale", [1.0, 0.01])
def test_build_index_bias_scale(scale):
    src, dst, ts, E, N = _graph("powerlaw")
    want = j_ti.build_index(j_es.store_from_arrays(
        src, dst, ts, edge_capacity=E, node_capacity=N), N, scale)
    got = ti.build_index(es.store_from_arrays(src, dst, ts, E, N,
                                              device="cpu"), N, scale)
    for f in ("pexp", "pexp_store"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


@pytest.mark.parametrize("seed,E", [(0, 1024), (1, 2048), (2, 4096)])
def test_weight_prefix_plain_matches_reference(seed, E):
    """CPU tensors take the plain version; it equals the Pallas kernel (in
    interpret mode) and weight_prefix_ref to the stated tolerance."""
    rng = np.random.default_rng(seed)
    dt = -rng.exponential(3.0, size=E).astype(np.float32)
    valid = rng.uniform(size=E) < 0.8
    before = dict(runtime.LAUNCHES)
    got = weight_prefix(torch.from_numpy(dt), torch.from_numpy(valid))
    assert runtime.LAUNCHES == before
    assert got.shape == (E + 1,) and got.dtype == torch.float32
    pallas = np.asarray(j_weight_prefix(jnp.asarray(dt), jnp.asarray(valid),
                                        interpret=True))
    ref = np.asarray(weight_prefix_ref(jnp.asarray(dt), jnp.asarray(valid)))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    assert got[0].item() == 0.0


@pytest.mark.parametrize("strict", [True, False])
def test_ranged_search_and_cutoff_match_reference(strict):
    src, dst, ts, E, N = _graph("ties")
    j_idx = j_ti.build_index(j_es.store_from_arrays(
        src, dst, ts, edge_capacity=E, node_capacity=N), N)
    t_idx = ti.build_index(es.store_from_arrays(src, dst, ts, E, N,
                                                device="cpu"), N)
    rng = np.random.default_rng(9)
    nodes = rng.integers(-2, N + 3, 300).astype(np.int32)
    times = rng.integers(-100, 11_000, 300).astype(np.int32)
    ja, jb = j_ti.node_range(j_idx, jnp.asarray(nodes))
    ta, tb = ti.node_range(t_idx, torch.from_numpy(nodes))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    want = j_ti.ranged_search(j_idx.ns_ts, ja, jb, jnp.asarray(times),
                              strict=strict)
    got = ti.ranged_search(t_idx.ns_ts, ta, tb, torch.from_numpy(times),
                           strict=strict)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ti.temporal_cutoff(t_idx, ta, tb, torch.from_numpy(times)).numpy(),
        np.asarray(j_ti.temporal_cutoff(j_idx, ja, jb, jnp.asarray(times))))


def test_batches_byte_equal():
    rng = np.random.default_rng(3)
    parts = [(rng.integers(0, 9, n), rng.integers(0, 9, n),
              rng.integers(0, 99, n)) for n in (5, 0, 12)]
    want = j_es.stack_batches(parts, 16)
    got = es.stack_batches(parts, 16, device="cpu")
    for f in es.EdgeBatch._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    wb = j_es.make_batch(*parts[0], capacity=8)
    gb = es.make_batch(*parts[0], capacity=8, device="cpu")
    for f in es.EdgeBatch._fields:
        np.testing.assert_array_equal(getattr(gb, f).numpy(),
                                      np.asarray(getattr(wb, f)))


def test_weight_prefix_error_reads_a_dropped_block():
    """``error_in_u`` holds a sound float32 scan within ``TOL_U`` of the
    plain version and reads one dropped 4096-edge block total far above
    it."""
    rng = np.random.default_rng(5)
    E = 8192 * 4
    dt = torch.from_numpy(-rng.exponential(3.0, size=E).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=E) < 0.8)
    want = weight_prefix_plain(dt, valid)
    w = torch.where(valid, torch.exp(dt), 0.0)
    sound = torch.cat([torch.zeros(1), torch.cumsum(w, 0)])
    assert error_in_u(sound, want) <= TOL_U
    dropped = want.clone()
    dropped[3 * 4096 + 1:] -= w[2 * 4096:3 * 4096].sum()
    assert error_in_u(dropped, want) > 100 * TOL_U
