"""The port's single-device streaming entry points against the reference's
(``repro.core.streaming``, ``repro.core.edge_store``), on the CPU:
``bias_scale`` on ``ingest_and_walk``/``replay_scan``/``replay_scan_probed``,
``ingest_and_walk``'s ``walk_bufs``, ``ingest_and_walk_donated`` and
``store_nbytes``. Walks, statistics, probes and every integer field are
compared byte for byte, the float prefixes to the tolerance of
tests/test_torch_window.py (rtol 1e-5, atol 1e-4).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core import edge_store as jes
from repro.core import streaming as jst
from repro.core.walk_engine import alloc_walk_buffers as j_alloc
from repro.core.window import init_window as j_init_window
from repro.data.synthetic import chronological_batches, powerlaw_temporal_graph
from repro_torch import interop
from repro_torch.configs import base as tcfg
from repro_torch.core import edge_store as tes
from repro_torch.core import streaming as tst
from repro_torch.core.walk_engine import alloc_walk_buffers as t_alloc
from repro_torch.core.window import init_window

N, E_CAP, DURATION = 96, 2048, 2500
WC = dict(num_walks=64, max_length=6)
# weight mode reads the exponential prefix, the one place bias_scale acts
SC = dict(bias="exponential", mode="weight")


def _batches():
    return list(chronological_batches(powerlaw_temporal_graph(N, 2000,
                                                              seed=13), 4))


def _args(pkg):
    return (N, pkg.WalkConfig(**WC), pkg.SamplerConfig(**SC),
            pkg.SchedulerConfig())


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _prefixes_close(t_index, j_index):
    for f in ("pexp", "pexp_store", "plin", "plin_store"):
        np.testing.assert_allclose(getattr(t_index, f).numpy(),
                                   np.asarray(getattr(j_index, f)),
                                   rtol=1e-5, atol=1e-4, err_msg=f)


def _walks_equal(t, j):
    for f in ("nodes", "times", "lengths"):
        _equal(getattr(t, f), getattr(j, f))


def test_store_nbytes_matches_reference():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, N, (2, 300)).astype(np.int32)
    ts = rng.integers(0, 1000, 300).astype(np.int32)
    for cap in (512, 4096):
        want = jes.store_nbytes(jes.store_from_arrays(src, dst, ts, cap, N))
        got = tes.store_nbytes(tes.store_from_arrays(src, dst, ts, cap, N,
                                                     device="cpu"))
        assert got == want == 3 * 4 * cap


@pytest.mark.parametrize("probed", [False, True])
def test_replay_at_half_bias_scale_matches_reference(probed):
    """A replay at ``bias_scale=0.5`` is byte-equal to the reference's, and
    differs from one at 1.0, so the scale reached the index."""
    batches = _batches()
    key = jax.random.PRNGKey(5)
    jscan = jst.replay_scan_probed if probed else jst.replay_scan
    tscan = tst.replay_scan_probed if probed else tst.replay_scan
    outs = {}
    for scale in (0.5, 1.0):
        j_out = jscan(j_init_window(E_CAP, N, DURATION),
                      jes.stack_batches(batches, 512), key, *_args(jcfg),
                      bias_scale=scale)
        t_out = tscan(init_window(E_CAP, N, DURATION, device="cpu"),
                      tes.stack_batches(batches, 512, device="cpu"),
                      interop.key_from_words(key), *_args(tcfg),
                      bias_scale=scale)
        _prefixes_close(t_out[0].index, j_out[0].index)
        for got, want in zip(t_out[1], j_out[1]):
            _equal(got, want)
        _walks_equal(t_out[2], j_out[2])
        if probed:
            _equal(t_out[3], j_out[3])
        outs[scale] = t_out
    assert not torch.equal(outs[0.5][0].index.pexp, outs[1.0][0].index.pexp)
    assert not torch.equal(outs[0.5][2].nodes, outs[1.0][2].nodes)


def test_ingest_and_walk_with_buffers_and_donated_match_reference():
    """``ingest_and_walk(walk_bufs=)`` writes into the buffers given and
    ``ingest_and_walk_donated`` chains them batch to batch, both equal to
    the reference's at ``bias_scale=0.5``."""
    batches = _batches()
    key = jax.random.PRNGKey(7)
    j_state = j_init_window(E_CAP, N, DURATION)
    t_state = init_window(E_CAP, N, DURATION, device="cpu")
    j_bufs = j_alloc(jcfg.WalkConfig(**WC))
    t_bufs = t_alloc(tcfg.WalkConfig(**WC), "cpu")
    for i, (src, dst, ts) in enumerate(batches):
        key, sub = jax.random.split(key)
        jb = jes.make_batch(src, dst, ts, 512)
        tb = tes.make_batch(src, dst, ts, 512, device="cpu")
        tkey = interop.key_from_words(sub)
        if i % 2 == 0:
            j_state, j_res = jst.ingest_and_walk(
                j_state, jb, sub, *_args(jcfg), bias_scale=0.5,
                walk_bufs=j_bufs)
            t_state, t_res = tst.ingest_and_walk(
                t_state, tb, tkey, *_args(tcfg), bias_scale=0.5,
                walk_bufs=t_bufs)
        else:
            j_state, j_res = jst.ingest_and_walk_donated(
                j_state, jb, j_bufs, sub, *_args(jcfg), bias_scale=0.5)
            t_state, t_res = tst.ingest_and_walk_donated(
                t_state, tb, t_bufs, tkey, *_args(tcfg), bias_scale=0.5)
        assert t_res.nodes.data_ptr() == t_bufs.nodes.data_ptr()
        assert t_res.times.data_ptr() == t_bufs.times.data_ptr()
        _walks_equal(t_res, j_res)
        _prefixes_close(t_state.index, j_state.index)
        j_bufs = type(j_bufs)(j_res.nodes, j_res.times)
        t_bufs = type(t_bufs)(t_res.nodes, t_res.times)
