"""The port's GPipe schedule (repro_torch/distributed/pipeline.py).

* ``gpipe_forward`` over ``ShardGroup(["cpu"] * P)`` equals the port's
  ``sequential_reference`` bit for bit for (P, M) in {(4, 6), (4, 1),
  (1, 3), (2, 5)}, and runs M + P − 1 ticks, P·M of them busy;
* on the reference test's ``tanh(x @ w + b)`` stages
  (``tests/test_pipeline_ft.py``), with params from numpy under a seed,
  it equals the reference's ``sequential_reference`` within rtol/atol
  1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.pipeline import sequential_reference as ref_sequential
from repro_torch.distributed.collectives import ShardGroup
from repro_torch.distributed.pipeline import (PipelineStats, gpipe_forward,
                                              sequential_reference)

MB, D = 3, 8


def _stages(P: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.standard_normal((P, D, D))).astype(np.float32)
    b = (0.1 * rng.standard_normal((P, D))).astype(np.float32)
    return w, b


def _inputs(M: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((M, MB, D)).astype(np.float32)


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _torch_params(w, b):
    return [{"w": torch.from_numpy(w[s]), "b": torch.from_numpy(b[s])}
            for s in range(w.shape[0])]


@pytest.mark.parametrize("P,M", [(4, 6), (4, 1), (1, 3), (2, 5)])
def test_gpipe_equals_sequential_bitwise(P, M):
    w, b = _stages(P)
    params = _torch_params(w, b)
    x = torch.from_numpy(_inputs(M))
    stats = PipelineStats()
    got = gpipe_forward(ShardGroup(["cpu"] * P), stage_fn, params, x, stats)
    want = sequential_reference(stage_fn, params, x)
    assert got.shape == (M, MB, D)
    assert torch.equal(got, want)
    assert (stats.ticks, stats.busy) == (M + P - 1, P * M)
    assert stats.bubble == pytest.approx((P - 1) / (M + P - 1))


def test_gpipe_matches_reference_sequential():
    P, M = 4, 6
    w, b = _stages(P)
    x = _inputs(M)

    def ref_stage(p, v):
        return jnp.tanh(v @ p["w"] + p["b"])

    want = ref_sequential(ref_stage, {"w": jnp.asarray(w),
                                      "b": jnp.asarray(b)}, jnp.asarray(x))
    got = gpipe_forward(ShardGroup(["cpu"] * P), stage_fn,
                        _torch_params(w, b), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_gpipe_refuses_a_stage_count_mismatch():
    w, b = _stages(2)
    with pytest.raises(ValueError, match="2 stage params for 3 stages"):
        gpipe_forward(ShardGroup(["cpu"] * 3), stage_fn, _torch_params(w, b),
                      torch.from_numpy(_inputs(2)))
