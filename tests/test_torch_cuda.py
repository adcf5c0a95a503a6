"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without an NVIDIA GPU (and ``nvcc`` to build the
kernels) every test skips. Run on a machine with an H100 from the root of
a checkout:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the port does
not need.) This file imports neither JAX nor the reference package.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import (EngineConfig, SamplerConfig,
                                      SchedulerConfig, WalkConfig,
                                      WindowConfig)
from repro_torch.core.edge_store import store_from_arrays
from repro_torch.core.streaming import StreamingEngine
from repro_torch.core.temporal_index import build_index
from repro_torch.data.synthetic import (chronological_batches,
                                        powerlaw_temporal_graph)
from repro_torch.kernels import fused_step as kf
from repro_torch.kernels import runtime
from repro_torch.kernels.weight_prefix import (TOL_U, error_in_u,
                                               weight_prefix,
                                               weight_prefix_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _index(device, N=256, num_edges=15000, E=16384, seed=0):
    g = powerlaw_temporal_graph(N, num_edges, seed=seed)
    return build_index(store_from_arrays(g.src, g.dst, g.ts, E, N,
                                         device=device), N)


@pytest.mark.parametrize("mode", ["index", "weight"])
def test_fused_kernels_match_plain(card, mode):
    idx = _index(card)
    rng = np.random.default_rng(1)
    W = 2048
    nodes = torch.sort(torch.as_tensor(
        rng.integers(0, 256, W).astype(np.int32), device=card)).values
    times = torch.as_tensor(rng.integers(0, 10_000, W).astype(np.int32),
                            device=card)
    u = torch.as_tensor(rng.uniform(size=W).astype(np.float32), device=card)
    code = torch.as_tensor(rng.integers(0, 3, W).astype(np.int32),
                           device=card)
    cfg = SchedulerConfig(path="fused", tile_walks=256, tile_edges=1024)
    before = dict(runtime.LAUNCHES)
    got = kf.fused_walk_step(idx, nodes, times, code, u, mode, cfg)
    assert runtime.LAUNCHES["fused_tier_s"] == before["fused_tier_s"] + 1
    assert runtime.LAUNCHES["fused_tier_l"] == before["fused_tier_l"] + 1
    sp = kf.tier_split(idx, nodes, cfg)
    assert int(sp.big.sum()) > 0 and int((~sp.big).sum()) > 0
    tbase = idx.node_tbase[nodes.long()]
    want = kf.fused_step_plain(idx.ns_ts, idx.ns_dst, idx.pexp, idx.plin,
                               sp.a, sp.b, times, code, u, tbase, mode=mode)
    for g, w in zip(got[:4], want):
        assert torch.equal(g, w)


def test_weight_prefix_kernel_matches_plain(card):
    rng = np.random.default_rng(2)
    E = 100_003
    dt = torch.as_tensor(-rng.exponential(3.0, E).astype(np.float32),
                         device=card)
    valid = torch.as_tensor(rng.uniform(size=E) < 0.9, device=card)
    got = weight_prefix(dt, valid)
    want = weight_prefix_plain(dt, valid)
    assert got[0].item() == 0.0
    assert bool((got[1:] >= got[:-1]).all())
    assert error_in_u(got, want) <= TOL_U


def test_small_replay_card_equals_cpu(card):
    g = powerlaw_temporal_graph(512, 1 << 14, seed=3, t_max=100_000)
    batches = list(chronological_batches(g, 3))
    cfg = EngineConfig(
        window=WindowConfig(duration=50_000.0, edge_capacity=1 << 13,
                            node_capacity=512),
        sampler=SamplerConfig(bias="linear", mode="index"),
        scheduler=SchedulerConfig(path="fused", tile_walks=64,
                                  tile_edges=256))
    wcfg = WalkConfig(num_walks=512, max_length=12, start_mode="edges")
    out = [StreamingEngine(cfg, 1 << 13, device=d).replay_device(
        batches, wcfg, return_walks=True) for d in ("cuda", "cpu")]
    for a, b in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(out[0][1][:3], out[1][1][:3]):
        np.testing.assert_array_equal(a, b)
