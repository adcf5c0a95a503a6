"""Port sliding-window ingest vs the JAX reference over randomized streams
with timestamp ties, late edges and capacity overflow: every integer
field of the ``WindowState`` — store, dual index, clock and drop
counters — byte-equal after every batch; the float prefixes to the
tolerance of tests/test_kernels.py. Within the port, ``ingest_sort`` and
the merge ingest give the same bytes."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.edge_store import make_batch as j_make_batch
from repro.core.window import ingest as j_ingest
from repro.core.window import init_window as j_init_window
from repro_torch.core.edge_store import make_batch
from repro_torch.core.temporal_index import TemporalIndex
from repro_torch.core.window import ingest, ingest_sort, init_window

FLOATS = ("pexp", "plin", "pexp_store", "plin_store")
COUNTERS = ("t_now", "window", "ingested", "late_drops", "overflow_drops")


def _assert_states_equal(j_state, t_state, where):
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(t_state, f).numpy(),
                                      np.asarray(getattr(j_state, f)),
                                      err_msg=f"{where}: {f}")
    for f in ("src", "dst", "ts", "num_edges"):
        np.testing.assert_array_equal(
            getattr(t_state.index.store, f).numpy(),
            np.asarray(getattr(j_state.index.store, f)),
            err_msg=f"{where}: store.{f}")
    for f in TemporalIndex._fields:
        if f == "store":
            continue
        g = getattr(t_state.index, f).numpy()
        w = np.asarray(getattr(j_state.index, f))
        if f in FLOATS:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4,
                                       err_msg=f"{where}: {f}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{where}: {f}")


@pytest.mark.parametrize("seed,E,N,B,window,ts_step,expect", [
    (0, 1024, 64, 300, 500, 3, "late"),        # ties (ts on a grid of 3)
    (1, 256, 32, 200, 2000, 1, "overflow"),    # small store: overflow clips
    (2, 512, 16, 128, 100, 10, "late"),        # short window
    (3, 2048, 128, 512, 800, 7, "late"),
])
def test_ingest_matches_reference(seed, E, N, B, window, ts_step, expect):
    rng = np.random.default_rng(seed)
    j_state = j_init_window(E, N, window)
    t_state = init_window(E, N, window, device="cpu")
    _assert_states_equal(j_state, t_state, "init")
    saw_late = saw_overflow = False
    for it in range(8):
        n = int(rng.integers(0, B + 1))
        t0 = it * 150
        src = rng.integers(0, N, n)
        dst = rng.integers(0, N, n)
        ts = rng.integers(t0 - 700, t0 + 200, n) // ts_step * ts_step
        j_state = j_ingest(j_state, j_make_batch(src, dst, ts, capacity=B),
                           N)
        t_state = ingest(t_state, make_batch(src, dst, ts, capacity=B,
                                             device="cpu"), N)
        _assert_states_equal(j_state, t_state, f"batch {it}")
        saw_late |= int(t_state.late_drops) > 0
        saw_overflow |= int(t_state.overflow_drops) > 0
    assert {"late": saw_late, "overflow": saw_overflow}[expect]


def test_ingest_all_late_and_empty_batches():
    j_state = j_init_window(128, 8, 10)
    t_state = init_window(128, 8, 10, device="cpu")
    for src, dst, ts in (([1, 2], [3, 4], [100, 100]),
                         ([1, 2, 3], [0, 0, 0], [5, 6, 7]),     # all late
                         ([], [], []),                           # empty
                         ([7], [6], [110])):
        j_state = j_ingest(j_state, j_make_batch(src, dst, ts, capacity=4), 8)
        t_state = ingest(t_state, make_batch(src, dst, ts, capacity=4,
                                             device="cpu"), 8)
        _assert_states_equal(j_state, t_state, f"ts {ts}")
    assert int(t_state.late_drops) == 3


def test_reference_state_carries_across():
    """A window built by the reference, carried into the port through
    ``interop.window_from_ref``, advances exactly as the reference's."""
    from repro_torch import interop
    rng = np.random.default_rng(4)
    j_state = j_init_window(512, 32, 300)
    for it in range(3):
        n = 150
        j_state = j_ingest(j_state, j_make_batch(
            rng.integers(0, 32, n), rng.integers(0, 32, n),
            rng.integers(it * 100, it * 100 + 400, n), capacity=200), 32)
    t_state = interop.window_from_ref(j_state, device="cpu")
    _assert_states_equal(j_state, t_state, "carried")
    for it in range(3, 6):
        src, dst = rng.integers(0, 32, 120), rng.integers(0, 32, 120)
        ts = rng.integers(it * 100, it * 100 + 400, 120)
        j_state = j_ingest(j_state, j_make_batch(src, dst, ts, capacity=200),
                           32)
        t_state = ingest(t_state, make_batch(src, dst, ts, capacity=200,
                                             device="cpu"), 32)
        _assert_states_equal(j_state, t_state, f"batch {it}")


def _assert_port_states_equal(a, b, where):
    for f in ("t_now", "window", "ingested", "late_drops", "overflow_drops"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{where}: {f}"
    for x, y, f in zip(a.index.store, b.index.store,
                       ("src", "dst", "ts", "num_edges")):
        assert torch.equal(x, y), f"{where}: store.{f}"
    for f in TemporalIndex._fields[1:]:
        assert torch.equal(getattr(a.index, f), getattr(b.index, f)), \
            f"{where}: {f}"


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_matches_sort(seed):
    """``ingest_sort`` (one global stable sort) and the merge ingest give
    the same bytes after every batch of a stream with timestamp ties,
    late edges, overflow and empty batches, as tests/test_streaming_merge
    holds the reference's two paths."""
    rng = np.random.default_rng(seed)
    sm = init_window(64, 16, 1000, device="cpu")
    ss = init_window(64, 16, 1000, device="cpu")
    t = 0
    for it in range(10):
        n = 0 if it == 4 else int(rng.integers(1, 60))
        ts = rng.integers(t - 1150, t + 200, n).astype(np.int32) // 3 * 3
        t = max([t] + ts.tolist())
        batch = make_batch(rng.integers(0, 16, n), rng.integers(0, 16, n),
                           ts, capacity=64, device="cpu")
        sm = ingest(sm, batch, 16)
        ss = ingest_sort(ss, batch, 16)
        _assert_port_states_equal(sm, ss, f"batch {it}")
    assert int(sm.late_drops) > 0 and int(sm.overflow_drops) > 0


def test_sort_engine_matches_merge_engine():
    """``StreamingEngine(ingest_impl="sort")``'s host loop equals the merge
    engine's; alias tables require the merge path, as in the reference."""
    from repro.data.synthetic import chronological_batches
    from repro.data.synthetic import powerlaw_temporal_graph
    from repro_torch.configs import base as tcfg
    from repro_torch.core.streaming import StreamingEngine
    from repro_torch.obs.registry import MetricsRegistry
    cfg = tcfg.EngineConfig(window=tcfg.WindowConfig(
        duration=1500, edge_capacity=1024, node_capacity=64))
    engines = [StreamingEngine(cfg, 512, ingest_impl=impl, device="cpu",
                               registry=MetricsRegistry())
               for impl in ("merge", "sort")]
    g = powerlaw_temporal_graph(64, 3000, seed=2, t_max=4000)
    for b in chronological_batches(g, 6):
        for eng in engines:
            eng.ingest_batch(*b)
        _assert_port_states_equal(engines[0].state, engines[1].state, "eng")
    wcfg = tcfg.WalkConfig(num_walks=64, max_length=6)
    a, b = (eng.sample_walks(wcfg) for eng in engines)
    assert torch.equal(a.nodes, b.nodes)
    with pytest.raises(ValueError, match="unknown ingest_impl"):
        StreamingEngine(cfg, 512, ingest_impl="heap", device="cpu")
    with pytest.raises(ValueError, match="requires the merge"):
        StreamingEngine(dataclasses.replace(cfg, sampler=tcfg.SamplerConfig(
            bias="table")), 512, ingest_impl="sort", device="cpu")
