"""The port's training consumer against the JAX reference, in one process:
``repro_torch.random.randint``/``normal``, ``data/walk_dataset.py`` and
``train/embeddings.py``.

* ``randint`` is bit for bit ``jax.random.randint`` (spans 1, 5, 128,
  2^22, 2^31 − 1; negative bounds; one batch of keys == each key's draw);
  ``normal`` agrees within ``NORMAL_RTOL``: its uniform is jax's bit for
  bit, but ``torch.erfinv`` and XLA's ``erf_inv`` are different
  approximations, whose relative gap grows toward the tails.
* ``skipgram_pairs`` gives the reference's arrays in its order, walks of
  length 0 and 1 and the ``max_pairs`` pick included.
* ``skipgram_step`` from a state carried across: negatives bit for bit;
  loss and tables within ``RTOL``/``ATOL``; rows the step did not read
  bitwise unchanged.
* ``train_on_walks``, three calls on the walks of both packages' engines
  (bitwise equal), within the same tolerance; ``link_prediction_auc``
  exactly equal on a state carried across; ``walks_to_lm_batch`` equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core.streaming import StreamingEngine as JStreamingEngine
from repro.data import walk_dataset as jwd
from repro.data.synthetic import chronological_batches, powerlaw_temporal_graph
from repro.train import embeddings as jemb
from repro_torch import interop
from repro_torch import random as prng
from repro_torch.configs import base as tcfg
from repro_torch.core.streaming import StreamingEngine
from repro_torch.data import walk_dataset as twd
from repro_torch.distributed.fault_tolerance import TrainSupervisor
from repro_torch.train import embeddings as temb

NORMAL_RTOL = 1e-5
RTOL, ATOL = 1e-5, 1e-7
N, DIM = 256, 16


def _key(jkey):
    return interop.key_from_words(np.asarray(jkey))


def _walks(seed=0, W=96, L=9, n=N):
    """Random walk-shaped arrays with lengths 0 .. L, NODE_PAD beyond."""
    rng = np.random.default_rng(seed)
    nodes = rng.integers(0, n, (W, L)).astype(np.int32)
    lengths = rng.integers(0, L + 1, W).astype(np.int32)
    lengths[:4] = [0, 1, 2, L]
    nodes[np.arange(L)[None] >= lengths[:, None]] = -1
    return nodes, lengths


def _carried(state):
    return interop.skipgram_state_from_ref(state, "cpu")


def _assert_state_close(ref, got):
    for name in ("emb_in", "emb_out"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("span", [1, 5, 128, 1 << 22, 2**31 - 1])
def test_randint_matches_jax(span):
    for seed in (0, 1, 42, 2**31 - 1):
        for shape in ((7,), (3, 5), (1001,), (64, 5)):
            got = prng.randint(prng.PRNGKey(seed), shape, 0, span, "cpu")
            want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                                 shape, 0, span))
            assert got.dtype == torch.int32 and tuple(got.shape) == shape
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"seed {seed} {shape}")


@pytest.mark.parametrize("lo,hi", [(-5, 7), (-2**31, 2**31 - 1), (10, 3),
                                   (-100, -50), (0, 0)])
def test_randint_bounds_match_jax(lo, hi):
    got = prng.randint(prng.PRNGKey(3), (500,), lo, hi, "cpu").numpy()
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (500,),
                                         lo, hi))
    np.testing.assert_array_equal(got, want)


def test_randint_keys_equals_each_key_and_split_chain_matches_jax():
    last, subs = prng.split_chain(prng.PRNGKey(5), 6)
    jk = jax.random.PRNGKey(5)
    for i in range(6):
        jk, js = jax.random.split(jk)
        np.testing.assert_array_equal(subs[i].numpy(), _key(js).numpy())
    np.testing.assert_array_equal(last.numpy(), _key(jk).numpy())
    batch = prng.randint_keys(subs, (40, 5), 0, 1 << 22, "cpu")
    for i in range(6):
        np.testing.assert_array_equal(
            batch[i].numpy(), prng.randint(subs[i], (40, 5), 0, 1 << 22,
                                           "cpu").numpy())
        # a shorter draw is a prefix of the longer one (the last step)
        np.testing.assert_array_equal(
            batch[i, :13].numpy(),
            np.asarray(jax.random.randint(
                jax.numpy.asarray(subs[i].numpy().astype(np.uint32)),
                (13, 5), 0, 1 << 22)))


@pytest.mark.parametrize("shape", [(1000,), (512, 16), (1 << 16,)])
def test_normal_within_erfinv_gap(shape):
    for seed in range(3):
        got = prng.normal(prng.PRNGKey(seed), shape, "cpu").numpy()
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_allclose(got, want, rtol=NORMAL_RTOL, atol=0)


@pytest.mark.parametrize("window,max_pairs", [(1, None), (2, None),
                                              (3, None), (2, 100)])
def test_skipgram_pairs_match_reference(window, max_pairs):
    nodes, lengths = _walks()
    c, x = jwd.skipgram_pairs(nodes, lengths, window=window,
                              max_pairs=max_pairs, seed=3)
    tc, tx = twd.skipgram_pairs(torch.from_numpy(nodes),
                                torch.from_numpy(lengths), window=window,
                                max_pairs=max_pairs, seed=3)
    assert tc.dtype == tx.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), c)
    np.testing.assert_array_equal(tx.numpy(), x)


def test_skipgram_pairs_of_short_walks_are_empty():
    nodes = np.array([[3, -1, -1], [4, -1, -1]], np.int32)
    for lengths in ([0, 0], [1, 1], [0, 1]):
        tc, tx = twd.skipgram_pairs(torch.from_numpy(nodes),
                                    torch.tensor(lengths, dtype=torch.int32))
        c, _ = jwd.skipgram_pairs(nodes, np.array(lengths))
        assert tc.numel() == tx.numel() == len(c) == 0


def test_init_skipgram_matches_reference():
    ref = jemb.init_skipgram(N, DIM, jax.random.PRNGKey(1))
    got = temb.init_skipgram(N, DIM, prng.PRNGKey(1), device="cpu")
    np.testing.assert_allclose(got.emb_in.numpy(), np.asarray(ref.emb_in),
                               rtol=NORMAL_RTOL, atol=0)
    assert not got.emb_out.any() and got.emb_out.shape == (N, DIM)


def test_skipgram_step_matches_reference():
    nodes, lengths = _walks(seed=1)
    c, x = jwd.skipgram_pairs(nodes, lengths)
    c, x = c[:300], x[:300]
    n = 4 * N        # rows beyond the walks' nodes, most left unread
    ref = jemb.init_skipgram(n, DIM, jax.random.PRNGKey(1))
    got = _carried(ref)
    key = jax.random.PRNGKey(7)
    for _ in range(3):
        key, sub = jax.random.split(key)
        negs = prng.randint(_key(sub), (len(c), 5), 0, n, "cpu")
        np.testing.assert_array_equal(
            negs.numpy(), np.asarray(jax.random.randint(sub, (len(c), 5),
                                                        0, n)))
        before = [t.clone() for t in got]
        ref, jloss = jemb.skipgram_step(ref, jnp.asarray(c), jnp.asarray(x),
                                        sub, n_neg=5, lr=0.025)
        got, tloss = temb.skipgram_step(got, torch.from_numpy(c),
                                        torch.from_numpy(x), _key(sub),
                                        n_neg=5, lr=0.025)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
        _assert_state_close(ref, got)
        read = np.zeros(n, bool)
        read[c] = True
        untouched_in = ~read
        read[x] = True
        read[negs.numpy().ravel()] = True
        untouched_out = ~read
        assert untouched_in.any() and untouched_out.any()
        assert torch.equal(got.emb_in[untouched_in], before[0][untouched_in])
        assert torch.equal(got.emb_out[untouched_out],
                           before[1][untouched_out])


def _engine_walks():
    """Three walk batches of both packages' engines on one small stream
    (index/exponential, fused path), checked equal."""
    g = powerlaw_temporal_graph(N, 6000, seed=4, t_max=3000)
    batches = list(chronological_batches(g, 3))
    window = dict(duration=1500.0, edge_capacity=4096, node_capacity=N)
    sched = dict(path="fused", tile_walks=64, tile_edges=256)
    wcfg = dict(num_walks=256, max_length=8, start_mode="nodes")
    j = JStreamingEngine(jcfg.EngineConfig(
        window=jcfg.WindowConfig(**window),
        scheduler=jcfg.SchedulerConfig(**sched)), 2048)
    t = StreamingEngine(tcfg.EngineConfig(
        window=tcfg.WindowConfig(**window),
        scheduler=tcfg.SchedulerConfig(**sched)), 2048, device="cpu")
    out = []
    for bs, bd, bt in batches:
        j.ingest_batch(bs, bd, bt)
        t.ingest_batch(bs, bd, bt)
        jw = j.sample_walks(jcfg.WalkConfig(**wcfg))
        tw = t.sample_walks(tcfg.WalkConfig(**wcfg))
        np.testing.assert_array_equal(tw.nodes.numpy(), np.asarray(jw.nodes))
        np.testing.assert_array_equal(tw.lengths.numpy(),
                                      np.asarray(jw.lengths))
        out.append((jw, tw))
    return g, out


def test_train_on_walks_and_auc_match_reference():
    g, walks = _engine_walks()
    ref = jemb.init_skipgram(N, DIM, jax.random.PRNGKey(1))
    got = _carried(ref)
    jkey = jax.random.PRNGKey(2)
    for jw, tw in walks:
        jkey, sub = jax.random.split(jkey)
        ref, jloss = jemb.train_on_walks(ref, jw.nodes, jw.lengths, sub,
                                         batch_pairs=256)
        got, tloss = temb.train_on_walks(got, tw.nodes, tw.lengths,
                                         _key(sub), batch_pairs=256)
        assert isinstance(tloss, float) and np.isfinite(tloss)
        np.testing.assert_allclose(tloss, jloss, rtol=RTOL)
        _assert_state_close(ref, got)
    n_test = int(0.85 * len(g.src))
    args = (g.src[n_test:], g.dst[n_test:], N)
    assert temb.link_prediction_auc(_carried(ref), *args) \
        == jemb.link_prediction_auc(ref, *args)


def test_train_on_walks_without_pairs():
    state = temb.init_skipgram(N, DIM, prng.PRNGKey(0), device="cpu")
    before = state.emb_in.clone()
    nodes = torch.full((4, 3), -1, dtype=torch.int32)
    out, loss = temb.train_on_walks(state, nodes,
                                    torch.tensor([0, 1, 1, 0]),
                                    prng.PRNGKey(1))
    assert loss == 0.0 and out is state
    assert torch.equal(out.emb_in, before)


def test_walks_to_lm_batch_matches_reference():
    nodes, lengths = _walks(seed=2, n=1000)
    for seq_len, batch in ((16, 4), (64, 8)):
        want = jwd.walks_to_lm_batch(nodes, lengths, seq_len, batch, 100,
                                     seed=5)
        got = twd.walks_to_lm_batch(nodes, lengths, seq_len, batch, 100,
                                    seed=5)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_training_entry_points_need_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref = jemb.init_skipgram(8, 4, jax.random.PRNGKey(0))
    calls = [
        lambda: temb.init_skipgram(8, 4, prng.PRNGKey(0)),
        lambda: prng.randint(prng.PRNGKey(0), (4,), 0, 8),
        lambda: prng.normal(prng.PRNGKey(0), (4,)),
        lambda: interop.skipgram_state_from_ref(ref),
        lambda: TrainSupervisor(str(tmp_path)).restore({}, {}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
