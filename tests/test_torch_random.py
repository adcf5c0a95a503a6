"""The port's threefry keys and draws (repro_torch.random) are bit-for-bit
those of the installed ``jax.random`` in its default (partitionable)
mode: PRNGKey, split, fold_in and float32 uniform, over many seeds, tags
and shapes, including odd sizes."""
import jax
import numpy as np
import pytest

from repro_torch import random as prng

SEEDS = [0, 1, 2, 7, 42, 1234, 2**31 - 1, -1, -5, 987654321]
TAGS = [0, 1, 2, 3, 17, 79, 80, (1 << 20) + 5, 2**31 - 1, 2**32 - 1]
SHAPES = [(1,), (2,), (7,), (128,), (1001,), (3, 5), (2, 3, 4), (16, 2, 7)]


def _words(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  _words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [1, 2, 3, 4, 7, 33])
def test_split_matches_jax(num):
    for seed in SEEDS:
        got = prng.split(prng.PRNGKey(seed), num).numpy()
        want = _words(jax.random.split(jax.random.PRNGKey(seed), num))
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")


@pytest.mark.parametrize("tag", TAGS)
def test_fold_in_matches_jax(tag):
    for seed in SEEDS[:6]:
        got = prng.fold_in(prng.PRNGKey(seed), tag).numpy()
        want = _words(jax.random.fold_in(jax.random.PRNGKey(seed),
                                         np.uint32(tag)))
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")


@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_matches_jax(shape):
    for seed in SEEDS[:5]:
        got = prng.uniform(prng.PRNGKey(seed), shape, "cpu").numpy()
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_engine_key_schedule_matches_jax():
    """The walk engine's chain: split into (start, walk) keys, fold_in per
    hop step, a uniform per hop; and the replay's per-batch split."""
    jk, tk = jax.random.PRNGKey(11), prng.PRNGKey(11)
    for _ in range(3):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        js, jw = jax.random.split(jsub)
        ts_, tw = prng.split(tsub)
        np.testing.assert_array_equal(tw.numpy(), _words(jw))
        np.testing.assert_array_equal(
            prng.uniform(ts_, (513,), "cpu").numpy(),
            np.asarray(jax.random.uniform(js, (513,))))
        for step in (0, 1, 79):
            np.testing.assert_array_equal(
                prng.uniform(prng.fold_in(tw, step), (257,), "cpu").numpy(),
                np.asarray(jax.random.uniform(jax.random.fold_in(jw, step),
                                              (257,))))


def test_key_words_accept_reference_keys():
    """A reference key (uint32[2] array) is a valid port key as it is."""
    jk = jax.random.PRNGKey(5)
    got = prng.uniform(np.asarray(jk), (9,), "cpu").numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jax.random.uniform(jk, (9,))))
