"""The port's node placements (repro_torch/distributed/placement.py)
against the JAX reference's, bit for bit.

* ``owner`` on tensors and ``owner_np`` on arrays equal the reference's
  ``owner``/``owner_np`` for D ∈ {1, 2, 3, 8} under range, hash and skew
  placement, on every node id and on ids at the int32 extremes (the
  multiplicative hash wraps in uint32).
* ``SkewPlacement.from_loads`` builds the reference's overrides; the
  manifests (``describe``) are equal and each package rebuilds the
  other's; ``shard_nodes`` agree; the validation messages are equal.
* Placements are frozen and hashable: equal placements key one cache.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.distributed import placement as jp
from repro_torch.distributed import placement as tp

NC = 1000


def _loads(seed: int, nc: int = NC) -> np.ndarray:
    rng = np.random.default_rng(seed)
    loads = rng.zipf(1.3, nc).astype(np.float64)
    loads[rng.integers(0, nc, nc // 4)] = 0.0
    return loads


def _pair(kind: str, D: int, nc: int = NC):
    """(reference, port) placements of one kind; skew with overrides."""
    if kind == "skew":
        loads = _loads(D)
        j = jp.SkewPlacement.from_loads(
            jp.make_placement("range", D, nc), loads, k=5)
        t = tp.SkewPlacement.from_loads(
            tp.make_placement("range", D, nc), loads, k=5)
        return j, t
    return jp.make_placement(kind, D, nc), tp.make_placement(kind, D, nc)


def _ids(nc: int = NC) -> np.ndarray:
    rng = np.random.default_rng(1)
    extremes = np.array([0, 1, nc - 1, nc, 2 ** 31 - 1, -1, -2 ** 31,
                         2 ** 30, -12345], np.int64)
    return np.concatenate([np.arange(nc), extremes,
                           rng.integers(-2 ** 31, 2 ** 31, 4096)]
                          ).astype(np.int32)


@pytest.mark.parametrize("D", [1, 2, 3, 8])
@pytest.mark.parametrize("kind", ["range", "hash", "skew"])
def test_owner_matches_reference(kind, D):
    j, t = _pair(kind, D)
    v = _ids()
    inside = v[(v >= 0) & (v < NC)]
    want = np.asarray(j.owner(inside))
    got = t.owner(torch.as_tensor(inside))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t.owner_np(inside), j.owner_np(inside))
    np.testing.assert_array_equal(t.owner_np(inside), want)
    # every node id has exactly one owner in range
    assert ((want >= 0) & (want < D)).all()
    # ids outside the node range: the hash wraps in uint32, range clips
    if kind != "skew" or not j.hot_nodes:
        np.testing.assert_array_equal(
            t.owner(torch.as_tensor(v)).numpy(), np.asarray(j.owner(v)))
        np.testing.assert_array_equal(t.owner_np(v), j.owner_np(v))


@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_from_loads_and_manifest_match_reference(D):
    loads = _loads(10 + D)
    for base in ("range", "hash"):
        j = jp.SkewPlacement.from_loads(jp.make_placement(base, D, NC),
                                        loads, k=8)
        t = tp.SkewPlacement.from_loads(tp.make_placement(base, D, NC),
                                        loads, k=8)
        assert (t.hot_nodes, t.hot_owners) == (j.hot_nodes, j.hot_owners)
        # re-deriving from a skew base unwraps it, as in the reference
        t2 = tp.SkewPlacement.from_loads(t, loads, k=3)
        j2 = jp.SkewPlacement.from_loads(j, loads, k=3)
        assert t2.describe() == j2.describe()
        for a, b in ((j, t), (j2, t2)):
            assert b.describe() == a.describe()
            assert tp.placement_from_manifest(a.describe()) == b
            assert jp.placement_from_manifest(b.describe()) == a
            for d in range(D):
                np.testing.assert_array_equal(b.shard_nodes(d),
                                              a.shard_nodes(d))


def test_make_placement_and_manifests_match_reference():
    for kind in ("range", "hash", "skew"):
        for D in (1, 4):
            j = jp.make_placement(kind, D, NC, hash_buckets=64)
            t = tp.make_placement(kind, D, NC, hash_buckets=64)
            assert t.describe() == j.describe()
            assert t.kind == j.kind
            assert tp.placement_from_manifest(j.describe()) == t
    r = tp.RangePlacement(num_shards=3, node_capacity=NC)
    assert r.range_size == jp.RangePlacement(num_shards=3,
                                             node_capacity=NC).range_size


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_refusal_messages_match_reference():
    def both(make):
        return _message(lambda: make(jp)), _message(lambda: make(tp))

    cases = [
        lambda m: m.make_placement("modulo", 2, NC),
        lambda m: m.HashPlacement(num_shards=2, node_capacity=NC,
                                  table=(0, 1, 0)),
        lambda m: m.HashPlacement(num_shards=2, node_capacity=NC, table=()),
        lambda m: m.HashPlacement(num_shards=2, node_capacity=NC,
                                  table=(0, 3)),
        lambda m: m.SkewPlacement(num_shards=2, node_capacity=NC),
        lambda m: m.SkewPlacement(
            num_shards=2, node_capacity=NC,
            base=m.RangePlacement(num_shards=3, node_capacity=NC)),
        lambda m: m.SkewPlacement(
            num_shards=2, node_capacity=NC,
            base=m.RangePlacement(num_shards=2, node_capacity=NC),
            hot_nodes=(3, 3), hot_owners=(0, 1)),
        lambda m: m.SkewPlacement(
            num_shards=2, node_capacity=NC,
            base=m.RangePlacement(num_shards=2, node_capacity=NC),
            hot_nodes=(3,), hot_owners=()),
        lambda m: m.SkewPlacement(
            num_shards=2, node_capacity=NC,
            base=m.RangePlacement(num_shards=2, node_capacity=NC),
            hot_nodes=(3,), hot_owners=(2,)),
        lambda m: m.SkewPlacement.from_loads(
            m.RangePlacement(num_shards=2, node_capacity=NC),
            np.ones(NC - 1)),
        lambda m: m.placement_from_manifest({"kind": "modulo"}),
    ]
    for make in cases:
        want, got = both(make)
        assert got == want


def test_placements_are_frozen_and_hashable():
    a = tp.make_placement("hash", 4, NC)
    b = tp.make_placement("hash", 4, NC)
    assert a == b and hash(a) == hash(b)
    assert len({a, b, tp.make_placement("range", 4, NC)}) == 2
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.num_shards = 2
    s = tp.SkewPlacement.from_loads(a, _loads(3), k=4)
    assert hash(s) == hash(tp.placement_from_manifest(s.describe()))
