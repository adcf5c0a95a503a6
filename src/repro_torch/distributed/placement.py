"""Pluggable node placement: which shard owns node v (DESIGN.md §15),
PyTorch port of repro/distributed/placement.py.

Every distributed path of the port — the node-partitioned window's
ingest, the walk start claims, per-hop migration and resharding — asks
one object which shard owns a node's out-edges. A placement maps every
node id in [0, node_capacity) to exactly one shard in [0, num_shards),
and answers the same on a device (``owner``, on torch tensors) and on
the host (``owner_np``, on numpy arrays), bit for bit with the
reference.

Three policies, as in the reference:

* ``range`` — ``owner(v) = clip(v // ceil(node_capacity / D), 0, D-1)``.
* ``hash`` — Knuth's multiplicative hash into a power-of-two routing
  table: ``table[(uint32(v) * 2654435761) >> (32 - log2(buckets))]``.
* ``skew`` — a base policy plus a top-K hot-node override table, built
  from measured loads by ``SkewPlacement.from_loads`` (LPT, heaviest
  first onto the least-loaded shard, ties to the lowest shard id).

Placements are frozen, hashable dataclasses of ints and tuples, because
caches key on them. The routing and override tables reach a device once
per (table, device) and are reused, so an owner lookup makes no
host-to-device copy.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

# Knuth's multiplicative constant (2^32 / phi); uint32 wrap on purpose.
_KNUTH = np.uint32(2654435761)
_MASK = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _device_table(values: Tuple[int, ...], device: torch.device
                  ) -> torch.Tensor:
    """A placement's constant table as int32 on ``device``, made once."""
    return torch.tensor(values, dtype=torch.int32).to(device)


def _mul_knuth_u32(v: torch.Tensor) -> torch.Tensor:
    """``uint32(v) * 2654435761 mod 2^32`` as int64, without an int64
    product that could overflow: the 16-bit halves of v are multiplied
    separately."""
    v = v.to(torch.int64) & _MASK
    k = int(_KNUTH)
    lo = (v & 0xFFFF) * k
    hi = (((v >> 16) * k) & 0xFFFF) << 16
    return (lo + hi) & _MASK


@dataclass(frozen=True)
class Placement:
    """Base node-placement policy: ``owner(v)`` on a device plus its host
    mirror ``owner_np``. Subclasses map int32 node ids to int32 shard
    ids in [0, num_shards)."""

    num_shards: int
    node_capacity: int

    kind = "base"

    def owner(self, v: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def owner_np(self, v) -> np.ndarray:
        raise NotImplementedError

    def shard_nodes(self, d: int) -> np.ndarray:
        """The node ids shard ``d`` owns (host-side)."""
        all_v = np.arange(self.node_capacity, dtype=np.int32)
        return all_v[self.owner_np(all_v) == d]

    def describe(self) -> dict:
        """JSON-serialisable manifest entry; ``placement_from_manifest``
        rebuilds the placement from it."""
        raise NotImplementedError


@dataclass(frozen=True)
class RangePlacement(Placement):
    """``owner(v) = clip(v // range_size, 0, D-1)``."""

    kind = "range"

    @property
    def range_size(self) -> int:
        return math.ceil(self.node_capacity / self.num_shards)

    def owner(self, v: torch.Tensor) -> torch.Tensor:
        r = torch.div(v.to(torch.int32), self.range_size,
                      rounding_mode="floor")
        return r.clamp(0, self.num_shards - 1).to(torch.int32)

    def owner_np(self, v) -> np.ndarray:
        r = np.asarray(v).astype(np.int64) // self.range_size
        return np.clip(r, 0, self.num_shards - 1).astype(np.int32)

    def shard_nodes(self, d: int) -> np.ndarray:
        lo = d * self.range_size
        hi = min((d + 1) * self.range_size, self.node_capacity)
        return np.arange(lo, max(lo, hi), dtype=np.int32)

    def describe(self) -> dict:
        return {"kind": self.kind, "num_shards": self.num_shards,
                "node_capacity": self.node_capacity}


@dataclass(frozen=True)
class HashPlacement(Placement):
    """Multiplicative hash plus routing table:
    ``owner(v) = table[(uint32(v) * 2654435761) >> (32 - log2(len(table)))]``.
    Rebalancing is an edit of table entries followed by a reshard."""

    table: Tuple[int, ...] = ()
    kind = "hash"

    def __post_init__(self):
        b = len(self.table)
        if b == 0 or (b & (b - 1)) != 0:
            raise ValueError(f"routing table size must be a power of two "
                             f"(got {b})")
        if any(not (0 <= t < self.num_shards) for t in self.table):
            raise ValueError("routing table entry out of shard range")

    @classmethod
    def make(cls, num_shards: int, node_capacity: int,
             num_buckets: int = 256) -> "HashPlacement":
        """Round-robin table: bucket i -> shard i % D."""
        table = tuple(i % num_shards for i in range(num_buckets))
        return cls(num_shards=num_shards, node_capacity=node_capacity,
                   table=table)

    @property
    def _shift(self) -> int:
        return 32 - int(math.log2(len(self.table)))

    def owner(self, v: torch.Tensor) -> torch.Tensor:
        bucket = _mul_knuth_u32(v) >> self._shift
        return _device_table(self.table, v.device)[bucket]

    def owner_np(self, v) -> np.ndarray:
        h = np.asarray(v).astype(np.uint32) * _KNUTH
        bucket = (h >> np.uint32(self._shift)).astype(np.int64)
        return np.asarray(self.table, np.int32)[bucket]

    def describe(self) -> dict:
        return {"kind": self.kind, "num_shards": self.num_shards,
                "node_capacity": self.node_capacity,
                "table": list(self.table)}


@dataclass(frozen=True)
class SkewPlacement(Placement):
    """A base policy plus a top-K hot-node override table:
    ``owner(v) = hot_owners[i] if v == hot_nodes[i] else base.owner(v)``.
    K stays small, so the override is one [n, K] compare on the device.
    An empty table is the base policy exactly."""

    base: Placement = None          # type: ignore[assignment]
    hot_nodes: Tuple[int, ...] = ()
    hot_owners: Tuple[int, ...] = ()
    kind = "skew"

    def __post_init__(self):
        if self.base is None:
            raise ValueError("SkewPlacement needs a base placement")
        if (self.base.num_shards != self.num_shards
                or self.base.node_capacity != self.node_capacity):
            raise ValueError("base placement shape mismatch")
        if len(self.hot_nodes) != len(self.hot_owners):
            raise ValueError("hot_nodes / hot_owners length mismatch")
        if len(set(self.hot_nodes)) != len(self.hot_nodes):
            raise ValueError("duplicate hot node override")
        if any(not (0 <= o < self.num_shards) for o in self.hot_owners):
            raise ValueError("hot owner out of shard range")

    @classmethod
    def from_loads(cls, base: Placement, node_loads, k: int = 8
                   ) -> "SkewPlacement":
        """Hub overrides from measured per-node load (host-side
        [node_capacity]): the top-``k`` loaded nodes leave the base
        assignment and go, heaviest first, to the least-loaded shard
        (ties to the lowest shard id). A ``SkewPlacement`` base is
        unwrapped first."""
        if isinstance(base, SkewPlacement):
            base = base.base
        loads = np.asarray(node_loads, np.float64)
        if loads.shape[0] != base.node_capacity:
            raise ValueError(
                f"node_loads has {loads.shape[0]} entries; placement "
                f"expects {base.node_capacity}")
        order = np.argsort(-loads, kind="stable")
        hot = [int(v) for v in order[:k] if loads[v] > 0]
        base_owner = base.owner_np(np.arange(base.node_capacity,
                                             dtype=np.int32))
        shard_load = np.zeros(base.num_shards, np.float64)
        np.add.at(shard_load, base_owner, loads)
        shard_load -= np.bincount(base_owner[hot], weights=loads[hot],
                                  minlength=base.num_shards)
        owners = []
        for v in hot:                      # heaviest first (argsort order)
            d = int(np.argmin(shard_load))
            owners.append(d)
            shard_load[d] += loads[v]
        return cls(num_shards=base.num_shards,
                   node_capacity=base.node_capacity, base=base,
                   hot_nodes=tuple(hot), hot_owners=tuple(owners))

    def owner(self, v: torch.Tensor) -> torch.Tensor:
        base_o = self.base.owner(v)
        if not self.hot_nodes:
            return base_o
        hn = _device_table(self.hot_nodes, v.device)
        ho = _device_table(self.hot_owners, v.device)
        m = v.to(torch.int32)[..., None] == hn
        hit = m.to(torch.int32).argmax(-1)
        return torch.where(m.any(-1), ho[hit], base_o)

    def owner_np(self, v) -> np.ndarray:
        out = self.base.owner_np(v).copy()
        va = np.asarray(v)
        for n, o in zip(self.hot_nodes, self.hot_owners):
            out[va == n] = o
        return out.astype(np.int32)

    def describe(self) -> dict:
        return {"kind": self.kind, "num_shards": self.num_shards,
                "node_capacity": self.node_capacity,
                "base": self.base.describe(),
                "hot_nodes": list(self.hot_nodes),
                "hot_owners": list(self.hot_owners)}


def make_placement(kind: str, num_shards: int, node_capacity: int, *,
                   hash_buckets: int = 256) -> Placement:
    """Factory from a ``ShardConfig.placement`` string. ``skew`` starts
    with an empty override table (its range base)."""
    if kind == "range":
        return RangePlacement(num_shards=num_shards,
                              node_capacity=node_capacity)
    if kind == "hash":
        return HashPlacement.make(num_shards, node_capacity,
                                  num_buckets=hash_buckets)
    if kind == "skew":
        return SkewPlacement(num_shards=num_shards,
                             node_capacity=node_capacity,
                             base=RangePlacement(num_shards=num_shards,
                                                 node_capacity=node_capacity))
    raise ValueError(f"unknown placement kind {kind!r} "
                     "(expected range | hash | skew)")


def placement_from_manifest(d: dict) -> Placement:
    """Rebuild a placement from its ``describe()`` manifest entry."""
    kind = d["kind"]
    if kind == "range":
        return RangePlacement(num_shards=d["num_shards"],
                              node_capacity=d["node_capacity"])
    if kind == "hash":
        return HashPlacement(num_shards=d["num_shards"],
                             node_capacity=d["node_capacity"],
                             table=tuple(d["table"]))
    if kind == "skew":
        return SkewPlacement(num_shards=d["num_shards"],
                             node_capacity=d["node_capacity"],
                             base=placement_from_manifest(d["base"]),
                             hot_nodes=tuple(d["hot_nodes"]),
                             hot_owners=tuple(d["hot_owners"]))
    raise ValueError(f"unknown placement manifest kind {kind!r}")
