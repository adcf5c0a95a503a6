"""State carried across from the reference into the port's types.

The functions take the reference's ``EdgeStore``, ``TemporalIndex``,
``WindowState``, ``LaneParams``, ``SkipgramState`` and ``OptState`` as
NamedTuples or dicts whose fields are numpy arrays (or anything
``numpy.asarray`` accepts), and a key as two uint32 words. Tests use them
to feed the reference's own index — its ``pexp``/``plin`` among it — into
the port, so weight-mode walks can be compared bit for bit, to start the
port from the reference's window, sharded window and alias tables, to
run one packed lane batch in both packages, and to step embeddings and
optimiser state from the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.alias import AliasTables
from repro_torch.core.edge_store import EdgeStore
from repro_torch.core.temporal_index import TemporalIndex
from repro_torch.core.walk_engine import LaneParams
from repro_torch.core.window import WindowState
from repro_torch.kernels.runtime import resolve_device
from repro_torch.train.embeddings import SkipgramState
from repro_torch.train.optimizer import OptState

_INT_FIELDS = ("ns_order", "ns_src", "ns_dst", "ns_ts", "node_starts",
               "node_group_counts", "node_tref", "node_tbase", "adj_order",
               "adj_dst")
_FLOAT_FIELDS = ("pexp", "plin", "pexp_store", "plin_store")
_COUNTERS = ("t_now", "window", "ingested", "late_drops", "overflow_drops")


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _tensor(x, dtype: np.dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=dtype)).to(device)


def key_from_words(key) -> torch.Tensor:
    """A port key from a reference key (uint32[2])."""
    return torch.as_tensor(np.asarray(key, np.uint32).astype(np.int64))


def store_from_ref(store, device=None) -> EdgeStore:
    device = resolve_device(device)
    return EdgeStore(**{f: _tensor(_get(store, f), np.int32, device)
                        for f in EdgeStore._fields})


def index_from_ref(index, device=None) -> TemporalIndex:
    device = resolve_device(device)
    fields = {"store": store_from_ref(_get(index, "store"), device)}
    fields.update({f: _tensor(_get(index, f), np.int32, device)
                   for f in _INT_FIELDS})
    fields.update({f: _tensor(_get(index, f), np.float32, device)
                   for f in _FLOAT_FIELDS})
    return TemporalIndex(**fields)


def tables_from_ref(tables, device=None) -> AliasTables:
    """The port's ``AliasTables`` from the reference's (same fields)."""
    device = resolve_device(device)
    return AliasTables(
        thresh=_tensor(_get(tables, "thresh"), np.int32, device),
        partner=_tensor(_get(tables, "partner"), np.int32, device),
        ptab=_tensor(_get(tables, "ptab"), np.float32, device),
        rebuilt=_tensor(_get(tables, "rebuilt"), np.int32, device))


def window_from_ref(state, device=None) -> WindowState:
    """The port's ``WindowState`` from the reference's, its alias tables
    included when it has them."""
    device = resolve_device(device)
    tables = (state.get("tables") if isinstance(state, dict)
              else getattr(state, "tables", None))
    return WindowState(index=index_from_ref(_get(state, "index"), device),
                       **{f: _tensor(_get(state, f), np.int32, device)
                          for f in _COUNTERS},
                       tables=None if tables is None
                       else tables_from_ref(tables, device))


def _take(x, d: int):
    """Shard ``d`` of a reference value whose leaves carry a leading [D]
    axis, as dicts of numpy arrays."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _take(v, d) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return {f: _take(getattr(x, f), d) for f in x._fields}
    return np.asarray(x)[d]


def sharded_window_from_ref(state, device=None):
    """The port's ``ShardedWindowState`` from the reference's (leaves
    [D, ...], alias tables included when present): one ``WindowState``
    per shard, every shard on ``device`` (CUDA unless named)."""
    from repro_torch.distributed.streaming_shard import ShardedWindowState
    device = resolve_device(device)
    xdrops = np.asarray(_get(state, "exchange_drops"), np.int32)
    window = _get(state, "window")
    return ShardedWindowState(
        window=tuple(window_from_ref(_take(window, d), device)
                     for d in range(xdrops.shape[0])),
        exchange_drops=tuple(_tensor(x, np.int32, device) for x in xdrops))


def lanes_from_ref(lanes, device=None) -> LaneParams:
    """The port's ``LaneParams`` from the reference's (same fields)."""
    device = resolve_device(device)
    fields = {}
    for f in LaneParams._fields:
        x = _get(lanes, f)
        if x is None:
            fields[f] = None
        elif f == "active":
            fields[f] = _tensor(x, np.bool_, device)
        elif f in ("n2v_p", "n2v_q"):
            fields[f] = _tensor(x, np.float32, device)
        else:
            fields[f] = _tensor(x, np.int32, device)
    return LaneParams(**fields)


def tree_from_ref(tree, device=None):
    """A tree of tensors (dtypes kept) from the reference's dicts, lists,
    tuples and NamedTuples of arrays; None stays None."""
    device = resolve_device(device)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_from_ref(v, device) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_from_ref(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_ref(v, device) for v in tree)
    return torch.as_tensor(np.array(tree)).to(device)


def skipgram_state_from_ref(state, device=None) -> SkipgramState:
    """The port's ``SkipgramState`` from the reference's (same fields)."""
    device = resolve_device(device)
    return SkipgramState(
        emb_in=_tensor(_get(state, "emb_in"), np.float32, device),
        emb_out=_tensor(_get(state, "emb_out"), np.float32, device))


def opt_state_from_ref(state, device=None) -> OptState:
    """The port's ``OptState`` from the reference's: the int32 step and
    the ``mu``/``nu``/``error`` trees (dicts, lists, tuples)."""
    device = resolve_device(device)
    return OptState(step=_tensor(_get(state, "step"), np.int32, device),
                    **{f: tree_from_ref(_get(state, f), device)
                       for f in ("mu", "nu", "error")})
