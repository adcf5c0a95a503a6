"""State carried across from the reference into the port's types.

The functions take the reference's ``EdgeStore``, ``TemporalIndex``,
``WindowState`` and ``LaneParams`` as NamedTuples or dicts whose fields
are numpy arrays (or anything ``numpy.asarray`` accepts), and a key as two
uint32 words. Tests use them to feed the reference's own index — its
``pexp``/``plin`` among it — into the port, so weight-mode walks can be
compared bit for bit, to start the port from the reference's window and
alias tables, and to run one packed lane batch in both packages.
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
