"""State carried across from the reference into the port's types.

The functions take the reference's ``EdgeStore``, ``TemporalIndex`` and
``WindowState`` as NamedTuples or dicts whose fields are numpy arrays (or
anything ``numpy.asarray`` accepts), and a key as two uint32 words. Tests
use them to feed the reference's own index — its ``pexp``/``plin`` among
it — into the port, so weight-mode walks can be compared bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.edge_store import EdgeStore
from repro_torch.core.temporal_index import TemporalIndex
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


def window_from_ref(state, device=None) -> WindowState:
    device = resolve_device(device)
    return WindowState(index=index_from_ref(_get(state, "index"), device),
                       **{f: _tensor(_get(state, f), np.int32, device)
                          for f in _COUNTERS})
