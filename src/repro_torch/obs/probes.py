"""On-device probes: fixed-slot int32 stat vectors (DESIGN.md §16),
PyTorch port of repro/obs/probes.py.

The replay runs on the device with one host synchronisation per call.
A probe vector bridges it and the host-side registry without adding
transfers: an int32 vector of fixed slots is updated on the device once
per batch, beside the values the replay already computes, returned with
its outputs, and flushed into the registry at the call's existing host
sync (``StreamingEngine.replay_device`` reads it in the same copy as the
replay's statistics). A probed replay emits the same bits as an unprobed
one: the probe arithmetic reads walk lengths and window counters and
touches nothing the walks read.

Slot layouts are the reference's, append-only: exporters and flushers
index by the ``RP_*`` / ``SP_*`` constants, never by position literals.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.obs.registry import MetricsRegistry, count_drop

# Replay probes: one int32[NUM_REPLAY_PROBES] vector per replay.
RP_BATCHES = 0           # batches replayed
RP_EDGES_INGESTED = 1    # edges delivered into the window
RP_LATE_DROPS = 2        # edges older than the eviction cutoff
RP_OVERFLOW_DROPS = 3    # capacity evictions of in-window edges
RP_EXCHANGE_DROPS = 4    # sharded only: ingest exchange overflow
RP_WALK_DROPS = 5        # sharded only: walk slot/bucket overflow
RP_HOPS = 6              # hop cells executed
RP_WALKS_EMITTED = 7     # walks with >= 1 hop
NUM_REPLAY_PROBES = 8

# Serve probes: one int32[NUM_SERVE_PROBES] row per shard of a sharded
# serving batch.
SP_LANES_CLAIMED = 0     # start lanes claimed by this shard
SP_WALK_DROPS = 1        # start-slot + migration overflow on this shard
SP_HOPS = 2              # hop cells executed by this shard
NUM_SERVE_PROBES = 3


def replay_probe_zeros(device=None) -> torch.Tensor:
    return torch.zeros(NUM_REPLAY_PROBES, dtype=torch.int32, device=device)


def serve_probe_zeros(device=None) -> torch.Tensor:
    return torch.zeros(NUM_SERVE_PROBES, dtype=torch.int32, device=device)


def replay_probe_update(vec: torch.Tensor, *, ingested_delta=None,
                        late_delta=None, overflow_delta=None,
                        exchange_drops=None, walk_drops=None, hops=None,
                        lengths=None) -> torch.Tensor:
    """One batch's accumulation into a replay probe vector, on its device;
    returns a new vector. Every argument is an optional 0-d tensor;
    ``lengths`` is the batch's [W] walk lengths, from which the hop count
    (unless ``hops`` is given) and the emitted-walk count follow."""
    add = [None] * NUM_REPLAY_PROBES
    add[RP_BATCHES] = torch.ones((), dtype=torch.int32, device=vec.device)
    for slot, x in ((RP_EDGES_INGESTED, ingested_delta),
                    (RP_LATE_DROPS, late_delta),
                    (RP_OVERFLOW_DROPS, overflow_delta),
                    (RP_EXCHANGE_DROPS, exchange_drops),
                    (RP_WALK_DROPS, walk_drops), (RP_HOPS, hops)):
        if x is not None:
            add[slot] = x.to(torch.int32)
    if lengths is not None:
        if hops is None:
            add[RP_HOPS] = (lengths - 1).clamp(min=0).sum(dtype=torch.int32)
        add[RP_WALKS_EMITTED] = (lengths >= 2).sum(dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=vec.device)
    return vec + torch.stack([zero if x is None else x for x in add])


def _shard_labels(shard: Optional[int], **extra) -> dict:
    labels = dict(extra)
    if shard is not None:
        labels["shard"] = str(shard)
    return labels


def flush_replay_probes(registry: MetricsRegistry, vec, *, driver: str,
                        shard: Optional[int] = None) -> None:
    """Publish one replay probe vector (host array or tensor) into the
    registry; drop slots land in ``drops_total{kind=...}``."""
    v = np.asarray(vec.cpu() if isinstance(vec, torch.Tensor) else vec,
                   dtype=np.int64)
    if v.shape != (NUM_REPLAY_PROBES,):
        raise ValueError(
            f"replay probe vector must be [{NUM_REPLAY_PROBES}] "
            f"(got shape {v.shape})")
    lab = _shard_labels(shard, driver=driver)
    registry.inc("stream_batches_total", int(v[RP_BATCHES]), labels=lab,
                 help="batches replayed through the streaming drivers")
    registry.inc("stream_edges_ingested_total", int(v[RP_EDGES_INGESTED]),
                 labels=lab, help="edges delivered into the window")
    registry.inc("walk_hops_total", int(v[RP_HOPS]),
                 labels=_shard_labels(shard, source="replay"),
                 help="hop cells executed")
    registry.inc("walks_emitted_total", int(v[RP_WALKS_EMITTED]), labels=lab,
                 help="walks with at least one hop")
    count_drop(registry, "ingest_late", int(v[RP_LATE_DROPS]))
    count_drop(registry, "window_overflow", int(v[RP_OVERFLOW_DROPS]))
    count_drop(registry, "exchange_clip", int(v[RP_EXCHANGE_DROPS]))
    count_drop(registry, "walk_slot_overflow", int(v[RP_WALK_DROPS]))


def flush_serve_probes(registry: MetricsRegistry, vecs) -> None:
    """Publish a [D, NUM_SERVE_PROBES] serve probe matrix (one batch)."""
    v = np.asarray(vecs.cpu() if isinstance(vecs, torch.Tensor) else vecs,
                   dtype=np.int64)
    if v.ndim != 2 or v.shape[1] != NUM_SERVE_PROBES:
        raise ValueError(
            f"serve probe matrix must be [D, {NUM_SERVE_PROBES}] "
            f"(got shape {v.shape})")
    for d in range(v.shape[0]):
        if v[d, SP_LANES_CLAIMED]:
            registry.inc("serve_lane_claims_total",
                         int(v[d, SP_LANES_CLAIMED]),
                         labels={"shard": str(d)},
                         help="start lanes claimed per owner shard")
        if v[d, SP_HOPS]:
            registry.inc("walk_hops_total", int(v[d, SP_HOPS]),
                         labels={"source": "serve", "shard": str(d)})
    count_drop(registry, "walk_slot_overflow", int(v[:, SP_WALK_DROPS].sum()))
