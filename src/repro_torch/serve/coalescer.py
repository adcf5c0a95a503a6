"""Request coalescing: heterogeneous queries -> one fixed-shape lane batch
(DESIGN.md §11), PyTorch port of repro/serve/coalescer.py.

* **shape buckets** — a batch always runs at a bucketed (lane count,
  max length) from ``ServeConfig``, never at the exact request shape;
* **lane packing** — queries are laid out back to back along the walk
  axis; surplus bucket lanes are inactive (``LaneParams.active``);
* **result slicing** — each query's rows are sliced back out and trimmed
  to its own ``max_length + 1`` columns;
* **lane owners** — ``lane_owners``, the host mirror of sharded
  serving's start claims.

``pack_queries`` lays the lane arrays out on the host exactly as the
reference does, then moves them to the device in one copy: from pinned
memory and without waiting on a CUDA device, so packing the next batch
never stalls the host behind the batches in flight.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.samplers import bias_code
from repro_torch.core.walk_engine import LaneParams, WalkResult
from repro_torch.kernels.runtime import resolve_device
from repro_torch.serve.query import WalkQuery

# rows of the packed host array; n2v_p/n2v_q travel as float32 bits
_ROWS = ("start_node", "bias", "start_bias", "max_len", "rid", "wid",
         "active", "n2v_p", "n2v_q")


def bucketize(n: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= n, or None when n exceeds every bucket."""
    for b in buckets:
        if n <= b:
            return b
    return None


def group_key(query: WalkQuery, length_buckets: Sequence[int]):
    """Coalescing group of a query: ``(start_mode, length bucket)``. Two
    queries may share a batch iff their group keys match."""
    return (query.start_mode, bucketize(query.max_length, length_buckets))


@dataclass(frozen=True)
class LaneSlice:
    """Where one query's lanes live inside a coalesced batch."""

    offset: int
    count: int


def pack_queries(queries: Sequence[WalkQuery], num_lanes: int,
                 max_length: int, device=None
                 ) -> Tuple[LaneParams, List[LaneSlice]]:
    """Lay queries out back to back along the walk axis.

    Returns the engine-ready ``LaneParams`` (``num_lanes`` wide, padding
    lanes inactive, on CUDA unless ``device`` names another) and one
    ``LaneSlice`` per query. All queries must share a start mode and fit
    the bucket shape; the service guarantees both.
    """
    device = resolve_device(device)
    total = sum(q.num_lanes for q in queries)
    if total > num_lanes:
        raise ValueError(f"{total} lanes exceed the {num_lanes}-lane bucket")
    if any(q.max_length > max_length for q in queries):
        raise ValueError("query max_length exceeds the length bucket")
    host = np.zeros((len(_ROWS), num_lanes), np.int32)
    r = {name: host[i] for i, name in enumerate(_ROWS)}
    # second-order lanes: (1, 1) = first-order draw, the padding default
    n2v = host[_ROWS.index("n2v_p"):].view(np.float32)
    n2v[:] = 1.0

    slices: List[LaneSlice] = []
    off = 0
    for q in queries:
        n = q.num_lanes
        sl = slice(off, off + n)
        if q.start_mode == "nodes":
            r["start_node"][sl] = np.asarray(q.start_nodes, np.int32)
        r["bias"][sl] = bias_code(q.bias)
        r["start_bias"][sl] = bias_code(q.start_bias)
        r["max_len"][sl] = q.max_length
        r["rid"][sl] = np.int32(q.seed)
        r["wid"][sl] = np.arange(n, dtype=np.int32)
        r["active"][sl] = 1
        n2v[0, sl] = np.float32(q.n2v_p)
        n2v[1, sl] = np.float32(q.n2v_q)
        slices.append(LaneSlice(offset=off, count=n))
        off += n

    t = torch.from_numpy(host)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    rows = dict(zip(_ROWS, t))
    rows["active"] = rows["active"] != 0
    rows["n2v_p"] = rows["n2v_p"].view(torch.float32)
    rows["n2v_q"] = rows["n2v_q"].view(torch.float32)
    return LaneParams(**rows), slices


def slice_result(nodes: np.ndarray, times: np.ndarray, lengths: np.ndarray,
                 sl: LaneSlice, query: WalkQuery):
    """One query's rows out of the batch result, trimmed to its columns."""
    cols = query.max_length + 1
    rows = slice(sl.offset, sl.offset + sl.count)
    return (nodes[rows, :cols].copy(), times[rows, :cols].copy(),
            lengths[rows].copy())


def lane_owners(params: LaneParams, placement) -> np.ndarray:
    """Owner shard of each start lane in a packed nodes-mode batch: the
    sharded claim rule's host mirror, ``placement.owner_np`` over the
    clipped start node, so it equals the device rule for every policy.
    Padding lanes map to -1."""
    v = np.clip(params.start_node.cpu().numpy(), 0,
                placement.node_capacity - 1)
    return np.where(params.active.cpu().numpy(), placement.owner_np(v), -1)


def result_arrays(res: WalkResult):
    """A batch result on the host, one copy per array; per-query slicing
    then stays in numpy."""
    return tuple(x.cpu().numpy() for x in (res.nodes, res.times,
                                           res.lengths))
