"""Per-hop lane regrouping (DESIGN.md §10), PyTorch port of
core/scheduler.py::bucket_regroup.

The reference groups lanes with LSD counting passes: first over a
span-scaled 16-bit quantized relative time (only when some occupied node
carries mixed times), then over the node-id digits. Each pass is stable,
so the result is the stable order of lanes by (node, quantized time) —
or by node alone. Here that is one stable sort of an int64 key
``node << 16 | time_bits``, which yields the same permutation. The
permutation is purely an execution layout (the emitted walks do not
depend on it), but the fused hop's tier split, and with it the ``tiers``
statistic, does.
"""
from __future__ import annotations

import torch

_TIME_SUBSORT_BITS = 16


def bucket_regroup(node_key: torch.Tensor, time_key: torch.Tensor,
                   node_capacity: int, *, time_subsort: bool = True
                   ) -> torch.Tensor:
    """Permutation (output position -> input lane) grouping lanes by
    ``node_key``; dead lanes are keyed ``node_capacity + 1``. With
    ``time_subsort``, lanes of one node are further ordered by quantized
    relative time when any occupied node carries mixed times."""
    key = node_key.to(torch.int64) << _TIME_SUBSORT_BITS
    if time_subsort and node_key.numel() > 0:
        # mixed: some occupied node holds two lanes at different times
        by_node = torch.sort(key, stable=True).indices
        s_node = node_key[by_node]
        s_time = time_key[by_node]
        same = (s_node[1:] == s_node[:-1]) & (s_node[1:] < node_capacity)
        mixed = (same & (s_time[1:] != s_time[:-1])).any()
        # span-scaled quantization: the observed span fits the subsort
        # bits; the shift is monotone, so equal times share a key
        tlo = time_key.min()
        span = (time_key.max() - tlo).clamp(min=1)
        shift = (torch.floor(torch.log2(span.to(torch.float32)))
                 .to(torch.int32) - (_TIME_SUBSORT_BITS - 1)).clamp(min=0)
        rel = ((time_key - tlo) >> shift).clamp(
            0, (1 << _TIME_SUBSORT_BITS) - 1)
        key = key + torch.where(mixed, rel, 0).to(torch.int64)
    return torch.sort(key, stable=True).indices.to(torch.int32)
