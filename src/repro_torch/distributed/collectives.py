"""Shard groups and their collectives: the port's stand-in for
``shard_map``'s mesh axis.

The reference writes each shard step as one body under ``shard_map`` and
reaches the other shards through ``all_to_all``, ``pmax``, ``pmin``,
``psum`` and ``axis_index``. The port writes the same step as per-shard
phases split at those collective points: the caller runs phase A for every
shard, then the collective over the D per-shard tensors, then phase B.
Each phase is a pure function of its own shard's tensors, so the bodies
do not depend on where the shards live.

A ``ShardGroup`` holds D and the device of each shard. Shards may share a
device: ``ShardGroup([torch.device("cuda")] * 4)`` runs four shards on one
card (and ``["cpu"] * 8`` eight on the CPU), the analogue of the
reference's forced host devices. On one device the collectives are plain
tensor operations: ``all_to_all`` of the stacked send buffers
``[D_src, D_dst, cap, ...]`` is a transpose of the first two axes, and a
reduction is one ``stack`` and one reduce. Shards on different devices
are served by copies between them.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.kernels.runtime import resolve_device


class ShardGroup:
    """D shards and the device each lives on (shard d on ``devices[d]``)."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a shard group needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)
        self.one_device = len(set(self.devices)) == 1

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"ShardGroup({[str(d) for d in self.devices]})"

    def sub(self, num_shards: int) -> "ShardGroup":
        """The group of the first ``num_shards`` shards."""
        return ShardGroup(self.devices[:num_shards])

    def replicate(self, x: torch.Tensor) -> List[torch.Tensor]:
        """One copy of ``x`` per shard, on its device (the same tensor for
        shards that share a device)."""
        copies = {}
        return [copies.setdefault(d, x.to(d)) for d in self.devices]

    def all_to_all(self, sends: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``all_to_all(split_axis=0, concat_axis=0, tiled=True)``:
        ``sends[s]`` is shard s's ``[D, cap, ...]`` buffer, row d bound for
        shard d. Shard d receives ``[D * cap, ...]``: every sender's row d,
        in sender order."""
        D = self.size
        if self.one_device:
            # stacking along axis 1 is the transpose [D_dst, D_src, ...]
            out = torch.stack(list(sends), dim=1)
            return [out[d].reshape((-1,) + tuple(out.shape[3:]))
                    for d in range(D)]
        return [torch.cat([sends[s][d].to(self.devices[d])
                           for s in range(D)]) for d in range(D)]

    def _reduce(self, xs: Sequence[torch.Tensor], op) -> List[torch.Tensor]:
        home = self.devices[0]
        r = op(torch.stack([x.to(home) for x in xs]))
        return self.replicate(r)

    def psum(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Sum over shards, replicated (dtype kept)."""
        return self._reduce(xs, lambda s: s.sum(0, dtype=s.dtype))

    def pmax(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return self._reduce(xs, lambda s: s.amax(0))

    def pmin(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return self._reduce(xs, lambda s: s.amin(0))


def tree_to(x, device: torch.device):
    """A tensor, or a (nested) NamedTuple of tensors and None, on
    ``device``; what is already there is not copied."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return type(x)(*(tree_to(y, device) for y in x))


def visible_devices() -> List[torch.device]:
    """Every CUDA device this process sees; raises without a card (see
    ``resolve_device``)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_group(num_shards: int = 0, devices=None) -> ShardGroup:
    """A group over the first ``num_shards`` (default: all) of ``devices``
    (default: the visible CUDA devices). More shards than devices is
    refused, as the reference refuses more shards than mesh devices; to
    run D shards on one device, name it D times."""
    devs = list(devices) if devices is not None else visible_devices()
    if num_shards:
        if num_shards > len(devs):
            raise ValueError(f"{num_shards} shards > {len(devs)} devices")
        devs = devs[:num_shards]
    return ShardGroup(devs)
