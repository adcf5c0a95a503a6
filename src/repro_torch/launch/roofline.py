"""Roofline terms of a dry-run cell at H100 constants, PyTorch port of
repro/launch/roofline.py.

Three terms per (arch × shape × mesh), from the counts of the step on
meta tensors (``op_cost``) and the collectives its plan implies
(``comm_cost``):

    compute    = FLOPs on one chip / PEAK_FLOPS
    memory     = bytes on one chip / HBM_BW
    collective = Σ collective bytes on one chip / the bandwidth of the
                 link its group runs over

A chip's FLOPs and bytes are its share of each op (``op_cost.per_chip``:
the global count divided by the shards that split it, so the work a plan
leaves replicated counts on every chip), as the reference reads them
from each device's compiled program. A collective's bytes are its
result's bytes on one partition, divided by one link's bandwidth, as the
reference divides them (``repro/launch/roofline.py:99-100``): not a ring
model, which would move ``(n − 1)/n`` of them over each of a ring's
links.

The link model: nodes of 8 H100 SXM (HGX/DGX H100); a mesh's devices
numbered row-major, the last axis fastest, 8 consecutive devices to a
node. A collective whose every group lies inside one node runs over
NVLink; one whose groups cross nodes, over InfiniBand. So on 16×16 and
2×16×16 every group crosses nodes, and on 2×4 and 1×8 none does.

``state_gib`` is the plan's bytes a chip holds of the step's inputs and
carried state (``shard_bytes`` of each leaf under its spec): params,
AdamW moments and gradients for train, params and the decode state for
decode, params for prefill, the batch in each. Activations are not
counted, where the reference reports the compiled program's peak, nor
is fusion: eager runs each op as its own kernel.

These times are projections from counts at data-sheet constants, not
readings of a card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Tuple

# dense bf16 tensor-core peak of one H100 SXM, NVIDIA's data sheet (no
# sparsity), at the 700 W power limit; chip_smoke.BF16_PEAK_FLOPS
PEAK_FLOPS = 989e12
# HBM3 bandwidth of one H100 SXM (80 GB), NVIDIA's data sheet;
# chip_smoke.HBM_BYTES_PER_S
HBM_BW = 3.35e12
# devices a node: HGX/DGX H100 carries 8 H100 SXM
NODE_DEVICES = 8
# NVLink 4 of one H100 SXM: 900 GB/s bidirectional, NVIDIA's H100 data
# sheet; 450 GB/s a direction
NVLINK_BW = 450e9
# InfiniBand NDR, one 400 Gb/s ConnectX-7 a GPU (DGX H100): 50 GB/s a
# direction
IB_BW = 50e9


def crosses_nodes(mesh: Dict[str, int], axes: Tuple[str, ...]) -> bool:
    """Whether a group of a collective over ``axes`` of ``mesh`` spans
    more than one node (devices row-major, ``NODE_DEVICES`` a node)."""
    names = list(mesh)
    sizes = [mesh[a] for a in names]
    strides = [math.prod(sizes[k + 1:]) for k in range(len(sizes))]

    def offsets(ks):
        out = [0]
        for k in ks:
            out = [i + c * strides[k] for i in out for c in range(sizes[k])]
        return out

    group = offsets([k for k, a in enumerate(names) if a in axes])
    return any(len({(base + i) // NODE_DEVICES for i in group}) > 1
               for base in offsets([k for k, a in enumerate(names)
                                    if a not in axes]))


def link_bandwidth(mesh: Dict[str, int], axes: Tuple[str, ...]) -> float:
    """Bytes a second of one link of a collective over ``axes``."""
    return IB_BW if crosses_nodes(mesh, axes) else NVLINK_BW


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                      # counted, global
    bytes: float                      # counted, global
    flops_per_chip: float             # a chip's share (op_cost.per_chip)
    bytes_per_chip: float
    state_bytes_per_chip: float = 0.0
    model_flops: float = 0.0          # 6·N·D (global)
    transcendentals: float = 0.0
    collective_breakdown: Dict[str, float] = field(default_factory=dict)
    # mesh axes ("data", "pod+data", ...) -> bytes, and each one's seconds
    collective_by_axes: Dict[str, float] = field(default_factory=dict)
    collective_s_by_axes: Dict[str, float] = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return float(sum(self.collective_s_by_axes.values()))

    def _terms(self) -> dict:
        return {"compute": self.t_compute, "memory": self.t_memory,
                "collective": self.t_collective}

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """The useful-FLOPs MFU bound implied by the dominant term."""
        t = max(self._terms().values())
        if t <= 0:
            return 0.0
        return (self.model_flops / (self.chips * PEAK_FLOPS)) / t

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "counted_flops_total": self.flops,
            "counted_bytes_total": self.bytes,
            "transcendentals_total": self.transcendentals,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "state_gib": self.state_bytes_per_chip / 2**30,
            "collectives": dict(self.collective_breakdown),
            "collectives_by_axes": dict(self.collective_by_axes),
        }


def collective_terms(comm, mesh: Dict[str, int]
                     ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(bytes, seconds) by mesh axes (``"pod+data"``) of a
    ``comm_cost.CommCounts`` on ``mesh``."""
    nbytes, secs = {}, {}
    for axes, b in comm.by_axes.items():
        key = "+".join(axes)
        nbytes[key] = b
        secs[key] = b / link_bandwidth(mesh, axes)
    return nbytes, secs


def model_flops_for(cfg, shape) -> float:
    """6·N·D for train; 2·N·D for an inference forward (per step)."""
    n_active = cfg.approx_active_params()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
