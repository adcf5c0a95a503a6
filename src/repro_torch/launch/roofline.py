"""Roofline terms of a dry-run cell at H100 constants, PyTorch port of
repro/launch/roofline.py.

Two terms per (arch × shape × mesh), from the counts of the step on meta
tensors (``op_cost``):

    compute = counted FLOPs / (chips × PEAK_FLOPS)
    memory  = counted bytes / (chips × HBM_BW)

The counts are of the global step, divided evenly over the chips. The
reference's counts come from each device's compiled program, so they
also see the work a plan leaves replicated (an attention whose heads the
model axis does not divide, say); these do not. ``t_collective`` is
None: a one-process eager run issues no collectives, so none is counted.

``state_gib`` is the plan's bytes a chip holds of the step's inputs and
carried state (``shard_bytes`` of each leaf under its spec): params,
AdamW moments and gradients for train, params and the decode state for
decode, params for prefill, the batch in each. Activations are not
counted, where the reference reports the compiled program's peak.

These times are projections from counts at data-sheet constants, not
readings of a card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# dense bf16 tensor-core peak of one H100 SXM, NVIDIA's data sheet (no
# sparsity), at the 700 W power limit; chip_smoke.BF16_PEAK_FLOPS
PEAK_FLOPS = 989e12
# HBM3 bandwidth of one H100 SXM (80 GB), NVIDIA's data sheet;
# chip_smoke.HBM_BYTES_PER_S
HBM_BW = 3.35e12


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                      # counted, global
    bytes: float                      # counted, global
    state_bytes_per_chip: float = 0.0
    model_flops: float = 0.0          # 6·N·D (global)
    transcendentals: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / self.chips / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes / self.chips / HBM_BW

    @property
    def t_collective(self) -> Optional[float]:
        return None

    def _terms(self) -> dict:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return {k: v for k, v in terms.items() if v is not None}

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
            "useful_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "state_gib": self.state_bytes_per_chip / 2**30,
            "collectives": None,
        }


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
