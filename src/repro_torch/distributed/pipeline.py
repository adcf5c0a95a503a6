"""Pipeline parallelism: the GPipe schedule over a ``ShardGroup``,
PyTorch port of repro/distributed/pipeline.py.

Stage s of P lives on ``group.devices[s]`` and holds its own parameters.
With M microbatches the schedule runs M + P − 1 ticks; at tick t stage s
works on microbatch t − s where ``s ≤ t < s + M``, stage 0 reading
microbatch t and every other stage the activation the stage before it
handed over at the previous tick (the reference's ``ppermute``: a copy
to the next stage's device, nothing where they share one). Stage s is
busy M of the ticks, so the bubble is (P − 1)/(M + P − 1).

The reference runs every stage at every tick and discards what an
inactive stage computes (``jnp.where(active, y, buf)``); here an
inactive stage computes nothing, which changes no output. The stages are
issued in one host loop, so on one device they run one after another:
the schedule's overlap needs one device per stage.

``sequential_reference`` applies the stages in order to each microbatch
at the same ``[mb, ...]`` shape, so the two agree bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from repro_torch.distributed.collectives import ShardGroup


@dataclass
class PipelineStats:
    """What one ``gpipe_forward`` call ran: its ticks and the stage-ticks
    that did work (P·M)."""

    stages: int = 0
    microbatches: int = 0
    ticks: int = 0
    busy: int = 0

    @property
    def bubble(self) -> float:
        """The idle share of the stage-ticks, (P − 1)/(M + P − 1)."""
        total = self.stages * self.ticks
        return 1.0 - self.busy / total if total else 0.0


def gpipe_forward(group: ShardGroup, stage_fn: Callable,
                  stage_params: Sequence, x_microbatches: torch.Tensor,
                  stats: Optional[PipelineStats] = None) -> torch.Tensor:
    """Run ``stage_fn(params, x) -> y`` as a P-stage pipeline, stage s on
    ``group.devices[s]`` with ``stage_params[s]`` (already there).

    ``x_microbatches`` is ``[M, mb, ...]``. Returns the last stage's
    outputs ``[M, mb, ...]`` on the first stage's device; ``stats``, if
    given, is filled in. Reads nothing back to the host."""
    P = group.size
    if len(stage_params) != P:
        raise ValueError(f"{len(stage_params)} stage params for {P} stages")
    M = x_microbatches.shape[0]
    ticks = M + P - 1
    devs = group.devices
    inbox = [None] * P          # what stage s reads at this tick
    outs = [None] * M
    busy = 0
    for t in range(ticks):
        sent = [None] * P
        for s in range(max(0, t - M + 1), min(P, t + 1)):
            x = x_microbatches[t].to(devs[0]) if s == 0 else inbox[s]
            y = stage_fn(stage_params[s], x)
            busy += 1
            if s == P - 1:
                outs[t - P + 1] = y
            else:
                sent[s + 1] = y.to(devs[s + 1])
        inbox = sent
    if stats is not None:
        stats.stages, stats.microbatches = P, M
        stats.ticks, stats.busy = ticks, busy
    return torch.stack([o.to(devs[0]) for o in outs])


def sequential_reference(stage_fn: Callable, stage_params: Sequence,
                         x_microbatches: torch.Tensor) -> torch.Tensor:
    """Oracle: every stage in order on each microbatch, no pipelining.
    The activation is not moved between stages, so their params share a
    device (or ``stage_fn`` moves its input)."""
    outs = []
    for x in x_microbatches:
        for p in stage_params:
            x = stage_fn(p, x)
        outs.append(x)
    return torch.stack(outs)
