"""Fault tolerance for long-running streaming (DESIGN.md §6, §15),
PyTorch port of repro/distributed/fault_tolerance.py without its training
supervisor, which comes with the training loop.

The walk engine's state is (window edges + walk key). ``WindowCheckpointer``
persists it directly — the sharded window, its placement manifest and
the walk key — so a restart resumes the replay mid-stream instead of
re-ingesting from a cursor; its elastic restore targets another shard
count or placement by re-bucketing the saved window
(``checkpoint.restore_sharded_window`` → ``reshard_host``).
``StreamSupervisor`` drives a ``DistributedStreamingEngine`` replay with
checkpoint-every-N and a straggler watchdog (``StragglerPolicy``), whose
``remesh`` verdict is the trigger for that elastic path.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from repro_torch.distributed.collectives import tree_to
from repro_torch.distributed.streaming_shard import (
    DistributedStreamingEngine,
    ShardedWindowState,
)
from repro_torch.obs.export import dump_health
from repro_torch.obs.registry import MetricsRegistry, get_registry
from repro_torch.train import checkpoint as ckpt


@dataclass
class StragglerPolicy:
    """Per-step wall-time watchdog.

    A straggling host shows up as a slow step. Policy: flag a step that
    takes more than ``threshold`` × the running median of the last
    ``window`` steps; after ``max_flags`` consecutive flags, recommend a
    checkpoint-and-remesh (the elastic path) instead of waiting.
    """

    threshold: float = 3.0
    window: int = 32
    max_flags: int = 3

    _times: List[float] = field(default_factory=list)
    _flags: int = 0

    def observe(self, step_s: float) -> str:
        """Returns 'ok' | 'straggler' | 'remesh'."""
        self._times.append(step_s)
        hist = self._times[-self.window:]
        if len(hist) < 5:
            return "ok"
        med = float(np.median(hist[:-1]))
        if step_s > self.threshold * med:
            self._flags += 1
            if self._flags >= self.max_flags:
                self._flags = 0
                return "remesh"
            return "straggler"
        self._flags = 0
        return "ok"


@dataclass
class WindowCheckpointer:
    """Save and restore a ``DistributedStreamingEngine``'s replay state:
    (sharded window, placement, walk key) under ``<ckpt_dir>/window``.
    ``restore_engine`` is the elastic restart: given ``num_shards`` or
    ``placement`` it comes back on another layout, and the walk key
    resumes the RNG chain, so a restored replay of the remaining batches
    equals the uninterrupted run at the target layout."""

    ckpt_dir: str

    @property
    def window_dir(self) -> str:
        return os.path.join(self.ckpt_dir, "window")

    def save(self, engine: DistributedStreamingEngine, step: int) -> None:
        ckpt.save_sharded_window(self.window_dir, engine.state,
                                 engine.placement, step,
                                 walk_key=engine.key)

    def latest_step(self) -> Optional[int]:
        return ckpt.latest_step(self.window_dir)

    def restore_engine(self, cfg, batch_capacity: int, *,
                       num_shards: Optional[int] = None, placement=None,
                       mesh=None, devices=None
                       ) -> DistributedStreamingEngine:
        """Rebuild an engine from the checkpoint: each shard's leaves on
        its device, the saved walk key resumed. The shards are ``mesh``,
        else the first ones of ``devices`` (default: the visible CUDA
        devices), as ``DistributedStreamingEngine`` takes them."""
        pool = list(mesh.devices) if mesh is not None else devices
        state, plc, walk_key = ckpt.restore_sharded_window(
            self.window_dir, placement=placement, num_shards=num_shards,
            devices=pool)
        eng = DistributedStreamingEngine(
            cfg, batch_capacity, mesh=mesh, num_shards=plc.num_shards,
            devices=devices, placement=plc)
        eng.state = ShardedWindowState(*(
            tuple(tree_to(x, dev) for x, dev in zip(leaves, eng.mesh.devices))
            for leaves in state))
        if walk_key is not None:
            eng.key = walk_key
        return eng


@dataclass
class StreamSupervisor:
    """Checkpoint-every-N supervisor of a distributed streaming replay.

    Feeds batches through ``engine.replay_device`` one at a time (so the
    walk-key chain advances as a per-batch caller's would), watches each
    batch's wall time with a ``StragglerPolicy``, and checkpoints the
    (window, placement, key) state every ``save_every`` batches.
    ``on_event(batch_idx, verdict)`` fires on 'straggler'/'remesh'; a
    'remesh' caller typically restores the latest checkpoint at another
    shard count through ``WindowCheckpointer.restore_engine``.

    With ``health_every > 0`` it writes a validated ``tempest-health/v1``
    snapshot (``obs.dump_health``) to ``health_dir`` (default
    ``<ckpt_dir>/health``) every ``health_every`` batches and once at the
    end of the run.
    """

    ckpt_dir: str
    save_every: int = 8
    straggler: StragglerPolicy = field(default_factory=StragglerPolicy)
    registry: Optional[MetricsRegistry] = None
    health_every: int = 0
    health_dir: Optional[str] = None

    def __post_init__(self):
        self.checkpointer = WindowCheckpointer(self.ckpt_dir)
        if self.registry is None:
            self.registry = get_registry()
        if self.health_dir is None:
            self.health_dir = os.path.join(self.ckpt_dir, "health")

    def resume_batch(self) -> int:
        s = self.checkpointer.latest_step()
        return int(s) if s is not None else 0

    def dump_health(self, engine, step: int) -> str:
        """Write one health snapshot for ``step``; returns its path."""
        os.makedirs(self.health_dir, exist_ok=True)
        path = os.path.join(self.health_dir, f"health_{step:06d}.json")
        dump_health(path, self.registry, engine=engine)
        return path

    def run(self, engine, batches, wcfg, start_batch: int = 0,
            on_event: Optional[Callable] = None):
        """Replay ``batches[start_batch:]``; returns (one
        ``DistReplayStats`` per batch, batches completed)."""
        out = []
        step = start_batch
        for batch in batches[start_batch:]:
            t0 = time.perf_counter()
            stats, _walks, _ = engine.replay_device([batch], wcfg)
            verdict = self.straggler.observe(time.perf_counter() - t0)
            if verdict != "ok":
                self.registry.inc("straggler_events_total", 1,
                                  labels={"verdict": verdict},
                                  help="straggler watchdog flags, by "
                                       "verdict")
                if on_event:
                    on_event(step, verdict)
            out.append(stats)
            step += 1
            if step % self.save_every == 0:
                self.checkpointer.save(engine, step)
                self.registry.inc("checkpoints_total", 1,
                                  labels={"kind": "window"},
                                  help="checkpoints written, by kind")
            if self.health_every and step % self.health_every == 0:
                self.dump_health(engine, step)
        if self.health_every and out:
            self.dump_health(engine, step)
        return out, step
