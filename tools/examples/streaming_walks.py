"""Streaming ingestion under a sliding window (paper §3.3 regime),
plus the observability quickstart (DESIGN.md §16): both replay drivers
publish into one metrics registry, exported at the end as Prometheus
text, a JSON snapshot, and a streaming-health document.

    PYTHONPATH=src python tools/examples/streaming_walks.py [--device cpu]

The port's counterpart of ``examples/streaming_walks.py``: the same
steps, sizes, seed and printed lines, on the card unless ``--device``
names another device. ``main`` returns the host loop's walks of every
batch, the device replay's ``ReplayStats`` and the registry.
"""
import argparse
import json

import numpy as np

from repro_torch.configs.base import (
    EngineConfig,
    SamplerConfig,
    SchedulerConfig,
    WalkConfig,
    WindowConfig,
)
from repro_torch.core.streaming import StreamingEngine
from repro_torch.core.validation import validate_walks
from repro_torch.data.synthetic import chronological_batches, powerlaw_temporal_graph
from repro_torch.kernels.runtime import resolve_device
from repro_torch.obs import health_snapshot, new_registry, to_prometheus


def main(argv=None, num_nodes=1000, num_edges=100_000, batches=16,
         num_walks=2048):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = powerlaw_temporal_graph(num_nodes=num_nodes, num_edges=num_edges,
                                seed=7, device=dev)
    cfg = EngineConfig(
        window=WindowConfig(duration=2500, edge_capacity=1 << 16,
                            node_capacity=1024),
        sampler=SamplerConfig(bias="exponential", mode="index"),
        scheduler=SchedulerConfig(path="grouped"),
    )
    registry = new_registry()     # or omit: engines share the process default
    engine = StreamingEngine(cfg, batch_capacity=8192, registry=registry,
                             device=dev)
    wcfg = WalkConfig(num_walks=num_walks, max_length=30, start_mode="nodes")
    walks = []

    def on_batch(eng, res):
        i = len(eng.stats.ingest_s)
        rep = validate_walks(eng.state.index, res)
        walks.append(res)
        print(f"batch {i:2d}: active_edges={eng.stats.edges_active[-1]:7d} "
              f"ingest={1e3*eng.stats.ingest_s[-1]:7.1f}ms "
              f"sample={1e3*eng.stats.sample_s[-1]:7.1f}ms "
              f"valid={float(rep.walk_valid_frac):.2f} "
              f"late={int(eng.state.late_drops)}")

    engine.replay(chronological_batches(g, batches), wcfg, on_batch=on_batch)
    ing = np.asarray(engine.stats.ingest_s[1:])
    print(f"\nsteady-state ingest {1e3*ing.mean():.1f}ms/batch; memory "
          f"bounded by the window (static shapes => exactly constant).")

    # Same replay, device-resident: every batch's ingest and walks are
    # issued without a host sync, and the statistics come back in one copy
    # at the end — the throughput driver (DESIGN.md §4).
    engine2 = StreamingEngine(cfg, batch_capacity=8192, registry=registry,
                              device=dev)
    stats, secs = engine2.replay_device(chronological_batches(g, batches),
                                        wcfg)
    print(f"device-resident replay: {len(stats.edges_active)} batches in "
          f"{secs:.2f}s, "
          f"late={int(stats.late_drops[-1])} "
          f"overflow={int(stats.overflow_drops[-1])}")

    # Both drivers published into the same registry (the device replay's
    # probe counters flushed at its one existing host sync). One export
    # covers everything — DESIGN.md §16.
    print("\n--- Prometheus exposition (excerpt) ---")
    print("\n".join(l for l in to_prometheus(registry).splitlines()
                    if l.startswith(("stream_", "window_", "drops_"))))
    health = health_snapshot(registry)     # validated tempest-health/v1
    print("\n--- streaming health ---")
    print(json.dumps({k: health[k] for k in ("ingest", "window", "drops")},
                     indent=2, sort_keys=True))
    return walks, stats, registry


if __name__ == "__main__":
    main()
