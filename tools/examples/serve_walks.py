"""Multi-tenant walk-query serving over a live edge stream (DESIGN.md §11).

    PYTHONPATH=src python tools/examples/serve_walks.py [--device cpu]
    # serving at scale (DESIGN.md §13): the window over N shards, here
    # N shards of one device through a ShardGroup
    PYTHONPATH=src python tools/examples/serve_walks.py --shards 4

The port's counterpart of ``examples/serve_walks.py``: the same steps,
sizes, seeds and printed lines, on the card unless ``--device`` names
another device.

Three tenants with incompatible needs — different biases, fan-outs, walk
lengths, seeds — share every dispatch: the coalescer packs their
queries into one shape-bucketed lane batch, and the per-lane RNG makes
each tenant's answer bit-identical to running it alone. With ``--shards``
the same service runs against the node-partitioned window: lanes start
on their owner shards and migrate per hop, and every tenant's answer
stays bit-identical to the single-device service's.

``main`` returns ``(svc, batches, tenants, results)``: the single-device
service, the edge batches, the three queries and each tenant's served
result; with ``--shards`` two more, the sharded service and its results.
"""
import argparse

import numpy as np

from repro_torch.configs.base import (
    EngineConfig,
    SamplerConfig,
    SchedulerConfig,
    ServeConfig,
    ShardConfig,
    WindowConfig,
)
from repro_torch.data.synthetic import chronological_batches, powerlaw_temporal_graph
from repro_torch.distributed.collectives import ShardGroup
from repro_torch.kernels.runtime import resolve_device
from repro_torch.serve import WalkQuery, WalkService


def serve_config() -> ServeConfig:
    return ServeConfig(queue_capacity=256, lane_buckets=(64, 256, 1024),
                       length_buckets=(8, 16, 32))


def single(dev):
    """The single-device service, its batches, tenants and results."""
    g = powerlaw_temporal_graph(num_nodes=1000, num_edges=50_000, seed=7,
                                device=dev)
    cfg = EngineConfig(
        window=WindowConfig(duration=4000, edge_capacity=1 << 16,
                            node_capacity=1024),
        sampler=SamplerConfig(mode="index"),       # bias is per-query now
        scheduler=SchedulerConfig(path="grouped"))
    svc = WalkService(cfg, serve_config(), batch_capacity=16384, device=dev)

    batches = list(chronological_batches(g, 5))
    for bs, bd, bt in batches[:-1]:
        svc.ingest(bs, bd, bt)

    # three tenants, one dispatch
    recommender = WalkQuery(start_nodes=tuple(range(0, 48)),
                            bias="exponential", max_length=12, seed=101)
    fraud_team = WalkQuery(start_nodes=(7, 11, 13), bias="uniform",
                           max_length=30, seed=202)
    embedder = WalkQuery(num_walks=64, start_mode="edges", bias="linear",
                         start_bias="exponential", max_length=16, seed=303)
    tickets = {name: svc.submit(q, strict=True) for name, q in
               [("recommender", recommender), ("fraud", fraud_team),
                ("embedder", embedder)]}
    while svc.pending_count:
        svc.step()
    results = {}
    for name, t in tickets.items():
        r = results[name] = svc.poll(t)
        lens = r.lengths
        print(f"{name:12s} bias={r.query.bias:11s} walks={len(lens):3d} "
              f"mean_len={lens.mean():5.2f} latency={1e3*r.latency_s:6.1f}ms")

    # coalesced == solo, bit for bit (the §11 guarantee)
    solo_nodes, _, solo_lengths = svc.run_query_solo(fraud_team)
    assert np.array_equal(solo_nodes, results["fraud"].nodes)
    assert np.array_equal(solo_lengths, results["fraud"].lengths)
    print("fraud tenant: solo run == coalesced run, bit for bit")

    # snapshot double-buffer: keep serving the current window while the
    # next batch ingests; publish() swaps atomically
    bs, bd, bt = batches[-1]
    svc.begin_ingest(bs, bd, bt)
    t = svc.submit(recommender, strict=True)     # runs against old window
    svc.step()
    svc.poll(t)
    svc.publish()                                # new window from here on
    print(f"snapshot version={svc.snapshots.version} "
          f"(served 1 query mid-ingest)")

    s = svc.stats
    print(f"\nserved {s.completed} queries in {s.batches} batches "
          f"(occupancy {s.lane_occupancy:.0%}), p50={s.p50_ms:.1f}ms "
          f"p99={s.p99_ms:.1f}ms, {s.walks_per_s:.0f} walks/s")

    return svc, batches, [recommender, fraud_team, embedder], results


def sharded(num_shards: int, svc, batches, tenants, dev):
    """Re-run the three tenants over the node-partitioned window, its
    ``num_shards`` shards on ``dev``, and show the DESIGN.md §13
    invariant: sharded-coalesced == single-device solo. Returns the
    sharded service and each tenant's result from it."""
    cfg = EngineConfig(
        window=WindowConfig(duration=4000, edge_capacity=1 << 16,
                            node_capacity=1024),
        sampler=SamplerConfig(mode="index"),
        scheduler=SchedulerConfig(path="grouped"),
        # exchange buckets must cover one sender routing its whole batch
        # slice to one owner (DESIGN.md §12 provisioning): at D=1 that is
        # the full 16384-row batch
        shard=ShardConfig(edge_capacity_per_shard=1 << 16,
                          exchange_capacity=1 << 14,
                          walk_slots=1 << 11, walk_bucket_capacity=1 << 10))
    sharded = WalkService(cfg, serve_config(), batch_capacity=16384,
                          mesh=ShardGroup([dev] * num_shards))
    for bs, bd, bt in batches:
        sharded.ingest(bs, bd, bt)
    # the single-device service above only ingested batches[:-1] + [-1]
    # via begin/publish, i.e. all of them — same window version here
    tickets = [sharded.submit(q, strict=True) for q in tenants]
    while sharded.pending_count:
        sharded.step()
    results = []
    for q, t in zip(tenants, tickets):
        r = sharded.poll(t)
        sn, _, sl = svc.run_query_solo(q)
        assert np.array_equal(r.nodes, sn) and np.array_equal(r.lengths, sl)
        results.append(r)
    print(f"\n{num_shards}-shard service: all {len(tenants)} tenants "
          f"bit-identical to single-device solo runs "
          f"(walk drops={sharded.stats.shard_walk_drops}, "
          f"ingest drops={sharded.stats.exchange_drops}, "
          f"lane balance={sharded.stats.lanes_by_shard})")
    return sharded, results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=None,
                    help="shards of the window, all on the one device")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.shards is not None and args.shards < 1:
        raise SystemExit("--shards needs a positive shard count, e.g. "
                         "--shards 4")
    dev = resolve_device(args.device)
    out = single(dev)
    if args.shards is None:
        return out
    return out + sharded(args.shards, *out[:3], dev)


if __name__ == "__main__":
    main()
