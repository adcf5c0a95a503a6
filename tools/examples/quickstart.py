"""Quickstart: build a temporal graph, ingest it, sample causal walks.

    PYTHONPATH=src python tools/examples/quickstart.py [--device cpu]

The port's counterpart of ``examples/quickstart.py``: the same steps,
sizes, seed and printed lines, on the card unless ``--device`` names
another device. ``main`` returns the walks.
"""
import argparse

import numpy as np

from repro_torch import random as prng
from repro_torch.configs.base import SamplerConfig, SchedulerConfig, WalkConfig
from repro_torch.core import build_index, store_from_arrays
from repro_torch.core.validation import validate_walks
from repro_torch.core.walk_engine import generate_walks
from repro_torch.data.synthetic import powerlaw_temporal_graph
from repro_torch.kernels.runtime import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a hub-skewed temporal graph (swap in your own (src, dst, ts))
    g = powerlaw_temporal_graph(num_nodes=500, num_edges=10_000, seed=42,
                                device=dev)

    # 2. the dual-index edge store (paper §2.3)
    store = store_from_arrays(g.src, g.dst, g.ts, edge_capacity=16384,
                              node_capacity=512, device=dev)
    index = build_index(store, node_capacity=512)

    # 3. temporal random walks under an exponential recency bias
    walks = generate_walks(
        index, prng.PRNGKey(0),
        WalkConfig(num_walks=1024, max_length=80, start_mode="nodes"),
        SamplerConfig(bias="exponential", mode="weight"),
        SchedulerConfig(path="grouped"),
    )

    # 4. every hop is causal (paper §3.10: 100% valid)
    report = validate_walks(index, walks)
    lengths = walks.lengths.cpu().numpy()
    nodes, times = walks.nodes.cpu().numpy(), walks.times.cpu().numpy()
    print(f"walks: {lengths.shape[0]}, mean length {lengths.mean():.1f}")
    print(f"hop validity  : {float(report.hop_valid_frac):.3f}")
    print(f"walk validity : {float(report.walk_valid_frac):.3f}")
    print("first walk:", nodes[0, :int(lengths[0])])
    print("its times  :", times[0, :int(lengths[0])])
    return walks


if __name__ == "__main__":
    main()
