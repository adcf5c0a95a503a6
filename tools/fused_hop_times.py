#!/usr/bin/env python3
"""Where the time of the fused hop goes, on one H100.

Run from the root of a checkout on a machine with a card:

    python3 tools/fused_hop_times.py

It builds the main path's window as ``chip_smoke.py`` does (the first 12
of 24 batches of the full-size stream) and the lanes of hop 3 of 2^20
walks, then times one ``fused_walk_step`` on six inputs, index mode with
the exponential bias unless named:

* ``hop0`` / ``hop3``: the real lanes of hop 0 / hop 3;
* ``dead``: hop 3's lanes with every time set past every edge, so every
  lane stops after its one load for n > 0;
* ``live_tiles``: hop 3's tiles up to the last that holds a live lane
  (dead lanes sort last);
* ``hop3_weight_exponential`` / ``hop3_weight_linear``: hop 3's lanes in
  weight mode.

The ``repro_torch`` package is the one on ``PYTHONPATH`` if that holds
one, else this checkout's, so another tree's fused hop is timed with
``PYTHONPATH=<tree>/src python3 tools/fused_hop_times.py``. Each input
prints one JSON line: device ms per call of the fused kernels (profiler),
ms per call by CUDA events, and a digest of the outputs, equal across
trees that compute the same bits. The last line is the card's name and
power limit. With no CUDA device it exits 2.
"""
from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# fused_hop, and the two tier kernels it replaced
KERNELS = ("fused_hop_kernel", "fused_tier_s_kernel", "fused_tier_l_kernel")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.append(str(ROOT / "src"))
    import chip_smoke as cs
    import repro_torch
    from repro_torch import random as prng
    from repro_torch.configs.base import (EngineConfig, SamplerConfig,
                                          SchedulerConfig, WalkConfig,
                                          WindowConfig)
    from repro_torch.core.samplers import BIAS_EXPONENTIAL, BIAS_LINEAR
    from repro_torch.core.streaming import StreamingEngine
    from repro_torch.data.synthetic import (chronological_batches,
                                            powerlaw_temporal_graph)
    from repro_torch.kernels import fused_step as kf

    print(json.dumps(dict(package=str(Path(repro_torch.__file__).parent))),
          flush=True)
    full = cs.FULL
    g = powerlaw_temporal_graph(
        full["nodes"], full["edges_per_batch"] * full["batches"], skew=1.2,
        t_max=10_000_000, seed=0)
    batches = list(chronological_batches(g, full["batches"]))
    sched = SchedulerConfig(path="fused", regroup="bucket")
    scfg = SamplerConfig(bias="exponential", mode="index")
    cfg = EngineConfig(
        window=WindowConfig(duration=float(full["duration"]),
                            edge_capacity=full["edge_capacity"],
                            node_capacity=full["nodes"]),
        sampler=scfg, scheduler=sched)
    wcfg = WalkConfig(num_walks=full["walks"], max_length=full["length"],
                      start_mode="nodes")
    engine = StreamingEngine(cfg, full["edges_per_batch"])
    for s, d, t in batches[:full["batches"] // 2]:
        engine.ingest_batch(s, d, t)
    idx = engine.state.index
    s_node, s_time, u = cs.hop_inputs(idx, wcfg, scfg, sched,
                                      prng.PRNGKey(1), hops=3)
    h0_node, h0_time, h0_u = cs.hop_inputs(idx, wcfg, scfg, sched,
                                           prng.PRNGKey(1), hops=0)
    W, TW = s_node.shape[0], sched.tile_walks
    code = torch.full((W,), BIAS_EXPONENTIAL, dtype=torch.int32,
                      device=s_node.device)
    live = kf.fused_walk_step(idx, s_node, s_time, code, u, "index",
                              sched).n > 0
    live_tiles = int(live.reshape(-1, TW).any(1).nonzero().max()) + 1
    L = live_tiles * TW
    linear = torch.full_like(code, BIAS_LINEAR)
    inputs = {
        "hop0": ("index", (h0_node, h0_time, code, h0_u)),
        "hop3": ("index", (s_node, s_time, code, u)),
        "dead": ("index", (s_node, torch.full_like(s_time, 2**31 - 1), code,
                           u)),
        "live_tiles": ("index", (s_node[:L], s_time[:L], code[:L], u[:L])),
        "hop3_weight_exponential": ("weight", (s_node, s_time, code, u)),
        "hop3_weight_linear": ("weight", (s_node, s_time, linear, u)),
    }
    for name, (mode, args) in inputs.items():
        call = lambda: kf.fused_walk_step(   # noqa: E731
            idx, *args, mode, sched)
        out = call()
        digest = hashlib.sha1(torch.cat([x.reshape(-1) for x in out])
                              .cpu().numpy().tobytes()).hexdigest()
        print(json.dumps(dict(
            input=name, lanes=int(args[0].numel()),
            live_lanes=int((out.n > 0).sum()),
            ms=cs.device_ms(call, KERNELS),
            issue_ms=cs.cuda_ms(call, reps=20), outputs_sha1=digest)),
            flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
