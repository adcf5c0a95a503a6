#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds
every kernel against its plain PyTorch version on the card, drives the
streaming main path (ingest -> index rebuild -> fused-hop walks) at full
size through ``StreamingEngine.replay_device``, runs weight mode at a
reduced window, and prints one JSON line per phase. The last three lines
are the kernels table, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero. With
no CUDA device, or without the package next to it, it exits 2 and prints
no result.

The options exist to cut the run for a shorter time limit; every cut
against the full configuration is printed.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FULL = dict(nodes=1 << 22, edges_per_batch=1 << 22, batches=24,
            edge_capacity=1 << 26, duration=5_000_000, walks=1 << 20,
            length=80)
# The fused plain version runs on a lane subset of the full-width hop:
# this many random lanes plus this many tier-L lanes.
COMPARE_LANES = 4096
COMPARE_BIG_LANES = 128
# walks per batch in the reduced weight-mode phase (at most the main
# path's own count)
WEIGHT_WALKS = 1 << 14


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for name, value in FULL.items():
        p.add_argument("--" + name.replace("_", "-"), type=int, default=value)
    return p.parse_args(argv)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds per call, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, match, reps: int = 20):
    """Mean device milliseconds per call of the kernels whose names contain
    one of ``match``, from a torch.profiler trace; None if the trace holds
    no such device event. Unlike ``cuda_ms`` it excludes the host time the
    wrapper takes to issue a launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and any(m in e.name for m in match)]
    return sum(us) / reps / 1e3 if us else None


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def hop_inputs(index, wcfg, scfg, sched, key, hops: int):
    """Per-lane inputs of the fused hop after ``hops`` hops of a walk."""
    from repro_torch import random as prng
    from repro_torch.core import walk_engine as we
    start_key, walk_key = prng.split(key)
    carry = we.start_walks(index, wcfg, scfg, start_key)
    for step in range(hops):
        carry = we._hop_fused_bucket(index, scfg, sched, carry, step,
                                     prng.fold_in(walk_key, step))
    lane, s_node, s_time, _, _ = we._bucket_prologue(index, sched, carry)
    u = prng.uniform(prng.fold_in(walk_key, hops), (lane.shape[0],),
                     lane.device)[lane.long()]
    return s_node, s_time.contiguous(), u


def compare_fused(index, sched, s_node, s_time, code, u, mode, rng):
    """Kernel hop vs the plain version on a lane subset holding tier-L
    lanes; returns (lanes compared per tier, max |diff|)."""
    import torch
    from repro_torch.kernels import fused_step as kf
    split = kf.tier_split(index, s_node, sched)
    got = kf.fused_walk_step(index, s_node, s_time, code, u, mode, sched)
    big = split.big.cpu().numpy()
    W = big.shape[0]
    big_ids = rng.permutation(big.nonzero()[0])[:COMPARE_BIG_LANES]
    lanes = torch.as_tensor(sorted(set(rng.choice(W, size=min(COMPARE_LANES,
                                                              W),
                                                  replace=False).tolist())
                                   | set(big_ids.tolist())),
                            device=s_node.device)
    E = index.edge_capacity
    nc = index.node_capacity
    tbase = index.node_tbase[s_node.clamp(0, nc - 1).long()]
    want = kf.fused_step_plain(
        index.ns_ts[:E], index.ns_dst[:E], index.pexp, index.plin,
        split.a[lanes], split.b[lanes], s_time[lanes], code[lanes], u[lanes],
        tbase[lanes], mode=mode)
    err = 0
    for name, g, w in zip(("k", "n", "dst", "ts"), got[:4], want):
        diff = (g[lanes] != w).sum().item()
        require(diff == 0, f"fused {mode}: {diff} lanes differ in {name}")
        err = max(err, (g[lanes].long() - w.long()).abs().max().item())
    sel_big = split.big[lanes]
    require(int(sel_big.sum()) >= min(COMPARE_BIG_LANES, int(big.sum())),
            f"fused {mode}: too few tier-L lanes compared")
    return dict(tier_s=int((~sel_big).sum()), tier_l=int(sel_big.sum()),
                max_abs_err=err), split, got, lanes


def profile_batch(engine, batch, wcfg) -> dict:
    """Where one more batch of the main path spends its time: stage times
    by CUDA events, then kernel time by name and the device's busy share
    from a torch.profiler trace of the same batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import random as prng
    from repro_torch.core.edge_store import stack_batches, EdgeBatch
    from repro_torch.core.walk_engine import generate_walks
    from repro_torch.core.window import ingest
    cfg = engine.cfg
    stacked = stack_batches([batch], engine.batch_capacity,
                            device=engine.device)
    one = EdgeBatch(*(x[0] for x in stacked))
    key = prng.PRNGKey(7)
    nc = cfg.window.node_capacity

    def run():
        st = ingest(engine.state, one, nc)
        mid.record()
        generate_walks(st.index, key, wcfg, cfg.sampler, cfg.scheduler)

    start, mid, end = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    run()
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    out = dict(ingest_ms=start.elapsed_time(mid),
               walks_ms=mid.elapsed_time(end), wall_ms=wall_ms)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        spans.append((s, t))
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) / 1e3
    busy = 0.0
    last = -math.inf
    for s, t in sorted(spans):
        if t > last:
            busy += t - max(s, last)
            last = t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    # device kernels of one hop's draw, to set against the batch's total
    draw_key = prng.PRNGKey(8)
    prng.uniform(draw_key, (wcfg.num_walks,), engine.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_u:
        prng.uniform(draw_key, (wcfg.num_walks,), engine.device)
        torch.cuda.synchronize()
    out.update(uniform_kernels=sum(
        e.device_type == torch.autograd.DeviceType.CUDA
        for e in prof_u.events()))
    out.update(traced_wall_ms=traced_ms,
               device_busy_ms=busy / 1e3 if spans else None,
               device_idle_share=(1 - busy / 1e3 / traced_ms)
               if spans else None,
               kernels=len(spans),
               top_kernels_ms={k[:80]: v for k, v in top})
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch import random as prng
    from repro_torch.configs.base import (EngineConfig, SamplerConfig,
                                          SchedulerConfig, WalkConfig,
                                          WindowConfig)
    from repro_torch.core.samplers import BIAS_EXPONENTIAL
    from repro_torch.core.streaming import StreamingEngine
    from repro_torch.core.validation import validate_walks
    from repro_torch.core.walk_engine import WalkResult
    from repro_torch.data.synthetic import (chronological_batches,
                                            powerlaw_temporal_graph)
    from repro_torch.kernels import fused_step as kf
    from repro_torch.kernels import runtime
    from repro_torch.kernels.weight_prefix import (TOL_U, error_in_u,
                                                   weight_prefix,
                                                   weight_prefix_plain)

    dev = runtime.resolve_device(None)
    cuts = {k: v for k, v in vars(args).items()
            if k in FULL and v != FULL[k]}

    # ---- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    lib = runtime.build_library(verbose=True)
    runtime.library()
    card = card_line()
    emit("build", seconds=time.perf_counter() - t0, library=lib.name,
         card=card, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- data (not timed as part of the replay) --------------------------
    t0 = time.perf_counter()
    g = powerlaw_temporal_graph(
        args.nodes, args.edges_per_batch * args.batches, skew=1.2,
        t_max=10_000_000, seed=0)
    batches = list(chronological_batches(g, args.batches))
    emit("data", seconds=time.perf_counter() - t0, nodes=args.nodes,
         edges=int(g.src.shape[0]), batches=args.batches, cuts=cuts)

    sched = SchedulerConfig(path="fused", regroup="bucket")
    scfg = SamplerConfig(bias="exponential", mode="index")
    cfg = EngineConfig(
        window=WindowConfig(duration=float(args.duration),
                            edge_capacity=args.edge_capacity,
                            node_capacity=args.nodes),
        sampler=scfg, scheduler=sched)
    wcfg = WalkConfig(num_walks=args.walks, max_length=args.length,
                      start_mode="nodes")
    B = args.edges_per_batch

    # ---- phase 2: every kernel against its plain version ------------------
    rng = np.random.default_rng(0)
    warm = StreamingEngine(cfg, B)
    for s, d, t in batches[:max(1, args.batches // 2)]:
        warm.ingest_batch(s, d, t)
    idx = warm.state.index
    E = idx.edge_capacity
    s_node, s_time, u = hop_inputs(idx, wcfg, scfg, sched,
                                   prng.PRNGKey(1), hops=3)
    W = s_node.shape[0]
    code_exp = torch.full((W,), BIAS_EXPONENTIAL, dtype=torch.int32,
                          device=dev)
    cmp_index, split, _, lanes = compare_fused(
        idx, sched, s_node, s_time, code_exp, u, "index", rng)
    # weight mode: mixed codes; lanes over hub regions larger than 2^16
    # edges draw exponential (a binary search) instead of linear (a count
    # over the region)
    code_mix = (torch.arange(W, device=dev) % 3).to(torch.int32)
    region = split.b - split.a
    code_mix = torch.where(split.big & (region > (1 << 16)),
                           BIAS_EXPONENTIAL, code_mix).to(torch.int32)
    cmp_weight, *_ = compare_fused(
        idx, sched, s_node, s_time, code_mix, u, "weight", rng)

    # weight_prefix on the index's own exponential weights, against the
    # plain version's float64 prefix, in units of float32 roundoff of P
    nc = idx.node_capacity
    in_range = idx.ns_src < nc
    dt = (idx.ns_ts - idx.node_tref[idx.ns_src.clamp(0, nc - 1).long()]) \
        .to(torch.float32)
    wp_k = weight_prefix(dt, in_range)
    wp_p = weight_prefix_plain(dt, in_range)
    wp_err_u = error_in_u(wp_k, wp_p)
    wp_max_err = (wp_k - wp_p).abs().max().item()
    wp_reading = dict(max_abs_err=wp_max_err, max_err_u=wp_err_u,
                      p_max=wp_p[-1].item(),
                      tolerance=f"|diff| <= {TOL_U}*2^-24*P")
    require(wp_err_u <= TOL_U,
            f"weight_prefix exceeds its tolerance: {wp_reading}")
    require(bool((wp_k[1:] >= wp_k[:-1]).all()),
            "weight_prefix output is not non-decreasing")
    require(bool(torch.equal(wp_k, idx.pexp)), "pexp != weight_prefix")
    emit("kernels_vs_plain",
         fused_index=cmp_index, fused_weight=cmp_weight,
         weight_prefix=dict(**wp_reading, monotone=True),
         lanes=W, tier_l_lanes=int(split.big.sum()),
         window_edges=int(idx.num_edges))

    # timings at the main path's shapes (index mode, exponential bias)
    out = tuple(torch.empty(W, dtype=torch.int32, device=dev)
                for _ in range(4))
    tbase = idx.node_tbase[s_node.clamp(0, nc - 1).long()]
    args_s = (split.base_blocks, split.a, split.b, split.big, s_time, u,
              code_exp, tbase, idx.ns_ts[:E], idx.ns_dst[:E], idx.pexp,
              idx.plin)
    timed = {
        "fused_tier_s": (lambda: kf.fused_tier_s(
            *args_s, mode="index", tile_walks=sched.tile_walks,
            tile_edges=sched.tile_edges, out=out), ("fused_tier_s_kernel",)),
        "fused_tier_l": (lambda: kf.fused_tier_l(
            *args_s[1:], mode="index", out=out), ("fused_tier_l_kernel",)),
        "weight_prefix": (lambda: weight_prefix(dt, in_range),
                          ("wp_block_totals", "wp_chain", "wp_apply")),
    }
    # ms: device time per launch (profiler); issue_ms: per wrapper call by
    # CUDA events, which for a kernel shorter than its Python wrapper's
    # launch overhead measures the host
    times = {}
    for name, (call, match) in timed.items():
        issue = cuda_ms(call)
        dev_ms = device_ms(call, match)
        times[name] = dict(ms=issue if dev_ms is None else dev_ms,
                           ms_source="cuda_events" if dev_ms is None
                           else "profiler", issue_ms=issue)
    sub = lambda x: x[lanes]   # noqa: E731
    plain_args = (idx.ns_ts[:E], idx.ns_dst[:E], idx.pexp, idx.plin,
                  sub(split.a), sub(split.b), sub(s_time), sub(code_exp),
                  sub(u), sub(tbase))
    plain_ms = cuda_ms(lambda: kf.fused_step_plain(*plain_args,
                                                   mode="index"), reps=3)
    plain_wp = cuda_ms(lambda: weight_prefix_plain(dt, in_range))
    w_exp = torch.where(in_range, torch.exp(dt), 0.0)
    lib_wp = cuda_ms(lambda: torch.cumsum(w_exp, 0))
    n_big = int(split.big.sum())
    n_small = W - n_big
    live = out[1] > 0
    live_s = int((live & ~split.big).sum())
    live_l = int((live & split.big).sum())
    T = W // sched.tile_walks
    lane_io = 5 * 4 + 1 + 4 * 4          # a, b, time, u, code, big; 4 outputs
    bound_s = (n_small * lane_io + live_s * 8 + T * 4) / HBM_BYTES_PER_S * 1e3
    bound_l = (n_big * lane_io + live_l * 8) / HBM_BYTES_PER_S * 1e3
    bound_wp = (E * 5 + (E + 1) * 4) / HBM_BYTES_PER_S * 1e3
    del warm, idx, out, w_exp, dt, in_range, wp_k, wp_p
    torch.cuda.empty_cache()

    # ---- phase 3: the main path at full size ------------------------------
    engine = StreamingEngine(cfg, B)
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launches()
    stats, walks, secs = engine.replay_device(batches, wcfg,
                                              return_walks=True)
    launches = dict(runtime.LAUNCHES)
    K = args.batches
    hops_done = float(np.sum(args.walks * (stats.mean_len.astype(np.float64)
                                           - 1.0)))
    rep = validate_walks(engine.state.index, WalkResult(
        nodes=torch.as_tensor(walks.nodes, device=dev),
        times=torch.as_tensor(walks.times, device=dev),
        lengths=torch.as_tensor(walks.lengths, device=dev)))
    evicted = int(stats.ingested[-1]) - int(stats.edges_active[-1]) \
        - int(stats.late_drops[-1]) - int(stats.overflow_drops[-1])
    emit("main_path", seconds=secs, batches=K, walks_per_batch=args.walks,
         max_length=args.length,
         edges_per_s=int(stats.ingested[-1]) / secs,
         walks_per_s=K * args.walks / secs, hops_per_s=hops_done / secs,
         hop_valid_frac=rep.hop_valid_frac,
         walk_valid_frac=rep.walk_valid_frac, num_hops_checked=rep.num_hops,
         edges_active=stats.edges_active.tolist(),
         evicted=evicted, late_drops=int(stats.late_drops[-1]),
         overflow_drops=int(stats.overflow_drops[-1]),
         mean_len=stats.mean_len.tolist(), launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, cuts=cuts)
    require(rep.num_hops > 0 and rep.hop_valid_frac == 1.0,
            f"hop validity {rep.hop_valid_frac} over {rep.num_hops} hops")
    require(evicted > 0, "the window evicted no edge")
    hops_per_batch = args.length
    require(launches["fused_tier_s"] == hops_per_batch * K,
            f"tier-S launches {launches['fused_tier_s']} != hops x batches")
    require(launches["fused_tier_l"] == hops_per_batch * K,
            f"tier-L launches {launches['fused_tier_l']} != hops x batches")
    require(launches["weight_prefix"] == 2 * K,
            f"weight_prefix launches {launches['weight_prefix']} != 2 x K")
    emit("main_path_profile", **profile_batch(engine, batches[-1], wcfg))
    del engine, walks
    torch.cuda.empty_cache()

    # ---- phase 4: weight mode, linear and exponential, reduced window -----
    wn, wb, wK = 1 << 16, 1 << 18, 4
    wg = powerlaw_temporal_graph(wn, wb * wK, skew=1.2, t_max=10_000_000,
                                 seed=1)
    wbatches = list(chronological_batches(wg, wK))
    weight_runs = {}
    weight_walks = min(WEIGHT_WALKS, args.walks)
    for bias in ("linear", "exponential"):
        wcfg_w = WalkConfig(num_walks=weight_walks,
                            max_length=args.length, start_mode="nodes")
        cfg_w = EngineConfig(
            window=WindowConfig(duration=5_000_000.0, edge_capacity=1 << 20,
                                node_capacity=wn),
            sampler=SamplerConfig(bias=bias, mode="weight"), scheduler=sched)
        eng = StreamingEngine(cfg_w, wb)
        runtime.reset_launches()
        st, wk, sec = eng.replay_device(wbatches, wcfg_w, return_walks=True)
        got_launches = dict(runtime.LAUNCHES)
        r = validate_walks(eng.state.index, WalkResult(
            *(torch.as_tensor(x, device=dev)
              for x in (wk.nodes, wk.times, wk.lengths))))
        require(r.num_hops > 0 and r.hop_valid_frac == 1.0,
                f"weight/{bias}: hop validity {r.hop_valid_frac}")
        require(all(v > 0 for v in got_launches.values()),
                f"weight/{bias}: a kernel was not launched: {got_launches}")
        weight_runs[bias] = dict(seconds=sec, hop_valid_frac=r.hop_valid_frac,
                                 num_hops=r.num_hops, launches=got_launches)
    emit("weight_mode", runs=weight_runs,
         cuts=dict(nodes=wn, edges_per_batch=wb, batches=wK,
                   edge_capacity=1 << 20, walks=weight_walks))

    # small replay: the card's path equals the CPU plain versions byte for
    # byte in index mode (no float prefix is read there)
    sg = powerlaw_temporal_graph(512, 1 << 15, skew=1.2, t_max=100_000,
                                 seed=2)
    sb = list(chronological_batches(sg, 4))
    cfg_s = EngineConfig(
        window=WindowConfig(duration=50_000.0, edge_capacity=1 << 14,
                            node_capacity=512),
        sampler=SamplerConfig(bias="exponential", mode="index"),
        scheduler=SchedulerConfig(path="fused", tile_walks=64,
                                  tile_edges=256))
    wcfg_s = WalkConfig(num_walks=1024, max_length=16)
    res = {}
    for d in ("cuda", "cpu"):
        st, wk, _ = StreamingEngine(cfg_s, 1 << 13, device=d).replay_device(
            sb, wcfg_s, return_walks=True)
        res[d] = (st, wk)
    same = all(np.array_equal(a, b) for a, b in zip(res["cuda"][0],
                                                    res["cpu"][0])) and \
        all(np.array_equal(a, b) for a, b in zip(res["cuda"][1][:3],
                                                 res["cpu"][1][:3]))
    require(same, "small replay: card and CPU walks differ")
    emit("small_replay_cuda_equals_cpu", ok=True)

    # ---- kernels line, card line, contract line --------------------------
    kernels = [
        dict(name="fused_tier_s", route="cuda",
             source="src/repro_torch/csrc/fused_step.cu",
             replaces="src/repro/kernels/fused_step.py:406",
             launches=launches["fused_tier_s"],
             max_abs_err=max(cmp_index["max_abs_err"],
                             cmp_weight["max_abs_err"]),
             **times["fused_tier_s"], plain_ms=plain_ms,
             plain_lanes=int(lanes.numel()),
             bound_ms=bound_s, bound_by="bytes", library_ms=None),
        dict(name="fused_tier_l", route="cuda",
             source="src/repro_torch/csrc/fused_step.cu",
             replaces="src/repro/kernels/fused_step.py:450",
             launches=launches["fused_tier_l"],
             max_abs_err=max(cmp_index["max_abs_err"],
                             cmp_weight["max_abs_err"]),
             **times["fused_tier_l"], plain_ms=plain_ms,
             plain_lanes=int(lanes.numel()),
             bound_ms=bound_l, bound_by="bytes", library_ms=None),
        dict(name="weight_prefix", route="cuda",
             source="src/repro_torch/csrc/weight_prefix.cu",
             replaces="src/repro/kernels/weight_prefix.py:54",
             launches=launches["weight_prefix"],
             max_abs_err=wp_max_err,
             **times["weight_prefix"], plain_ms=plain_wp, bound_ms=bound_wp,
             bound_by="bytes", library_ms=lib_wp),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
