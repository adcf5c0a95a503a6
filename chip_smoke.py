#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds
every kernel against its plain PyTorch version on the card (the fused hop
``fused_hop``, one launch per hop for both tiers, ``weight_prefix`` with
its run-to-run determinism, and the tiled hop both as ``walk_step_hop``,
the tiled path's one launch per hop, and as ``walk_step_tiled``'s
tile-local contract), times one fused hop alone, drives the streaming
main path (ingest -> index rebuild -> fused-hop walks) at full size
through ``StreamingEngine.replay_device``, replays the same stream on the
tiled path, holds the seven first-order layouts to byte-identical walks
at full width, runs weight mode at a reduced window, serves 320 walk
queries through ``WalkService`` on the fused path against the main
path's window while its next batch is ingested (checked against solo
runs, the grouped path, a synchronous ring and the CPU), replays the
stream through the node-partitioned window with 4 shards on the card
(``DistributedStreamingEngine``, byte-equal to the single-device replay
across a live ``rebalance``), samples walk-axis-sharded walks on the
fused, tiled and grouped paths, holds small sharded replays, reshards
and the static walker to the CPU and to one shard, serves 40 queries
through ``WalkService(num_shards=4)`` on the main path's window while its
next batch is ingested (every ticket equal to the single-device
service's), holds small sharded services to the CPU and to single-device
solo runs, checkpoints a sharded window mid-stream and restores it at
another shard count (``StreamSupervisor``, ``restore_engine``), trains
2^22 × 64 skipgram embeddings on the main path's walks of the train split
and scores link prediction (``train_on_walks``, ``link_prediction_auc``),
holds small training runs and AdamW (int8 too) on the card to the CPU,
resumes a ``TrainSupervisor`` run from its checkpoint, trains olmo-1b at
full size on token streams of the main path's walks (``make_train_step``,
bf16, remat per block), serves qwen2-0.5b at full size from its KV cache
(prefill, cache fill, greedy decode with no host sync), holds both models
at full width and 2 layers on the card to the CPU, serves deepseek-v2-236b
(MLA, 160 routed experts) and arctic-480b (128 experts and a dense
residual) at full width and cut depth in bf16 on prompts of the same
walks, holds both MoE models reduced on the card to the CPU, trains
xlstm-125m (mLSTM and sLSTM) at full size on the same walks, serves it
and jamba-v0.1-52b (mamba, attention, MoE) at full width on one period
in bf16, holds both in float32 on the card to the CPU, trains
seamless-m4t-medium (an encoder over audio frames, cross-attention) at
full size on the same walks, serves it and qwen2-vl-72b (patches before
the text, M-RoPE) at full width on 2 layers in bf16, holds both reduced
in float32 on the card to the CPU, runs the six ``tools/examples`` entry
points in-process at their reference scripts' sizes, and prints
one JSON line per phase, each with its wall seconds (``wall_s``, since
the line before). The last three lines are the kernels
table, the card's name and power limit, and ``{"ok": true, "device":
{...}}``. Any failed phase exits non-zero. With no CUDA device, or
without the package next to it, it exits 2 and prints no result.

The options exist to cut the run for a shorter time limit; every cut
against the full configuration is printed.
"""
from __future__ import annotations

import argparse
import contextlib
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
TILED_MODES = (("index", "uniform"), ("index", "linear"),
               ("index", "exponential"), ("weight", "uniform"),
               ("weight", "linear"), ("weight", "exponential"))
# the reference's first-order layouts, which emit identical walks
LAYOUTS = (("fullwalk", "bucket"), ("grouped", "bucket"),
           ("grouped", "lexsort"), ("tiled", "bucket"), ("tiled", "lexsort"),
           ("fused", "bucket"), ("fused", "lexsort"))
# tasks of exact-fit lanes (hi == 2·TE) compared for walk_step_tiled
COMPARE_EXACT_TILES = 8


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for name, value in FULL.items():
        p.add_argument("--" + name.replace("_", "-"), type=int, default=value)
    return p.parse_args(argv)


_LAST_EMIT = [time.perf_counter()]


def emit(phase: str, **fields) -> None:
    """One JSON line for ``phase``; ``wall_s`` is the wall time since the
    previous line (the script's start for the first)."""
    now = time.perf_counter()
    wall, _LAST_EMIT[0] = now - _LAST_EMIT[0], now
    print(json.dumps({"phase": phase, "wall_s": wall, **fields}),
          flush=True)


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


# the primer that opens every trace (``trace_kernels``): int16
# bitwise_not_ launches in rounds of PRIMER_ROUND, each round followed by a
# sync, until at least PRIMER_ROUNDS rounds and PRIMER_MS of host time
PRIMER_ROUND = 64
PRIMER_ROUNDS = 4
PRIMER_MS = 20.0
# the closing primer lasts longer: a sharded walk batch's trace (~160,000
# kernels) has lost a whole 1,536-launch, 20 ms closer on the card
CLOSER_MS = 100.0
# over all traces: how many, the fewest primer launches, and the most
# events of the opening and of the closing primer a trace did not record
PRIMER = {"traces": 0, "launched_least": None, "lost_most_opening": 0,
          "lost_most_closing": 0}


def prime(primer, ms: float = PRIMER_MS) -> int:
    """Launch the primer's rounds, at least ``PRIMER_ROUNDS`` and for at
    least ``ms``; returns the launches."""
    import torch
    launched = 0
    t0 = time.perf_counter()
    while launched < PRIMER_ROUNDS * PRIMER_ROUND \
            or (time.perf_counter() - t0) * 1e3 < ms:
        for _ in range(PRIMER_ROUND):
            primer.bitwise_not_()
        launched += PRIMER_ROUND
        torch.cuda.synchronize()
    return launched


def trace_kernels(fn, host_ops: bool = False):
    """One call of ``fn`` under torch.profiler: ([(kernel name, start µs,
    end µs)] of the device, wall ms of the call). The trace opens with a
    primer of int16 ``bitwise_not_`` launches and syncs that lasts at
    least ``PRIMER_MS`` (``prime``), so that they are the device's first
    events, and closes with another on int8 (``CLOSER_MS``), so that they
    are its last: the
    first device events of a trace can go unrecorded (seen on the card: a
    decode step's ~800 kernels read ~57 fewer late in the script, and once
    a 256-launch primer was lost whole, so that the trace opened with the
    traced batch's own ``arange``), and the primer takes that loss. The
    leading run of events named as the first, which must be the primer's
    int16 kernel (the port's ``~mask`` on bool tensors is another
    instantiation, with another name), is left out of the result, and only
    it: 1 to all of the primer's launches, or ``fn``'s own first events
    may be lost; so is the trailing run of the closing primer's kernel,
    which must be the last event, 1 to all of its launches. ``PRIMER`` keeps the most primer events a
    trace lost.
    The events are read from the raw trace (``kineto_results``), minutes
    faster than the profiler's event tree for 10^5–10^6 kernels.
    ``host_ops`` also traces the host's ops, as the profiles of PR 11–21
    did, which lengthens the wall time a little."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    primer = torch.zeros(1, dtype=torch.int16, device="cuda")
    closer = torch.zeros(1, dtype=torch.int8, device="cuda")
    primer.bitwise_not_()
    closer.bitwise_not_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if host_ops else [])) as prof:
        launched = prime(primer)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        tail = prime(closer, CLOSER_MS)
    cuda = torch.autograd.DeviceType.CUDA
    events = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == cuda)
    first = events[0][2] if events else ""
    require("bitwise_not" in first and "bool" not in first,
            f"trace_kernels: the trace opens with {first!r}, not the primer "
            f"({launched} primer launches, {len(events)} device events)")
    kept = 0
    while kept < len(events) and events[kept][2] == first:
        kept += 1
    last = events[-1][2]
    require("bitwise_not" in last and "bool" not in last and last != first,
            f"trace_kernels: the trace closes with {last!r}, not the "
            f"closing primer ({tail} launches)")
    kept_tail = 0
    while kept_tail < len(events) - kept \
            and events[-1 - kept_tail][2] == last:
        kept_tail += 1
    require(kept <= launched and kept_tail <= tail,
            f"trace_kernels: {kept} leading and {kept_tail} trailing primer "
            f"events of {launched} and {tail} launched")
    PRIMER["traces"] += 1
    PRIMER["launched_least"] = min(launched, tail, PRIMER["launched_least"]
                                   or launched)
    PRIMER["lost_most_opening"] = max(PRIMER["lost_most_opening"],
                                      launched - kept)
    PRIMER["lost_most_closing"] = max(PRIMER["lost_most_closing"],
                                      tail - kept_tail)
    return [(n, s, t) for s, t, n in events[kept:len(events) - kept_tail]], \
        wall_ms


def device_ms(fn, match, reps: int = 20):
    """Mean device milliseconds per call of the kernels whose names contain
    one of ``match``, from a torch.profiler trace; None if the trace holds
    no such device event. Unlike ``cuda_ms`` it excludes the host time the
    wrapper takes to issue a launch."""
    import torch
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            fn()
    us = [t - s for name, s, t in trace_kernels(calls, host_ops=True)[0]
          if any(m in name for m in match)]
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
    lanes, and its ``tiers`` vs tier_split's; returns (lanes compared per
    tier, max |diff|), the split, the kernel's outputs and the lanes."""
    import torch
    from repro_torch.kernels import fused_step as kf
    split = kf.tier_split(index, s_node, sched)
    got = kf.fused_walk_step(index, s_node, s_time, code, u, mode, sched)
    require(torch.equal(got.tiers, split.tiers),
            f"fused {mode}: tiers {got.tiers.tolist()} != tier_split's "
            f"{split.tiers.tolist()}")
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


def grouped_hop_plain(index, s_node, s_time, code, u, mode="index"):
    """The fused hop by the grouped hop's exact plain functions, on every
    lane: temporal_cutoff, then index_pick_lanes (index mode) or
    weighted_pick_exp (weight mode, every code exponential), which equal
    the fused semantics where pexp is non-decreasing. Returns (k, n, dst,
    ts), 0 where n == 0."""
    import torch
    from repro_torch.core.samplers import index_pick_lanes, weighted_pick_exp
    from repro_torch.core.temporal_index import node_range, temporal_cutoff
    a, b = node_range(index, s_node)
    c = temporal_cutoff(index, a, b, s_time)
    n = b - c
    if mode == "index":
        k = c + index_pick_lanes(code, u, n)
    else:
        k = weighted_pick_exp(index.pexp, c, b, u)
    has = n > 0
    k = torch.where(has, k, 0)
    return (k, n, torch.where(has, index.ns_dst[k.long()], 0),
            torch.where(has, index.ns_ts[k.long()], 0))


def compare_fused_grouped(index, sched, s_node, s_time, code, u, mode):
    """Kernel hop vs ``grouped_hop_plain`` on every lane. Returns the lanes
    compared, the live ones and max |diff|."""
    from repro_torch.kernels import fused_step as kf
    if mode == "weight":
        require(bool((code == 2).all()), "weight mode: exponential only")
        require(bool((index.pexp[1:] >= index.pexp[:-1]).all()),
                "pexp is not non-decreasing")
    got = kf.fused_walk_step(index, s_node, s_time, code, u, mode, sched)
    want = grouped_hop_plain(index, s_node, s_time, code, u, mode)
    err = 0
    for name, g, w in zip(("k", "n", "dst", "ts"), got[:4], want):
        diff = int((g.long() != w.long()).sum())
        require(diff == 0, f"fused {mode} vs grouped: {diff} lanes differ in "
                           f"{name}")
        err = max(err, int((g.long() - w.long()).abs().max()))
    return dict(lanes=int(want[1].numel()), live=int((want[1] > 0).sum()),
                max_abs_err=err)


def fused_hop_reading(index, sched, s_node, s_time, code, u) -> dict:
    """One fused hop (index mode) alone: profiler kernels and device ms of
    one call, live lanes per tier, distinct regions of the live tier-L
    lanes, and how many live tier-L lanes the tiles hold."""
    import torch
    from repro_torch.kernels import fused_step as kf
    out = kf.fused_walk_step(index, s_node, s_time, code, u, "index", sched)
    split = kf.tier_split(index, s_node, sched)
    live = out.n > 0
    live_l = live & split.big
    per_tile = live_l.reshape(-1, sched.tile_walks).sum(1)
    call = profile_call(lambda: kf.fused_walk_step(index, s_node, s_time,
                                                   code, u, "index", sched))
    return dict(**call, lanes=int(live.numel()),
                tier_l_lanes=int(split.big.sum()),
                live_tier_s=int((live & ~split.big).sum()),
                live_tier_l=int(live_l.sum()),
                distinct_live_tier_l_regions=int(
                    torch.unique(split.a[live_l]).numel()),
                tiles=int(per_tile.numel()),
                tiles_with_live_tier_l=int((per_tile > 0).sum()),
                max_live_tier_l_per_tile=int(per_tile.max()))


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy = 0.0
    last = -math.inf
    for s, t in sorted(spans):
        if t > last:
            busy += t - max(s, last)
            last = t
    return busy


def kernel_reading(kernels, wall_ms, top: int = 8) -> dict:
    """Kernels, busy ms (the union of their spans), idle share and the
    largest kernels by device time of ``trace_kernels``' result."""
    by_name = {}
    for name, s, t in kernels:
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e3
    busy = busy_us([(s, t) for _, s, t in kernels]) / 1e3
    largest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(kernels=len(kernels), device_ms=busy, traced_wall_ms=wall_ms,
                device_idle_share=1 - busy / wall_ms if kernels else None,
                top_kernels_ms={k[:80]: v for k, v in largest})


def profile_call(fn) -> dict:
    """Device kernels, busy ms and idle share of one call of ``fn``, after
    a warm-up call, from a torch.profiler trace, with the largest kernels
    by device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    return kernel_reading(*trace_kernels(fn, host_ops=True))


def two_stage_hop(index, s_node, s_time, u, scfg, sched):
    """The tiled hop as the previous design ran it, for comparison: the
    tile-local walk_step_tiled on every lane, then the plain-torch global
    fallback (temporal_cutoff, pick_in_neighborhood) over every lane,
    merged by the oversize mask. Returns (k, n) like ops.walk_step."""
    import torch
    from repro_torch.core.samplers import pick_in_neighborhood
    from repro_torch.core.scheduler import panel_bounds, tile_table
    from repro_torch.core.temporal_index import temporal_cutoff
    from repro_torch.kernels.walk_step import walk_step_tiled
    E, TE = index.edge_capacity, sched.tile_edges
    tiles = tile_table(index, s_node, sched)
    lo, hi = panel_bounds(tiles, sched)
    prefix = index.plin if (scfg.mode, scfg.bias) == ("weight", "linear") \
        else index.pexp
    tbase = index.node_tbase[s_node.clamp(0, index.node_capacity - 1)
                             .long()]
    k_loc, n_k, _, _ = walk_step_tiled(
        index.ns_ts[:E], index.ns_dst[:E], prefix[:E], prefix[1:E + 1],
        tiles.base_blocks, s_time, lo, hi, u, tbase, mode=scfg.mode,
        bias=scfg.bias, tile_walks=sched.tile_walks, tile_edges=TE)
    k_kernel = (tiles.base_blocks * TE).repeat_interleave(sched.tile_walks) \
        + k_loc
    c = temporal_cutoff(index, tiles.a, tiles.b, s_time)
    k_fb = pick_in_neighborhood(index, scfg, c, tiles.b, u, s_node)
    return (torch.where(tiles.oversize, k_fb, k_kernel),
            torch.where(tiles.oversize, tiles.b - c, n_k))


def profile_batch(engine, batch, wcfg) -> dict:
    """Where one more batch of the main path spends its time: stage times
    by CUDA events, then kernel time by name and the device's busy share
    from a torch.profiler trace of the same batch."""
    import torch
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
    reading = kernel_reading(*trace_kernels(run, host_ops=True), top=12)
    # device kernels of one hop's draw, to set against the batch's total
    draw_key = prng.PRNGKey(8)
    prng.uniform(draw_key, (wcfg.num_walks,), engine.device)
    torch.cuda.synchronize()
    out.update(uniform_kernels=len(trace_kernels(
        lambda: prng.uniform(draw_key, (wcfg.num_walks,), engine.device),
        host_ops=True)[0]))
    out.update(traced_wall_ms=reading["traced_wall_ms"],
               device_busy_ms=reading["device_ms"] if reading["kernels"]
               else None,
               device_idle_share=reading["device_idle_share"],
               kernels=reading["kernels"],
               top_kernels_ms=reading["top_kernels_ms"])
    return out


def walk_step_bound_ms(index, sched, tiles, n, mode: str,
                       bias: str) -> float:
    """Least device time of one walk_step_hop launch, by bytes, for the
    lanes of ``tiles`` and the kernel's own ``n``: per lane a, b, time and
    u read (tbase too in weight/linear) and four int32 written; each
    task's base block; the distinct rows staged by the tasks that stage,
    rows [min lo, max hi] of their in-tile lanes with n > 0, read once:
    (ts, dst) up to the panel's last row, plus the prefix row P(j) in
    weight mode; and one (dst, ts) row per live oversize lane. Search
    probes are left out, so it is a lower bound."""
    import torch
    TW, TE = sched.tile_walks, sched.tile_edges
    P = 2 * TE
    W = n.shape[0]
    T = W // TW
    live_in = ~tiles.oversize & (n > 0)
    lo = torch.where(live_in, tiles.lo_raw, P + 1).reshape(T, TW).amin(1)
    hi = torch.where(live_in, tiles.hi_raw, -1).reshape(T, TW).amax(1)
    stages = hi >= 0
    base = tiles.base_blocks.long()[stages] * TE
    start = base + lo[stages]

    def distinct(end):
        mark = torch.zeros(index.edge_capacity + 2, dtype=torch.int32,
                           device=n.device)
        one = torch.ones_like(start, dtype=torch.int32)
        mark.index_add_(0, start, one)
        mark.index_add_(0, end, -one)
        return int((torch.cumsum(mark, 0) > 0).sum())

    rows = distinct(base + (hi[stages] + 1).clamp(max=P))
    pre_rows = distinct(base + hi[stages] + 1) if mode == "weight" else 0
    lane = (16 + (4 if (mode, bias) == ("weight", "linear") else 0)) + 16
    live_over = int((tiles.oversize & (n > 0)).sum())
    return (lane * W + 4 * T + 8 * rows + 4 * pre_rows + 8 * live_over) \
        / HBM_BYTES_PER_S * 1e3


def tiled_args(index, tiles, s_node, s_time, u, mode, bias):
    """Arguments of walk_step_tiled for one hop, as kernels/ops.py builds
    them; ``tiles`` is (base_blocks, lo, hi)."""
    E = index.edge_capacity
    prefix = index.plin if (mode, bias) == ("weight", "linear") \
        else index.pexp
    tbase = index.node_tbase[s_node.clamp(0, index.node_capacity - 1).long()]
    base_blocks, lo, hi = tiles
    return (index.ns_ts[:E], index.ns_dst[:E], prefix[:E], prefix[1:E + 1],
            base_blocks, s_time, lo, hi, u, tbase)


def hop_args(index, base_blocks, a, b, s_node, s_time, u, mode, bias):
    """Arguments of walk_step_hop for one hop, as kernels/ops.py builds
    them (tbase always given, so the plain version may read it)."""
    E = index.edge_capacity
    prefix = index.plin if (mode, bias) == ("weight", "linear") \
        else index.pexp
    tbase = index.node_tbase[s_node.clamp(0, index.node_capacity - 1).long()]
    return (index.ns_ts[:E], index.ns_dst[:E], prefix, base_blocks, s_time,
            a, b, u, tbase)


def exact_fit_tasks(index, sched, rng):
    """A task table on the real index whose lanes are exact fits
    (hi == 2·TE): each task stages the panel that ends where its node's
    region ends. Up to COMPARE_EXACT_TILES tasks over non-empty regions,
    and one over an empty region at a panel's end (lo == hi == 2·TE).
    Returns (base_blocks, s_node, s_time, u, lo, hi), or None if the
    index has no such region."""
    import torch
    TW, TE = sched.tile_walks, sched.tile_edges
    nc = index.node_capacity
    a = index.node_starts[:nc].long()
    b = index.node_starts[1:nc + 1].long()
    fits = (b % TE == 0) & (b >= 2 * TE) & (b - a <= 2 * TE)
    full = (fits & (b > a)).nonzero()[:, 0].cpu().numpy()
    empty = (fits & (b == a)).nonzero()[:, 0].cpu().numpy()
    nodes = list(rng.permutation(full)[:COMPARE_EXACT_TILES]) \
        + list(rng.permutation(empty)[:1])
    if not nodes:
        return None
    dev = index.ns_ts.device
    v = torch.as_tensor(nodes, device=dev).repeat_interleave(TW)
    av, bv = a[v], b[v]
    lo_t = index.ns_ts[av.clamp(max=index.edge_capacity - 1)]
    hi_t = index.ns_ts[(bv - 1).clamp(min=0)]
    frac = torch.as_tensor(rng.uniform(size=v.numel()), device=dev)
    s_time = (lo_t - 1 + (frac * (hi_t - lo_t + 2).double()).long()) \
        .to(torch.int32)
    u = torch.as_tensor(rng.uniform(size=v.numel()).astype("float32"),
                        device=dev)
    base = bv - 2 * TE
    return ((b[torch.as_tensor(nodes, device=dev)] // TE - 2)
            .to(torch.int32), v.to(torch.int32), s_time, u,
            (av - base).to(torch.int32), (bv - base).to(torch.int32))


def compare_walk_step(index, sched, s_node, s_time, u, rng):
    """For the six (mode, bias): walk_step_hop vs walk_step_hop_plain on
    every lane of the hop, in-tile and oversize; and walk_step_tiled vs
    walk_step_plain (the tile-local contract) on every lane in index mode
    and, in weight mode, on the lanes of a subset of its tiles that holds
    oversize lanes (and exact-fit lanes where the hop has any). Exact-fit
    tasks built on the same index are compared in every mode, by both.
    Returns the readings per mode, the size of the exact-fit tasks, the
    hop's task table and its clipped (lo, hi)."""
    import torch
    from repro_torch.core.scheduler import panel_bounds, tile_table
    from repro_torch.kernels import walk_step as kw
    TW, TE = sched.tile_walks, sched.tile_edges
    tiles = tile_table(index, s_node, sched)
    lo, hi = panel_bounds(tiles, sched)
    W = s_node.shape[0]
    T = W // TW
    over = tiles.oversize
    exact = ~over & (hi == 2 * TE)
    over_t = over.reshape(T, TW).any(1).cpu().numpy()
    exact_t = exact.reshape(T, TW).any(1).cpu().numpy()
    picked = set(rng.choice(T, size=min(T, COMPARE_LANES // TW),
                            replace=False).tolist())
    n_over = int(over.reshape(T, TW)[sorted(picked)].sum())
    for t in rng.permutation(over_t.nonzero()[0]).tolist():
        if n_over >= COMPARE_BIG_LANES:
            break
        if t not in picked:
            picked.add(t)
            n_over += int(over[t * TW:(t + 1) * TW].sum())
    picked |= set(rng.permutation(exact_t.nonzero()[0])
                  [:COMPARE_EXACT_TILES].tolist())
    sel = torch.as_tensor(sorted(picked), device=s_node.device)
    lanes = (sel[:, None] * TW + torch.arange(TW, device=sel.device)) \
        .reshape(-1)
    crafted = exact_fit_tasks(index, sched, rng)
    require(crafted is not None, "walk_step_tiled: the index holds no "
                                 "region that ends at a panel's end")
    c_base, c_node, c_time, c_u, c_lo, c_hi = crafted

    def check(what, got, want):
        err = 0
        for name, g, w in zip(("k", "n", "dst", "ts"), got, want):
            diff = int((g != w).sum())
            require(diff == 0, f"walk_step_tiled {what}: {diff} lanes "
                               f"differ in {name}")
            err = max(err, int((g.long() - w.long()).abs().max()))
        return err

    readings = {}
    for mode, bias in TILED_MODES:
        kwargs = dict(mode=mode, bias=bias, tile_walks=TW, tile_edges=TE)
        args = tiled_args(index, (tiles.base_blocks, lo, hi), s_node,
                          s_time, u, mode, bias)
        got = kw.walk_step_tiled(*args, **kwargs)
        if mode == "index":
            on = torch.arange(W, device=sel.device)
            want = kw.walk_step_plain(*args, **kwargs)
        else:
            on = lanes
            want = kw.walk_step_plain(
                *args[:4], tiles.base_blocks[sel],
                *(x[lanes] for x in args[5:]), **kwargs)
        err = check(f"{mode}/{bias}", [g[on] for g in got], want)
        c_args = tiled_args(index, (c_base, c_lo, c_hi), c_node, c_time,
                            c_u, mode, bias)
        err = max(err, check(f"{mode}/{bias} exact-fit tasks",
                             kw.walk_step_tiled(*c_args, **kwargs),
                             kw.walk_step_plain(*c_args, **kwargs)))
        n_ov = int(over[on].sum())
        require(n_ov > 0, f"walk_step_tiled {mode}/{bias}: no oversize "
                          "lane compared")
        # the one-launch hop: every lane, then the exact-fit tasks
        h_args = hop_args(index, tiles.base_blocks, tiles.a, tiles.b,
                          s_node, s_time, u, mode, bias)
        want_h = kw.walk_step_hop_plain(*h_args, **kwargs)
        err_h = check(f"hop {mode}/{bias}",
                      kw.walk_step_hop(*h_args, **kwargs), want_h)
        c_rows = (c_base.repeat_interleave(TW) * TE).to(torch.int32)
        ch_args = hop_args(index, c_base, c_lo + c_rows, c_hi + c_rows,
                           c_node, c_time, c_u, mode, bias)
        err_h = max(err_h, check(f"hop {mode}/{bias} exact-fit tasks",
                                 kw.walk_step_hop(*ch_args, **kwargs),
                                 kw.walk_step_hop_plain(*ch_args,
                                                        **kwargs)))
        live_ov = int((over & (want_h[1] > 0)).sum())
        require(live_ov > 0, f"walk_step_hop {mode}/{bias}: no live "
                             "oversize lane compared")
        readings[f"{mode}/{bias}"] = dict(
            lanes=int(on.numel()), oversize=n_ov,
            exact_fit=int(exact[on].sum()), max_abs_err=err,
            hop=dict(lanes=W, oversize=int(over.sum()),
                     live_oversize=live_ov,
                     live_in_tile=int((~over & (want_h[1] > 0)).sum()),
                     max_abs_err=err_h))
    crafted = dict(tasks=int(c_base.numel()), lanes=int(c_node.numel()),
                   empty_at_panel_end=int((c_lo == c_hi).sum()))
    return readings, crafted, tiles, (lo, hi)


def rows_differ(a, b) -> int:
    """Walks (rows) in which two WalkResults differ."""
    return int(((a.nodes != b.nodes).any(1) | (a.times != b.times).any(1)
                | (a.lengths != b.lengths)).sum())


def tier_shares(stats) -> dict:
    """Per-hop dispatch tiers from generate_walks(collect_stats=True):
    node tiers as shares of occupied nodes, fused tiers as shares of live
    lanes; means over the hops with live lanes, and hop 0."""
    import numpy as np
    from repro_torch.core import scheduler as sc
    st = stats.cpu().numpy().astype(np.float64)
    live = st[:, sc.STAT_ALIVE] > 0
    nodes = np.maximum(st[:, sc.STAT_UNIQUE_NODES], 1)
    lanes = np.maximum(st[:, sc.STAT_ALIVE], 1)
    share = dict(solo=st[:, sc.STAT_SOLO] / nodes,
                 group_smem=st[:, sc.STAT_GROUP_SMEM] / nodes,
                 group_global=st[:, sc.STAT_GROUP_GLOBAL] / nodes,
                 fused_small=st[:, sc.STAT_FUSED_SMALL] / lanes,
                 fused_big=st[:, sc.STAT_FUSED_BIG] / lanes)
    return dict(mean=({k: float(v[live].mean()) for k, v in share.items()}
                      if live.any() else None),
                hop0={k: float(v[0]) for k, v in share.items()},
                hops_with_live_lanes=int(live.sum()),
                live_lanes_per_hop=st[:, sc.STAT_ALIVE].astype(int).tolist())


@contextlib.contextmanager
def watch_tiled_bucket(observe):
    """Within the block, every tiled bucket hop that ``generate_walks``
    runs also calls ``observe(index, s_node, s_time, s_alive, u, scfg,
    sched, k, n)`` with that hop's own lanes, draws and picks; the walk
    loop stays ``generate_walks``' own."""
    from repro_torch.core import walk_engine as we
    prologue, step = we._bucket_prologue, we.walk_step
    alive = []

    def prologue_seen(index, sched, carry):
        out = prologue(index, sched, carry)
        alive[:] = [out[4]]
        return out

    def step_seen(index, s_node, s_time, u, scfg, sched):
        k, n = step(index, s_node, s_time, u, scfg, sched)
        observe(index, s_node, s_time, alive[0], u, scfg, sched, k, n)
        return k, n

    we._bucket_prologue, we.walk_step = prologue_seen, step_seen
    try:
        yield
    finally:
        we._bucket_prologue, we.walk_step = prologue, step


class OversizeShare:
    """Observer: per hop, the oversize lanes of all lanes and of the live
    lanes; ``reading`` gives the mean shares over the hops."""

    def __init__(self):
        self.rows = []
        self.lanes = 0

    def __call__(self, index, s_node, s_time, s_alive, u, scfg, sched, k,
                 n):
        import torch
        from repro_torch.core.scheduler import tile_table
        over = tile_table(index, s_node, sched).oversize
        self.lanes = over.numel()
        self.rows.append(torch.stack([over.sum(), (over & s_alive).sum(),
                                      s_alive.sum()]))

    def reading(self) -> dict:
        import numpy as np
        import torch
        r = torch.stack(self.rows).cpu().numpy().astype(np.float64)
        live = r[:, 2] > 0
        return dict(of_all_lanes=float(np.mean(r[:, 0] / self.lanes)),
                    of_live_lanes=float(np.mean(r[live, 1] / r[live, 2]))
                    if live.any() else None,
                    hop0_of_live_lanes=float(r[0, 1] / max(r[0, 2], 1)),
                    hops_with_live_lanes=int(live.sum()))


class LinearDisagreements:
    """Observer: why weight/linear walks differ between tiled and grouped.
    Each hop's tiled pick is set against the grouped pick of the same
    lanes and draws. A lane can differ only where the tiled kernel counts
    S(j) < u·S(hi−1) over a region in which S is not monotone (the
    grouped binary search then stops at another crossing), so every
    differing lane must be in-tile with a non-monotone S; ``reading``
    checks this."""

    def __init__(self):
        self.differ = self.in_tile = self.non_monotone = self.live = 0
        self.plin_max = None

    def __call__(self, index, s_node, s_time, s_alive, u, scfg, sched, k,
                 n):
        import torch
        from repro_torch.core.samplers import pick_in_neighborhood
        from repro_torch.core.scheduler import tile_table
        from repro_torch.core.temporal_index import temporal_cutoff
        tiles = tile_table(index, s_node, sched)
        c = temporal_cutoff(index, tiles.a, tiles.b, s_time)
        k_g = pick_in_neighborhood(index, scfg, c, tiles.b, u, s_node)
        ok = s_alive & (n > 0)
        d = (ok & (k != k_g)).nonzero()[:, 0]
        self.live += int(ok.sum())
        self.differ += int(d.numel())
        self.in_tile += int((~tiles.oversize[d]).sum())
        self.plin_max = float(index.plin.max())
        if d.numel():
            span = 2 * sched.tile_edges
            cd, bd = c[d].long(), tiles.b[d].long()
            j = cd[:, None] + torch.arange(span, device=d.device)
            inside = j < bd[:, None]
            jc = j.clamp(max=index.edge_capacity - 1)
            delta = (index.ns_ts[cd.clamp(max=index.edge_capacity - 1)]
                     - index.node_tbase[s_node[d].long()]).to(torch.float32)
            sj = (index.plin[jc + 1] - index.plin[cd][:, None]) \
                - (jc + 1 - cd[:, None]).to(torch.float32) * delta[:, None]
            down = (sj[:, 1:] < sj[:, :-1]) & inside[:, 1:]
            self.non_monotone += int(down.any(1).sum())

    def reading(self) -> dict:
        require(self.in_tile == self.differ
                and self.non_monotone == self.differ,
                f"weight/linear: {self.differ} picks differ, "
                f"{self.in_tile} in-tile, {self.non_monotone} over a "
                "non-monotone S")
        return dict(live_picks=self.live, picks_differ=self.differ,
                    in_tile=self.in_tile, non_monotone_s=self.non_monotone,
                    plin_max=self.plin_max)


def paths_agree(index, wcfg):
    """The seven layouts from one key at full width: index/exponential
    walks byte-identical; weight mode, tiled against grouped. The tiled
    bucket runs carry an observer (``with_observer``, so their seconds are
    no path timing): the index one reads the oversize share per hop, the
    weight/linear one the cause of any pick that differs from grouped.
    Returns the readings, the oversize share and the grouped-bucket run's
    per-hop ``dispatch_stats``."""
    import torch
    from repro_torch import random as prng
    from repro_torch.configs.base import SamplerConfig, SchedulerConfig
    from repro_torch.core.validation import validate_walks
    from repro_torch.core.walk_engine import generate_walks
    key = prng.PRNGKey(11)

    def run(scfg, path, regroup, stats=False, observe=None):
        with (watch_tiled_bucket(observe) if observe
              else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w = generate_walks(index, key, wcfg, scfg,
                               SchedulerConfig(path=path, regroup=regroup),
                               collect_stats=stats)
            torch.cuda.synchronize()
        return w, time.perf_counter() - t0

    scfg = SamplerConfig(bias="exponential", mode="index")
    ref, secs = run(scfg, *LAYOUTS[0])
    rep = validate_walks(index, ref)
    require(rep.num_hops > 0 and rep.hop_valid_frac == 1.0,
            f"paths_agree: fullwalk hop validity {rep.hop_valid_frac}")
    layouts = {"fullwalk-bucket": dict(seconds=secs, walks_differ=0)}
    stats = None
    share = OversizeShare()
    for path, regroup in LAYOUTS[1:]:
        keep = (path, regroup) == ("grouped", "bucket")
        watch = (path, regroup) == ("tiled", "bucket")
        w, secs = run(scfg, path, regroup, stats=keep,
                      observe=share if watch else None)
        if keep:
            stats = w.stats
        layouts[f"{path}-{regroup}"] = dict(seconds=secs,
                                            walks_differ=rows_differ(ref, w),
                                            with_observer=watch)
        del w
    bad = {k: v["walks_differ"] for k, v in layouts.items()
           if v["walks_differ"]}
    require(not bad, f"paths_agree: walks differ from fullwalk: {bad}")
    weight = {}
    for bias in ("linear", "exponential"):
        ws = SamplerConfig(bias=bias, mode="weight")
        cause = LinearDisagreements() if bias == "linear" else None
        g, g_secs = run(ws, "grouped", "bucket")
        t, t_secs = run(ws, "tiled", "bucket", observe=cause)
        rg, rt = validate_walks(index, g), validate_walks(index, t)
        require(rg.hop_valid_frac == 1.0 and rt.hop_valid_frac == 1.0,
                f"paths_agree weight/{bias}: hop validity grouped "
                f"{rg.hop_valid_frac}, tiled {rt.hop_valid_frac}")
        weight[bias] = dict(walks_differ=rows_differ(g, t),
                            grouped_seconds=g_secs, tiled_seconds=t_secs,
                            with_observer=cause is not None,
                            hop_valid_frac=rt.hop_valid_frac,
                            num_hops=rt.num_hops)
        del g, t
        if cause is not None:
            weight[bias]["cause"] = cause.reading()
    return dict(walks=wcfg.num_walks, max_length=wcfg.max_length,
                window_edges=int(index.num_edges), index_exponential=layouts,
                hop_valid_frac=rep.hop_valid_frac, num_hops=rep.num_hops,
                weight_tiled_vs_grouped=weight), share.reading(), stats


# the serving phase: queries in all (five waves; 1,024 until the recurrent
# LM phases, 512 until the enc-dec ones needed the seconds), per wave, and
# compared with solo runs (64 until the pipeline phase needed the seconds)
SERVE_QUERIES = 320
SERVE_WAVE = 64
SERVE_SOLO = 32
# window batches ingested before serving; the next is ingested while
# serving (begin_ingest after half the waves, publish two waves later)
SERVE_WINDOW_BATCHES = 12
SERVE_HUB_SHARE = 0.01
SERVE_TILE_WALKS = 64


def serve_traffic(rng, num_nodes, hubs, n=SERVE_QUERIES, max_length=80):
    """The serving phase's queries: ~70% nodes mode with 1-64 start nodes,
    half of them drawn from ``hubs``; ~30% edges mode with 16-256 walks;
    bias, start bias and max_length 3-``max_length`` at random; distinct
    seeds."""
    import numpy as np
    from repro_torch.serve import WalkQuery
    biases = ("uniform", "linear", "exponential")
    seeds = rng.choice(1 << 30, size=n, replace=False) - (1 << 29)
    out = []
    for seed in seeds:
        bias, start_bias = (biases[i] for i in rng.integers(0, 3, 2))
        length = int(rng.integers(3, max_length + 1))
        if rng.uniform() < 0.7:
            k = int(rng.integers(1, 65))
            starts = np.where(rng.uniform(size=k) < 0.5,
                              rng.choice(hubs, size=k),
                              rng.integers(0, num_nodes, size=k))
            out.append(WalkQuery(start_nodes=tuple(int(v) for v in starts),
                                 bias=bias, max_length=length,
                                 seed=int(seed)))
        else:
            out.append(WalkQuery(num_walks=int(rng.integers(16, 257)),
                                 start_mode="edges", bias=bias,
                                 start_bias=start_bias, max_length=length,
                                 seed=int(seed)))
    return out


def drive_serve(svc, queries, next_batch, observe=None, wave=SERVE_WAVE):
    """Serve ``queries`` in waves of ``wave``: submit a wave, tick(),
    and while queries of the wave wait for room in the in-flight ring,
    harvest the ring and tick() again, so a batch's queries and snapshot
    version do not depend on device timing. ``begin_ingest(next_batch)``
    runs after half the waves and ``publish()`` two waves later.
    ``observe(wcfg)`` is called for every batch launched. Returns
    ({ticket: result}, wall seconds, {version: pinned window})."""
    import torch
    launch = svc._launch_lanes

    def observed(params, wcfg, pin, **kw):
        observe(wcfg)
        return launch(params, wcfg, pin, **kw)
    if observe is not None:
        svc._launch_lanes = observed
    states = {svc.snapshots.version: svc.snapshots.acquire().state}
    waves = [queries[i:i + wave] for i in range(0, len(queries), wave)]
    tickets = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w, qs in enumerate(waves):
        if w == len(waves) // 2:
            svc.begin_ingest(*next_batch)
        if w == len(waves) // 2 + 2:
            svc.publish()
            states[svc.snapshots.version] = svc.snapshots.acquire().state
        tickets += [svc.submit(q) for q in qs]
        svc.tick()
        while svc.pending_count:
            svc.pump(block=True)
            svc.tick()
    svc.pump(block=True)
    secs = time.perf_counter() - t0
    svc._launch_lanes = launch
    require(None not in tickets, "serve: a query was dropped at submit")
    return {t: svc.poll(t) for t in tickets}, secs, states


def results_differ(a: dict, b: dict) -> int:
    """Tickets whose (nodes, times, lengths, snapshot_version) differ."""
    import numpy as np
    return sum(not (np.array_equal(a[t].nodes, b[t].nodes)
                    and np.array_equal(a[t].times, b[t].times)
                    and np.array_equal(a[t].lengths, b[t].lengths)
                    and a[t].snapshot_version == b[t].snapshot_version)
               for t in a)


def no_host_sync(fn):
    """``fn`` under torch.cuda.set_sync_debug_mode("error"): any call that
    waits for the device inside it raises."""
    import torch

    def run(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return run


def served_validity(results: dict, states: dict, max_length: int) -> dict:
    """Hop validity of every served walk against the window of the version
    its result reports."""
    import numpy as np
    import torch
    from repro_torch.core.validation import validate_walks
    from repro_torch.core.walk_engine import NODE_PAD, WalkResult
    out = {}
    for version, state in states.items():
        rs = [r for r in results.values() if r.snapshot_version == version]
        require(rs, f"serve: no result ran against version {version}")
        pad = lambda x: np.pad(  # noqa: E731
            x, ((0, 0), (0, max_length + 1 - x.shape[1])),
            constant_values=NODE_PAD)
        dev = state.index.ns_ts.device
        walks = WalkResult(*(torch.as_tensor(np.concatenate(x), device=dev)
                             for x in ([pad(r.nodes) for r in rs],
                                       [pad(r.times) for r in rs],
                                       [r.lengths for r in rs])))
        rep = validate_walks(state.index, walks)
        require(rep.num_hops > 0 and rep.hop_valid_frac == 1.0,
                f"serve: hop validity {rep.hop_valid_frac} at version "
                f"{version}")
        out[str(version)] = dict(queries=len(rs), walks=rep.num_walks,
                                 num_hops=rep.num_hops,
                                 hop_valid_frac=rep.hop_valid_frac)
    return out


def lane_hop_inputs(index, key, lanes, wcfg, scfg, sched, hops: int):
    """Lane-order inputs of the fused hop after ``hops`` hops of a lane
    batch (what generate_walk_lanes hands fused_hop at hop ``hops``)."""
    import torch
    from repro_torch.core import walk_engine as we
    lane_keys = we._lane_keys(key, lanes)
    carry = we.start_walks(index, wcfg, scfg, key, lanes=lanes,
                           lane_keys=lane_keys)
    us = we._lane_uniform(lane_keys, torch.arange(
        1, hops + 2, device=lane_keys.device)[:, None])
    for step in range(hops):
        carry = we._hop_fused_bucket(
            index, scfg, sched, carry, step, None, lane_bias=lanes.bias,
            lane_u=us[step], lane_limit=(step + 1) <= lanes.max_len)
    lane, s_node, s_time, _, _ = we._bucket_prologue(index, sched, carry)
    order = lane.long()
    return (s_node, s_time.contiguous(), lanes.bias[order].contiguous(),
            us[hops][order].contiguous())


def profile_lane_batch(call, hops: int, draw_call,
                       host_ops: bool = True) -> dict:
    """Device kernels, busy ms and idle share of one lane batch, from a
    torch.profiler trace; the kernels of its all-hops lane draw alone.
    ``host_ops=False`` traces the device alone: the host ops of a sharded
    batch's ~160,000 kernels make its trace slow to read back, and their
    own tracing lengthens the wall time."""
    import torch
    call()
    torch.cuda.synchronize()
    kernels, wall_ms = trace_kernels(call, host_ops)
    spans = [(s, t) for _, s, t in kernels]
    busy = busy_us(spans) / 1e3
    draw = profile_call(draw_call)["kernels"]
    return dict(kernels=len(spans), kernels_per_hop=len(spans) / hops,
                draw_kernels=draw,
                kernels_per_hop_without_draw=(len(spans) - draw) / hops,
                device_busy_ms=busy, traced_wall_ms=wall_ms,
                device_idle_share=1 - busy / wall_ms, hops=hops,
                host_ops_traced=host_ops)


def serve_window(cfg, serve_cfg, batches, dev, **kw):
    """A WalkService (``kw``: e.g. ``num_shards``) over the first
    SERVE_WINDOW_BATCHES batches of the main path's stream, ingested one
    by one."""
    import torch
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.serve import WalkService
    svc = WalkService(cfg, serve_cfg, batch_capacity=max(
        len(b[0]) for b in batches), registry=MetricsRegistry(), device=dev,
        **kw)
    t0 = time.perf_counter()
    for b in batches[:SERVE_WINDOW_BATCHES]:
        svc.ingest(*b)
    torch.cuda.synchronize()
    return svc, time.perf_counter() - t0


def serve_path(args, cfg, batches, dev) -> dict:
    """The serving path at full size: SERVE_QUERIES queries on the main
    path's window through WalkService on the fused path, with an ingest
    overlapped; checked against solo runs, the grouped path and the
    synchronous ring, for hop validity and for host syncs in the launch.
    Returns the phase reading and the fused_hop numbers at a served
    batch's shapes."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import (SchedulerConfig, ServeConfig,
                                          WalkConfig)
    from repro_torch.core import walk_engine as we
    from repro_torch.kernels import fused_step as kf
    from repro_torch.kernels import runtime
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.serve import WalkQuery, WalkService, pack_queries
    require(len(batches) > SERVE_WINDOW_BATCHES,
            f"serve: needs more than {SERVE_WINDOW_BATCHES} batches")
    rng = np.random.default_rng(3)
    # 64-lane tiles: every lane bucket of the default ServeConfig is a
    # whole number of tiles, as the fused hop requires
    sched = SchedulerConfig(path="fused", regroup="bucket",
                            tile_walks=SERVE_TILE_WALKS)
    cfg_f = dataclasses.replace(cfg, scheduler=sched)
    svc, window_s = serve_window(cfg_f, ServeConfig(), batches, dev)
    nc = cfg.window.node_capacity
    idx = svc.snapshots.current.index
    deg = idx.node_starts[1:nc + 1] - idx.node_starts[:nc]
    hubs = torch.topk(deg, max(1, int(nc * SERVE_HUB_SHARE))).indices
    hubs = hubs.cpu().numpy()
    queries = serve_traffic(rng, nc, hubs)
    next_batch = batches[SERVE_WINDOW_BATCHES]

    # the main path: counts set to 0 just before, read just after
    hops = []
    svc._launch = no_host_sync(svc._launch)
    runtime.reset_launches()
    results, secs, states = drive_serve(
        svc, queries, next_batch,
        observe=lambda w: hops.append(w.max_length
                                      - (w.start_mode == "edges")))
    launches = dict(runtime.LAUNCHES)
    st = svc.stats
    require(st.completed == len(queries) and st.dropped == 0
            and all(r is not None for r in results.values()),
            f"serve: {st.completed} of {len(queries)} completed, "
            f"{st.dropped} dropped")
    require(launches["fused_hop"] == sum(hops),
            f"serve: fused_hop launches {launches['fused_hop']} != hops "
            f"served {sum(hops)}")
    require(launches["walk_step_tiled"] == 0,
            f"serve: walk_step_tiled launched: {launches}")
    require(launches["weight_prefix"] == 2,
            f"serve: weight_prefix launches {launches['weight_prefix']} "
            "!= 2 for one begin_ingest")
    validity = served_validity(results, states, 80)

    # solo runs at the exact query shape (one-lane tiles), against the
    # window of the version each result reports
    solo_cfg = dataclasses.replace(cfg, scheduler=dataclasses.replace(
        sched, tile_walks=1))
    solo = {v: WalkService(solo_cfg, state=state, registry=MetricsRegistry())
            for v, state in states.items()}
    picked = rng.choice(sorted(results), size=SERVE_SOLO, replace=False)
    solo_differ = 0
    for t in picked:
        r = results[int(t)]
        got = solo[r.snapshot_version].run_query_solo(r.query)
        solo_differ += not all(np.array_equal(a, b) for a, b in zip(
            got, (r.nodes, r.times, r.lengths)))
    require(solo_differ == 0,
            f"serve: {solo_differ} of {SERVE_SOLO} queries differ from solo")
    del solo

    # one 4096-lane x 80 batch: kernels per dispatch and per hop, device
    # busy share; fused_hop at its shapes against the plain version
    W, L = 4096, 80
    per = W // 64
    prof_q = [WalkQuery(
        start_nodes=tuple(int(v) for v in np.where(
            rng.uniform(size=per) < 0.5, rng.choice(hubs, size=per),
            rng.integers(0, nc, size=per))),
        bias=("uniform", "linear", "exponential")[i % 3], max_length=L,
        seed=7 * i + 1) for i in range(64)]
    params, _ = pack_queries(prof_q, W, L, device=dev)
    wcfg = WalkConfig(num_walks=W, max_length=L, start_mode="nodes")
    index = states[max(states)].index
    key = svc.base_key
    profile = profile_lane_batch(
        lambda: we.generate_walk_lanes(index, key, params, wcfg,
                                       cfg.sampler, sched), L,
        lambda: we._lane_uniform(we._lane_keys(key, params), torch.arange(
            1, L + 1, device=dev)[:, None]))
    s_node, s_time, code, u = lane_hop_inputs(index, key, params, wcfg,
                                              cfg.sampler, sched, hops=3)
    cmp_serve, _, out, _ = compare_fused(index, sched, s_node, s_time, code,
                                         u, "index", rng)
    call = lambda: kf.fused_walk_step(  # noqa: E731
        index, s_node, s_time, code, u, "index", sched)
    hop_ms = device_ms(call, ("fused_hop_kernel",))
    live = int((out.n > 0).sum())
    bound = (W * (6 * 4 + 4 * 4) + live * 8 + 3 * 4) / HBM_BYTES_PER_S * 1e3
    reading = dict(
        queries=len(queries), window_batches=SERVE_WINDOW_BATCHES,
        window_edges=int(states[min(states)].index.num_edges),
        window_ingest_seconds=window_s, seconds=secs,
        walks=st.walks, hops=st.hops, walks_per_s=st.walks_per_s,
        hops_per_s=st.steps_per_s, walks_per_wall_s=st.walks / secs,
        hops_per_wall_s=st.hops / secs, p50_ms=st.p50_ms, p99_ms=st.p99_ms,
        batches=st.batches, lane_occupancy=st.lane_occupancy,
        lanes_dispatched=st.lanes_dispatched, lanes_live=st.lanes_live,
        hops_launched=sum(hops), launches=launches,
        versions=sorted(states), validity=validity,
        solo_equal=SERVE_SOLO, launch_host_syncs=0,
        tile_walks=SERVE_TILE_WALKS, batch_4096x80=profile,
        fused_hop_4096=dict(hop=3, lanes=W, live_lanes=live, ms=hop_ms,
                            issue_ms=cuda_ms(call), bound_ms=bound,
                            vs_plain=cmp_serve))
    del svc, states, index, params, s_node, s_time, code, u, out, idx, deg
    torch.cuda.empty_cache()

    # the same traffic on the grouped path and on a synchronous ring
    for name, c, serve_cfg in (
            ("grouped", dataclasses.replace(cfg, scheduler=dataclasses.replace(
                sched, path="grouped")), ServeConfig()),
            ("max_inflight_1", cfg_f, ServeConfig(max_inflight=1))):
        other, _ = serve_window(c, serve_cfg, batches, dev)
        got, other_secs, _ = drive_serve(other, queries, next_batch)
        differ = results_differ(results, got)
        require(differ == 0, f"serve: {differ} tickets differ on {name}")
        reading[f"equal_{name}"] = dict(tickets=len(got), differ=differ,
                                        seconds=other_secs)
        del other, got
        torch.cuda.empty_cache()
    return dict(reading=reading, launches=launches, fused_max_abs_err=(
        cmp_serve["max_abs_err"]), fused_hop=dict(
            serve_launches=launches["fused_hop"], serve_lanes=W,
            serve_tile_walks=SERVE_TILE_WALKS, serve_ms=hop_ms,
            serve_bound_ms=bound))


def serve_cuda_equals_cpu(dev) -> dict:
    """The same queries served on a tiny window on the card and on the
    CPU: equal results for every ticket."""
    import numpy as np
    from repro_torch.configs.base import (EngineConfig, SamplerConfig,
                                          SchedulerConfig, ServeConfig,
                                          WindowConfig)
    from repro_torch.data.synthetic import (chronological_batches,
                                            powerlaw_temporal_graph)
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.serve import WalkService
    g = powerlaw_temporal_graph(512, 1 << 15, skew=1.2, t_max=100_000,
                                seed=2)
    stream = list(chronological_batches(g, 4))
    cfg = EngineConfig(
        window=WindowConfig(duration=50_000.0, edge_capacity=1 << 14,
                            node_capacity=512),
        sampler=SamplerConfig(mode="index"),
        scheduler=SchedulerConfig(path="fused", tile_walks=64,
                                  tile_edges=256))
    queries = serve_traffic(np.random.default_rng(4), 512,
                            np.arange(8), n=48)
    out = {}
    for d in (dev, "cpu"):
        svc = WalkService(cfg, ServeConfig(), batch_capacity=1 << 13,
                          registry=MetricsRegistry(), device=d)
        for b in stream[:3]:
            svc.ingest(*b)
        out[str(d)], _, _ = drive_serve(svc, queries, stream[3], wave=8)
    differ = results_differ(out[str(dev)], out["cpu"])
    require(differ == 0, f"serve: {differ} tickets differ, card vs CPU")
    return dict(tickets=len(queries), differ=differ,
                versions=sorted({r.snapshot_version
                                 for r in out["cpu"].values()}))


# ---- alias tables, node2vec and probes ------------------------------------
# batches of the main stream replayed on the table path (24 until the
# recurrent LM phases, 16 until the pipeline phase needed the seconds; the
# window fills after 12, so the last two evict and maintain their tables)
TABLE_BATCHES = 14
# served queries of serve_tables (32 until the enc-dec LM phases needed
# the seconds), compared with solo runs (16 until the pipeline phase)
SERVE_TABLE_QUERIES = 24
SERVE_TABLE_SOLO = 8
# node2vec phases: (p, q) of the config walks
N2V_PQ = (0.5, 2.0)
# tables_cuda_equals_cpu's served queries, in five waves (18 in six until
# the enc-dec LM phases needed the seconds)
TABLES_EQ_QUERIES = 15
TABLES_EQ_WAVE = 3


def count_syncs(fn):
    """(fn(), host syncs, {site: syncs}): the calls inside fn that wait
    for the device, each counted once under
    torch.cuda.set_sync_debug_mode("warn"), by the line of the repository
    that made them. An explicit torch.cuda.synchronize (a line of torch
    itself, which the warning does not always report) is left out."""
    import os
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = {}
    for w in caught:
        if ("synchroniz" in str(w.message)
                and os.path.dirname(torch.__file__) not in w.filename):
            site = f"{os.path.basename(w.filename)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return out, sum(sites.values()), sites


def ingest_readings(state, batch, nc, spec) -> dict:
    """One more batch on a table-carrying window: ingest ms with and
    without tables (CUDA events, in turns), the incremental update and the
    from-scratch build alone, device kernels of each ingest, and the dirty
    nodes of this advance, those with a region (the ``rebuilt``
    increment) and those rebuilt as rows (region within degree_cap)."""
    import torch
    from repro_torch.core import window as tw
    from repro_torch.core.alias import build_tables, update_tables
    from repro_torch.core.edge_store import EdgeBatch, stack_batches
    stacked = stack_batches([batch], batch[0].shape[0], device=state.t_now.device)
    one = EdgeBatch(*(x[0] for x in stacked))
    plain = lambda: tw.ingest(state, one, nc)   # noqa: E731
    tabled = lambda: tw.ingest(state, one, nc, table=spec)  # noqa: E731
    run_s, run_b, _, _, evict_to = tw._prepare_runs(
        state.index.store, state.t_now, state.window, one, nc)
    merged = tw._merge_runs(run_s, run_b)
    dirty = tw._dirty_nodes(state, run_b, merged, run_s[3], run_b[3],
                            evict_to, nc)
    new = plain()
    update = lambda: update_tables(  # noqa: E731
        new.index, spec, old_starts=state.index.node_starts,
        old_tables=state.tables, dirty=dirty)
    ms = {}
    for name, fn in (("ingest_ms", plain), ("ingest_tables_ms", tabled),
                     ("ingest_tables_ms_again", tabled),
                     ("ingest_ms_again", plain)):
        ms[name] = cuda_ms(fn, reps=3, warmup=1)
    ms["update_ms"] = cuda_ms(update, reps=3, warmup=1)
    ms["build_ms"] = cuda_ms(lambda: build_tables(new.index, spec), reps=3,
                             warmup=1)
    deg = new.index.node_starts[1:nc + 1] - new.index.node_starts[:nc]
    out = dict(**ms, kernels_ingest=profile_call(plain)["kernels"],
               kernels_ingest_tables=profile_call(tabled)["kernels"],
               kernels_update=profile_call(update)["kernels"],
               dirty_nodes=int(dirty.sum()),
               rebuilt_nodes=int((dirty & (deg > 0)).sum()),
               rebuilt_rows=int((dirty & (deg > 0)
                                 & (deg <= spec.degree_cap)).sum()),
               tabled_nodes=int(((deg > 0) & (deg <= spec.degree_cap)).sum()),
               edges=int(new.index.num_edges))
    del new, dirty, merged
    torch.cuda.empty_cache()
    return out


def check_row_masses(index, tables, spec, rows_per_pass=1 << 20) -> dict:
    """Every tabled row (0 < deg <= degree_cap): the masses its (thresh,
    partner) encode equal quantize_row of its region weights, and sum to
    deg·M."""
    import torch
    from repro_torch.core.alias import quantize_row, region_weights, row_masses
    nc, E = index.node_capacity, index.edge_capacity
    M, R = spec.radix, spec.degree_cap
    starts = index.node_starts
    deg = starts[1:nc + 1] - starts[:nc]
    ids = torch.nonzero((deg > 0) & (deg <= R))[:, 0]
    w = region_weights(index, spec)
    off = torch.arange(R, device=w.device)
    bad = 0
    for p0 in range(0, ids.numel(), rows_per_pass):
        v = ids[p0:p0 + rows_per_pass]
        d = deg[v]
        pos = (starts[v].long()[:, None] + off).clamp(max=E - 1)
        inrow = off[None, :] < d[:, None]
        got = row_masses(tables.thresh[pos], tables.partner[pos], d, M)
        want = quantize_row(torch.where(inrow, w[pos], 0.0), d, M)
        bad += int(((got != want).any(1) | (got.sum(1) != d * M)).sum())
    require(bad == 0, f"table_path: {bad} rows fail the mass round trip")
    return dict(rows=int(ids.numel()), rows_failing=bad)


class RejectionRounds:
    """Observer: for every node2vec hop, the round at which each live lane
    with a previous node accepted (N2V_ROUNDS where every round rejected
    and the round-0 proposal stands). Wraps the walk engine's
    ``_draw_pick`` (for the live mask, b > c) and ``_proposals`` (for the
    rounds' acceptances)."""

    def __init__(self):
        self.hist = None

    @contextlib.contextmanager
    def watch(self):
        import torch
        from repro_torch.core import walk_engine as we
        draw, props = we._draw_pick, we._proposals
        live = []

        def draw_seen(index, scfg, hop_key, a, c, b, *args, **kw):
            live[:] = [b > c]
            return draw(index, scfg, hop_key, a, c, b, *args, **kw)

        def props_seen(index, pick, beta_of, prev, us, beta_max):
            k, ok = props(index, pick, beta_of, prev, us, beta_max)
            first = torch.where(ok.any(0), ok.to(torch.int8).argmax(0),
                                we.N2V_ROUNDS)
            keep = live[0] & (prev >= 0)
            h = torch.bincount(first[keep], minlength=we.N2V_ROUNDS + 1)
            self.hist = h if self.hist is None else self.hist + h
            return k, ok

        we._draw_pick, we._proposals = draw_seen, props_seen
        try:
            yield self
        finally:
            we._draw_pick, we._proposals = draw, props

    def reading(self) -> dict:
        h = self.hist.cpu().tolist()
        n = sum(h)
        return dict(lanes=n, accepted_at_round=h[:-1], none_accepted=h[-1],
                    mean_rounds=sum((r + 1) * c for r, c in enumerate(h[:-1])
                                    ) / max(n - h[-1], 1)
                    if n else None)


def node2vec_path(index, tables, wcfg) -> dict:
    """Node2vec at full width on the table path's window: index mode,
    exponential and table bias; walks/s on the grouped path, hop
    validity, grouped == fullwalk for one key, rejection rounds (from an
    observed third run)."""
    import dataclasses
    import torch
    from repro_torch import random as prng
    from repro_torch.configs.base import SamplerConfig, SchedulerConfig
    from repro_torch.core.validation import validate_walks
    from repro_torch.core.walk_engine import generate_walks
    key = prng.PRNGKey(17)
    p, q = N2V_PQ
    t0 = time.perf_counter()
    out = {}
    for name, bias in (("index_exponential", "exponential"),
                       ("table", "table")):
        scfg = SamplerConfig(mode="index", bias=bias, node2vec_p=p,
                             node2vec_q=q)
        runs = {}
        for path in ("grouped", "fullwalk"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[path] = generate_walks(index, key, wcfg, scfg,
                                        SchedulerConfig(path=path),
                                        tables=tables)
            torch.cuda.synchronize()
            runs[path + "_s"] = time.perf_counter() - t0
        rep = validate_walks(index, runs["grouped"])
        differ = rows_differ(runs["grouped"], runs["fullwalk"])
        require(rep.num_hops > 0 and rep.hop_valid_frac == 1.0,
                f"node2vec {name}: hop validity {rep.hop_valid_frac}")
        require(differ == 0, f"node2vec {name}: {differ} walks differ "
                             "between grouped and fullwalk")
        rounds = RejectionRounds()
        with rounds.watch():
            again = generate_walks(index, key, wcfg, scfg,
                                   SchedulerConfig(path="grouped"),
                                   tables=tables)
        require(rows_differ(again, runs["grouped"]) == 0,
                f"node2vec {name}: the observed run differs")
        lengths = runs["grouped"].lengths.double()
        out[name] = dict(
            p=p, q=q, seconds=runs["grouped_s"],
            fullwalk_seconds=runs["fullwalk_s"],
            walks_per_s=wcfg.num_walks / runs["grouped_s"],
            hops_per_s=float((lengths - 1).clamp(min=0).sum())
            / runs["grouped_s"],
            mean_len=float(lengths.mean()), hop_valid_frac=rep.hop_valid_frac,
            num_hops=rep.num_hops, grouped_vs_fullwalk_differ=differ,
            rejection=rounds.reading())
        del runs, again
        torch.cuda.empty_cache()
    return dict(walks=wcfg.num_walks, max_length=wcfg.max_length,
                window_edges=int(index.num_edges), **out,
                phase_seconds=time.perf_counter() - t0)


def table_traffic(rng, num_nodes, hubs, n):
    """serve_traffic's queries, a third of them table-coded, a third
    second-order with (n2v_p, n2v_q) in {0.5, 1, 2}² minus (1, 1), the
    rest closed-form as they came."""
    import dataclasses
    pq = (0.5, 1.0, 2.0)
    out = []
    for qu in serve_traffic(rng, num_nodes, hubs, n=n):
        kind = int(rng.integers(0, 3))
        if kind == 0:
            qu = dataclasses.replace(qu, bias="table")
        elif kind == 1:
            p, q = (pq[i] for i in rng.integers(0, 3, 2))
            if p == q == 1.0:
                q = 2.0
            qu = dataclasses.replace(qu, n2v_p=p, n2v_q=q)
        out.append(qu)
    return out


def serve_tables(cfg, batches, dev) -> dict:
    """WalkService on the grouped path with exponential alias tables, on
    the main path's window after SERVE_WINDOW_BATCHES batches, the next
    batch ingested (tables maintained) while serving: table-coded,
    second-order and closed-form queries; checked against solo runs and a
    synchronous ring, for hop validity and host syncs in the launch."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import (SamplerConfig, SchedulerConfig,
                                          ServeConfig)
    from repro_torch.kernels import runtime
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.serve import WalkService
    t_phase = time.perf_counter()
    rng = np.random.default_rng(5)
    cfg_t = dataclasses.replace(
        cfg, sampler=SamplerConfig(mode="index", table_weight="exponential"),
        scheduler=SchedulerConfig(path="grouped", regroup="bucket"))
    svc, window_s = serve_window(cfg_t, ServeConfig(), batches, dev)
    nc = cfg.window.node_capacity
    idx = svc.snapshots.current.index
    deg = idx.node_starts[1:nc + 1] - idx.node_starts[:nc]
    hubs = torch.topk(deg, max(1, int(nc * SERVE_HUB_SHARE))).indices
    queries = table_traffic(rng, nc, hubs.cpu().numpy(), SERVE_TABLE_QUERIES)
    next_batch = batches[SERVE_WINDOW_BATCHES]
    # eight waves: the next batch is ingested from the fifth to the seventh
    wave = max(1, len(queries) // 8)
    svc._launch = no_host_sync(svc._launch)
    runtime.reset_launches()
    results, secs, states = drive_serve(svc, queries, next_batch, wave=wave)
    launches = dict(runtime.LAUNCHES)
    st = svc.stats
    require(len(states) == 2, f"serve_tables: versions {sorted(states)}")
    require(st.completed == len(queries) and st.dropped == 0,
            f"serve_tables: {st.completed} of {len(queries)} completed, "
            f"{st.dropped} dropped")
    require(launches == dict(fused_hop=0, weight_prefix=2,
                             walk_step_tiled=0),
            f"serve_tables: launches {launches}")
    require(all(s.tables is not None for s in states.values()),
            "serve_tables: a snapshot has no tables")
    validity = served_validity(results, states, 80)
    solo = {v: WalkService(cfg_t, state=state, registry=MetricsRegistry())
            for v, state in states.items()}
    picked = rng.choice(sorted(results), size=SERVE_TABLE_SOLO,
                        replace=False)
    solo_differ = 0
    for t in picked:
        r = results[int(t)]
        got = solo[r.snapshot_version].run_query_solo(r.query)
        solo_differ += not all(np.array_equal(a, b) for a, b in zip(
            got, (r.nodes, r.times, r.lengths)))
    require(solo_differ == 0, f"serve_tables: {solo_differ} of "
                              f"{SERVE_TABLE_SOLO} differ from solo")
    kinds = dict(table=sum(q.bias == "table" for q in queries),
                 second_order=sum(q.second_order for q in queries))
    reading = dict(
        queries=len(queries), kinds=kinds,
        window_batches=SERVE_WINDOW_BATCHES,
        window_edges=int(states[min(states)].index.num_edges),
        window_ingest_seconds=window_s, seconds=secs, walks=st.walks,
        hops=st.hops, walks_per_wall_s=st.walks / secs,
        hops_per_wall_s=st.hops / secs, walks_per_s=st.walks_per_s,
        p50_ms=st.p50_ms, p99_ms=st.p99_ms, batches=st.batches,
        lane_occupancy=st.lane_occupancy, launches=launches,
        alias_nodes_rebuilt=svc.registry.value("alias_nodes_rebuilt_total"),
        versions=sorted(states), validity=validity, wave=wave,
        solo_equal=SERVE_TABLE_SOLO, launch_host_syncs=0)
    del svc, solo, states, idx, deg
    torch.cuda.empty_cache()
    other, _ = serve_window(cfg_t, ServeConfig(max_inflight=1), batches, dev)
    got, other_secs, _ = drive_serve(other, queries, next_batch, wave=wave)
    differ = results_differ(results, got)
    require(differ == 0, f"serve_tables: {differ} tickets differ with "
                         "max_inflight=1")
    reading["equal_max_inflight_1"] = dict(tickets=len(got), differ=differ,
                                           seconds=other_secs)
    reading["phase_seconds"] = time.perf_counter() - t_phase
    del other, got
    torch.cuda.empty_cache()
    return reading


def tables_cuda_equals_cpu(dev) -> dict:
    """A small window, each table weight: the card's tables after a
    replay equal the CPU's bit for bit, and so do its table walks,
    node2vec walks (config and second-order lanes via served tickets)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import random as prng
    from repro_torch.configs.base import (EngineConfig, SamplerConfig,
                                          SchedulerConfig, ServeConfig,
                                          WalkConfig, WindowConfig)
    from repro_torch.core.streaming import StreamingEngine
    from repro_torch.core.walk_engine import generate_walks
    from repro_torch.data.synthetic import (chronological_batches,
                                            powerlaw_temporal_graph)
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.serve import WalkService
    g = powerlaw_temporal_graph(512, 1 << 15, skew=1.2, t_max=100_000,
                                seed=2)
    stream = list(chronological_batches(g, 4))
    window = WindowConfig(duration=50_000.0, edge_capacity=1 << 14,
                          node_capacity=512)
    sched = SchedulerConfig(path="grouped")
    wcfg = WalkConfig(num_walks=1024, max_length=16)
    queries = table_traffic(np.random.default_rng(6), 512, np.arange(8),
                            TABLES_EQ_QUERIES)
    t0 = time.perf_counter()
    out = {}
    for weight in ("uniform", "linear", "exponential"):
        scfg = SamplerConfig(mode="index", bias="table", table_weight=weight)
        got = {}
        for d in (dev, "cpu"):
            eng = StreamingEngine(EngineConfig(window=window, sampler=scfg,
                                               scheduler=sched), 1 << 13,
                                  device=d, registry=MetricsRegistry())
            _, walks, _ = eng.replay_device(stream[:3], wcfg,
                                            return_walks=True)
            n2v = generate_walks(eng.state.index, prng.PRNGKey(9), wcfg,
                                 dataclasses.replace(scfg, node2vec_p=0.5,
                                                     node2vec_q=2.0),
                                 sched, tables=eng.state.tables)
            svc = WalkService(EngineConfig(
                window=window, sampler=SamplerConfig(
                    mode="index", table_weight=weight), scheduler=sched),
                ServeConfig(), batch_capacity=1 << 13,
                registry=MetricsRegistry(), device=d)
            for b in stream[:3]:
                svc.ingest(*b)
            served, _, _ = drive_serve(svc, queries, stream[3],
                                       wave=TABLES_EQ_WAVE)
            got[str(d)] = (eng.state.tables, walks, n2v, served)
        (t_c, w_c, n_c, s_c), (t_h, w_h, n_h, s_h) = got[str(dev)], \
            got["cpu"]
        tables_equal = all(torch.equal(getattr(t_c, f).cpu(),
                                       getattr(t_h, f))
                           for f in ("thresh", "partner", "ptab", "rebuilt"))
        walks_equal = all(np.array_equal(a, b) for a, b in zip(w_c[:3],
                                                               w_h[:3]))
        n2v_equal = rows_differ(on_cpu(n_c), n_h) == 0
        differ = results_differ(s_c, s_h)
        require(tables_equal and walks_equal and n2v_equal and differ == 0,
                f"tables_cuda_equals_cpu ({weight}): tables {tables_equal}, "
                f"table walks {walks_equal}, node2vec {n2v_equal}, "
                f"{differ} tickets differ")
        out[weight] = dict(tables_equal=True, table_walks_equal=True,
                           node2vec_walks_equal=True, tickets=len(s_c),
                           tickets_differ=0)
    return dict(**out, seconds=time.perf_counter() - t0)


def on_cpu(res):
    """A WalkResult's arrays on the CPU."""
    return type(res)(*(None if x is None else x.cpu() for x in res))


def probed_replay(cfg, batches, wcfg, unprobed_walks, unprobed_syncs,
                  args) -> dict:
    """The main path once more with probes=True: walks byte-equal to the
    unprobed replay, the same host syncs, and probe counters that agree
    with ReplayStats (hops to the float32 rounding of mean_len: 4 per
    batch at most)."""
    import numpy as np
    from repro_torch.core.streaming import StreamingEngine
    from repro_torch.kernels import runtime
    from repro_torch.obs.registry import MetricsRegistry
    reg = MetricsRegistry()
    engine = StreamingEngine(cfg, args.edges_per_batch, registry=reg,
                             probes=True)
    runtime.reset_launches()
    (stats, walks, secs), syncs, sites = count_syncs(
        lambda: engine.replay_device(batches, wcfg, return_walks=True))
    launches = dict(runtime.LAUNCHES)
    differ = int(sum(not np.array_equal(a, b)
                     for a, b in zip(walks[:3], unprobed_walks[:3])))
    require(differ == 0, "probed replay: walks differ from the unprobed")
    require(syncs == unprobed_syncs,
            f"probed replay: {syncs} host syncs ({sites}) against "
            f"{unprobed_syncs}")
    K = len(stats.mean_len)
    W = wcfg.num_walks
    hops_stats = float(np.sum(W * stats.mean_len.astype(np.float64) - W))
    probes = dict(
        batches=reg.value("stream_batches_total", {"driver": "device"}),
        edges_ingested=reg.value("stream_edges_ingested_total",
                                 {"driver": "device"}),
        late_drops=reg.value("drops_total", {"kind": "ingest_late"}, 0),
        overflow_drops=reg.value("drops_total", {"kind": "window_overflow"},
                                 0),
        hops=reg.value("walk_hops_total", {"source": "replay"}),
        walks_emitted=reg.value("walks_emitted_total", {"driver": "device"}))
    agree = (probes["batches"] == K
             and probes["edges_ingested"] == int(stats.ingested[-1])
             and probes["late_drops"] == int(stats.late_drops[-1])
             and probes["overflow_drops"] == int(stats.overflow_drops[-1])
             and abs(probes["hops"] - hops_stats) <= 4 * K)
    require(agree, f"probed replay: probes {probes} disagree with stats")
    return dict(seconds=secs, host_syncs=syncs, host_sync_sites=sites,
                unprobed_host_syncs=unprobed_syncs,
                walks_differ=differ, probes=probes,
                hops_from_mean_len=hops_stats, launches=launches)


# ---- scale-out: the node-partitioned window, D shards on one card ---------
SHARDS = 4
SHARD_WALK_PATHS = ("fused", "tiled", "grouped")
# batches of sharded_path's second half, after the rebalance (12 until
# the recurrent LM phases, 4 until the enc-dec ones needed the seconds):
# the window is full after the first half, so each of them evicts
SHARD_SECOND_HALF = 2


def shard_config(args):
    """The full-size sharded window's ShardConfig, scaled with the run's
    sizes: range placement, shard 0 owning the lowest quarter of the node
    ids (the Zipf hubs and every all-nodes start below 2^20), so its
    capacities are those of the whole window and the whole walk batch."""
    from repro_torch.configs.base import ShardConfig
    return ShardConfig(num_shards=SHARDS,
                       edge_capacity_per_shard=args.edge_capacity,
                       exchange_capacity=args.edges_per_batch // SHARDS,
                       walk_slots=args.walks,
                       walk_bucket_capacity=args.walks, placement="range")


def stats_equal(a, b) -> bool:
    import numpy as np
    return all(np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))) for f in a._fields)


def walks_equal(a, b) -> bool:
    import numpy as np
    return all(np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f)))
               for f in ("nodes", "times", "lengths"))


def hop_validity(index, walks, dev):
    from repro_torch.core.validation import validate_walks
    from repro_torch.core.walk_engine import WalkResult
    import torch
    return validate_walks(index, WalkResult(
        *(torch.as_tensor(getattr(walks, f), device=dev)
          for f in ("nodes", "times", "lengths"))))


def profile_sharded_batch(engine, batch, wcfg) -> dict:
    """One more batch of the sharded replay under torch.profiler, ingest
    and walks traced apart: device kernels of each (the walks' per hop),
    busy ms and the idle share of the batch; then one walk-migration
    exchange alone at the replay's shapes."""
    import torch
    from repro_torch import random as prng
    from repro_torch.core.distributed import exchange_by_owner
    from repro_torch.core.edge_store import stack_batches
    from repro_torch.distributed import streaming_shard as ss
    cfg, mesh, D = engine.cfg, engine.mesh, engine.num_shards
    st = stack_batches([batch], engine.batch_capacity, device=engine.home)
    split = [x.reshape(D, engine.batch_slice) for x in st[:3]]
    nc = cfg.window.node_capacity
    out = {}

    def ingest():
        return ss._shard_ingest(
            mesh, engine.state.window, *(ss._slices(mesh, x) for x in split),
            ss._batch_valid(mesh, engine.batch_slice, st.count[0]),
            placement=engine.placement,
            exchange_capacity=cfg.shard.exchange_capacity,
            node_capacity=nc, bias_scale=1.0)[0]

    def walks(states):
        return ss._shard_walks(
            mesh, [w.index for w in states], prng.PRNGKey(7), wcfg,
            cfg.sampler, placement=engine.placement,
            walk_slots=cfg.shard.walk_slots,
            walk_bucket_capacity=cfg.shard.walk_bucket_capacity)

    states = ingest()
    walks(states)
    torch.cuda.synchronize()
    busy, traced, kernels = {}, {}, {}
    # the device alone: the host ops of ~160,000 walk kernels make the
    # trace slow to read back (profile_lane_batch's host_ops=False)
    for name, fn in (("ingest", ingest), ("walks", lambda: walks(states))):
        spans, traced[name] = trace_kernels(fn)
        busy[name] = busy_us([(s, t) for _, s, t in spans]) / 1e3
        kernels[name] = len(spans)
    out.update(ingest_kernels=kernels["ingest"],
               walk_kernels=kernels["walks"],
               walk_kernels_per_hop=kernels["walks"] / wcfg.max_length,
               ingest_busy_ms=busy["ingest"], walks_busy_ms=busy["walks"],
               traced_wall_ms=traced["ingest"] + traced["walks"],
               device_idle_share=1 - (busy["ingest"] + busy["walks"])
               / (traced["ingest"] + traced["walks"]))
    # one migration exchange at the walk slots' width: every slot live,
    # owners drawn over the node range
    Ws = cfg.shard.walk_slots
    g = torch.Generator(device=engine.home).manual_seed(3)
    node = [torch.randint(0, nc, (Ws,), generator=g, device=engine.home,
                          dtype=torch.int32) for _ in range(D)]
    wid = torch.arange(Ws, dtype=torch.int32, device=engine.home)
    live = torch.ones(Ws, dtype=torch.bool, device=engine.home)

    def exchange():
        return exchange_by_owner(
            mesh, cfg.shard.walk_bucket_capacity,
            [engine.placement.owner(v) for v in node], [live] * D,
            [(wid, v, v) for v in node], (-1, 0, 0))
    out["exchange"] = profile_call(exchange)
    del states
    return out


def sharded_walks(single, wcfg, dev) -> dict:
    """``sample_walks_sharded`` with 4 shards on one card, on the window
    after the first half of the stream, on the fused, tiled and grouped
    paths from one key: equal bits, hop validity 1.0, and one hop-kernel
    launch per shard and hop on the kernel paths."""
    import dataclasses
    import torch
    from repro_torch.configs.base import SchedulerConfig
    from repro_torch.distributed.collectives import ShardGroup
    from repro_torch.kernels import runtime
    group = ShardGroup([dev] * SHARDS)
    key0, cfg0 = single.key, single.cfg
    runs, reading = {}, {}
    try:
        for path in SHARD_WALK_PATHS:
            single.key = key0
            single.cfg = dataclasses.replace(
                cfg0, scheduler=SchedulerConfig(path=path, regroup="bucket"))
            runtime.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = single.sample_walks_sharded(wcfg, mesh=group)
            secs = time.perf_counter() - t0
            launches = dict(runtime.LAUNCHES)
            runs[path] = on_cpu(res)
            rep = hop_validity(single.state.index, runs[path], dev)
            reading[path] = dict(seconds=secs,
                                 walks_per_s=wcfg.num_walks / secs,
                                 hop_valid_frac=rep.hop_valid_frac,
                                 num_hops=rep.num_hops, launches=launches)
            require(rep.num_hops > 0 and rep.hop_valid_frac == 1.0,
                    f"sharded walks ({path}): hop validity "
                    f"{rep.hop_valid_frac}")
    finally:
        single.key, single.cfg = key0, cfg0
    hops = wcfg.max_length           # all_nodes: every hop is a walk hop
    for path in SHARD_WALK_PATHS[1:]:
        require(walks_equal(runs[path], runs["fused"]),
                f"sharded walks: {path} and fused differ")
    want = {"fused": ("fused_hop", SHARDS * hops),
            "tiled": ("walk_step_tiled", SHARDS * hops)}
    for path, (name, n) in want.items():
        got = reading[path]["launches"][name]
        require(got == n, f"sharded walks ({path}): {name} launched {got} "
                          f"times, not {SHARDS} shards x {hops} hops")
    require(reading["grouped"]["launches"]["fused_hop"] == 0,
            "sharded walks (grouped) launched the fused hop")
    return dict(shards=SHARDS, walks=wcfg.num_walks,
                max_length=wcfg.max_length, start_mode=wcfg.start_mode,
                paths=reading, paths_equal=True)


def sharded_path(args, cfg, batches, dev) -> dict:
    """The node-partitioned window at full size, 4 shards on one card:
    batches 1-12, ``rebalance()``, batches 13-14 (``SHARD_SECOND_HALF``),
    each half byte-equal to
    the single-device replay of the same batches, no drops, hop validity
    1.0, ``weight_prefix`` launched twice per shard and ingest. Between
    the halves, ``sharded_walks`` on the single-device window."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.configs.base import WalkConfig
    from repro_torch.core.streaming import StreamingEngine
    from repro_torch.distributed.streaming_shard import (
        DistributedStreamingEngine)
    from repro_torch.kernels import runtime
    wcfg = WalkConfig(num_walks=args.walks, max_length=args.length,
                      start_mode="all_nodes")
    cfg_sh = dataclasses.replace(cfg, shard=shard_config(args))
    B = args.edges_per_batch
    half = len(batches) // 2
    single = StreamingEngine(cfg, B, probes=False)
    sharded = DistributedStreamingEngine(cfg_sh, B, devices=[dev] * SHARDS,
                                         probes=False)
    reading = dict(shards=SHARDS, shard_config=dataclasses.asdict(
        cfg_sh.shard), batches=half + len(batches[half:half +
                                                  SHARD_SECOND_HALF]),
        walks=args.walks,
        max_length=args.length, start_mode="all_nodes",
        single_device_path=cfg.scheduler.path)
    halves = {}
    walks_reading = None
    # the serving phases leave services in reference cycles: collect them
    # so that the peak below is this phase's own
    gc.collect()
    torch.cuda.empty_cache()
    reading["allocated_at_start_gib"] = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    second = batches[half:half + SHARD_SECOND_HALF]
    for h, part in (("first", batches[:half]), ("second", second)):
        if h == "second":
            walks_reading = sharded_walks(single, wcfg, dev)
            loads_before = sharded.shard_loads()
            runtime.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            placement = sharded.rebalance()
            torch.cuda.synchronize()
            rebalance = dict(
                seconds=time.perf_counter() - t0,
                launches=dict(runtime.LAUNCHES),
                hot_nodes=list(placement.hot_nodes),
                hot_owners=list(placement.hot_owners),
                shard_loads_before=loads_before.tolist(),
                shard_loads_after=sharded.shard_loads().tolist(),
                exchange_drops=[int(x) for x in
                                sharded.state.exchange_drops])
            require(sum(rebalance["shard_loads_after"])
                    == sum(rebalance["shard_loads_before"]),
                    f"rebalance lost edges: {rebalance}")
            require(rebalance["launches"]["weight_prefix"] == 2 * SHARDS,
                    f"rebalance: {rebalance['launches']} weight_prefix "
                    f"launches, not 2 per shard")
            reading["rebalance"] = rebalance
        t0 = time.perf_counter()
        s_stats, s_walks, s_secs = single.replay_device(part, wcfg,
                                                        return_walks=True)
        runtime.reset_launches()
        (d_stats, d_walks, secs), syncs, sites = count_syncs(
            lambda: sharded.replay_device(part, wcfg))
        launches = dict(runtime.LAUNCHES)
        K = len(part)
        rep = hop_validity(single.state.index, d_walks, dev)
        stats = d_stats.replay
        prior = halves["first"]["ingested_end"] if h == "second" else 0
        hops_done = float(np.sum(args.walks * (
            stats.mean_len.astype(np.float64) - 1.0)))
        loads = sharded.shard_loads()
        halves[h] = dict(
            batches=K, seconds=secs, single_device_seconds=s_secs,
            edges_per_s=(int(stats.ingested[-1]) - prior) / secs,
            walks_per_s=K * args.walks / secs, hops_per_s=hops_done / secs,
            hop_valid_frac=rep.hop_valid_frac, num_hops=rep.num_hops,
            host_syncs=syncs, host_sync_sites=sites, launches=launches,
            exchange_drops=int(d_stats.exchange_drops.sum()),
            walk_drops=int(d_stats.walk_drops.sum()),
            shard_loads=loads.tolist(),
            edges_active=int(stats.edges_active[-1]),
            ingested_end=int(stats.ingested[-1]),
            walks_equal=walks_equal(d_walks, s_walks),
            stats_equal=stats_equal(stats, s_stats))
        require(halves[h]["stats_equal"],
                f"sharded {h} half: ReplayStats differ from single-device")
        require(halves[h]["walks_equal"],
                f"sharded {h} half: walks differ from single-device")
        require(halves[h]["exchange_drops"] == 0
                and halves[h]["walk_drops"] == 0,
                f"sharded {h} half: drops {halves[h]}")
        require(rep.num_hops > 0 and rep.hop_valid_frac == 1.0,
                f"sharded {h} half: hop validity {rep.hop_valid_frac}")
        require(launches["weight_prefix"] == 2 * SHARDS * K,
                f"sharded {h} half: weight_prefix launched "
                f"{launches['weight_prefix']} times, not 2 x {SHARDS} x {K}")
        require(int(loads.sum()) == int(stats.edges_active[-1]),
                f"sharded {h} half: shard loads {loads} != edges_active")
    reading["halves"] = halves
    reading["sharded_walks"] = walks_reading
    reading["profile"] = profile_sharded_batch(
        sharded, batches[min(half + SHARD_SECOND_HALF, len(batches) - 1)],
        wcfg)
    reading["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    reading["weight_prefix_launches"] = sum(
        halves[h]["launches"]["weight_prefix"] for h in halves)
    del single, sharded
    torch.cuda.empty_cache()
    return reading


def sharded_small(dev) -> dict:
    """A small window (512 nodes, 2^15 edges) on the card and on the CPU:
    D = 1, and D in {2, 8} under range, hash and skew placement, and one
    under-provisioned 4-shard run that drops; walks, statistics and
    per-shard drop counters equal bit for bit, and equal to the
    single-device replay where nothing drops. Then a live reshard
    4 -> 2 -> 8 on the card, every segment equal to the single-device
    replay, and the static walker at 4 shards equal to 1 shard."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.base import (EngineConfig, SamplerConfig,
                                          SchedulerConfig, ShardConfig,
                                          WalkConfig, WindowConfig)
    from repro_torch.core import distributed as dist
    from repro_torch.core.streaming import StreamingEngine
    from repro_torch.data.synthetic import (chronological_batches,
                                            powerlaw_temporal_graph)
    from repro_torch.distributed import placement as pl
    from repro_torch.distributed.collectives import ShardGroup
    from repro_torch.distributed.streaming_shard import (
        DistributedStreamingEngine)
    from repro_torch.obs.registry import MetricsRegistry
    t_start = time.perf_counter()
    N = 512
    sg = powerlaw_temporal_graph(N, 1 << 15, skew=1.2, t_max=100_000, seed=2)
    sb = list(chronological_batches(sg, 4))
    # every shard (and the single window) can hold the whole stream, so
    # no window overflows and only the exchange capacities can drop
    roomy = ShardConfig(edge_capacity_per_shard=1 << 15,
                        exchange_capacity=1 << 13, walk_slots=1024,
                        walk_bucket_capacity=1024)
    tight = ShardConfig(edge_capacity_per_shard=1 << 15,
                        exchange_capacity=256, walk_slots=256,
                        walk_bucket_capacity=64)
    cfg = EngineConfig(
        window=WindowConfig(duration=50_000.0, edge_capacity=1 << 15,
                            node_capacity=N),
        sampler=SamplerConfig(bias="exponential", mode="index"),
        scheduler=SchedulerConfig(path="grouped"), shard=roomy)
    wcfg = WalkConfig(num_walks=1024, max_length=16, start_mode="all_nodes")
    B = 1 << 13

    def single(batch_lists):
        eng = StreamingEngine(cfg, B, device="cpu",
                              registry=MetricsRegistry())
        return [eng.replay_device(b, wcfg, return_walks=True)[:2]
                for b in batch_lists]

    (want_s, want_w), = single([sb])
    loads = np.bincount(sg.src, minlength=N)

    def placement(kind, D):
        p = pl.make_placement(kind, D, N)
        return pl.SkewPlacement.from_loads(p, loads, k=8) \
            if kind == "skew" else p

    # one shard owns every node whatever the placement: D = 1 once
    cases = [(1, "range", roomy)] + [(D, kind, roomy) for D in (2, 8)
                                     for kind in ("range", "hash", "skew")] \
        + [(4, "range", tight)]
    runs = []
    for D, kind, shard in cases:
        out = {}
        for d in (dev, "cpu"):
            eng = DistributedStreamingEngine(
                dataclasses.replace(cfg, shard=shard), B, num_shards=D,
                devices=[d] * D, placement=placement(kind, D),
                registry=MetricsRegistry())
            out[str(d)] = eng.replay_device(sb, wcfg)[:2]
        (cs, cw), (ps, pw) = out[str(dev)], out["cpu"]
        same = (stats_equal(cs.replay, ps.replay) and walks_equal(cw, pw)
                and np.array_equal(cs.exchange_drops, ps.exchange_drops)
                and np.array_equal(cs.walk_drops, ps.walk_drops))
        require(same, f"sharded small D={D} {kind}: card and CPU differ")
        drops = int(cs.exchange_drops.sum()) + int(cs.walk_drops.sum())
        if shard is roomy:
            require(drops == 0 and stats_equal(cs.replay, want_s)
                    and walks_equal(cw, want_w),
                    f"sharded small D={D} {kind}: differs from one device")
        else:
            require(int(cs.exchange_drops.sum()) > 0
                    and int(cs.walk_drops.sum()) > 0,
                    f"sharded small D={D}: the tight capacities dropped "
                    "nothing")
        runs.append(dict(shards=D, placement=kind,
                         tight=shard is tight,
                         exchange_drops=cs.exchange_drops.sum(0).tolist(),
                         walk_drops=cs.walk_drops.sum(0).tolist()))

    # live reshard 4 -> 2 -> 8 on the card, against one device
    segments = (sb[:2], sb[2:], sb[:1])
    want = single(segments)
    eng = DistributedStreamingEngine(cfg, B, num_shards=4,
                                     devices=[dev] * 8,
                                     registry=MetricsRegistry())
    shard_counts = []
    for i, seg in enumerate(segments):
        st, wk = eng.replay_device(seg, wcfg)[:2]
        shard_counts.append(eng.num_shards)
        require(stats_equal(st.replay, want[i][0])
                and walks_equal(wk, want[i][1]),
                f"reshard: segment {i} at {eng.num_shards} shards differs "
                "from one device")
        if i == 0:
            eng.reshard_to(pl.make_placement("hash", 2, N))
        elif i == 1:
            eng.reshard_to(pl.make_placement("range", 8, N))

    # the static walker with per-step migration: 4 shards == 1 shard
    W, L = 512, 12
    starts = (np.arange(W) % N).astype(np.int32)
    times = np.full(W, -1, np.int32)
    walked = {}
    for D in (1, 4):
        group = ShardGroup([dev] * D)
        p = pl.make_placement("hash", D, N)
        idxs, _ = dist.partition_edges(sg.src, sg.dst, sg.ts, N, D, 1 << 15,
                                       placement=p, mesh=group)
        state = dist.init_sharded_walks(D, W, L, starts, times, p,
                                        mesh=group)
        out = dist.make_distributed_walker(
            group, idxs, cfg.sampler, placement=p, max_length=L,
            bucket_capacity=W)(state)
        require(sum(int(x) for x in out.dropped) == 0,
                f"walker D={D}: bucket overflow")
        walked[D] = dist.gather_walks(out, W)
    require(all(np.array_equal(a, b) for a, b in zip(walked[1], walked[4])),
            "walker: 4 shards differ from 1 shard")
    return dict(cases=runs, reshard_shard_counts=shard_counts,
                walker_walks=W, walker_length=L,
                walker_moved=int((walked[1][2] > 1).sum()),
                seconds=time.perf_counter() - t_start)


# ---- sharded serving and the window checkpoints --------------------------
# queries of serve_sharded, in waves of SERVE_SHARDED_WAVE: five waves, the
# next batch ingested from the third to the fifth (six waves of 48 until
# the enc-dec LM phases needed the seconds)
SERVE_SHARDED_QUERIES = 40
SERVE_SHARDED_WAVE = 8
# serve_sharded_small's queries in waves of 3: five waves, as above (16
# in six until the enc-dec LM phases)
SERVE_SHARDED_SMALL_QUERIES = 15
SERVE_SHARDED_SMALL_WAVE = 3
# window_checkpoint's reduced stream: nodes, edges per batch, batches
CKPT_NODES, CKPT_BATCH, CKPT_BATCHES = 1 << 20, 1 << 20, 6
CKPT_EDGE_CAPACITY = 1 << 22
CKPT_WALKS, CKPT_LENGTH = 1 << 16, 16


def started_lanes(results: dict) -> int:
    """Served lanes that started a walk (length > 0)."""
    return sum(int((r.lengths > 0).sum()) for r in results.values())


def serve_sharded(args, cfg, batches, dev) -> dict:
    """Sharded serving at full size: the main path's window after
    SERVE_WINDOW_BATCHES batches on 4 shards of the card (sharded_path's
    ShardConfig), SERVE_SHARDED_QUERIES closed-form queries in both start
    modes and all three biases, the next batch ingested while serving.
    Every ticket equals the single-device service's for the same query and
    version; no lane or edge drops; the per-shard claims sum to the started
    lanes; no host sync in ``_launch``; ``weight_prefix`` twice per shard
    for the one ``begin_ingest``, no hop kernel. Then one 4096 × 80 sharded
    batch under the profiler."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.configs.base import (SchedulerConfig, ServeConfig,
                                          WalkConfig)
    from repro_torch.core import walk_engine as we
    from repro_torch.distributed.streaming_shard import serve_lanes_sharded
    from repro_torch.kernels import runtime
    from repro_torch.serve import WalkQuery, pack_queries
    t_phase = time.perf_counter()
    # what earlier phases left in reference cycles goes first
    gc.collect()
    torch.cuda.empty_cache()
    allocated0 = torch.cuda.memory_allocated()
    rng = np.random.default_rng(6)
    sched = SchedulerConfig(path="fused", regroup="bucket",
                            tile_walks=SERVE_TILE_WALKS)
    cfg_s = dataclasses.replace(cfg, scheduler=sched,
                                shard=shard_config(args))
    nc = cfg.window.node_capacity
    next_batch = batches[SERVE_WINDOW_BATCHES]

    # the single-device service on the fused path: the tickets to equal
    single, _ = serve_window(cfg_s, ServeConfig(), batches, dev)
    idx = single.snapshots.current.index
    deg = idx.node_starts[1:nc + 1] - idx.node_starts[:nc]
    hubs = torch.topk(deg, max(1, int(nc * SERVE_HUB_SHARE))).indices
    hubs = hubs.cpu().numpy()
    queries = serve_traffic(rng, nc, hubs, n=SERVE_SHARDED_QUERIES)
    want, single_secs, states = drive_serve(single, queries, next_batch,
                                            wave=SERVE_SHARDED_WAVE)
    require(len(states) == 2, f"serve_sharded: versions {sorted(states)}")
    validity = served_validity(want, states, 80)
    del single, states, idx, deg
    gc.collect()
    torch.cuda.empty_cache()

    # the main path of this phase: counts set to 0 just before, read after
    torch.cuda.reset_peak_memory_stats()
    svc, window_s = serve_window(cfg_s, ServeConfig(), batches, dev,
                                 num_shards=SHARDS)
    svc._launch = no_host_sync(svc._launch)
    runtime.reset_launches()
    results, secs, _ = drive_serve(svc, queries, next_batch,
                                   wave=SERVE_SHARDED_WAVE)
    launches = dict(runtime.LAUNCHES)
    st = svc.stats
    differ = results_differ(results, want)
    started = started_lanes(results)
    require(st.completed == len(queries) and st.dropped == 0,
            f"serve_sharded: {st.completed} of {len(queries)} completed, "
            f"{st.dropped} dropped")
    require(differ == 0, f"serve_sharded: {differ} tickets differ from the "
                         "single-device service")
    require(st.shard_walk_drops == 0 and st.exchange_drops == 0,
            f"serve_sharded: drops {st.shard_walk_drops} lanes, "
            f"{st.exchange_drops} edges")
    require(sum(st.lanes_by_shard.values()) == started,
            f"serve_sharded: claims {st.lanes_by_shard} != {started} "
            "started lanes")
    require(launches == dict(fused_hop=0, weight_prefix=2 * SHARDS,
                             walk_step_tiled=0),
            f"serve_sharded: launches {launches}, not {2 * SHARDS} "
            "weight_prefix for one begin_ingest")
    reading = dict(
        queries=len(queries), shards=SHARDS,
        shard_config=dataclasses.asdict(cfg_s.shard),
        window_batches=SERVE_WINDOW_BATCHES, wave=SERVE_SHARDED_WAVE,
        window_ingest_seconds=window_s, seconds=secs, walks=st.walks,
        hops=st.hops, walks_per_wall_s=st.walks / secs,
        hops_per_wall_s=st.hops / secs, walks_per_s=st.walks_per_s,
        p50_ms=st.p50_ms, p99_ms=st.p99_ms, batches=st.batches,
        lane_occupancy=st.lane_occupancy, lanes_live=st.lanes_live,
        started_lanes=started,
        lanes_by_shard={str(k): v for k, v in
                        sorted(st.lanes_by_shard.items())},
        shard_walk_drops=st.shard_walk_drops,
        exchange_drops=st.exchange_drops, launches=launches,
        versions=sorted({r.snapshot_version for r in results.values()}),
        tickets_differ=differ, single_device_seconds=single_secs,
        single_device_validity=validity, launch_host_syncs=0,
        shard_loads=[int(w.index.num_edges)
                     for w in svc.snapshots.state.window])

    # one 4096-lane x 80 sharded batch: kernels per hop, idle share
    W, L = 4096, 80
    per = W // 64
    prof_q = [WalkQuery(
        start_nodes=tuple(int(v) for v in np.where(
            rng.uniform(size=per) < 0.5, rng.choice(hubs, size=per),
            rng.integers(0, nc, size=per))),
        bias=("uniform", "linear", "exponential")[i % 3], max_length=L,
        seed=7 * i + 1) for i in range(64)]
    params, _ = pack_queries(prof_q, W, L, device=dev)
    wcfg = WalkConfig(num_walks=W, max_length=L, start_mode="nodes")
    pin, key = svc.snapshots.acquire(), svc.base_key
    reading["batch_4096x80"] = profile_lane_batch(
        lambda: serve_lanes_sharded(
            pin.state, pin.view, key, params, mesh=svc.snapshots.mesh,
            node_capacity=nc, wcfg=wcfg, scfg=cfg.sampler,
            shard_cfg=cfg_s.shard, placement=svc.placement,
            with_probes=svc.probes), L,
        lambda: we._lane_uniform(we._lane_keys(key, params), torch.arange(
            L + 1, device=dev)[:, None]), host_ops=False)
    reading["allocated_at_start_gib"] = allocated0 / 2**30
    reading["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del svc, pin, params
    gc.collect()
    torch.cuda.empty_cache()
    reading["phase_seconds"] = time.perf_counter() - t_phase
    return reading


def serve_sharded_small(dev) -> dict:
    """Sharded serving on a small window (512 nodes, 2^15 edges), the
    last batch ingested while serving: at 1, 2 and 8 shards under range,
    hash and skew placement the card's tickets equal the CPU's and the
    single-device solo runs, with no drops; an under-provisioned 4-shard
    service drops lanes and edges alike on card and CPU; the sharded
    refusals raise."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.base import (EngineConfig, SamplerConfig,
                                          SchedulerConfig, ServeConfig,
                                          ShardConfig, WindowConfig)
    from repro_torch.core.edge_store import make_batch
    from repro_torch.core.window import init_window
    from repro_torch.data.synthetic import (chronological_batches,
                                            powerlaw_temporal_graph)
    from repro_torch.distributed import placement as pl
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.serve import (ShardedSnapshotManager, WalkQuery,
                                   WalkService)
    t_start = time.perf_counter()
    N = 512
    g = powerlaw_temporal_graph(N, 1 << 15, skew=1.2, t_max=100_000, seed=2)
    stream = list(chronological_batches(g, 4))
    # every shard (and the single window) can hold the whole stream
    roomy = ShardConfig(edge_capacity_per_shard=1 << 15,
                        exchange_capacity=1 << 13, walk_slots=2048,
                        walk_bucket_capacity=2048)
    tight = ShardConfig(edge_capacity_per_shard=1 << 15,
                        exchange_capacity=256, walk_slots=32,
                        walk_bucket_capacity=16)
    cfg = EngineConfig(
        window=WindowConfig(duration=50_000.0, edge_capacity=1 << 15,
                            node_capacity=N),
        sampler=SamplerConfig(mode="index"),
        scheduler=SchedulerConfig(path="grouped"), shard=roomy)
    queries = serve_traffic(np.random.default_rng(4), N, np.arange(8),
                            n=SERVE_SHARDED_SMALL_QUERIES, max_length=16)
    loads = np.bincount(g.src, minlength=N)

    def serve(d, D=0, kind="range", shard=roomy):
        placement = None
        if D:
            placement = pl.make_placement(kind, D, N)
            if kind == "skew":
                placement = pl.SkewPlacement.from_loads(placement, loads,
                                                        k=8)
        svc = WalkService(dataclasses.replace(cfg, shard=shard),
                          ServeConfig(), batch_capacity=1 << 13,
                          registry=MetricsRegistry(), device=d,
                          num_shards=D, placement=placement)
        for b in stream[:3]:
            svc.ingest(*b)
        results, _, states = drive_serve(svc, queries, stream[3],
                                         wave=SERVE_SHARDED_SMALL_WAVE)
        return svc, results, states

    # single-device solo runs at each ticket's version
    _, coalesced, states = serve(dev)
    require(len(states) == 2, f"sharded small: versions {sorted(states)}")
    solo = {v: WalkService(cfg, state=s, registry=MetricsRegistry())
            for v, s in states.items()}
    want = {t: (r.snapshot_version, solo[r.snapshot_version].run_query_solo(
        r.query)) for t, r in coalesced.items()}
    del solo, states

    # one shard owns every node whatever the placement: D = 1 once
    cases = [(1, "range", roomy)] + [(D, kind, roomy) for D in (2, 8)
                                     for kind in ("range", "hash", "skew")] \
        + [(4, "range", tight)]
    runs = []
    for D, kind, shard in cases:
        (c_svc, c_res, _), (p_svc, p_res, _) = (
            serve(d, D, kind, shard) for d in (dev, "cpu"))
        what = f"sharded small D={D} {kind}" + (
            " tight" if shard is tight else "")
        differ = results_differ(c_res, p_res)
        require(differ == 0, f"{what}: {differ} tickets differ, card vs CPU")
        counters = [(s.stats.shard_walk_drops, s.stats.exchange_drops,
                     s.stats.lanes_by_shard) for s in (c_svc, p_svc)]
        require(counters[0] == counters[1],
                f"{what}: drops and claims differ, card vs CPU: {counters}")
        walk_drops, edge_drops, claims = counters[0]
        if shard is roomy:
            solo_differ = sum(
                not (r.snapshot_version == want[t][0] and all(
                    np.array_equal(a, b) for a, b in zip(
                        (r.nodes, r.times, r.lengths), want[t][1])))
                for t, r in c_res.items())
            require(solo_differ == 0 and walk_drops == edge_drops == 0,
                    f"{what}: {solo_differ} tickets differ from the "
                    f"single-device solo runs; drops {walk_drops}, "
                    f"{edge_drops}")
            require(sum(claims.values()) == started_lanes(c_res),
                    f"{what}: claims {claims}")
        else:
            require(walk_drops > 0 and edge_drops > 0,
                    f"{what}: the tight capacities dropped nothing")
        runs.append(dict(shards=D, placement=kind, tight=shard is tight,
                         shard_walk_drops=walk_drops,
                         exchange_drops=edge_drops,
                         lanes_by_shard={str(k): v for k, v in
                                         sorted(claims.items())}))

    # the sharded refusals, as the reference's
    def service(**kw):
        return WalkService(dataclasses.replace(cfg, **kw), num_shards=2,
                           device=dev, registry=MetricsRegistry())
    svc = service()
    refusals = {
        "mode weight": lambda: service(sampler=SamplerConfig(mode="weight")),
        "node2vec": lambda: service(sampler=SamplerConfig(
            mode="index", node2vec_p=2.0)),
        "bias table": lambda: service(sampler=SamplerConfig(
            mode="index", bias="table")),
        "state override": lambda: WalkService(
            cfg, state=init_window(1 << 15, N, 50_000, device=dev),
            num_shards=2, device=dev),
        "table query": lambda: svc.submit(WalkQuery(start_nodes=(1,),
                                                    bias="table")),
        "second-order query": lambda: svc.submit(WalkQuery(
            start_nodes=(1,), n2v_p=2.0)),
        "more shards than devices": lambda: ShardedSnapshotManager(
            cfg, num_shards=3, devices=[dev] * 2),
        "batch capacity": lambda: svc.snapshots.begin_ingest(make_batch(
            [1], [2], [3], capacity=16, device=dev)),
    }
    for what, call in refusals.items():
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"sharded serving: {what} was not refused")
    return dict(queries=len(queries), cases=runs,
                refusals=sorted(refusals),
                seconds=time.perf_counter() - t_start)


def edge_multiset(state):
    """The window's edges over all shards as one (src, dst, ts)-sorted
    int32 [n, 3] host array."""
    import numpy as np
    cols = [np.concatenate([getattr(w.index.store, f)[
        :int(w.index.num_edges)].cpu().numpy() for w in state.window])
        for f in ("src", "dst", "ts")]
    order = np.lexsort(cols[::-1])
    return np.stack([c[order] for c in cols], axis=1)


def window_checkpoint(dev) -> dict:
    """Sharded-window checkpoints at a reduced size (CKPT_*: a full window
    would write 4 × 3.25 GiB of .npy and reshard 2^28 slots through the
    host mirror). ``StreamSupervisor(save_every=4)`` replays 4 shards on
    the card, ``restore_engine`` brings the window back at 2 shards and
    the replay goes on; then 2 → 4. The continued replay's last
    ``ReplayStats``, walk key and edge multiset equal an uninterrupted run
    at the target count. Reads the checkpoint's bytes and the seconds to
    save and to restore."""
    import os
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs.base import (EngineConfig, SamplerConfig,
                                          SchedulerConfig, ShardConfig,
                                          WalkConfig, WindowConfig)
    from repro_torch.data.synthetic import (chronological_batches,
                                            powerlaw_temporal_graph)
    from repro_torch.distributed.fault_tolerance import StreamSupervisor
    from repro_torch.distributed.streaming_shard import (
        DistributedStreamingEngine)
    from repro_torch.kernels import runtime
    from repro_torch.obs.registry import MetricsRegistry
    t_start = time.perf_counter()
    g = powerlaw_temporal_graph(CKPT_NODES, CKPT_BATCH * CKPT_BATCHES,
                                skew=1.2, t_max=10_000_000, seed=4,
                                device=dev)
    batches = list(chronological_batches(g, CKPT_BATCHES))
    # range placement puts the hubs and every all-nodes start on shard 0
    # at 2 and 4 shards: its capacities are those of a whole batch
    cfg = EngineConfig(
        window=WindowConfig(duration=5_000_000.0,
                            edge_capacity=CKPT_EDGE_CAPACITY,
                            node_capacity=CKPT_NODES),
        sampler=SamplerConfig(bias="exponential", mode="index"),
        scheduler=SchedulerConfig(path="grouped"),
        shard=ShardConfig(edge_capacity_per_shard=CKPT_EDGE_CAPACITY,
                          exchange_capacity=CKPT_BATCH // 2,
                          walk_slots=CKPT_WALKS,
                          walk_bucket_capacity=CKPT_WALKS,
                          placement="range"))
    wcfg = WalkConfig(num_walks=CKPT_WALKS, max_length=CKPT_LENGTH,
                      start_mode="all_nodes")
    pool = [dev] * SHARDS

    def engine(D):
        return DistributedStreamingEngine(cfg, CKPT_BATCH, num_shards=D,
                                          devices=pool, probes=False,
                                          registry=MetricsRegistry())
    runs = []
    for d_save, d_load in ((SHARDS, 2), (2, SHARDS)):
        with tempfile.TemporaryDirectory() as tmp:
            sup = StreamSupervisor(tmp, save_every=4,
                                   registry=MetricsRegistry())
            e1 = engine(d_save)
            sup.run(e1, batches[:4], wcfg)
            require(sup.resume_batch() == 4,
                    f"checkpoint: resume at {sup.resume_batch()}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sup.checkpointer.save(e1, 4)
            save_s = time.perf_counter() - t0
            wdir = sup.checkpointer.window_dir
            nbytes = sum(os.path.getsize(os.path.join(wdir, f))
                         for f in os.listdir(wdir))
            before = edge_multiset(e1.state)
            del e1
            runtime.reset_launches()
            t0 = time.perf_counter()
            e2 = sup.checkpointer.restore_engine(cfg, CKPT_BATCH,
                                                 num_shards=d_load,
                                                 devices=pool)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            restore_launches = dict(runtime.LAUNCHES)
            require(e2.num_shards == d_load
                    and np.array_equal(edge_multiset(e2.state), before),
                    f"checkpoint {d_save} -> {d_load}: the restore lost "
                    "edges")
            out, step = sup.run(e2, batches, wcfg, start_batch=4)
            ref = engine(d_load)
            for b in batches[:-1]:
                ref.replay_device([b], wcfg)
            last, _, _ = ref.replay_device([batches[-1]], wcfg)
            same = dict(
                walk_key=bool(torch.equal(e2.key, ref.key)),
                replay_stats=stats_equal(out[-1].replay, last.replay),
                edges=bool(np.array_equal(edge_multiset(e2.state),
                                          edge_multiset(ref.state))),
                drops=int(out[-1].exchange_drops.sum())
                + int(out[-1].walk_drops.sum()) == 0)
            require(step == CKPT_BATCHES and all(same.values()),
                    f"checkpoint {d_save} -> {d_load}: {same}")
            runs.append(dict(saved_shards=d_save, restored_shards=d_load,
                             checkpoint_bytes=nbytes, save_seconds=save_s,
                             restore_seconds=restore_s,
                             restore_launches=restore_launches,
                             window_edges=int(before.shape[0]),
                             shard_loads=e2.shard_loads().tolist(),
                             equal=same))
            del e2, ref
    torch.cuda.empty_cache()
    return dict(runs=runs, nodes=CKPT_NODES, edges_per_batch=CKPT_BATCH,
                batches=CKPT_BATCHES, edge_capacity_per_shard=(
                    CKPT_EDGE_CAPACITY), walks=CKPT_WALKS,
                max_length=CKPT_LENGTH,
                cut="reduced from the main window (2^22 nodes, 2^26 slots "
                    "a shard): the full one writes 4 x 3.25 GiB of .npy and "
                    "reshards 2^28 slots through the host mirror",
                seconds=time.perf_counter() - t_start)


# examples/train_embeddings.py's settings: skipgram on the walks of every
# batch of the chronological train split, link prediction on the edges
# past TRAIN_TEST
TRAIN = dict(window=2, epochs=1, batch_pairs=8192, n_neg=5, lr=0.025)
TRAIN_DIM = 64
TRAIN_SPLIT = 0.7
TRAIN_TEST = 0.85
# the split's last batches trained; the batches before them are ingested
# and walked. Cut from all 17 of the full run to its 5 after the window
# fills, then to 3 for the enc-dec LM phases: a batch trains in ~3 s on
# an H100 (NVIDIA H100 80GB HBM3, 700 W), and the whole run must fit
# 1,200 s on a slower host
TRAIN_BATCHES = 3


def train_embeddings(args, cfg, batches, g, dev) -> dict:
    """The training consumer at full size, driven as
    examples/train_embeddings.py drives it: for each batch of the
    chronological train split, ``ingest_batch``, ``sample_walks`` (2^20
    walks × 80 from nodes, fused path) and ``train_on_walks`` on 2^22 × 64
    tables; then ``link_prediction_auc`` on the last 15% of the edges.
    Per batch: pairs, steps, seconds (CUDA events), pairs/s, host syncs
    of the call and the loss."""
    import numpy as np
    import torch
    from repro_torch import random as prng
    from repro_torch.configs.base import WalkConfig
    from repro_torch.core.streaming import StreamingEngine
    from repro_torch.data.walk_dataset import skipgram_pairs
    from repro_torch.kernels import runtime
    from repro_torch.train.embeddings import (init_skipgram,
                                              link_prediction_auc,
                                              skipgram_step, train_on_walks)
    K = len(batches)
    split = [bi for bi in range(K) if bi / K <= TRAIN_SPLIT]
    first = max(0, len(split) - TRAIN_BATCHES)
    wcfg = WalkConfig(num_walks=args.walks, max_length=args.length,
                      start_mode="nodes")
    engine = StreamingEngine(cfg, args.edges_per_batch, probes=False)
    torch.cuda.reset_peak_memory_stats()
    state = init_skipgram(args.nodes, TRAIN_DIM, prng.PRNGKey(1), device=dev)
    key = prng.PRNGKey(2)
    runtime.reset_launches()
    rows, walks, sampled = [], None, 0
    t_phase = time.perf_counter()
    for bi in split:
        engine.ingest_batch(*batches[bi])
        walks = engine.sample_walks(wcfg)
        sampled += 1
        key, sub = prng.split(key)
        if bi < first:
            continue
        pairs = skipgram_pairs(walks.nodes, walks.lengths,
                               TRAIN["window"])[0].numel()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        (state, loss), syncs, sites = count_syncs(
            lambda: train_on_walks(state, walks.nodes, walks.lengths, sub,
                                   **TRAIN))
        end.record()
        end.synchronize()
        secs = start.elapsed_time(end) / 1e3
        rows.append(dict(batch=bi, pairs=pairs,
                         steps=math.ceil(pairs / TRAIN["batch_pairs"]),
                         seconds=secs, pairs_per_s=pairs / secs,
                         host_syncs=syncs, host_sync_sites=sites,
                         loss=loss))
    launches = dict(runtime.LAUNCHES)
    loop_s = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 2**30
    rep = hop_validity(engine.state.index, walks, dev)
    n_test = int(TRAIN_TEST * len(g.src))
    t0 = time.perf_counter()
    auc = link_prediction_auc(state, g.src[n_test:], g.dst[n_test:],
                              args.nodes)
    auc_s = time.perf_counter() - t0
    losses = [r["loss"] for r in rows]
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    require(auc > 0.5, f"link prediction AUC {auc} <= 0.5")
    require(rep.num_hops > 0 and rep.hop_valid_frac == 1.0,
            f"train_embeddings: hop validity {rep.hop_valid_frac}")
    require(launches["fused_hop"] == args.length * sampled
            and launches["weight_prefix"] == 2 * sampled,
            f"train_embeddings: launches {launches} for {sampled} batches")
    worst_syncs = max(r["host_syncs"] for r in rows)
    require(worst_syncs <= 4,
            f"train_on_walks made {worst_syncs} host syncs in one call")

    # one step alone, on the last batch's first mini-batch of pairs
    c, x = skipgram_pairs(walks.nodes, walks.lengths, TRAIN["window"])
    c, x = c[:TRAIN["batch_pairs"]], x[:TRAIN["batch_pairs"]]
    step_key = prng.PRNGKey(9)
    step = profile_call(lambda: skipgram_step(state, c, x, step_key,
                                       TRAIN["n_neg"], TRAIN["lr"]))
    draw = profile_call(lambda: prng.randint(step_key, (c.numel(), TRAIN["n_neg"]),
                                      0, args.nodes, dev))
    total_pairs = sum(r["pairs"] for r in rows)
    total_s = sum(r["seconds"] for r in rows)
    out = dict(batches_walked=sampled, batches_trained=len(rows),
               trained_from=first, dim=TRAIN_DIM, **TRAIN,
               tables_gib=2 * args.nodes * TRAIN_DIM * 4 / 2**30,
               per_batch=rows, pairs=total_pairs,
               steps=sum(r["steps"] for r in rows),
               train_seconds=total_s, pairs_per_s=total_pairs / total_s,
               host_syncs_per_call=sorted({r["host_syncs"] for r in rows}),
               last_loss=losses[-1], auc=auc, auc_seconds=auc_s,
               test_edges=len(g.src) - n_test, loop_seconds=loop_s,
               hop_valid_frac=rep.hop_valid_frac, num_hops_checked=rep.num_hops,
               launches=launches, peak_mem_gib=peak,
               skipgram_step=step, randint_of_step=draw)
    del engine, state, walks, c, x
    torch.cuda.empty_cache()
    return out


def train_cuda_equals_cpu(dev) -> dict:
    """A small stream (512 nodes, 2^15 edges, 4 batches), trained at dim
    16 on the card and on the CPU: walks, skipgram pairs and negatives
    bitwise; losses and tables within the training tolerance of
    tests/test_torch_cuda.py; the AUC within 1e-3. A second card run
    gives the same bits (the per-row sums run in a fixed order)."""
    import numpy as np
    import torch
    from repro_torch import random as prng
    from repro_torch.configs.base import (EngineConfig, SamplerConfig,
                                          SchedulerConfig, WalkConfig,
                                          WindowConfig)
    from repro_torch.core.streaming import StreamingEngine
    from repro_torch.data.synthetic import (chronological_batches,
                                            powerlaw_temporal_graph)
    from repro_torch.data.walk_dataset import skipgram_pairs
    from repro_torch.train.embeddings import (init_skipgram,
                                              link_prediction_auc,
                                              train_on_walks)
    rtol, atol = 1e-5, 1e-7
    n, bp = 512, 2048
    g = powerlaw_temporal_graph(n, 1 << 15, skew=1.2, t_max=100_000, seed=2)
    stream = list(chronological_batches(g, 4))
    cfg = EngineConfig(
        window=WindowConfig(duration=50_000.0, edge_capacity=1 << 14,
                            node_capacity=n),
        sampler=SamplerConfig(bias="exponential", mode="index"),
        scheduler=SchedulerConfig(path="fused", tile_walks=64,
                                  tile_edges=256))
    wcfg = WalkConfig(num_walks=1024, max_length=16)
    t0 = time.perf_counter()
    runs = {}
    for run, d in (("card", dev), ("cpu", "cpu"), ("card_again", dev)):
        eng = StreamingEngine(cfg, 1 << 13, device=d)
        state = init_skipgram(n, 16, prng.PRNGKey(1), device="cpu")
        state = type(state)(*(t.to(d) for t in state))
        key = prng.PRNGKey(2)
        walks, pairs, negs, losses = [], [], [], []
        for b in stream:
            eng.ingest_batch(*b)
            w = eng.sample_walks(wcfg)
            key, sub = prng.split(key)
            p = skipgram_pairs(w.nodes, w.lengths, TRAIN["window"])
            steps = math.ceil(p[0].numel() / bp)
            negs.append(prng.randint_keys(prng.split_chain(sub, steps)[1],
                                          (bp, TRAIN["n_neg"]), 0, n,
                                          d).cpu())
            walks.append(w.nodes.cpu())
            pairs.append([t.cpu() for t in p])
            state, loss = train_on_walks(state, w.nodes, w.lengths, sub,
                                         window=TRAIN["window"],
                                         batch_pairs=bp,
                                         n_neg=TRAIN["n_neg"],
                                         lr=TRAIN["lr"])
            losses.append(loss)
        n_test = int(TRAIN_TEST * len(g.src))
        auc = link_prediction_auc(state, g.src[n_test:], g.dst[n_test:], n)
        runs[run] = (walks, pairs, negs, losses,
                     [t.cpu() for t in state], auc)
    card, cpu, again = runs["card"], runs["cpu"], runs["card_again"]
    same = [all(torch.equal(a, b) for a, b in zip(card[0], cpu[0])),
            all(torch.equal(x, y) for a, b in zip(card[1], cpu[1])
                for x, y in zip(a, b)),
            all(torch.equal(a, b) for a, b in zip(card[2], cpu[2]))]
    require(all(same), f"train_cuda_equals_cpu: walks, pairs, negatives "
                       f"bitwise {same}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card[3], cpu[3]))
    table_err = {}
    for name, a, b in zip(("emb_in", "emb_out"), card[4], cpu[4]):
        diff = (a - b).abs()
        require(bool((diff <= atol + rtol * b.abs()).all()),
                f"train_cuda_equals_cpu: {name} off by {diff.max()}")
        table_err[name] = float(diff.max())
    require(loss_err <= rtol, f"train_cuda_equals_cpu: loss {loss_err}")
    require(abs(card[5] - cpu[5]) <= 1e-3,
            f"train_cuda_equals_cpu: AUC {card[5]} vs {cpu[5]}")
    repeat = all(torch.equal(a, b) for a, b in zip(card[4], again[4])) \
        and card[3] == again[3]
    require(repeat, "train_cuda_equals_cpu: two card runs differ")
    return dict(walks_pairs_negatives_bitwise=True,
                pairs=sum(p[0].numel() for p in card[1]),
                loss_max_rel_err=loss_err, table_max_abs_err=table_err,
                tolerance=f"|diff| <= {atol} + {rtol}*|cpu|",
                auc_card=card[5], auc_cpu=cpu[5],
                card_runs_bitwise_equal=repeat,
                seconds=time.perf_counter() - t0)


OPT_LEAVES = {"emb": (1 << 14, 1 << 9), "layers": [(1 << 12, 1 << 10),
                                                   (1 << 11, 1 << 11)]}
OPT_STEPS = 20


def opt_tree(make):
    """A tree shaped as ``OPT_LEAVES`` (2^24 float32) with ``make(i, shape)``
    as leaf i."""
    return {"emb": make(0, OPT_LEAVES["emb"]),
            "layers": [make(1 + i, s)
                       for i, s in enumerate(OPT_LEAVES["layers"])]}


def optimizer_cuda_equals_cpu(dev) -> dict:
    """``apply_updates`` on a 2^24-parameter tree for 20 steps, without and
    with int8 compression, on the card and on the CPU from the same bits:
    the int8 residuals and codes equal, params and moments within 1e-6 of
    each leaf's largest magnitude. Then ``TrainSupervisor(save_every=5)``
    over 12 steps on the card, a "crash", a restore onto the card and the
    tail replayed: bitwise the uninterrupted run."""
    import os
    import tempfile
    import numpy as np
    import torch
    from repro_torch.distributed.fault_tolerance import TrainSupervisor
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.train.checkpoint import _flatten_with_paths
    from repro_torch.train.optimizer import (AdamWConfig, apply_updates,
                                             init_opt_state, quantize_int8,
                                             tree_map)
    rng = np.random.default_rng(11)
    base = [opt_tree(lambda i, s: torch.from_numpy(
        rng.standard_normal(s, dtype=np.float32))) for _ in range(3)]
    t0 = time.perf_counter()

    def grads_at(t, d):
        # the same bits on every device: two products and a sum, each one
        # rounding
        a, b = math.cos(0.3 * t) * 0.3, math.sin(0.3 * t) * 0.3
        return tree_map(lambda x, y: x.to(d) * a + y.to(d) * b,
                        base[1], base[2])

    def run(cfg, d, steps):
        p = tree_map(lambda x: x.to(d), base[0])
        st = init_opt_state(p, cfg)
        for t in range(steps):
            p, st, _ = apply_updates(p, grads_at(t, d), st, cfg)
        return p, st

    out = {}
    for comp in ("none", "int8"):
        cfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100,
                          compression=comp)
        (cp, cs), (hp, hs) = run(cfg, dev, OPT_STEPS), run(cfg, "cpu",
                                                           OPT_STEPS)
        worst = 0.0
        for (k, a), (_, b) in zip(_flatten_with_paths((cp, cs.mu, cs.nu)),
                                  _flatten_with_paths((hp, hs.mu, hs.nu))):
            gap = float((a.cpu() - b).abs().max() / b.abs().max())
            require(gap <= 1e-6, f"optimizer ({comp}) {k}: {gap}")
            worst = max(worst, gap)
        reading = dict(max_err_of_leaf_max=worst)
        if comp == "int8":
            errs_equal = all(
                torch.equal(a.cpu(), b) for (_, a), (_, b) in zip(
                    _flatten_with_paths(cs.error),
                    _flatten_with_paths(hs.error)))
            g_last = grads_at(OPT_STEPS, "cpu")
            codes_equal = all(
                torch.equal(quantize_int8(g.to(dev) + e)[0].cpu(),
                            quantize_int8(g + f)[0])
                for (_, g), (_, e), (_, f) in zip(
                    _flatten_with_paths(g_last),
                    _flatten_with_paths(cs.error),
                    _flatten_with_paths(hs.error)))
            require(errs_equal and codes_equal,
                    f"optimizer int8: residuals equal {errs_equal}, codes "
                    f"equal {codes_equal}")
            reading.update(residuals_equal=True, codes_equal=True)
        out[comp] = reading
        del cp, cs, hp, hs

    cfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100,
                      compression="int8")

    def step_fn(p, st, t):
        return apply_updates(p, grads_at(t, dev), st, cfg)

    with tempfile.TemporaryDirectory() as tmp:
        sup = TrainSupervisor(tmp, save_every=5, registry=MetricsRegistry())
        p0 = tree_map(lambda x: x.to(dev), base[0])
        o0 = init_opt_state(p0, cfg)
        p1, o1, step = sup.run(step_fn, p0, o0, range(12), max_steps=12)
        resume = sup.resume_step()
        t1 = time.perf_counter()
        p2, o2 = sup.restore(p0, o0)
        restore_s = time.perf_counter() - t1
        p2, o2, step2 = sup.run(step_fn, p2, o2, range(resume, 12),
                                start_step=resume, max_steps=12)
        on_card = all(x.device.type == "cuda"
                      for _, x in _flatten_with_paths((p2, o2)))
        equal = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            _flatten_with_paths((p1, o1)), _flatten_with_paths((p2, o2))))
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(tmp) for f in fs)
    require(step == step2 == 12 and resume == 10 and on_card and equal,
            f"TrainSupervisor: steps {step}/{step2}, resume {resume}, "
            f"on card {on_card}, bitwise {equal}")
    return dict(parameters=sum(x.numel() for _, x in
                               _flatten_with_paths(base[0])),
                steps=OPT_STEPS, **out,
                supervisor=dict(save_every=5, steps=12, resumed_from=resume,
                                bitwise_equal=True, restored_on_card=True,
                                checkpoint_bytes=ckpt_bytes,
                                restore_seconds=restore_s),
                seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# The walk-native LM consumer (repro_torch.models, train/train_loop.py)
# ---------------------------------------------------------------------------

# examples/train_lm_on_walks.py at full size: olmo-1b, walks of the main
# path's final window packed into batch × seq tokens, AdamW
LM_TRAIN = dict(arch="olmo-1b", walks=1 << 14, batch=8, seq=2048, steps=5,
                lr=3e-4, warmup_steps=2)
# examples/serve_lm.py at full size: qwen2-0.5b from the KV cache, on
# prompts of 256 (512 until the enc-dec LM phases needed the seconds)
LM_SERVE = dict(arch="qwen2-0.5b", prompts=64, prompt_len=256, max_seq=1024,
                new_tokens=128)
# dense bf16 peak of one H100 SXM, NVIDIA's data sheet (no sparsity), at
# the full 700 W power limit
BF16_PEAK_FLOPS = 989e12
# lm_pipeline_full: lm_train_full's olmo-1b after its steps, its 16 layers
# in 4 GPipe stages of 4 on one card, 8 microbatches of 1 × 2048 tokens
LM_PIPE = dict(stages=4, microbatches=8)
LM_PIPE_LOGITS_TOL = 1e-4        # pipelined vs M.forward: of the largest
# lm_cuda_equals_cpu: both models at full width, 2 layers, float32, TF32
# off, the same parameters on the card and the CPU. Tolerances:
LM_EQ_LAYERS = 2
LM_EQ_STEPS = 1                  # train steps checked
LM_EQ_LOSS_RTOL = 1e-5           # loss and global gradient norm
LM_EQ_LEAF_TOL = 1e-4            # gradients, moments, params: of leaf max
LM_EQ_LOGITS_TOL = 1e-4          # decode logits: of the largest |logit|
LM_EQ_CONSISTENCY = 2e-3         # prefill vs decode (tests/test_arch_smoke.py)
# an element whose gradient is within this share of its leaf's largest
# gradient of zero has an AdamW direction its gradient cannot fix: its
# update is held only to the step bound 2·lr
LM_EQ_UNRESOLVED = 1e-3
# float32 rounding of a zero leaf's first step, in units of lr: the
# update's ~5 rounded operations on each side and the step's product
LM_EQ_ZERO_ROUND = 2.0 ** -20


def lm_train_full(args, cfg, batches, dev) -> dict:
    """olmo-1b at full width and depth trained as
    examples/train_lm_on_walks.py trains it: each step samples 2^14 walks
    × 80 from nodes on the main path's final window (fused path), packs
    them with ``walks_to_lm_batch`` into 8 × 2048 tokens and takes one
    ``make_train_step`` step (float32 masters, bf16 compute, remat per
    block, AdamW lr 3e-4, warmup 2, 10 steps). Per step: ms (CUDA events,
    the packing apart), tokens/s, model FLOP/s as a share of the bf16
    peak, host syncs, loss, grad norm."""
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.configs.base import WalkConfig
    from repro_torch.core.streaming import StreamingEngine
    from repro_torch.data.walk_dataset import walks_to_lm_batch
    from repro_torch.kernels import runtime
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the main path's final window: every batch ingested, fused path
    engine = StreamingEngine(cfg, args.edges_per_batch, probes=False)
    runtime.reset_launches()
    for b in batches:
        engine.ingest_batch(*b)
    mcfg = get_config(LM_TRAIN["arch"])
    t0 = time.perf_counter()
    model = M.init_params(mcfg, prng.PRNGKey(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    opt_cfg = AdamWConfig(lr=LM_TRAIN["lr"],
                          warmup_steps=LM_TRAIN["warmup_steps"],
                          total_steps=LM_TRAIN["steps"])
    step = make_train_step(model, opt_cfg)
    params = M.params_of(model)
    opt = init_opt_state(params, opt_cfg)
    n_params = M.count_params_analytic(mcfg)
    n_actual = sum(p.numel() for p in params.values())
    wcfg = WalkConfig(num_walks=LM_TRAIN["walks"], max_length=args.length,
                      start_mode="nodes")
    B, S = LM_TRAIN["batch"], LM_TRAIN["seq"]
    rows, last_walks = [], None
    for s in range(LM_TRAIN["steps"]):
        walks = engine.sample_walks(wcfg)
        t0 = time.perf_counter()
        nodes, lengths = walks.nodes.cpu().numpy(), walks.lengths.cpu().numpy()
        toks, labels = walks_to_lm_batch(nodes, lengths, S, B,
                                         mcfg.vocab_size, seed=s)
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        pack_ms = (time.perf_counter() - t0) * 1e3
        last_walks = (nodes, lengths)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        (params, opt, metrics), syncs, sites = count_syncs(
            lambda: step(params, opt, batch))
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        tok_s = B * S / (ms / 1e3)
        rows.append(dict(step=s, ms=ms, pack_ms=pack_ms, tokens_per_s=tok_s,
                         model_flops_share=6 * n_params * tok_s
                         / BF16_PEAK_FLOPS,
                         host_syncs=syncs, host_sync_sites=sites,
                         loss=float(metrics["loss"]),
                         grad_norm=float(metrics["grad_norm"]),
                         lr=float(metrics["lr"])))
    launches = dict(runtime.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # one more step on the last batch, traced (its result is dropped)
    step_profile = profile_call(lambda: step(params, opt, batch))
    losses = [r["loss"] for r in rows]
    norms = [r["grad_norm"] for r in rows]
    require(all(math.isfinite(x) for x in losses + norms),
            f"lm_train_full: losses {losses}, grad norms {norms}")
    require(losses[-1] < losses[0],
            f"lm_train_full: last loss {losses[-1]} >= first {losses[0]}")
    walked = LM_TRAIN["steps"]
    require(launches["fused_hop"] == args.length * walked
            and launches["weight_prefix"] == 2 * len(batches),
            f"lm_train_full: launches {launches}")
    steady = rows[1:]
    mean_ms = sum(r["ms"] for r in steady) / len(steady)
    out = dict(arch=mcfg.name, params=n_actual, params_analytic=n_params,
               dtype=mcfg.dtype, remat=mcfg.remat, batch=B, seq=S,
               walks_per_step=LM_TRAIN["walks"], init_seconds=init_s,
               per_step=rows, steady_ms=mean_ms,
               steady_tokens_per_s=B * S / (mean_ms / 1e3),
               steady_model_flops_share=6 * n_params * B * S
               / (mean_ms / 1e3) / BF16_PEAK_FLOPS,
               peak_source="989 TFLOP/s dense bf16, NVIDIA H100 SXM data "
                           "sheet, 700 W",
               first_loss=losses[0], last_loss=losses[-1],
               launches=launches, peak_mem_gib=peak,
               train_step_profile=step_profile,
               phase_seconds=time.perf_counter() - t_phase)
    del params, opt, step, batch
    pipe = lm_pipeline_full(engine, model, wcfg, mean_ms, dev)
    del model
    torch.cuda.empty_cache()
    return out, pipe, last_walks, engine


def dryrun_against_card(row: dict, steady_ms: float,
                        flops_6nd: float) -> dict:
    """The dry-run's projection of a train step (``launch.dryrun``
    row, at data-sheet constants) beside the step the card measured:
    the measured time over the largest of the three projected terms
    (compute, memory, collective), and the counted FLOPs over
    6·N·tokens."""
    projected_s = max(row["t_compute_s"], row["t_memory_s"],
                      row["t_collective_s"])
    return dict(t_compute_s=row["t_compute_s"], t_memory_s=row["t_memory_s"],
                t_collective_s=row["t_collective_s"],
                bottleneck=row["bottleneck"],
                counted_flops=row["counted_flops_total"],
                counted_bytes=row["counted_bytes_total"],
                flops_per_chip=row["flops_per_chip"],
                bytes_per_chip=row["bytes_per_chip"],
                flops_6nd=flops_6nd, steady_ms=steady_ms,
                measured_over_projected=steady_ms / 1e3 / projected_s,
                counted_over_6nd=row["counted_flops_total"] / flops_6nd)


def lm_pipeline_full(engine, model, wcfg, steady_ms: float, dev) -> dict:
    """olmo-1b as ``lm_train_full`` ends it, its forward pipelined: one
    more 2^14 × 80 walk batch from that phase's engine (fused path; the
    engine's key is put back after it, so later phases walk as before)
    packed into 8 × 2048 tokens, embedded as ``M.forward`` embeds them,
    then ``gpipe_forward`` over ``ShardGroup([dev] * 4)``: stage s holds
    periods 4s..4s+3 of the one segment and applies their blocks as
    ``apply_stack`` does (bf16, the same tables and casts), 8
    microbatches of 1 × 2048. Required: the pipeline bitwise equal to
    ``sequential_reference``; each microbatch after ``final_norm`` and
    its logits within 1e-4 of the largest of ``M.forward`` on that
    microbatch alone (bitwise read); 0 host syncs inside
    ``gpipe_forward``; 80 ``fused_hop`` launches. Read: ms (CUDA events)
    of the pipelined and the sequential forward, in turns, and of
    ``M.forward`` on the whole batch; kernels, busy ms and idle share of
    one pipelined and one sequential forward; ticks, bubble, peak
    memory; then the dry-run's count
    of ``lm_train_full``'s own step (8 × 2048, remat per block, AdamW)
    on the one-chip mesh beside its measured ``steady_ms``, required to
    move no collective bytes and to count a chip's FLOPs and bytes as
    the step's own."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.walk_dataset import walks_to_lm_batch
    from repro_torch.distributed.collectives import ShardGroup
    from repro_torch.distributed.pipeline import (PipelineStats,
                                                  gpipe_forward,
                                                  sequential_reference)
    from repro_torch.kernels import runtime
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import dev_mesh
    from repro_torch.models import model as M
    from repro_torch.models.layers import positional_tables
    t_phase = time.perf_counter()
    cfg = model.cfg
    B, S = LM_TRAIN["batch"], LM_TRAIN["seq"]
    P, n_mb = LM_PIPE["stages"], LM_PIPE["microbatches"]
    key = engine.key
    runtime.reset_launches()
    walks = engine.sample_walks(wcfg)
    engine.key = key
    toks, _ = walks_to_lm_batch(walks.nodes.cpu().numpy(),
                                walks.lengths.cpu().numpy(), S, B,
                                cfg.vocab_size, seed=LM_TRAIN["steps"])
    tokens = torch.from_numpy(toks).to(dev)
    dtype = M.compute_dtype(cfg)
    seg = model.layers[0]
    require(len(model.layers) == 1 and len(seg) % P == 0
            and B % n_mb == 0,
            f"lm_pipeline_full: {len(seg)} periods, {P} stages, batch {B}")
    per = len(seg) // P
    stages = [list(seg[s * per:(s + 1) * per]) for s in range(P)]
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        x, pos = M._input_embedding(model, {"tokens": tokens}, dtype)
        xs = x.view((n_mb, B // n_mb) + tuple(x.shape[1:]))
        tables = positional_tables(cfg.attention, pos[:B // n_mb])

        def stage_fn(periods, h):
            for period in periods:
                for j in range(len(period)):
                    h, _ = period[f"pos{j}"](h, tables, 1, True, None)
            return h

        group = ShardGroup([dev] * P)
        stats = PipelineStats()
        piped, syncs, sites = count_syncs(
            lambda: gpipe_forward(group, stage_fn, stages, xs, stats))
        torch.cuda.synchronize()
        launches = dict(runtime.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        seq = sequential_reference(stage_fn, stages, xs)
        pipe_equal = bool(torch.equal(piped, seq))
        hid_err, hid_equal = 0.0, True
        logits_err = logits_equal = None
        for m in range(n_mb):
            mb = B // n_mb
            want, _, _ = M.forward(model, {"tokens": tokens[m * mb:
                                                            (m + 1) * mb]})
            got = model.final_norm(piped[m])
            hid_equal &= bool(torch.equal(got, want))
            hid_err = max(hid_err, ((got.float() - want.float()).abs().max()
                                    / want.float().abs().max()).item())
            if m == 0:
                lg = M.logits_from_hidden(model, got).float()
                lw = M.logits_from_hidden(model, want).float()
                logits_equal = bool(torch.equal(lg, lw))
                logits_err = ((lg - lw).abs().max()
                              / lw.abs().max()).item()
                del lg, lw
        batch = {"tokens": tokens}
        runs = dict(
            pipeline=lambda: gpipe_forward(group, stage_fn, stages, xs),
            sequential=lambda: sequential_reference(stage_fn, stages, xs))
        # in turns, both warm: pipeline, sequential, sequential, pipeline
        ms = {k: [] for k in runs}
        for k in ("pipeline", "sequential", "sequential", "pipeline"):
            ms[k].append(cuda_ms(runs[k], reps=2, warmup=0))
        fwd_ms = cuda_ms(lambda: M.forward(model, batch), reps=2, warmup=1)
        profiles = {k: profile_call(f) for k, f in runs.items()}
    require(pipe_equal, "lm_pipeline_full: gpipe_forward != "
                        "sequential_reference")
    require(hid_err <= LM_PIPE_LOGITS_TOL and logits_err <= LM_PIPE_LOGITS_TOL,
            f"lm_pipeline_full: hidden {hid_err}, logits {logits_err} of the "
            "largest against M.forward")
    require(syncs == 0, f"lm_pipeline_full: {syncs} host syncs {sites}")
    require(launches["fused_hop"] == wcfg.max_length,
            f"lm_pipeline_full: launches {launches}")
    require((stats.ticks, stats.busy) == (n_mb + P - 1, P * n_mb),
            f"lm_pipeline_full: {stats}")
    # the dry-run of lm_train_full's own step, on the host, on meta
    t0 = time.perf_counter()
    row = dryrun.lower_cell(cfg.name, ShapeConfig("lm_train_full", S, B,
                                                  "train"),
                            mesh=dev_mesh(), cfg=cfg)
    dry_s = time.perf_counter() - t0
    # one chip: no collective, and a chip's counts (the sum of the
    # count's shares, each over 1 chip) are the step's own
    require(row["t_collective_s"] == 0
            and not any(row["collectives"].values())
            and math.isclose(row["flops_per_chip"],
                             row["counted_flops_total"], rel_tol=1e-12)
            and math.isclose(row["bytes_per_chip"],
                             row["counted_bytes_total"], rel_tol=1e-12),
            f"lm_pipeline_full: the 1x1 dry-run row {row}")
    n_params = M.count_params_analytic(cfg)
    return dict(arch=cfg.name, stages=P, microbatches=n_mb,
                microbatch=[B // n_mb, S], ticks=stats.ticks,
                busy_stage_ticks=stats.busy, bubble=stats.bubble,
                pipeline_equals_sequential=pipe_equal,
                hidden_equals_forward=hid_equal,
                hidden_max_err_of_largest=hid_err,
                logits_equal_forward=logits_equal,
                logits_max_err_of_largest=logits_err,
                tolerance=f"{LM_PIPE_LOGITS_TOL} of the largest",
                host_syncs=syncs, host_sync_sites=sites,
                pipeline_ms=sum(ms["pipeline"]) / 2,
                sequential_ms=sum(ms["sequential"]) / 2, ms_in_turns=ms,
                forward_whole_batch_ms=fwd_ms, profiles=profiles,
                peak_mem_gib=peak,
                launches=launches,
                dryrun=dict(**dryrun_against_card(
                    row, steady_ms, 6 * n_params * B * S),
                    mesh=row["mesh"], state_gib=row["state_gib"],
                    ops=row["ops"], count_seconds=dry_s,
                    note="projection at data-sheet constants (989 TFLOP/s "
                         "bf16, 3.35 TB/s, NVLink 450 GB/s and "
                         "InfiniBand 50 GB/s a direction), not a "
                         "reading"),
                phase_seconds=time.perf_counter() - t_phase)


def lm_serve_full(walks, dev) -> dict:
    """qwen2-0.5b at full width and depth serving in bf16: 64 prompts of
    256 walk tokens, ``make_prefill_step`` over them, the KV cache
    (max_seq 1024) filled by ``decode_step`` over each prompt, then 128
    tokens decoded greedily by ``make_serve_step``. A decode step must
    make no host sync (``set_sync_debug_mode("error")``)."""
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.data.walk_dataset import walks_to_lm_batch
    from repro_torch.models import model as M
    from repro_torch.train.train_loop import (make_prefill_step,
                                              make_serve_step)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mcfg = get_config(LM_SERVE["arch"])
    model = M.cast_for_serving(M.init_params(mcfg, prng.PRNGKey(1), dev))
    params = M.params_of(model)
    P, L = LM_SERVE["prompts"], LM_SERVE["prompt_len"]
    toks, _ = walks_to_lm_batch(*walks, L, P, mcfg.vocab_size, seed=100)
    prompts = torch.from_numpy(toks).to(dev)
    prefill, serve = make_prefill_step(model), make_serve_step(model)

    def events():
        return [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    prefill(params, {"tokens": prompts[:, :8]})          # warm-up
    start, end = events()
    torch.cuda.synchronize()
    start.record()
    pre_logits = prefill(params, {"tokens": prompts})
    end.record()
    end.synchronize()
    prefill_ms = start.elapsed_time(end)

    state = M.init_decode_state(model, P, LM_SERVE["max_seq"])
    start, end = events()
    start.record()
    with torch.no_grad():
        for t in range(L):
            logits, state = M.decode_step(model, prompts[:, t:t + 1], state)
    end.record()
    end.synchronize()
    fill_ms = start.elapsed_time(end) / L
    gap = float((logits.float() - pre_logits.float()).abs().max())
    agree = float((logits[:, -1].argmax(-1) == pre_logits[:, -1].argmax(-1))
                  .float().mean())
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]

    n_new = LM_SERVE["new_tokens"]

    def decode(tok, state):
        out = []
        for _ in range(n_new):
            tok, state = serve(params, tok, state)
            out.append(tok)
        return out, tok, state

    start, end = events()
    start.record()
    out_toks, tok, state = no_host_sync(decode)(tok, state)
    end.record()
    end.synchronize()
    decode_ms = start.elapsed_time(end) / n_new
    _, syncs, sites = count_syncs(lambda: serve(params, tok, state))
    require(syncs == 0, f"lm_serve_full: a decode step synced {sites}")
    prof = profile_call(lambda: serve(params, tok, state))
    gen = torch.cat(out_toks, dim=1)
    require(bool((gen >= 0).all() and (gen < mcfg.vocab_size).all()),
            "lm_serve_full: a decoded token is out of the vocabulary")
    require(math.isfinite(gap), "lm_serve_full: non-finite logits")
    out = dict(arch=mcfg.name, dtype=mcfg.dtype,
               params=sum(p.numel() for p in params.values()),
               prompts=P, prompt_len=L, max_seq=LM_SERVE["max_seq"],
               new_tokens=n_new, prefill_ms=prefill_ms,
               prefill_tokens_per_s=P * L / (prefill_ms / 1e3),
               cache_fill_ms_per_step=fill_ms, decode_ms_per_step=decode_ms,
               decode_tokens_per_s=P / (decode_ms / 1e3),
               host_syncs_per_decode_step=syncs, decode_step_profile=prof,
               prefill_vs_decode_max_abs=gap,
               prefill_vs_decode_argmax_agree=agree,
               final_pos=int(state.pos), peak_mem_gib=
               torch.cuda.max_memory_allocated() / 2**30,
               phase_seconds=time.perf_counter() - t_phase)
    del model, params, state
    torch.cuda.empty_cache()
    return out


def _leaf_gap(a, b) -> float:
    return float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _lm_grads(model, params, batch, num_groups=1):
    """The loss's gradient by name at ``params``."""
    import torch
    from repro_torch.models import model as M
    M.bind_params(model, params)
    named = dict(model.named_parameters())
    return dict(zip(params, torch.autograd.grad(
        M.loss_fn(model, batch, num_groups=num_groups),
        [named[n] for n in params])))


def _zero_leaf_limit(g, scale: float, eps: float):
    """Per element of a leaf that is 0 before the first AdamW step, the
    largest card-vs-CPU gap of its step, in units of lr, that gradients
    within the checks' tolerances allow. At step 1 the update is
    ``f(x) = x / (|x| + ε)`` of the clipped gradient ``x = scale·g``, and
    ``f' = ε / (|x| + ε)²``. The gradient check allows ``|Δg| ≤
    LM_EQ_LEAF_TOL·G`` (``G`` the leaf's largest ``|g|``) and the
    grad-norm check a clip scale off by ``LM_EQ_LOSS_RTOL``, so ``|Δx| ≤
    D = scale·(tol·G + rtol·(|g| + tol·G))``, and where ``|x| > D`` (every
    resolved element) the step differs by at most ``ε·D / (|x| − D +
    ε)²``, plus ``LM_EQ_ZERO_ROUND`` for float32 rounding of the update."""
    import torch
    G = g.abs().max()
    d = scale * (LM_EQ_LEAF_TOL * G
                 + LM_EQ_LOSS_RTOL * (g.abs() + LM_EQ_LEAF_TOL * G))
    x = scale * g.abs()
    return (eps * d / (torch.clamp_min(x - d, 0.0) + eps) ** 2
            + LM_EQ_ZERO_ROUND)


def _train_steps(card, host, p_host, batch, dev, num_groups=1, n_steps=2):
    """``n_steps`` ``make_train_step`` steps on the card and on the CPU,
    each started from the CPU's state. Returns (gaps, unresolved elements,
    step bound): loss and grad norm relative; gradients, moments and
    params of each leaf's largest magnitude, except params whose AdamW
    direction is unresolved (``LM_EQ_UNRESOLVED``), read against the step
    bound 2·lr.

    A leaf that is 0 before the first step (a layernorm's bias at init)
    is held apart: its largest magnitude after the step is lr, and a
    resolved element near the threshold, whose gradient the gradient
    check holds only to ~10%, moves by up to ~1e-4·lr through AdamW's ε.
    Its gap is read in units of lr (``zero_leaf_params_of_lr``) and held
    per element to what the gradient tolerances allow
    (``_zero_leaf_limit``; ``zero_leaf_of_limit`` ≤ 1). Every leaf's step
    is also held against the CPU's AdamW on the card's own gradients
    (``params_given_card_grads``), the arithmetic given the gradients
    that check holds."""
    import torch
    from repro_torch.train.optimizer import (AdamWConfig, apply_updates,
                                             init_opt_state, lr_at, tree_map)
    from repro_torch.train.train_loop import make_train_step
    b_card = {k: v.to(dev) for k, v in batch.items()}
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    steps = {"card": make_train_step(card, opt_cfg, num_groups),
             "cpu": make_train_step(host, opt_cfg, num_groups)}
    p, o = p_host, init_opt_state(p_host, opt_cfg)
    gaps = dict(loss=0.0, grad_norm=0.0, grads=0.0, mu=0.0, nu=0.0,
                params=0.0, unresolved_max_abs=0.0, params_given_card_grads=0.0,
                zero_leaf_params_of_lr=0.0, zero_leaf_of_limit=0.0)
    worst = {}                   # the leaf of each largest gap

    def note(k, gap, n):
        if gap > gaps[k]:
            gaps[k], worst[k] = gap, n
    unresolved, bound = 0, 0.0
    for t in range(n_steps):
        pc, oc = tree_map(lambda x: x.to(dev), (p, o))
        gc = _lm_grads(card, pc, b_card, num_groups)
        gh = _lm_grads(host, p, batch, num_groups)
        pc, oc, mc = steps["card"](pc, oc, b_card)
        ph, oh, mh = steps["cpu"](p, o, batch)
        for k in ("loss", "grad_norm"):
            gaps[k] = max(gaps[k], abs(float(mc[k]) - float(mh[k]))
                          / abs(float(mh[k])))
        lr = float(lr_at(opt_cfg, t + 1))
        step_bound = 2 * lr
        bound = max(bound, step_bound)
        clip = min(opt_cfg.clip_norm / max(float(mh["grad_norm"]), 1e-12),
                   1.0)
        with torch.no_grad():
            pg, _, _ = apply_updates(p, {n: x.cpu() for n, x in gc.items()},
                                     o, opt_cfg)
        for n, ref in ph.items():
            note("grads", _leaf_gap(gc[n], gh[n]), n)
            note("mu", _leaf_gap(oc.mu[n], oh.mu[n]), n)
            note("nu", _leaf_gap(oc.nu[n], oh.nu[n]), n)
            note("params_given_card_grads", _leaf_gap(pc[n], pg[n]), n)
            unres = gh[n].abs() <= LM_EQ_UNRESOLVED * gh[n].abs().max()
            diff = (pc[n].cpu() - ref).abs()
            if t == 0 and not bool(p[n].any()) and (~unres).any():
                res = diff[~unres] / lr
                note("zero_leaf_params_of_lr", float(res.max()), n)
                note("zero_leaf_of_limit", float((res / _zero_leaf_limit(
                    gh[n], clip, opt_cfg.eps)[~unres]).max()), n)
            elif (~unres).any():
                note("params", float(diff[~unres].max() / ref.abs().max()),
                     n)
            if unres.any():
                note("unresolved_max_abs", float(diff[unres].max())
                     / step_bound, n)
            unresolved += int(unres.sum())
        p, o = ph, oh
    gaps["worst_leaf"] = worst
    return gaps, unresolved, bound


def _train_gaps_hold(gaps) -> bool:
    return (gaps["loss"] <= LM_EQ_LOSS_RTOL
            and gaps["grad_norm"] <= LM_EQ_LOSS_RTOL
            and max(gaps[k] for k in (
                "grads", "mu", "nu", "params", "params_given_card_grads"))
            <= LM_EQ_LEAF_TOL
            and gaps["zero_leaf_of_limit"] <= 1.0
            and gaps["unresolved_max_abs"] <= 1.0)


# the leaves' params and their gaps as every LM card-vs-CPU phase reports
# them: of each leaf's largest magnitude, and a zero leaf's in lr and of
# its limit
TRAIN_GAP_KEYS = ("grads", "mu", "nu", "params", "params_given_card_grads",
                  "zero_leaf_params_of_lr", "zero_leaf_of_limit")


def _decode_card_cpu(card, host, p_card, p_host, tokens, dev, frames=None):
    """From the given parameters on both sides: 8 decode steps of
    ``tokens`` [2, ≥9], the card's prefill of the same 8, then 4 greedy
    tokens. An enc-dec model decodes over the encoder's memory of
    ``frames`` and prefills over them; a VLM prefills with 0 patches.
    Returns (logits of the largest, prefill vs decode max abs, prefill vs
    decode within ``LM_EQ_CONSISTENCY``, greedy equal)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.train.train_loop import make_serve_step
    dec = {}
    for name, model, params, d in (("card", card, p_card, dev),
                                   ("cpu", host, p_host, "cpu")):
        M.bind_params(model, params)
        t = tokens.to(d)
        st = M.init_decode_state(model, 2, 16)
        extra = {}
        if model.cfg.family == "vlm":
            extra["patches"] = torch.zeros((2, 0, model.cfg.d_model),
                                           device=d)
        if frames is not None:
            extra["frames"] = frames.to(d)
            with torch.no_grad():
                enc_out, enc_pos = M.run_encoder(model, extra["frames"])
            st = st._replace(enc_out=enc_out, enc_pos=enc_pos)
        lg = []
        with torch.no_grad():
            for i in range(8):
                x, st = M.decode_step(model, t[:, i:i + 1], st)
                lg.append(x[:, 0])
            pre, _, _ = M.forward(model, {"tokens": t[:, :8], **extra})
            pre = M.logits_from_hidden(model, pre)
        serve = make_serve_step(model)
        tok, gen = t[:, 8:9], []
        for _ in range(4):
            tok, st = serve(params, tok, st)
            gen.append(tok)
        dec[name] = dict(logits=torch.stack(lg, 1).cpu(), prefill=pre.cpu(),
                         greedy=torch.cat(gen, 1).cpu())
    lc, lh = dec["card"]["logits"], dec["cpu"]["logits"]
    logit_gap = float((lc[:, :4] - lh[:, :4]).abs().max() / lh.abs().max())
    consist = float((dec["card"]["prefill"] - lc).abs().max())
    consist_ok = torch.allclose(lc, dec["card"]["prefill"],
                                rtol=LM_EQ_CONSISTENCY,
                                atol=LM_EQ_CONSISTENCY)
    greedy_equal = torch.equal(dec["card"]["greedy"], dec["cpu"]["greedy"])
    return logit_gap, consist, consist_ok, greedy_equal


def lm_cuda_equals_cpu(dev) -> dict:
    """olmo-1b and qwen2-0.5b at full width, 2 layers, float32, TF32 off,
    the same parameters on the card and the CPU. ``LM_EQ_STEPS`` train
    steps, each started on both from the CPU's state: loss and gradient
    norm within ``LM_EQ_LOSS_RTOL``; gradients, moments and params within
    ``LM_EQ_LEAF_TOL`` of each leaf's largest magnitude, except params
    whose AdamW direction is unresolved (``LM_EQ_UNRESOLVED``), held to
    the step bound 2·lr. Then, from the initial parameters: 4 decode
    steps' logits within ``LM_EQ_LOGITS_TOL`` of the largest, prefill vs
    decode on the card within ``LM_EQ_CONSISTENCY``, 4 greedy tokens
    equal. (Left free, the two runs part at the unresolved elements,
    whose ±lr steps change the next gradient: a later step is read from
    a shared state.)"""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for arch in ("olmo-1b", "qwen2-0.5b"):
            cfg = dataclasses.replace(get_config(arch),
                                      num_layers=LM_EQ_LAYERS,
                                      dtype="float32")
            card = M.init_params(cfg, prng.PRNGKey(3), dev)
            host = M.TransformerLM(cfg, None, "cpu")
            p_card = M.params_of(card)
            p_host = {n: t.cpu() for n, t in p_card.items()}
            M.bind_params(host, p_host)
            rng = np.random.default_rng(5)
            toks = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
            labs = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
            batch = {k: torch.from_numpy(v) for k, v in
                     (("tokens", toks), ("labels", labs))}
            gaps, unresolved, bound = _train_steps(card, host, p_host,
                                                   batch, dev,
                                                   n_steps=LM_EQ_STEPS)
            require(_train_gaps_hold(gaps),
                    f"lm_cuda_equals_cpu {arch}: {gaps}")
            logit_gap, consist, consist_ok, greedy_equal = _decode_card_cpu(
                card, host, p_card, p_host, batch["tokens"], dev)
            require(logit_gap <= LM_EQ_LOGITS_TOL and consist_ok
                    and greedy_equal,
                    f"lm_cuda_equals_cpu {arch}: logits {logit_gap}, "
                    f"prefill/decode {consist}, greedy {greedy_equal}")
            out[arch] = dict(
                layers=LM_EQ_LAYERS, params=sum(
                    v.numel() for v in p_host.values()),
                steps=LM_EQ_STEPS,
                gaps={k: gaps[k] for k in TRAIN_GAP_KEYS},
                worst_leaf=gaps["worst_leaf"],
                loss_rel=gaps["loss"], grad_norm_rel=gaps["grad_norm"],
                unresolved_elements=unresolved,
                unresolved_max_of_step_bound=gaps["unresolved_max_abs"],
                step_bound=bound, decode_logits_of_max=logit_gap,
                prefill_vs_decode_max_abs=consist, greedy_equal=True)
            del card, host, p_card, p_host
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["tolerances"] = dict(loss_rtol=LM_EQ_LOSS_RTOL,
                             leaf_tol=LM_EQ_LEAF_TOL,
                             logits_tol=LM_EQ_LOGITS_TOL,
                             consistency=LM_EQ_CONSISTENCY,
                             unresolved=LM_EQ_UNRESOLVED)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---- the MoE family ------------------------------------------------------

# lm_moe_serve_full: each config at full width and cut depth (deepseek's
# dense layer 0 and one MoE layer with MLA; arctic's one MoE layer with
# its dense residual), bf16, serving
LM_MOE_ARCHS = (("deepseek-v2-236b", 2), ("arctic-480b", 1))
LM_MOE = dict(prompts=16, prompt_len=512, max_seq=1024, decode_batch=64,
              fill=16, new_tokens=32)
# lm_moe_cuda_equals_cpu: both configs ``reduced`` at a width at which
# the CPU side takes seconds; a token whose CPU gap between its k-th and
# (k+1)-th routing probability is below LM_MOE_NEAR_TIE may route apart
LM_MOE_EQ = dict(layers=2, d_model=1024, vocab=8192, experts=64, batch=4,
                 seq=64, groups=(1, 4), steps=1)
LM_MOE_NEAR_TIE = 1e-5
# init's peak may exceed the parameters plus one slab's draw by the
# caching allocator's rounding of ~30 leaves and their temporaries
INIT_SLACK = 16 << 20


def _moe_hooks(model, record):
    """A forward pre-hook on every MoE layer of ``model`` calling
    ``record(layer, routing, logits)`` with the routing it recomputes on
    the layer's input. Returns the handles."""
    from repro_torch.models.moe import MoE

    def hook(mod, args):
        x = args[0]
        g = args[1] if len(args) > 1 else 1
        xg, r, _ = mod.route(x, g)
        record(mod, r, xg @ mod.router.to(x.dtype))
    return [m.register_forward_pre_hook(hook) for m in model.modules()
            if isinstance(m, MoE)]


def _drop_share(model, run):
    """(share of the MoE slots dropped at the capacity over ``run()``,
    its result): an untimed pass whose counts stay on the card until its
    end."""
    import torch
    counts = []
    hooks = _moe_hooks(model, lambda mod, r, la: counts.append(
        (torch.logical_not(r.keep).sum(), r.keep.numel())))
    try:
        result = run()
    finally:
        for h in hooks:
            h.remove()
    dropped = int(torch.stack([c for c, _ in counts]).sum())
    return dropped / sum(n for _, n in counts), result


def lm_moe_serve_full(engine, args, dev) -> dict:
    """deepseek-v2-236b (2 layers: the dense layer 0 and one MoE layer of
    160 routed and 2 shared experts, MLA) and arctic-480b (1 layer: GQA,
    128 experts top-2, the dense residual) at full width in bf16, each
    drawn straight into bf16 slab by slab (``init_params(dtype=)``), on
    prompts of 2^14 × 80 walks sampled from the main path's final window
    (fused path, one batch a model): a prefill of 16 × 512 tokens, a
    cache of 1,024 for 64 sequences filled by 16 ``decode_step``s, then
    32 greedy steps under ``set_sync_debug_mode("error")``, one traced.
    Reads init seconds and peak memory (required within the bf16
    parameter bytes plus one slab's draw), prefill ms, decode ms a step
    against its bound (the bytes a step reads: every weight but the
    unused embedding rows, and the caches), the shares of dropped slots
    at prefill and at decode, the aux loss and peak memory."""
    import dataclasses
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.configs.base import WalkConfig
    from repro_torch.data.walk_dataset import walks_to_lm_batch
    from repro_torch.kernels import runtime
    from repro_torch.models import layers as TL
    from repro_torch.models import model as M
    from repro_torch.models.moe import _capacity
    from repro_torch.train.train_loop import (make_prefill_step,
                                              make_serve_step)
    t_phase = time.perf_counter()
    P, S = LM_MOE["prompts"], LM_MOE["prompt_len"]
    Bd, fill, n_new = (LM_MOE["decode_batch"], LM_MOE["fill"],
                       LM_MOE["new_tokens"])
    wcfg = WalkConfig(num_walks=LM_TRAIN["walks"], max_length=args.length,
                      start_mode="nodes")
    # one slab's draw: what init may hold beyond the parameters, read as
    # a two-slab leaf's peak less the leaf itself
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    leaf = TL.truncated_normal(prng.PRNGKey(0), (2 * TL.INIT_SLAB,), 0.01,
                               dev, torch.bfloat16)
    slab_bytes = torch.cuda.max_memory_allocated() - base \
        - leaf.numel() * leaf.element_size()
    del leaf

    def events():
        return [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    out = dict(slab_elements=TL.INIT_SLAB, slab_draw_bytes=slab_bytes)
    runtime.reset_launches()
    for i, (arch, layers) in enumerate(LM_MOE_ARCHS):
        t_model = time.perf_counter()
        walks = engine.sample_walks(wcfg)
        nodes = walks.nodes.cpu().numpy()
        lengths = walks.lengths.cpu().numpy()
        del walks
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        dtype = M.compute_dtype(cfg)
        toks, _ = walks_to_lm_batch(nodes, lengths, S, P, cfg.vocab_size,
                                    seed=200 + i)
        prompts = torch.from_numpy(toks).to(dev)
        toks, _ = walks_to_lm_batch(nodes, lengths, fill, Bd,
                                    cfg.vocab_size, seed=300 + i)
        dprompts = torch.from_numpy(toks).to(dev)

        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = M.init_params(cfg, prng.PRNGKey(10 + i), dev, dtype=dtype)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() - base
        params = M.params_of(model)
        n_params = sum(p.numel() for p in params.values())
        param_bytes = sum(p.numel() * p.element_size()
                          for p in params.values())
        require(init_peak <= param_bytes + slab_bytes + INIT_SLACK,
                f"lm_moe_serve_full {arch}: init peak {init_peak} B over "
                f"{param_bytes} B of parameters + {slab_bytes} B of a slab")

        prefill = make_prefill_step(model)
        prefill(params, {"tokens": prompts[:, :8]})          # warm-up
        start, end = events()
        torch.cuda.synchronize()
        start.record()
        pre_logits = prefill(params, {"tokens": prompts})
        end.record()
        end.synchronize()
        prefill_ms = start.elapsed_time(end)
        with torch.no_grad():
            prefill_drop, (_, _, aux) = _drop_share(
                model, lambda: M.forward(model, {"tokens": prompts}))
        aux = float(aux)

        state = M.init_decode_state(model, Bd, LM_MOE["max_seq"])

        def fill_cache(state=state):
            with torch.no_grad():
                for t in range(fill):
                    lg, state = M.decode_step(model, dprompts[:, t:t + 1],
                                              state)
            return lg
        decode_drop, logits = _drop_share(model, fill_cache)
        serve = make_serve_step(model)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]

        def decode(tok, state):
            toks_out = []
            for _ in range(n_new):
                tok, state = serve(params, tok, state)
                toks_out.append(tok)
            return toks_out, tok, state

        start, end = events()
        start.record()
        out_toks, tok, state = no_host_sync(decode)(tok, state)
        end.record()
        end.synchronize()
        decode_ms = start.elapsed_time(end) / n_new
        _, syncs, sites = count_syncs(lambda: serve(params, tok, state))
        require(syncs == 0, f"lm_moe_serve_full {arch}: a decode step "
                            f"synced {sites}")
        prof = profile_call(lambda: serve(params, tok, state))
        gen = torch.cat(out_toks, dim=1)
        require(bool((gen >= 0).all() and (gen < cfg.vocab_size).all()),
                f"lm_moe_serve_full {arch}: a token is out of the vocabulary")
        require(bool(torch.isfinite(pre_logits.float()).all())
                and bool(torch.isfinite(logits.float()).all())
                and math.isfinite(aux) and aux > 0,
                f"lm_moe_serve_full {arch}: non-finite logits or aux {aux}")
        emb = model.embed.table
        weight_bytes = param_bytes - emb.numel() * emb.element_size() \
            + Bd * cfg.d_model * emb.element_size()
        cache_bytes = sum(t.numel() * t.element_size()
                          for c in state.caches for t in c)
        expert_bytes = sum(p.numel() * p.element_size()
                           for n, p in params.items()
                           if n.endswith(("moe.w_gate", "moe.w_up",
                                          "moe.w_down")))
        bound_ms = (weight_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
        m = cfg.moe
        out[arch] = dict(
            layers=layers, dtype=cfg.dtype, params=n_params,
            params_analytic=M.count_params_analytic(cfg),
            param_gib=param_bytes / 2**30, experts=m.num_experts,
            top_k=m.top_k, init_seconds=init_s,
            init_peak_gib=init_peak / 2**30,
            init_over_params_gib=(init_peak - param_bytes) / 2**30,
            init_allowance_gib=(param_bytes + slab_bytes + INIT_SLACK)
            / 2**30,
            prompts=P, prompt_len=S,
            prefill_capacity=_capacity(P * S, m),
            prefill_ms=prefill_ms,
            prefill_tokens_per_s=P * S / (prefill_ms / 1e3),
            prefill_dropped_share=prefill_drop, aux_loss=aux,
            decode_batch=Bd, max_seq=LM_MOE["max_seq"], cache_fill=fill,
            decode_capacity=_capacity(Bd, m),
            decode_dropped_share=decode_drop, new_tokens=n_new,
            decode_ms_per_step=decode_ms,
            decode_tokens_per_s=Bd / (decode_ms / 1e3),
            decode_bound_ms=bound_ms, decode_bound_by="bytes",
            decode_weight_bytes=weight_bytes, decode_cache_bytes=cache_bytes,
            expert_bytes=expert_bytes,
            host_syncs_per_decode_step=syncs, decode_step_profile=prof,
            final_pos=int(state.pos),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            peak_over_window_gib=(torch.cuda.max_memory_allocated() - base)
            / 2**30, window_gib=base / 2**30,
            seconds=time.perf_counter() - t_model)
        del model, params, state, prefill, serve, pre_logits, logits, tok
        del out_toks, gen, prompts, dprompts
        torch.cuda.empty_cache()
    launches = dict(runtime.LAUNCHES)
    require(launches["fused_hop"] == args.length * len(LM_MOE_ARCHS)
            and launches["weight_prefix"] == 0
            and launches["walk_step_tiled"] == 0,
            f"lm_moe_serve_full: launches {launches}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _routing_agreement(card, host, cfg, tokens, dev, g):
    """Every MoE layer's routing on one forward of ``tokens`` at
    ``num_groups`` ``g``, card against CPU: (near-tie tokens, routing
    entries that differ, groups with a near tie, {side: aux}). A token
    whose CPU gap between its k-th and (k+1)-th probability is below
    ``LM_MOE_NEAR_TIE`` may route apart: the other tokens' top-k experts
    are compared, and the ranks and keep of every group without one."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.moe import routing_margin
    routes = {"card": [], "cpu": []}
    aux = {}
    for name, model, d in (("card", card, dev), ("cpu", host, "cpu")):
        hooks = _moe_hooks(model, lambda mod, r, la, name=name:
                           routes[name].append((r, la.cpu())))
        try:
            with torch.no_grad():
                _, _, a = M.forward(model, {"tokens": tokens.to(d)},
                                    num_groups=g)
        finally:
            for h in hooks:
                h.remove()
        aux[name] = float(a)
    near, differ, groups_with_near = 0, 0, 0
    for (rc, _), (rh, la) in zip(routes["card"], routes["cpu"]):
        tie = routing_margin(la, cfg.moe.top_k) < LM_MOE_NEAR_TIE
        near += int(tie.sum())
        both = rc.keep.cpu() & rh.keep
        top_c = torch.where(both, rc.e_idx.cpu(), -1)
        top_h = torch.where(both, rh.e_idx, -1)
        differ += int((top_c != top_h).any(-1)[~tie].sum())
        for gi in range(tie.shape[0]):
            if bool(tie[gi].any()):
                groups_with_near += 1
                continue
            for f in ("e_idx", "r_idx", "keep"):
                differ += int((getattr(rc, f)[gi].cpu()
                               != getattr(rh, f)[gi]).sum())
    return near, differ, groups_with_near, aux


def lm_moe_cuda_equals_cpu(dev) -> dict:
    """deepseek-v2-236b and arctic-480b ``reduced`` to 2 layers, d_model
    1024, 64 experts (top-2), vocab 8192, in float32 with TF32 off, the
    same parameters on the card and the CPU, a 4 × 64 batch (4 × 128
    until the enc-dec LM phases needed the seconds). At
    ``num_groups`` 1 and 4: every MoE layer's routing on the first
    forward equal (top-k experts of every token but the near ties, whose
    CPU gap between the k-th and (k+1)-th probability is below
    ``LM_MOE_NEAR_TIE``, counted; ranks and keep of every group without
    one), the aux loss within ``LM_EQ_LOSS_RTOL``, then 2 train steps
    from a shared state at ``lm_cuda_equals_cpu``'s tolerances. Then 8
    decode steps' logits and 4 greedy tokens as there (prefill vs decode
    is read: a prefill slot dropped at the capacity parts them)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    e = LM_MOE_EQ
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for arch, _ in LM_MOE_ARCHS:
            t_arch = time.perf_counter()
            cfg = dataclasses.replace(
                reduced(get_config(arch), layers=e["layers"],
                        d_model=e["d_model"], vocab=e["vocab"],
                        experts=e["experts"]), dtype="float32")
            host = M.init_params(cfg, prng.PRNGKey(4), "cpu")
            p_host = M.params_of(host)
            p_card = {n: t.to(dev) for n, t in p_host.items()}
            card = M.TransformerLM(cfg, None, dev)
            M.bind_params(card, p_card)
            rng = np.random.default_rng(6)
            batch = {k: torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (e["batch"], e["seq"])).astype(np.int32))
                for k in ("tokens", "labels")}
            per_groups = {}
            for g in e["groups"]:
                near, differ, groups_with_near, aux = _routing_agreement(
                    card, host, cfg, batch["tokens"], dev, g)
                aux_rel = abs(aux["card"] - aux["cpu"]) / abs(aux["cpu"])
                require(differ == 0 and aux_rel <= LM_EQ_LOSS_RTOL,
                        f"lm_moe_cuda_equals_cpu {arch} groups {g}: "
                        f"{differ} routing entries differ, aux {aux}")
                gaps, unresolved, bound = _train_steps(
                    card, host, p_host, batch, dev, num_groups=g,
                    n_steps=e["steps"])
                require(_train_gaps_hold(gaps),
                        f"lm_moe_cuda_equals_cpu {arch} groups {g}: {gaps}")
                per_groups[g] = dict(
                    near_tie_tokens=near,
                    groups_with_near_ties=groups_with_near,
                    routing_entries_differ=0, aux=aux["cpu"],
                    aux_rel=aux_rel,
                    gaps={k: gaps[k] for k in TRAIN_GAP_KEYS},
                    worst_leaf=gaps["worst_leaf"],
                    loss_rel=gaps["loss"], grad_norm_rel=gaps["grad_norm"],
                    unresolved_elements=unresolved,
                    unresolved_max_of_step_bound=gaps[
                        "unresolved_max_abs"], step_bound=bound)
            # prefill and decode differ where the prefill drops a slot at
            # its capacity (a decode step of 2 tokens drops none): read,
            # not required
            logit_gap, consist, _, greedy_equal = _decode_card_cpu(
                card, host, p_card, p_host, batch["tokens"][:2], dev)
            require(logit_gap <= LM_EQ_LOGITS_TOL and greedy_equal,
                    f"lm_moe_cuda_equals_cpu {arch}: logits {logit_gap}, "
                    f"greedy {greedy_equal}")
            out[arch] = dict(
                config=dict(layers=cfg.num_layers, d_model=cfg.d_model,
                            vocab=cfg.vocab_size,
                            experts=cfg.moe.num_experts,
                            top_k=cfg.moe.top_k,
                            attention=cfg.attention.kind),
                params=sum(v.numel() for v in p_host.values()),
                batch=[e["batch"], e["seq"]], steps=e["steps"],
                by_num_groups={str(k): v for k, v in per_groups.items()},
                decode_logits_of_max=logit_gap,
                prefill_vs_decode_max_abs=consist, greedy_equal=True,
                seconds=time.perf_counter() - t_arch)
            del card, host, p_card, p_host
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["tolerances"] = dict(loss_rtol=LM_EQ_LOSS_RTOL,
                             leaf_tol=LM_EQ_LEAF_TOL,
                             logits_tol=LM_EQ_LOGITS_TOL,
                             consistency=LM_EQ_CONSISTENCY,
                             unresolved=LM_EQ_UNRESOLVED,
                             near_tie=LM_MOE_NEAR_TIE)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---- the recurrent families (models/ssm.py) ------------------------------

# lm_ssm_train_full: xlstm-125m at full size (configs/xlstm_125m.py: 9
# mLSTM and 3 sLSTM layers) trained as lm_train_full trains olmo-1b,
# float32 masters, bf16 compute, remat per block, on 8 × 512 tokens (2048
# until the enc-dec phases needed the seconds): 2 steps, the second
# traced (the time loops launch their kernels a sequence position at a
# time, so a step's ~1.8·10^5 kernels and the reading of its trace scale
# with the length, not the batch)
LM_SSM_TRAIN = dict(arch="xlstm-125m", batch=8, seq=512, steps=2, lr=3e-4,
                    warmup_steps=1)
# lm_ssm_serve_full, bf16: xlstm-125m at full size (prefill, a cache
# filled by decode over the prompts, of 256 tokens since the enc-dec
# phases, 512 before, greedy steps) and jamba-v0.1-52b at
# full width on one period of 8 of its 32 layers (prefill, a cache
# filled by `fill` steps at the decode batch, greedy steps); the mamba
# block's kernels per token are read here (xlstm's blocks' in training)
LM_SSM_SERVE = (
    ("xlstm-125m", dict(layers=None, prompts=64, prompt_len=256,
                        max_seq=1024, decode_batch=64, fill=256,
                        new_tokens=64, kernels_per_token=())),
    ("jamba-v0.1-52b", dict(layers=8, prompts=16, prompt_len=512,
                            max_seq=1024, decode_batch=64, fill=16,
                            new_tokens=32, kernels_per_token=("mamba",))))
# lm_ssm_cuda_equals_cpu, float32, TF32 off: xlstm-125m at full width on
# one period (4 layers) on 2 × 512 tokens (two 256-token chunks), jamba
# reduced to one period at d_model 1024 with 4 experts on 2 × 64
LM_SSM_EQ = dict(xlstm=dict(layers=4, seq=512),
                 jamba=dict(layers=8, d_model=1024, vocab=8192, experts=4,
                            seq=64))
# the sequence lengths whose kernel counts give a block's kernels per
# token (their difference over the tokens between them); the chunkwise
# mLSTM's are one and two chunks
KERNELS_PER_TOKEN_SEQ = (64, 128)


def block_kernels_per_token(blocks: dict, batch: int, dtype, dev,
                            train: bool) -> dict:
    """For each named ``Block``: device kernels per token of its
    full-sequence forward (and, with ``train``, of a forward and its
    backward), read as the difference between two sequence lengths over
    the tokens between them (``KERNELS_PER_TOKEN_SEQ``; one and two
    chunks for the chunkwise mLSTM), and of one decode step from its zero
    state."""
    import torch
    from repro_torch.models import transformer as tfm
    out = {}
    for name, blk in blocks.items():
        s0, s1 = KERNELS_PER_TOKEN_SEQ
        if blk.spec.kind == "mlstm" and blk.cfg.ssm.chunked:
            s0, s1 = blk.cfg.ssm.chunk_size, 2 * blk.cfg.ssm.chunk_size
        d = blk.cfg.d_model
        xs = {S: torch.randn((batch, S, d), device=dev).to(dtype)
              for S in (s0, s1)}

        def fwd(S):
            with torch.no_grad():
                blk(xs[S], None)

        def fwd_bwd(S):
            x = xs[S].detach().requires_grad_()
            y, _ = blk(x, None)
            torch.autograd.grad(y.float().sum(), [x] + [
                p for p in blk.parameters() if p.requires_grad])

        row = {}
        for label, fn in (("forward", fwd),) + ((("forward_backward",
                                                  fwd_bwd),) if train
                                                else ()):
            fn(s0)                                   # warm-up
            k = [len(trace_kernels(lambda S=S: fn(S))[0]) for S in (s0, s1)]
            row[label] = (k[1] - k[0]) / (s1 - s0)
        state = tfm.init_layer_cache(blk.cfg, blk.spec, batch, 16, dtype,
                                     dev)
        x1 = xs[s0][:, :1]
        with torch.no_grad():
            blk.decode(x1, state, None, None)
            row["decode_step"] = len(trace_kernels(
                lambda: blk.decode(x1, state, None, None))[0])
        out[name] = row
    return out


def lm_ssm_train_full(engine, args, dev) -> dict:
    """xlstm-125m at full size (12 layers: 9 mLSTM in the chunkwise form,
    3 sLSTM; d_model 768) trained as ``lm_train_full`` trains olmo-1b:
    each step samples 2^14 walks × 80 from nodes on the main path's final
    window (fused path), packs them into 8 × 512 tokens and takes one
    ``make_train_step`` step (float32 masters, bf16 compute, remat per
    block, AdamW lr 3e-4, warmup 1), ``LM_SSM_TRAIN["steps"]`` steps, the
    last traced. Per step: ms (CUDA events, packing apart; the traced
    step's by the host clock inside its trace), tokens/s, model FLOP/s as
    a share of the bf16 peak, host syncs (untraced steps: required 0),
    loss (required finite); the traced step's kernels and idle share; the
    kernels per token of each block kind; peak memory."""
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.configs.base import WalkConfig
    from repro_torch.data.walk_dataset import walks_to_lm_batch
    from repro_torch.kernels import runtime
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mcfg = get_config(LM_SSM_TRAIN["arch"])
    t0 = time.perf_counter()
    model = M.init_params(mcfg, prng.PRNGKey(20), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_steps = LM_SSM_TRAIN["steps"]
    opt_cfg = AdamWConfig(lr=LM_SSM_TRAIN["lr"],
                          warmup_steps=LM_SSM_TRAIN["warmup_steps"],
                          total_steps=n_steps)
    step = make_train_step(model, opt_cfg)
    params = M.params_of(model)
    opt = init_opt_state(params, opt_cfg)
    n_params = M.count_params_analytic(mcfg)
    wcfg = WalkConfig(num_walks=LM_TRAIN["walks"], max_length=args.length,
                      start_mode="nodes")
    B, S = LM_SSM_TRAIN["batch"], LM_SSM_TRAIN["seq"]
    rows = []
    runtime.reset_launches()
    for s in range(n_steps):
        walks = engine.sample_walks(wcfg)
        t0 = time.perf_counter()
        nodes, lengths = walks.nodes.cpu().numpy(), walks.lengths.cpu().numpy()
        toks, labels = walks_to_lm_batch(nodes, lengths, S, B,
                                         mcfg.vocab_size, seed=400 + s)
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        pack_ms = (time.perf_counter() - t0) * 1e3
        if s == n_steps - 1:
            # the device activity alone: the host ops of a step's ~7·10^5
            # kernels would double the trace
            res = []
            t0 = time.perf_counter()
            step_profile = kernel_reading(*trace_kernels(
                lambda: res.append(step(params, opt, batch))))
            step_profile["seconds"] = time.perf_counter() - t0
            (params, opt, metrics), syncs, sites = res[0], None, None
            ms = step_profile["traced_wall_ms"]
        else:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            (params, opt, metrics), syncs, sites = count_syncs(
                lambda: step(params, opt, batch))
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        tok_s = B * S / (ms / 1e3)
        rows.append(dict(step=s, ms=ms, traced=syncs is None,
                         pack_ms=pack_ms, tokens_per_s=tok_s,
                         model_flops_share=6 * n_params * tok_s
                         / BF16_PEAK_FLOPS,
                         host_syncs=syncs, host_sync_sites=sites,
                         loss=float(metrics["loss"]),
                         grad_norm=float(metrics["grad_norm"])))
    launches = dict(runtime.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [r["loss"] for r in rows]
    norms = [r["grad_norm"] for r in rows]
    require(all(math.isfinite(x) for x in losses + norms),
            f"lm_ssm_train_full: losses {losses}, grad norms {norms}")
    require(all(r["host_syncs"] == 0 for r in rows if not r["traced"]),
            "lm_ssm_train_full: host syncs "
            f"{[r['host_sync_sites'] for r in rows]}")
    require(launches["fused_hop"] == args.length * n_steps
            and launches["weight_prefix"] == 0,
            f"lm_ssm_train_full: launches {launches}")
    kinds = {}
    for blk in tfm.blocks(model.layers):
        kinds.setdefault(blk.spec.kind, blk)
    t0 = time.perf_counter()
    per_token = block_kernels_per_token(kinds, B, M.compute_dtype(mcfg),
                                        dev, train=True)
    per_token_s = time.perf_counter() - t0
    out = dict(arch=mcfg.name, params=sum(p.numel() for p in params.values()),
               params_analytic=n_params, layers=mcfg.num_layers,
               layer_kinds={k: sum(1 for sp in tfm.layer_specs(mcfg)
                                   if sp.kind == k) for k in kinds},
               chunked_mlstm=mcfg.ssm.chunked, chunk=mcfg.ssm.chunk_size,
               dtype=mcfg.dtype, remat=mcfg.remat, batch=B, seq=S,
               walks_per_step=LM_TRAIN["walks"], steps=n_steps,
               init_seconds=init_s, kernels_per_token_seconds=per_token_s,
               per_step=rows, kernels_per_token=per_token,
               kernels_per_token_batch=B,
               first_loss=losses[0], last_loss=losses[-1],
               launches=launches, peak_mem_gib=peak,
               train_step_profile=step_profile,
               phase_seconds=time.perf_counter() - t_phase)
    del model, params, opt, step, batch
    torch.cuda.empty_cache()
    return out


def lm_ssm_serve_full(engine, args, dev) -> dict:
    """xlstm-125m at full size and jamba-v0.1-52b at full width on one
    period (8 of 32 layers: 7 mamba and 1 GQA layer with a 4,096-slot
    ring, 4 MoE FFNs of 16 experts top-2 and 4 dense ones), each drawn
    straight into bf16 slab by slab, each on one 2^14 × 80 walk batch of
    the main path's final window (fused path): a prefill of ``prompts``
    × ``prompt_len`` tokens, a decode state at ``decode_batch`` filled by
    ``fill`` ``decode_step``s (xlstm: its prompts), then ``new_tokens``
    greedy steps under ``set_sync_debug_mode("error")``, one traced.
    Reads init seconds and peak (required within the parameter bytes plus
    one slab's draw), prefill ms, decode ms a step against its byte bound
    (the weights a step reads, the SSM states read and written, the KV
    ring read), jamba's dropped-slot shares and the blocks' kernels per
    token."""
    import dataclasses
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.configs.base import WalkConfig
    from repro_torch.data.walk_dataset import walks_to_lm_batch
    from repro_torch.kernels import runtime
    from repro_torch.models import layers as TL
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm
    from repro_torch.models.attention import KVCache
    from repro_torch.train.train_loop import (make_prefill_step,
                                              make_serve_step)
    t_phase = time.perf_counter()
    wcfg = WalkConfig(num_walks=LM_TRAIN["walks"], max_length=args.length,
                      start_mode="nodes")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    leaf = TL.truncated_normal(prng.PRNGKey(0), (2 * TL.INIT_SLAB,), 0.01,
                               dev, torch.bfloat16)
    slab_bytes = torch.cuda.max_memory_allocated() - base \
        - leaf.numel() * leaf.element_size()
    del leaf

    def events():
        return [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed(fn):
        start, end = events()
        torch.cuda.synchronize()
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        return res, start.elapsed_time(end)

    out = dict(slab_elements=TL.INIT_SLAB, slab_draw_bytes=slab_bytes)
    runtime.reset_launches()
    for i, (arch, c) in enumerate(LM_SSM_SERVE):
        t_model = time.perf_counter()
        walks = engine.sample_walks(wcfg)
        nodes = walks.nodes.cpu().numpy()
        lengths = walks.lengths.cpu().numpy()
        del walks
        cfg = get_config(arch)
        if c["layers"]:
            cfg = dataclasses.replace(cfg, num_layers=c["layers"])
        P, L, Bd = c["prompts"], c["prompt_len"], c["decode_batch"]
        fill, n_new = c["fill"], c["new_tokens"]
        toks, _ = walks_to_lm_batch(nodes, lengths, L, P, cfg.vocab_size,
                                    seed=500 + i)
        prompts = torch.from_numpy(toks).to(dev)
        if (Bd, fill) == (P, L):        # the cache filled by the prompts
            dprompts = prompts
        else:
            toks, _ = walks_to_lm_batch(nodes, lengths, fill, Bd,
                                        cfg.vocab_size, seed=600 + i)
            dprompts = torch.from_numpy(toks).to(dev)

        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = M.init_params(cfg, prng.PRNGKey(30 + i), dev,
                              dtype=M.compute_dtype(cfg))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() - base
        params = M.params_of(model)
        param_bytes = sum(p.numel() * p.element_size()
                          for p in params.values())
        require(init_peak <= param_bytes + slab_bytes + INIT_SLACK,
                f"lm_ssm_serve_full {arch}: init peak {init_peak} B over "
                f"{param_bytes} B of parameters + {slab_bytes} B of a slab")

        prefill = make_prefill_step(model)
        prefill(params, {"tokens": prompts[:, :8]})          # warm-up
        pre_logits, prefill_ms = timed(
            lambda: prefill(params, {"tokens": prompts}))
        moe = cfg.moe is not None
        if moe:
            with torch.no_grad():
                prefill_drop, (_, _, aux) = _drop_share(
                    model, lambda: M.forward(model, {"tokens": prompts}))

        state = M.init_decode_state(model, Bd, c["max_seq"])

        def fill_cache(state=state):
            with torch.no_grad():
                for t in range(fill):
                    lg, state = M.decode_step(model, dprompts[:, t:t + 1],
                                              state)
            return lg
        if moe:
            (decode_drop, logits), fill_ms = timed(
                lambda: _drop_share(model, fill_cache))
        else:
            logits, fill_ms = timed(fill_cache)
        serve = make_serve_step(model)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]

        def decode(tok, state):
            toks_out = []
            for _ in range(n_new):
                tok, state = serve(params, tok, state)
                toks_out.append(tok)
            return toks_out, tok, state

        (out_toks, tok, state), decode_total = timed(
            lambda: no_host_sync(decode)(tok, state))
        decode_ms = decode_total / n_new
        _, syncs, sites = count_syncs(lambda: serve(params, tok, state))
        require(syncs == 0, f"lm_ssm_serve_full {arch}: a decode step "
                            f"synced {sites}")
        prof = profile_call(lambda: serve(params, tok, state))
        gen = torch.cat(out_toks, dim=1)
        require(bool((gen >= 0).all() and (gen < cfg.vocab_size).all()),
                f"lm_ssm_serve_full {arch}: a token is out of the vocabulary")
        require(bool(torch.isfinite(pre_logits.float()).all())
                and bool(torch.isfinite(logits.float()).all()),
                f"lm_ssm_serve_full {arch}: non-finite logits")
        emb = model.embed.table
        elt = emb.element_size()
        # the embedding's rows a step gathers; a tied table is read whole
        # by the logits, an untied one's unembedding is in param_bytes
        weight_bytes = param_bytes + Bd * cfg.d_model * elt \
            - (0 if cfg.tie_embeddings else emb.numel() * elt)
        kv_bytes = sum(t.numel() * t.element_size() for st in state.caches
                       if isinstance(st, KVCache) for t in st)
        ssm_bytes = sum(t.numel() * t.element_size() for st in state.caches
                        if not isinstance(st, KVCache) for t in st)
        bound_ms = (weight_bytes + kv_bytes + 2 * ssm_bytes) \
            / HBM_BYTES_PER_S * 1e3
        kinds = {}
        for blk in tfm.blocks(model.layers):
            if blk.spec.kind in c["kernels_per_token"]:
                kinds.setdefault(blk.spec.kind, blk)
        per_token = block_kernels_per_token(kinds, P, M.compute_dtype(cfg),
                                            dev, train=False)
        row = dict(
            layers=cfg.num_layers, dtype=cfg.dtype,
            layer_kinds={k: sum(1 for sp in tfm.layer_specs(cfg)
                                if sp.kind == k)
                         for k in ("attn", "mamba", "mlstm", "slstm")},
            params=sum(p.numel() for p in params.values()),
            params_analytic=M.count_params_analytic(cfg),
            param_gib=param_bytes / 2**30, init_seconds=init_s,
            init_peak_gib=init_peak / 2**30,
            init_over_params_gib=(init_peak - param_bytes) / 2**30,
            init_allowance_gib=(param_bytes + slab_bytes + INIT_SLACK)
            / 2**30,
            prompts=P, prompt_len=L, prefill_ms=prefill_ms,
            prefill_tokens_per_s=P * L / (prefill_ms / 1e3),
            decode_batch=Bd, max_seq=c["max_seq"], cache_fill=fill,
            cache_fill_ms_per_step=fill_ms / fill,
            prefill_vs_decode_max_abs=float(
                (logits.float() - pre_logits.float()).abs().max())
            if dprompts is prompts else None,
            new_tokens=n_new, decode_ms_per_step=decode_ms,
            decode_tokens_per_s=Bd / (decode_ms / 1e3),
            decode_bound_ms=bound_ms, decode_bound_by="bytes",
            decode_weight_bytes=weight_bytes, decode_kv_bytes=kv_bytes,
            decode_ssm_state_bytes=ssm_bytes,
            host_syncs_per_decode_step=syncs, decode_step_profile=prof,
            kernels_per_token=per_token, final_pos=int(state.pos),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            peak_over_window_gib=(torch.cuda.max_memory_allocated() - base)
            / 2**30, window_gib=base / 2**30,
            seconds=time.perf_counter() - t_model)
        if moe:
            row.update(experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                       prefill_dropped_share=prefill_drop,
                       decode_dropped_share=decode_drop, aux_loss=float(aux))
        out[arch] = row
        del model, params, state, prefill, serve, pre_logits, logits, tok
        del out_toks, gen, prompts, dprompts
        torch.cuda.empty_cache()
    launches = dict(runtime.LAUNCHES)
    require(launches["fused_hop"] == args.length * len(LM_SSM_SERVE)
            and launches["weight_prefix"] == 0
            and launches["walk_step_tiled"] == 0,
            f"lm_ssm_serve_full: launches {launches}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    return out


def lm_ssm_cuda_equals_cpu(dev) -> dict:
    """xlstm-125m at full width on one period (4 layers, 2 × 512 tokens:
    two 256-token chunks) and jamba-v0.1-52b reduced to one period (8
    layers, d_model 1024, 4 experts, 2 × 64 tokens), float32, TF32 off,
    the same parameters on the card and the CPU: jamba's routing on the
    first forward equal but for near ties (``_routing_agreement``); one
    train step from a shared state at ``lm_cuda_equals_cpu``'s
    tolerances; 8 decode steps' logits within ``LM_EQ_LOGITS_TOL``,
    prefill vs decode on the card within ``LM_EQ_CONSISTENCY``, 4 greedy
    tokens equal; xlstm's chunkwise mLSTM against its sequential form on
    the card, read."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    e = LM_SSM_EQ
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for arch in ("xlstm-125m", "jamba-v0.1-52b"):
            t_arch = time.perf_counter()
            if arch.startswith("xlstm"):
                x = e["xlstm"]
                cfg = dataclasses.replace(get_config(arch),
                                          num_layers=x["layers"],
                                          dtype="float32")
            else:
                x = e["jamba"]
                cfg = dataclasses.replace(
                    reduced(get_config(arch), layers=x["layers"],
                            d_model=x["d_model"], vocab=x["vocab"],
                            experts=x["experts"]), dtype="float32")
            card = M.init_params(cfg, prng.PRNGKey(5), dev)
            host = M.TransformerLM(cfg, None, "cpu")
            p_card = M.params_of(card)
            p_host = {n: t.cpu() for n, t in p_card.items()}
            M.bind_params(host, p_host)
            rng = np.random.default_rng(7)
            batch = {k: torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (2, x["seq"])).astype(np.int32))
                for k in ("tokens", "labels")}
            row = dict(config=dict(layers=cfg.num_layers,
                                   d_model=cfg.d_model,
                                   vocab=cfg.vocab_size,
                                   kinds=[s.kind for s in
                                          M.tfm.layer_specs(cfg)]),
                       params=sum(v.numel() for v in p_host.values()),
                       batch=[2, x["seq"]])
            if cfg.moe is not None:
                near, differ, groups_with_near, aux = _routing_agreement(
                    card, host, cfg, batch["tokens"], dev, 1)
                aux_rel = abs(aux["card"] - aux["cpu"]) / abs(aux["cpu"])
                require(differ == 0 and aux_rel <= LM_EQ_LOSS_RTOL,
                        f"lm_ssm_cuda_equals_cpu {arch}: {differ} routing "
                        f"entries differ, aux {aux}")
                row.update(near_tie_tokens=near,
                           groups_with_near_ties=groups_with_near,
                           routing_entries_differ=0, aux_rel=aux_rel)
            gaps, unresolved, bound = _train_steps(card, host, p_host, batch,
                                                   dev, n_steps=1)
            require(_train_gaps_hold(gaps),
                    f"lm_ssm_cuda_equals_cpu {arch}: {gaps}")
            logit_gap, consist, consist_ok, greedy_equal = _decode_card_cpu(
                card, host, p_card, p_host, batch["tokens"], dev)
            require(logit_gap <= LM_EQ_LOGITS_TOL and consist_ok
                    and greedy_equal,
                    f"lm_ssm_cuda_equals_cpu {arch}: logits {logit_gap}, "
                    f"prefill/decode {consist}, greedy {greedy_equal}")
            row.update(
                steps=1, gaps={k: gaps[k] for k in TRAIN_GAP_KEYS},
                worst_leaf=gaps["worst_leaf"],
                loss_rel=gaps["loss"], grad_norm_rel=gaps["grad_norm"],
                unresolved_elements=unresolved,
                unresolved_max_of_step_bound=gaps["unresolved_max_abs"],
                step_bound=bound, decode_logits_of_max=logit_gap,
                prefill_vs_decode_max_abs=consist, greedy_equal=True)
            if cfg.ssm.chunked and "mlstm" in cfg.layer_pattern:
                seq_cfg = dataclasses.replace(
                    cfg, ssm=dataclasses.replace(cfg.ssm, chunked=False))
                seq_model = M.TransformerLM(seq_cfg, None, dev)
                M.bind_params(card, p_card)
                M.bind_params(seq_model, p_card)
                tokens = batch["tokens"].to(dev)
                with torch.no_grad():
                    lc = M.logits_from_hidden(
                        card, M.forward(card, {"tokens": tokens})[0])
                    ls = M.logits_from_hidden(
                        seq_model, M.forward(seq_model,
                                             {"tokens": tokens})[0])
                row["chunked_vs_sequential_of_max"] = float(
                    (lc - ls).abs().max() / ls.abs().max())
                del seq_model, lc, ls
            row["seconds"] = time.perf_counter() - t_arch
            out[arch] = row
            del card, host, p_card, p_host
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["tolerances"] = dict(loss_rtol=LM_EQ_LOSS_RTOL,
                             leaf_tol=LM_EQ_LEAF_TOL,
                             logits_tol=LM_EQ_LOGITS_TOL,
                             consistency=LM_EQ_CONSISTENCY,
                             unresolved=LM_EQ_UNRESOLVED,
                             near_tie=LM_MOE_NEAR_TIE)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---- the enc-dec and VLM families (cross-attention, M-RoPE) ------------

# lm_encdec_train_full: seamless-m4t-medium at full size (12 encoder and
# 12 decoder layers of 1,024, untied 256,206-row tables) trained as
# lm_ssm_train_full trains xlstm-125m, each step on 8 × 2048 walk tokens
# over 8 × ENC_FRAMES frames: 2 steps, the second traced
LM_ENCDEC_TRAIN = dict(arch="seamless-m4t-medium", batch=8, seq=2048,
                       steps=2, lr=3e-4, warmup_steps=1)
# lm_encdec_vlm_serve_full, bf16, slab-drawn: seamless at full size (a
# prefill over the encoder's memory, the decode state's memory set by
# run_encoder, the cache filled by decoding the prompts, greedy steps)
# and qwen2-vl-72b at full width on 2 of its 80 layers (a prefill of
# patches and text, the cache filled by `fill` text steps at the decode
# batch, greedy steps: a VLM decode embeds tokens only)
LM_ENCDEC_SERVE = (
    ("seamless-m4t-medium", dict(layers=None, prompts=16, prompt_len=512,
                                 patches=0, max_seq=1024, decode_batch=16,
                                 fill=512, new_tokens=32)),
    ("qwen2-vl-72b", dict(layers=2, prompts=4, prompt_len=1024,
                          patches=1024, max_seq=1024, decode_batch=64,
                          fill=16, new_tokens=32)))
# lm_encdec_vlm_cuda_equals_cpu, float32, TF32 off: both ``reduced`` to 2
# layers (seamless: 2 + 2) at d_model 1024 with a vocabulary of 8192, on
# 2 × 64 tokens; seamless over 2 × ENC_FRAMES frames, qwen2-vl after 24
# patches (not a square: the grid's rows run past its side)
LM_ENCDEC_EQ = dict(layers=2, d_model=1024, vocab=8192, seq=64, patches=24)
# the stub frontends' inputs, as tests/test_arch_smoke.py scales them
FRAME_SCALE, PATCH_SCALE = 0.1, 0.02


def modality_inputs(cfg, B: int, key, dev, n_patches: int = 0) -> dict:
    """The precomputed frontend embeddings a batch of ``cfg``'s family
    holds, float32 from ``repro_torch.random.normal`` under ``key``:
    ``frames [B, ENC_FRAMES, d]`` × 0.1 (enc_dec), ``patches [B,
    n_patches, d]`` × 0.02 (vlm); empty for the other families."""
    from repro_torch import random as prng
    from repro_torch.models import model as M
    out = {}
    if cfg.family == "enc_dec":
        out["frames"] = FRAME_SCALE * prng.normal(
            prng.fold_in(key, 0), (B, M.ENC_FRAMES, cfg.d_model), dev)
    if cfg.family == "vlm":
        out["patches"] = PATCH_SCALE * prng.normal(
            prng.fold_in(key, 1), (B, n_patches, cfg.d_model), dev)
    return out


def encdec_train_flops(cfg, B: int, S: int, S_enc: int) -> dict:
    """Model FLOPs of one train step of an enc-dec ``cfg`` by part, 3×
    the forward's (the forward and its backward; the remat recompute is
    not counted), 2 a multiply-add, from the code: the decoder's weights
    (self-attention, the cross-attention's q and o, the MLP) on its
    ``B·S`` tokens; the cross-attention's K and V projections on the
    ``B·S_enc`` frames in every decoder layer; the encoder's weights on
    the frames; the unembedding on the decoder's tokens (the embedding is
    a gather); and the attention products, which ``_chunked_attention``
    computes over every chunk, masked or not (QKᵀ and PV:
    ``4·B·Sq·Skv·H·D`` a layer)."""
    att = cfg.attention
    d, L, Le = cfg.d_model, cfg.num_layers, cfg.encoder_layers
    hd, kvd = att.n_heads * att.head_dim, att.n_kv_heads * att.head_dim
    mlp = (3 if cfg.activation in ("swiglu", "geglu") else 2) * d * cfg.d_ff
    self_attn = 2 * d * hd + 2 * d * kvd
    fwd = dict(
        decoder=2 * B * S * L * (self_attn + 2 * d * hd + mlp),
        cross_kv=2 * B * S_enc * L * 2 * d * kvd,
        encoder=2 * B * S_enc * Le * (self_attn + mlp),
        unembed=2 * B * S * cfg.vocab_size * d,
        attention=4 * B * hd * (L * S * S + L * S * S_enc
                                + Le * S_enc * S_enc))
    return {k: 3 * v for k, v in fwd.items()}


def decode_bounds(model, state, B: int) -> dict:
    """The least time one ``decode_step`` at batch ``B`` could take, from
    the code, as the larger of two. Bytes: every weight a step applies
    read once (the embedding's ``B`` rows, not its table, unless it is
    tied), each attention cache read whole (a step's scores cover every
    slot, masked or not) and the encoder memory read by every
    cross-attention layer, over the memory rate. Operations, 2 a
    multiply-add: every weight matrix on the ``B`` tokens, but the
    cross-attention's K and V projections on the memory's ``B·S_enc``
    rows in every layer (recomputed each step, as the reference does),
    the unembedding, and the attention products over the cache and the
    memory (``4·B·S·H·D`` a layer), over the bf16 peak."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.attention import KVCache
    cfg = model.cfg
    att = cfg.attention
    hd = att.n_heads * att.head_dim
    emb = model.embed.table
    elt = emb.element_size()
    # the encoder's weights are read once a prefill, not a step
    param_bytes = sum(p.numel() * p.element_size()
                      for n, p in model.named_parameters()
                      if not n.startswith("enc_"))
    weight_bytes = param_bytes + B * cfg.d_model * elt \
        - (0 if cfg.tie_embeddings else emb.numel() * elt)
    kv_bytes = sum(t.numel() * t.element_size() for c in state.caches
                   if isinstance(c, KVCache) for t in c)
    S_enc = 0 if state.enc_out is None else state.enc_out.shape[1]
    blks = tfm.blocks(model.layers)
    n_cross = sum(1 for b in blks if b.cross_attention)
    memory_bytes = 0 if state.enc_out is None else n_cross * (
        state.enc_out.numel() * state.enc_out.element_size())
    flops = 2 * B * model.out_table().numel()
    for blk, cache in zip(blks, state.caches):
        for n, p in blk.named_parameters():
            leaf = n.rsplit(".", 1)[-1]
            if p.dim() < 2 or leaf in ("bq", "bk", "bv"):
                continue                     # norms and biases
            rows = B * S_enc if n in ("cross.wk", "cross.wv") else B
            flops += 2 * rows * p.numel()
        if blk.spec.kind == "attn":
            flops += 4 * B * hd * cache.k.shape[2]
        if blk.cross_attention:
            flops += 4 * B * hd * S_enc
    bytes_ms = (weight_bytes + kv_bytes + memory_bytes) \
        / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_PEAK_FLOPS * 1e3
    return dict(bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                bytes_bound_ms=bytes_ms, flops_bound_ms=flops_ms,
                weight_bytes=weight_bytes, kv_bytes=kv_bytes,
                memory_bytes=memory_bytes, flops=flops)


def lm_encdec_train_full(engine, args, dev) -> dict:
    """seamless-m4t-medium at full size (12 encoder and 12 decoder layers
    of 1,024, cross-attention in every decoder layer, untied 256,206-row
    tables) trained as ``lm_ssm_train_full`` trains xlstm-125m: each step
    samples 2^14 walks × 80 from nodes on the main path's final window
    (fused path), packs them into 8 × 2048 tokens over 8 × ENC_FRAMES
    frames and takes one ``make_train_step`` step (float32 masters, bf16
    compute, remat per block in both stacks, AdamW lr 3e-4, warmup 1);
    the last step is traced. Per step: ms (CUDA events, packing apart;
    the traced step's by the host clock inside its trace), tokens/s,
    model FLOP/s as a share of the bf16 peak (``encdec_train_flops``),
    host syncs, loss and grad norm (required finite, the second loss
    below the first); the traced step's kernels and idle share; peak
    memory."""
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.configs.base import WalkConfig
    from repro_torch.data.walk_dataset import walks_to_lm_batch
    from repro_torch.kernels import runtime
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    c = LM_ENCDEC_TRAIN
    mcfg = get_config(c["arch"])
    t0 = time.perf_counter()
    model = M.init_params(mcfg, prng.PRNGKey(40), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_steps, B, S = c["steps"], c["batch"], c["seq"]
    opt_cfg = AdamWConfig(lr=c["lr"], warmup_steps=c["warmup_steps"],
                          total_steps=n_steps)
    step = make_train_step(model, opt_cfg)
    params = M.params_of(model)
    opt = init_opt_state(params, opt_cfg)
    frames = modality_inputs(mcfg, B, prng.PRNGKey(41), dev)["frames"]
    flops = encdec_train_flops(mcfg, B, S, frames.shape[1])
    step_flops = sum(flops.values())
    wcfg = WalkConfig(num_walks=LM_TRAIN["walks"], max_length=args.length,
                      start_mode="nodes")
    rows = []
    runtime.reset_launches()
    for s in range(n_steps):
        walks = engine.sample_walks(wcfg)
        t0 = time.perf_counter()
        nodes, lengths = walks.nodes.cpu().numpy(), walks.lengths.cpu().numpy()
        toks, labels = walks_to_lm_batch(nodes, lengths, S, B,
                                         mcfg.vocab_size, seed=700 + s)
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "labels": torch.from_numpy(labels).to(dev),
                 "frames": frames}
        pack_ms = (time.perf_counter() - t0) * 1e3
        if s == n_steps - 1:
            res = []
            step_profile = kernel_reading(*trace_kernels(
                lambda: res.append(step(params, opt, batch))))
            (params, opt, metrics), syncs, sites = res[0], None, None
            ms = step_profile["traced_wall_ms"]
        else:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            (params, opt, metrics), syncs, sites = count_syncs(
                lambda: step(params, opt, batch))
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        rows.append(dict(step=s, ms=ms, traced=syncs is None,
                         pack_ms=pack_ms, tokens_per_s=B * S / (ms / 1e3),
                         model_flops_share=step_flops / (ms / 1e3)
                         / BF16_PEAK_FLOPS,
                         host_syncs=syncs, host_sync_sites=sites,
                         loss=float(metrics["loss"]),
                         grad_norm=float(metrics["grad_norm"])))
    launches = dict(runtime.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [r["loss"] for r in rows]
    norms = [r["grad_norm"] for r in rows]
    require(all(math.isfinite(x) for x in losses + norms),
            f"lm_encdec_train_full: losses {losses}, grad norms {norms}")
    require(losses[-1] < losses[0],
            f"lm_encdec_train_full: last loss {losses[-1]} >= first "
            f"{losses[0]}")
    require(launches["fused_hop"] == args.length * n_steps
            and launches["weight_prefix"] == 0,
            f"lm_encdec_train_full: launches {launches}")
    out = dict(arch=mcfg.name, params=sum(p.numel() for p in params.values()),
               params_analytic=M.count_params_analytic(mcfg),
               layers=mcfg.num_layers, encoder_layers=mcfg.encoder_layers,
               dtype=mcfg.dtype, remat=mcfg.remat, batch=B, seq=S,
               frames=list(frames.shape), walks_per_step=LM_TRAIN["walks"],
               steps=n_steps, init_seconds=init_s, step_flops=step_flops,
               step_flops_by_part=flops, per_step=rows,
               first_loss=losses[0], last_loss=losses[-1],
               launches=launches, peak_mem_gib=peak,
               train_step_profile=step_profile,
               peak_source="989 TFLOP/s dense bf16, NVIDIA H100 SXM data "
                           "sheet, 700 W",
               phase_seconds=time.perf_counter() - t_phase)
    del model, params, opt, step, batch, frames
    torch.cuda.empty_cache()
    return out


def lm_encdec_vlm_serve_full(engine, args, dev) -> dict:
    """seamless-m4t-medium at full size and qwen2-vl-72b at full width on
    2 of its 80 layers, each drawn straight into bf16 slab by slab, each
    on one 2^14 × 80 walk batch of the main path's final window (fused
    path). seamless: a prefill of 16 × 512 tokens over 16 × ENC_FRAMES
    frames, the decode state's memory set by ``run_encoder`` on those
    frames, the cache filled by decoding the prompts, then greedy steps.
    qwen2-vl: a prefill of 4 × (1024 patches + 1024 tokens), a cache at
    batch 64 filled by 16 text steps (M-RoPE at ``(p, p, p)``), then
    greedy steps. The greedy steps run under
    ``set_sync_debug_mode("error")``, one traced. Reads init seconds and
    peak (required within the parameter bytes plus one slab's draw),
    prefill ms, the encoder's ms, decode ms a step against its bound by
    bytes and by operations (``decode_bounds``), host syncs a step
    (required 0) and the decoded tokens (required in the vocabulary)."""
    import dataclasses
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.configs.base import WalkConfig
    from repro_torch.data.walk_dataset import walks_to_lm_batch
    from repro_torch.kernels import runtime
    from repro_torch.models import layers as TL
    from repro_torch.models import model as M
    from repro_torch.train.train_loop import (make_prefill_step,
                                              make_serve_step)
    t_phase = time.perf_counter()
    wcfg = WalkConfig(num_walks=LM_TRAIN["walks"], max_length=args.length,
                      start_mode="nodes")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    leaf = TL.truncated_normal(prng.PRNGKey(0), (2 * TL.INIT_SLAB,), 0.01,
                               dev, torch.bfloat16)
    slab_bytes = torch.cuda.max_memory_allocated() - base \
        - leaf.numel() * leaf.element_size()
    del leaf

    def timed(fn):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        return res, start.elapsed_time(end)

    out = dict(slab_elements=TL.INIT_SLAB, slab_draw_bytes=slab_bytes)
    runtime.reset_launches()
    for i, (arch, c) in enumerate(LM_ENCDEC_SERVE):
        t_model = time.perf_counter()
        walks = engine.sample_walks(wcfg)
        nodes = walks.nodes.cpu().numpy()
        lengths = walks.lengths.cpu().numpy()
        del walks
        cfg = get_config(arch)
        if c["layers"]:
            cfg = dataclasses.replace(cfg, num_layers=c["layers"])
        P, L, Bd = c["prompts"], c["prompt_len"], c["decode_batch"]
        fill, n_new = c["fill"], c["new_tokens"]
        toks, _ = walks_to_lm_batch(nodes, lengths, L, P, cfg.vocab_size,
                                    seed=800 + i)
        prompts = torch.from_numpy(toks).to(dev)
        if (Bd, fill) == (P, L):        # the cache filled by the prompts
            dprompts = prompts
        else:
            toks, _ = walks_to_lm_batch(nodes, lengths, fill, Bd,
                                        cfg.vocab_size, seed=900 + i)
            dprompts = torch.from_numpy(toks).to(dev)
        extra = modality_inputs(cfg, P, prng.PRNGKey(50 + i), dev,
                                n_patches=c["patches"])

        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = M.init_params(cfg, prng.PRNGKey(60 + i), dev,
                              dtype=M.compute_dtype(cfg))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() - base
        params = M.params_of(model)
        param_bytes = sum(p.numel() * p.element_size()
                          for p in params.values())
        require(init_peak <= param_bytes + slab_bytes + INIT_SLACK,
                f"lm_encdec_vlm_serve_full {arch}: init peak {init_peak} B "
                f"over {param_bytes} B of parameters + {slab_bytes} B of a "
                "slab")

        prefill = make_prefill_step(model)
        prefill(params, {"tokens": prompts[:, :8], **extra})  # warm-up
        pre_logits, prefill_ms = timed(
            lambda: prefill(params, {"tokens": prompts, **extra}))
        state = M.init_decode_state(model, Bd, c["max_seq"])
        encoder_ms = None
        if cfg.family == "enc_dec":
            with torch.no_grad():
                (enc_out, enc_pos), encoder_ms = timed(
                    lambda: M.run_encoder(model, extra["frames"]))
            state = state._replace(enc_out=enc_out, enc_pos=enc_pos)

        def fill_cache(state=state):
            with torch.no_grad():
                for t in range(fill):
                    lg, state = M.decode_step(model, dprompts[:, t:t + 1],
                                              state)
            return lg
        logits, fill_ms = timed(fill_cache)
        serve = make_serve_step(model)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]

        def decode(tok, state):
            toks_out = []
            for _ in range(n_new):
                tok, state = serve(params, tok, state)
                toks_out.append(tok)
            return toks_out, tok, state

        (out_toks, tok, state), decode_total = timed(
            lambda: no_host_sync(decode)(tok, state))
        decode_ms = decode_total / n_new
        _, syncs, sites = count_syncs(lambda: serve(params, tok, state))
        require(syncs == 0, f"lm_encdec_vlm_serve_full {arch}: a decode "
                            f"step synced {sites}")
        prof = profile_call(lambda: serve(params, tok, state))
        gen = torch.cat(out_toks, dim=1)
        require(bool((gen >= 0).all() and (gen < cfg.vocab_size).all()),
                f"lm_encdec_vlm_serve_full {arch}: a token is out of the "
                "vocabulary")
        require(bool(torch.isfinite(pre_logits.float()).all())
                and bool(torch.isfinite(logits.float()).all()),
                f"lm_encdec_vlm_serve_full {arch}: non-finite logits")
        bounds = decode_bounds(model, state, Bd)
        row = dict(
            layers=cfg.num_layers, encoder_layers=cfg.encoder_layers
            if cfg.family == "enc_dec" else 0, dtype=cfg.dtype,
            params=sum(p.numel() for p in params.values()),
            params_analytic=M.count_params_analytic(cfg),
            param_gib=param_bytes / 2**30, init_seconds=init_s,
            init_peak_gib=init_peak / 2**30,
            init_over_params_gib=(init_peak - param_bytes) / 2**30,
            init_allowance_gib=(param_bytes + slab_bytes + INIT_SLACK)
            / 2**30,
            prompts=P, prompt_len=L, patches=c["patches"],
            frames=list(extra["frames"].shape) if "frames" in extra
            else None,
            prefill_ms=prefill_ms,
            prefill_tokens_per_s=P * (L + c["patches"]) / (prefill_ms / 1e3),
            encoder_ms=encoder_ms,
            decode_batch=Bd, max_seq=c["max_seq"], cache_fill=fill,
            cache_fill_ms_per_step=fill_ms / fill,
            prefill_vs_decode_max_abs=float(
                (logits.float() - pre_logits.float()).abs().max())
            if dprompts is prompts else None,
            new_tokens=n_new, decode_ms_per_step=decode_ms,
            decode_tokens_per_s=Bd / (decode_ms / 1e3),
            decode_of_bound=decode_ms / bounds["bound_ms"],
            decode_bounds=bounds,
            host_syncs_per_decode_step=syncs, decode_step_profile=prof,
            final_pos=int(state.pos),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            peak_over_window_gib=(torch.cuda.max_memory_allocated() - base)
            / 2**30, window_gib=base / 2**30,
            seconds=time.perf_counter() - t_model)
        out[arch] = row
        del model, params, state, prefill, serve, pre_logits, logits, tok
        del out_toks, gen, prompts, dprompts, extra
        torch.cuda.empty_cache()
    launches = dict(runtime.LAUNCHES)
    require(launches["fused_hop"] == args.length * len(LM_ENCDEC_SERVE)
            and launches["weight_prefix"] == 0
            and launches["walk_step_tiled"] == 0,
            f"lm_encdec_vlm_serve_full: launches {launches}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    return out


def lm_encdec_vlm_cuda_equals_cpu(dev) -> dict:
    """seamless-m4t-medium and qwen2-vl-72b ``reduced`` to 2 layers
    (seamless: 2 encoder and 2 decoder layers) at d_model 1024 with a
    vocabulary of 8192, float32, TF32 off, the same parameters on the
    card and the CPU, on 2 × 64 tokens (seamless over 2 × ENC_FRAMES
    frames, qwen2-vl after 24 patches): one train step from a shared
    state at ``lm_cuda_equals_cpu``'s tolerances; 8 decode steps'
    logits within ``LM_EQ_LOGITS_TOL``, prefill vs decode on the card
    within ``LM_EQ_CONSISTENCY`` (seamless with its encoder memory,
    qwen2-vl with 0 patches, as tests/test_arch_smoke.py), 4 greedy
    tokens equal."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import random as prng
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    e = LM_ENCDEC_EQ
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for i, arch in enumerate(("seamless-m4t-medium", "qwen2-vl-72b")):
            t_arch = time.perf_counter()
            cfg = dataclasses.replace(
                reduced(get_config(arch), layers=e["layers"],
                        d_model=e["d_model"], vocab=e["vocab"]),
                dtype="float32")
            card = M.init_params(cfg, prng.PRNGKey(70 + i), dev)
            host = M.TransformerLM(cfg, None, "cpu")
            p_card = M.params_of(card)
            p_host = {n: t.cpu() for n, t in p_card.items()}
            M.bind_params(host, p_host)
            rng = np.random.default_rng(9)
            batch = {k: torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (2, e["seq"])).astype(np.int32))
                for k in ("tokens", "labels")}
            batch.update(modality_inputs(cfg, 2, prng.PRNGKey(80 + i),
                                         "cpu", n_patches=e["patches"]))
            gaps, unresolved, bound = _train_steps(card, host, p_host, batch,
                                                   dev, n_steps=1)
            require(_train_gaps_hold(gaps),
                    f"lm_encdec_vlm_cuda_equals_cpu {arch}: {gaps}")
            logit_gap, consist, consist_ok, greedy_equal = _decode_card_cpu(
                card, host, p_card, p_host, batch["tokens"], dev,
                frames=batch.get("frames"))
            require(logit_gap <= LM_EQ_LOGITS_TOL and consist_ok
                    and greedy_equal,
                    f"lm_encdec_vlm_cuda_equals_cpu {arch}: logits "
                    f"{logit_gap}, prefill/decode {consist}, greedy "
                    f"{greedy_equal}")
            out[arch] = dict(
                config=dict(layers=cfg.num_layers,
                            encoder_layers=cfg.encoder_layers
                            if cfg.family == "enc_dec" else 0,
                            d_model=cfg.d_model, vocab=cfg.vocab_size,
                            heads=cfg.attention.n_heads,
                            head_dim=cfg.attention.head_dim,
                            rope=cfg.attention.rope),
                params=sum(v.numel() for v in p_host.values()),
                batch={k: list(v.shape) for k, v in batch.items()},
                steps=1, gaps={k: gaps[k] for k in TRAIN_GAP_KEYS},
                worst_leaf=gaps["worst_leaf"],
                loss_rel=gaps["loss"], grad_norm_rel=gaps["grad_norm"],
                unresolved_elements=unresolved,
                unresolved_max_of_step_bound=gaps["unresolved_max_abs"],
                step_bound=bound, decode_logits_of_max=logit_gap,
                prefill_vs_decode_max_abs=consist, greedy_equal=True,
                seconds=time.perf_counter() - t_arch)
            del card, host, p_card, p_host
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["tolerances"] = dict(loss_rtol=LM_EQ_LOSS_RTOL,
                             leaf_tol=LM_EQ_LEAF_TOL,
                             logits_tol=LM_EQ_LOGITS_TOL,
                             consistency=LM_EQ_CONSISTENCY,
                             unresolved=LM_EQ_UNRESOLVED)
    out["seconds"] = time.perf_counter() - t_phase
    return out


EXAMPLES = ("quickstart", "streaming_walks", "serve_walks",
            "train_embeddings", "serve_lm", "train_lm_on_walks")
EXAMPLES_LM_STEPS = 40


def load_example(name: str):
    """``tools/examples/<name>.py`` of this checkout as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "tools" / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_cuda(dev) -> dict:
    """The six entry points of ``tools/examples`` called in-process on the
    card at their reference scripts' default sizes (``train_lm_on_walks``
    at ``--steps 40`` with a temporary checkpoint directory), each on a
    line of its own with its wall seconds and its ``fused_hop`` and
    ``weight_prefix`` launches. Requires hop validity 1.0 on every walk
    the scripts validate; quickstart's walks bitwise equal to the same
    call on the CPU; serve_walks' solo == coalesced (the script's own
    check), and the 4-shard tickets == the single-device solo runs with
    0 walk and 0 ingest drops; train_embeddings' final AUC above 0.5; finite LM
    losses, the last below the first; no host sync in serve_lm's decode
    loop (``set_sync_debug_mode("error")``); ``weight_prefix`` launched
    by every entry point that builds an index."""
    import io
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.kernels import runtime
    t_phase = time.perf_counter()
    mods = {name: load_example(name) for name in EXAMPLES}
    reports = []                 # (hop valid fraction, hops) of each check

    def validated(mod):
        validate = mod.validate_walks

        def run(index, walks):
            rep = validate(index, walks)
            reports.append((float(rep.hop_valid_frac), int(rep.num_hops)))
            return rep
        mod.validate_walks = run

    for name in ("quickstart", "streaming_walks"):
        validated(mods[name])
    mods["serve_lm"].decode = no_host_sync(mods["serve_lm"].decode)
    ckpt_dir = tempfile.mkdtemp(prefix="examples_lm_")
    argv = {"serve_walks": ["--shards", "4"],
            "train_lm_on_walks": ["--steps", str(EXAMPLES_LM_STEPS),
                                  "--ckpt-dir", ckpt_dir]}
    out, launches, seconds = {}, {}, {}
    try:
        for name in EXAMPLES:
            runtime.reset_launches()
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                out[name] = mods[name].main(["--device", str(dev)]
                                            + argv.get(name, []))
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            launches[name] = {k: runtime.LAUNCHES[k]
                              for k in ("fused_hop", "weight_prefix")}
            emit("examples_cuda_entry", entry=name,
                 seconds=seconds[name], launches=launches[name],
                 printed_lines=len(printed.getvalue().splitlines()))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    require(all(v == 1.0 and n > 0 for v, n in reports),
            f"examples_cuda: hop validity {reports}")
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = mods["quickstart"].main(["--device", "cpu"])
    card = out["quickstart"]
    require(all(torch.equal(getattr(card, f).cpu(), getattr(cpu, f))
                for f in ("nodes", "times", "lengths")),
            "examples_cuda: quickstart's walks differ from the CPU's")
    # the script asserts solo == coalesced (the fraud tenant, before the
    # next batch is published) and sharded == solo; held again here on
    # the final window, tenant by tenant
    svc, _, tenants, _, sharded, sharded_results = out["serve_walks"]
    for q, r in zip(tenants, sharded_results):
        nodes, _, lengths = svc.run_query_solo(q)
        require(np.array_equal(nodes, r.nodes)
                and np.array_equal(lengths, r.lengths),
                f"examples_cuda: serve_walks --shards 4 != solo for {q}")
    require(len(sharded_results) == 3 and sharded.num_shards == 4
            and sharded.stats.shard_walk_drops == 0
            and sharded.stats.exchange_drops == 0,
            f"examples_cuda: serve_walks --shards 4 drops "
            f"{sharded.stats.shard_walk_drops} walk, "
            f"{sharded.stats.exchange_drops} ingest")
    emb = out["train_embeddings"]
    require(emb["final_auc"] > 0.5,
            f"examples_cuda: train_embeddings AUC {emb['final_auc']}")
    losses = out["train_lm_on_walks"]
    require(len(losses) == EXAMPLES_LM_STEPS
            and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0],
            f"examples_cuda: train_lm_on_walks losses {losses}")
    ids = out["serve_lm"]
    require(ids.shape == (4, 32), f"examples_cuda: serve_lm ids {ids.shape}")
    builds = [n for n in EXAMPLES if n != "serve_lm"]
    require(all(launches[n]["weight_prefix"] > 0 for n in builds),
            f"examples_cuda: weight_prefix launches {launches}")
    return dict(entries=list(EXAMPLES), seconds=seconds, launches=launches,
                hop_valid_frac=min(v for v, _ in reports),
                hops_checked=sum(n for _, n in reports),
                quickstart_cuda_equals_cpu=True,
                serve_walks_solo_equals_coalesced=True,
                serve_walks_sharded_equals_solo=True,
                serve_walks_sharded_drops=dict(
                    walk=sharded.stats.shard_walk_drops,
                    ingest=sharded.stats.exchange_drops),
                train_embeddings_final_auc=emb["final_auc"],
                train_lm_losses=dict(first=losses[0], last=losses[-1],
                                     steps=len(losses)),
                serve_lm_decode_host_syncs=0,
                serve_lm_first_ids=ids[0][:16].tolist(),
                phase_seconds=time.perf_counter() - t_phase)


def main(argv=None) -> int:
    args = parse_args(argv)
    t_start = time.perf_counter()
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
    from repro_torch.kernels import ops
    from repro_torch.kernels import runtime
    from repro_torch.kernels import walk_step as kw
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
    # the draws on the host, the inverse-CDF lookups and the sort by time
    # on the card: the same graph bit for bit
    g = powerlaw_temporal_graph(
        args.nodes, args.edges_per_batch * args.batches, skew=1.2,
        t_max=10_000_000, seed=0, device=dev)
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
    # weight mode: mixed codes on every lane, hub lanes included (their
    # linear pick is a count over [c, b) by the lane's own thread)
    code_mix = (torch.arange(W, device=dev) % 3).to(torch.int32)
    cmp_weight, *_ = compare_fused(
        idx, sched, s_node, s_time, code_mix, u, "weight", rng)
    cmp_grouped = dict(
        index_mixed_codes=compare_fused_grouped(
            idx, sched, s_node, s_time, code_mix, u, "index"),
        weight_exponential=compare_fused_grouped(
            idx, sched, s_node, s_time, code_exp, u, "weight"))

    # weight_prefix on the index's own exponential weights, against the
    # plain version's float64 prefix, in units of float32 roundoff of P
    nc = idx.node_capacity
    in_range = idx.ns_src < nc
    dt = (idx.ns_ts - idx.node_tref[idx.ns_src.clamp(0, nc - 1).long()]) \
        .to(torch.float32)
    wp_runs = [weight_prefix(dt, in_range) for _ in range(3)]
    wp_k = wp_runs[0]
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
    require(all(torch.equal(r.view(torch.int32), wp_k.view(torch.int32))
                for r in wp_runs[1:]),
            "weight_prefix: three calls on the same input differ")
    del wp_runs
    emit("kernels_vs_plain",
         fused_index=cmp_index, fused_weight=cmp_weight,
         fused_weight_codes="uniform/linear/exponential by lane % 3, hub "
                            "lanes included",
         fused_vs_grouped_every_lane=cmp_grouped,
         fused_tiers=split.tiers.tolist(),
         weight_prefix=dict(**wp_reading, monotone=True,
                            bitwise_equal_calls=3),
         lanes=W, tier_l_lanes=int(split.big.sum()),
         window_edges=int(idx.num_edges))

    # walk_step_hop and walk_step_tiled against their plain versions on the
    # same hop's lanes
    sched_t = SchedulerConfig(path="tiled", regroup="bucket")
    cmp_tiled, exact_tasks, tiles, (lo_t, hi_t) = compare_walk_step(
        idx, sched_t, s_node, s_time, u, rng)
    emit("walk_step_vs_plain", modes=cmp_tiled, exact_fit_tasks=exact_tasks,
         lanes=W,
         oversize_lanes=int(tiles.oversize.sum()),
         exact_fit_lanes=int((~tiles.oversize
                              & (hi_t == 2 * sched_t.tile_edges)).sum()),
         tile_walks=sched_t.tile_walks, tile_edges=sched_t.tile_edges,
         window_edges=int(idx.num_edges))

    # one fused hop alone, at the main path's shapes
    emit("fused_hop", hop=3, **fused_hop_reading(idx, sched, s_node, s_time,
                                                  code_exp, u))

    # timings at the main path's shapes (index mode, exponential bias)
    tbase = idx.node_tbase[s_node.clamp(0, nc - 1).long()]
    args_ws = tiled_args(idx, (tiles.base_blocks, lo_t, hi_t), s_node,
                         s_time, u, "index", "exponential")
    args_hop = hop_args(idx, tiles.base_blocks, tiles.a, tiles.b, s_node,
                        s_time, u, "index", "exponential")
    kw_ws = dict(mode="index", bias="exponential",
                 tile_walks=sched_t.tile_walks, tile_edges=sched_t.tile_edges)
    timed = {
        "walk_step_tiled": (lambda: kw.walk_step_hop(*args_hop, **kw_ws),
                            ("walk_step_kernel",)),
        "walk_step_tiled_tile_local": (
            lambda: kw.walk_step_tiled(*args_ws, **kw_ws),
            ("walk_step_kernel",)),
        "fused_hop": (lambda: kf.fused_walk_step(
            idx, s_node, s_time, code_exp, u, "index", sched),
            ("fused_hop_kernel",)),
        "weight_prefix": (lambda: weight_prefix(dt, in_range),
                          ("weight_prefix_lookback",)),
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
    plain_ws = cuda_ms(lambda: kw.walk_step_hop_plain(*args_hop, **kw_ws),
                       reps=3)
    w_exp = torch.where(in_range, torch.exp(dt), 0.0)
    lib_wp = cuda_ms(lambda: torch.cumsum(w_exp, 0))
    plain_grouped = cuda_ms(lambda: grouped_hop_plain(idx, s_node, s_time,
                                                      code_exp, u), reps=3)
    # s_node, time, u, code and the two node_starts rows in; four int32
    # out; one (dst, ts) row per live lane; tiers (index mode: no tbase)
    live = kf.fused_walk_step(idx, s_node, s_time, code_exp, u, "index",
                              sched).n > 0
    bound_hop = (W * (6 * 4 + 4 * 4) + int(live.sum()) * 8 + 3 * 4) \
        / HBM_BYTES_PER_S * 1e3
    bound_wp = (E * 5 + (E + 1) * 4) / HBM_BYTES_PER_S * 1e3
    n_hop = kw.walk_step_hop(*args_hop, **kw_ws)[1]
    bound_ws = walk_step_bound_ms(idx, sched_t, tiles, n_hop, "index",
                                  "exponential")
    # the tiled hop as the tiled path runs it (one launch) and as the
    # previous design ran it (tile-local kernel, then the plain-torch
    # fallback over every lane), on the same lanes, one call each
    scfg_e = SamplerConfig(bias="exponential", mode="index")
    one = ops.walk_step(idx, s_node, s_time, u, scfg_e, sched_t)
    two = two_stage_hop(idx, s_node, s_time, u, scfg_e, sched_t)
    require(all(bool((x.long() == y.long()).all()) for x, y in zip(one, two)),
            "tiled hop: one launch and two stages differ")
    emit("tiled_hop", lanes=W,
         one_launch=profile_call(
             lambda: ops.walk_step(idx, s_node, s_time, u, scfg_e, sched_t)),
         two_stage=profile_call(
             lambda: two_stage_hop(idx, s_node, s_time, u, scfg_e, sched_t)),
         oversize_lanes=int(tiles.oversize.sum()),
         live_lanes=int((n_hop > 0).sum()))
    del warm, idx, live, w_exp, dt, in_range, wp_k, wp_p, tiles, args_ws
    del lo_t, hi_t, args_hop, n_hop, one, two
    torch.cuda.empty_cache()

    # ---- phase 3: the main path at full size ------------------------------
    engine = StreamingEngine(cfg, B, probes=False)
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launches()
    (stats, walks, secs), main_syncs, main_sites = count_syncs(
        lambda: engine.replay_device(batches, wcfg, return_walks=True))
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
         host_syncs=main_syncs, host_sync_sites=main_sites, probes=False,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, cuts=cuts)
    require(rep.num_hops > 0 and rep.hop_valid_frac == 1.0,
            f"hop validity {rep.hop_valid_frac} over {rep.num_hops} hops")
    require(evicted > 0, "the window evicted no edge")
    hops_per_batch = args.length
    require(launches["fused_hop"] == hops_per_batch * K,
            f"fused_hop launches {launches['fused_hop']} != hops x batches")
    require(launches["weight_prefix"] == 2 * K,
            f"weight_prefix launches {launches['weight_prefix']} != 2 x K")
    emit("main_path_profile", **profile_batch(engine, batches[-1], wcfg))
    del engine
    torch.cuda.empty_cache()
    emit("main_path_probed", **probed_replay(cfg, batches, wcfg, walks,
                                             main_syncs, args))
    del walks
    torch.cuda.empty_cache()

    # ---- phase 3b: alias tables at full size (grouped path) ---------------
    from repro_torch.core.alias import build_tables
    from repro_torch.core.window import ingest as window_ingest
    cfg_tab = EngineConfig(window=cfg.window,
                           sampler=SamplerConfig(mode="index", bias="table"),
                           scheduler=SchedulerConfig(path="grouped",
                                                     regroup="bucket"))
    engine = StreamingEngine(cfg_tab, B)
    spec = engine._table
    # the stream's first TABLE_BATCHES batches: the window fills after
    # 12, so the last ones evict and their tables are maintained
    K_tab = min(TABLE_BATCHES, K)
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launches()
    (stats, walks, secs), tab_syncs, tab_sites = count_syncs(
        lambda: engine.replay_device(batches[:K_tab], wcfg,
                                     return_walks=True))
    launches_tab = dict(runtime.LAUNCHES)
    hops_done = float(np.sum(args.walks * (stats.mean_len.astype(np.float64)
                                           - 1.0)))
    rep = validate_walks(engine.state.index, WalkResult(
        *(torch.as_tensor(x, device=dev)
          for x in (walks.nodes, walks.times, walks.lengths))))
    del walks
    require(rep.num_hops > 0 and rep.hop_valid_frac == 1.0,
            f"table path: hop validity {rep.hop_valid_frac}")
    require(launches_tab["weight_prefix"] == 2 * K_tab
            and launches_tab["fused_hop"] == 0
            and launches_tab["walk_step_tiled"] == 0,
            f"table path: launches {launches_tab}")
    # the table build reads one count per ingest
    require(tab_syncs == main_syncs + K_tab,
            f"table path: {tab_syncs} host syncs ({tab_sites}) against the "
            f"main path's {main_syncs} + one per batch")
    tables = engine.state.tables
    scratch = build_tables(engine.state.index, spec)
    require(all(torch.equal(getattr(tables, f), getattr(scratch, f))
                for f in ("thresh", "partner", "ptab")),
            "table path: incremental tables differ from build_tables")
    del scratch
    masses = check_row_masses(engine.state.index, tables, spec)
    rebuilt = int(tables.rebuilt)
    state_before = engine.state
    emit("table_path", seconds=secs, batches=K_tab,
         walks_per_batch=args.walks,
         max_length=args.length, path="grouped",
         weight="exponential", radix=spec.radix, degree_cap=spec.degree_cap,
         edges_per_s=int(stats.ingested[-1]) / secs,
         walks_per_s=K_tab * args.walks / secs, hops_per_s=hops_done / secs,
         hop_valid_frac=rep.hop_valid_frac, num_hops_checked=rep.num_hops,
         host_syncs=tab_syncs, host_sync_sites=tab_sites,
         launches=launches_tab,
         rebuilt_nodes_total=rebuilt,
         rebuilt_nodes_per_batch=rebuilt / K_tab,
         incremental_equals_build=True, row_masses=masses,
         mean_len=stats.mean_len.tolist(),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, cuts=cuts)
    emit("table_path_ingest", **ingest_readings(
        state_before, batches[min(K_tab, K - 1)], args.nodes, spec))
    del state_before

    # ---- phase 3c: node2vec at full width on the table path's window ------
    emit("node2vec_path", **node2vec_path(engine.state.index, tables, wcfg))
    del engine, tables
    torch.cuda.empty_cache()

    # ---- phase 4: the tiled path at full size -----------------------------
    cfg_t = EngineConfig(window=cfg.window, sampler=scfg, scheduler=sched_t)
    engine = StreamingEngine(cfg_t, B)
    runtime.reset_launches()
    stats, walks, secs = engine.replay_device(batches, wcfg,
                                              return_walks=True)
    launches_t = dict(runtime.LAUNCHES)
    hops_done = float(np.sum(args.walks * (stats.mean_len.astype(np.float64)
                                           - 1.0)))
    rep = validate_walks(engine.state.index, WalkResult(
        *(torch.as_tensor(x, device=dev)
          for x in (walks.nodes, walks.times, walks.lengths))))
    del walks
    profile_t = profile_batch(engine, batches[-1], wcfg)
    index_t = engine.state.index
    emit("tiled_path", seconds=secs, batches=K, walks_per_batch=args.walks,
         max_length=args.length,
         edges_per_s=int(stats.ingested[-1]) / secs,
         walks_per_s=K * args.walks / secs, hops_per_s=hops_done / secs,
         hop_valid_frac=rep.hop_valid_frac,
         walk_valid_frac=rep.walk_valid_frac, num_hops_checked=rep.num_hops,
         mean_len=stats.mean_len.tolist(), launches=launches_t, cuts=cuts)
    emit("tiled_path_profile", **profile_t)
    require(rep.num_hops > 0 and rep.hop_valid_frac == 1.0,
            f"tiled path: hop validity {rep.hop_valid_frac}")
    require(launches_t["walk_step_tiled"] == hops_per_batch * K,
            f"walk_step_tiled launches {launches_t['walk_step_tiled']} != "
            "hops x batches")
    require(launches_t["weight_prefix"] == 2 * K,
            f"weight_prefix launches {launches_t['weight_prefix']} != 2 x K")
    require(launches_t["fused_hop"] == 0,
            f"the tiled path launched the fused hop: {launches_t}")

    # ---- phase 5: every layout, one key, full width -----------------------
    agree, shares, tier_stats = paths_agree(index_t, wcfg)
    emit("tiled_path_oversize", path="tiled-bucket",
         oversize_share=shares)
    emit("paths_agree", **agree)
    emit("dispatch_stats", path="grouped-bucket", **tier_shares(tier_stats))
    del engine, index_t, tier_stats
    torch.cuda.empty_cache()

    # ---- phase 6: weight mode, linear and exponential, reduced window -----
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
        require(all(got_launches[k] > 0 for k in
                    ("fused_hop", "weight_prefix")),
                f"weight/{bias}: a kernel was not launched: {got_launches}")
        weight_runs[bias] = dict(seconds=sec, hop_valid_frac=r.hop_valid_frac,
                                 num_hops=r.num_hops, launches=got_launches)
    emit("weight_mode", runs=weight_runs,
         cuts=dict(nodes=wn, edges_per_batch=wb, batches=wK,
                   edge_capacity=1 << 20, walks=weight_walks))

    # small replay: the card's kernel paths equal the CPU plain versions
    # byte for byte in index mode (no float prefix is read there)
    sg = powerlaw_temporal_graph(512, 1 << 15, skew=1.2, t_max=100_000,
                                 seed=2)
    sb = list(chronological_batches(sg, 4))
    wcfg_s = WalkConfig(num_walks=1024, max_length=16)
    for path in ("fused", "tiled"):
        cfg_s = EngineConfig(
            window=WindowConfig(duration=50_000.0, edge_capacity=1 << 14,
                                node_capacity=512),
            sampler=SamplerConfig(bias="exponential", mode="index"),
            scheduler=SchedulerConfig(path=path, tile_walks=64,
                                      tile_edges=256))
        res = {}
        for d in ("cuda", "cpu"):
            st, wk, _ = StreamingEngine(cfg_s, 1 << 13,
                                        device=d).replay_device(
                sb, wcfg_s, return_walks=True)
            res[d] = (st, wk)
        same = all(np.array_equal(a, b) for a, b in zip(res["cuda"][0],
                                                        res["cpu"][0])) and \
            all(np.array_equal(a, b) for a, b in zip(res["cuda"][1][:3],
                                                     res["cpu"][1][:3]))
        require(same, f"small replay ({path}): card and CPU walks differ")
    emit("small_replay_cuda_equals_cpu", ok=True, paths=["fused", "tiled"])
    emit("tables_cuda_equals_cpu", **tables_cuda_equals_cpu(dev))

    # ---- phase 7: the serving path at full size ---------------------------
    serve = serve_path(args, cfg, batches, dev)
    emit("serve_path", **serve["reading"])
    emit("serve_cuda_equals_cpu", **serve_cuda_equals_cpu(dev))
    serve_tab = serve_tables(cfg, batches, dev)
    emit("serve_tables", **serve_tab)

    # ---- phase 8: scale-out, 4 shards on one card ------------------------
    sharded = sharded_path(args, cfg, batches, dev)
    sharded_w = sharded.pop("sharded_walks")
    emit("sharded_walks", **sharded_w)
    emit("sharded_path", **sharded)
    emit("sharded_small", **sharded_small(dev))

    # ---- phase 9: sharded serving and the window checkpoints -------------
    serve_sh = serve_sharded(args, cfg, batches, dev)
    emit("serve_sharded", **serve_sh)
    emit("serve_sharded_small", **serve_sharded_small(dev))
    ckpt = window_checkpoint(dev)
    emit("window_checkpoint", **ckpt)
    torch.cuda.empty_cache()

    # ---- phase 10: the training consumer ---------------------------------
    train = train_embeddings(args, cfg, batches, g, dev)
    emit("train_embeddings", **train, cuts=cuts)
    emit("train_cuda_equals_cpu", **train_cuda_equals_cpu(dev))
    emit("optimizer_cuda_equals_cpu", **optimizer_cuda_equals_cpu(dev))

    # ---- phase 11: the walk-native LM consumer ---------------------------
    lm_train, lm_pipe, lm_walks, lm_engine = lm_train_full(args, cfg,
                                                           batches, dev)
    emit("lm_train_full", **lm_train, cuts=cuts)
    # ---- phase 15: the GPipe schedule and the dry-run against the card ---
    emit("lm_pipeline_full", **lm_pipe)
    emit("lm_serve_full", **lm_serve_full(lm_walks, dev))
    emit("lm_cuda_equals_cpu", **lm_cuda_equals_cpu(dev))

    # ---- phase 12: the MoE family (MLA, routed experts) -----------------
    lm_moe = lm_moe_serve_full(lm_engine, args, dev)
    emit("lm_moe_serve_full", **lm_moe)
    emit("lm_moe_cuda_equals_cpu", **lm_moe_cuda_equals_cpu(dev))

    # ---- phase 13: the recurrent families (mamba, mLSTM, sLSTM) ---------
    lm_ssm_train = lm_ssm_train_full(lm_engine, args, dev)
    emit("lm_ssm_train_full", **lm_ssm_train, cuts=cuts)
    lm_ssm_serve = lm_ssm_serve_full(lm_engine, args, dev)
    emit("lm_ssm_serve_full", **lm_ssm_serve)
    emit("lm_ssm_cuda_equals_cpu", **lm_ssm_cuda_equals_cpu(dev))

    # ---- phase 14: the enc-dec and VLM families (cross-attention, M-RoPE)
    lm_encdec_train = lm_encdec_train_full(lm_engine, args, dev)
    emit("lm_encdec_train_full", **lm_encdec_train, cuts=cuts)
    lm_encdec_serve = lm_encdec_vlm_serve_full(lm_engine, args, dev)
    del lm_engine
    torch.cuda.empty_cache()
    emit("lm_encdec_vlm_serve_full", **lm_encdec_serve)
    emit("lm_encdec_vlm_cuda_equals_cpu",
         **lm_encdec_vlm_cuda_equals_cpu(dev))

    # ---- phase 16: the six examples as entry points ----------------------
    examples = examples_cuda(dev)
    emit("examples_cuda", **examples)
    emit("total", seconds=time.perf_counter() - t_start, primer=PRIMER)

    # ---- kernels line, card line, contract line --------------------------
    # tiers S and L are one launch, fused_hop: one row for each TPU kernel
    fused_err = max([cmp_index["max_abs_err"], cmp_weight["max_abs_err"]]
                    + [r["max_abs_err"] for r in cmp_grouped.values()])
    fused_err = max(fused_err, serve["fused_max_abs_err"])
    kernels = [
        dict(name="fused_hop", route="cuda",
             source="src/repro_torch/csrc/fused_step.cu",
             replaces=replaces, tier=tier, launches=launches["fused_hop"],
             max_abs_err=fused_err, **times["fused_hop"], plain_ms=plain_ms,
             plain_lanes=int(lanes.numel()),
             grouped_plain_ms=plain_grouped, bound_ms=bound_hop,
             bound_by="bytes", library_ms=None,
             sharded_walks_launches=sharded_w["paths"]["fused"]["launches"][
                 "fused_hop"],
             train_embeddings_launches=train["launches"]["fused_hop"],
             lm_train_launches=lm_train["launches"]["fused_hop"],
             lm_pipeline_launches=lm_pipe["launches"]["fused_hop"],
             lm_moe_serve_launches=lm_moe["launches"]["fused_hop"],
             lm_ssm_train_launches=lm_ssm_train["launches"]["fused_hop"],
             lm_ssm_serve_launches=lm_ssm_serve["launches"]["fused_hop"],
             lm_encdec_train_launches=lm_encdec_train["launches"][
                 "fused_hop"],
             lm_encdec_vlm_serve_launches=lm_encdec_serve["launches"][
                 "fused_hop"],
             examples_launches={k: v["fused_hop"] for k, v in
                                examples["launches"].items()},
             **serve["fused_hop"])
        for tier, replaces in (("S", "src/repro/kernels/fused_step.py:406"),
                               ("L", "src/repro/kernels/fused_step.py:450"))
    ] + [
        dict(name="weight_prefix", route="cuda",
             source="src/repro_torch/csrc/weight_prefix.cu",
             replaces="src/repro/kernels/weight_prefix.py:54",
             launches=launches["weight_prefix"],
             serve_launches=serve["launches"]["weight_prefix"],
             table_path_launches=launches_tab["weight_prefix"],
             serve_tables_launches=serve_tab["launches"]["weight_prefix"],
             sharded_path_launches=sharded["weight_prefix_launches"],
             reshard_launches=sharded["rebalance"]["launches"][
                 "weight_prefix"],
             serve_sharded_launches=serve_sh["launches"]["weight_prefix"],
             train_embeddings_launches=train["launches"]["weight_prefix"],
             lm_train_launches=lm_train["launches"]["weight_prefix"],
             lm_moe_serve_launches=lm_moe["launches"]["weight_prefix"],
             lm_ssm_train_launches=lm_ssm_train["launches"]["weight_prefix"],
             lm_ssm_serve_launches=lm_ssm_serve["launches"][
                 "weight_prefix"],
             lm_encdec_train_launches=lm_encdec_train["launches"][
                 "weight_prefix"],
             lm_encdec_vlm_serve_launches=lm_encdec_serve["launches"][
                 "weight_prefix"],
             examples_launches={k: v["weight_prefix"] for k, v in
                                examples["launches"].items()},
             checkpoint_restore_launches=[
                 r["restore_launches"]["weight_prefix"]
                 for r in ckpt["runs"]],
             max_abs_err=wp_max_err,
             **times["weight_prefix"], plain_ms=plain_wp, bound_ms=bound_wp,
             bound_by="bytes", library_ms=lib_wp),
        dict(name="walk_step_tiled", route="cuda",
             source="src/repro_torch/csrc/walk_step.cu",
             replaces="src/repro/kernels/walk_step.py:175",
             launches=launches_t["walk_step_tiled"],
             max_abs_err=max(r["max_abs_err"] for r in cmp_tiled.values()),
             **times["walk_step_tiled"], plain_ms=plain_ws, plain_lanes=W,
             bound_ms=bound_ws, bound_by="bytes", library_ms=None,
             sharded_walks_launches=sharded_w["paths"]["tiled"]["launches"][
                 "walk_step_tiled"],
             timed="walk_step_hop, index/exponential, every lane",
             tile_local_ms=times["walk_step_tiled_tile_local"]["ms"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
