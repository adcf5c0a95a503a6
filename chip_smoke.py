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
at full width, runs weight mode at a reduced window, serves 1,024 walk
queries through ``WalkService`` on the fused path against the main
path's window while its next batch is ingested (checked against solo
runs, the grouped path, a synchronous ring and the CPU), replays the
stream through the node-partitioned window with 4 shards on the card
(``DistributedStreamingEngine``, byte-equal to the single-device replay
across a live ``rebalance``), samples walk-axis-sharded walks on the
fused, tiled and grouped paths, holds small sharded replays, reshards
and the static walker to the CPU and to one shard, serves 256 queries
through ``WalkService(num_shards=4)`` on the main path's window while its
next batch is ingested (every ticket equal to the single-device
service's), holds small sharded services to the CPU and to single-device
solo runs, checkpoints a sharded window mid-stream and restores it at
another shard count (``StreamSupervisor``, ``restore_engine``), and
prints one JSON line per phase. The last three lines are the kernels
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


def profile_call(fn) -> dict:
    """Device kernels and device-busy ms of one call of ``fn``, after a
    warm-up call, from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(kernels=len(spans), device_ms=busy_us(spans) / 1e3)


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
    busy = busy_us(spans)
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


# the serving phase: queries in all, per wave, and compared with solo runs
SERVE_QUERIES = 1024
SERVE_WAVE = 64
SERVE_SOLO = 64
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
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if host_ops else [])) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
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
# served queries of serve_tables, compared with solo runs
SERVE_TABLE_QUERIES = 128
SERVE_TABLE_SOLO = 32
# node2vec phases: (p, q) of the config walks
N2V_PQ = (0.5, 2.0)


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
    queries = table_traffic(np.random.default_rng(6), 512, np.arange(8), 48)
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
            served, _, _ = drive_serve(svc, queries, stream[3], wave=8)
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
    from torch.profiler import ProfilerActivity, profile
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
    for name, fn in (("ingest", ingest), ("walks", lambda: walks(states))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced[name] = (time.perf_counter() - t0) * 1e3
        spans = [(e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        busy[name] = busy_us(spans) / 1e3
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
    batches 1-12, ``rebalance()``, batches 13-24, each half byte-equal to
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
        cfg_sh.shard), batches=len(batches), walks=args.walks,
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
    for h, part in (("first", batches[:half]), ("second", batches[half:])):
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
    reading["profile"] = profile_sharded_batch(sharded, batches[-1], wcfg)
    reading["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    reading["weight_prefix_launches"] = sum(
        halves[h]["launches"]["weight_prefix"] for h in halves)
    del single, sharded
    torch.cuda.empty_cache()
    return reading


def sharded_small(dev) -> dict:
    """A small window (512 nodes, 2^15 edges) on the card and on the CPU:
    D in {1, 2, 8} under range, hash and skew placement, and one
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

    cases = [(D, kind, roomy) for D in (1, 2, 8)
             for kind in ("range", "hash", "skew")] + [(4, "range", tight)]
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
# queries of serve_sharded, in waves of SERVE_SHARDED_WAVE: eight waves, the
# next batch ingested from the fifth to the seventh
SERVE_SHARDED_QUERIES = 256
SERVE_SHARDED_WAVE = 32
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
    queries = serve_traffic(np.random.default_rng(4), N, np.arange(8), n=16,
                            max_length=16)
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
        results, _, states = drive_serve(svc, queries, stream[3], wave=2)
        return svc, results, states

    # single-device solo runs at each ticket's version
    _, coalesced, states = serve(dev)
    require(len(states) == 2, f"sharded small: versions {sorted(states)}")
    solo = {v: WalkService(cfg, state=s, registry=MetricsRegistry())
            for v, s in states.items()}
    want = {t: (r.snapshot_version, solo[r.snapshot_version].run_query_solo(
        r.query)) for t, r in coalesced.items()}
    del solo, states

    cases = [(D, kind, roomy) for D in (1, 2, 8)
             for kind in ("range", "hash", "skew")] + [(4, "range", tight)]
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
                                skew=1.2, t_max=10_000_000, seed=4)
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
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launches()
    (stats, walks, secs), tab_syncs, tab_sites = count_syncs(
        lambda: engine.replay_device(batches, wcfg, return_walks=True))
    launches_tab = dict(runtime.LAUNCHES)
    hops_done = float(np.sum(args.walks * (stats.mean_len.astype(np.float64)
                                           - 1.0)))
    rep = validate_walks(engine.state.index, WalkResult(
        *(torch.as_tensor(x, device=dev)
          for x in (walks.nodes, walks.times, walks.lengths))))
    del walks
    require(rep.num_hops > 0 and rep.hop_valid_frac == 1.0,
            f"table path: hop validity {rep.hop_valid_frac}")
    require(launches_tab["weight_prefix"] == 2 * K
            and launches_tab["fused_hop"] == 0
            and launches_tab["walk_step_tiled"] == 0,
            f"table path: launches {launches_tab}")
    # the table build reads one count per ingest
    require(tab_syncs == main_syncs + K,
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
    emit("table_path", seconds=secs, batches=K, walks_per_batch=args.walks,
         max_length=args.length, path="grouped",
         weight="exponential", radix=spec.radix, degree_cap=spec.degree_cap,
         edges_per_s=int(stats.ingested[-1]) / secs,
         walks_per_s=K * args.walks / secs, hops_per_s=hops_done / secs,
         hop_valid_frac=rep.hop_valid_frac, num_hops_checked=rep.num_hops,
         host_syncs=tab_syncs, host_sync_sites=tab_sites,
         launches=launches_tab,
         rebuilt_nodes_total=rebuilt, rebuilt_nodes_per_batch=rebuilt / K,
         incremental_equals_build=True, row_masses=masses,
         mean_len=stats.mean_len.tolist(),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, cuts=cuts)
    emit("table_path_ingest", **ingest_readings(
        state_before, batches[-1], args.nodes, spec))
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
    emit("total", seconds=time.perf_counter() - t_start)

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
                 "fused_hop"], **serve["fused_hop"])
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
