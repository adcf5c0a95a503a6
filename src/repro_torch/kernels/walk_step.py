"""Tiled walk step (paper §2.4.3 smem panel), PyTorch port of
kernels/walk_step.py::walk_step_tiled.

One *task* is a tile of ``tile_walks`` walk lanes sorted by current node,
plus the ``2·tile_edges`` rows ``[base, base + 2·TE)`` of the node-ts view
that the task stages. Per lane, with tile-local region ``[lo, hi)``:

* the temporal cutoff ``c = lo + #{j ∈ [lo, hi) : ts[j] <= t}``;
* the pick for the one (mode, bias) of the call: the closed-form inverse
  CDF (index mode), or a count of staged prefix values below the target
  (weight mode), with the uniform fallback when the mass is not positive;
* ``k`` clipped to ``[0, 2·TE − 1]`` and the one-hot ``dst``/``ts`` gather,
  everything masked by ``n > 0``.

Outputs are tile-local ``(k, n, dst, ts)``. ``walk_step_tiled`` sends CUDA
tensors to the hand-written kernel (csrc/walk_step.cu) and CPU tensors to
``walk_step_plain``, which counts over each lane's region as the Pallas
kernel does. Both compute identical bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.samplers import BIAS_CODES, index_pick, index_uniform
from repro_torch.kernels import runtime
from repro_torch.kernels.fused_step import region_count

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_I, _I] + [_P] * 10 + [_I, _I, _I] + [_P] * 4 + [_P]
_BIASES = ("uniform", "linear", "exponential")


def _check_mode(mode: str, bias: str) -> None:
    if mode not in ("index", "weight"):
        raise ValueError(f"unknown sampler mode {mode!r}")
    if bias not in _BIASES:
        raise ValueError(f"walk_step_tiled draws {_BIASES}, got {bias!r}")


def walk_step_plain(ns_ts, ns_dst, pfx, pfx_shift, base_blocks, time, lo, hi,
                    u, tbase, *, mode: str, bias: str, tile_walks: int,
                    tile_edges: int):
    """The Pallas kernel's semantics on whole arrays, counting over each
    lane's own region. ``lo``/``hi`` must lie in ``[0, 2·tile_edges]``.
    Returns tile-local (k, n, dst, ts) as int32."""
    _check_mode(mode, bias)
    P = 2 * tile_edges
    base = (base_blocks.long() * tile_edges).repeat_interleave(tile_walks)
    ghi = base + hi
    c = lo + region_count(base + lo, ghi,
                          lambda l, p: ns_ts[p] <= time[l])
    n = hi - c
    if mode == "index":
        k = c + index_pick(bias, u, n)
    else:
        fb = c + index_uniform(u, n)
        # one-hot reads of the panel: 0 outside it (c == P, hi == 0)
        inside = c < P
        cg = torch.where(inside, base + c, 0)
        p_c = torch.where(inside, pfx[cg], 0.0)
        p_hi = torch.where(hi > 0, pfx_shift[(ghi - 1).clamp(min=0)], 0.0)
        if bias == "exponential":
            total = p_hi - p_c
            target = p_c + u * total
            k = c + region_count(base + c, ghi,
                                 lambda l, p: pfx_shift[p] < target[l])
            k = torch.where(total > 0, k, fb)
        elif bias == "linear":
            ts_c = torch.where(inside, ns_ts[cg], 0)
            delta = (ts_c - tbase).to(torch.float32)
            total = (p_hi - p_c) - (hi - c).to(torch.float32) * delta
            r = u * total
            k = c + region_count(
                base + c, ghi,
                lambda l, p: ((pfx_shift[p] - p_c[l])
                              - (p - base[l] + 1 - c[l]).to(torch.float32)
                              * delta[l]) < r[l])
            k = torch.where(total > 0, k, fb)
        else:
            k = fb
    k = k.clamp(0, P - 1)
    has = n > 0
    k = torch.where(has, k, 0).to(torch.int32)
    kg = base + k
    return (k, n.to(torch.int32), torch.where(has, ns_dst[kg], 0),
            torch.where(has, ns_ts[kg], 0))


def walk_step_tiled(ns_ts, ns_dst, pfx, pfx_shift, base_blocks, time, lo, hi,
                    u, tbase, *, mode: str, bias: str, tile_walks: int,
                    tile_edges: int):
    """The tiled hop over all tasks, in the reference's argument order.

    ``ns_ts``/``ns_dst``/``pfx``/``pfx_shift`` are length-E rows (``pfx``
    = P(j), ``pfx_shift`` = P(j+1) of the active weight bias; unread in
    index mode); ``base_blocks`` is int32[T] in units of ``tile_edges``;
    ``time``/``lo``/``hi``/``u``/``tbase`` are per lane, W = T·tile_walks,
    with ``0 <= lo <= hi <= 2·tile_edges``. Returns tile-local
    (k, n, dst, ts)."""
    if time.device.type == "cpu":
        return walk_step_plain(ns_ts, ns_dst, pfx, pfx_shift, base_blocks,
                               time, lo, hi, u, tbase, mode=mode, bias=bias,
                               tile_walks=tile_walks, tile_edges=tile_edges)
    _check_mode(mode, bias)
    weight = mode == "weight"
    W, E, dev = time.shape[0], ns_ts.shape[0], time.device
    TW, TE = tile_walks, tile_edges
    if W % TW or E % TE or E // TE < 2:
        raise ValueError(f"walks {W} / edges {E} do not tile as ({TW}, {TE})")
    for name, t in (("time", time), ("lo", lo), ("hi", hi)):
        runtime.expect(t, name, torch.int32, (W,), dev)
    runtime.expect(u, "u", torch.float32, (W,), dev)
    runtime.expect(base_blocks, "base_blocks", torch.int32, (W // TW,), dev)
    runtime.expect(ns_ts, "ns_ts", torch.int32, (E,), dev)
    runtime.expect(ns_dst, "ns_dst", torch.int32, (E,), dev)
    if weight:
        runtime.expect(tbase, "tbase", torch.int32, (W,), dev)
        runtime.expect(pfx, "pfx", torch.float32, (E,), dev)
        runtime.expect(pfx_shift, "pfx_shift", torch.float32, (E,), dev)
    out = tuple(torch.empty(W, dtype=torch.int32, device=dev)
                for _ in range(4))
    if W == 0:
        return out
    fn = runtime.kernel("repro_walk_step_tiled", _ARGS)
    p = runtime.ptr
    status = fn(int(weight), BIAS_CODES[bias], p(base_blocks), p(time),
                p(lo), p(hi), p(u), p(tbase if weight else None), p(ns_ts),
                p(ns_dst), p(pfx if weight else None),
                p(pfx_shift if weight else None), W, TW, TE, *map(p, out),
                runtime.stream())
    runtime.check(status, "walk_step_tiled")
    runtime.LAUNCHES["walk_step_tiled"] += 1
    return out
