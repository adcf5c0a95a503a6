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

``walk_step_hop`` is the whole hop of the tiled path over the lanes' global
regions ``[a, b)``: in-tile lanes as above, oversize lanes (regions that
leave their task's panel) through the reference's global fallback
(``temporal_cutoff``, then ``pick_in_neighborhood``), all in one launch of
the same kernel. Its plain version ``walk_step_hop_plain`` is the
reference's kernels/ops.py::walk_step body. Outputs are global.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.samplers import (BIAS_CODES, index_pick,
                                       index_uniform, weighted_pick_exp,
                                       weighted_pick_linear)
from repro_torch.core.temporal_index import ranged_search
from repro_torch.kernels import runtime
from repro_torch.kernels.fused_step import region_count

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_I, _I, _I] + [_P] * 9 + [_I] * 4 + [_P] * 4 + [_P]
_BIASES = ("uniform", "linear", "exponential")
_MAX_TILE_WALKS = 1024    # kMaxThreads in csrc/walk_step.cu


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
    if mode == "weight":
        E = ns_ts.shape[0]
        runtime.expect(pfx, "pfx", torch.float32, (E,), time.device)
        runtime.expect(pfx_shift, "pfx_shift", torch.float32, (E,),
                       time.device)
        if pfx_shift.data_ptr() != pfx.data_ptr() + 4:
            raise ValueError("pfx_shift must be pfx shifted by one row "
                             "(prefix[1:E + 1] beside prefix[:E])")
    return _launch(False, ns_ts, ns_dst, pfx, base_blocks, time, lo, hi,
                   u, tbase, mode, bias, tile_walks, tile_edges)


def walk_step_hop_plain(ns_ts, ns_dst, prefix, base_blocks, time, a, b, u,
                        tbase, *, mode: str, bias: str, tile_walks: int,
                        tile_edges: int):
    """The reference's kernels/ops.py::walk_step on arrays: the tiled hop
    (``walk_step_plain``) on in-tile lanes, the global fallback
    (``temporal_cutoff`` then ``pick_in_neighborhood``) on oversize lanes,
    merged by mask. ``prefix`` is the bias's float32[E+1] prefix (read in
    weight mode). Returns global (k, n, dst, ts) as int32; dst and ts are
    0 where n == 0."""
    _check_mode(mode, bias)
    E = ns_ts.shape[0]
    P = 2 * tile_edges
    base = (base_blocks.long() * tile_edges).repeat_interleave(tile_walks)
    lo, hi = a - base, b - base
    oversize = (lo < 0) | (hi > P)
    k_loc, n_k, _, _ = walk_step_plain(
        ns_ts, ns_dst, prefix[:E], prefix[1:E + 1], base_blocks, time,
        lo.clamp(0, P).to(torch.int32), hi.clamp(0, P).to(torch.int32), u,
        tbase, mode=mode, bias=bias, tile_walks=tile_walks,
        tile_edges=tile_edges)
    k_kernel = base + k_loc

    c = ranged_search(ns_ts, a, b, time, strict=True)
    n_fb = b - c
    if mode == "index":
        k_fb = c + index_pick(bias, u, n_fb)
    elif bias == "exponential":
        k_fb = weighted_pick_exp(prefix, c, b, u)
    elif bias == "linear":
        k_fb = weighted_pick_linear(prefix, ns_ts, tbase, c, b, u)
    else:
        k_fb = c + index_uniform(u, n_fb)
    k = torch.where(oversize, k_fb, k_kernel).to(torch.int32)
    n = torch.where(oversize, n_fb, n_k).to(torch.int32)
    has = n > 0
    kc = k.clamp(0, E - 1).long()
    return (k, n, torch.where(has, ns_dst[kc], 0),
            torch.where(has, ns_ts[kc], 0))


def walk_step_hop(ns_ts, ns_dst, prefix, base_blocks, time, a, b, u, tbase,
                  *, mode: str, bias: str, tile_walks: int, tile_edges: int):
    """The tiled path's hop over every lane, in one launch.

    ``base_blocks`` is the task table (int32[T], units of ``tile_edges``);
    ``a``/``b`` are the lanes' global regions and ``time``/``u`` their
    cutoffs and draws (int32/float32[W], W = T·tile_walks); ``prefix`` is
    the bias's float32[E+1] prefix and ``tbase`` the lanes' node t_base,
    read in weight mode and weight/linear only (else may be None). Returns
    global (k, n, dst, ts), equal to ``walk_step_hop_plain`` bit for bit."""
    if time.device.type == "cpu":
        return walk_step_hop_plain(ns_ts, ns_dst, prefix, base_blocks, time,
                                   a, b, u, tbase, mode=mode, bias=bias,
                                   tile_walks=tile_walks,
                                   tile_edges=tile_edges)
    _check_mode(mode, bias)
    if mode == "weight":
        runtime.expect(prefix, "prefix", torch.float32,
                       (ns_ts.shape[0] + 1,), time.device)
    return _launch(True, ns_ts, ns_dst, prefix, base_blocks, time, a, b, u,
                   tbase, mode, bias, tile_walks, tile_edges)


def _launch(hop: bool, ns_ts, ns_dst, prefix, base_blocks, time, x, y, u,
            tbase, mode, bias, TW, TE):
    """Check the arguments and launch csrc/walk_step.cu once. ``x``/``y``
    are tile-local (lo, hi) or, for the hop, global (a, b); ``prefix`` is
    the bias's prefix from row 0, with at least E + 1 rows."""
    weight = mode == "weight"
    linear = weight and bias == "linear"
    W, E, dev = time.shape[0], ns_ts.shape[0], time.device
    if W % TW or E % TE or E // TE < 2:
        raise ValueError(f"walks {W} / edges {E} do not tile as ({TW}, {TE})")
    if TW > _MAX_TILE_WALKS:
        raise ValueError(f"tile_walks {TW} exceeds {_MAX_TILE_WALKS} "
                         "(one thread per lane of a task)")
    for name, t in (("time", time), ("lo/a", x), ("hi/b", y)):
        runtime.expect(t, name, torch.int32, (W,), dev)
    runtime.expect(u, "u", torch.float32, (W,), dev)
    runtime.expect(base_blocks, "base_blocks", torch.int32, (W // TW,), dev)
    runtime.expect(ns_ts, "ns_ts", torch.int32, (E,), dev)
    runtime.expect(ns_dst, "ns_dst", torch.int32, (E,), dev)
    staged = [("ns_ts", ns_ts), ("ns_dst", ns_dst)]
    if weight:
        staged.append(("prefix", prefix))
    if linear:
        runtime.expect(tbase, "tbase", torch.int32, (W,), dev)
    for name, t in staged:     # the bulk copies read 16-byte aligned rows
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    out = tuple(torch.empty(W, dtype=torch.int32, device=dev)
                for _ in range(4))
    if W == 0:
        return out
    fn = runtime.kernel("repro_walk_step", _ARGS)
    p = runtime.ptr
    status = fn(int(hop), int(weight), BIAS_CODES[bias], p(base_blocks),
                p(x), p(y), p(time), p(u), p(tbase if linear else None),
                p(ns_ts), p(ns_dst), p(prefix if weight else None), W, TW,
                TE, E, *map(p, out), runtime.stream())
    runtime.check(status, "walk_step_hop" if hop else "walk_step_tiled")
    runtime.LAUNCHES["walk_step_tiled"] += 1
    return out
