"""The one-pass look-back scan of csrc/weight_prefix.cu, modelled on the CPU.

The card kernel cannot run here, so this file models its arithmetic in
numpy float32, one correctly rounded operation at a time in the kernel's
order: per tile of 16384 edges, in four passes of 4096, each of 256
threads scans 16 edges sequentially, thread totals are scanned across each
warp by shuffles (Kogge-Stone) and warp totals in warp order from the
previous pass's last value, and a running max makes the tile-local prefix
L' non-decreasing; the tile's aggregate is L'_last.
Tiles are then chained in float64 by decoupled look-back under random
schedules (publication orders, look-back depths, restarts), and the
outputs are fl32(fl64(R(b-1) + L'_j)). The model shows:

* folding forward from the nearest inclusive predecessor gives the same
  bits under every schedule: the sequential recurrence
  R(b) = fl64(R(b-1) + agg(b));
* the output is non-decreasing and within ``TOL_U`` of the float64 plain
  version ``weight_prefix_plain``, where a float32 chain is not;
* summing the aggregates in look-back order instead (the textbook
  decoupled look-back) depends on the schedule and can come out
  non-monotone, which would break tier L's binary search over ``pexp``.

Inputs are made from numpy seeds: weights spanning 2^-126..1, long zero
runs (padding past the window), and E of 0, 1, tile − 1, tile + 1 and
several tiles. No JAX is needed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.weight_prefix import (TOL_U, error_in_u,
                                               weight_prefix,
                                               weight_prefix_plain)

THREADS, ITEMS, WARP, PASSES = 256, 16, 32, 2
PASS = THREADS * ITEMS
TILE = PASS * PASSES
WARPS = THREADS // WARP
F = np.float32
D = np.float64


def tile_scan(w, running_max=True):
    """(L', agg) of every tile, as the kernel computes them: L' is
    float32[ntiles, TILE] (non-decreasing per tile), agg = L'[:, -1].
    The tile is scanned in PASSES passes; each pass starts from the
    previous pass's last value. Without ``running_max``, L (the scan
    before the max) and its last value."""
    nt = w.shape[0] // TILE
    w = w.reshape(nt, PASSES, WARPS, WARP, ITEMS)
    lane = np.arange(WARP)
    out = np.empty_like(w)
    carry = np.zeros(nt, F)
    for p in range(PASSES):
        s = np.empty_like(w[:, p])
        acc = np.zeros(w.shape[:1] + w.shape[2:4], F)
        for j in range(ITEMS):                  # per-thread sequential run
            acc = acc + w[:, p, ..., j]
            s[..., j] = acc
        x = acc.copy()                          # Kogge-Stone over the warp
        for d in (1, 2, 4, 8, 16):
            y = np.roll(x, d, axis=2)
            x = np.where(lane >= d, y + x, x).astype(F)
        t_excl = np.where(lane >= 1, np.roll(x, 1, axis=2), F(0)).astype(F)
        woff = np.zeros((nt, WARPS), F)         # warp totals in warp order
        woff[:, 0] = carry
        for i in range(1, WARPS):
            woff[:, i] = woff[:, i - 1] + x[:, i - 1, WARP - 1]
        off = woff[:, :, None] + t_excl
        r = off[..., None] + s                  # ascends within a thread
        if not running_max:
            out[:, p] = r
            carry = r[:, -1, -1, -1].copy()
            continue
        m = r[..., ITEMS - 1].copy()            # running max across lanes
        for d in (1, 2, 4, 8, 16):
            y = np.roll(m, d, axis=2)
            m = np.where(lane >= d, np.maximum(y, m), m)
        m_excl = np.where(lane >= 1, np.roll(m, 1, axis=2), carry[:, None,
                                                                  None])
        wmax = m[:, :, WARP - 1]
        w_excl = np.maximum.accumulate(
            np.concatenate([carry[:, None], wmax], axis=1), axis=1)[:, :-1]
        m_excl = np.maximum(w_excl[:, :, None], m_excl)
        out[:, p] = np.maximum(m_excl[..., None], r)
        carry = out[:, p, -1, -1, -1].copy()
    lp = out.reshape(nt, TILE)
    return lp, lp[:, -1].copy()


def chain(agg, rng=None, order=None, *, fold=True, max_depth=None):
    """Exclusive prefix R(b-1) of each tile (float64) by decoupled
    look-back.

    Tiles take steps in a random order (``rng``) or in ``order``: a tile's
    first step publishes its aggregate (tile 0 publishes its inclusive
    value at once); each later step is a look-back attempt, which fails
    (and is retried) when it meets a tile that has not published, or when
    it would buffer more than its depth limit. ``fold`` adds the buffered
    aggregates forward from the nearest inclusive predecessor; otherwise
    they are summed in look-back order and that sum is added to it."""
    nt = agg.shape[0]
    status = [None] * nt              # None, ("A", v) or ("P", v)
    excl = np.zeros(nt, D)
    done = 0
    steps = iter(order) if order is not None else None

    def attempt(b):
        buf = []
        limit = max_depth if max_depth is not None else (
            int(rng.integers(1, nt + 1)) if rng is not None else nt)
        j = b - 1
        while True:
            if j < 0:
                base = D(0)
                break
            st = status[j]
            if st is None or len(buf) >= limit:
                return False
            if st[0] == "P":
                base = st[1]
                break
            buf.append(st[1])
            j -= 1
        if fold:
            x = base
            for v in reversed(buf):
                x = x + D(v)
        else:
            acc = D(0)
            for v in buf:
                acc = acc + D(v)
            x = base + acc
        excl[b] = x
        status[b] = ("P", x + D(agg[b]))
        return True

    while done < nt:
        if steps is not None:
            b = next(steps)
        else:
            left = [i for i in range(nt) if status[i] is None
                    or status[i][0] == "A"]
            b = int(rng.choice(left))
        if status[b] is None:
            if b == 0:
                status[0] = ("P", D(agg[0]))
                done += 1
            else:
                status[b] = ("A", F(agg[b]))
        elif status[b][0] == "A" and attempt(b):
            done += 1
    return excl


def model_prefix(dt, valid, rng=None, *, fold=True, order=None):
    """P[E + 1] as the kernel would write it under one schedule."""
    E = dt.shape[0]
    nt = -(-E // TILE)
    w = np.zeros(nt * TILE, F)
    w[:E] = np.where(valid, np.exp(dt.astype(F)), F(0))
    lp, agg = tile_scan(w)
    excl = chain(agg, rng, order, fold=fold) if nt else np.zeros(0, D)
    out = (excl[:, None] + lp.astype(D)).reshape(-1)[:E].astype(F)
    return np.concatenate([np.zeros(1, F), out]), agg


def sequential(agg, f32=False):
    """excl(b) of the recurrence R(b) = fl64(R(b-1) + agg(b)), R(-1) = 0;
    with ``f32`` the float32 chain R(b) = fl32(R(b-1) + agg(b)) instead."""
    excl = np.zeros(agg.shape[0], F if f32 else D)
    r = F(0) if f32 else D(0)
    for b, a in enumerate(agg):
        excl[b] = r
        r = F(r + a) if f32 else r + D(a)
    return excl


def _inputs(E, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "span":
        # weights e^dt from ~2^-126 up to 1, a few masked out
        dt = -rng.uniform(0.0, 87.0, E).astype(F)
        valid = rng.uniform(size=E) < 0.95
    else:
        # window edges followed by a long padding run, with zero runs
        dt = -rng.exponential(3.0, E).astype(F)
        valid = np.ones(E, bool)
        valid[int(E * 0.6):] = False
        for s in rng.integers(0, max(E, 1), 4):
            valid[s:s + 3000] = False
    return dt, valid


SIZES = [0, 1, TILE - 1, TILE + 1, 24 * TILE + 123]


@pytest.mark.parametrize("kind", ["span", "zero_runs"])
@pytest.mark.parametrize("E", SIZES)
def test_lookback_is_schedule_free_monotone_and_within_tol(E, kind):
    dt, valid = _inputs(E, kind, seed=E % 97)
    outs = [model_prefix(dt, valid, np.random.default_rng(s))[0]
            for s in range(4)]
    for o in outs[1:]:
        assert np.array_equal(o.view(np.uint32), outs[0].view(np.uint32))
    out, agg = model_prefix(dt, valid, order=None,
                            rng=np.random.default_rng(99))
    nt = agg.shape[0]
    if nt:
        lp, _ = tile_scan(np.concatenate(
            [np.where(valid, np.exp(dt), F(0)).astype(F),
             np.zeros(nt * TILE - E, F)]))
        want = (sequential(agg)[:, None] + lp.astype(D)).reshape(-1)[:E]
        assert np.array_equal(out[1:], want.astype(F))
    assert out.shape == (E + 1,) and out[0] == 0.0
    assert (np.diff(out) >= 0).all()
    plain = weight_prefix_plain(torch.from_numpy(dt),
                                torch.from_numpy(valid))
    assert error_in_u(torch.from_numpy(out), plain) <= TOL_U
    # CPU tensors take the plain version, which the model is held to
    got = weight_prefix(torch.from_numpy(dt), torch.from_numpy(valid))
    assert torch.equal(got, plain)


def test_running_max_makes_the_tile_prefix_non_decreasing():
    """The warp-shuffle offsets alone can step down across a thread
    boundary (another association than the thread's own run); the running
    max lifts every such step and changes nothing else."""
    rng = np.random.default_rng(7)
    steps_down = 0
    for _ in range(20):
        w = np.exp(-rng.uniform(0, 30, TILE)).astype(F)
        w[rng.integers(0, TILE, 8)] = F(1)
        lp, agg = tile_scan(w)
        raw, _ = tile_scan(w, running_max=False)
        assert (np.diff(lp[0]) >= 0).all() and agg[0] == lp[0, -1]
        first = slice(0, PASS)    # one pass: the same L before the max
        assert np.array_equal(lp[0, first],
                              np.maximum.accumulate(raw[0, first]))
        steps_down += int((np.diff(raw[0, first]) < 0).sum())
    assert steps_down > 0


def test_deep_lookbacks_and_restarts_give_the_recurrence():
    """Look-backs that reach far (every tile publishes before any looks
    back) and attempts cut short by a depth limit of one all land on the
    sequential recurrence."""
    rng = np.random.default_rng(3)
    agg = rng.uniform(0, 1, 64).astype(F) * F(1e-3)
    agg[0] = F(1000.0)
    want = sequential(agg)
    n = agg.shape[0]
    late = list(range(n)) + list(range(n - 1, 0, -1)) * n
    assert np.array_equal(chain(agg, order=late), want)
    short = chain(agg, rng=np.random.default_rng(1), max_depth=1)
    assert np.array_equal(short, want)


def test_float32_chain_drifts_past_the_tolerance_at_full_size():
    """Chained in float32, the tile prefixes of a 2^26-edge window (4096
    tiles) drift by ~0.3·sqrt(tiles) units of float32 roundoff, past
    TOL_U (31.5u here); chained in float64 and rounded once, they stay
    within one unit (one float32 rounding)."""
    rng = np.random.default_rng(5)
    agg = (rng.uniform(0.5, 1.5, 4096) * 3000.0).astype(F)
    exact = np.cumsum(agg.astype(D))

    def err_u(r):
        return float(np.max(np.abs(r.astype(D) - exact)
                            / (exact * 2.0 ** -24)))

    r32 = sequential(agg, f32=True) + agg       # R(b), chained in float32
    r64 = sequential(agg) + agg.astype(D)       # R(b), chained in float64
    assert err_u(r32) > TOL_U
    assert err_u(r64.astype(F)) <= 1.0


def test_lookback_order_sum_is_schedule_dependent_and_can_step_down():
    """With e = 2^-52 (one float64 ulp near 1) and m = 1 + 2^-24 (the
    float32 midpoint above 1): tiles 0..27 bring R to m - 2e, tiles 28..30
    each add a = 0.6e, tile 31 looks back while 28..30 have only published
    their aggregates, and they complete afterwards. The forward fold rounds
    at every tile, R(30) = m + e, and gives tile 31 the same value; the
    look-back-order sum gives fl64(m - 2e + 1.8e) = m, which rounds to 1.0
    (a tie, to even) while tile 30's last output rounds up to 1 + 2^-23:
    the prefix steps down."""
    e = 2.0 ** -52
    m = 1.0 + 2.0 ** -24
    agg = np.asarray([1.0] + [2.0 ** -k for k in range(25, 52)]
                     + [0.6 * e] * 3 + [0.0], F)
    assert sum(D(a) for a in agg[:28]) == m - 2 * e
    order = list(range(28)) * 2 + [28, 29, 30, 31, 31, 28, 29, 30]
    fold = chain(agg, order=order, fold=True)
    lsum = chain(agg, order=order, fold=False)
    assert np.array_equal(fold, sequential(agg))
    assert fold[31] == fold[30] + D(agg[30]) == m + e
    assert lsum[31] == m < lsum[30] + D(agg[30])
    last_30 = F(lsum[30] + D(agg[30]))          # tile 30's last output
    first_31 = F(lsum[31])                       # tile 31's first (L'_0 = 0)
    assert first_31 == F(1) < last_30 == F(1 + 2.0 ** -23)
    assert F(fold[31]) == last_30
    # in the schedule where every tile completes in order, the sum agrees
    in_order = [b for b in range(32) for _ in (0, 1)]
    assert np.array_equal(chain(agg, order=in_order, fold=False), fold)
