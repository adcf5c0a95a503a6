"""The port's alias tables (core/alias.py) against the JAX reference's.

* Rows: ``quantize_row``/``vose_row``/``row_masses`` byte-equal to the
  reference's on seeded integer-weight rows, for every ``deg`` in 1..64;
  on exponential rows fed the reference's own weights, equal on every row
  whose float32 total is the same in both packages (the rest are counted
  and stated); exact-enumeration laws as tests/test_alias.py checks them.
* Windows: over a seeded stream with eviction and overflow, uniform and
  linear tables after every ingest byte-equal to the reference's
  (``thresh``, ``partner``, ``ptab``, ``rebuilt``), with timestamps small
  enough that every sum is exact; incremental == scratch in the port for
  all three weights.
* Draws: ``alias_pick`` per-u equal to the reference's on the reference's
  own window and tables (``interop.window_from_ref``), tabled and
  fallback lanes; table-biased walks byte-equal on fullwalk and grouped.
* The fixed-order ``ptab`` scan: monotone, exact on integer weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core import alias as ja
from repro.core.edge_store import make_batch as j_make_batch
from repro.core.walk_engine import generate_walks as j_generate_walks
from repro.core.window import ingest_nodonate as j_ingest
from repro.core.window import init_window as j_init_window
from repro.data.synthetic import chronological_batches, powerlaw_temporal_graph
from repro_torch import interop
from repro_torch.configs import base as tcfg
from repro_torch.core import alias as ta
from repro_torch.core.edge_store import make_batch
from repro_torch.core.walk_engine import generate_walks
from repro_torch.core.window import ingest, init_window

R, M = 64, 4096
SMALL_M, SMALL_R = 64, 8
WEIGHTS = ("uniform", "linear", "exponential")
FIELDS = ("thresh", "partner", "ptab", "rebuilt")


def _j_row_impl(w, deg, radix):
    """The reference's row build; ``total`` is its quantize_row's own
    float32 row total (the same expression, in the same program)."""
    inrow = jnp.arange(w.shape[0]) < deg
    total = jnp.sum(jnp.where(inrow, jnp.maximum(w, 0.0), 0.0))
    m = ja.quantize_row(w, deg, radix)
    th, pa = ja.vose_row(m, deg, radix)
    return m, th, pa, total


_J_ROWS = jax.jit(jax.vmap(_j_row_impl, in_axes=(0, 0, None)),
                  static_argnums=2)


def _j_rows(w, deg, radix=M):
    return tuple(np.asarray(x) for x in _J_ROWS(jnp.asarray(w),
                                                 jnp.asarray(deg), radix))


def _t_rows(w, deg, radix=M):
    m = ta.quantize_row(torch.as_tensor(w), torch.as_tensor(deg), radix)
    th, pa = ta.vose_row(m, torch.as_tensor(deg), radix)
    return m.numpy(), th.numpy(), pa.numpy()


# ---------------------------------------------------------------------------
# Rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hi", [1, 7, 1000])
def test_integer_rows_match_reference_every_degree(hi):
    """Seeded integer weights in [0, hi) (zeros included), one batch of
    rows for every deg in 1..64, plus the empty row: masses, thresholds,
    partners and recovered masses byte-equal to the reference's."""
    rng = np.random.default_rng(hi)
    deg = np.repeat(np.arange(0, R + 1), 3).astype(np.int32)
    w = rng.integers(0, hi, (deg.size, R)).astype(np.float32)
    m, th, pa = _t_rows(w, deg)
    rm = ta.row_masses(torch.as_tensor(th), torch.as_tensor(pa),
                       torch.as_tensor(deg), M).numpy()
    jm, jth, jpa, _ = _j_rows(w, deg)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(th, jth)
    np.testing.assert_array_equal(pa, jpa)
    j_rm = jax.vmap(ja.row_masses, in_axes=(0, 0, 0, None))(
        jnp.asarray(jth), jnp.asarray(jpa), jnp.asarray(deg), M)
    np.testing.assert_array_equal(rm, np.asarray(j_rm))
    np.testing.assert_array_equal(rm, jm)
    np.testing.assert_array_equal(rm.sum(1), deg * M)


def test_exponential_rows_equal_where_totals_are():
    """The reference's own exponential weights into the port's row build:
    equal wherever the two packages' float32 row totals are equal. The
    rows whose totals differ are counted: each must still be a valid
    apportionment (Σm = deg·M, masses recovered exactly)."""
    rng = np.random.default_rng(5)
    n = 400
    deg = rng.integers(1, R + 1, n).astype(np.int32)
    ts = np.sort(rng.integers(0, 104, (n, R)), axis=1).astype(np.int32)
    tref = ts[np.arange(n), deg - 1][:, None]
    w_ref = np.asarray(ja.weight_exponential(jnp.asarray(ts), None,
                                             jnp.asarray(tref)))
    w_ref = np.where(np.arange(R)[None, :] < deg[:, None], w_ref, 0.0)
    w_ref = w_ref.astype(np.float32)
    m, th, pa = _t_rows(w_ref, deg)
    tot_t = ta._row_sum(torch.as_tensor(w_ref)).numpy()
    jm, jth, jpa, tot_j = _j_rows(w_ref, deg)
    same_total = tot_t == tot_j
    equal = differ_total = 0
    for i in range(n):
        same = (np.array_equal(m[i], jm[i]) and np.array_equal(th[i], jth[i])
                and np.array_equal(pa[i], jpa[i]))
        if same_total[i]:
            assert same, f"row {i}: equal totals, different tables"
            equal += 1
        else:
            differ_total += 1
            assert m[i].sum() == deg[i] * M
            np.testing.assert_array_equal(
                ta.row_masses(torch.as_tensor(th[i]), torch.as_tensor(pa[i]),
                              int(deg[i]), M).numpy(), m[i])
    assert equal + differ_total == n and equal > n // 2
    print(f"exponential rows: {equal} of {n} have the reference's float32 "
          f"total and equal tables; {differ_total} have another total")


def _lr_masses(w, deg, radix):
    """Independent float64 largest-remainder apportionment."""
    w = np.maximum(np.asarray(w[:deg], np.float64), 0.0)
    if w.sum() <= 0:
        return np.full(deg, radix, np.int64)
    q = w / w.sum() * deg * radix
    fl = np.floor(q).astype(np.int64)
    order = np.lexsort((np.arange(deg), -(q - fl)))
    m = fl.copy()
    m[order[:deg * radix - fl.sum()]] += 1
    return m


@pytest.mark.parametrize("deg", list(range(1, SMALL_R + 1)))
def test_row_exact_enumeration(deg):
    """All deg·M quantized uniforms hit outcome i exactly mass_i times,
    and the masses are the largest-remainder apportionment."""
    rng = np.random.default_rng(deg)
    w = np.zeros(SMALL_R, np.float32)
    w[:deg] = rng.uniform(0.1, 10.0, deg).astype(np.float32)
    if deg >= 3:
        w[1] = 0.0
    m, th, pa = (x.numpy() for x in (
        ta.quantize_row(torch.as_tensor(w), torch.tensor(deg), SMALL_M),
        *ta.vose_row(ta.quantize_row(torch.as_tensor(w), torch.tensor(deg),
                                     SMALL_M), torch.tensor(deg), SMALL_M)))
    assert m[:deg].sum() == deg * SMALL_M and (m[deg:] == 0).all()
    if deg >= 3:
        assert m[1] == 0
    np.testing.assert_array_equal(m[:deg], _lr_masses(w, deg, SMALL_M))
    assert ((pa[:deg] >= 0) & (pa[:deg] < deg)).all()
    assert ((th[:deg] >= 0) & (th[:deg] <= SMALL_M)).all()
    kq = np.arange(deg * SMALL_M)
    j, r = kq // SMALL_M, kq % SMALL_M
    outcome = np.where(r < th[j], j, pa[j])
    np.testing.assert_array_equal(np.bincount(outcome, minlength=deg)[:deg],
                                  m[:deg])


def test_row_degenerates_and_spec():
    m1 = ta.quantize_row(torch.tensor([3.0, 0, 0, 0]), torch.tensor(1),
                         SMALL_M)
    assert m1.tolist() == [SMALL_M, 0, 0, 0]
    th, pa = ta.vose_row(m1, torch.tensor(1), SMALL_M)
    assert th[0] == SMALL_M and pa[0] == 0
    mz = ta.quantize_row(torch.zeros(4), torch.tensor(3), SMALL_M)
    assert mz.tolist() == [SMALL_M] * 3 + [0]
    m0 = ta.quantize_row(torch.ones(4), torch.tensor(0), SMALL_M)
    assert (m0 == 0).all()
    assert (ta.vose_row(m0, torch.tensor(0), SMALL_M)[0] == -1).all()
    for kw, match in ((dict(radix=48), "power of two"),
                      (dict(degree_cap=0), "degree_cap"),
                      (dict(radix=4096, degree_cap=1 << 13), "2\\^23"),
                      (dict(chunk=0), "chunk")):
        with pytest.raises(ValueError, match=match):
            ta.TableSpec(**kw)
    spec = ta.spec_from_sampler(tcfg.SamplerConfig(
        mode="index", bias="table", table_weight="linear"))
    assert spec.weight is ta.weight_linear and spec.radix == M
    assert ta.spec_from_sampler(tcfg.SamplerConfig(bias="table")).weight \
        is ta.weight_exponential
    assert ta.spec_from_sampler(tcfg.SamplerConfig()) is None


# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------


def _specs(weight, radix=SMALL_M, cap=SMALL_R):
    return (ja.TableSpec(weight=ja.WEIGHT_FNS[weight], radix=radix,
                         degree_cap=cap),
            ta.TableSpec(weight=ta.WEIGHT_FNS[weight], radix=radix,
                         degree_cap=cap))


def _stream(seed, n_batches=8, batch_n=48, nc=24, duration=300):
    rng = np.random.default_rng(seed)
    t = 0
    for _ in range(n_batches):
        n = int(rng.integers(1, batch_n + 1))
        src = rng.integers(0, nc, n).astype(np.int32)
        dst = rng.integers(0, nc, n).astype(np.int32)
        ts = np.sort(rng.integers(t, t + duration // 2, n)).astype(np.int32)
        t += int(rng.integers(1, duration // 2))
        yield src, dst, ts


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("weight", ["uniform", "linear"])
def test_window_tables_match_reference(weight, seed):
    """Tables after every ingest of a stream with eviction and overflow
    (capacity 64), byte-equal to the reference's; each also equal to the
    port's from-scratch build."""
    ec, nc, dur = 64, 24, 300
    jspec, tspec = _specs(weight)
    js = j_init_window(ec, nc, dur, table=jspec)
    ts = init_window(ec, nc, dur, table=tspec, device="cpu")
    for src, dst, t in _stream(seed, batch_n=60, nc=nc, duration=dur):
        js = j_ingest(js, j_make_batch(src, dst, t, capacity=ec), nc,
                      table=jspec)
        ts = ingest(ts, make_batch(src, dst, t, capacity=ec, device="cpu"),
                    nc, table=tspec)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(ts.tables, f).numpy(),
                                          np.asarray(getattr(js.tables, f)),
                                          err_msg=f)
        scratch = ta.build_tables(ts.index, tspec)
        for f in FIELDS[:3]:
            assert torch.equal(getattr(ts.tables, f), getattr(scratch, f)), f
    assert int(ts.overflow_drops) > 0 and int(ts.tables.rebuilt) > 0


@pytest.mark.parametrize("weight", WEIGHTS)
def test_incremental_equals_scratch(weight):
    """The dirty rule catches every changed node: incremental tables equal
    a from-scratch build after every advance, for all three weights, on a
    longer stream with a tight window and capacity."""
    spec = ta.TableSpec(weight=ta.WEIGHT_FNS[weight], radix=256,
                        degree_cap=32)
    ec, nc, dur = 512, 64, 800
    st = init_window(ec, nc, dur, table=spec, device="cpu")
    rebuilt = []
    # small batches between large ones: their rebuilds run narrower Vose
    # passes than a from-scratch build
    for i, (src, dst, t) in enumerate(_stream(7, n_batches=12, batch_n=300,
                                              nc=nc, duration=dur)):
        if i % 2:
            src, dst, t = src[:3], dst[:3], t[:3]
        st = ingest(st, make_batch(src, dst, t, capacity=512, device="cpu"),
                    nc, table=spec)
        scratch = ta.build_tables(st.index, spec)
        for f in FIELDS[:3]:
            assert torch.equal(getattr(st.tables, f), getattr(scratch, f)), f
        rebuilt.append(int(st.tables.rebuilt))
    assert rebuilt == sorted(rebuilt) and rebuilt[-1] > rebuilt[0] > 0


def test_rebuild_passes_give_the_same_bytes(monkeypatch):
    """Rows are independent: a rebuild in passes of 5 rows equals one
    pass over the whole node range."""
    spec = ta.TableSpec(weight=ta.weight_exponential, radix=SMALL_M,
                        degree_cap=SMALL_R)
    st = init_window(128, 24, 300, device="cpu")
    for src, dst, t in _stream(3, nc=24):
        st = ingest(st, make_batch(src, dst, t, capacity=128, device="cpu"),
                    24)
    whole = ta.build_tables(st.index, spec)
    monkeypatch.setattr(ta, "REBUILD_ROWS", 5)
    parts = ta.build_tables(st.index, spec)
    for f in FIELDS:
        assert torch.equal(getattr(whole, f), getattr(parts, f)), f


def test_fixed_prefix_scan():
    """ptab's scan: exact on integer weights (equal to an int64 cumsum),
    non-decreasing on float weights, within float32 roundoff of the
    float64 prefix, across several blocks and a ragged tail."""
    rng = np.random.default_rng(0)
    wi = rng.integers(0, 50, 1000).astype(np.float32)
    got = ta.fixed_order_prefix(torch.as_tensor(wi)).numpy()
    want = np.concatenate([[0], np.cumsum(wi.astype(np.int64))])
    np.testing.assert_array_equal(got, want.astype(np.float32))
    wf = np.exp(-rng.uniform(0, 80, 5000)).astype(np.float32)
    got = ta.fixed_order_prefix(torch.as_tensor(wf)).numpy().astype(
        np.float64)
    want = np.concatenate([[0], np.cumsum(wf.astype(np.float64))])
    assert (np.diff(got) >= 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# Draws and walks
# ---------------------------------------------------------------------------


def _ref_window(weight, cap=SMALL_R):
    """A reference window with tables over a stream of 3 batches (ts up
    to 1,000, so linear sums stay exact)."""
    jspec, tspec = _specs(weight, cap=cap)
    g = powerlaw_temporal_graph(40, 1200, seed=9, t_max=1000)
    js = j_init_window(2048, 40, 600, table=jspec)
    ts = init_window(2048, 40, 600, table=tspec, device="cpu")
    for b in chronological_batches(g, 3):
        js = j_ingest(js, j_make_batch(*b, capacity=512), 40, table=jspec)
        ts = ingest(ts, make_batch(*b, capacity=512, device="cpu"), 40,
                    table=tspec)
    return js, ts


@pytest.mark.parametrize("weight", WEIGHTS)
def test_alias_pick_matches_reference_per_u(weight):
    """``alias_pick`` on the reference's own window and tables: per-u
    equal to the reference's on tabled lanes (c == a), suffix lanes
    (c > a, the ptab fallback) and oversize regions."""
    js, _ = _ref_window(weight)
    t_state = interop.window_from_ref(js, device="cpu")
    idx = t_state.index
    rng = np.random.default_rng(1)
    W = 2048
    node = torch.as_tensor(rng.integers(0, 40, W))
    a = idx.node_starts[node].numpy()
    b = idx.node_starts[node + 1].numpy()
    cut = rng.integers(0, 4, W)
    c = np.minimum(a + cut * (rng.uniform(size=W) < 0.5), b).astype(np.int32)
    u = rng.uniform(size=W).astype(np.float32)
    live = b > c
    for cap in (SMALL_R, 3):
        want = np.asarray(ja.alias_pick(
            js.tables, jnp.asarray(a), jnp.asarray(c), jnp.asarray(b),
            jnp.asarray(u), radix=SMALL_M, degree_cap=cap))
        got = ta.alias_pick(
            t_state.tables, torch.as_tensor(a), torch.as_tensor(c),
            torch.as_tensor(b), torch.as_tensor(u), radix=SMALL_M,
            degree_cap=cap).numpy()
        np.testing.assert_array_equal(got[live], want[live])
    tabled = (c == a) & (b - a > 0) & (b - a <= SMALL_R)
    assert tabled.sum() > 100 and (live & ~tabled).sum() > 100


@pytest.mark.parametrize("path", ["fullwalk", "grouped"])
@pytest.mark.parametrize("weight", ["uniform", "linear"])
def test_table_walks_match_reference(weight, path):
    """bias="table" walks from the port's own incrementally maintained
    window equal the reference's, both regroups, both start modes."""
    js, ts = _ref_window(weight)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ts.tables, f).numpy(),
                                      np.asarray(getattr(js.tables, f)))
    scfg = dict(mode="index", bias="table", table_weight=weight,
                table_radix=SMALL_M, table_degree_cap=SMALL_R)
    for regroup in ("bucket", "lexsort"):
        for start_mode in ("nodes", "edges"):
            wc = dict(num_walks=256, max_length=6, start_mode=start_mode)
            key = jax.random.PRNGKey(7)
            ref = j_generate_walks(
                js.index, key, jcfg.WalkConfig(**wc),
                jcfg.SamplerConfig(**scfg),
                jcfg.SchedulerConfig(path=path, regroup=regroup),
                tables=js.tables)
            got = generate_walks(
                ts.index, interop.key_from_words(key), tcfg.WalkConfig(**wc),
                tcfg.SamplerConfig(**scfg),
                tcfg.SchedulerConfig(path=path, regroup=regroup),
                tables=ts.tables)
            for f in ("nodes", "times", "lengths"):
                np.testing.assert_array_equal(
                    getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                    err_msg=f"{regroup} {start_mode} {f}")
            assert int(got.lengths.max()) > 2
