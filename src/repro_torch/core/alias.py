"""Alias/radix bias factorization with incremental maintenance (DESIGN.md
§17), PyTorch port of core/alias.py.

Per-node **alias tables** over the window's node-ts regions: a region's
weights are quantized (largest remainder) into integer masses summing
``deg · M`` (M = ``TableSpec.radix``), a two-stack Vose construction
turns them into (threshold, partner) bucket pairs, and a draw is O(1):
one uniform → bucket ``j = ⌊u·deg·M⌋ div M`` → coin ``r = ⌊u·deg·M⌋ mod
M`` → ``j`` if ``r < thresh[j]`` else ``partner[j]``.

Three flat arrays ride in the window state beside pexp/plin:

* ``thresh``  int32[E]: per ns-view position, the bucket threshold in
  [0, M]; ``-1`` where no table exists (padding, regions larger than
  ``degree_cap``);
* ``partner`` int32[E]: the alias partner as a region-local offset, so a
  node whose region only shifted copies its old bytes;
* ``ptab``    float32[E+1]: exclusive prefix of the raw weights in ns-view
  order, the exact fallback for draws the table cannot serve (temporal
  suffixes Γ_t(v) ⊊ [a, b) and oversize regions).

**Incremental maintenance**: an ingest dirties exactly the nodes whose
region content changed (core/window.py::_dirty_nodes); clean nodes copy
their old table content positionally through the old→new ``node_starts``
offset, dirty ones are rebuilt. A from-scratch build is the same code
with every node dirty.

**The rebuild is one vectorised batch of rows.** Rows are independent, so
the dirty nodes whose regions fit the table are compacted to the front
of the node range and rebuilt up to ``REBUILD_ROWS`` rows at a time,
every row of a pass through the same quantization and the same Vose
steps at once. A build reads one pair back from the device — how many
rows to rebuild and their largest degree — and sizes its passes and the
Vose width and step count to it (a row of degree d needs d − 1 steps and
no slot past d, so a wider row gives the same bytes). That is the
build's one host sync. Quantization always runs over ``degree_cap``
slots, so a row's total is summed the same way in every batch. The Vose steps write no table element: each step
logs its (small, large, mass) triple and one scatter after the last step
writes them.

**Arithmetic.** The reference sums each row with ``jnp.sum`` and takes
``ptab`` from ``jnp.cumsum``, in orders XLA chooses. The port fixes its
own: a row total is a pairwise tree of elementwise adds over the slots,
``ptab`` a blocked scan of elementwise adds made monotone by a running
max, and the exponential weight ``exp`` taken in float64 and rounded once.
So the card's tables equal the CPU's bit for bit, for every weight. With
integer weights (uniform, linear) whose row totals and prefix stay below
2^24 every sum is exact, so the tables are also byte-equal to the
reference's; exponential tables are equal wherever a row's float32 total
is (``tests/test_torch_alias.py`` counts the rows where it is not).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.samplers import _shifted_lower_bound, index_uniform
from repro_torch.core.temporal_index import TemporalIndex

DEFAULT_RADIX = 4096        # M: coin resolution per bucket (2^12)
DEFAULT_DEGREE_CAP = 64     # R: largest region served by the O(1) path
DEFAULT_CHUNK = 128         # the reference's rows per rebuild iteration
# most rows of one vectorised rebuild pass: the pass holds a few int32
# and int64 [rows, degree_cap] temporaries (~2.5 GiB at 2^20 × 64)
REBUILD_ROWS = 1 << 20
_SCAN_BLOCK = 64            # elements summed in order inside a ptab block


# ---------------------------------------------------------------------------
# Spec + state
# ---------------------------------------------------------------------------


def weight_uniform(ts, tbase, tref):
    """w ≡ 1 — table-bias reproduction of the uniform sampler."""
    return torch.ones_like(ts, dtype=torch.float32)


def weight_linear(ts, tbase, tref):
    """w = ts − t_base(v) + 1 — the weight-mode linear element weights."""
    return (ts - tbase + 1).to(torch.float32)


def weight_exponential(ts, tbase, tref):
    """w = exp(ts − t_ref(v)): the float32 argument's exp in float64,
    rounded once to float32."""
    return torch.exp((ts - tref).to(torch.float32).to(torch.float64)).to(
        torch.float32)


WEIGHT_FNS = {
    "uniform": weight_uniform,
    "linear": weight_linear,
    "exponential": weight_exponential,
}


@dataclass(frozen=True)
class TableSpec:
    """Static alias-table parameters (hashable).

    ``weight(ts, tbase, tref) -> float32`` is the user bias over int32
    tensors: elementwise and node-local (it may read only the edge's
    timestamp and its source node's min/max timestamp), which is what
    makes the clean-node copy sound. Negative outputs are clamped to 0.
    ``chunk`` is the reference's rows per rebuild iteration, kept for
    parity; the port rebuilds ``REBUILD_ROWS`` rows per pass, which gives
    the same bytes.
    """

    weight: Callable = weight_exponential
    radix: int = DEFAULT_RADIX
    degree_cap: int = DEFAULT_DEGREE_CAP
    chunk: int = DEFAULT_CHUNK

    def __post_init__(self):
        if self.radix < 2 or self.radix & (self.radix - 1):
            raise ValueError(f"radix must be a power of two >= 2, got "
                             f"{self.radix}")
        if self.degree_cap < 1:
            raise ValueError("degree_cap must be >= 1")
        if self.degree_cap * self.radix > 1 << 23:
            # deg·M must stay exactly representable in float32
            raise ValueError("degree_cap * radix must be <= 2^23")
        if self.chunk < 1:
            raise ValueError("chunk must be >= 1")


class AliasTables(NamedTuple):
    """Per-node alias tables over the ns-view regions (see module doc)."""

    thresh: torch.Tensor    # int32[E]   bucket threshold in [0, M]; -1 = none
    partner: torch.Tensor   # int32[E]   region-local alias partner offset
    ptab: torch.Tensor      # float32[E+1] exclusive raw-weight prefix
    rebuilt: torch.Tensor   # int32[]    cumulative node rebuilds


def spec_from_sampler(scfg) -> Optional[TableSpec]:
    """The TableSpec a SamplerConfig implies, or None when tables are off."""
    if scfg.bias != "table" and scfg.table_weight is None:
        return None
    weight = scfg.table_weight
    if weight is None:
        weight = weight_exponential
    elif isinstance(weight, str):
        weight = WEIGHT_FNS[weight]
    return TableSpec(weight=weight, radix=scfg.table_radix,
                     degree_cap=scfg.table_degree_cap)


# ---------------------------------------------------------------------------
# Row-level construction, over a [rows, R] batch
# ---------------------------------------------------------------------------


def _inrow(R: int, deg: torch.Tensor) -> torch.Tensor:
    return torch.arange(R, dtype=torch.int32, device=deg.device) \
        < deg[..., None]


def _row_sum(w: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis as a pairwise tree of elementwise float32
    adds (padded with zeros to a power of two): the same bits on every
    device."""
    R = w.shape[-1]
    width = 1 << max(R - 1, 0).bit_length()
    if width != R:
        w = torch.nn.functional.pad(w, (0, width - R))
    while w.shape[-1] > 1:
        h = w.shape[-1] // 2
        w = w[..., :h] + w[..., h:]
    return w[..., 0]


def _inverse(order: torch.Tensor) -> torch.Tensor:
    """The inverse of a permutation along the last axis (what an argsort of
    the permutation gives)."""
    inv = torch.empty_like(order)
    idx = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    return inv.scatter_(-1, order, idx.contiguous())


def quantize_row(w: torch.Tensor, deg: torch.Tensor,
                 radix: int) -> torch.Tensor:
    """Integer masses m[..., R] with Σm = deg·M exactly, m_i ∝ w_i, for a
    row or a batch of rows (``deg`` of the batch's shape).

    Largest-remainder apportionment with index tie-break; zero weights get
    zero mass; an all-zero row falls back to uniform masses (M each);
    ``deg == 0`` yields the all-zero row. The reference's expression
    order, with the row total as ``_row_sum``.
    """
    R = w.shape[-1]
    M = radix
    deg = deg.to(torch.int32)
    inrow = _inrow(R, deg)
    w = torch.where(inrow, w.to(torch.float32).clamp(min=0.0), 0.0)
    total_w = _row_sum(w)[..., None]
    target = (deg * M)[..., None]
    targetf = target.to(torch.float32)
    q = torch.where(total_w > 0, w * (targetf / total_w.clamp(min=1e-30)),
                    0.0)
    fl = torch.minimum(torch.floor(q).to(torch.int32), target)
    frac = q - fl.to(torch.float32)
    d = target - fl.sum(-1, keepdim=True, dtype=torch.int32)

    # d > 0: +1 to the d largest remainders (stable sort => index ties)
    pos_frac = frac > 0
    order = torch.sort(torch.where(inrow & pos_frac, -frac, 2.0), dim=-1,
                       stable=True).indices
    add = (_inverse(order) < d) & pos_frac
    # d < 0 (float-rounding edge): -1 from the |d| smallest remainders
    # among positions that have a unit to give
    has_unit = fl >= 1
    order = torch.sort(torch.where(inrow & has_unit, frac, 2.0), dim=-1,
                       stable=True).indices
    sub = (_inverse(order) < -d) & has_unit

    m = fl + add.to(torch.int32) - sub.to(torch.int32)
    # fold any residual into the heaviest slot (the first maximum)
    resid = target - m.sum(-1, keepdim=True, dtype=torch.int32)
    m = m.scatter_add(-1, m.argmax(-1, keepdim=True), resid)

    uniform = torch.where(inrow, M, 0).to(torch.int32)
    m = torch.where(total_w > 0, m, uniform)
    return torch.where(inrow, m, 0)


def vose_row(masses: torch.Tensor, deg: torch.Tensor, radix: int):
    """Two-stack Vose construction over a row or a batch of rows.

    ``masses`` int32[..., R] with Σ = deg·M (``quantize_row``). Returns
    (thresh, partner): bucket i resolves to i when the coin ``r <
    thresh[i]`` and to ``partner[i]`` otherwise; -1 / 0 beyond ``deg``.

    The reference's scan, step for step: each step pops one small (m < M)
    and one large (m ≥ M) bucket, finalizes the small one at its current
    mass and takes the shortfall from the large one. Its stacks reduce to
    pointers: the large stack only ever pops its top (when that bucket
    turns small), and a bucket pushed onto the small stack is its top and
    is popped by the very next step, so the small stack is a prefix of its
    initial list plus at most one carried bucket. Each step logs its
    (small, large, mass); one scatter after the last step writes them.
    """
    R = masses.shape[-1]
    M = radix
    lead = masses.shape[:-1]
    m = masses.to(torch.int32).reshape(-1, R).clone()
    deg = deg.to(torch.int32).reshape(-1)
    K = m.shape[0]
    dev = m.device
    inrow = _inrow(R, deg)

    is_small = inrow & (m < M)
    is_large = inrow & (m >= M)
    # compacted ascending index lists; the top is entry count-1
    small = torch.sort(torch.where(is_small, 0, 1).to(torch.int8), dim=-1,
                       stable=True).indices
    large = torch.sort(torch.where(is_large, 0, 1).to(torch.int8), dim=-1,
                       stable=True).indices
    sp = is_small.sum(-1, keepdim=True)          # small-list pointer
    lp = is_large.sum(-1, keepdim=True)          # large-list pointer
    carry = torch.full((K, 1), -1, dtype=torch.int64, device=dev)

    dump = torch.full((K, 1), R, dtype=torch.int64, device=dev)
    logs = []
    for _ in range(max(R - 1, 1)):
        carried = carry >= 0
        can = (carried | (sp > 0)) & (lp > 0)
        si = torch.where(carried, carry,
                         small.gather(1, (sp - 1).clamp(min=0)))
        li = large.gather(1, (lp - 1).clamp(min=0))
        ms = m.gather(1, si)
        ml_old = m.gather(1, li)
        ml = ml_old - (M - ms)
        m.scatter_(1, li, torch.where(can, ml, ml_old))
        logs.append((torch.where(can, si, dump), li, ms))
        now_small = can & (ml < M)
        sp = sp - (can & ~carried).to(sp.dtype)
        carry = torch.where(can, torch.where(now_small, li, -1), carry)
        lp = lp - now_small.to(lp.dtype)

    si, li, ms = (torch.cat(x, 1) for x in zip(*logs))
    thresh = torch.full((K, R + 1), -1, dtype=torch.int32, device=dev)
    partner = torch.arange(R + 1, dtype=torch.int32, device=dev).repeat(K, 1)
    thresh.scatter_(1, si, ms)
    partner.scatter_(1, si, li.to(torch.int32))
    thresh, partner = thresh[:, :R], partner[:, :R]
    pending = inrow & (thresh < 0)
    pos = torch.arange(R, dtype=torch.int32, device=dev)
    thresh = torch.where(pending, M, thresh)
    partner = torch.where(pending, pos, partner)
    return (torch.where(inrow, thresh, -1).reshape(*lead, R),
            torch.where(inrow, partner, 0).reshape(*lead, R))


def row_masses(thresh: torch.Tensor, partner: torch.Tensor, deg,
               radix: int) -> torch.Tensor:
    """Recover the quantized masses a (thresh, partner) row encodes:
    m_i = thresh_i + Σ_j [partner_j == i]·(M − thresh_j)."""
    R = thresh.shape[-1]
    M = radix
    deg = torch.as_tensor(deg, dtype=torch.int32, device=thresh.device)
    inrow = _inrow(R, deg)
    own = torch.where(inrow, thresh, 0)
    donated = torch.where(inrow, M - thresh, 0).to(torch.int32)
    slot = torch.where(inrow, partner, R).long()
    recv = torch.zeros((*inrow.shape[:-1], R + 1), dtype=torch.int32,
                       device=thresh.device).scatter_add(-1, slot, donated)
    return own + recv[..., :R]


# ---------------------------------------------------------------------------
# Flat build / incremental update
# ---------------------------------------------------------------------------


def region_weights(index: TemporalIndex, spec: TableSpec) -> torch.Tensor:
    """Raw per-position weights over the ns view (0 beyond the valid part)."""
    nc = index.node_capacity
    srcc = index.ns_src.clamp(0, nc - 1).long()
    w = spec.weight(index.ns_ts, index.node_tbase[srcc],
                    index.node_tref[srcc])
    valid = index.ns_src < nc
    return torch.where(valid, w.to(torch.float32).clamp(min=0.0), 0.0)


def fixed_order_prefix(w: torch.Tensor) -> torch.Tensor:
    """Exclusive float32 prefix P[0..E] of non-negative ``w`` in a fixed
    order of elementwise adds: in order inside blocks of ``_SCAN_BLOCK``,
    a Hillis-Steele scan over the block totals, then a running max (exact)
    so P is non-decreasing. The same bits on every device; exact, and so
    equal to any cumsum, while every partial sum is an integer below
    2^24."""
    E = w.shape[0]
    B = _SCAN_BLOCK
    nb = max(-(-E // B), 1)
    x = torch.nn.functional.pad(w.to(torch.float32), (0, nb * B - E))
    x = x.view(nb, B).t().contiguous()                   # [B, nb]
    for j in range(1, B):
        x[j] += x[j - 1]
    tot = x[B - 1].clone()                               # inclusive totals
    s = 1
    while s < nb:
        tot = torch.cat([tot[:s], tot[s:] + tot[:-s]])
        s *= 2
    x[:, 1:] += tot[None, :-1]
    zero = torch.zeros(1, dtype=torch.float32, device=w.device)
    flat = torch.cat([zero, x.t().reshape(-1)[:E]])
    return torch.cummax(flat, 0).values


def _rebuild_rows(w, starts, ids, thresh, partner, radix: int, R: int,
                  width: int):
    """Rebuild the tables of nodes ``ids`` (degrees 1..``width``) in place
    into ``thresh``/``partner`` (E+1 elements, the last a dump). Masses are
    quantized over R = degree_cap slots, which fixes the order of the row
    sum; the Vose steps run over the first ``width`` slots."""
    E = thresh.shape[0] - 1
    dev = w.device
    vc = ids.long()
    A = starts[vc]
    degr = starts[vc + 1] - A
    off = torch.arange(R, dtype=torch.int32, device=dev)
    gpos = A[:, None] + off[None, :]
    gvalid = off[None, :] < degr[:, None]
    wrow = torch.where(gvalid, w[gpos.clamp(0, E - 1).long()], 0.0)
    masses = quantize_row(wrow, degr, radix)[:, :width]
    th, pa = vose_row(masses, degr, radix)
    gpos, gvalid = gpos[:, :width], gvalid[:, :width]
    spos = torch.where(gvalid, gpos, E).reshape(-1).long()
    thresh[spos] = th.reshape(-1)
    partner[spos] = pa.reshape(-1)


def update_tables(index: TemporalIndex, spec: TableSpec, *,
                  old_starts: Optional[torch.Tensor] = None,
                  old_tables: Optional[AliasTables] = None,
                  dirty: Optional[torch.Tensor] = None) -> AliasTables:
    """(Re)build alias tables for ``index``.

    With ``old_starts``/``old_tables``/``dirty`` (bool[N]) this is the
    incremental advance: clean nodes copy their old region content through
    the old→new offset, dirty ones are rebuilt. Without them it is the
    from-scratch build, the same code with every node dirty. ``rebuilt``
    counts what the reference counts: dirty nodes with a non-empty region.
    """
    E = index.edge_capacity
    nc = index.node_capacity
    M, R = spec.radix, spec.degree_cap
    dev = index.ns_src.device

    w = region_weights(index, spec)
    ptab = fixed_order_prefix(w)

    starts = index.node_starts
    if dirty is None:
        dirty = torch.ones(nc, dtype=torch.bool, device=dev)
    dirty = dirty.to(torch.bool)

    thresh = torch.full((E + 1,), -1, dtype=torch.int32, device=dev)
    partner = torch.zeros(E + 1, dtype=torch.int32, device=dev)
    if old_tables is not None:
        # clean-node positional copy: position p of node v's new region
        # holds what old position old_starts[v] + (p − starts[v]) held
        pos = torch.arange(E, dtype=torch.int32, device=dev)
        v = index.ns_src.clamp(0, nc - 1).long()
        clean = (index.ns_src < nc) & ~dirty[v]
        old_pos = (old_starts[v] + (pos - starts[v])).clamp(0, E - 1).long()
        thresh[:E] = torch.where(clean, old_tables.thresh[old_pos], -1)
        partner[:E] = torch.where(clean, old_tables.partner[old_pos], 0)
        prev_rebuilt = old_tables.rebuilt
    else:
        prev_rebuilt = torch.zeros((), dtype=torch.int32, device=dev)

    # dirty nodes whose region fits a table, compacted to the front; the
    # build's one host read: how many there are and their largest degree
    deg_all = starts[1:nc + 1] - starts[:nc]
    rows = dirty & (deg_all > 0) & (deg_all <= R)
    order = torch.sort((~rows).to(torch.int8), stable=True).indices
    n_rows, width = torch.stack([
        rows.sum(), torch.where(rows, deg_all, 0).max()]).tolist()
    for p0 in range(0, n_rows, REBUILD_ROWS):
        _rebuild_rows(w, starts, order[p0:min(p0 + REBUILD_ROWS, n_rows)],
                      thresh, partner, M, R, width)

    rebuilt = prev_rebuilt + (dirty & (deg_all > 0)).sum(dtype=torch.int32)
    return AliasTables(thresh=thresh[:E], partner=partner[:E], ptab=ptab,
                       rebuilt=rebuilt)


def build_tables(index: TemporalIndex, spec: TableSpec) -> AliasTables:
    """From-scratch build: ``update_tables`` with every node dirty."""
    return update_tables(index, spec)


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------


def alias_pick(tables: AliasTables, a: torch.Tensor, c: torch.Tensor,
               b: torch.Tensor, u: torch.Tensor, *, radix: int,
               degree_cap: int) -> torch.Tensor:
    """Pick k ∈ [c, b) under the table bias; valid only where b > c.

    O(1) alias path when the temporal cutoff keeps the whole region
    (c == a) and the region fits the table (deg ≤ degree_cap); otherwise
    the exact inverse CDF over ``ptab`` restricted to [c, b), by the
    weight-mode binary search.
    """
    M = radix
    E = tables.thresh.shape[0]
    deg = b - a
    n = b - c
    tabled = (c == a) & (deg > 0) & (deg <= degree_cap)

    # O(1) path: bucket + biased coin, exact in float32 (deg·M ≤ 2^23)
    dm = deg * M
    kq = torch.floor(u * dm.to(torch.float32)).to(torch.int32)
    kq = torch.minimum(kq.clamp(min=0), (dm - 1).clamp(min=0))
    j = torch.div(kq, M, rounding_mode="floor")
    r = kq - j * M
    pa = (a + j).clamp(0, E - 1).long()
    take_own = r < tables.thresh[pa]
    k_tab = a + torch.where(take_own, j, tables.partner[pa])

    # exact fallback over the raw-weight prefix, suffix-restricted
    p_c = tables.ptab[c.long()]
    total = tables.ptab[b.long()] - p_c
    target = p_c + u * total
    k_w = _shifted_lower_bound(tables.ptab, c, b, target)
    k_w = torch.where(total > 0, k_w, c + index_uniform(u, n))

    k = torch.where(tabled, k_tab, k_w)
    return torch.minimum(torch.maximum(k, c), torch.maximum(b - 1, c))
