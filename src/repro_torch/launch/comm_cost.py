"""The collectives a sharding plan implies for one step, a chip's bytes by
kind and by the mesh axes each runs over, in place of the reference's
count from the compiled SPMD module (``repro/launch/roofline.py``,
``collective_bytes_from_hlo``).

A collective's bytes are its result's bytes on one partition, the
reference's convention. The rules are the reference plan's own account
of itself (``repro/distributed/sharding.py:1-14``: TP over ``model``,
ZeRO-3 over the fsdp axes, the batch over ``(pod, data)``, a decode
cache's sequence over ``model``), applied to the port's specs
(``distributed.sharding``: ``param_pspec``, ``batch_pspec``,
``state_pspecs``, ``hint_pspec``), the stacked-leaf quirk included
(ROADMAP queue 3 item 12):

1. ``param_gathers`` — all-gather of each parameter use (ZeRO-3).
2. ``grad_reductions`` — reduce-scatter or all-reduce of each gradient,
   train only.
3. ``tp_reductions`` — all-reduce of each product whose contraction
   carries ``model``.
4. ``expert_dispatch`` — the MoE dispatch and combine all-to-alls.
5. ``split_decode`` — the split-sequence decode's all-reduce.
6. ``activation_reshards`` — all-gather of a tensor a ``hint`` (or a
   weight gradient's leaf) takes off ``model``.
7. ``recurrence_steps`` — the gathers and reductions a mamba scan's
   time loop makes each step over ``model``, times its trip count (the
   sequence), train and prefill.

Rules 1, 2, 4, 5 and 7 count uses from the config; rules 3 and 6 read
what the counter recorded (``op_cost.OpCounts.products`` and
``reshards``).
Two departures from the plan's account, each matching the reference's
compiled train step: rule 1 gathers again in the backward with remat
off too, and rule 6 exists. An axis of size 1 moves nothing. XLA's partitioner chooses its own collectives
(on the CPU it emits no reduce-scatter and reshards activations with
all-to-alls and permutes), so these are held to the reference's total
bytes a chip, not kind by kind (``tests/test_torch_launch_vs_reference
.py``).
"""
from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.launch.op_cost import (OpCounts, Product, Reshard,
                                        share_divisor)
from repro_torch.models.model import compute_dtype
from repro_torch.models.moe import _capacity
from repro_torch.models.transformer import layer_specs

KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "collective-permute")

Axes = Tuple[str, ...]


@dataclass
class CommCounts:
    """Bytes one chip receives in one step, by (kind, mesh axes)."""
    bytes: Dict[Tuple[str, Axes], float] = field(default_factory=Counter)

    def add(self, kind: str, axes: Axes, nbytes: float, times: int = 1):
        if axes and nbytes and times:
            self.bytes[(kind, axes)] += nbytes * times

    @property
    def by_kind(self) -> Dict[str, float]:
        out = {k: 0.0 for k in KINDS}
        for (kind, _), b in self.bytes.items():
            out[kind] += b
        return out

    @property
    def by_axes(self) -> Dict[Axes, float]:
        out: Dict[Axes, float] = Counter()
        for (_, axes), b in self.bytes.items():
            out[axes] += b
        return dict(out)

    @property
    def total(self) -> float:
        return float(sum(self.bytes.values()))


def _axes(mesh, names) -> Axes:
    """``names`` in mesh order, those of size 1 left out."""
    names = set(names)
    return tuple(a for a in mesh if a in names and mesh[a] > 1)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _leaves(model):
    """(reference path, stacked shape, per-period shape) of each leaf of
    ``model`` once."""
    seen = {}
    named = dict(model.named_parameters())
    for name, path, stacked, _ in shd.param_leaves(model):
        seen.setdefault(path, (path, stacked, tuple(named[name].shape)))
    return list(seen.values())


def param_gathers(leaves, mesh, compute_dtype: torch.dtype, uses: Dict,
                  out: CommCounts, mode: Optional[str] = None) -> None:
    """Rule 1, ZeRO-3 (``sharding.py:4-5``): each use of a leaf gathers it
    over the fsdp axes in its spec, and over whatever its period axis
    carries (quirk 12 puts an entry there). The result is one period of
    the leaf in ``compute_dtype``, divided by the ``model`` shards of its
    other dimensions; a stacked leaf is gathered once a period. A leaf
    whose spec leaves it whole over ``model`` is gathered as the part one
    ``model`` shard reads, where ``model`` divides one of its dimensions:
    the partitioner splits its product's heads or output features over
    ``model`` (``op_cost``'s output-feature split) and gathers that part
    only (the reference's compiled olmo-1b steps on 2×4 gather ``wo``
    as ``f32[1,16,64]`` and ``w_down`` as ``f32[128,16]`` a layer, in
    train, prefill and decode). ``uses[path]`` (1 by default) counts the
    uses a step makes of each period: one a forward, and in train one
    more in the backward, which gathers again (ZeRO-3 frees a gathered
    period after its forward; the reference's compiled train step
    gathers each leaf twice with remat off too), the backward's
    recomputation of a remat block included. A leaf with no fsdp entry
    (norms, routers' and the sLSTM's replicated leaves) needs no
    gather."""
    ax = shd.AxisNames(mesh, mode)
    fsdp = set(shd._parts(ax.fsdp))
    for path, stacked, shape in leaves:
        spec = shd.param_pspec(path, stacked, mesh, mode)
        spec = tuple(spec) + (None,) * (len(stacked) - len(spec))
        lead = len(stacked) - len(shape)
        names = {a for e in spec for a in shd._parts(e) if a in fsdp}
        names |= {a for e in spec[:lead] for a in shd._parts(e)}
        axes = _axes(mesh, names)
        if not axes:
            continue
        model = math.prod(mesh[a] for e in spec[lead:]
                          for a in shd._parts(e) if a == "model")
        m = mesh.get("model", 1)
        if model == 1 and any(n % m == 0 for n in shape):
            model = m
        nbytes = math.prod(shape) // model * _itemsize(compute_dtype)
        periods = math.prod(stacked[:lead])
        out.add("all-gather", axes, nbytes, periods * uses.get(path, 1))


def grad_reductions(leaves, mesh, out: CommCounts,
                    mode: Optional[str] = None) -> None:
    """Rule 2, train only: the float32 gradient of a leaf with an fsdp
    axis in its spec is reduce-scattered to its shard; a leaf replicated
    over the batch axes is all-reduced over them, its bytes divided by
    its ``model`` shards."""
    ax = shd.AxisNames(mesh, mode)
    batch = set(shd._parts(ax.batch))
    for path, stacked, _ in leaves:
        spec = shd.param_pspec(path, stacked, mesh, mode)
        in_spec = {a for e in spec for a in shd._parts(e)}
        scatter = _axes(mesh, batch & in_spec)
        shard = shd.shard_bytes(stacked, torch.float32, spec, mesh)
        if scatter:
            out.add("reduce-scatter", scatter, shard)
        else:
            out.add("all-reduce", _axes(mesh, batch - in_spec), shard)


def _per_chip(shape, dims, itemsize: int, mesh, mode) -> float:
    """Bytes one chip holds of a tensor laid out as ``dims``."""
    bs = frozenset(n for lab in dims for a, n in lab if a == "batch")
    ms = frozenset(n for lab in dims for a, n in lab if a == "model")
    return math.prod(shape) * itemsize / share_divisor((bs, ms, None),
                                                       mesh, mode)


def tp_reductions(products: Dict[Product, int], mesh, train: bool,
                  out: CommCounts, mode: Optional[str] = None) -> None:
    """Rule 3, TP over ``model`` (``sharding.py:3``): a product of an
    activation with a weight whose contraction carries ``model`` (by the
    leaf's spec, or the activation's layout from ``hint``: heads) sums
    partial products, an all-reduce of its output on one chip: the
    tokens a chip holds times the output features left after the
    weight's own shards. In train, one more in the backward, of the
    input's gradient (none for a table lookup's integer tokens). Where
    ``model`` does not divide the contracted size, or the batch already
    uses it (``fsdp`` mode), nothing is reduced."""
    ax = shd.AxisNames(mesh, mode)
    m = mesh.get("model", 1)
    if m == 1 or ax.model is None or ax.model in shd._parts(ax.batch):
        return
    for p, n in products.items():
        if not any(size % m == 0 for size in p.contraction):
            continue
        out.add("all-reduce", ("model",),
                _per_chip(p.out_shape, p.out_dims, p.out_itemsize, mesh,
                          mode), n)
        if train and p.in_float:
            out.add("all-reduce", ("model",),
                    _per_chip(p.in_shape, p.in_dims, p.in_itemsize, mesh,
                              mode), n)


def activation_reshards(reshards: Dict[Reshard, int], mesh,
                        out: CommCounts, mode: Optional[str] = None) -> None:
    """Rule 6, the reference's ``hint`` is a sharding constraint: where it
    pins a tensor (or, in the backward, its gradient) replicated over
    ``model`` along a dimension the tensor arrives split on (a residual
    split on its features by a product's output), the tensor is
    all-gathered over ``model``, its bytes on one chip as pinned. So is
    a weight gradient computed split over ``model`` (from split
    activations) for a leaf its spec leaves replicated over it."""
    ax = shd.AxisNames(mesh, mode)
    m = mesh.get("model", 1)
    if m == 1 or ax.model is None or ax.model in shd._parts(ax.batch):
        return
    for r, n in reshards.items():
        if any(size % m == 0 for size in r.dropped):
            out.add("all-gather", ("model",),
                    _per_chip(r.shape, r.dims, r.itemsize, mesh, mode), n)


def expert_dispatch(cfg, tokens: int, groups: int, mesh, train: bool,
                    compute_dtype: torch.dtype, out: CommCounts,
                    mode: Optional[str] = None) -> None:
    """Rule 4, EP over ``model`` (``sharding.py:3``, ``moe.py:153,161``):
    an MoE layer whose dispatch buffer ``[G, E, C, d]`` has its experts
    over ``model`` (``hint_pspec``) exchanges it by an all-to-all to
    dispatch and one to combine, each the buffer's bytes on one chip, at
    the port's capacity (``models.moe._capacity``); two more in the
    backward in train. A family without MoE layers has none."""
    if cfg.moe is None:
        return
    n = sum(s.ffn == "moe" for s in layer_specs(cfg))
    G = math.gcd(tokens, groups)
    shape = (G, cfg.moe.num_experts,
             _capacity(tokens // G, cfg.moe), cfg.d_model)
    spec = shd.hint_pspec(shape, ("batch", "model", None, None), mesh, mode)
    if "model" not in shd._parts(spec[1]) or mesh.get("model", 1) == 1:
        return
    nbytes = shd.shard_bytes(shape, compute_dtype, spec, mesh)
    out.add("all-to-all", ("model",), nbytes, n * (4 if train else 2))


def split_decode(cfg, batch: int, max_seq: int, mesh, out: CommCounts,
                 mode: Optional[str] = None) -> None:
    """Rule 5, the split-KV decode (``sharding.py:6-7``, ``cache_pspec``):
    an attention layer whose cache's sequence lies over ``model`` holds a
    part of the keys on each chip, and all-reduces its partial output
    ``[B, H, Dv]`` and softmax statistics (max and sum, ``[B, H]`` each),
    float32, per layer and step. Recurrent layers carry a state, not a
    sequence, and have none."""
    if mesh.get("model", 1) == 1:
        return
    att = cfg.attention
    specs = shd.state_pspecs(cfg, mesh, batch, max_seq, mode)
    bspec = shd.batch_pspec(mesh, batch, mode)
    b_local = batch // shd._size(mesh, bspec[0] if bspec else None)
    dv = att.v_head_dim or att.head_dim
    nbytes = b_local * att.n_heads * (dv + 2) * 4
    for layer, s in enumerate(layer_specs(cfg)):
        if s.kind != "attn":
            continue
        spec = next(v for k, v in specs.items()
                    if k.startswith(f"caches.{layer}."))
        if len(spec) > 2 and "model" in shd._parts(spec[2]):
            out.add("all-reduce", ("model",), nbytes)


def recurrence_steps(leaves, batch: int, seq_len: int, mesh, train: bool,
                     out: CommCounts, mode: Optional[str] = None) -> None:
    """Rule 7, a mamba scan whose state ``h [B, di, N]`` lies over
    ``model`` on ``N`` (``A_log``'s spec, the last entry of its rule)
    moves its per-step inputs and output over ``model`` once a time step,
    inside the loop: an all-gather of each of ``dt`` and ``dt·x`` and an
    all-reduce of ``y = h·C`` (the contraction over ``N``), each ``[B,
    di]`` float32 with ``B`` the batch on one chip. In train the
    backward's loop gathers the inputs and the output's cotangent (three)
    and all-reduces the inputs' two cotangents. Each is multiplied by the
    loop's trip count, ``seq_len``, as the reference's ``hlo_cost``
    multiplies a ``while`` body (read off its compiled jamba steps on 2×4
    and 1×8: 2 + 1 ``f32[B, di]`` a step and layer forward, 3 + 2 more
    in train). A decode step is one step with no loop, its state laid out
    over ``di`` (``cache_pspec``), and moves none of these."""
    m = mesh.get("model", 1)
    if m == 1:
        return
    bspec = shd.batch_pspec(mesh, batch, mode)
    b_local = batch // shd._size(mesh, bspec[0] if bspec else None)
    gathers, reduces = (5, 3) if train else (2, 1)
    for path, stacked, _ in leaves:
        if not path.endswith("mamba/A_log"):
            continue
        spec = shd.param_pspec(path, stacked, mesh, mode)
        if len(spec) < len(stacked) or "model" not in shd._parts(spec[-1]):
            continue
        periods, di = math.prod(stacked[:-2]), stacked[-2]
        nbytes = b_local * di * 4
        out.add("all-gather", ("model",), nbytes, gathers * seq_len * periods)
        out.add("all-reduce", ("model",), nbytes, reduces * seq_len * periods)


def plan_collectives(cfg, shape, mesh, counts: OpCounts,
                     mode: Optional[str] = None, groups: int = 1,
                     model=None) -> CommCounts:
    """The bytes one chip of ``mesh`` moves in one step of ``shape`` (a
    ``ShapeConfig``), by kind and mesh axes: the seven rules above,
    ``counts`` the step's counts (its products and reshards), ``groups``
    the MoE token groups of the step, ``model`` the step's model (a
    meta skeleton of ``cfg`` by default). A 1×1 mesh moves nothing."""
    out = CommCounts()
    dtype = compute_dtype(cfg)
    train = shape.kind == "train"
    if model is None:
        from repro_torch.launch.specs import abstract_model
        model = abstract_model(cfg)
    leaves = _leaves(model)
    uses = {p: 2 if train else 1 for p, _, _ in leaves}
    # the table is gathered once a step, tied to the logits or not: a
    # lookup's backward does not read it, and the reference's compiled
    # olmo-1b steps keep one gather for the lookup and the logits
    uses["embed/table"] = 1
    param_gathers(leaves, mesh, dtype, uses, out, mode)
    if train:
        grad_reductions(leaves, mesh, out, mode)
    tp_reductions(counts.products, mesh, train, out, mode)
    activation_reshards(counts.reshards, mesh, out, mode)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    expert_dispatch(cfg, tokens, groups, mesh, train, dtype, out, mode)
    if shape.kind == "decode":
        split_decode(cfg, shape.global_batch, shape.seq_len, mesh, out,
                     mode)
    else:
        recurrence_steps(leaves, shape.global_batch, shape.seq_len, mesh,
                         train, out, mode)
    return out
