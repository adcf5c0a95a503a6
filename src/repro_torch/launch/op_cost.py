"""Operation counts of an eager PyTorch step, global and a chip's share,
in place of the reference's ``launch/hlo_cost.py``.

Eager PyTorch has no HLO. The step runs on meta tensors (shapes, no
storage) under ``OpCounter``, a ``TorchDispatchMode`` that sees every
aten op autograd issues, the backward and the recomputation of a
checkpointed block included:

* **flops** — for the matmul-like ops, ``torch.utils.flop_counter``'s
  registered formulas (2 × output elements × contraction); one FLOP per
  output element of every other op tagged ``torch.Tag.pointwise``, the
  reference's rule for elementwise ops;
* **transcendentals** — output elements of exp, log, tanh, erf, rsqrt
  and the like, counted apart and not in ``flops``, as the reference
  counts them;
* **bytes** — the operand bytes plus the result bytes of each op. Eager
  runs each op as its own kernel, so this is the traffic model the
  reference applies to each fusion; views (and the ops that only
  allocate) move no bytes.

A Python loop runs every iteration, so there is no trip count to
multiply by: a loop of ten matmuls counts ten.

**A chip's share.** The reference reads each chip's counts from the
compiled SPMD module, so it sees the work a plan leaves replicated. The
counter learns which plan governs each op by carrying a layout with
every tensor (a ``WeakTensorKeyDictionary`` filled in
``__torch_dispatch__``; meta tensors have no ``data_ptr``):

* a parameter is seeded with its leaf's spec (``distributed.sharding``),
  the batch and the decode state with theirs, and
  ``distributed.sharding.hint`` puts the layout the reference's ``hint``
  pins at the same call sites (and on the gradient through it);
* each dimension carries the logical axes it lies over (``batch`` or
  ``model``, with the dimension's size where the axis was set, which
  decides on a mesh whether the axis divides it), through views (a
  reshape moves them to the outermost dimension of each group),
  casts, elementwise ops and reductions (a reduced dimension drops
  them);
* a product's output takes its operands' free dimensions; a contracted
  dimension's axes split the product and are summed away. A product's
  weight gradient (an operand entered a product with that weight in the
  forward, and the result has the weight operand's shape) takes the
  weight's layout, as the reference's gradient sharding pins it;
* a product of a weight and an activation that carry no ``model`` is
  split over ``model`` on its output features only where it writes the
  residual stream (``residual`` wide: every (fsdp, model) rule puts
  ``model`` on a stacked leaf's ``d_model`` rows, so XLA lays the
  residual out over ``model`` and computes its writers split); any
  other such product runs replicated over ``model``, as XLA computes
  xlstm's q/k/v projections. A ``hint`` on a product's output (through
  views) lays out the product too: a constraint propagates to its
  producer.

An op's FLOPs and bytes on one chip are its global count divided by the
shards that split it: the batch shards where a batch axis lies on one of
its dimensions, times the ``model`` shards where ``model`` does (from
the weight it reads, the heads or experts it carries, or a decode
cache's sequence). An op on a parameter alone (the optimiser, casts) is
divided by its leaf's shards on every axis. Anything else runs
replicated. ``OpCounts.shares`` keeps each op's counts by that class, so
one count serves every mesh (``per_chip``).

``OpCounts.products`` records each forward product whose contraction
carries ``model``, and ``OpCounts.reshards`` each ``hint`` (or weight
gradient) that takes ``model`` off a dimension: the tensor-parallel
reductions and the gathers of ``launch.comm_cost``.
"""
from __future__ import annotations

import functools
import math
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.distributed import sharding as shd

aten = torch.ops.aten

_TRANSCENDENTAL = {
    aten.exp, aten.exp2, aten.expm1, aten.log, aten.log1p, aten.log2,
    aten.log10, aten.tanh, aten.sigmoid, aten.erf, aten.erfc, aten.erfinv,
    aten.rsqrt, aten.sqrt, aten.pow, aten.sin, aten.cos, aten.softplus,
    aten.logit,
}
# ops that allocate or alias and move no bytes
_NO_TRAFFIC = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten._unsafe_view, aten.lift_fresh,
    aten.detach, aten.alias,
}
_RESHAPES = {aten.view, aten._unsafe_view, aten.reshape, aten.alias,
             aten.detach, aten.unsqueeze, aten.squeeze, aten.unflatten,
             aten.flatten, aten._reshape_alias, aten.view_as}
_REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max,
               aten.min, aten.argmax, aten.argmin, aten.logsumexp,
               aten.prod, aten.var, aten.std, aten.var_mean, aten.any,
               aten.all, aten.linalg_vector_norm, aten.norm, aten.nansum}
_PRODUCTS = {aten.mm: 0, aten.addmm: 1, aten.bmm: 0, aten.baddbmm: 1}
# ops that make a tensor from a template's dtype and device
_NEW = {aten.new_zeros, aten.new_ones, aten.new_full, aten.new_empty,
        aten.new_empty_strided}

Labels = FrozenSet[Tuple[str, int]]       # one dimension's (axis, size)s
_NONE: Labels = frozenset()
Leaf = Tuple[str, Tuple[int, ...]]        # reference path, stacked shape
# an op's class: batch sizes, model sizes, and the leaf of an op on a
# parameter alone
ShareKey = Tuple[FrozenSet[int], FrozenSet[int], Optional[Leaf]]
_REPLICATED: ShareKey = (frozenset(), frozenset(), None)


class Layout(NamedTuple):
    """What the counter knows of a tensor: each dimension's axes, the
    parameter leaf it is (a view, cast, gradient or moment of), and the
    weights it entered a product with (``(leaf, weight operand shape,
    its dims)``), carried through views only."""
    dims: Tuple[Labels, ...]
    leaf: Optional[Leaf] = None
    times: Tuple = ()


@dataclass(frozen=True)
class Product:
    """A forward product whose contraction carries ``model``: the
    weight's reference path, the output and the activation operand
    (shape, dims, bytes an element), the model sizes on the contraction,
    and whether the activation is floating (it then has a gradient)."""
    path: str
    out_shape: Tuple[int, ...]
    out_dims: Tuple[Labels, ...]
    out_itemsize: int
    in_shape: Tuple[int, ...]
    in_dims: Tuple[Labels, ...]
    in_itemsize: int
    contraction: FrozenSet[int]
    in_float: bool


@dataclass(frozen=True)
class Reshard:
    """A layout that takes ``model`` off a dimension of a tensor: a
    ``hint`` (in the forward, or on the gradient in the backward), or a
    weight gradient computed split over ``model`` for a leaf that is not.
    The tensor's shape, the layout it is pinned to, bytes an element, and
    the model sizes it drops."""
    shape: Tuple[int, ...]
    dims: Tuple[Labels, ...]
    itemsize: int
    dropped: FrozenSet[int]


@dataclass
class OpCounts:
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes: float = 0.0
    ops: int = 0
    by_op: Dict[str, float] = field(default_factory=Counter)  # matmul-like
    # class -> [flops, bytes, transcendentals]
    shares: Dict[ShareKey, list] = field(default_factory=dict)
    products: Dict[Product, int] = field(default_factory=Counter)
    reshards: Dict[Reshard, int] = field(default_factory=Counter)


# -- layouts ------------------------------------------------------------


def dims_of(shape, logical) -> Tuple[Labels, ...]:
    """Dims from logical names (``"batch"``, ``"model"``, None), one a
    leading dimension, each axis with the dimension's size; an entry
    ``(name, size)`` gives the size of the logical axis the dimension
    holds a part of (the heads of a ``[B, Hkv, ·, rep]`` grouping)."""
    out = []
    for k, n in enumerate(shape):
        name = logical[k] if k < len(logical) else None
        if isinstance(name, tuple):
            name, n = name
        out.append(frozenset({(name, int(n))}) if name else _NONE)
    return tuple(out)


@functools.lru_cache(maxsize=4096)
def _reshape(src, dims, dst) -> Tuple[Labels, ...]:
    """A reshape's dims: each group of dimensions whose products agree
    hands each of its axes to the group's dimension of the axis's size
    (a split of a merged dimension), else to its outermost one of size
    > 1."""
    out = [_NONE] * len(dst)
    if not any(dims):
        return tuple(out)
    i = j = 0
    n, m = len(src), len(dst)
    while i < n or j < m:
        i0, j0 = i, j
        ps = src[i] if i < n else 1
        pd = dst[j] if j < m else 1
        i, j = i + 1, j + 1
        while ps != pd and (i < n or j < m):
            if (ps < pd and i < n) or j >= m:
                ps *= src[i]
                i += 1
            else:
                pd *= dst[j]
                j += 1
        lab = frozenset().union(*dims[i0:min(i, n)])
        if lab and j0 < m:
            at = [k for k in range(j0, min(j, m)) if dst[k] != 1] or [j0]
            taken = set()
            # axes that match a dimension's size first; the others to the
            # outermost dimension left (the heads of a [B·Hkv] merge)
            for ax, size in sorted(lab, key=lambda a: (
                    not any(dst[k] == a[1] for k in at), a)):
                k = next((k for k in at if dst[k] == size and k not in taken),
                         next((k for k in at if dst[k] == size),
                              next((k for k in at if k not in taken),
                                   at[0])))
                taken.add(k)
                out[k] = out[k] | {(ax, size)}
    return tuple(out)


@functools.lru_cache(maxsize=4096)
def _broadcast(shape, ins) -> Tuple[Labels, ...]:
    """Dims of an output of ``shape`` from inputs ``(shape, dims)``
    aligned from the right: a dimension keeps the axes of every input
    dimension of its size."""
    nd = len(shape)
    out = [_NONE] * nd
    for s, d in ins:
        off = nd - len(s)
        for k, lab in enumerate(d):
            if lab and off + k >= 0 and s[k] == shape[off + k]:
                out[off + k] = out[off + k] | lab
    return tuple(out)


def _arg(func, args, kwargs, name, default=None):
    for k, a in enumerate(func._schema.arguments):
        if a.name == name:
            if name in kwargs:
                return kwargs[name]
            return args[k] if k < len(args) else default
    return default


def _reduced(func, args, kwargs, ndim):
    dim = _arg(func, args, kwargs, "dim")
    if dim is None or (isinstance(dim, (list, tuple)) and not dim):
        return set(range(ndim))
    dims = dim if isinstance(dim, (list, tuple)) else [dim]
    return {d % max(ndim, 1) for d in dims}


def _tensors(xs) -> list:
    """The tensors of an op's arguments (or results): each one, and
    those of a list or tuple among them."""
    out = []
    for a in xs:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _union(dims) -> Labels:
    return frozenset().union(*dims) if dims else _NONE


def _key(dims) -> ShareKey:
    """The class of an op on a tensor laid out as ``dims`` alone."""
    labels = _union(dims)
    return (frozenset(n for a, n in labels if a == "batch"),
            frozenset(n for a, n in labels if a == "model"), None)


class _Hint(torch.autograd.Function):
    """``distributed.sharding.hint`` while counting: a view of ``x`` laid
    out as ``dims``, and its gradient the same (a sharding constraint
    pins the cotangent too)."""

    @staticmethod
    def forward(ctx, x, counter, dims):
        ctx.counter, ctx.dims = counter, dims
        return counter._relayout(x.view_as(x), dims)

    @staticmethod
    def backward(ctx, g):
        return ctx.counter._relayout(g.view_as(g), ctx.dims), None, None


class OpCounter(TorchDispatchMode):
    """``with OpCounter(seeds, residual) as c: step(...)``, then
    ``c.counts``. ``seeds`` maps tensors to their ``Layout``
    (``step_seeds``); ``residual`` is the model's ``d_model``, the only
    output width at which a product with nothing over ``model`` is split
    over it (None: at none)."""

    def __init__(self, seeds=None, residual: Optional[int] = None):
        super().__init__()
        self.counts = OpCounts()
        self.residual = residual
        self.layouts = WeakTensorKeyDictionary()
        # autograd node -> {shape: dims} of its outputs, and the layouts
        # its backward may give (``_grad_dims``)
        self._node_outs, self._node_cands = {}, {}
        # the last op that made a tensor from no tensor, or a forward
        # product's output (or a view of either): (that tensor, its
        # class, its counts), moved to the layout a hint then gives it
        self._made = None
        for t, lay in (seeds or {}).items():
            self.layouts[t] = lay

    def __enter__(self):
        self._hook = shd.set_layout_hook(self._hint)
        return super().__enter__()

    def __exit__(self, *exc):
        shd.set_layout_hook(self._hook)
        return super().__exit__(*exc)

    def _hint(self, x, logical):
        dims = dims_of(x.shape, logical)
        made = self._made
        if made is not None and made[0] is x:
            # a buffer or a product's output made and laid out at once:
            # its making too (a constraint propagates to its producer)
            _, key, f, b, tx = made
            new = _key(dims)
            self._add(key, f, b, tx, -1.0)
            self._add((key[0] | new[0], key[1] | new[1], None), f, b, tx)
        return _Hint.apply(x, self, dims)

    def _relayout(self, y, dims):
        """Lay ``y`` out as ``dims``."""
        lay = self.layouts.get(y) or Layout((_NONE,) * y.dim())
        self._relayout_dims(y, lay.dims, dims)
        self.layouts[y] = lay._replace(dims=dims)
        return y

    def _relayout_dims(self, y, had, dims):
        """Where ``model`` leaves a dimension of ``y`` laid out as ``had``
        to be laid out as ``dims``, record the all-gather that reshards
        it (``OpCounts.reshards``)."""
        dropped = frozenset(n for h, w in zip(had, dims)
                            for ax, n in h - w if ax == "model")
        if dropped:
            self.counts.reshards[Reshard(tuple(y.shape), dims,
                                         y.element_size(), dropped)] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        ins = _tensors(args)
        if kwargs:
            ins += _tensors(kwargs.values())
        outs = [out] if isinstance(out, torch.Tensor) else _tensors(out) \
            if isinstance(out, (list, tuple)) else []
        c = self.counts
        c.ops += 1
        f = tx = 0.0
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            c.by_op[packet.__name__] += f
        elif packet in _TRANSCENDENTAL:
            tx = sum(o.numel() for o in outs)
        elif torch.Tag.pointwise in func.tags:
            f = sum(o.numel() for o in outs)
        b = 0.0
        if not (func.is_view or packet in _NO_TRAFFIC):
            b = sum(t.numel() * t.element_size() for t in ins + outs)
        c.flops += f
        c.transcendentals += tx
        c.bytes += b
        lays = [self.layouts.get(t) for t in ins]
        for t, lay in zip(ins, lays):
            if lay is not None and any(lay.dims) and t.grad_fn is not None:
                self._node_outs.setdefault(t.grad_fn, {})[
                    tuple(t.shape)] = lay.dims
        node = torch._C._current_autograd_node()
        # an op that reads nothing laid out, outside a backward node that
        # has layouts to give, is replicated and lays nothing out
        if any(l is not None for l in lays) \
                or (node is not None and self._grad_dims(node)):
            key = self._propagate(func, packet, args, kwargs, ins, outs,
                                  [l if l is not None
                                   else Layout((_NONE,) * t.dim())
                                   for t, l in zip(ins, lays)], node)
        else:                       # nothing laid out: replicated
            key = _REPLICATED
        self._add(key, f, b, tx)
        made = self._made
        if made is not None and ins and ins[0] is made[0] and outs \
                and (func.is_view or packet in _RESHAPES):
            self._made = (outs[0],) + made[1:]       # a view of it
        else:
            self._made = (outs[0], key, f, b, tx) if outs and (
                not ins or (packet in _PRODUCTS and node is None)) else None
        return out

    def _add(self, key, f, b, tx, sign=1.0):
        share = self.counts.shares.get(key)
        if share is None:
            share = self.counts.shares[key] = [0.0, 0.0, 0.0]
        share[0] += sign * f
        share[1] += sign * b
        share[2] += sign * tx

    # -- propagation ----------------------------------------------------

    def _grad_dims(self, node) -> Dict[Tuple[int, ...], Tuple[Labels, ...]]:
        """The layouts by shape of the tensors whose gradients the
        backward ``node`` takes and gives: its forward op's outputs and
        inputs."""
        cands = self._node_cands.get(node)
        if cands is None:
            cands = {}
            for f, _ in node.next_functions:
                cands.update(self._node_outs.get(f, {}))
            cands.update(self._node_outs.get(node, {}))
            self._node_cands[node] = cands
        return cands

    def _propagate(self, func, packet, args, kwargs, ins, outs, lays,
                   node=None) -> ShareKey:
        """Set the layouts of ``outs`` and return the op's class. In the
        backward (``node``), an output laid out on no axis takes the
        layout of the forward tensor of its shape that the node's
        gradients belong to: a cotangent is laid out as its primal."""
        extra: Labels = _NONE       # axes of contracted/gathered dims
        leaf = next((l.leaf for l in lays if l.leaf is not None), None)
        times, grad_of = (), None
        if packet in _PRODUCTS and len(ins) >= 2:
            extra, dims, grad_of = self._product(packet, ins, lays,
                                                 outs[0], node)
            out_dims = [dims]
        elif packet is aten.index and ins and lays[0].leaf is not None \
                and len(ins) == 2:
            # a table lookup: rows gathered from a parameter
            src, idx = lays
            extra = src.dims[0] if src.dims else _NONE
            out_dims = [idx.dims + src.dims[1:]]
            if node is None:
                self._lookup(ins[1], src, idx, outs[0], extra)
        elif func.is_view or packet in _RESHAPES:
            src = ins[0] if ins else None
            out_dims = [self._view_dims(packet, args, src,
                                        lays[0] if lays else None, o)
                        for o in outs]
            if lays:
                times = lays[0].times
        elif packet in _REDUCTIONS and len(ins) == 1:
            red = _reduced(func, args, kwargs, ins[0].dim())
            d = lays[0].dims
            kept = [lab for k, lab in enumerate(d) if k not in red]
            out_dims = []
            for o in outs:
                if o.dim() == len(d):      # keepdim
                    out_dims.append(tuple(_NONE if k in red else lab
                                          for k, lab in enumerate(d)))
                elif o.dim() == len(kept):
                    out_dims.append(tuple(kept))
                else:
                    out_dims.append((_NONE,) * o.dim())
        elif packet in _NEW and outs[0].shape != ins[0].shape:
            out_dims = [(_NONE,) * outs[0].dim()]   # a template's dtype
        elif packet is aten.cat and ins:
            out_dims = [tuple(_union([l.dims[k] for l in lays
                                      if len(l.dims) == outs[0].dim()])
                              for k in range(outs[0].dim()))]
        else:
            pairs = [(tuple(t.shape), l.dims) for t, l in zip(ins, lays)]
            out_dims = [_broadcast(tuple(o.shape), tuple(pairs))
                        for o in outs]
        if node is not None:
            cands = self._grad_dims(node)
            out_dims = [d if any(d) else cands.get(tuple(o.shape), d)
                        for o, d in zip(outs, out_dims)]
        labels = set(extra)
        for l in lays:
            for lab in l.dims:
                labels |= lab
        for d in out_dims:
            for lab in d:
                labels |= lab
        bs = frozenset(n for a, n in labels if a == "batch")
        ms = frozenset(n for a, n in labels if a == "model")
        out_leaf = leaf if grad_of is None and not bs else grad_of
        for o, d in zip(outs, out_dims):
            # an unset layout reads as one on no axis: a new tensor that
            # would carry none gets none
            if any(d) or out_leaf is not None or times \
                    or any(o is t for t in ins):
                self.layouts[o] = Layout(d, out_leaf, times)
        return bs, ms, (leaf if not bs else None)

    def _product_dims(self, packet, ins, lays, out):
        a, la, lb = ins[-2], lays[-2].dims, lays[-1].dims
        if a.dim() == 2:
            dims = (la[0], lb[1])
        else:
            dims = (la[0] | lb[0], la[1], lb[2])
        if _PRODUCTS[packet]:       # addmm / baddbmm: the bias broadcast
            bias = _broadcast(tuple(out.shape),
                              ((tuple(ins[0].shape), lays[0].dims),))
            dims = tuple(x | y for x, y in zip(dims, bias))
        return dims

    def _product(self, packet, ins, lays, out, node):
        """(the contraction's axes, the output's dims, and the leaf whose
        gradient it is or None). Marks the activation operand of a
        weight product, records a forward one whose contraction carries
        ``model``, and splits the output's last dimension over ``model``
        where neither the weight nor the activation's free dimensions
        carry it and the output is ``residual`` wide (the reference's
        partitioner splits a weight product over ``model`` by the
        weight, the contraction or else, for the residual stream, the
        output features; it replicates an expert product whose experts
        do not divide ``model``, and xlstm's q/k/v projections)."""
        a, b = ins[-2], ins[-1]
        la, lb = lays[-2], lays[-1]
        contraction = la.dims[-1] | lb.dims[-2]
        dims = self._product_dims(packet, ins, lays, out)
        if (la.leaf is None) != (lb.leaf is None):
            w, wl, x, xl = (b, lb, a, la) if lb.leaf is not None \
                else (a, la, b, lb)
            entry = (wl.leaf, tuple(w.shape), wl.dims)
            if entry not in xl.times:
                self.layouts[x] = xl._replace(times=xl.times + (entry,))
            ms = frozenset(n for ax, n in contraction if ax == "model")
            if ms and node is None:
                self.counts.products[Product(
                    wl.leaf[0], tuple(out.shape), dims, out.element_size(),
                    tuple(x.shape), xl.dims, x.element_size(), ms,
                    x.is_floating_point())] += 1
            free = wl.dims + (xl.dims[:-1] if x is a else xl.dims[:-2]
                              + xl.dims[-1:])
            if not any(ax == "model" for lab in free for ax, _ in lab) \
                    and self.residual == int(out.shape[-1]):
                last = frozenset({("model", int(out.shape[-1]))})
                dims = dims[:-1] + (dims[-1] | last,)
            return contraction, dims, None
        if la.leaf is None and lb.leaf is None:
            shape = tuple(out.shape)
            for lay in (la, lb):
                for leaf, wshape, wdims in lay.times:
                    if wshape == shape:
                        self._relayout_dims(out, dims, wdims)
                        return contraction | _union(wdims), wdims, leaf
        return contraction, dims, None

    def _lookup(self, idx, src, idxl, out, extra):
        """Record a forward table lookup whose rows lie over ``model``:
        a product with the one-hot tokens, contracted over the rows."""
        ms = frozenset(n for ax, n in extra if ax == "model")
        if ms:
            dims = idxl.dims + src.dims[1:]
            self.counts.products[Product(
                src.leaf[0], tuple(out.shape), dims, out.element_size(),
                tuple(idx.shape), idxl.dims, idx.element_size(), ms,
                False)] += 1

    def _view_dims(self, packet, args, src, lay, o):
        """The dims of a view ``o`` of ``src`` laid out as ``lay``."""
        if src is None or lay is None:
            return (_NONE,) * o.dim()
        d = lay.dims
        if packet is aten.permute:
            return tuple(d[k] for k in args[1])
        if packet in (aten.transpose, aten.t):
            if src.dim() < 2:
                return d
            i, j = (args[1], args[2]) if packet is aten.transpose else (0, 1)
            i, j = i % src.dim(), j % src.dim()
            d = list(d)
            d[i], d[j] = d[j], d[i]
            return tuple(d)
        if packet is aten.select:
            k = args[1] % src.dim()
            return d[:k] + d[k + 1:]
        if packet is aten.unbind:
            k = (args[1] if len(args) > 1 else 0) % src.dim()
            return d[:k] + d[k + 1:]
        if packet is aten.expand:
            return _broadcast(tuple(o.shape), ((tuple(src.shape), d),))
        if o.dim() == src.dim() and packet not in _RESHAPES:
            return d                 # slice, narrow, split, as_strided
        return _reshape(tuple(src.shape), d, tuple(o.shape))


# -- seeds and shares ---------------------------------------------------

# a mesh on which every axis divides every dimension: a spec on it names
# the axes a rule gives, before a real mesh drops those that do not divide
_LOGICAL_MESH = {"data": 1, "model": 1}


def _spec_dims(shape, spec, labels) -> Tuple[Labels, ...]:
    """The dims of ``shape`` under ``spec`` (one entry a dimension of
    ``shape``): each mesh axis in ``labels`` (``{"model": "model"}``)
    put on its dimension as that logical axis."""
    return tuple(frozenset((labels[a], int(n)) for a in shd._parts(e)
                           if a in labels)
                 for n, e in zip(shape, spec))


def param_layout(path: str, stacked, shape) -> Layout:
    """A parameter's layout: one period of the reference leaf at ``path``
    (``stacked``, leading with the period count where the leaf is
    stacked), ``model`` on the dimensions its spec puts it on."""
    spec = shd.param_pspec(path, stacked, _LOGICAL_MESH)
    spec = tuple(spec) + (None,) * (len(stacked) - len(spec))
    return Layout(_spec_dims(shape, spec[len(stacked) - len(shape):],
                             {"model": "model"}),
                  (path, tuple(stacked)))


def _cache_dims(shape, batch_size: int) -> Tuple[Labels, ...]:
    """A decode-state leaf's dims from ``sharding.cache_pspec``: the
    batch axes as ``batch``, ``model`` as ``model``."""
    spec = shd.cache_pspec(_LOGICAL_MESH, shape, batch_size, "hybrid")
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return _spec_dims(shape, spec, {"data": "batch", "model": "model"})


def step_seeds(model, params=None, opt=None, batch=None, tokens=None,
               state=None, max_seq: int = 1) -> dict:
    """The layouts a step's inputs start with: the model's parameters
    (and ``params``, the tensors the step is given), AdamW's moments and
    error of each, the batch and decode tokens (batch on dimension 0) and
    the decode state at ``max_seq`` (``cache_pspec``'s layout,
    ``state_leaves``' names and shapes)."""
    from repro_torch.models.attention import KVCache
    seeds = {}
    named = dict(model.named_parameters())
    trees = [named] + [t for t in (params,) if t is not None]
    if opt is not None:
        trees += [t for t in (opt.mu, opt.nu, opt.error)
                  if isinstance(t, dict)]
    for name, path, stacked, _ in shd.param_leaves(model):
        lay = param_layout(path, stacked, named[name].shape)
        for tree in trees:
            if name in tree:
                seeds[tree[name]] = lay
    for t in list((batch or {}).values()) + [tokens]:
        if t is not None:
            seeds[t] = Layout(dims_of(t.shape, ("batch",)))
    if state is not None:
        ref = {name: shp for name, _, shp, _ in shd.state_leaves(
            model.cfg, tokens.shape[0], max_seq)}
        for layer, cache in enumerate(state.caches):
            for f, t in zip(cache._fields, cache):
                d = _cache_dims(ref[f"caches.{layer}.{f}"],
                               tokens.shape[0])[1:]
                if isinstance(cache, KVCache):
                    d = (d[0], d[2], d[1], d[3])
                seeds[t] = Layout(d)
        for f in ("enc_out", "enc_pos"):
            t = getattr(state, f)
            if t is not None:
                seeds[t] = Layout(_cache_dims(tuple(t.shape),
                                             tokens.shape[0]))
    return seeds


def share_divisor(key: ShareKey, mesh, mode: Optional[str] = None) -> int:
    """The chips an op of class ``key`` is split over on ``mesh``: a
    parameter-only op over its leaf's shards; else the batch axes where
    they divide one of its batch sizes, times ``model`` where it divides
    one of its model sizes (and the batch does not already use it)."""
    bs, ms, leaf = key
    if leaf is not None:
        return math.prod(shd._size(mesh, e)
                         for e in shd.param_pspec(leaf[0], leaf[1], mesh,
                                                  mode))
    ax = shd.AxisNames(mesh, mode)
    div, used = 1, ()
    if ax.batch is not None:
        b = shd._size(mesh, ax.batch)
        if b > 1 and any(n % b == 0 for n in bs):
            div, used = b, shd._parts(ax.batch)
    m = mesh.get("model", 1)
    if ax.model and ax.model not in used and m > 1 \
            and any(n % m == 0 for n in ms):
        div *= m
    return div


def per_chip(counts: OpCounts, mesh, mode: Optional[str] = None
             ) -> Tuple[float, float, float]:
    """(FLOPs, bytes, transcendentals) on one chip of ``mesh``: each
    class's share over the chips that split it. The shares add up to the
    global counts, so a 1×1 mesh gives those back (to rounding)."""
    divs = [(share, share_divisor(key, mesh, mode))
            for key, share in counts.shares.items()]
    return tuple(math.fsum(share[k] / div for share, div in divs)
                 for k in range(3))


def count_ops(fn, *args, seeds=None, residual: Optional[int] = None,
              **kwargs) -> OpCounts:
    """Counts of ``fn(*args, **kwargs)`` (meta tensors, or any), its
    inputs laid out by ``seeds``; ``residual`` as ``OpCounter``'s."""
    with OpCounter(seeds, residual) as counter:
        fn(*args, **kwargs)
    return counter.counts
