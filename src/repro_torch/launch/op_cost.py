"""Operation counts of an eager PyTorch step, in place of the reference's
``launch/hlo_cost.py``.

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

Collective bytes are not counted: a one-process eager run issues no
collectives (``RooflineReport.t_collective`` is None).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

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


@dataclass
class OpCounts:
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes: float = 0.0
    ops: int = 0
    by_op: Dict[str, float] = field(default_factory=Counter)  # matmul-like


def _tensor_bytes(xs) -> int:
    leaves, _ = tree_flatten(xs)
    return sum(x.numel() * x.element_size() for x in leaves
               if isinstance(x, torch.Tensor))


def _numel(xs) -> int:
    leaves, _ = tree_flatten(xs)
    return sum(x.numel() for x in leaves if isinstance(x, torch.Tensor))


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: step(...)``, then ``c.counts``."""

    def __init__(self):
        super().__init__()
        self.counts = OpCounts()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        c = self.counts
        c.ops += 1
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            c.flops += f
            c.by_op[packet.__name__] += f
        elif packet in _TRANSCENDENTAL:
            c.transcendentals += _numel(out)
        elif torch.Tag.pointwise in func.tags:
            c.flops += _numel(out)
        if not (func.is_view or packet in _NO_TRAFFIC):
            c.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def count_ops(fn, *args, **kwargs) -> OpCounts:
    """Counts of ``fn(*args, **kwargs)`` (meta tensors, or any)."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.counts
