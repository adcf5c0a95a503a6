"""Mixture-of-Experts with static-shape sort-based dispatch, PyTorch port
of repro/models/moe.py.

router -> top-k -> flatten the (token, slot) assignments -> stable sort
by expert -> each assignment's rank within its expert (``searchsorted``)
-> scatter into a capacity-bounded ``[G, E, C, d]`` buffer (ranks past
the capacity drop) -> per-expert gated products -> gather back, weighted
combine. Every shape is static and nothing is read back to the host, so
a decode step makes no host sync.

Token groups: the ``T`` tokens are split into ``G = gcd(T, num_groups)``
groups and each is dispatched on its own, as the reference does per
data shard. The reference's sharding hints sit where it has them
(``distributed.sharding.hint``): they return their input, and only the
dry-run's counter reads the layouts they name.

Ties and drops, as the reference has them:

* ``jax.lax.top_k`` keeps the lower index on ties; ``torch.topk``
  promises no order, so the top k are the head of a stable descending
  sort;
* the reference scatters with ``mode="drop"``, sending a dropped slot to
  ``(E − 1, C)``, out of bounds. ``index_put`` has no drop mode, so the
  buffer carries one spare row after its ``G·E·C`` rows: every dropped
  slot writes there, and the products read only the rows before it.
  Kept ``(g, e, r)`` triples are distinct, so the kept rows' writes are
  deterministic.

Supports shared experts (DeepSeek-V2), a dense-residual FFN in parallel
(Arctic), first-k-dense layers (``transformer.layer_specs``) and the
load-balancing auxiliary loss (GShard). The reference's ``init_moe`` and
``apply_moe`` are ``MoE(key, ...)`` and ``MoE.forward``; its one-group
``_dispatch_one_group``/``_combine_one_group`` are ``group_indices``,
``dispatch`` and ``combine`` with a group axis of 1.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import random as prng
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed.sharding import hint
from repro_torch.models.layers import MLP, parameter


class Routing(NamedTuple):
    """One group's routing, each ``[G, Tg, k]`` but ``aux`` ``[G]``."""

    e_idx: torch.Tensor    # int64 expert of each slot; E − 1 if dropped
    r_idx: torch.Tensor    # int64 rank within the expert; C if dropped
    top_p: torch.Tensor    # float32 renormalised top-k probabilities
    keep: torch.Tensor     # bool: the slot fits the capacity
    aux: torch.Tensor      # float32 load-balancing term per group


def _capacity(tokens_per_group: int, m: MoEConfig) -> int:
    c = int(math.ceil(tokens_per_group * m.top_k * m.capacity_factor
                      / m.num_experts))
    # the reference keeps it a nonzero multiple of 8
    c = max(8, ((c + 7) // 8) * 8)
    return min(c, tokens_per_group)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    the lower index first among equals (a stable descending sort keeps
    equal values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def group_indices(logits: torch.Tensor, k: int, capacity: int) -> Routing:
    """The reference's ``group_indices`` over ``[G, Tg, E]`` logits (in the
    compute dtype): softmax in float32, top-k, ranks within each expert
    in (token, slot) order, the capacity drop, and the aux-loss term
    ``E · Σ_e f_e · p_e`` with ``f_e`` the share of tokens whose largest
    logit is expert ``e`` (first index on ties, ``jnp.argmax``)."""
    G, Tg, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = top_k(probs, k)                              # [G, Tg, k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    flat_e = top_e.reshape(G, Tg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    # rank within expert = position − first position of that expert
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(Tg * k, device=logits.device).expand(G, -1)
    ranks = torch.empty_like(flat_e).scatter_(1, order, pos - first)
    ranks = ranks.view(G, Tg, k)
    keep = ranks < capacity
    e_idx = torch.where(keep, top_e, E - 1)
    r_idx = torch.where(keep, ranks, capacity)
    # jnp.mean(one_hot(top1)) and jnp.mean(probs): sums divided by Tg
    top1 = torch.argmax(logits, dim=-1)                        # [G, Tg]
    hits = torch.zeros(G, E, device=logits.device).scatter_add_(
        1, top1, torch.ones(G, Tg, device=logits.device))
    f_e = hits / Tg
    p_e = probs.sum(dim=1) / Tg
    aux = E * torch.sum(f_e * p_e, dim=-1)
    return Routing(e_idx, r_idx, top_p, keep, aux)


def routing_margin(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's float32 gap between its k-th and (k+1)-th routing
    probability (``inf`` when every expert is chosen): two runs whose
    logits differ in the last bits may route a token with a small gap
    differently."""
    probs = torch.softmax(logits.float(), dim=-1)
    if k >= probs.shape[-1]:
        return torch.full(probs.shape[:-1], float("inf"),
                          device=probs.device)
    top = top_k(probs, k + 1)[0]
    return top[..., k - 1] - top[..., k]


def _slot_rows(r: Routing, E: int, capacity: int) -> torch.Tensor:
    """Row of each slot in the flat ``[G·E·C + 1, d]`` buffer: kept slots
    at ``(g·E + e)·C + r``, dropped ones at the spare last row."""
    G = r.e_idx.shape[0]
    g = torch.arange(G, device=r.e_idx.device).view(G, 1, 1)
    rows = (g * E + r.e_idx) * capacity + r.r_idx
    return torch.where(r.keep, rows, G * E * capacity)


def dispatch(x: torch.Tensor, r: Routing, E: int,
             capacity: int) -> torch.Tensor:
    """x ``[G, Tg, d]`` → the ``[G, E, C, d]`` dispatch buffer: each kept
    slot's token copied to its (expert, rank) row, other rows zero. The
    reference's ``.at[g, e, r].set(repeat(x, k), mode="drop")``."""
    G, Tg, d = x.shape
    k = r.e_idx.shape[-1]
    # jnp.repeat(x, k, axis=1): each token k times in a row
    xk = hint(x.unsqueeze(2).expand(G, Tg, k, d).reshape(G, Tg * k, d),
              "batch", None, None)
    buf = x.new_zeros(G * E * capacity + 1, d)
    buf = buf.index_put((_slot_rows(r, E, capacity).reshape(-1),),
                        xk.reshape(-1, d))
    return hint(buf[:-1].view(G, E, capacity, d), "batch", "model", None,
                None)


def combine(out_buf: torch.Tensor, r: Routing) -> torch.Tensor:
    """The expert outputs ``[G, E, C, d]`` back to ``[G, Tg, d]``: each
    slot gathers its row at ``clip(r_idx, 0, C − 1)`` and the slots are
    summed with their probabilities, dropped slots weighted 0
    (``einsum("gtkd,gtk->gtd")``). The sum is XLA's: slot by slot, each
    product added with one rounding (a float32 fused multiply-add,
    exact in float64), then rounded once to the compute dtype, so the
    combine equals the reference's bit for bit on the same inputs."""
    G, E, C, d = out_buf.shape
    g = torch.arange(G, device=out_buf.device).view(G, 1, 1)
    rows = (g * E + r.e_idx) * C + torch.clamp(r.r_idx, 0, C - 1)
    gathered = hint(out_buf.reshape(G * E * C, d)[rows],       # [G, Tg, k, d]
                    "batch", None, None, None)
    w = torch.where(r.keep, r.top_p, 0.0).to(out_buf.dtype).double()
    acc = torch.zeros(gathered.shape[:2] + (d,), dtype=torch.float32,
                      device=out_buf.device)
    for j in range(gathered.shape[2]):
        acc = (acc.double() + gathered[:, :, j].double()
               * w[:, :, j, None]).float()
    return hint(acc.to(out_buf.dtype), "batch", None, None)


class MoE(nn.Module):
    """The reference's MoE parameters: ``router [d, E]``, ``w_gate`` and
    ``w_up [E, d, f]``, ``w_down [E, f, d]``, and ``shared`` (the shared
    experts as one MLP of ``shared_d_ff · num_shared_experts``) and
    ``dense`` (Arctic's residual MLP) where the config has them."""

    def __init__(self, key, cfg: ModelConfig, m: MoEConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg, self.m = cfg, m
        ks = prng.split(key, 6) if key is not None else [None] * 6
        d, f, E = cfg.d_model, m.expert_d_ff, m.num_experts
        s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
        self.router = parameter(ks[0], (d, E), s_in, device, dtype)
        self.w_gate = parameter(ks[1], (E, d, f), s_in, device, dtype)
        self.w_up = parameter(ks[2], (E, d, f), s_in, device, dtype)
        self.w_down = parameter(ks[3], (E, f, d), s_out, device, dtype)
        if m.num_shared_experts:
            self.shared = MLP(ks[4], d, m.shared_d_ff * m.num_shared_experts,
                              cfg.activation, device, dtype)
        if m.dense_residual:
            self.dense = MLP(ks[5], d, m.dense_residual_d_ff,
                             cfg.activation, device, dtype)

    def route(self, x: torch.Tensor, num_groups: int = 1):
        """x ``[B, S, d]`` → (tokens ``[G, Tg, d]``, ``Routing``,
        capacity)."""
        B, S, d = x.shape
        T = B * S
        G = math.gcd(T, num_groups)          # decode batches may be tiny
        tg = T // G
        capacity = _capacity(tg, self.m)
        xg = hint(x.reshape(G, tg, d), "batch", None, None)
        logits = hint(xg @ self.router.to(x.dtype), "batch", None, None)
        return xg, group_indices(logits, self.m.top_k, capacity), capacity

    def forward(self, x: torch.Tensor, num_groups: int = 1):
        """x ``[B, S, d]`` → (y ``[B, S, d]``, aux loss float32 0-d)."""
        dtype = x.dtype
        xg, r, capacity = self.route(x, num_groups)
        buf = dispatch(xg, r, self.m.num_experts, capacity)
        h = buf @ self.w_gate.to(dtype)                        # [G, E, C, f]
        u = buf @ self.w_up.to(dtype)
        if self.cfg.activation in ("swiglu", "silu"):
            act = F.silu(h) * u
        else:
            act = F.gelu(h, approximate="tanh") * u
        out_buf = hint(act @ self.w_down.to(dtype), "batch", "model", None,
                       None)
        y = combine(out_buf, r).reshape(x.shape)
        if self.m.num_shared_experts:
            y = y + self.shared(x)
        if self.m.dense_residual:
            y = y + self.dense(x)
        return y, torch.mean(r.aux) * self.m.router_aux_loss
