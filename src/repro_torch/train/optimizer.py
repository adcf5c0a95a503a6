"""AdamW with global-norm clipping, cosine schedule, and optional int8
error-feedback gradient compression, PyTorch port of
repro/train/optimizer.py.

The compression is a distributed-optimisation feature: the all-reduce
payload shrinks 4x, and the quantisation residual is carried forward so
the compression is unbiased over time.

Functions over trees (dicts, NamedTuples, tuples and lists of tensors,
walked as ``train/checkpoint.py`` walks them), in float32 and in the
reference's expression order; nothing is updated in place.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.train.checkpoint import _flatten_with_paths, _map_with_paths


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # gradient compression: "none" | "int8"
    compression: str = "none"


class OptState(NamedTuple):
    step: torch.Tensor     # int32, 0-d
    mu: Any
    nu: Any
    error: Any             # error-feedback residual (int8 only), else None


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the leaves at the same paths
    of ``rest``; the result has ``tree``'s structure."""
    others = [dict(_flatten_with_paths(t)) for t in rest]
    return _map_with_paths(tree,
                           lambda k, x: fn(x, *(o[k] for o in others)))


def _leaves(tree):
    return [x for _, x in _flatten_with_paths(tree)]


def init_opt_state(params, cfg: AdamWConfig) -> OptState:
    """Zero moments (and residual, with int8 compression) on the params'
    device."""
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    err = tree_map(torch.clone, zeros) if cfg.compression != "none" \
        else None
    device = _leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=zeros, nu=tree_map(torch.clone, zeros), error=err)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    stepf = torch.as_tensor(step).to(torch.float32)
    warm = stepf / max(cfg.warmup_steps, 1)
    prog = torch.clamp((stepf - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.minimum(warm, cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in _leaves(tree)))


def quantize_int8(g_ef: torch.Tensor):
    """(int8 codes, float32 scale) of one leaf: ``scale = max|g| / 127``,
    codes rounded half to even and clipped to ±127."""
    peak = torch.clamp_min(torch.max(torch.abs(g_ef)), 1e-12)
    # by a tensor: CUDA divides by a Python scalar as a product with its
    # reciprocal, which can round the scale, and so the codes, otherwise
    scale = peak / torch.full_like(peak, 127.0)
    q = torch.clamp(torch.round(g_ef / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_int8(g, error):
    """Error-feedback int8 quantisation of one leaf: returns
    ``(dequantised gradient, new residual)``."""
    g_ef = g + error
    q, scale = quantize_int8(g_ef)
    deq = q.to(torch.float32) * scale
    return deq, g_ef - deq


def apply_updates(params, grads, state: OptState, cfg: AdamWConfig):
    """One AdamW step. Returns (new_params, new_state, metrics)."""
    step = state.step + 1

    if cfg.compression == "int8":
        error = dict(_flatten_with_paths(state.error))
        pairs = {k: compress_int8(g, error[k])
                 for k, g in _flatten_with_paths(grads)}
        grads = _map_with_paths(grads, lambda k, _: pairs[k][0])
        new_error = _map_with_paths(grads, lambda k, _: pairs[k][1])
    else:
        new_error = state.error

    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                            1.0)
    grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)

    b1, b2 = cfg.b1, cfg.b2
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    c1 = 1 - b1 ** step.to(torch.float32)
    c2 = 1 - b2 ** step.to(torch.float32)
    lr = lr_at(cfg, step)

    def upd(p, m, v):
        u = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        return (p.to(torch.float32)
                - lr * (u + cfg.weight_decay * p.to(torch.float32))
                ).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_params, OptState(step=step, mu=mu, nu=nu, error=new_error), \
        metrics
