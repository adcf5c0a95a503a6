"""Shared model layers: norms, rotary embeddings (RoPE / M-RoPE /
sinusoidal), MLPs, embeddings. PyTorch port of repro/models/layers.py.

Parameters are float32 masters and are cast to the compute dtype
(``cfg.dtype``) where they are applied, as the reference does. The
arithmetic follows jax's promotion: a bf16 activation times a float32
tensor computes in float32 (rope, norms); a bf16 activation times a
Python scalar stays bf16, with the scalar rounded to bf16 first, which
torch does only for a tensor of that dtype (``scalar_like``).

Norms, MLPs and embedding tables are ``nn.Module``s whose parameters
carry the reference's names and layouts; positional encodings are
functions on tensors. A module built with ``key=None`` holds
uninitialised parameters, to be loaded (``repro_torch.interop``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import random as prng
from repro_torch.configs.base import AttentionConfig


# a leaf larger than this many elements is drawn slab by slab: a draw's
# int64 counters and threefry temporaries take ~50 bytes an element, so
# one 1.3e9–4.5e9-element expert leaf drawn at once would not fit the card
INIT_SLAB = 1 << 25


def truncated_normal(key, shape, scale, device, dtype=torch.float32,
                     slab: int = INIT_SLAB) -> torch.Tensor:
    """``(scale · truncated_normal(key, −2, 2, shape)).to(dtype)``: the
    float32 draw, cast once. A leaf of more than ``slab`` elements is
    drawn slab by slab (``random.truncated_normal``'s ``start``) into its
    ``dtype`` storage, so the draw needs the leaf plus one slab's
    temporaries and gives the same bits as one draw."""
    n = math.prod(shape)
    if n <= slab:
        return (scale * prng.truncated_normal(key, -2.0, 2.0, shape,
                                              device)).to(dtype)
    out = torch.empty(n, dtype=dtype, device=device)
    for s0 in range(0, n, slab):
        m = min(slab, n - s0)
        out[s0:s0 + m] = scale * prng.truncated_normal(
            key, -2.0, 2.0, (m,), device, start=s0)
    return out.view(tuple(shape))


def parameter(key, shape, scale, device,
              dtype=torch.float32) -> nn.Parameter:
    """A parameter drawn as the reference draws it and stored in ``dtype``
    (float32 masters by default), or left uninitialised when ``key`` is
    None."""
    if key is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    return nn.Parameter(truncated_normal(key, shape, scale, device, dtype))


def scalar_like(value: float, x: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``x``'s dtype and device: jax rounds a
    Python scalar to a bf16 operand's dtype before the product, torch
    does not (a fill kernel, no copy from the host)."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """rmsnorm in float32 with a float32 ``scale``, cast back."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


class Norm(nn.Module):
    """rmsnorm (``scale``), layernorm (``scale``, ``bias``) or
    nonparametric_ln (OLMo: no learned affine), computed in float32 and
    cast back."""

    def __init__(self, kind: str, dim: int, device=None, eps: float = 1e-5):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm", "nonparametric_ln"):
            raise ValueError(kind)
        self.kind, self.eps = kind, eps
        if kind in ("rmsnorm", "layernorm"):
            self.scale = nn.Parameter(torch.ones(dim, device=device))
        if kind == "layernorm":
            self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "rmsnorm":
            return rmsnorm(x, self.scale, self.eps)
        xf = x.float()
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        if self.kind == "layernorm":
            y = y * self.scale + self.bias
        return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """float32 ``(cos, sin)`` of ``[..., S, 1, head_dim/2]`` for positions
    ``[..., S]``: computed once per forward and shared by every layer."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def mrope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: tuple):
    """M-RoPE (Qwen2-VL) tables for positions ``[..., S, 3]`` = (t, h, w):
    the half-dim frequency bands are split into ``sections`` (sum ==
    head_dim // 2), each rotated by its own position component."""
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_frequencies(head_dim, theta, positions.device)
    comp = torch.cat([torch.full((s,), i, dtype=torch.int64,
                                 device=positions.device)
                      for i, s in enumerate(sections)])
    pos_per_band = torch.take_along_dim(
        positions.float(), comp.expand(positions.shape[:-1] + (half,)),
        dim=-1)                                       # [..., S, half]
    angles = pos_per_band * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x ``[..., S, H, D]`` rotated by float32 tables: the products run in
    float32 (jax promotes bf16 × float32) and the result is cast back."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def apply_mrope(x, positions, theta: float, sections: tuple):
    return rotate(x, *mrope_tables(positions, x.shape[-1], theta, sections))


def sinusoidal_positions(positions: torch.Tensor, d_model: int):
    half = d_model // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                            device=positions.device)
                               / half))
    angles = positions[..., None].float() * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def positional_tables(att: AttentionConfig, positions: torch.Tensor):
    """The rotation tables of ``att.rope`` for ``positions``: ``"rope"``
    over ``qk_rope_head_dim`` for MLA, ``head_dim`` otherwise, positions
    ``[..., S]``; ``"mrope"`` over ``head_dim`` by ``mrope_sections``,
    positions ``[..., S, 3]``; None for ``"none"`` and ``"sinusoidal"``
    (added at the embedding, not in attention), as the reference's
    ``apply_positional``. A cross-attention's keys take the tables of the
    encoder memory's own positions (``enc_pos``), as the reference
    rotates them."""
    if att.rope == "rope":
        dim = att.qk_rope_head_dim if att.kind == "mla" else att.head_dim
        return rope_tables(positions, dim, att.rope_theta)
    if att.rope == "mrope":
        return mrope_tables(positions, att.head_dim, att.rope_theta,
                            att.mrope_sections)
    return None


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """swiglu / geglu (``w_gate``, ``w_up``, ``w_down``) or gelu (``w_up``,
    ``w_down``), weights ``[d_model, d_ff]`` and ``[d_ff, d_model]``.
    jax's ``gelu`` is the tanh approximation."""

    def __init__(self, key, d_model: int, d_ff: int, activation: str,
                 device=None, dtype=torch.float32):
        super().__init__()
        if activation not in ("swiglu", "geglu", "gelu"):
            raise ValueError(activation)
        self.activation = activation
        gated = activation in ("swiglu", "geglu")
        ks = prng.split(key, 3) if key is not None else [None] * 3
        s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
        if gated:
            self.w_gate = parameter(ks[0], (d_model, d_ff), s_in, device,
                                    dtype)
        self.w_up = parameter(ks[1 if gated else 0], (d_model, d_ff), s_in,
                              device, dtype)
        self.w_down = parameter(ks[2 if gated else 1], (d_ff, d_model),
                                s_out, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        if self.activation == "gelu":
            h = F.gelu(x @ self.w_up.to(dtype), approximate="tanh")
        else:
            g = x @ self.w_gate.to(dtype)
            u = x @ self.w_up.to(dtype)
            act = F.silu(g) if self.activation == "swiglu" \
                else F.gelu(g, approximate="tanh")
            h = act * u
        return h @ self.w_down.to(dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


class Embedding(nn.Module):
    """A ``[vocab, d_model]`` table (``table``); 1/sqrt(d) keeps tied
    unembedding logits O(1) at init."""

    def __init__(self, key, vocab: int, d_model: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.table = parameter(key, (vocab, d_model),
                               1.0 / math.sqrt(d_model), device, dtype)


def embed(emb: Embedding, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The reference casts the whole table, then gathers; the cast is
    elementwise, so gathering first gives the same bits for
    ``tokens.numel()`` rows of work instead of ``vocab``."""
    return emb.table[tokens.long()].to(dtype)
