"""Attention: GQA (optional QKV bias, RoPE / M-RoPE), MLA (DeepSeek-V2)
and GQA cross-attention over an encoder memory, in two regimes, PyTorch
port of repro/models/attention.py:

* ``train/prefill`` — memory-efficient chunked attention (a flash-style
  running softmax over KV blocks, looped over Q blocks), in plain torch
  ops as the reference's is plain jnp;
* ``decode`` — a one-token query against a KV cache written in place at
  a device-side position (``index_copy_``), so a decode step reads
  nothing back to the host; windowed layers keep a ring cache of
  ``att.window`` slots.

Heads are grouped, not repeated: head ``h`` reads KV head ``h // rep``
(``jnp.repeat``'s order), and the products contract the same elements
over ``[B, Hkv, ·]`` without copying K/V ``rep`` times. The cache is
kept ``[B, Hkv, S_max, D]`` so a decode step's products read it in
place; ``repro_torch.interop`` converts from the reference's
``[B, S_max, Hkv, D]``.

MLA (``MLA``) keeps a latent cache: ``c_kv [B, S_max, kv_lora]`` and
``k_rope [B, S_max, qk_rope]``, the reference's layout. Its prefill
materialises per-head K/V from the latent and runs the same chunked
attention (q/k width ``qk_nope + qk_rope``, v width ``v_head_dim``,
``Hkv = H``); its decode folds the key up-projection into the query and
scores the latent cache directly (the absorb trick). ``make_attention``
builds either kind from the config.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch import random as prng
from repro_torch.configs.base import AttentionConfig
from repro_torch.distributed.sharding import hint
from repro_torch.models.layers import parameter, rotate, scalar_like

Q_CHUNK = 1024
KV_CHUNK = 1024
NEG = -1e30


def _by_kv_head(x: torch.Tensor, n_kv: int) -> torch.Tensor:
    """``[B, S, H, D]`` → ``[B, Hkv, S, rep, D]`` (a copy), head ``h`` at
    ``(h // rep, h % rep)``."""
    B, S, H, D = x.shape
    return x.view(B, S, n_kv, H // n_kv, D).permute(0, 2, 1, 3, 4) \
        .contiguous()


def _chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                       window: int = 0):
    """q: [B, Sq, H, D]; k/v: [B, Skv, Hkv, D(v)]. Running softmax over
    KV chunks, looped over Q chunks, in the reference's dtypes: scores in
    q's dtype times the scale rounded to it, the running max, sum and
    output in float32, the probabilities cast to v's dtype for the PV
    product."""
    q = hint(q, "batch", None, "model", None)
    B, Sq, H, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    rep = H // Hkv
    dev = q.device
    qc = Q_CHUNK if Sq > Q_CHUNK else Sq
    kc = KV_CHUNK if Skv > KV_CHUNK else Skv
    nq = (Sq + qc - 1) // qc
    nk = (Skv + kc - 1) // kc
    scale = scalar_like(1.0 / math.sqrt(D), q)
    qg = _by_kv_head(q, Hkv)                         # [B, Hkv, Sq, rep, D]
    heads = ("batch", ("model", H), None, None, None)  # the running state
    kg = k.permute(0, 2, 1, 3)                       # [B, Hkv, Skv, D]
    vg = v.permute(0, 2, 1, 3).contiguous()          # [B, Hkv, Skv, Dv]
    outs = []
    for qi in range(nq):
        q0 = qi * qc
        qn = min(qc, Sq - q0)
        qb = qg[:, :, q0:q0 + qn].reshape(B, Hkv, qn * rep, D)
        q_pos = q_offset + q0 + torch.arange(qn, device=dev)
        m = hint(torch.full((B, Hkv, qn, rep), NEG, dtype=torch.float32,
                            device=dev), *heads)
        l = hint(torch.zeros((B, Hkv, qn, rep), dtype=torch.float32,
                             device=dev), *heads)
        o = hint(torch.zeros((B, Hkv, qn, rep, Dv), dtype=torch.float32,
                             device=dev), *heads)
        for ki in range(nk):
            k0 = ki * kc
            kn = min(kc, Skv - k0)
            kb = kg[:, :, k0:k0 + kn]
            vb = vg[:, :, k0:k0 + kn]
            s = (qb @ kb.transpose(-1, -2)).view(B, Hkv, qn, rep, kn) \
                * scale
            kv_pos = k0 + torch.arange(kn, device=dev)
            mask = None
            if causal:
                mask = kv_pos[None, :] <= q_pos[:, None]
            if window:
                wmask = kv_pos[None, :] > q_pos[:, None] - window
                mask = wmask if mask is None else mask & wmask
            if mask is not None:
                s = torch.where(mask[:, None, :], s, NEG)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = (p.to(vb.dtype).view(B, Hkv, qn * rep, kn) @ vb) \
                .view(B, Hkv, qn, rep, Dv)
            o = o * corr[..., None] + pv
            m = m_new
        out = (o / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
        outs.append(out.permute(0, 2, 1, 3, 4).reshape(B, qn, H, Dv))
    return outs[0] if nq == 1 else torch.cat(outs, dim=1)


def _project(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """einsum("bs{d},{d}hk->bshk") as one matmul: ``w [d, H, K]``."""
    return (x @ w.to(x.dtype).flatten(1)).unflatten(-1, w.shape[1:])


class KVCache(NamedTuple):
    k: torch.Tensor     # [B, Hkv, S_max, D] (a ring when windowed)
    v: torch.Tensor


class DecodeSlot(NamedTuple):
    slot: torch.Tensor   # int64 [1]: the cache slot this token writes
    valid: torch.Tensor  # bool [S_max]: the slots it attends over


def decode_slot(pos: torch.Tensor, size: int, window: int) -> DecodeSlot:
    """Where the token at ``pos`` (int32 0-d, on the device) goes in a
    cache of ``size`` slots, and which slots it reads: the slot clamps at
    ``size − 1`` past the end, or wraps in a windowed ring. The same for
    every layer of a step, so computed once."""
    idx = torch.arange(size, device=pos.device)
    if window > 0:
        slot = torch.remainder(pos, size)
        # ring buffer: every slot written so far is in-window by
        # construction (K entries carry their absolute rotary positions)
        valid = idx < torch.clamp_max(pos + 1, size)
    else:
        slot = torch.clamp_max(pos, size - 1)
        valid = idx <= pos
    return DecodeSlot(slot=slot.long().view(1), valid=valid)


class Attention(nn.Module):
    """GQA with the reference's parameters and layouts: ``wq [d, H, D]``,
    ``wk``/``wv [d, Hkv, D]``, ``wo [H, D, d]``, and ``bq [H, D]``,
    ``bk``/``bv [Hkv, D]`` with ``att.qkv_bias``."""

    def __init__(self, key, att: AttentionConfig, d_model: int,
                 device=None, dtype=torch.float32):
        super().__init__()
        if att.kind != "gqa":
            raise ValueError(f"Attention is GQA, not {att.kind!r}")
        self.att = att
        H, Hkv, D = att.n_heads, att.n_kv_heads, att.head_dim
        ks = prng.split(key, 8) if key is not None else [None] * 8
        s = 1.0 / math.sqrt(d_model)
        self.wq = parameter(ks[0], (d_model, H, D), s, device, dtype)
        self.wk = parameter(ks[1], (d_model, Hkv, D), s, device, dtype)
        self.wv = parameter(ks[2], (d_model, Hkv, D), s, device, dtype)
        self.wo = parameter(ks[3], (H, D, d_model), 1.0 / math.sqrt(H * D),
                            device, dtype)
        if att.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(H, D, device=device))
            self.bk = nn.Parameter(torch.zeros(Hkv, D, device=device))
            self.bv = nn.Parameter(torch.zeros(Hkv, D, device=device))

    def _qkv(self, x, tables, kv=None):
        """q from ``x``; k and v from ``x`` or, for cross-attention, from
        ``kv = (k_src, v_src, kv_tables)``; the biases added; q rotated by
        ``tables`` and k by its own (``kv_tables``, or ``tables``)."""
        k_src, v_src, k_tables = (x, x, tables) if kv is None else kv
        q, k, v = (_project(w, src) for w, src in
                   ((self.wq, x), (self.wk, k_src), (self.wv, v_src)))
        if self.att.qkv_bias:
            q, k, v = (y + b.to(x.dtype) for y, b in
                       ((q, self.bq), (k, self.bk), (v, self.bv)))
        if tables is not None:
            q = rotate(q, *tables)
        if k_tables is not None:
            k = rotate(k, *k_tables)
        return q, k, v

    def _out(self, out):
        """einsum("bshk,hkd->bsd")."""
        return out.flatten(2) @ self.wo.to(out.dtype).flatten(0, 1)

    def forward(self, x, tables, *, causal: bool = True, window: int = 0,
                kv=None) -> torch.Tensor:
        """Full-sequence forward (train / prefill); ``tables`` are the
        positional rotation tables (``layers.positional_tables``). With
        ``kv = (k_src, v_src, kv_tables)`` it is cross-attention over an
        encoder memory (``causal=False``): the reference runs it so in
        decode too, a 1-token query through the same chunked softmax."""
        q, k, v = self._qkv(x, tables, kv)
        return self._out(_chunked_attention(q, k, v, causal=causal,
                                            window=window))

    def decode(self, x, cache: KVCache, at: "DecodeSlot",
               tables) -> torch.Tensor:
        """One-token decode: x ``[B, 1, d]`` written at ``at.slot`` of
        ``cache`` in place, attending over the slots ``at.valid``."""
        att = self.att
        B = x.shape[0]
        H, Hkv, D = att.n_heads, att.n_kv_heads, att.head_dim
        q, k, v = self._qkv(x, tables)
        cache.k.index_copy_(2, at.slot, k.permute(0, 2, 1, 3))
        cache.v.index_copy_(2, at.slot, v.permute(0, 2, 1, 3))
        qg = q.view(B, Hkv, H // Hkv, D)
        s = (qg @ cache.k.transpose(-1, -2)) \
            / scalar_like(math.sqrt(D), x)           # [B, Hkv, rep, S]
        s = torch.where(at.valid, s, NEG)
        p = torch.softmax(s.float(), dim=-1).to(x.dtype)
        out = (p @ cache.v).view(B, 1, H, cache.v.shape[-1])
        return self._out(out)


def gqa_init_cache(att: AttentionConfig, batch: int, max_seq: int, dtype,
                   device=None) -> KVCache:
    size = att.window if att.window else max_seq
    shape = (batch, att.n_kv_heads, size, att.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------


class MLACache(NamedTuple):
    c_kv: torch.Tensor     # [B, S_max, kv_lora] compressed latent
    k_rope: torch.Tensor   # [B, S_max, qk_rope]


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """MLA's latent norm (not ``Norm``): eps 1e-6, ``· scale`` in float32,
    cast back."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


class MLA(nn.Module):
    """Multi-head latent attention with the reference's leaves:
    ``wq_a [d, q_lora]``, ``q_norm [q_lora]``, ``wq_b [q_lora, H, qk]``,
    ``wkv_a [d, kv_lora + qk_rope]``, ``kv_norm [kv_lora]``, ``wk_b
    [kv_lora, H, qk_nope]``, ``wv_b [kv_lora, H, v]``, ``wo [H, v, d]``.
    ``q_norm`` and ``kv_norm`` apply in float32 and stay float32 under
    ``cast_for_serving`` (``keep_float32``)."""

    keep_float32 = ("q_norm", "kv_norm")

    def __init__(self, key, att: AttentionConfig, d_model: int,
                 device=None, dtype=torch.float32):
        super().__init__()
        if att.kind != "mla":
            raise ValueError(f"MLA is MLA, not {att.kind!r}")
        self.att = att
        H, qr, kr = att.n_heads, att.q_lora_rank, att.kv_lora_rank
        nope, rope, vd = (att.qk_nope_head_dim, att.qk_rope_head_dim,
                          att.v_head_dim)
        ks = prng.split(key, 8) if key is not None else [None] * 8
        s = 1.0 / math.sqrt(d_model)
        self.wq_a = parameter(ks[0], (d_model, qr), s, device, dtype)
        self.q_norm = nn.Parameter(torch.ones(qr, device=device))
        self.wq_b = parameter(ks[1], (qr, H, nope + rope),
                              1.0 / math.sqrt(qr), device, dtype)
        self.wkv_a = parameter(ks[2], (d_model, kr + rope), s, device, dtype)
        self.kv_norm = nn.Parameter(torch.ones(kr, device=device))
        self.wk_b = parameter(ks[3], (kr, H, nope), 1.0 / math.sqrt(kr),
                              device, dtype)
        self.wv_b = parameter(ks[4], (kr, H, vd), 1.0 / math.sqrt(kr),
                              device, dtype)
        self.wo = parameter(ks[5], (H, vd, d_model), 1.0 / math.sqrt(H * vd),
                            device, dtype)

    def _query(self, x, tables):
        """(q_nope ``[B, S, H, nope]``, rotated q_rope ``[B, S, H, rope]``)."""
        nope = self.att.qk_nope_head_dim
        q_lat = _rms(x @ self.wq_a.to(x.dtype), self.q_norm)
        q = _project(self.wq_b, q_lat)
        return q[..., :nope], rotate(q[..., nope:], *tables)

    def _latent(self, x, tables):
        """(normed c_kv ``[B, S, kv_lora]``, rotated k_rope ``[B, S, 1,
        rope]``)."""
        kr = self.att.kv_lora_rank
        kv_a = x @ self.wkv_a.to(x.dtype)
        c_kv = _rms(kv_a[..., :kr], self.kv_norm)
        return c_kv, rotate(kv_a[..., None, kr:], *tables)

    def _out(self, out):
        """einsum("bshk,hkd->bsd")."""
        return out.flatten(2) @ self.wo.to(out.dtype).flatten(0, 1)

    def forward(self, x, tables, *, causal: bool = True,
                window: int = 0) -> torch.Tensor:
        """Train / prefill: per-head K/V materialised from the latent, then
        the chunked attention. ``tables`` rotate ``qk_rope`` dims."""
        att = self.att
        q_nope, q_rope = self._query(x, tables)
        c_kv, k_rope = self._latent(x, tables)
        k_nope = _project(self.wk_b, c_kv)
        v = _project(self.wv_b, c_kv)
        k_rope = k_rope.expand(-1, -1, att.n_heads, -1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope], dim=-1)
        return self._out(_chunked_attention(q, k, v, causal=causal,
                                            window=window))

    def decode(self, x, cache: MLACache, at: DecodeSlot,
               tables) -> torch.Tensor:
        """Latent-space decode (absorb trick): x ``[B, 1, d]``; the key
        up-projection is folded into the query, so the scores read the
        latent cache, written at ``at.slot`` in place; the attended
        latent is up-projected by ``wv_b``."""
        att = self.att
        dtype = x.dtype
        B = x.shape[0]
        H = att.n_heads
        q_nope, q_rope = self._query(x, tables)
        # q_eff [B, H, kv_lora] = einsum("bshk,rhk->bshr", q_nope, wk_b)
        q_eff = torch.einsum("bhk,rhk->bhr", q_nope[:, 0],
                             self.wk_b.to(dtype))
        c_new, k_rope_new = self._latent(x, tables)
        cache.c_kv.index_copy_(1, at.slot, c_new)
        cache.k_rope.index_copy_(1, at.slot, k_rope_new[:, :, 0])
        scale = 1.0 / math.sqrt(att.qk_nope_head_dim + att.qk_rope_head_dim)
        s = (q_eff @ cache.c_kv.transpose(1, 2)
             + q_rope[:, 0] @ cache.k_rope.transpose(1, 2))     # [B, H, S]
        s = s * scalar_like(scale, s)
        s = torch.where(at.valid, s, NEG)
        p = torch.softmax(s.float(), dim=-1).to(dtype)
        o_lat = p @ cache.c_kv                                 # [B, H, r]
        out = torch.einsum("bhr,rhk->bhk", o_lat, self.wv_b.to(dtype))
        return self._out(out.view(B, 1, H, -1))


def mla_init_cache(att: AttentionConfig, batch: int, max_seq: int, dtype,
                   device=None) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, max_seq, att.kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, max_seq, att.qk_rope_head_dim),
                           dtype=dtype, device=device))


def make_attention(key, att: AttentionConfig, d_model: int, device=None,
                   dtype=torch.float32) -> nn.Module:
    """``Attention`` (``kind="gqa"``) or ``MLA`` (``kind="mla"``)."""
    if att.kind == "gqa":
        return Attention(key, att, d_model, device, dtype)
    if att.kind == "mla":
        return MLA(key, att, d_model, device, dtype)
    raise ValueError(f"unknown attention kind {att.kind!r}")


def init_cache(att: AttentionConfig, batch: int, max_seq: int, dtype,
               device=None):
    """The decode cache of one layer of ``att``'s kind."""
    if att.kind == "mla":
        return mla_init_cache(att, batch, max_seq, dtype, device)
    return gqa_init_cache(att, batch, max_seq, dtype, device)


def cache_len(cache) -> int:
    """Slots of a layer's cache (``KVCache`` or ``MLACache``)."""
    return cache.c_kv.shape[1] if isinstance(cache, MLACache) \
        else cache.k.shape[2]
