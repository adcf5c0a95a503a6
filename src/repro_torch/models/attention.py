"""Attention: GQA (optional QKV bias, RoPE / M-RoPE) in two regimes,
PyTorch port of repro/models/attention.py:

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

MLA (DeepSeek-V2) waits for the MoE slice (ROADMAP queue 1 item 5b).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch import random as prng
from repro_torch.configs.base import AttentionConfig
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
    kg = k.permute(0, 2, 1, 3)                       # [B, Hkv, Skv, D]
    vg = v.permute(0, 2, 1, 3).contiguous()          # [B, Hkv, Skv, Dv]
    outs = []
    for qi in range(nq):
        q0 = qi * qc
        qn = min(qc, Sq - q0)
        qb = qg[:, :, q0:q0 + qn].reshape(B, Hkv, qn * rep, D)
        q_pos = q_offset + q0 + torch.arange(qn, device=dev)
        m = torch.full((B, Hkv, qn, rep), NEG, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, qn, rep), dtype=torch.float32, device=dev)
        o = torch.zeros((B, Hkv, qn, rep, Dv), dtype=torch.float32,
                        device=dev)
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
                 device=None):
        super().__init__()
        if att.kind != "gqa":
            raise NotImplementedError(
                f"attention kind {att.kind!r} (MLA) is not ported yet: "
                "ROADMAP queue 1 item 5b")
        self.att = att
        H, Hkv, D = att.n_heads, att.n_kv_heads, att.head_dim
        ks = prng.split(key, 8) if key is not None else [None] * 8
        s = 1.0 / math.sqrt(d_model)
        self.wq = parameter(ks[0], (d_model, H, D), s, device)
        self.wk = parameter(ks[1], (d_model, Hkv, D), s, device)
        self.wv = parameter(ks[2], (d_model, Hkv, D), s, device)
        self.wo = parameter(ks[3], (H, D, d_model), 1.0 / math.sqrt(H * D),
                            device)
        if att.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(H, D, device=device))
            self.bk = nn.Parameter(torch.zeros(Hkv, D, device=device))
            self.bv = nn.Parameter(torch.zeros(Hkv, D, device=device))

    def _project(self, w, b, x):
        """einsum("bsd,dhk->bshk") as one matmul, plus the bias."""
        y = (x @ w.to(x.dtype).flatten(1)).unflatten(-1, w.shape[1:])
        return y if b is None else y + b.to(x.dtype)

    def _qkv(self, x, tables):
        bias = self.att.qkv_bias
        q = self._project(self.wq, self.bq if bias else None, x)
        k = self._project(self.wk, self.bk if bias else None, x)
        v = self._project(self.wv, self.bv if bias else None, x)
        if tables is not None:
            q, k = rotate(q, *tables), rotate(k, *tables)
        return q, k, v

    def _out(self, out):
        """einsum("bshk,hkd->bsd")."""
        return out.flatten(2) @ self.wo.to(out.dtype).flatten(0, 1)

    def forward(self, x, tables, *, causal: bool = True,
                window: int = 0) -> torch.Tensor:
        """Full-sequence forward (train / prefill); ``tables`` are the
        positional rotation tables (``layers.positional_tables``)."""
        q, k, v = self._qkv(x, tables)
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
