"""Layer assembly: per-layer specs, segment grouping, block stacks.
PyTorch port of repro/models/transformer.py.

A ``LayerSpec`` is (kind, ffn). Consecutive layers are grouped into
*segments* of repeating periods exactly as the reference groups them,
since that decides its parameter tree: the reference stacks a segment's
parameters over periods (``layers[si]["pos{j}"]``, leaves
``[n_periods, ...]``) and scans them; here each period is a
``ModuleDict`` of ``Block``s (``layers[si][period]["pos{j}"]``), run in
a Python loop. ``repro_torch.interop`` unstacks and restacks.

The port builds every layer kind: ``attn`` (GQA or MLA), ``mamba``,
``mlstm`` and ``slstm`` (``models/ssm.py``), with ``ffn`` dense, moe or
none, and the enc-dec decoder's cross-attention (``cross_attention``);
a stack's forward returns the MoE layers' aux loss summed in layer
order, and runs causal (the decoders) or not (the encoder).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import random as prng
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import hint
from repro_torch.models.attention import (Attention, DecodeSlot, KVCache,
                                          MLACache, cache_len, decode_slot,
                                          init_cache, make_attention)
from repro_torch.models.layers import MLP, Norm
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import (SSM_BLOCKS, SSM_INIT_STATE, MambaState,
                                    MLSTMState, SLSTMState)

LayerCache = Union[KVCache, MLACache, MambaState, MLSTMState, SLSTMState]


class Memory(NamedTuple):
    """An encoder's output as the decoder's cross-attention reads it."""
    out: torch.Tensor        # [B, S_enc, d_model], the compute dtype
    tables: Optional[tuple]  # the keys' rotation tables (None: sinusoidal)


class LayerSpec(NamedTuple):
    kind: str     # attn | mamba | mlstm | slstm
    ffn: str      # dense | moe | none


class Segment(NamedTuple):
    n_periods: int
    period: Tuple[LayerSpec, ...]


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    specs = []
    m = cfg.moe
    for i in range(cfg.num_layers):
        kind = cfg.layer_pattern[i % len(cfg.layer_pattern)]
        if kind in ("mlstm", "slstm") or cfg.d_ff == 0:
            ffn = "none"
        elif m is None:
            ffn = "dense"
        elif i < m.first_dense_layers:
            ffn = "dense"
        elif m.every_k_layers > 1 and (i % m.every_k_layers) != m.every_k_layers - 1:
            ffn = "dense"
        else:
            ffn = "moe"
        specs.append(LayerSpec(kind, ffn))
    return specs


def build_segments(cfg: ModelConfig) -> List[Segment]:
    specs = layer_specs(cfg)
    segments: List[Segment] = []
    prefix = cfg.moe.first_dense_layers if cfg.moe else 0
    if prefix:
        segments.append(Segment(1, tuple(specs[:prefix])))
        specs = specs[prefix:]
    if not specs:
        return segments
    period_len = len(cfg.layer_pattern)
    if cfg.moe and cfg.moe.every_k_layers > 1:
        period_len = math.lcm(period_len, cfg.moe.every_k_layers)
    if len(specs) % period_len:
        period_len = len(specs)
    segments.append(Segment(len(specs) // period_len,
                            tuple(specs[:period_len])))
    return segments


def check_supported(cfg: ModelConfig) -> None:
    """Refuse a layer or attention kind the reference does not know.
    Attention layers of either kind (GQA, MLA), mamba, mLSTM and sLSTM
    layers, with dense, MoE or no FFN, cross-attention and M-RoPE are
    built: every config of the registry."""
    for spec in layer_specs(cfg):
        if spec.kind != "attn" and spec.kind not in SSM_BLOCKS:
            raise ValueError(f"unknown layer kind {spec.kind!r}")
    if cfg.attention.kind not in ("gqa", "mla"):
        raise ValueError(
            f"unknown attention kind {cfg.attention.kind!r}")


# ---------------------------------------------------------------------------
# One layer
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """Pre-norm mixer and FFN with residuals: ``norm1``, the mixer named
    by its kind as the reference names it (``attn``: ``Attention`` or
    ``MLA`` by ``cfg.attention.kind``; ``mamba``, ``mlstm``, ``slstm``),
    and with ``ffn="dense"`` ``norm2`` and ``mlp``, with ``ffn="moe"``
    ``norm2`` and ``moe``. An attention block built with
    ``cross_attention`` (the enc-dec decoder's) also has ``norm_x`` and
    ``cross``, a GQA ``Attention`` drawn from the block's ``ks[1]``, run
    after the mixer's residual and before the FFN. ``dtype`` stores the
    drawn matrices (norms and the SSM blocks' ``keep_float32`` leaves
    stay float32)."""

    def __init__(self, key, cfg: ModelConfig, spec: LayerSpec, device=None,
                 dtype=torch.float32, cross_attention: bool = False):
        super().__init__()
        ks = prng.split(key, 6) if key is not None else [None] * 6
        self.cfg, self.spec = cfg, spec
        self.norm1 = Norm(cfg.norm, cfg.d_model, device)
        self.cross_attention = cross_attention and spec.kind == "attn"
        if spec.kind == "attn":
            self.attn = make_attention(ks[0], cfg.attention, cfg.d_model,
                                       device, dtype)
            if self.cross_attention:
                self.norm_x = Norm(cfg.norm, cfg.d_model, device)
                self.cross = Attention(ks[1], cfg.attention, cfg.d_model,
                                       device, dtype)
        else:
            setattr(self, spec.kind, SSM_BLOCKS[spec.kind](
                ks[0], cfg, cfg.ssm, device, dtype))
        if spec.ffn == "dense":
            self.norm2 = Norm(cfg.norm, cfg.d_model, device)
            self.mlp = MLP(ks[2], cfg.d_model, cfg.d_ff, cfg.activation,
                           device, dtype)
        elif spec.ffn == "moe":
            self.norm2 = Norm(cfg.norm, cfg.d_model, device)
            self.moe = MoE(ks[2], cfg, cfg.moe, device, dtype)

    def _ffn(self, x, num_groups: int):
        """(x after the FFN, the layer's aux loss or None)."""
        if self.spec.ffn == "dense":
            return x + self.mlp(self.norm2(x)), None
        if self.spec.ffn == "moe":
            y, aux = self.moe(self.norm2(x), num_groups)
            return x + y, aux
        return x, None

    def _cross(self, x, tables, memory: Optional[Memory]):
        """x after the cross-attention over ``memory`` (unchanged without
        one, as the reference skips it when ``enc_out`` is None)."""
        if not self.cross_attention or memory is None:
            return x
        return x + self.cross(self.norm_x(x), tables, causal=False,
                              kv=(memory.out, memory.out, memory.tables))

    def forward(self, x, tables, num_groups: int = 1, causal: bool = True,
                memory: Optional[Memory] = None):
        """Returns (x, aux loss float32 0-d, or None without an MoE). An
        SSM block runs from the zero state; the mLSTM in its chunkwise
        form when ``cfg.ssm.chunked``."""
        h = self.norm1(x)
        kind = self.spec.kind
        if kind == "attn":
            y = self.attn(h, tables, causal=causal,
                          window=self.cfg.attention.window)
        elif kind == "mlstm":
            y, _ = self.mlstm(h, chunked=self.cfg.ssm.chunked)
        else:
            y, _ = getattr(self, kind)(h)
        return self._ffn(self._cross(x + y, tables, memory), num_groups)

    def decode(self, x, cache: LayerCache, at: DecodeSlot | None, tables,
               num_groups: int = 1, memory: Optional[Memory] = None):
        """One token; ``cache`` (a KV cache or an SSM state) is written in
        place. ``at`` is the attention layers' slot (None without one).
        The cross-attention reads the whole ``memory`` each step."""
        h = self.norm1(x)
        if self.spec.kind == "attn":
            y = self.attn.decode(h, cache, at, tables)
        else:
            y = getattr(self, self.spec.kind).decode(h, cache)
        return self._ffn(self._cross(x + y, tables, memory), num_groups)[0]


# ---------------------------------------------------------------------------
# Segment stacks
# ---------------------------------------------------------------------------


def init_stack(key, cfg: ModelConfig, segments: List[Segment],
               device=None, dtype=torch.float32,
               cross_attention: bool = False) -> nn.ModuleList:
    """``stack[si][period]["pos{j}"]``. Keys as the reference draws them:
    segment ``si`` folds ``si`` into ``key``, its periods take
    ``split(·, n_periods)``, and position ``j`` folds in ``j``; the
    reference ``vmap``s over periods, which draws the same bits as one
    period at a time. ``key=None`` leaves the parameters uninitialised.
    ``cross_attention`` gives every attention block its ``cross``."""
    stacks = nn.ModuleList()
    for si, seg in enumerate(segments):
        keys = prng.split(prng.fold_in(key, si), seg.n_periods) \
            if key is not None else [None] * seg.n_periods
        stacks.append(nn.ModuleList(
            nn.ModuleDict({
                f"pos{j}": Block(None if k is None else prng.fold_in(k, j),
                                 cfg, spec, device, dtype, cross_attention)
                for j, spec in enumerate(seg.period)})
            for k in keys))
    return stacks


def blocks(stacks: nn.ModuleList) -> List[Block]:
    """Every block in layer order."""
    return [period[f"pos{j}"] for seg in stacks for period in seg
            for j in range(len(period))]


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_seq: int, dtype, device=None) -> LayerCache:
    """One layer's decode state: a KV cache (``MLACache`` for MLA) or its
    SSM block's state."""
    if spec.kind == "attn":
        return init_cache(cfg.attention, batch, max_seq, dtype, device)
    return SSM_INIT_STATE[spec.kind](cfg, cfg.ssm, batch, dtype, device)


def init_stack_cache(cfg: ModelConfig, segments: List[Segment], batch: int,
                     max_seq: int, dtype, device=None) -> List[LayerCache]:
    """One cache or state per layer, in layer order."""
    return [init_layer_cache(cfg, spec, batch, max_seq, dtype, device)
            for seg in segments for _ in range(seg.n_periods)
            for spec in seg.period]


def apply_stack(stacks: nn.ModuleList, cfg: ModelConfig, x, tables,
                num_groups: int = 1, causal: bool = True,
                memory: Optional[Memory] = None):
    """Full-sequence forward through every block, causal (a decoder) or
    not (the encoder), its cross-attention over ``memory`` where it has
    one. Returns (x, aux): the MoE layers' aux losses summed in float32
    in layer order (0 without one). With ``cfg.remat == "block"`` and
    autograd on, each period is recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant), the reference's
    ``jax.checkpoint(..., nothing_saveable)`` around its scan body, aux
    included; the gradient reaches the memory through it."""
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg in stacks:
        for period in seg:
            def run(xc, auxc, period=period):
                xc = hint(xc, "batch", None, None)
                for j in range(len(period)):
                    xc, a = period[f"pos{j}"](xc, tables, num_groups,
                                              causal, memory)
                    if a is not None:
                        auxc = auxc + a
                return xc, auxc
            x, aux = checkpoint(run, x, aux, use_reentrant=False) if remat \
                else run(x, aux)
    return x, aux


def decode_stack(stacks: nn.ModuleList, cfg: ModelConfig, x,
                 caches: List[LayerCache], pos, tables, num_groups: int = 1,
                 memory: Optional[Memory] = None):
    """One decode step through every block at position ``pos``, the
    cross-attention over ``memory`` where a block has one. The slot
    comes from the first attention layer's cache (every attention layer
    has the same); a model without one computes none."""
    blks = blocks(stacks)
    attn = next((c for b, c in zip(blks, caches) if b.spec.kind == "attn"),
                None)
    at = None if attn is None \
        else decode_slot(pos, cache_len(attn), cfg.attention.window)
    for blk, cache in zip(blks, caches):
        x = blk.decode(x, cache, at, tables, num_groups, memory)
    return x
