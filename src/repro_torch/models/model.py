"""Top-level model API, PyTorch port of repro/models/model.py, for
every family of the registry: ``"dense"``, ``"moe"`` (MoE FFNs, MLA or
GQA attention), ``"ssm"`` (xLSTM's mLSTM and sLSTM), ``"hybrid"``
(mamba and attention, dense and MoE FFNs; Jamba), ``"enc_dec"`` (an
encoder stack over audio frames and a decoder with cross-attention;
SeamlessM4T) and ``"vlm"`` (patch embeddings before the text, M-RoPE;
Qwen2-VL).

* ``init_params(cfg, key, device)``      — a ``TransformerLM`` (float32
  masters, drawn with the reference's threefry keys; ``dtype=`` stores
  the drawn matrices in the serving dtype instead)
* ``forward(model, batch)``              — pre-logits for train/prefill
  and the MoE aux loss
* ``loss_fn(model, batch)``              — sequence-chunked cross-entropy
  plus the aux loss
* ``init_decode_state(model, B, S)``     — KV or latent caches, SSM
  states and the position
* ``decode_step(model, tokens, state)``  — one-token serve step

``forward``, ``loss_fn`` and ``decode_step`` take the reference's
``num_groups``: an MoE layer dispatches its tokens in ``gcd(tokens,
num_groups)`` groups.

Batch dict keys, tensors on the model's device: ``tokens`` [B, S]
(+ ``labels`` for train), integers; for ``vlm`` also ``patches``
[B, n_patches, d_model] (at most ``N_PATCHES``; the text is the last
``S`` positions), for ``enc_dec`` ``frames`` [B, ENC_FRAMES, d_model]:
the modality frontends are stubs, as in the reference, and these are
their precomputed embeddings. The model's parameters are float32 and
are cast to ``cfg.dtype`` where they are applied; ``cast_for_serving``
stores them in that dtype once, for a model that only serves.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import random as prng
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import hint
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import LayerCache, Memory
from repro_torch.models.layers import (Embedding, Norm, embed,
                                       positional_tables,
                                       sinusoidal_positions)

N_PATCHES = 1024        # VLM stub: patch tokens prepended to text
ENC_FRAMES = 1536       # audio stub: encoder frame count
SEQ_CHUNK = 256         # sequence-chunked cross-entropy block


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _encoder_segments(cfg: ModelConfig) -> List[tfm.Segment]:
    """The enc-dec encoder: ``encoder_layers`` dense attention layers."""
    return [tfm.Segment(cfg.encoder_layers,
                        (tfm.LayerSpec("attn", "dense"),))]


class TransformerLM(nn.Module):
    """``embed``, ``layers`` (``layers[si][period]["pos{j}"]``),
    ``final_norm`` and, untied, ``unembed``: the reference's parameter
    tree with each segment unstacked over its periods; for ``enc_dec``
    also ``enc_layers`` (the encoder's stack, drawn from the init key's
    ``split(·, 8)[3]``) and ``enc_norm``, and the decoder's attention
    blocks carry ``norm_x`` and ``cross``. On CUDA unless
    ``device`` names another; ``key`` None leaves it uninitialised.
    ``dtype`` (float32 by default) stores every drawn matrix in that
    dtype, each the float32 draw cast once and a large one drawn slab by
    slab, so a serving model never holds its float32 masters; norm
    parameters stay float32."""

    def __init__(self, cfg: ModelConfig, key=None, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        tfm.check_supported(cfg)
        device = resolve_device(device)
        dtype = dtype or torch.float32
        self.cfg = cfg
        ks = prng.split(key, 8) if key is not None else [None] * 8
        self.segments = tfm.build_segments(cfg)
        self.embed = Embedding(ks[0], cfg.vocab_size, cfg.d_model, device,
                               dtype)
        self.final_norm = Norm(cfg.norm, cfg.d_model, device)
        enc_dec = cfg.family == "enc_dec"
        self.layers = tfm.init_stack(ks[1], cfg, self.segments, device,
                                     dtype, cross_attention=enc_dec)
        if not cfg.tie_embeddings:
            self.unembed = Embedding(ks[2], cfg.vocab_size, cfg.d_model,
                                     device, dtype)
        if enc_dec:
            self.enc_layers = tfm.init_stack(
                ks[3], cfg, _encoder_segments(cfg), device, dtype)
            self.enc_norm = Norm(cfg.norm, cfg.d_model, device)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def out_table(self) -> torch.Tensor:
        return self.embed.table if self.cfg.tie_embeddings \
            else self.unembed.table


def init_params(cfg: ModelConfig, key, device=None,
                dtype: Optional[torch.dtype] = None) -> TransformerLM:
    """The model with the reference's initial values (within the
    ``erfinv`` gap of ``random.truncated_normal``), on CUDA unless
    ``device`` names another. ``key`` None leaves it uninitialised.
    ``dtype=compute_dtype(cfg)`` gives, bit for bit, ``cast_for_serving``
    of the float32 model without ever holding it."""
    return TransformerLM(cfg, key, device, dtype)


def params_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters by name, detached (sharing storage): the
    params tree of the train and serve steps."""
    return {n: p.detach() for n, p in model.named_parameters()}


def bind_params(model: nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Point each parameter of ``model`` at the tensor of the same name
    (no copy; a parameter already there is left alone). The dict last
    bound is remembered, and binding it again costs nothing: a step
    called in a loop with one params dict (serving) skips the walk over
    the parameters, so give a new dict, not an edited one, to rebind."""
    if getattr(model, "_bound_params", None) is params:
        return
    for n, p in model.named_parameters():
        t = params[n]
        if p.data_ptr() != t.data_ptr() or p.shape != t.shape \
                or p.dtype != t.dtype:
            p.data = t.detach()
    model._bound_params = params


def cast_for_serving(model: TransformerLM) -> TransformerLM:
    """Store every parameter that is only ever applied in ``cfg.dtype``
    (matrices, tables, QKV biases) in that dtype, in place; norm
    parameters (``Norm``'s, and those a module lists in
    ``keep_float32``, MLA's ``q_norm``/``kv_norm``) stay float32, as
    they apply in float32. The cast is the
    one the forward makes, so the outputs keep their bits, and a decode
    step stops re-casting its weights (for qwen2-0.5b, the 136M-element
    tied table each step). For a model that serves: training keeps its
    float32 masters."""
    dtype = compute_dtype(model.cfg)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Norm):
                continue
            keep = getattr(mod, "keep_float32", ())
            for name, p in mod.named_parameters(recurse=False):
                if name not in keep:
                    p.data = p.data.to(dtype)
    model._bound_params = None
    return model


# ---------------------------------------------------------------------------
# Positions and forward
# ---------------------------------------------------------------------------


def _sequence_positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None] \
        .expand(B, S)


def _mrope_positions(B: int, S: int, n_patches: int,
                     device) -> torch.Tensor:
    """(t, h, w) positions, int32 ``[B, S, 3]``: patch ``i`` on a grid at
    ``(0, i // side, i % side)`` (``side`` the floor of the root, so a
    non-square count runs past ``side`` rows, as the reference's does),
    then the text sequential at ``t = n_patches + j`` in all three (the
    decode path's position is the cache write index)."""
    side = max(int(math.sqrt(max(n_patches, 1))), 1)
    i = torch.arange(n_patches, device=device)
    patch_pos = torch.stack([torch.zeros_like(i), i // side, i % side], -1)
    t = n_patches + torch.arange(S - n_patches, device=device)
    text_pos = torch.stack([t, t, t], -1)
    pos = torch.cat([patch_pos, text_pos], 0)
    return pos[None].expand(B, S, 3).to(torch.int32)


def _positions(cfg: ModelConfig, B: int, S: int, n_patches: int = 0,
               device=None) -> torch.Tensor:
    if cfg.attention.rope == "mrope":
        return _mrope_positions(B, S, n_patches, device)
    return _sequence_positions(B, S, device)


def _input_embedding(model: TransformerLM, batch, dtype):
    """Token (and, for ``vlm``, patch) input embedding. Returns (x
    ``[B, S, d]``, positions): the patches, cast to ``dtype``, sit before
    the tokens; a ``"sinusoidal"`` signal is added after the cast."""
    cfg = model.cfg
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x = embed(model.embed, tokens, dtype)
    n_patches = 0
    if cfg.family == "vlm":
        patches = batch["patches"].to(dtype)
        n_patches = patches.shape[1]
        x = torch.cat([patches, x], dim=1)
    pos = _positions(cfg, B, x.shape[1], n_patches, x.device)
    if cfg.attention.rope == "sinusoidal":
        x = x + sinusoidal_positions(pos, cfg.d_model).to(dtype)
    return x, pos


def run_encoder(model: TransformerLM, frames: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The enc-dec encoder over ``frames [B, S_enc, d]``: the frames cast
    to the compute dtype plus the sinusoidal signal, the encoder stack
    (not causal; each period recomputed in the backward under
    ``remat="block"``), ``enc_norm``. Returns (enc_out ``[B, S_enc, d]``,
    enc_pos int32 ``[B, S_enc]``), a decode state's memory."""
    cfg = model.cfg
    dtype = compute_dtype(cfg)
    B, S_enc, _ = frames.shape
    pos = _sequence_positions(B, S_enc, frames.device)
    x = frames.to(dtype) + sinusoidal_positions(pos, cfg.d_model).to(dtype)
    x, _ = tfm.apply_stack(model.enc_layers, cfg, x,
                           positional_tables(cfg.attention, pos),
                           causal=False)
    return model.enc_norm(x), pos


def _memory(cfg: ModelConfig, enc_out, enc_pos) -> Optional[Memory]:
    """The decoder's view of an encoder memory: its keys rotate at the
    memory's own positions."""
    return None if enc_out is None \
        else Memory(enc_out, positional_tables(cfg.attention, enc_pos))


def forward(model: TransformerLM, batch, *, num_groups: int = 1):
    """Full-sequence forward. Returns (pre-logits x, positions, aux): aux
    is the MoE layers' load-balancing loss, float32 (0 without MoE). An
    enc-dec model first runs its encoder on ``batch["frames"]``."""
    cfg = model.cfg
    dtype = compute_dtype(cfg)
    x, pos = _input_embedding(model, batch, dtype)
    x = hint(x, "batch", None, None)
    memory = None
    if cfg.family == "enc_dec":
        memory = _memory(cfg, *run_encoder(model, batch["frames"]))
    x, aux = tfm.apply_stack(model.layers, cfg, x,
                             positional_tables(cfg.attention, pos),
                             num_groups, causal=True, memory=memory)
    x = model.final_norm(x)
    return x, pos, aux


def logits_from_hidden(model: TransformerLM, x: torch.Tensor):
    return x @ model.out_table().to(x.dtype).T


# ---------------------------------------------------------------------------
# Sequence-chunked cross-entropy: never materializes [B, S, V] logits
# ---------------------------------------------------------------------------


def _chunk_nll(xs, tab, tg):
    logits = hint((xs @ tab.T).float(), "batch", None, "model")
    lse = torch.logsumexp(logits, dim=-1)
    tl = torch.gather(logits, 2, tg[..., None].long())[..., 0]
    return torch.sum(lse - tl)


def cross_entropy_chunked(x, table, targets, *, chunk: int = SEQ_CHUNK):
    """x: [B, S, d]; table: [V, d]; targets: [B, S]. Mean NLL in float32.

    Sequence chunks of ``chunk``: each materialises only [B, chunk, V]
    float32 logits, recomputed in the backward (the reference's
    ``jax.checkpoint`` around its scan body); the chunk sums are added in
    sequence order."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    tab = hint(table, "model", None).to(x.dtype)
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        args = (x[:, c0:c0 + chunk], tab, targets[:, c0:c0 + chunk])
        part = checkpoint(_chunk_nll, *args, use_reentrant=False) \
            if remat else _chunk_nll(*args)
        total = total + part
    return total / (B * S)


def loss_fn(model: TransformerLM, batch, *, num_groups: int = 1):
    x, _, aux = forward(model, batch, num_groups=num_groups)
    labels = batch["labels"]
    # vlm: the loss is over the text, the last S_l positions
    S_l = labels.shape[1]
    loss = cross_entropy_chunked(x[:, -S_l:, :], model.out_table(), labels)
    return loss + aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    caches: List[LayerCache]  # one cache or SSM state per layer, in order
    pos: torch.Tensor       # int32, 0-d: tokens already written
    # enc_dec: the encoder memory the cross-attention reads each step
    # ([B, S_enc, d] in the compute dtype, and its int32 [B, S_enc]
    # positions); None for the other families. A caller who runs the
    # encoder replaces both (``state._replace``); it is not masked
    enc_out: Optional[torch.Tensor] = None
    enc_pos: Optional[torch.Tensor] = None


def init_decode_state(model: TransformerLM, batch: int,
                      max_seq: int) -> DecodeState:
    """Zero caches and states at position 0; for ``enc_dec`` the
    reference's placeholder memory, ``ENC_FRAMES`` zero frames at
    positions ``0 .. ENC_FRAMES − 1``."""
    cfg = model.cfg
    dev = model.device
    dtype = compute_dtype(cfg)
    enc_out = enc_pos = None
    if cfg.family == "enc_dec":
        enc_out = torch.zeros((batch, ENC_FRAMES, cfg.d_model), dtype=dtype,
                              device=dev)
        enc_pos = _sequence_positions(batch, ENC_FRAMES, dev)
    return DecodeState(
        caches=tfm.init_stack_cache(cfg, model.segments, batch, max_seq,
                                    dtype, dev),
        pos=torch.zeros((), dtype=torch.int32, device=dev),
        enc_out=enc_out, enc_pos=enc_pos)


def decode_step(model: TransformerLM, tokens, state: DecodeState, *,
                num_groups: int = 1):
    """tokens: [B, 1]. Returns (logits [B, 1, V], state): the caches and
    SSM states are written and ``pos`` advanced in place, on the device,
    so the step reads nothing back to the host. Every layer sits at the
    same position, so the rotation tables are computed once a step
    (M-RoPE's at ``(p, p, p)``: a decode step embeds tokens only). An
    enc-dec decoder's cross-attention reads ``state.enc_out``."""
    cfg = model.cfg
    dtype = compute_dtype(cfg)
    B = tokens.shape[0]
    x = embed(model.embed, tokens, dtype)
    posf = state.pos.expand(B, 1)
    if cfg.attention.rope == "sinusoidal":
        x = x + sinusoidal_positions(posf, cfg.d_model).to(dtype)
    qpos = state.pos.expand(B, 1, 3) if cfg.attention.rope == "mrope" \
        else posf
    tables = positional_tables(cfg.attention, qpos)
    x = tfm.decode_stack(model.layers, cfg, x, state.caches, state.pos,
                         tables, num_groups,
                         _memory(cfg, state.enc_out, state.enc_pos))
    x = model.final_norm(x)
    state.pos.add_(1)
    return logits_from_hidden(model, x), state


# ---------------------------------------------------------------------------
# Analytic parameter counts (roofline 6ND)
# ---------------------------------------------------------------------------


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    att = cfg.attention
    d = cfg.d_model
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)

    def attn_params() -> int:
        if att.kind == "mla":
            qk = att.qk_nope_head_dim + att.qk_rope_head_dim
            return (d * att.q_lora_rank
                    + att.q_lora_rank * att.n_heads * qk
                    + d * (att.kv_lora_rank + att.qk_rope_head_dim)
                    + att.kv_lora_rank * att.n_heads
                    * (att.qk_nope_head_dim + att.v_head_dim)
                    + att.n_heads * att.v_head_dim * d)
        return (d * att.n_heads * att.head_dim
                + 2 * d * att.n_kv_heads * att.head_dim
                + att.n_heads * att.head_dim * d)

    def mlp_params(ff: int) -> int:
        mult = 3 if cfg.activation in ("swiglu", "geglu") else 2
        return mult * d * ff

    def moe_params(active: bool) -> int:
        m = cfg.moe
        n_e = m.top_k if active else m.num_experts
        n = d * m.num_experts            # router
        n += n_e * 3 * d * m.expert_d_ff
        if m.num_shared_experts:
            n += mlp_params(m.shared_d_ff * m.num_shared_experts)
        if m.dense_residual:
            n += mlp_params(m.dense_residual_d_ff)
        return n

    def ssm_params(kind: str) -> int:
        s = cfg.ssm
        if kind == "mamba":
            di = s.expand * d
            dt_rank = max(1, math.ceil(d / 16))
            return (2 * d * di + s.d_conv * di + di * (dt_rank + 2 * s.d_state)
                    + dt_rank * di + di * s.d_state + 2 * di + di * d)
        if kind == "mlstm":
            di = int(s.proj_factor * d)
            dh = di // s.num_heads
            return (2 * d * di + 3 * di * s.num_heads * dh
                    + 2 * di * s.num_heads + di * d + di)
        if kind == "slstm":
            di = d
            dh = di // s.num_heads
            return (4 * d * di + s.num_heads * dh * 4 * dh
                    + 2 * di * (4 * di // 3) + 5 * di)
        raise ValueError(kind)

    for spec in tfm.layer_specs(cfg):
        if spec.kind == "attn":
            total += attn_params()
            if cfg.family == "enc_dec":
                total += attn_params()     # cross-attention
        else:
            total += ssm_params(spec.kind)
        if spec.ffn == "dense":
            total += mlp_params(cfg.d_ff)
        elif spec.ffn == "moe":
            total += moe_params(active_only)
    if cfg.family == "enc_dec":
        total += cfg.encoder_layers * (attn_params() + mlp_params(cfg.d_ff))
    return int(total)
