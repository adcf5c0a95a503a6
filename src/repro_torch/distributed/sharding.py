"""Sharding plans: the partition spec of every parameter, optimiser
moment, batch tensor and decode-state leaf on a device mesh, PyTorch
port of repro/distributed/sharding.py as pure functions.

Scheme (DESIGN.md §6), the reference's:

* TP over ``model``: attention heads, FFN hidden, MoE experts (EP), vocab;
* FSDP over ``data`` (+``pod`` when present): the d_model axis of every
  large matrix;
* activations: batch over (pod, data); decode caches shard their
  sequence axis over ``model`` (a split-KV decode);
* anything small (norms, biases, routers) replicates.

A mesh is an ordered ``{axis name: size}`` dict (``launch.mesh``). A
spec is a tuple with one entry per leading dimension it names: ``None``
(replicated), an axis name, or a tuple of axis names; ``()`` is
replicated, as the reference's ``P()``. Nothing here touches a device or
``torch.distributed``: the port runs on one card, and the plans say how
each config would be laid out on a cluster (the dry-run, ``launch/``,
reckons with them).

The rules key on the reference's parameter paths (``layers/0/pos0/attn/
wq``), and each is applied to the reference's leaf, which the layer
stacks hold stacked over their periods (``[n_periods, ...]``). The rules
are written for one period's shape, so on a stacked leaf every entry
lands one axis early: olmo-1b's ``wq`` ``[16, 2048, 16, 128]`` gets
``('data', 'model', None, None)`` on 16×16. ``cache_pspec`` assumes a
stack axis on every leaf of two or more dimensions, the encoder memory
``enc_out [B, S_enc, d]`` included. Both are the reference's (ROADMAP
queue 3 item 12) and are reproduced here, not fixed.

``hint_pspec`` is the spec the reference's ``hint`` constrains an
activation to. The port has no ambient mesh: the model code calls
``hint`` where the reference does, and it returns its input unchanged
unless the dry-run's counter (``launch.op_cost.OpCounter``) has set a
layout hook, which records the layout.
"""
from __future__ import annotations

import math
import os
import re
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch

Spec = Tuple
Mesh = Mapping[str, int]

_STACKS = ("layers", "enc_layers")

# (path regex, spec builder), first match wins; a builder takes the leaf
# shape and the resolved axis names. The reference's table, entry for
# entry.
_RULES = [
    # embeddings / unembeddings: vocab x d_model
    (r"(embed|unembed)/table$", lambda s, ax: (ax.model, ax.fsdp)),
    # attention projections [d, H, hd] / [H, hd, d]
    (r"attn/wq$|attn/wk$|attn/wv$|cross/wq$|cross/wk$|cross/wv$",
     lambda s, ax: (ax.fsdp, ax.model, None)),
    (r"attn/wo$|cross/wo$", lambda s, ax: (ax.model, None, ax.fsdp)),
    (r"attn/bq$|attn/bk$|attn/bv$|cross/b[qkv]$",
     lambda s, ax: (ax.model, None)),
    # MLA latents
    (r"attn/wq_a$|attn/wkv_a$", lambda s, ax: (ax.fsdp, None)),
    (r"attn/wq_b$|attn/wk_b$|attn/wv_b$",
     lambda s, ax: (None, ax.model, None)),
    # dense MLP [d, ff] / [ff, d]
    (r"(mlp|shared|dense)/w_gate$|(mlp|shared|dense)/w_up$",
     lambda s, ax: (ax.fsdp, ax.model)),
    (r"(mlp|shared|dense)/w_down$", lambda s, ax: (ax.model, ax.fsdp)),
    # MoE experts [E, d, f] / [E, f, d]  (EP over model)
    (r"moe/w_gate$|moe/w_up$", lambda s, ax: (ax.model, ax.fsdp, None)),
    (r"moe/w_down$", lambda s, ax: (ax.model, None, ax.fsdp)),
    (r"moe/router$", lambda s, ax: (ax.fsdp, None)),
    # mamba
    (r"mamba/w_in$", lambda s, ax: (ax.fsdp, ax.model)),
    (r"mamba/w_out$", lambda s, ax: (ax.model, ax.fsdp)),
    (r"mamba/w_x$", lambda s, ax: (ax.model, None)),
    (r"mamba/w_dt$", lambda s, ax: (None, ax.model)),
    (r"mamba/(conv_w|conv_b|dt_bias|A_log|D)$",
     lambda s, ax: (None,) * (len(s) - 1) + (ax.model,)),
    # xLSTM
    (r"(mlstm|slstm)/w_up$|slstm/w_gates$|slstm/w_ff1$",
     lambda s, ax: (ax.fsdp, ax.model)),
    (r"(mlstm|slstm)/w_down$|slstm/w_ff2$", lambda s, ax: (ax.model, ax.fsdp)),
    (r"mlstm/w(q|k|v)$", lambda s, ax: (ax.model, None, None)),
    (r"mlstm/w_if$", lambda s, ax: (ax.model, None)),
]


class AxisNames:
    """Resolved mesh-axis names; fsdp composes pod+data when present.

    Modes (``mode``, or ``REPRO_SHARDING_MODE`` when it is None, as the
    reference reads it):
      hybrid (default) — batch over (pod, data); TP/EP over model.
      fsdp             — batch over every axis.
    """

    def __init__(self, mesh: Mesh, mode: Optional[str] = None):
        names = tuple(mesh)
        if mode is None:
            mode = os.environ.get("REPRO_SHARDING_MODE", "hybrid")
        self.model = "model" if "model" in names else None
        if "pod" in names and "data" in names:
            self.fsdp = ("pod", "data")
        elif "data" in names:
            self.fsdp = "data"
        else:
            self.fsdp = None
        if mode == "fsdp" and self.model is not None:
            self.batch = _parts(self.fsdp) + (self.model,)
        else:
            self.batch = self.fsdp


def _parts(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _size(mesh: Mesh, entry) -> int:
    return math.prod(mesh[p] for p in _parts(entry))


def _divisible(shape, spec: Spec, mesh: Mesh) -> Spec:
    """Drop sharding on axes the mesh doesn't divide (e.g. kv=10 over 16);
    one entry per dimension of ``shape``."""
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(s if s is None or dim % _size(mesh, s) == 0 else None
                 for dim, s in zip(shape, padded))


def param_pspec(path: str, shape, mesh: Mesh,
                mode: Optional[str] = None) -> Spec:
    """The spec of the reference's leaf at ``path`` of ``shape``."""
    ax = AxisNames(mesh, mode)
    for pattern, builder in _RULES:
        if re.search(pattern, path):
            return _divisible(shape, builder(shape, ax), mesh)
    return ()   # norms, small biases: replicated


def param_leaves(cfg_or_model) -> Iterator[Tuple[str, str, Tuple[int, ...],
                                                 torch.dtype]]:
    """(port name, reference path, reference leaf shape, dtype) for every
    parameter of the model (or of a meta skeleton of the config): a
    parameter of a layer stack is one period of the reference's leaf,
    whose shape leads with the period count."""
    model = cfg_or_model
    if not isinstance(cfg_or_model, torch.nn.Module):
        from repro_torch.interop import _lm_skeleton
        model = _lm_skeleton(cfg_or_model)
    for name, p in model.named_parameters():
        parts = name.split(".")
        shape = tuple(p.shape)
        if parts[0] in _STACKS:
            si = int(parts[1])
            shape = (len(getattr(model, parts[0])[si]),) + shape
            parts = parts[:2] + parts[3:]
        yield name, "/".join(parts), shape, p.dtype


def tree_pspecs(cfg_or_model, mesh: Mesh, mode: Optional[str] = None,
                prefix: str = "") -> Dict[str, Spec]:
    """Port parameter name → the spec of the reference's leaf it is (one
    period of). ``prefix`` ``"mu/"``, ``"nu/"`` or ``"error/"`` gives an
    ``OptState``'s moments, which shard like their parameters."""
    return {name: param_pspec(prefix + path, shape, mesh, mode)
            for name, path, shape, _ in param_leaves(cfg_or_model)}


def hint_pspec(shape, logical: Sequence[Optional[str]], mesh: Mesh,
               mode: Optional[str] = None) -> Spec:
    """The spec the reference's ``hint(x, *logical)`` constrains ``x`` of
    ``shape`` to on ``mesh``. Logical names: ``"batch"`` → the batch
    axes, ``"model"`` → model, ``None``; an axis is used once, and a
    dimension the axes do not divide stays replicated."""
    ax = AxisNames(mesh, mode)
    spec: List = []
    used = set()
    for name, dim in zip(logical, shape):
        if name == "batch" and ax.batch is not None:
            parts = tuple(p for p in _parts(ax.batch) if p not in used)
            total = math.prod(mesh[p] for p in parts) if parts else 0
            if parts and dim % total == 0:
                spec.append(parts if len(parts) > 1 else parts[0])
                used.update(parts)
            else:
                spec.append(None)
        elif name == "model" and ax.model is not None \
                and ax.model not in used:
            ok = dim % mesh[ax.model] == 0
            spec.append(ax.model if ok else None)
            if ok:
                used.add(ax.model)
        else:
            spec.append(None)
    return tuple(spec)


_layout_hook = None


def set_layout_hook(hook):
    """Install ``hook(x, logical) -> x`` for ``hint`` (None removes it);
    returns the hook it replaces."""
    global _layout_hook
    old, _layout_hook = _layout_hook, hook
    return old


def hint(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The reference's ``hint(x, *logical)`` at its call sites: ``x``
    itself, or what the layout hook makes of it while the dry-run counts
    (``hint_pspec`` gives the spec on a mesh). An entry may be ``(name,
    size)``: the dimension holds a part of a logical axis of that size
    (heads grouped by KV head)."""
    hook = _layout_hook
    return x if hook is None else hook(x, logical)


def batch_pspec(mesh: Mesh, batch_size: int,
                mode: Optional[str] = None) -> Spec:
    """tokens/labels [B, S]: B over the batch axes when they divide it,
    else replicated."""
    ax = AxisNames(mesh, mode)
    if ax.batch is None:
        return ()
    if batch_size % _size(mesh, ax.batch) == 0:
        return (ax.batch, None)
    return (None, None)


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def batch_pspecs(cfg, mesh: Mesh, batch: Mapping,
                 mode: Optional[str] = None) -> Dict[str, Spec]:
    """Specs of a train/prefill batch dict (tensors or shapes): tokens and
    labels by ``batch_pspec``; frames and patches ``[B, S, d]`` their
    batch axis the same, the rest replicated."""
    out = {}
    for k, v in batch.items():
        bspec = batch_pspec(mesh, _shape(v)[0], mode)
        out[k] = bspec if k in ("tokens", "labels") \
            else (bspec[0] if bspec else None, None, None)
    return out


def cache_pspec(mesh: Mesh, shape, batch_size: int,
                mode: Optional[str] = None) -> Spec:
    """A decode-state leaf stacked over periods ``[n_periods, B, ...]``:
    the batch over the batch axes when they divide it; the first later
    axis of more than 8 that ``model`` divides, over ``model``."""
    ax = AxisNames(mesh, mode)
    b_ax = ax.batch if (ax.batch and batch_size % _size(mesh, ax.batch) == 0) \
        else None
    spec: List = [None, b_ax]
    m = mesh.get("model", 1)
    for dim in shape[2:]:
        if ("model" not in [x for x in spec if x] and dim >= m
                and dim % m == 0 and dim > 8):
            spec.append("model")
        else:
            spec.append(None)
    return tuple(spec[:len(shape)])


def state_leaves(cfg, batch_size: int, max_seq: int
                 ) -> Iterator[Tuple[str, str, Tuple[int, ...], torch.dtype]]:
    """(port name, reference path, reference leaf shape, dtype) for every
    leaf of the port's ``DecodeState`` of ``cfg``: ``caches.{layer}.
    {field}`` is one period of the reference's cache leaf at ``caches/
    {segment}/pos{j}/{field}``, stacked ``[n_periods, ...]`` (a
    ``KVCache``'s ``k``/``v`` in the reference's ``[B, S, Hkv, D]``);
    ``pos`` is the port's one 0-d position (the reference keeps one per
    attention cache, one dimension, replicated alike); ``enc_out`` and
    ``enc_pos`` (enc-dec) are the reference's as they are."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.attention import KVCache
    from repro_torch.models.model import ENC_FRAMES, compute_dtype

    dtype = compute_dtype(cfg)
    layer = 0
    for si, seg in enumerate(tfm.build_segments(cfg)):
        for _ in range(seg.n_periods):
            for j, spec in enumerate(seg.period):
                cache = tfm.init_layer_cache(cfg, spec, batch_size, max_seq,
                                             dtype, "meta")
                for f, t in zip(cache._fields, cache):
                    shape = tuple(t.shape)
                    if isinstance(cache, KVCache):
                        shape = (shape[0], shape[2], shape[1], shape[3])
                    yield (f"caches.{layer}.{f}", f"caches/{si}/pos{j}/{f}",
                           (seg.n_periods,) + shape, t.dtype)
                layer += 1
    yield "pos", "pos", (), torch.int32
    if cfg.family == "enc_dec":
        yield ("enc_out", "enc_out", (batch_size, ENC_FRAMES, cfg.d_model),
               dtype)
        yield "enc_pos", "enc_pos", (batch_size, ENC_FRAMES), torch.int32


def state_pspecs(cfg, mesh: Mesh, batch_size: int, max_seq: int,
                 mode: Optional[str] = None) -> Dict[str, Spec]:
    """Port ``DecodeState`` leaf name → the spec of the reference's leaf
    it comes from (``state_leaves``): ``cache_pspec`` of its shape,
    ``()`` below two dimensions."""
    return {name: () if len(shape) < 2
            else cache_pspec(mesh, shape, batch_size, mode)
            for name, _, shape, _ in state_leaves(cfg, batch_size, max_seq)}


def shard_bytes(shape, dtype: torch.dtype, spec: Spec, mesh: Mesh) -> int:
    """Bytes of a leaf of ``shape`` that one chip holds under ``spec``:
    each sharded dimension cut into its axes' product of equal blocks
    (the last one full where they do not divide it)."""
    n = 1
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, s in zip(shape, padded):
        n *= -(-dim // _size(mesh, s))
    return n * torch.empty((), dtype=dtype).element_size()
