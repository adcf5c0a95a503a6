"""State carried across from the reference into the port's types.

The functions take the reference's ``EdgeStore``, ``TemporalIndex``,
``WindowState``, ``LaneParams``, ``SkipgramState``, ``OptState`` and the
LM's params, moments and decode state as
NamedTuples or dicts whose fields are numpy arrays (or anything
``numpy.asarray`` accepts), and a key as two uint32 words. Tests use them
to feed the reference's own index — its ``pexp``/``plin`` among it — into
the port, so weight-mode walks can be compared bit for bit, to start the
port from the reference's window, sharded window and alias tables, to
run one packed lane batch in both packages, and to step embeddings and
optimiser state from the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.alias import AliasTables
from repro_torch.core.edge_store import EdgeStore
from repro_torch.core.temporal_index import TemporalIndex
from repro_torch.core.walk_engine import LaneParams
from repro_torch.core.window import WindowState
from repro_torch.kernels.runtime import resolve_device
from repro_torch.train.embeddings import SkipgramState
from repro_torch.train.optimizer import OptState

_INT_FIELDS = ("ns_order", "ns_src", "ns_dst", "ns_ts", "node_starts",
               "node_group_counts", "node_tref", "node_tbase", "adj_order",
               "adj_dst")
_FLOAT_FIELDS = ("pexp", "plin", "pexp_store", "plin_store")
_COUNTERS = ("t_now", "window", "ingested", "late_drops", "overflow_drops")


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _tensor(x, dtype: np.dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=dtype)).to(device)


def key_from_words(key) -> torch.Tensor:
    """A port key from a reference key (uint32[2])."""
    return torch.as_tensor(np.asarray(key, np.uint32).astype(np.int64))


def store_from_ref(store, device=None) -> EdgeStore:
    device = resolve_device(device)
    return EdgeStore(**{f: _tensor(_get(store, f), np.int32, device)
                        for f in EdgeStore._fields})


def index_from_ref(index, device=None) -> TemporalIndex:
    device = resolve_device(device)
    fields = {"store": store_from_ref(_get(index, "store"), device)}
    fields.update({f: _tensor(_get(index, f), np.int32, device)
                   for f in _INT_FIELDS})
    fields.update({f: _tensor(_get(index, f), np.float32, device)
                   for f in _FLOAT_FIELDS})
    return TemporalIndex(**fields)


def tables_from_ref(tables, device=None) -> AliasTables:
    """The port's ``AliasTables`` from the reference's (same fields)."""
    device = resolve_device(device)
    return AliasTables(
        thresh=_tensor(_get(tables, "thresh"), np.int32, device),
        partner=_tensor(_get(tables, "partner"), np.int32, device),
        ptab=_tensor(_get(tables, "ptab"), np.float32, device),
        rebuilt=_tensor(_get(tables, "rebuilt"), np.int32, device))


def window_from_ref(state, device=None) -> WindowState:
    """The port's ``WindowState`` from the reference's, its alias tables
    included when it has them."""
    device = resolve_device(device)
    tables = (state.get("tables") if isinstance(state, dict)
              else getattr(state, "tables", None))
    return WindowState(index=index_from_ref(_get(state, "index"), device),
                       **{f: _tensor(_get(state, f), np.int32, device)
                          for f in _COUNTERS},
                       tables=None if tables is None
                       else tables_from_ref(tables, device))


def _take(x, d: int):
    """Shard ``d`` of a reference value whose leaves carry a leading [D]
    axis, as dicts of numpy arrays."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _take(v, d) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return {f: _take(getattr(x, f), d) for f in x._fields}
    return np.asarray(x)[d]


def sharded_window_from_ref(state, device=None):
    """The port's ``ShardedWindowState`` from the reference's (leaves
    [D, ...], alias tables included when present): one ``WindowState``
    per shard, every shard on ``device`` (CUDA unless named)."""
    from repro_torch.distributed.streaming_shard import ShardedWindowState
    device = resolve_device(device)
    xdrops = np.asarray(_get(state, "exchange_drops"), np.int32)
    window = _get(state, "window")
    return ShardedWindowState(
        window=tuple(window_from_ref(_take(window, d), device)
                     for d in range(xdrops.shape[0])),
        exchange_drops=tuple(_tensor(x, np.int32, device) for x in xdrops))


def lanes_from_ref(lanes, device=None) -> LaneParams:
    """The port's ``LaneParams`` from the reference's (same fields)."""
    device = resolve_device(device)
    fields = {}
    for f in LaneParams._fields:
        x = _get(lanes, f)
        if x is None:
            fields[f] = None
        elif f == "active":
            fields[f] = _tensor(x, np.bool_, device)
        elif f in ("n2v_p", "n2v_q"):
            fields[f] = _tensor(x, np.float32, device)
        else:
            fields[f] = _tensor(x, np.int32, device)
    return LaneParams(**fields)


def tree_from_ref(tree, device=None):
    """A tree of tensors (dtypes kept) from the reference's dicts, lists,
    tuples and NamedTuples of arrays; None stays None."""
    device = resolve_device(device)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_from_ref(v, device) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_from_ref(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_ref(v, device) for v in tree)
    return torch.as_tensor(np.array(tree)).to(device)


def skipgram_state_from_ref(state, device=None) -> SkipgramState:
    """The port's ``SkipgramState`` from the reference's (same fields)."""
    device = resolve_device(device)
    return SkipgramState(
        emb_in=_tensor(_get(state, "emb_in"), np.float32, device),
        emb_out=_tensor(_get(state, "emb_out"), np.float32, device))


def opt_state_from_ref(state, device=None) -> OptState:
    """The port's ``OptState`` from the reference's: the int32 step and
    the ``mu``/``nu``/``error`` trees (dicts, lists, tuples)."""
    device = resolve_device(device)
    return OptState(step=_tensor(_get(state, "step"), np.int32, device),
                    **{f: tree_from_ref(_get(state, f), device)
                       for f in ("mu", "nu", "error")})


# ---------------------------------------------------------------------------
# The walk-native LM (repro_torch.models)
# ---------------------------------------------------------------------------
#
# The reference's LM params are a tree {"embed": {"table"}, "final_norm",
# "layers": [segment trees], "unembed"?, and for enc_dec "enc_layers":
# [segment trees], "enc_norm"}; segment si holds {"pos{j}": layer tree}
# with every leaf stacked [n_periods, ...] by jax.vmap (an enc-dec
# decoder layer's tree also holds "norm_x" and "cross"). The port's
# ``TransformerLM`` unstacks them: its parameter
# ``layers.{si}.{period}.pos{j}.<path>`` is row ``period`` of the leaf at
# ``layers/{si}/pos{j}/<path>``, and ``enc_layers`` likewise; every other
# parameter ``a.b`` is the leaf at ``a/b``. Optimiser moments have the
# params' structure on both sides.

_STACKS = ("layers", "enc_layers")


def _lm_skeleton(cfg):
    """A ``TransformerLM`` of ``cfg`` on the meta device: names, shapes
    and module structure, no storage."""
    from repro_torch.models.model import TransformerLM
    return TransformerLM(cfg, None, "meta")


def _torch_from_array(x, device) -> torch.Tensor:
    """A tensor from an array (numpy, or anything ``numpy.asarray``
    takes), bfloat16 included, with its dtype kept."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                                .copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _ref_leaf(tree, name: str):
    """(leaf, period) of the reference tree for a port parameter name;
    period is None outside the stacked layers."""
    parts = name.split(".")
    if parts[0] in _STACKS:
        node = tree[parts[0]][int(parts[1])]
        period, parts = int(parts[2]), parts[3:]
    else:
        node, period = tree, None
    for p in parts:
        node = node[p]
    return node, period


def lm_tree_from_ref(tree, cfg, device=None):
    """Port parameter names → tensors, from a reference params (or moment)
    tree of ``cfg``'s model: each stacked leaf split over its periods."""
    device = resolve_device(device)
    out, cache = {}, {}
    for name, _ in _lm_skeleton(cfg).named_parameters():
        leaf, period = _ref_leaf(tree, name)
        if id(leaf) not in cache:
            cache[id(leaf)] = np.asarray(leaf)
        arr = cache[id(leaf)]
        out[name] = _torch_from_array(arr if period is None else arr[period],
                                      device)
    return out


def lm_tree_to_ref(named, cfg):
    """The reference's tree (numpy leaves, stacked over periods, empty
    dicts for norms without parameters) from port names → tensors."""
    def arr(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def module_tree(mod, prefix):
        node = {n: arr(named[prefix + n])
                for n, _ in mod.named_parameters(recurse=False)}
        for n, child in mod.named_children():
            node[n] = module_tree(child, f"{prefix}{n}.")
        return node

    skel = _lm_skeleton(cfg)
    tree = {}
    for n, child in skel.named_children():
        if n not in _STACKS:
            tree[n] = module_tree(child, n + ".")
            continue
        tree[n] = [_stack_trees([module_tree(period, f"{n}.{si}.{pi}.")
                                 for pi, period in enumerate(seg)])
                   for si, seg in enumerate(child)]
    return tree


def _stack_trees(trees):
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def lm_params_from_ref(params, cfg, device=None):
    """A ``TransformerLM`` holding the reference's params (``init_params``
    output or a restored checkpoint), on CUDA unless ``device`` names
    another."""
    from repro_torch.models.model import TransformerLM, bind_params
    device = resolve_device(device)
    model = TransformerLM(cfg, None, device)
    bind_params(model, lm_tree_from_ref(params, cfg, device))
    return model


def lm_params_to_ref(model, cfg=None):
    """The reference's params tree (numpy) of a ``TransformerLM``."""
    from repro_torch.models.model import params_of
    return lm_tree_to_ref(params_of(model), cfg or model.cfg)


def lm_opt_state_from_ref(state, cfg, device=None) -> OptState:
    """An LM ``OptState`` (moments by port parameter name) from the
    reference's."""
    device = resolve_device(device)
    error = _get(state, "error")
    return OptState(step=_tensor(_get(state, "step"), np.int32, device),
                    mu=lm_tree_from_ref(_get(state, "mu"), cfg, device),
                    nu=lm_tree_from_ref(_get(state, "nu"), cfg, device),
                    error=None if error is None
                    else lm_tree_from_ref(error, cfg, device))


def lm_opt_state_to_ref(state: OptState, cfg) -> OptState:
    """The reference's ``OptState`` layout (numpy leaves) of an LM
    ``OptState``: what ``train.checkpoint.save`` writes in its format."""
    return OptState(step=np.asarray(state.step.cpu(), np.int32),
                    mu=lm_tree_to_ref(state.mu, cfg),
                    nu=lm_tree_to_ref(state.nu, cfg),
                    error=None if state.error is None
                    else lm_tree_to_ref(state.error, cfg))


def decode_state_from_ref(state, cfg, device=None, pos: int = 0):
    """The port's ``DecodeState`` from the reference's: per-segment caches
    and states stacked over periods become one per layer, and one
    position. ``KVCache`` ``k``/``v`` ``[n_periods, B, S_max, Hkv, D]`` go
    to ``[B, Hkv, S_max, D]``; ``MLACache`` ``c_kv``/``k_rope`` and the
    SSM states (``MambaState`` ``h [n_periods, B, di, N]``, ``conv``;
    ``MLSTMState`` ``C``, ``n``, ``m``; ``SLSTMState`` ``c``, ``n``,
    ``h``, ``m``) keep their layout. The position is the attention
    caches' (every layer's is the same); a model without attention
    tracks none in the reference, so it is ``pos``. An enc-dec state's
    ``enc_out`` and ``enc_pos`` (the encoder memory) come across as they
    are."""
    from repro_torch.models.attention import KVCache, MLACache
    from repro_torch.models.model import DecodeState
    from repro_torch.models.ssm import MambaState, MLSTMState, SLSTMState
    from repro_torch.models.transformer import build_segments
    device = resolve_device(device)
    states = {"mamba": MambaState, "mlstm": MLSTMState, "slstm": SLSTMState,
              "attn": MLACache if cfg.attention.kind == "mla" else KVCache}
    caches, positions = [], []
    for si, seg in enumerate(build_segments(cfg)):
        seg_state = _get(state, "caches")[si]
        for p in range(seg.n_periods):
            for j, spec in enumerate(seg.period):
                c = seg_state[f"pos{j}"]
                kind = states[spec.kind]
                if kind is not KVCache:
                    caches.append(kind(*(
                        _torch_from_array(np.asarray(_get(c, f))[p], device)
                        for f in kind._fields)))
                else:
                    k, v = (_torch_from_array(np.asarray(_get(c, f))[p],
                                              device)
                            .permute(0, 2, 1, 3).contiguous() for f in "kv")
                    caches.append(KVCache(k=k, v=v))
                if spec.kind == "attn":
                    positions.append(int(np.asarray(_get(c, "pos"))[p]))
    if len(set(positions)) > 1:
        raise ValueError(f"layers at different positions: {positions}")
    memory = {f: _torch_from_array(state[f], device)
              for f in ("enc_out", "enc_pos")
              if isinstance(state, dict) and state.get(f) is not None}
    return DecodeState(caches=caches,
                       pos=torch.tensor(positions[0] if positions else pos,
                                        dtype=torch.int32, device=device),
                       **memory)
