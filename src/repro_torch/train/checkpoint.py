"""Leaf checkpoints and sharded-window checkpoints (DESIGN.md §15),
PyTorch port of repro/train/checkpoint.py.

The on-disk format is the reference's, so a checkpoint written by either
package restores in the other:

* one ``.npy`` per leaf, named by the leaf's path with ``/`` → ``__``
  (``state/.window/.index/.store/.src`` is
  ``state__.window__.index__.store__.src.npy``): a dict key is itself, a
  NamedTuple field ``.name``, a sequence position its index, and a None
  field has no leaf;
* ``manifest.json``: ``{"step": …, "leaves": {path: {"shape", "dtype"}}}``;
* every file is written to a temporary name and renamed, so a write cut
  short never corrupts the previous checkpoint.

``save_sharded_window`` persists a ``ShardedWindowState`` with every leaf
stacked ``[D, …]`` over its shards, the walk key as ``uint32[2]``, and
``placement.json`` (the placement's ``describe()`` and the window's
geometry). ``restore_sharded_window`` splits the leaves back onto each
shard's device; given another shard count or placement it re-buckets the
window through ``reshard_host`` (the elastic restore), keeping the edge
multiset up to the counted per-shard capacity clip.

``save``/``restore`` are the generic leaf writer and reader; their use
for model parameters and optimiser state comes with the training loop,
which is not ported yet.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_MANIFEST = "manifest.json"
_PLACEMENT = "placement.json"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map_with_paths(tree, fn, prefix: Tuple[str, ...] = ()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``; dicts,
    NamedTuples, tuples and lists are containers, None is empty and stays
    None, anything else is a leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_paths(tree[k], fn, prefix + (str(k),))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(
            _map_with_paths(getattr(tree, f), fn, prefix + ("." + f,))
            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_paths(x, fn, prefix + (str(i),))
                          for i, x in enumerate(tree))
    return fn("/".join(prefix), tree)


def _flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in the reference's order and with its path names."""
    items: List[Tuple[str, Any]] = []
    _map_with_paths(tree, lambda k, leaf: items.append((k, leaf)))
    return items


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _write_atomic(path: str, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _leaf_file(ckpt_dir: str, key: str) -> str:
    return os.path.join(ckpt_dir, key.replace("/", "__") + ".npy")


def save(ckpt_dir: str, tree, step: int) -> None:
    """Write every leaf of ``tree`` (tensors or arrays) and the manifest."""
    os.makedirs(ckpt_dir, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "leaves": {}}
    for key, leaf in _flatten_with_paths(tree):
        arr = _to_numpy(leaf)
        manifest["leaves"][key] = {"shape": list(arr.shape),
                                   "dtype": str(arr.dtype)}
        _write_atomic(_leaf_file(ckpt_dir, key),
                      lambda f, a=arr: np.save(f, a, allow_pickle=False))
    _write_atomic(os.path.join(ckpt_dir, _MANIFEST),
                  lambda f: f.write(json.dumps(manifest).encode()))


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, _MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["step"]


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def restore(ckpt_dir: str, target_tree):
    """Restore into the structure of ``target_tree``, whose leaves give
    each leaf's shape and torch dtype (meta tensors will do). Leaves come
    back as CPU tensors."""
    with open(os.path.join(ckpt_dir, _MANIFEST)) as f:
        manifest = json.load(f)

    def load(key, ref):
        if key not in manifest["leaves"]:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(_leaf_file(ckpt_dir, key), allow_pickle=False)
        if list(arr.shape) != list(ref.shape):
            raise ValueError(
                f"{key}: checkpoint shape {arr.shape} != target "
                f"{tuple(ref.shape)}")
        return torch.from_numpy(arr.astype(_numpy_dtype(ref.dtype),
                                           copy=False))
    return _map_with_paths(target_tree, load)


# ---------------------------------------------------------------------------
# Sharded-window checkpoints: ShardedWindowState + placement manifest, with
# the elastic (shard-count / policy-changing) restore (DESIGN.md §15)
# ---------------------------------------------------------------------------


def _stack(trees):
    """Per-shard trees → one tree of numpy arrays stacked ``[D, …]``."""
    first = trees[0]
    if first is None:
        return None
    if _is_namedtuple(first):
        return type(first)(*(_stack([getattr(t, f) for t in trees])
                             for f in first._fields))
    return np.stack([_to_numpy(t) for t in trees])


def _unstack(tree, d: int):
    """Shard ``d`` of a tree stacked ``[D, …]``."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(_unstack(x, d) for x in tree))
    return tree[d]


def save_sharded_window(ckpt_dir: str, state, placement, step: int,
                        walk_key=None) -> None:
    """Persist a ``ShardedWindowState``, its placement and the walk key.

    ``placement`` is the ``Placement`` that produced the layout (saved as
    its ``describe()``, routing and override tables included);
    ``walk_key`` is the engine's key, without which a restored replay
    could not continue the walk stream (``replay_device`` splits it per
    call)."""
    from repro_torch import random as prng
    from repro_torch.distributed.streaming_shard import ShardedWindowState
    stacked = ShardedWindowState(window=_stack(list(state.window)),
                                 exchange_drops=_stack(
                                     list(state.exchange_drops)))
    tree = {"state": stacked}
    if walk_key is not None:
        tree["walk_key"] = np.asarray(prng.key_words(walk_key), np.uint32)
    save(ckpt_dir, tree, step)
    w = stacked.window
    meta = {
        "placement": placement.describe(),
        "num_shards": int(stacked.exchange_drops.shape[0]),
        "edge_capacity_per_shard": int(w.index.store.src.shape[1]),
        # node_starts spans nc real nodes + the padding node, with one
        # extra boundary entry: [D, nc + 2]
        "node_capacity": int(w.index.node_starts.shape[1]) - 2,
        "window": int(np.max(w.window)),
        "step": step,
        "has_walk_key": walk_key is not None,
    }
    _write_atomic(os.path.join(ckpt_dir, _PLACEMENT),
                  lambda f: f.write(json.dumps(meta).encode()))


def load_placement_manifest(ckpt_dir: str) -> Dict[str, Any]:
    with open(os.path.join(ckpt_dir, _PLACEMENT)) as f:
        return json.load(f)


def _stacked_target(D: int, edge_capacity: int, node_capacity: int,
                    window: int):
    """Shape-and-dtype target of a saved D-shard window: meta tensors
    ``[D, …]`` shaped like an empty window of that geometry."""
    from repro_torch.core.window import init_window
    from repro_torch.distributed.streaming_shard import ShardedWindowState
    template = init_window(edge_capacity, node_capacity, window,
                           device="cpu")

    def spec(x):
        return None if x is None else torch.empty(
            (D,) + tuple(x.shape), dtype=x.dtype, device="meta")
    return ShardedWindowState(
        window=_map_with_paths(template, lambda _, x: spec(x)),
        exchange_drops=spec(torch.zeros((), dtype=torch.int32)))


def restore_sharded_window(ckpt_dir: str, *, placement=None,
                           num_shards: Optional[int] = None,
                           bias_scale: float = 1.0, devices=None):
    """Restore a sharded window, optionally onto another layout.

    With no target the window comes back as saved: same shard count and
    placement, leaves byte-equal. ``placement`` (a ``Placement``) or
    ``num_shards`` (the saved policy kind at the new count; skew hub
    overrides are dropped, since they index the old shard space)
    re-bucket the edges through ``reshard_host``. Shard d lands on the
    d-th of ``devices`` (default: the visible CUDA devices; name a device
    D times for D shards on it).

    Returns ``(state, placement, walk_key)``; ``walk_key`` is None when
    none was saved.
    """
    from repro_torch.distributed.collectives import make_group, tree_to
    from repro_torch.distributed.placement import (
        make_placement,
        placement_from_manifest,
    )
    from repro_torch.distributed.streaming_shard import (
        ShardedWindowState,
        reshard_host,
    )

    meta = load_placement_manifest(ckpt_dir)
    old_placement = placement_from_manifest(meta["placement"])
    D_old = meta["num_shards"]
    target = {"state": _stacked_target(
        D_old, meta["edge_capacity_per_shard"], meta["node_capacity"],
        meta["window"])}
    if meta["has_walk_key"]:
        target["walk_key"] = torch.empty(2, dtype=torch.int64, device="meta")
    tree = restore(ckpt_dir, target)
    stacked = tree["state"]
    state = ShardedWindowState(
        window=tuple(_unstack(stacked.window, d) for d in range(D_old)),
        exchange_drops=tuple(stacked.exchange_drops[d]
                             for d in range(D_old)))
    walk_key = tree.get("walk_key")

    if placement is None:
        if num_shards is None or num_shards == D_old:
            placement = old_placement
        else:
            kind = meta["placement"]["kind"]
            placement = make_placement(
                kind if kind in ("range", "hash") else "range",
                num_shards, meta["node_capacity"])
    if placement.node_capacity != meta["node_capacity"]:
        raise ValueError(
            f"target placement node_capacity {placement.node_capacity} != "
            f"checkpoint {meta['node_capacity']}")
    group = make_group(placement.num_shards, devices)
    if placement != old_placement:
        state = reshard_host(state, placement, bias_scale=bias_scale,
                             mesh=group)
    else:
        state = ShardedWindowState(*(
            tuple(tree_to(x, dev) for x, dev in zip(leaves, group.devices))
            for leaves in state))
    return state, placement, walk_key
