"""Counter-based threefry2x32 keys, bit-for-bit with ``jax.random``.

The reference draws every random number from ``jax.random`` in its
default partitionable threefry mode, so walks can only be compared byte
for byte if the port reproduces those bits exactly:

* ``PRNGKey(seed)``   — ``[seed >> 32, seed & 0xFFFFFFFF]``;
* ``split(key, n)``   — key i is ``threefry(key, (0, i))``, both words;
* ``fold_in(key, d)`` — ``threefry(key, (0, d))``;
* ``uniform(key, shape)`` — for flat index i, bits =
  ``y0 ^ y1`` of ``threefry(key, (i >> 32, i & 0xFFFFFFFF))``, then the
  float32 in [0, 1) with mantissa ``bits >> 9``.

A key is an int64 tensor of shape ``(2,)`` holding the two uint32 words
(on the CPU: key arithmetic is a handful of integer ops, done on the
host so no draw waits for the device). All uint32 arithmetic is done in
int64 with masks, so the same ``_threefry2x32`` body runs on Python ints
and on int64 tensors of any device.

Per-lane batches carry one key per lane: an int64 tensor ``[W, 2]`` on
the lanes' device. ``fold_in_lanes`` and ``uniform_lanes`` are
``jax.vmap(jax.random.fold_in)`` and ``jax.vmap(lambda k:
jax.random.uniform(k, ()))`` over such a tensor, or over a ``[T, W, 2]``
stack of them.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

from repro_torch.kernels.runtime import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3F800000          # float32 1.0

KeyLike = Union[torch.Tensor, Sequence[int]]


def _rotl(v, r: int):
    return ((v << r) & _MASK) | (v >> (32 - r))


def _threefry2x32(k1: int, k2: int, x0, x1):
    """Threefry-2x32, 20 rounds; ``x0``/``x1`` are ints or int64 tensors
    holding uint32 values. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key_words(key: KeyLike) -> Tuple[int, int]:
    """The two uint32 words of a key as Python ints."""
    if isinstance(key, torch.Tensor):
        key = key.tolist()
    k1, k2 = (int(k) & _MASK for k in key)
    return k1, k2


def _key(k1: int, k2: int) -> torch.Tensor:
    return torch.tensor([k1, k2], dtype=torch.int64)


def PRNGKey(seed: int) -> torch.Tensor:
    """Raw key from an integer seed (``jax.random.PRNGKey``)."""
    seed = int(seed)
    if -(1 << 31) <= seed < (1 << 31):
        return _key(0, seed & _MASK)
    return _key((seed >> 32) & _MASK, seed & _MASK)


def split(key: KeyLike, num: int = 2) -> torch.Tensor:
    """``num`` new keys, int64 ``[num, 2]`` (``jax.random.split``)."""
    k1, k2 = key_words(key)
    y0, y1 = _threefry2x32(k1, k2, torch.zeros(num, dtype=torch.int64),
                           torch.arange(num, dtype=torch.int64))
    return torch.stack([y0, y1], dim=1)


def fold_in(key: KeyLike, data: int) -> torch.Tensor:
    """Key folded with a uint32 tag (``jax.random.fold_in``)."""
    k1, k2 = key_words(key)
    y0, y1 = _threefry2x32(k1, k2, 0, int(data) & _MASK)
    return _key(y0, y1)


def fold_in_lanes(keys: KeyLike, data) -> torch.Tensor:
    """Keys folded with tags (``jax.vmap(jax.random.fold_in)``): ``keys``
    is one key or int64 ``[..., 2]``, ``data`` a Python int or an integer
    tensor that broadcasts against the keys' leading shape (int32 values
    are taken as uint32, as ``fold_in`` does). Returns int64 ``[..., 2]``
    on the device of the tensors given."""
    if isinstance(keys, torch.Tensor) and keys.dim() > 1:
        k1, k2 = keys[..., 0], keys[..., 1]
    else:
        k1, k2 = key_words(keys)
    data = (data.to(torch.int64) if isinstance(data, torch.Tensor)
            else int(data)) & _MASK
    y0, y1 = _threefry2x32(k1, k2, 0, data)
    return torch.stack([y0, y1], dim=-1)


def uniform_lanes(keys: torch.Tensor) -> torch.Tensor:
    """One float32 U[0, 1) per key of int64 ``[..., 2]`` (``uniform(k, ())``
    of each), on the keys' device."""
    y0, y1 = _threefry2x32(keys[..., 0], keys[..., 1], 0, 0)
    return _to_unit_float(y0 ^ y1)


def _to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    f = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: KeyLike, shape: Sequence[int],
            device: torch.device | str | None = None) -> torch.Tensor:
    """float32 U[0, 1) of ``shape`` (``jax.random.uniform``), on CUDA unless
    ``device`` names another."""
    k1, k2 = key_words(key)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=resolve_device(device))
    y0, y1 = _threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return _to_unit_float((y0 ^ y1).reshape(tuple(shape)))
