"""Counter-based threefry2x32 keys, bit-for-bit with ``jax.random``.

The reference draws every random number from ``jax.random`` in its
default partitionable threefry mode, so walks can only be compared byte
for byte if the port reproduces those bits exactly:

* ``PRNGKey(seed)``   — ``[seed >> 32, seed & 0xFFFFFFFF]``;
* ``split(key, n)``   — key i is ``threefry(key, (0, i))``, both words;
* ``fold_in(key, d)`` — ``threefry(key, (0, d))``;
* ``uniform(key, shape)`` — for flat index i, bits =
  ``y0 ^ y1`` of ``threefry(key, (i >> 32, i & 0xFFFFFFFF))``, then the
  float32 in [0, 1) with mantissa ``bits >> 9``;
* ``randint(key, shape, lo, hi)`` — ``k1, k2 = split(key)``, a high and a
  low word of bits from each, folded into ``[0, span)`` by
  ``((hi mod span)·m + lo mod span) mod span`` in uint32, with jax's
  ``m = (2^16 mod span)^2 mod span``, whose square wraps in uint32 (so
  ``m = 0`` for spans above 2^16);
* ``normal(key, shape)`` — a uniform on ``[nextafter(-1, 0), 1)``, then
  ``sqrt(2)·erfinv``. ``torch.erfinv`` is not XLA's ``erf_inv`` (both
  approximate), so normals agree with jax's to a stated tolerance only.

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

import numpy as np
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


def split_chain(key: KeyLike, num: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``num`` successive ``key, sub = split(key)``: returns the last key
    and the ``num`` subkeys, int64 ``[num, 2]``, computed on Python ints
    (a host loop that calls ``split`` per step pays ~100 tiny tensor ops
    each time)."""
    k1, k2 = key_words(key)
    subs = []
    for _ in range(num):
        a = _threefry2x32(k1, k2, 0, 0)
        subs.append(_threefry2x32(k1, k2, 0, 1))
        k1, k2 = a
    return _key(k1, k2), torch.tensor(subs, dtype=torch.int64).reshape(
        num, 2)


def _to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    f = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: KeyLike, shape: Sequence[int],
            device: torch.device | str | None = None,
            minval: float = 0.0, maxval: float = 1.0,
            start: int = 0) -> torch.Tensor:
    """float32 U[minval, maxval) of ``shape`` (``jax.random.uniform``), on
    CUDA unless ``device`` names another: the unit floats, then
    ``max(minval, floats·(maxval − minval) + minval)`` with the bounds
    taken as float32. XLA fuses the product and the sum into one
    multiply-add, rounded once; here both are taken in float64, where
    they are exact for bounds of like magnitude, and rounded once.

    ``start`` draws counters ``[start, start + prod(shape))`` of the
    key's stream: in the partitionable layout element ``i`` of a draw
    depends on counter ``i`` alone, so a draw of ``n`` elements is the
    concatenation of its slabs, each drawn with its own ``start``."""
    k1, k2 = key_words(key)
    bits = _bits(k1, k2, math.prod(shape), resolve_device(device), start)
    u = _to_unit_float(bits.reshape(tuple(shape)))
    if (minval, maxval) == (0.0, 1.0):
        return u
    lo, hi = np.float32(minval), np.float32(maxval)
    u = (u.double() * float(hi - lo) + float(lo)).to(torch.float32)
    return torch.clamp_min(u, float(lo))


def _bits(k1, k2, n: int, device, start: int = 0) -> torch.Tensor:
    """jax's 32-bit ``random_bits`` at counters ``[start, start + n)``:
    int64 ``[..., n]`` holding uint32, for keys given as ints or int64
    ``[..., 1]``."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    y0, y1 = _threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return y0 ^ y1


def randint_keys(keys: torch.Tensor, shape: Sequence[int], minval: int,
                 maxval: int, device: torch.device | str | None = None
                 ) -> torch.Tensor:
    """int32 ``[S, *shape]``: row s is ``jax.random.randint(keys[s], shape,
    minval, maxval)`` for the S keys of int64 ``[S, 2]``, drawn in one
    batch on CUDA unless ``device`` names another. ``minval`` and
    ``maxval`` are Python ints in the int32 range, as jax takes them."""
    device = resolve_device(device)
    lo_v, hi_v = int(minval), int(maxval)
    if not -(1 << 31) <= min(lo_v, hi_v) <= max(lo_v, hi_v) < (1 << 31):
        raise OverflowError(f"randint bounds {lo_v}, {hi_v} leave int32")
    span = hi_v - lo_v if hi_v > lo_v else 1
    # jax's multiplier, (2^16 mod span)^2 mod span with the square taken
    # in uint32: it wraps to 0 for every span above 2^16
    mult = (((1 << 16) % span) ** 2 & _MASK) % span
    # split each key on the host: k1 = threefry(key, (0, 0)), k2 = (0, 1)
    kk = torch.as_tensor(keys, dtype=torch.int64).cpu()
    a = _threefry2x32(kk[:, 0], kk[:, 1], 0, 0)
    b = _threefry2x32(kk[:, 0], kk[:, 1], 0, 1)
    words = torch.stack(a + b, dim=1).to(device, non_blocking=True)
    n = math.prod(shape)
    hi = _bits(words[:, 0:1], words[:, 1:2], n, device)
    lo = _bits(words[:, 2:3], words[:, 3:4], n, device)
    # uint32 arithmetic: the product wraps before the sum, the sum before
    # the last remainder
    off = (((hi % span) * mult & _MASK) + lo % span) & _MASK
    out = (off % span + lo_v + (1 << 31) & _MASK) - (1 << 31)  # int32 wrap
    return out.to(torch.int32).reshape((kk.shape[0],) + tuple(shape))


def randint(key: KeyLike, shape: Sequence[int], minval: int, maxval: int,
            device: torch.device | str | None = None) -> torch.Tensor:
    """int32 in ``[minval, maxval)`` of ``shape``, bit for bit
    ``jax.random.randint``, on CUDA unless ``device`` names another."""
    keys = torch.tensor([key_words(key)], dtype=torch.int64)
    return randint_keys(keys, shape, minval, maxval, device)[0]


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key: KeyLike, shape: Sequence[int],
           device: torch.device | str | None = None) -> torch.Tensor:
    """float32 standard normals of ``shape`` (``jax.random.normal``), on
    CUDA unless ``device`` names another: jax's uniform on
    ``[nextafter(-1, 0), 1)`` bit for bit, then ``sqrt(2)·erfinv`` by
    ``torch.erfinv``, which differs from XLA's ``erf_inv`` in its last
    bits."""
    u = uniform(key, shape, device)
    # uniform(minval=lo, maxval=1): floats·(1 − lo) + lo, where 1 − lo
    # rounds to 2.0 in float32, then max(lo, ·)
    u = torch.clamp_min(u * 2.0 + _NORMAL_LO, _NORMAL_LO)
    return torch.erfinv(u) * _SQRT2


def truncated_normal(key: KeyLike, lower: float, upper: float,
                     shape: Sequence[int],
                     device: torch.device | str | None = None,
                     start: int = 0) -> torch.Tensor:
    """float32 normals truncated to ``(lower, upper)`` (``jax.random.
    truncated_normal``), on CUDA unless ``device`` names another.

    jax's algorithm: ``a, b = erf(lower/√2), erf(upper/√2)`` in float32,
    a uniform on ``[a, b)`` from the key's bits (equal to jax's), then
    ``√2·erfinv(u)`` clipped to ``(nextafter(lower, +inf),
    nextafter(upper, −inf))``. ``torch.erf``/``torch.erfinv`` are not
    XLA's approximations, so values agree with jax's within the
    ``erfinv`` gap of ``normal``. ``start`` draws counters ``[start,
    start + prod(shape))``, as ``uniform`` does."""
    lo, hi = np.float32(lower), np.float32(upper)
    ends = torch.erf(torch.tensor([lo, hi], dtype=torch.float32)
                     / torch.tensor(_SQRT2, dtype=torch.float32))
    a, b = (float(x) for x in ends)
    u = uniform(key, shape, device, minval=a, maxval=b, start=start)
    out = torch.erfinv(u) * _SQRT2
    return torch.clamp(out, float(np.nextafter(lo, np.float32(np.inf))),
                       float(np.nextafter(hi, np.float32(-np.inf))))
