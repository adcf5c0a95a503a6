"""Fused exp-weight + exclusive prefix sum (paper Table 4 "weight" stage).

``weight_prefix(dt, valid, scale)`` returns ``P`` of length E+1 with
``P[0] = 0`` and ``P[i+1] = P[i] + (valid[i] ? exp(scale·dt[i]) : 0)``:
the reference's Pallas kernel kernels/weight_prefix.py::weight_prefix and
oracle kernels/ref.py::weight_prefix_ref. The index build computes
``pexp`` and ``pexp_store`` through it.

A CUDA tensor goes to the Hopper kernel (csrc/weight_prefix.cu, one
launch: a single-pass scan with decoupled look-back, chained across tiles
in float64, whose output is the same on every run and non-decreasing); a
CPU tensor goes to the plain version ``weight_prefix_plain``. The plain
version accumulates in float64 and rounds once, so at a multi-million-edge
window it is the exact prefix to within half an ulp; ``error_in_u``
measures the kernel's float32 scan against it.

The kernel's look-back reads per-tile status words from a workspace that
is kept per (device, stream). Each call tags its words with a new epoch,
so calls do not clear them: the workspace is zeroed only when it is
allocated or grown (or after 2^31 - 1 calls, when the epochs wrap).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_uint, ctypes.c_void_p]
_TILE = 8192             # kTile in csrc/weight_prefix.cu
_EPOCHS = 1 << 31        # a status word's flag holds epochs 1 .. 2^31 - 1
_U = 2.0 ** -24          # float32 unit roundoff
# The kernel may differ from the plain version by this many units of
# float32 roundoff of P (``error_in_u``). PERF.md gives the on-card
# readings it is set from, on a sound kernel and on one with a block
# total dropped.
TOL_U = 8.0


def weight_prefix_plain(dt: torch.Tensor, valid: torch.Tensor,
                        scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version: masked float32 exp, then a float64
    ``torch.cumsum`` rounded to float32 (non-decreasing, like the kernel)."""
    w = torch.where(valid, torch.exp(scale * dt.to(torch.float32)),
                    torch.zeros((), dtype=torch.float32, device=dt.device))
    zero = torch.zeros(1, dtype=torch.float64, device=dt.device)
    return torch.cat([zero, torch.cumsum(w.double(), 0)]).float()


def error_in_u(got: torch.Tensor, want: torch.Tensor) -> float:
    """max_i |got_i - want_i| / (u · max(want_i, FLT_MIN)) with u = 2^-24:
    the error of a prefix in units of float32 roundoff of its own value."""
    scale = want.double().clamp(min=torch.finfo(torch.float32).tiny) * _U
    return ((got.double() - want.double()).abs() / scale).max().item()


def weight_prefix(dt: torch.Tensor, valid: torch.Tensor,
                  scale: float = 1.0) -> torch.Tensor:
    """float32[E+1] exclusive prefix of the masked exponential weights."""
    if dt.device.type == "cpu":
        return weight_prefix_plain(dt, valid, scale)
    E = dt.shape[0]
    runtime.expect(dt, "dt", torch.float32, (E,), dt.device)
    runtime.expect(valid, "valid", torch.bool, (E,), dt.device)
    out = torch.empty(E + 1, dtype=torch.float32, device=dt.device)
    if E == 0:
        return out.zero_()
    workspace, epoch = _workspace(-(-E // _TILE), dt.device)
    fn = runtime.kernel("repro_weight_prefix", _ARGTYPES)
    status = fn(dt.data_ptr(), valid.data_ptr(), float(scale), E,
                out.data_ptr(), workspace.data_ptr(), epoch,
                runtime.stream())
    runtime.check(status, "weight_prefix")
    runtime.LAUNCHES["weight_prefix"] += 1
    return out


# (device, stream) -> [workspace, last epoch]
_WORKSPACES: dict = {}


def _workspace(ntiles: int, device: torch.device):
    """The look-back workspace of the current stream (a tile counter, one
    status word per tile, one float64 prefix per tile) and this call's
    epoch. Zeroed only when it is allocated, grown, or its epochs run
    out."""
    key = (device, runtime.stream())
    entry = _WORKSPACES.get(key)
    if entry is None or entry[0].numel() < 2 * ntiles + 1:
        entry = [torch.zeros(2 * ntiles + 1, dtype=torch.int64,
                             device=device), 0]
        _WORKSPACES[key] = entry
    elif entry[1] + 1 >= _EPOCHS:
        entry[0].zero_()
        entry[1] = 0
    entry[1] += 1
    return entry[0], entry[1]
