"""Fused exp-weight + exclusive prefix sum (paper Table 4 "weight" stage).

``weight_prefix(dt, valid, scale)`` returns ``P`` of length E+1 with
``P[0] = 0`` and ``P[i+1] = P[i] + (valid[i] ? exp(scale·dt[i]) : 0)``:
the reference's Pallas kernel kernels/weight_prefix.py::weight_prefix and
oracle kernels/ref.py::weight_prefix_ref. The index build computes
``pexp`` and ``pexp_store`` through it.

A CUDA tensor goes to the Hopper kernel (csrc/weight_prefix.cu); a CPU
tensor goes to the plain version ``weight_prefix_plain``. The plain
version accumulates in float64 and rounds once, so at a multi-million-edge
window it is the exact prefix to within half an ulp; ``error_in_u``
measures the kernel's float32 chain against it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p]
_BLOCK_ELEMS = 4096      # kBlockElems in csrc/weight_prefix.cu
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
    nblk = -(-E // _BLOCK_ELEMS)
    scratch = torch.empty(2 * nblk, dtype=torch.float32, device=dt.device)
    fn = runtime.kernel("repro_weight_prefix", _ARGTYPES)
    status = fn(dt.data_ptr(), valid.data_ptr(), float(scale), E,
                out.data_ptr(), scratch.data_ptr(), runtime.stream())
    runtime.check(status, "weight_prefix")
    runtime.LAUNCHES["weight_prefix"] += 1
    return out
