"""State-space and recurrent blocks: Mamba (selective SSM), xLSTM's mLSTM
(matrix memory) and sLSTM (scalar memory with exponential gating).
PyTorch port of repro/models/ssm.py.

Each block is an ``nn.Module`` whose parameters carry the reference's
leaf names and layouts (``Mamba``, ``MLSTM``, ``SLSTM``), with:

* ``forward(x, state=None)`` — a full sequence (train / prefill), the
  reference's ``lax.scan`` over time as a Python loop of eager steps
  (``_mamba_scan``, ``mlstm_forward``, ``slstm_forward``), or over
  chunks for the chunkwise-parallel mLSTM (``mlstm_forward_chunked``);
  returns ``(y, final state)``;
* ``*_init_state`` — the decode state;
* ``decode(x, state)`` — one token, its new state written into
  ``state``'s tensors in place (``copy_``), so a decode step reads
  nothing back to the host.

The arithmetic follows the reference's: the recurrences run in float32,
the projections in the compute dtype; ``A_log`` and ``gn_scale`` apply
in float32 and stay float32 under ``cast_for_serving``
(``keep_float32``); the inner norm is always rmsnorm over the flat
``gn_scale``. jax's ``softplus`` is ``logaddexp(x, 0)`` and its
``log_sigmoid`` is ``-softplus(-x)``, each with jax's derivative
(``softplus``, ``log_sigmoid``); ``F.softplus`` and ``F.logsigmoid``
round differently and ``F.softplus`` returns ``x`` above 20. The
maxima are ``torch.maximum``, whose gradient splits a tie in half as
jax's does (sLSTM's ``max(n, 1)`` ties at its first step).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import random as prng
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.distributed.sharding import hint
from repro_torch.models.layers import parameter, rmsnorm


# ---------------------------------------------------------------------------
# jax's activations
# ---------------------------------------------------------------------------


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus`` = ``logaddexp(x, 0)`` = ``max(x, 0) +
    log1p(exp(-|x|))``, with jax's derivative ``exp(x − softplus(x))``."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


class _LogSigmoid(torch.autograd.Function):
    """``jax.nn.log_sigmoid`` = ``-softplus(-x)``, computed as ``min(x, 0)
    − log1p(exp(-|x|))`` (the same bits: rounding is symmetric), with
    jax's derivative ``exp(−x − softplus(−x))``."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp_max(x, 0) - torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(out - x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return _LogSigmoid.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x · sigmoid(x)``."""
    return x * torch.sigmoid(x)


def jnp_linspace(start: float, stop: float, num: int,
                 device=None) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` (num ≥ 2) in float32, bit for
    bit as XLA's CPU backend computes it: its simplifier turns ``i / div``
    into ``i · r`` with ``r = f32(1 / div)`` and folds ``stop · r`` into
    one constant, and LLVM contracts both ``a·b + c`` into FMAs, so
    ``s_i = fma(−i, r, 1)`` and ``out_i = fma(i, stop·r, start·s_i)``,
    the end point appended. The FMAs run in float64 (the products of
    float32 operands are exact there)."""
    f32, f64 = torch.float32, torch.float64
    i = torch.arange(num - 1, dtype=f64, device=device)
    r = torch.ones((), dtype=f32, device=device) \
        / torch.tensor(num - 1, dtype=f32, device=device)
    lo = torch.tensor(start, dtype=f32, device=device)
    hi = torch.tensor(stop, dtype=f32, device=device)
    s = (1.0 - i * r.to(f64)).to(f32)
    out = (i * (hi * r).to(f64) + (lo * s).to(f64)).to(f32)
    return torch.cat([out, hi[None]])


def _constant(value: torch.Tensor, dtype) -> nn.Parameter:
    """A leaf the reference sets to a constant, stored in ``dtype`` (the
    cast ``cast_for_serving`` would make)."""
    return nn.Parameter(value.to(dtype))


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


class MambaState(NamedTuple):
    h: torch.Tensor       # [B, d_inner, N] float32
    conv: torch.Tensor    # [B, d_conv − 1, d_inner] trailing inputs, dtype


def mamba_init_state(cfg: ModelConfig, s: SSMConfig, batch: int, dtype,
                     device=None) -> MambaState:
    di = s.expand * cfg.d_model
    return MambaState(
        h=torch.zeros((batch, di, s.d_state), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, s.d_conv - 1, di), dtype=dtype,
                         device=device))


class Mamba(nn.Module):
    """The selective SSM with the reference's leaves: ``w_in [d, 2·di]``,
    ``conv_w [d_conv, di]``, ``conv_b [di]``, ``w_x [di, dt_rank + 2N]``,
    ``w_dt [dt_rank, di]``, ``dt_bias [di]``, ``A_log [di, N]`` (float32
    always), ``D [di]``, ``w_out [di, d]``; ``di = expand · d``,
    ``dt_rank = ceil(d / 16)``. The constant leaves are computed as the
    reference computes them (``jnp_linspace``); ``torch.exp``/``log``
    may round ``dt_bias`` and ``A_log`` an ulp apart from XLA's."""

    keep_float32 = ("A_log",)

    def __init__(self, key, cfg: ModelConfig, s: SSMConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg, self.s = cfg, s
        d = cfg.d_model
        di = s.expand * d
        N = s.d_state
        r = max(1, math.ceil(d / 16))
        ks = prng.split(key, 8) if key is not None else [None] * 8
        self.w_in = parameter(ks[0], (d, 2 * di), 1.0 / math.sqrt(d),
                              device, dtype)
        self.conv_w = parameter(ks[1], (s.d_conv, di),
                                1.0 / math.sqrt(s.d_conv), device, dtype)
        self.conv_b = _constant(torch.zeros(di, device=device), dtype)
        self.w_x = parameter(ks[2], (di, r + 2 * N), 1.0 / math.sqrt(di),
                             device, dtype)
        self.w_dt = parameter(ks[3], (r, di), 1.0 / math.sqrt(r), device,
                              dtype)
        self.dt_bias = _constant(torch.log(torch.exp(
            jnp_linspace(1e-3, 1e-1, di, device)) - 1.0), dtype)
        self.A_log = nn.Parameter(torch.log(torch.arange(
            1, N + 1, dtype=torch.float32, device=device).expand(di, N)
            .contiguous()))
        self.D = _constant(torch.ones(di, device=device), dtype)
        self.w_out = parameter(ks[4], (di, d), 1.0 / math.sqrt(di), device,
                               dtype)

    def forward(self, x, state: MambaState | None = None):
        """x ``[B, S, d]`` → (y ``[B, S, d]``, state)."""
        dtype = x.dtype
        if state is None:
            state = mamba_init_state(self.cfg, self.s, x.shape[0], dtype,
                                     x.device)
        xz = x @ self.w_in.to(dtype)
        y, st = _mamba_scan(self, xz, state.h, state.conv)
        return y @ self.w_out.to(dtype), st

    def decode(self, x, state: MambaState):
        """One token ``[B, 1, d]``; ``state`` is written in place."""
        y, new = self(x, state)
        _write(state, new)
        return y


def _mamba_scan(p: Mamba, xz, h0, conv0):
    """xz ``[B, S, 2·di]`` → (y ``[B, S, di]``, the state). The causal
    depthwise conv sums its K taps in order, ``((t0 + t1) + t2) + …``;
    the scan steps ``h = h·exp(dt·A) + (dt·x)·B`` in float32, one
    ``[B, di, N]`` step at a time (nothing ``[B, S, di, N]`` is made)."""
    B, S, _ = xz.shape
    di = xz.shape[-1] // 2
    N = p.A_log.shape[1]
    dtype = xz.dtype
    x_part, z = xz[..., :di], xz[..., di:]
    conv_w = p.conv_w.to(dtype)                          # [K, di]
    K = conv_w.shape[0]
    x_hist = torch.cat([conv0.to(dtype), x_part], dim=1)
    x_conv = x_hist[:, 0:S] * conv_w[0]
    for i in range(1, K):
        x_conv = x_conv + x_hist[:, i:i + S] * conv_w[i]
    x_conv = silu(x_conv + p.conv_b.to(dtype))
    new_conv = x_hist[:, S:]                             # trailing K − 1

    proj = x_conv @ p.w_x.to(dtype)
    r = p.w_dt.shape[0]
    dt_in, b_mat, c_mat = proj[..., :r], proj[..., r:r + N], proj[..., r + N:]
    dt = softplus(dt_in @ p.w_dt.to(dtype) + p.dt_bias.to(dtype))
    A = -torch.exp(p.A_log.float())                      # [di, N]

    # the per-step casts of the reference, made once for the sequence
    dt_f = dt.float()
    dtx = (dt * x_conv).float()
    b_f, c_f = b_mat.float(), c_mat[..., None].float()
    h = h0
    ys = []
    for t in range(S):
        dA = torch.exp(dt_f[:, t, :, None] * A)          # [B, di, N]
        dBx = dtx[:, t, :, None] * b_f[:, t, None, :]
        h = h * dA + dBx
        ys.append(torch.bmm(h, c_f[:, t])[..., 0].to(dtype))
    y = torch.stack(ys, 1) + x_conv * p.D.to(dtype)
    y = y * silu(z)
    return y, MambaState(h=h, conv=new_conv)


def _write(state: NamedTuple, new: NamedTuple) -> None:
    """Each tensor of ``new`` into ``state``'s, in place."""
    for dst, src in zip(state, new):
        dst.copy_(src)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory)
# ---------------------------------------------------------------------------


class MLSTMState(NamedTuple):
    C: torch.Tensor       # [B, H, dk, dv] float32
    n: torch.Tensor       # [B, H, dk]
    m: torch.Tensor       # [B, H] log-domain gate normaliser


def mlstm_init_state(cfg: ModelConfig, s: SSMConfig, batch: int, dtype,
                     device=None) -> MLSTMState:
    di = int(s.proj_factor * cfg.d_model)
    H = s.num_heads
    dh = di // H
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(C=torch.zeros((batch, H, dh, dh), **f32),
                      n=torch.zeros((batch, H, dh), **f32),
                      m=torch.full((batch, H), -1e30, **f32))


class MLSTM(nn.Module):
    """mLSTM with the reference's leaves: ``w_up [d, 2·di]``, ``wq``/``wk``/
    ``wv [di, H, dh]``, ``w_if [di, 2H]``, ``b_if [2H]`` (input gates 0,
    forget gates 3), ``gn_scale [di]`` (float32 always), ``w_down [di,
    d]``; ``di = proj_factor · d``. ``forward`` takes the chunkwise form
    when ``chunked`` (the reference's choice for train and prefill with
    ``cfg.ssm.chunked``), the sequential one otherwise."""

    keep_float32 = ("gn_scale",)

    def __init__(self, key, cfg: ModelConfig, s: SSMConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg, self.s = cfg, s
        d = cfg.d_model
        di = int(s.proj_factor * d)
        H = s.num_heads
        dh = di // H
        ks = prng.split(key, 8) if key is not None else [None] * 8
        sc, si = 1.0 / math.sqrt(d), 1.0 / math.sqrt(di)
        self.w_up = parameter(ks[0], (d, 2 * di), sc, device, dtype)
        self.wq = parameter(ks[1], (di, H, dh), si, device, dtype)
        self.wk = parameter(ks[2], (di, H, dh), si, device, dtype)
        self.wv = parameter(ks[3], (di, H, dh), si, device, dtype)
        self.w_if = parameter(ks[4], (di, 2 * H), si, device, dtype)
        self.b_if = _constant(torch.cat([
            torch.zeros(H, device=device),
            3.0 * torch.ones(H, device=device)]), dtype)
        self.gn_scale = nn.Parameter(torch.ones(di, device=device))
        self.w_down = parameter(ks[5], (di, d), si, device, dtype)

    def forward(self, x, state: MLSTMState | None = None,
                chunked: bool = False):
        if chunked:
            return mlstm_forward_chunked(self, x, state)
        return mlstm_forward(self, x, state)

    def decode(self, x, state: MLSTMState):
        """One token, sequential form; ``state`` is written in place."""
        y, new = mlstm_forward(self, x, state)
        _write(state, new)
        return y


def _mlstm_inputs(p: MLSTM, x, given_state: bool = False):
    """(q, k, v ``[B, S, H, dh]``, i_pre, f_pre ``[B, S, H]``, z ``[B, S,
    di]``) in the compute dtype. With ``given_state`` (a decode state,
    laid out by ``sharding.cache_pspec`` with ``dk`` over ``model``), q
    and k take the state's layout, as the reference's partitioner lays
    them out from the state (``hint``; read off its compiled decode
    step: q and k split over ``model`` on ``dk``, v not)."""
    dtype = x.dtype
    di = p.wq.shape[0]
    up = x @ p.w_up.to(dtype)
    u, z = up[..., :di], up[..., di:]
    dk = ("batch", None, None, "model") if given_state else ()

    def project(w, layout=()):
        y = (u @ w.to(dtype).flatten(1)).unflatten(-1, w.shape[1:])
        return hint(y, *layout) if layout else y

    q, k, v = project(p.wq, dk), project(p.wk, dk), project(p.wv)
    gates = u @ p.w_if.to(dtype) + p.b_if.to(dtype)
    H = p.wq.shape[1]
    return q, k, v, gates[..., :H], gates[..., H:], z


def _mlstm_out(p: MLSTM, y, z):
    """y ``[B, S, H, dh]`` → the block's output: rmsnorm over di with
    ``gn_scale``, the ``silu(z)`` gate, ``w_down``."""
    y = rmsnorm(y.flatten(2), p.gn_scale)
    y = y * silu(z)
    return y @ p.w_down.to(y.dtype)


def mlstm_forward(p: MLSTM, x, state: MLSTMState | None = None):
    """The stabilised mLSTM recurrence (xLSTM eqs. 19–27), one token at a
    time: x ``[B, S, d]`` → (y ``[B, S, d]``, state)."""
    B, S, _ = x.shape
    dtype = x.dtype
    given = state is not None
    if state is None:
        state = mlstm_init_state(p.cfg, p.s, B, dtype, x.device)
    q, k, v, i_pre, f_pre, z = _mlstm_inputs(p, x, given)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = q.float(), k.float(), v.float()
    i_f, f_f = i_pre.float(), f_pre.float()
    C, n, m = state
    ys = []
    for t in range(S):
        q_t, k_t, v_t, i_t = qf[:, t], kf[:, t], vf[:, t], i_f[:, t]
        logf = log_sigmoid(f_f[:, t])                    # [B, H]
        lm = logf + m
        m_new = torch.maximum(lm, i_t)
        fg = torch.exp(lm - m_new)[..., None, None]
        ig = torch.exp(i_t - m_new)[..., None, None]
        C = fg * C + ig * (k_t[..., :, None] * v_t[..., None, :]) * scale
        n = fg[..., 0] * n + ig[..., 0] * k_t * scale
        num = (q_t[..., None, :] @ C)[..., 0, :]          # bhkv,bhk->bhv
        den = torch.maximum(
            torch.abs(torch.einsum("bhk,bhk->bh", n, q_t)),
            torch.exp(-m_new))[..., None]
        ys.append((num / den).to(dtype))
        m = m_new
    return _mlstm_out(p, torch.stack(ys, 1), z), MLSTMState(C=C, n=n, m=m)


def mlstm_forward_chunked(p: MLSTM, x, state: MLSTMState | None = None):
    """The chunkwise-parallel mLSTM (the reference's derivation): within a
    chunk of ``c = min(chunk_size, S)`` tokens an attention-style causal
    score matrix with cumulative log-forget weights, across chunks the
    carried ``(C, n, m)``. Falls back to ``mlstm_forward`` when ``S % c``.
    The cumulative sum is ``torch.cumsum`` (XLA may sum in another order:
    the last bits can differ), the running max ``torch.cummax`` (exact);
    the three-operand products keep the reference's pairing."""
    B, S, _ = x.shape
    dtype = x.dtype
    if state is None:
        state = mlstm_init_state(p.cfg, p.s, B, dtype, x.device)
    c = min(p.s.chunk_size, S)
    if S % c:
        return mlstm_forward(p, x, state)
    q, k, v, i_pre, f_pre, z = _mlstm_inputs(p, x)
    scale = 1.0 / math.sqrt(q.shape[-1])
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=x.device))
    C, n, m = state
    ys = []
    for c0 in range(0, S, c):
        qf = q[:, c0:c0 + c].float()                     # [B, c, H, dk]
        kf = k[:, c0:c0 + c].float() * scale
        vf = v[:, c0:c0 + c].float()
        i_f = i_pre[:, c0:c0 + c].float()                # [B, c, H]
        logf = log_sigmoid(f_pre[:, c0:c0 + c].float())
        csum = torch.cumsum(logf, dim=1)                 # F_t, inclusive
        total = csum[:, -1]                              # F_c  [B, H]
        iw = i_f - csum                                  # i_j − F_j
        run_max = torch.cummax(iw, dim=1).values
        m_loc = csum + torch.maximum(run_max, m[:, None, :])
        m_new = m_loc[:, -1]

        # intra-chunk (attention-style, causal)
        sc = torch.einsum("bthk,bjhk->bhtj", qf, kf)
        cs_h = csum.transpose(1, 2)                      # [B, H, c]
        logw = (cs_h[:, :, :, None] - cs_h[:, :, None, :]
                + i_f.transpose(1, 2)[:, :, None, :]
                - m_loc.transpose(1, 2)[:, :, :, None])
        w = torch.where(causal, torch.exp(logw), 0.0)
        intra = torch.einsum("bhtj,bjhv->bthv", sc * w, vf)
        nrm = torch.einsum("bhtj,bjhk->bthk", w, kf)
        n_intra = torch.einsum("bthk,bthk->bth", qf, nrm)

        # inter-chunk (the boundary state, read once)
        carry_w = torch.exp(csum + m[:, None, :] - m_loc)   # [B, c, H]
        inter = torch.einsum("bthk,bhkv->bthv", qf, C) * carry_w[..., None]
        n_inter = torch.einsum("bthk,bhk->bth", qf, n) * carry_w
        num = intra + inter
        den = torch.maximum(torch.abs(n_intra + n_inter),
                            torch.exp(-m_loc))[..., None]
        ys.append((num / den).to(dtype))

        # the boundary state, written once a chunk
        kv_w = torch.exp(i_f + (total[:, None] - csum) - m_new[:, None, :])
        fgate = torch.exp(total + m - m_new)[:, :, None, None]
        C = fgate * C + torch.einsum("bjhk,bjhv->bhkv", kf,
                                     kv_w[..., None] * vf)
        n = fgate[..., 0] * n + torch.einsum("bjhk,bjh->bhk", kf, kv_w)
        m = m_new
    y = torch.cat(ys, 1) if len(ys) > 1 else ys[0]
    return _mlstm_out(p, y, z), MLSTMState(C=C, n=n, m=m)


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar memory)
# ---------------------------------------------------------------------------


class SLSTMState(NamedTuple):
    c: torch.Tensor       # [B, di] float32
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


def slstm_init_state(cfg: ModelConfig, s: SSMConfig, batch: int, dtype,
                     device=None) -> SLSTMState:
    di = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return SLSTMState(c=torch.zeros((batch, di), **f32),
                      n=torch.zeros((batch, di), **f32),
                      h=torch.zeros((batch, di), **f32),
                      m=torch.full((batch, di), -1e30, **f32))


class SLSTM(nn.Module):
    """sLSTM with the reference's leaves: ``w_gates [d, 4·d]``, the
    block-diagonal recurrent mixing ``r_gates [H, dh, 4·dh]``, ``b_gates
    [4·d]`` (forget gates 3), ``gn_scale [d]`` (float32 always), and the
    post-FFN ``w_ff1 [d, 4d/3]``, ``w_ff2 [4d/3, d]`` (tanh gelu)."""

    keep_float32 = ("gn_scale",)

    def __init__(self, key, cfg: ModelConfig, s: SSMConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg, self.s = cfg, s
        d = di = cfg.d_model
        H = s.num_heads
        dh = di // H
        ff = 4 * di // 3
        ks = prng.split(key, 6) if key is not None else [None] * 6
        sc = 1.0 / math.sqrt(d)
        self.w_gates = parameter(ks[0], (d, 4 * di), sc, device, dtype)
        self.r_gates = parameter(ks[1], (H, dh, 4 * dh), 1.0 / math.sqrt(dh),
                                 device, dtype)
        self.b_gates = _constant(torch.cat([
            torch.zeros(di, device=device),
            3.0 * torch.ones(di, device=device),
            torch.zeros(2 * di, device=device)]), dtype)
        self.gn_scale = nn.Parameter(torch.ones(di, device=device))
        self.w_ff1 = parameter(ks[2], (di, ff), sc, device, dtype)
        self.w_ff2 = parameter(ks[3], (ff, di), 1.0 / math.sqrt(ff), device,
                               dtype)

    def forward(self, x, state: SLSTMState | None = None):
        return slstm_forward(self, x, state)

    def decode(self, x, state: SLSTMState):
        """One token; ``state`` is written in place."""
        y, new = slstm_forward(self, x, state)
        _write(state, new)
        return y


def slstm_forward(p: SLSTM, x, state: SLSTMState | None = None):
    """x ``[B, S, d]`` → (y ``[B, S, d]``, state): the exponentially gated
    scalar recurrence one token at a time, its recurrent product per
    head in the compute dtype (einsum ``bhk,hkp->bhp``), then rmsnorm
    and the post-FFN's residual."""
    B, S, d = x.shape
    dtype = x.dtype
    if state is None:
        state = slstm_init_state(p.cfg, p.s, B, dtype, x.device)
    H, dh, _ = p.r_gates.shape
    wx = x @ p.w_gates.to(dtype) + p.b_gates.to(dtype)
    r = p.r_gates.to(dtype)
    c, n, h, m = state
    one = torch.ones((), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        hh = h.view(B, H, dh).to(dtype).transpose(0, 1)  # [H, B, dh]
        rec = torch.bmm(hh, r).transpose(0, 1).reshape(B, 4 * d)
        g = (wx[:, t] + rec).float()
        zi, fi, ii, oi = g.split(d, dim=-1)
        logf = log_sigmoid(fi)
        lm = logf + m
        m_new = torch.maximum(lm, ii)
        fg = torch.exp(lm - m_new)
        ig = torch.exp(ii - m_new)
        c = fg * c + ig * torch.tanh(zi)
        n = fg * n + ig
        h = torch.sigmoid(oi) * c / torch.maximum(n, one)
        m = m_new
        ys.append(h.to(dtype))
    y = rmsnorm(torch.stack(ys, 1), p.gn_scale)
    y = y + F.gelu(y @ p.w_ff1.to(dtype), approximate="tanh") \
        @ p.w_ff2.to(dtype)
    return y, SLSTMState(c=c, n=n, h=h, m=m)


# the block and its decode state by ``LayerSpec.kind``
SSM_BLOCKS = {"mamba": Mamba, "mlstm": MLSTM, "slstm": SLSTM}
SSM_INIT_STATE = {"mamba": mamba_init_state, "mlstm": mlstm_init_state,
                  "slstm": slstm_init_state}
