"""The port's MLA (``repro_torch.models.attention.MLA``) against the
reference's (``repro.models.attention.mla_*``) on the CPU, at reduced
deepseek-v2-236b's shapes (4 heads, q_lora 32, kv_lora 16, qk_nope 16,
qk_rope 8, v 16).

Tolerances (float32): outputs rtol/atol 1e-5; gradients within 1e-4 of
each leaf's largest magnitude; the port's own prefill against its
decode within 2e-3 (the reference's ``tests/test_arch_smoke.py``). In
bfloat16, the decode within four bf16 steps (4·2^-8) of the largest
output (XLA keeps float32 between fused elementwise ops where torch
rounds each to bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import attention as RA
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention as TA
from repro_torch.models.layers import positional_tables

D_MODEL = 64
RTOL = ATOL = 1e-5
LEAF_TOL = 1e-4


def _setup(seed=0):
    ratt = ref_reduced(ref_get_config("deepseek-v2-236b")).attention
    att = reduced(get_config("deepseek-v2-236b")).attention
    params = RA.init_attention(jax.random.PRNGKey(seed), ratt, D_MODEL)
    mla = TA.MLA(None, att, D_MODEL, "cpu")
    with torch.no_grad():
        for n, p in mla.named_parameters():
            p.copy_(torch.from_numpy(np.array(params[n])))
    return ratt, att, params, mla


def _x(B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D_MODEL)).astype(np.float32)


def _pos(B, S):
    return np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))


def test_mla_forward_matches_reference(monkeypatch):
    """The prefill at 16-row chunks (two Q and two KV chunks)."""
    for mod in (RA, TA):
        monkeypatch.setattr(mod, "Q_CHUNK", 16)
        monkeypatch.setattr(mod, "KV_CHUNK", 16)
    ratt, att, params, mla = _setup()
    x, pos = _x(2, 32, 1), _pos(2, 32)
    want = jax.jit(RA.mla_forward, static_argnums=1)(
        params, ratt, jnp.asarray(x), jnp.asarray(pos))
    with torch.no_grad():
        got = mla(torch.from_numpy(x),
                  positional_tables(att, torch.from_numpy(pos.copy())))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _decode_both(ratt, att, params, mla, x, dtype, steps):
    B = x.shape[0]
    tdtype = getattr(torch, jnp.dtype(dtype).name)
    rcache = RA.mla_init_cache(ratt, B, 16, dtype)
    cache = TA.mla_init_cache(att, B, 16, tdtype, "cpu")
    pos = torch.zeros((), dtype=torch.int32)
    rdec = jax.jit(RA.mla_decode, static_argnums=1)
    got, want = [], []
    with torch.no_grad():
        for t in range(steps):
            xt = x[:, t:t + 1]
            w, rcache = rdec(params, ratt, jnp.asarray(xt).astype(dtype),
                             rcache)
            tables = positional_tables(att, pos.expand(B, 1))
            at = TA.decode_slot(pos, 16, 0)
            got.append(mla.decode(torch.from_numpy(xt).to(tdtype), cache,
                                  at, tables))
            want.append(np.asarray(w.astype(jnp.float32)))
            pos += 1
    return torch.cat(got, 1), np.concatenate(want, 1), cache, rcache


def test_mla_decode_matches_reference_and_prefill():
    """8 latent-space decode steps: each output and the latent cache as
    the reference's; the port's prefill of the same tokens within
    2e-3."""
    ratt, att, params, mla = _setup(1)
    x = _x(2, 8, 2)
    got, want, cache, rcache = _decode_both(ratt, att, params, mla, x,
                                            jnp.float32, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cache.c_kv.numpy(), np.asarray(rcache.c_kv),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cache.k_rope.numpy(),
                               np.asarray(rcache.k_rope), rtol=RTOL,
                               atol=ATOL)
    with torch.no_grad():
        pre = mla(torch.from_numpy(x), positional_tables(
            att, torch.from_numpy(_pos(2, 8).copy())))
    np.testing.assert_allclose(got.numpy(), pre.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_mla_bf16_decode_matches_reference():
    """bf16 decode from float32 norms: the score scale rounded to bf16 as
    jax rounds a Python scalar (``scalar_like``)."""
    ratt, att, params, mla = _setup(2)
    x = _x(2, 6, 3)
    got, want, _, _ = _decode_both(ratt, att, params, mla, x, jnp.bfloat16,
                                   6)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 4 * 2**-8 * np.abs(want).max()


def test_mla_gradients_match_reference():
    """Every MLA leaf's gradient of ``sum(y · w)``, and the input's."""
    ratt, att, params, mla = _setup(3)
    x, pos = _x(2, 12, 4), _pos(2, 12)
    w = np.random.default_rng(5).standard_normal((2, 12, D_MODEL)) \
        .astype(np.float32)

    def ref_obj(p, xx):
        return jnp.sum(RA.mla_forward(p, ratt, xx, jnp.asarray(pos)) * w)
    g_p, g_x = jax.jit(jax.grad(ref_obj, argnums=(0, 1)))(params,
                                                          jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = mla(xt, positional_tables(att, torch.from_numpy(pos.copy())))
    names = [n for n, _ in mla.named_parameters()]
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(w)),
                                list(mla.parameters()) + [xt])
    want = dict(g_p, x=g_x)
    for n, g in zip(names + ["x"], grads):
        wt = torch.from_numpy(np.array(want[n]))
        gap = float((g - wt).abs().max() / wt.abs().max().clamp_min(1e-30))
        assert gap <= LEAF_TOL, (n, gap)


@pytest.mark.parametrize("seed", [0, 7])
def test_mla_init_draws_the_reference_values(seed):
    """``MLA`` from the same key: every leaf within the erfinv gap, the
    norms ones."""
    from repro_torch import random as prng
    ratt = ref_reduced(ref_get_config("deepseek-v2-236b")).attention
    att = reduced(get_config("deepseek-v2-236b")).attention
    want = RA.init_attention(jax.random.PRNGKey(seed), ratt, D_MODEL)
    got = TA.MLA(prng.PRNGKey(seed), att, D_MODEL, "cpu")
    assert {n for n, _ in got.named_parameters()} == set(want)
    for n, p in got.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[n]),
                                   rtol=1e-5, atol=1e-7, err_msg=n)
