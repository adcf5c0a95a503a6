"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``) on the CPU, and the slab-wise init.

Given the same float32 logits, the routing integers (experts, ranks,
the capacity drop), the dispatch buffer and the combine are bitwise,
planted exact ties and capacity overflow included. The layer's output
and aux loss within rtol/atol 1e-5 at ``num_groups`` 1, 2, 4 and at a
token count the group count does not divide; every gradient leaf within
1e-4 of its largest magnitude. A leaf drawn slab by slab equals the
one-shot draw bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import moe as RMOE
from repro_torch import random as prng
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE

RTOL = ATOL = 1e-5
LEAF_TOL = 1e-4

# jitted once per (config, num_groups): eager jax compiles op by op
_ref_apply = jax.jit(RMOE.apply_moe, static_argnums=(2, 3),
                     static_argnames="num_groups")


def _cfgs(arch, **kw):
    rcfg, cfg = ref_reduced(ref_get_config(arch)), reduced(get_config(arch))
    if kw:
        rcfg = dataclasses.replace(rcfg, **kw)
        cfg = dataclasses.replace(cfg, **kw)
    return rcfg, cfg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _layer(arch, seed=0, **kw):
    """(ref cfg, port cfg, reference params, the port's MoE holding them)."""
    rcfg, cfg = _cfgs(arch, **kw)
    params = RMOE.init_moe(jax.random.PRNGKey(seed), rcfg, rcfg.moe)
    moe = TMOE.MoE(None, cfg, cfg.moe, "cpu")
    flat = _flat(params)
    assert set(flat) == {n for n, _ in moe.named_parameters()}
    with torch.no_grad():
        for n, p in moe.named_parameters():
            p.copy_(torch.from_numpy(np.array(flat[n])))
    return rcfg, cfg, params, moe


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _logits(rng, T, E, ties: bool):
    la = rng.standard_normal((T, E)).astype(np.float32)
    if ties:
        # exact ties between experts 0/1 and 2/3 on every other token
        la[::2, 1] = la[::2, 0]
        la[1::2, 3] = la[1::2, 2]
        la[::3, :] = 0.5                   # a whole row tied
    return la


@pytest.mark.parametrize("T,E,k,capacity,ties", [
    (64, 8, 2, 8, True),      # capacity 8 of 16 expected: overflow drops
    (64, 8, 2, 32, False),    # no drop
    (48, 6, 6, 8, True),      # top-k over every expert, ties throughout
    (33, 4, 1, 8, False),     # top-1, ragged token count
])
def test_dispatch_and_combine_bitwise(T, E, k, capacity, ties):
    """``group_indices``/``dispatch``/``combine`` with one group against
    the reference's ``_dispatch_one_group``/``_combine_one_group`` on the
    same float32 logits and tokens: experts, ranks, keep mask and buffer
    bitwise, the lower index first on ties; the combine of one expert
    output bitwise."""
    rng = np.random.default_rng(T + E + k)
    d = 16
    rm = dataclasses.replace(ref_get_config("deepseek-v2-236b").moe,
                             num_experts=E, top_k=k)
    x = rng.standard_normal((T, d)).astype(np.float32)
    la = _logits(rng, T, E, ties)
    rbuf, (re, rr, rp, rkeep, _) = RMOE._dispatch_one_group(
        jnp.asarray(x), jnp.asarray(la), rm, capacity)
    r = TMOE.group_indices(torch.from_numpy(la)[None], k, capacity)
    buf = TMOE.dispatch(torch.from_numpy(x)[None], r, E, capacity)[0]
    _equal(r.e_idx[0], re)
    _equal(r.r_idx[0], rr)
    _equal(r.keep[0], rkeep)
    _equal(buf, rbuf)
    np.testing.assert_allclose(r.top_p[0].numpy(), np.asarray(rp),
                               rtol=RTOL, atol=1e-7)
    if ties:
        # a whole tied row routes to experts 0..k-1 in index order
        kept = r.keep[0][::3].all(-1)
        assert bool(kept.any())
        assert bool((r.e_idx[0][::3][kept] == torch.arange(k)).all())
    if capacity * E < T * k:
        assert not bool(r.keep.all())
    # the combine of an expert output, same weights both sides
    out = rng.standard_normal((E, capacity, d)).astype(np.float32)
    rinfo = (re, rr, rp, rkeep, None)
    want = RMOE._combine_one_group(jnp.asarray(out), rinfo, T, capacity)
    got = TMOE.combine(torch.from_numpy(out)[None], r._replace(
        top_p=torch.from_numpy(np.array(rp))[None]))[0]
    _equal(got, want)


def test_group_indices_planted_ties_pick_lower_index():
    """An exact tie among the top-k keeps the lower expert index first
    (``jax.lax.top_k``); the aux term's top-1 is the first maximum."""
    la = torch.tensor([[[1.0, 3.0, 3.0, 3.0, 0.0],
                        [2.0, 2.0, 0.0, 2.0, 2.0]]])
    r = TMOE.group_indices(la, 2, 8)
    assert r.e_idx.tolist() == [[[1, 2], [0, 1]]]
    assert r.r_idx.tolist() == [[[0, 0], [0, 1]]]
    f_top1 = torch.tensor([0, 0.5, 0, 0, 0]) + torch.tensor(
        [0.5, 0, 0, 0, 0])
    probs = torch.softmax(la.float(), -1)[0]
    np.testing.assert_allclose(r.aux.numpy(),
                               [5 * float((f_top1 * probs.mean(0)).sum())],
                               rtol=1e-6)


@pytest.mark.parametrize("arch,kw,groups", [
    ("deepseek-v2-236b", {}, (1, 2, 4)),                # shared experts
    ("arctic-480b", {}, (1, 2, 4)),                     # dense residual
    ("deepseek-v2-236b", {"activation": "gelu"}, (1, 4)),  # gelu branch
])
def test_apply_moe_matches_reference(arch, kw, groups):
    """Output and aux at each ``num_groups``, and at T = 30 tokens, which
    4 does not divide (gcd 2)."""
    rcfg, cfg, params, moe = _layer(arch, **kw)
    rng = np.random.default_rng(1)
    for B, S in ((2, 32), (3, 10)):
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        for g in groups:
            want_y, want_aux = _ref_apply(params, jnp.asarray(x), rcfg,
                                          rcfg.moe, num_groups=g)
            with torch.no_grad():
                y, aux = moe(torch.from_numpy(x), num_groups=g)
            np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(float(aux), float(want_aux),
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "arctic-480b"])
def test_moe_gradients_match_reference(arch):
    """Every MoE leaf's gradient of ``sum(y · w) + aux`` at ``num_groups``
    2, within 1e-4 of the leaf's largest, and the input's."""
    rcfg, cfg, params, moe = _layer(arch, seed=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)

    def ref_obj(p, xx):
        y, aux = RMOE.apply_moe(p, xx, rcfg, rcfg.moe, num_groups=2)
        return jnp.sum(y * w) + aux
    g_p, g_x = jax.jit(jax.grad(ref_obj, argnums=(0, 1)))(params,
                                                          jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe(xt, num_groups=2)
    obj = torch.sum(y * torch.from_numpy(w)) + aux
    names = [n for n, _ in moe.named_parameters()]
    grads = torch.autograd.grad(obj, list(moe.parameters()) + [xt])
    want = _flat(g_p)
    want["x"] = g_x
    for n, g in zip(names + ["x"], grads):
        wt = torch.from_numpy(np.array(want[n]))
        gap = float((g - wt).abs().max() / wt.abs().max().clamp_min(1e-30))
        assert gap <= LEAF_TOL, (n, gap)


def test_moe_init_draws_the_reference_values():
    """``MoE`` from ``init_moe``'s key: every leaf within the erfinv
    gap."""
    rcfg, cfg = _cfgs("arctic-480b")
    want = _flat(RMOE.init_moe(jax.random.PRNGKey(4), rcfg, rcfg.moe))
    got = TMOE.MoE(prng.PRNGKey(4), cfg, cfg.moe, "cpu")
    for n, p in got.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[n]),
                                   rtol=1e-5, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("shape,slab,dtype", [
    ((6, 40, 24), 1000, torch.float32),      # 5,760 elements, 6 slabs
    ((7, 333), 512, torch.bfloat16),         # a ragged last slab
    ((3, 1 << 12), 1 << 10, torch.bfloat16),
])
def test_slab_init_equals_one_shot(shape, slab, dtype):
    """A leaf drawn slab by slab into its dtype is bitwise
    ``(scale · truncated_normal(key, shape)).to(dtype)``."""
    key = prng.PRNGKey(11)
    want = (0.125 * prng.truncated_normal(key, -2.0, 2.0, shape, "cpu")) \
        .to(dtype)
    got = TL.truncated_normal(key, shape, 0.125, "cpu", dtype, slab=slab)
    assert got.dtype == dtype and got.shape == shape
    assert torch.equal(got.view(-1).view(torch.int16 if dtype ==
                                          torch.bfloat16 else torch.int32),
                       want.view(-1).view(torch.int16 if dtype ==
                                          torch.bfloat16 else torch.int32))
    # a slab that straddles counter 2^32 (arctic's 4.46e9-element leaves)
    # equals its two halves drawn apart
    hi = prng.uniform(key, (4,), "cpu", start=(1 << 32) - 2)
    assert torch.equal(hi[:2], prng.uniform(key, (2,), "cpu",
                                            start=(1 << 32) - 2))
    assert torch.equal(hi[2:], prng.uniform(key, (2,), "cpu",
                                            start=1 << 32))
