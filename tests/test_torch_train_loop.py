"""The port's LM steps (``repro_torch.train.train_loop``) and LM
checkpoints held against the reference's in one process, on the CPU.

Tolerances (float32): losses, ``lr`` and ``grad_norm`` rtol 1e-5; the
AdamW moments after 2 steps within 1e-4 of each leaf's largest
magnitude. Updated parameters within 1e-4 of each leaf's largest
magnitude wherever AdamW's direction is resolved: AdamW divides each
element's moment by its own root second moment, so an element whose
gradient at some step is within 1e-3 of its leaf's largest gradient of
zero (where the gradients' agreement, 1e-4 of the leaf's largest, leaves
its sign or size open) may move by up to the whole step either way, and
is held to the step bound 2·Σ lr.
Greedy tokens are equal. Checkpoints are bitwise.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import model as RM
from repro.train import checkpoint as rckpt
from repro.train.optimizer import AdamWConfig as RAdamW
from repro.train.optimizer import init_opt_state as ref_init_opt
from repro.train.train_loop import make_eval_step as ref_eval_step
from repro.train.train_loop import make_prefill_step as ref_prefill_step
from repro.train.train_loop import make_serve_step as ref_serve_step
from repro.train.train_loop import make_train_step as ref_train_step
from repro_torch import interop
from repro_torch.configs import get_config, reduced
from repro_torch.models import model as TM
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.optimizer import AdamWConfig, init_opt_state, lr_at
from repro_torch.train.train_loop import (make_eval_step, make_prefill_step,
                                          make_serve_step, make_train_step)

ARCHS = ["olmo-1b", "qwen2-0.5b", "phi3-medium-14b", "deepseek-v2-236b",
         "arctic-480b"]
MOE_ARCHS = ["deepseek-v2-236b", "arctic-480b"]
SSM_ARCHS = ["xlstm-125m", "jamba-v0.1-52b"]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
RTOL = 1e-5
LEAF_TOL = 1e-4
UNRESOLVED = 1e-3

_ref_init = jax.jit(RM.init_params, static_argnums=0)


def _setup(arch, seed=0):
    rcfg = ref_reduced(ref_get_config(arch))
    cfg = reduced(get_config(arch))
    params = _ref_init(rcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)}
    return rcfg, cfg, params, rb, tb


def _ref_step(arch, num_groups=1):
    """The reference's jitted train step of reduced ``arch``, compiled once
    a process (``_ref_step(a)`` and ``_ref_step(a, 1)`` are one step)."""
    return _ref_step_of(arch, num_groups)


@functools.lru_cache(maxsize=None)
def _ref_step_of(arch, num_groups):
    return jax.jit(ref_train_step(ref_reduced(ref_get_config(arch)),
                                  RAdamW(**OPT), num_groups=num_groups))


def _leaf_gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """Two ``make_train_step`` steps from the same carried parameters:
    metrics, moments and parameters (see the module's tolerances)."""
    rcfg, cfg, params, rb, tb = _setup(arch)
    rstep = jax.jit(ref_train_step(rcfg, RAdamW(**OPT)))
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    step = make_train_step(model, AdamWConfig(**OPT))
    p_r, o_r = params, ref_init_opt(params, RAdamW(**OPT))
    p_t = TM.params_of(model)
    o_t = init_opt_state(p_t, AdamWConfig(**OPT))
    unresolved = {n: torch.zeros_like(p, dtype=torch.bool)
                  for n, p in p_t.items()}
    for _ in range(2):
        # the step's gradients (held to the reference's in
        # test_torch_models.py)
        TM.bind_params(model, p_t)
        names = list(p_t)
        g = torch.autograd.grad(TM.loss_fn(model, tb),
                                [dict(model.named_parameters())[n]
                                 for n in names])
        for n, x in zip(names, g):
            unresolved[n] |= x.abs() <= UNRESOLVED * x.abs().max()
        p_r, o_r, m_r = rstep(p_r, o_r, rb)
        p_t, o_t, m_t = step(p_t, o_t, tb)
        assert set(m_t) == set(m_r) == {"loss", "lr", "grad_norm"}
        for k in m_r:
            np.testing.assert_allclose(float(m_t[k]), float(m_r[k]),
                                       rtol=RTOL)
    assert int(o_t.step) == int(o_r.step) == 2
    for tree_t, tree_r in ((o_t.mu, o_r.mu), (o_t.nu, o_r.nu)):
        want = interop.lm_tree_from_ref(tree_r, cfg, "cpu")
        for n, x in tree_t.items():
            assert _leaf_gap(x, want[n]) <= LEAF_TOL, n
    want = interop.lm_tree_from_ref(p_r, cfg, "cpu")
    bound = 2 * float(lr_at(AdamWConfig(**OPT), 1)
                      + lr_at(AdamWConfig(**OPT), 2))
    for n, x in p_t.items():
        diff, unres = (x - want[n]).abs(), unresolved[n]
        assert float(diff[~unres].max()) <= LEAF_TOL \
            * float(want[n].abs().max()), n
        assert not unres.any() or float(diff[unres].max()) <= bound, n
    # the module computes with the tensors the step returned
    assert all(p.data_ptr() == p_t[n].data_ptr()
               for n, p in model.named_parameters())


def test_eval_and_prefill_steps_match_reference():
    rcfg, cfg, params, rb, tb = _setup("qwen2-0.5b", seed=1)
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    p = TM.params_of(model)
    np.testing.assert_allclose(
        float(make_eval_step(model)(p, tb)),
        float(ref_eval_step(rcfg)(params, rb)), rtol=RTOL)
    want = ref_prefill_step(rcfg)(params, {"tokens": rb["tokens"]})
    got = make_prefill_step(model)(p, {"tokens": tb["tokens"]})
    assert got.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-0.5b"] + MOE_ARCHS
                         + SSM_ARCHS)
def test_serve_step_matches_reference(arch):
    """12 greedy steps from a 4-token prompt: the same tokens, int32
    ``[B, 1]``."""
    rcfg, cfg, params, rb, tb = _setup(arch, seed=2)
    rserve = jax.jit(ref_serve_step(rcfg))
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    serve = make_serve_step(model)
    p = TM.params_of(model)
    rstate = RM.init_decode_state(rcfg, 2, 32)
    state = TM.init_decode_state(model, 2, 32)
    rtok, tok = rb["tokens"][:, :1], tb["tokens"][:, :1]
    for t in range(16):
        if t < 4:                       # the prompt, teacher-forced
            rtok, tok = rb["tokens"][:, t:t + 1], tb["tokens"][:, t:t + 1]
        rtok, rstate = rserve(params, rtok, rstate)
        tok, state = serve(p, tok, state)
        assert tok.dtype == torch.int32 and tok.shape == (2, 1)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))


def _train(step, p, o, batches):
    for b in batches:
        p, o, _ = step(p, o, b)
    return p, o


def test_checkpoint_from_reference_continues_bitwise(tmp_path):
    """Params and ``OptState`` after 2 reference steps, saved by the
    reference's ``train/checkpoint.py``, restore into the port bit for
    bit and continue 2 steps exactly as the state carried in memory
    does."""
    rcfg, cfg, params, rb, tb = _setup("olmo-1b", seed=3)
    rstep = jax.jit(ref_train_step(rcfg, RAdamW(**OPT)))
    p_r, o_r = params, ref_init_opt(params, RAdamW(**OPT))
    for _ in range(2):
        p_r, o_r, _ = rstep(p_r, o_r, rb)
    rckpt.save(os.path.join(tmp_path, "params"), p_r, 2)
    rckpt.save(os.path.join(tmp_path, "opt"), o_r, 2)

    model = interop.lm_params_from_ref(params, cfg, "cpu")
    target_p = interop.lm_params_to_ref(model)
    target_o = interop.lm_opt_state_to_ref(
        init_opt_state(TM.params_of(model), AdamWConfig(**OPT)), cfg)
    assert tckpt.latest_step(os.path.join(tmp_path, "params")) == 2
    got_p = tckpt.restore(os.path.join(tmp_path, "params"),
                          interop.tree_from_ref(target_p, "cpu"))
    got_o = tckpt.restore(os.path.join(tmp_path, "opt"),
                          interop.tree_from_ref(target_o, "cpu"))
    for (k, a), (_, b) in zip(tckpt._flatten_with_paths(got_o),
                              tckpt._flatten_with_paths(o_r)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)

    runs = []
    for p_src, o_src in ((got_p, got_o), (p_r, o_r)):
        m = interop.lm_params_from_ref(p_src, cfg, "cpu")
        step = make_train_step(m, AdamWConfig(**OPT))
        runs.append(_train(step, TM.params_of(m),
                           interop.lm_opt_state_from_ref(o_src, cfg, "cpu"),
                           [tb, tb]))
    (p1, o1), (p2, o2) = runs
    assert int(o1.step) == 4
    for n in p1:
        for a, b in ((p1[n], p2[n]), (o1.mu[n], o2.mu[n]),
                     (o1.nu[n], o2.nu[n])):
            assert torch.equal(a, b), n


def test_port_checkpoint_restores_in_reference(tmp_path):
    """The port's save of its LM params and ``OptState`` (after 2 port
    steps) restores in the reference bit for bit, and the reference
    continues from it."""
    rcfg, cfg, params, rb, tb = _setup("qwen2-0.5b", seed=4)
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    step = make_train_step(model, AdamWConfig(**OPT))
    p, o = _train(step, TM.params_of(model),
                  init_opt_state(TM.params_of(model), AdamWConfig(**OPT)),
                  [tb, tb])
    tckpt.save(os.path.join(tmp_path, "params"),
               interop.lm_tree_to_ref(p, cfg), 2)
    tckpt.save(os.path.join(tmp_path, "opt"),
               interop.lm_opt_state_to_ref(o, cfg), 2)
    r_o0 = ref_init_opt(params, RAdamW(**OPT))
    got_p = rckpt.restore(os.path.join(tmp_path, "params"), params)
    got_o = rckpt.restore(os.path.join(tmp_path, "opt"), r_o0)
    want_p = interop.lm_tree_to_ref(p, cfg)
    for a, b in zip(jax.tree_util.tree_leaves(got_p),
                    jax.tree_util.tree_leaves(want_p)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(got_o.step) == 2
    back = interop.lm_opt_state_from_ref(got_o, cfg, "cpu")
    for n in p:
        assert torch.equal(back.mu[n], o.mu[n])
        assert torch.equal(back.nu[n], o.nu[n])
    rstep = jax.jit(ref_train_step(rcfg, RAdamW(**OPT)))
    p3, o3, m3 = rstep(got_p, got_o, rb)
    assert int(o3.step) == 3 and np.isfinite(float(m3["loss"]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_checkpoints_cross_both_ways(arch, tmp_path):
    """MoE and MLA leaves and their moments: the reference's checkpoint
    after 2 steps at ``num_groups=2`` restores into the port bit for bit
    and continues exactly as the state carried in memory does; the
    port's save restores in the reference bit for bit."""
    _checkpoints_cross_both_ways(arch, tmp_path)


def _checkpoints_cross_both_ways(arch, tmp_path, num_groups=2):
    rcfg, cfg, params, rb, tb = _setup(arch, seed=5)
    rstep = _ref_step(arch, num_groups)
    p_r, o_r = params, ref_init_opt(params, RAdamW(**OPT))
    for _ in range(2):
        p_r, o_r, _ = rstep(p_r, o_r, rb)
    rckpt.save(os.path.join(tmp_path, "params"), p_r, 2)
    rckpt.save(os.path.join(tmp_path, "opt"), o_r, 2)
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    target_o = interop.lm_opt_state_to_ref(
        init_opt_state(TM.params_of(model), AdamWConfig(**OPT)), cfg)
    got_p = tckpt.restore(os.path.join(tmp_path, "params"),
                          interop.tree_from_ref(
                              interop.lm_params_to_ref(model), "cpu"))
    got_o = tckpt.restore(os.path.join(tmp_path, "opt"),
                          interop.tree_from_ref(target_o, "cpu"))
    for (k, a), (_, b) in zip(tckpt._flatten_with_paths(got_p),
                              tckpt._flatten_with_paths(p_r)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
    runs = []
    for p_src, o_src in ((got_p, got_o), (p_r, o_r)):
        m = interop.lm_params_from_ref(p_src, cfg, "cpu")
        step = make_train_step(m, AdamWConfig(**OPT), num_groups=num_groups)
        runs.append(_train(step, TM.params_of(m),
                           interop.lm_opt_state_from_ref(o_src, cfg, "cpu"),
                           [tb]))
    (p1, o1), (p2, o2) = runs
    for n in p1:
        for a, b in ((p1[n], p2[n]), (o1.mu[n], o2.mu[n]),
                     (o1.nu[n], o2.nu[n])):
            assert torch.equal(a, b), n
    # the port's save, read by the reference
    tckpt.save(os.path.join(tmp_path, "port_params"),
               interop.lm_tree_to_ref(p1, cfg), 3)
    tckpt.save(os.path.join(tmp_path, "port_opt"),
               interop.lm_opt_state_to_ref(o1, cfg), 3)
    back_p = rckpt.restore(os.path.join(tmp_path, "port_params"), params)
    back_o = rckpt.restore(os.path.join(tmp_path, "port_opt"), o_r)
    want_p = interop.lm_tree_to_ref(p1, cfg)
    for a, b in zip(jax.tree_util.tree_leaves(back_p),
                    jax.tree_util.tree_leaves(want_p)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(back_o.step) == 3
    back = interop.lm_opt_state_from_ref(back_o, cfg, "cpu")
    for n in p1:
        assert torch.equal(back.mu[n], o1.mu[n])
        assert torch.equal(back.nu[n], o1.nu[n])


def test_moe_train_step_with_groups_matches_reference():
    """One step of reduced deepseek-v2 at ``num_groups=4``: the loss (with
    aux), ``grad_norm`` and ``lr`` as the reference's."""
    rcfg, cfg, params, rb, tb = _setup("deepseek-v2-236b", seed=6)
    rstep = jax.jit(ref_train_step(rcfg, RAdamW(**OPT), num_groups=4))
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    step = make_train_step(model, AdamWConfig(**OPT), num_groups=4)
    p_t = TM.params_of(model)
    _, _, m_r = rstep(params, ref_init_opt(params, RAdamW(**OPT)), rb)
    _, _, m_t = step(p_t, init_opt_state(p_t, AdamWConfig(**OPT)), tb)
    for k in m_r:
        np.testing.assert_allclose(float(m_t[k]), float(m_r[k]), rtol=RTOL)
