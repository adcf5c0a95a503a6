"""The port's recurrent LM families, xlstm-125m (mLSTM, sLSTM) and
jamba-v0.1-52b (mamba, attention, MoE), held against the reference in
one process on the CPU: decode states carried across mid-sequence, the
decode slot of a model whose layer 0 is mamba, parameter round trips,
remat around the time loops, train steps, checkpoints both ways, eval
and prefill. (Their init, forward, gradients, decode and greedy serving
are cases of the parametrised tests in ``tests/test_torch_models.py``
and ``tests/test_torch_train_loop.py``, whose helpers and tolerances
this file shares.)

The second train step starts from the reference's first-step state:
left free, the unresolved AdamW elements' steps move the xlstm-125m
second gradient's norm by 2e-5 and a jamba second moment by 1.4e-4 of
its leaf, where from a shared state they agree within 1e-6.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import model as RM
from repro.train.optimizer import AdamWConfig as RAdamW
from repro.train.optimizer import init_opt_state as ref_init_opt
from repro.train.train_loop import make_eval_step as ref_eval_step
from repro.train.train_loop import make_prefill_step as ref_prefill_step
from repro_torch import interop
from repro_torch.models import model as TM
from repro_torch.train.optimizer import AdamWConfig, init_opt_state, lr_at
from repro_torch.train.train_loop import (make_eval_step, make_prefill_step,
                                          make_train_step)
from test_torch_models import _batch, _cfgs, _close, _ref_decode
from test_torch_models import ref_params  # noqa: F401  (a fixture)
from test_torch_train_loop import (LEAF_TOL, OPT, RTOL, UNRESOLVED,
                                   _checkpoints_cross_both_ways, _leaf_gap,
                                   _ref_step, _setup)

SSM_ARCHS = ["xlstm-125m", "jamba-v0.1-52b"]


# ---------------------------------------------------------------------------
# The model: decode states, the decode slot, round trips, remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_decode_continues_from_reference_state(arch, ref_params):
    """``decode_state_from_ref`` mid-sequence: the reference's SSM states
    (stacked over periods) after 5 steps carry across into one state per
    layer and continue as the reference does. jamba's position comes
    from its attention layer's cache; xlstm has none, so it is given."""
    rcfg, cfg = _cfgs(arch)
    params = ref_params(arch)
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    rb, tb = _batch(cfg.vocab_size, S=8, seed=11)
    rstate = RM.init_decode_state(rcfg, 2, 16)
    for t in range(5):
        _, rstate = _ref_decode(params, rcfg, rb["tokens"][:, t:t + 1],
                                rstate)
    attn = arch.startswith("jamba")
    state = interop.decode_state_from_ref(rstate, cfg, "cpu",
                                          pos=0 if attn else 5)
    kinds = [type(c).__name__ for c in state.caches]
    assert kinds == ([("KVCache" if s.kind == "attn" else "MambaState")
                      for s in TM.tfm.layer_specs(cfg)] if attn else
                     ["MLSTMState"] * 3 + ["SLSTMState"])
    assert int(state.pos) == 5
    with torch.no_grad():
        for t in range(5, 8):
            want, rstate = _ref_decode(params, rcfg,
                                       rb["tokens"][:, t:t + 1], rstate)
            got, state = TM.decode_step(model, tb["tokens"][:, t:t + 1],
                                        state)
            _close(got, want)


def test_hybrid_decode_takes_the_attention_layers_slot(ref_params):
    """jamba's layer 0 is mamba: the decode slot comes from its attention
    layer's ring cache (window 4 < 12 steps), which wraps as the
    reference's does."""
    rcfg, cfg = _cfgs("jamba-v0.1-52b")
    rcfg = dataclasses.replace(
        rcfg, attention=dataclasses.replace(rcfg.attention, window=4))
    cfg = dataclasses.replace(
        cfg, attention=dataclasses.replace(cfg.attention, window=4))
    params = ref_params("jamba-v0.1-52b")
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    rb, tb = _batch(cfg.vocab_size, S=12, seed=12)
    rstate = RM.init_decode_state(rcfg, 2, 32)
    state = TM.init_decode_state(model, 2, 32)
    specs = TM.tfm.layer_specs(cfg)
    assert specs[0].kind == "mamba" and specs[3].kind == "attn"
    assert state.caches[3].k.shape[2] == 4
    with torch.no_grad():
        for t in range(12):
            want, rstate = _ref_decode(params, rcfg,
                                       rb["tokens"][:, t:t + 1], rstate)
            got, state = TM.decode_step(model, tb["tokens"][:, t:t + 1],
                                        state)
            _close(got, want)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_params_round_trip(arch, ref_params):
    """``lm_params_to_ref`` inverts ``lm_params_from_ref`` bit for bit on
    the mamba, mLSTM and sLSTM leaves, with the reference's tree."""
    params = ref_params(arch)
    _, cfg = _cfgs(arch)
    back = interop.lm_params_to_ref(
        interop.lm_params_from_ref(params, cfg, "cpu"))
    flat_want, tree_want = jax.tree_util.tree_flatten(params)
    flat_got, tree_got = jax.tree_util.tree_flatten(back)
    assert tree_got == tree_want
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_ssm_remat_changes_nothing(ref_params):
    """``remat="block"`` around a period of time loops: the recompute
    replays the loops, giving the same loss and gradients."""
    _, cfg = _cfgs("xlstm-125m")
    _, tb = _batch(cfg.vocab_size)
    out = []
    for remat in ("none", "block"):
        c = dataclasses.replace(cfg, remat=remat)
        model = interop.lm_params_from_ref(ref_params("xlstm-125m"), c,
                                           "cpu")
        loss = TM.loss_fn(model, tb)
        out.append((loss, torch.autograd.grad(loss,
                                              list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# ---------------------------------------------------------------------------
# The steps and checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_train_steps_match_reference(arch):
    """Two ``make_train_step`` steps of the SSM families, the first from
    the same carried parameters, the second from the reference's
    first-step parameters and moments: metrics, moments and parameters
    of each step at the module's tolerances."""
    rcfg, cfg, params, rb, tb = _setup(arch)
    rstep = _ref_step(arch)
    p_r, o_r = params, ref_init_opt(params, RAdamW(**OPT))
    for t in range(2):
        model = interop.lm_params_from_ref(p_r, cfg, "cpu")
        step = make_train_step(model, AdamWConfig(**OPT))
        p_t = TM.params_of(model)
        o_t = init_opt_state(p_t, AdamWConfig(**OPT)) if t == 0 \
            else interop.lm_opt_state_from_ref(o_r, cfg, "cpu")
        names = list(p_t)
        g = torch.autograd.grad(TM.loss_fn(model, tb),
                                [dict(model.named_parameters())[n]
                                 for n in names])
        unresolved = {n: x.abs() <= UNRESOLVED * x.abs().max()
                      for n, x in zip(names, g)}
        p_r, o_r, m_r = rstep(p_r, o_r, rb)
        p_t, o_t, m_t = step(p_t, o_t, tb)
        for k in m_r:
            np.testing.assert_allclose(float(m_t[k]), float(m_r[k]),
                                       rtol=RTOL, err_msg=k)
        assert int(o_t.step) == int(o_r.step) == t + 1
        for tree_t, tree_r in ((o_t.mu, o_r.mu), (o_t.nu, o_r.nu)):
            want = interop.lm_tree_from_ref(tree_r, cfg, "cpu")
            for n, x in tree_t.items():
                assert _leaf_gap(x, want[n]) <= LEAF_TOL, (t, n)
        want = interop.lm_tree_from_ref(p_r, cfg, "cpu")
        bound = 2 * float(lr_at(AdamWConfig(**OPT), t + 1))
        for n, x in p_t.items():
            diff, unres = (x - want[n]).abs(), unresolved[n]
            assert float(diff[~unres].max()) <= LEAF_TOL \
                * float(want[n].abs().max()), (t, n)
            assert not unres.any() or float(diff[unres].max()) <= bound, \
                (t, n)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_checkpoints_cross_both_ways(arch, tmp_path):
    """The mamba, mLSTM and sLSTM leaves and their moments, as
    ``test_moe_checkpoints_cross_both_ways`` holds the MoE ones (at
    ``num_groups=1``, sharing the train steps' compiled reference)."""
    _checkpoints_cross_both_ways(arch, tmp_path, num_groups=1)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_eval_and_prefill_steps_match_reference(arch):
    """The eval loss and the prefill's last logits as the reference's,
    and an 8-token prefill within 2e-3 of the last of 8 decode steps over
    the same tokens (``tests/test_arch_smoke.py``; 16 tokens fit jamba's
    MoE capacity, so no prefill slot drops)."""
    rcfg, cfg, params, rb, tb = _setup(arch, seed=7)
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    p = TM.params_of(model)
    np.testing.assert_allclose(
        float(make_eval_step(model)(p, tb)),
        float(ref_eval_step(rcfg)(params, rb)), rtol=RTOL)
    want = ref_prefill_step(rcfg)(params, {"tokens": rb["tokens"]})
    got = make_prefill_step(model)(p, {"tokens": tb["tokens"]})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL)
    short = make_prefill_step(model)(p, {"tokens": tb["tokens"][:, :8]})
    state = TM.init_decode_state(model, 2, 8)
    with torch.no_grad():
        for t in range(8):
            logits, state = TM.decode_step(model, tb["tokens"][:, t:t + 1],
                                           state)
    np.testing.assert_allclose(logits.numpy(), short.numpy(), rtol=2e-3,
                               atol=2e-3)
