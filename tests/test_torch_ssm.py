"""The port's recurrent blocks (``repro_torch.models.ssm``: mamba, mLSTM,
sLSTM) held against the reference's (``repro.models.ssm``) in one
process, on the CPU, at float32 on ``reduced()`` configs (d_model 64,
d_state 8, 2 heads, chunk 32).

Inputs come from numpy seeds; parameters are the reference's own init
copied into the port's modules. Tolerances: outputs and final states
within 1e-5 of each tensor's largest magnitude (the recurrences run in
float32; XLA's and torch's ``exp``/``log1p`` differ in the last bit);
gradients within 1e-4 of each leaf's largest magnitude (as
``tests/test_torch_models.py``); initial values within the ``erfinv``
gap, rtol 1e-5 (``dt_bias`` and ``A_log``, made by ``exp`` and ``log``,
within 1e-5 of their largest magnitude); jax's ``linspace`` bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import ssm as RS
from repro_torch import random as prng
from repro_torch.configs import get_config, reduced
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS

OUT_TOL = 1e-5
LEAF_TOL = 1e-4
ARCH = {"mamba": "jamba-v0.1-52b", "mlstm": "xlstm-125m",
        "slstm": "xlstm-125m"}
REF_INIT = {"mamba": RS.init_mamba, "mlstm": RS.init_mlstm,
            "slstm": RS.init_slstm}


def _gap(got, want) -> float:
    g = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                   np.float64)
    w = np.asarray(want, np.float64)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _block(kind, seed=1):
    """(reference cfg, reference params, port cfg, port module holding
    the reference's params)."""
    rcfg = ref_reduced(ref_get_config(ARCH[kind]))
    cfg = reduced(get_config(ARCH[kind]))
    params = REF_INIT[kind](jax.random.PRNGKey(seed), rcfg, rcfg.ssm)
    mod = TS.SSM_BLOCKS[kind](None, cfg, cfg.ssm, "cpu")
    with torch.no_grad():
        for name, p in mod.named_parameters():
            p.copy_(torch.from_numpy(np.array(params[name])))
    return rcfg, params, cfg, mod


def _ref_forward(kind, chunked=False):
    if kind == "mamba":
        return RS.mamba_forward
    if kind == "slstm":
        return RS.slstm_forward
    return RS.mlstm_forward_chunked if chunked else RS.mlstm_forward


def _port_forward(mod, kind, chunked=False):
    if kind == "mlstm":
        return lambda x, st=None: mod(x, st, chunked=chunked)
    return mod


def _x(cfg, S, seed=0, B=2):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _states_close(got, want):
    assert type(got).__name__ == type(want).__name__
    for f, g, w in zip(got._fields, got, want):
        assert g.shape == np.asarray(w).shape, f
        assert g.dtype == torch.float32 or f == "conv", f
        assert _gap(g, w) <= OUT_TOL, (f, _gap(g, w))


# ---------------------------------------------------------------------------
# jax's elementwise functions
# ---------------------------------------------------------------------------


def test_activations_match_jax():
    """softplus and log_sigmoid as jax writes them (``logaddexp(x, 0)``,
    ``-softplus(-x)``) with jax's derivatives, silu as ``x·sigmoid(x)``;
    within a few float32 ulps of jax's (XLA's ``exp`` and ``log1p`` round
    apart from torch's; the derivatives, bounded by 1.1, within 1e-7 where
    they are small) on 100,000 draws of σ 5 and at ±0, ±30."""
    x = np.concatenate([
        np.random.default_rng(3).normal(0, 5, 100_000),
        [0.0, -0.0, 30.0, -30.0]]).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    for ours, theirs in ((TS.softplus, jax.nn.softplus),
                         (TS.log_sigmoid, jax.nn.log_sigmoid),
                         (TS.silu, jax.nn.silu)):
        got = ours(xt)
        g, = torch.autograd.grad(got.sum(), xt)
        want = theirs(jnp.asarray(x))
        want_g = jax.grad(lambda v: theirs(v).sum())(jnp.asarray(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=5e-7, atol=1e-37)
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g),
                                   rtol=1e-6, atol=1e-7)
    # jax's derivative at 0, where max(x, 0) has none
    z = torch.zeros((), requires_grad=True)
    assert float(torch.autograd.grad(TS.softplus(z), z)[0]) \
        == float(jax.grad(jax.nn.softplus)(0.0)) == 0.5


@pytest.mark.parametrize("num", [2, 7, 128, 8192])
def test_jnp_linspace_is_bitwise(num):
    got = TS.jnp_linspace(1e-3, 1e-1, num)
    want = np.asarray(jnp.linspace(1e-3, 1e-1, num))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Initial values
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_block_init_matches_reference(kind):
    """The reference's leaves, names and shapes, drawn with its key splits
    (8 for mamba and mLSTM, 6 for sLSTM)."""
    rcfg = ref_reduced(ref_get_config(ARCH[kind]))
    cfg = reduced(get_config(ARCH[kind]))
    want = REF_INIT[kind](jax.random.PRNGKey(2), rcfg, rcfg.ssm)
    mod = TS.SSM_BLOCKS[kind](prng.PRNGKey(2), cfg, cfg.ssm, "cpu")
    got = dict(mod.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        w = np.asarray(want[name])
        assert tuple(p.shape) == w.shape and p.dtype == torch.float32, name
        if name in ("dt_bias", "A_log"):
            assert _gap(p, w) <= OUT_TOL, name
        else:
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-5,
                                       atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------
# Forward, decode, final states
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,S,chunked", [
    ("mamba", 40, False),
    ("mlstm", 40, False),           # sequential
    ("mlstm", 96, True),            # three chunks of 32
    ("mlstm", 40, True),            # ragged: the sequential fallback
    ("slstm", 40, False),
])
def test_block_forward_matches_reference(kind, S, chunked):
    """Outputs and final states from the zero state."""
    rcfg, params, cfg, mod = _block(kind)
    x = _x(cfg, S)
    want, wstate = _ref_forward(kind, chunked)(params, rcfg, rcfg.ssm,
                                               jnp.asarray(x))
    with torch.no_grad():
        got, state = _port_forward(mod, kind, chunked)(torch.from_numpy(x))
    assert got.shape == (2, S, cfg.d_model)
    assert _gap(got, want) <= OUT_TOL
    _states_close(state, wstate)
    if kind == "mlstm" and chunked and S % cfg.ssm.chunk_size:
        with torch.no_grad():
            seq, _ = mod(torch.from_numpy(x), chunked=False)
        assert torch.equal(got, seq)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_block_decode_matches_reference(kind):
    """A 24-token forward (sequential), then 8 one-token ``decode`` steps
    from its state, each writing the state in place: outputs and states
    as the reference's ``*_forward``/``*_decode`` over the same tokens."""
    rcfg, params, cfg, mod = _block(kind)
    x = _x(cfg, 32, seed=4)
    ref_fwd = _ref_forward(kind)
    _, wstate = ref_fwd(params, rcfg, rcfg.ssm, jnp.asarray(x[:, :24]))
    with torch.no_grad():
        _, state = _port_forward(mod, kind)(torch.from_numpy(x[:, :24]))
    _states_close(state, wstate)
    ptrs = [t.data_ptr() for t in state]
    for t in range(24, 32):
        want, wstate = ref_fwd(params, rcfg, rcfg.ssm,
                               jnp.asarray(x[:, t:t + 1]), wstate)
        with torch.no_grad():
            got = mod.decode(torch.from_numpy(x[:, t:t + 1]), state)
        assert _gap(got, want) <= OUT_TOL, t
        _states_close(state, wstate)
    assert [t.data_ptr() for t in state] == ptrs


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_init_state_matches_reference(kind):
    rcfg = ref_reduced(ref_get_config(ARCH[kind]))
    cfg = reduced(get_config(ARCH[kind]))
    ref_init = {"mamba": RS.mamba_init_state, "mlstm": RS.mlstm_init_state,
                "slstm": RS.slstm_init_state}[kind]
    want = ref_init(rcfg, rcfg.ssm, 3, jnp.bfloat16)
    got = TS.SSM_INIT_STATE[kind](cfg, cfg.ssm, 3, torch.bfloat16, "cpu")
    for f, g, w in zip(got._fields, got, want):
        assert tuple(g.shape) == w.shape, f
        assert str(g.dtype).split(".")[1] == str(w.dtype), f
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,S,chunked", [
    ("mamba", 40, False),
    ("mlstm", 40, False),
    ("mlstm", 96, True),
    ("slstm", 40, False),
])
def test_block_gradients_match_reference(kind, S, chunked):
    """Every parameter's gradient and the input's, of ``Σ y·r`` plus the
    final state's ``Σ s·r_s`` (float32 fields), from the zero state."""
    rcfg, params, cfg, mod = _block(kind)
    rng = np.random.default_rng(5)
    x = _x(cfg, S, seed=6)
    r = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    fwd = _ref_forward(kind, chunked)
    _, st0 = fwd(params, rcfg, rcfg.ssm, jnp.asarray(x))
    rs = [rng.standard_normal(np.shape(a)).astype(np.float32)
          if np.asarray(a).dtype == np.float32 else None for a in st0]

    def objective(y, state):
        total = (y * r).sum()
        for a, w in zip(state, rs):
            if w is not None:
                total = total + (a * w).sum()
        return total

    want_p, want_x = jax.grad(
        lambda p, xx: objective(*fwd(p, rcfg, rcfg.ssm, xx)),
        argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, state = _port_forward(mod, kind, chunked)(xt)
    objective_t = (y * torch.from_numpy(r)).sum()
    for a, w in zip(state, rs):
        if w is not None:
            objective_t = objective_t + (a * torch.from_numpy(w)).sum()
    names = [n for n, _ in mod.named_parameters()]
    grads = torch.autograd.grad(objective_t, [xt] + list(mod.parameters()))
    assert _gap(grads[0], want_x) <= LEAF_TOL
    for name, g in zip(names, grads[1:]):
        assert _gap(g, want_p[name]) <= LEAF_TOL, (name, _gap(g,
                                                              want_p[name]))


# ---------------------------------------------------------------------------
# Serving dtype and parameter counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_serving_cast_keeps_ssm_float32_leaves(arch):
    """``cast_for_serving`` keeps ``A_log`` and ``gn_scale`` float32 (they
    apply in float32) and casts every other SSM leaf; ``init_params(
    dtype=bf16)`` gives the same bits without the float32 model."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="bfloat16")
    served = TM.cast_for_serving(TM.init_params(cfg, prng.PRNGKey(0),
                                                "cpu"))
    direct = TM.init_params(cfg, prng.PRNGKey(0), "cpu",
                            dtype=torch.bfloat16)
    kinds = set()
    for (n, p), (n2, q) in zip(served.named_parameters(),
                               direct.named_parameters()):
        assert n == n2 and p.dtype == q.dtype and torch.equal(p, q), n
        if any(f".{k}." in n for k in TS.SSM_BLOCKS):
            kinds.add(n.split(".")[-2])
            want = torch.float32 if n.endswith(("A_log", "gn_scale")) \
                else torch.bfloat16
            assert p.dtype == want, n
    assert kinds == ({"mamba"} if arch.startswith("jamba")
                     else {"mlstm", "slstm"})


@pytest.mark.parametrize("arch,analytic", [("xlstm-125m", 147_886_848),
                                           ("jamba-v0.1-52b", None)])
def test_count_params_analytic_holds_to_the_model(arch, analytic):
    """The built model (on the meta device, full size) has the analytic
    count plus what the count leaves out: the norms' parameters, each
    mamba layer's ``conv_b`` and each mLSTM layer's ``b_if``."""
    cfg = get_config(arch)
    model = TM.TransformerLM(cfg, None, "meta")
    n = TM.count_params_analytic(cfg)
    if analytic is not None:
        assert n == analytic
    extra = 0
    for name, p in model.named_parameters():
        if name.endswith(("norm1.scale", "norm1.bias", "norm2.scale",
                          "norm2.bias", "final_norm.scale",
                          "final_norm.bias", "mamba.conv_b", "mlstm.b_if")):
            extra += p.numel()
    assert sum(p.numel() for p in model.parameters()) == n + extra
    di = cfg.ssm.expand * cfg.d_model
    H = cfg.ssm.num_heads
    kinds = [s.kind for s in TM.tfm.layer_specs(cfg)]
    norms = sum(p.numel() for nm, p in model.named_parameters()
                if "norm" in nm)
    assert extra == norms + kinds.count("mamba") * di \
        + kinds.count("mlstm") * 2 * H
