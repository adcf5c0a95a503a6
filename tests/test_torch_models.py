"""The port's walk-native LM (``repro_torch.models``) held against the
reference (``repro.models``) in one process, on the CPU.

Inputs come from numpy seeds; parameters are the reference's own
``init_params`` output carried across by ``interop.lm_params_from_ref``.
Tolerances (float32): logits and losses rtol 1e-5 / atol 1e-5; gradients
within 1e-4 of each leaf's largest magnitude (the reference's own
``tests/test_models_units.py``); prefill vs decode within 2e-3 (the
reference's ``tests/test_arch_smoke.py``); initial values within the
``erfinv`` gap, rtol 1e-5. The bfloat16 case: logits within four bf16
steps (4·2^-8) of the largest logit, the loss rtol 1e-3 (XLA keeps
float32 between fused elementwise ops where torch rounds each to bf16).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as ref_all_configs
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch import interop
from repro_torch import random as prng
from repro_torch.configs import all_configs, get_config, list_archs, reduced
from repro_torch.configs.base import AttentionConfig
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

ARCHS = ["olmo-1b", "qwen2-0.5b", "phi3-medium-14b", "deepseek-v2-236b",
         "arctic-480b", "xlstm-125m", "jamba-v0.1-52b"]
MOE_ARCHS = ["deepseek-v2-236b", "arctic-480b"]
RTOL = ATOL = 1e-5
LEAF_TOL = 1e-4


_ref_init = jax.jit(RM.init_params, static_argnums=0)
_ref_decode = jax.jit(RM.decode_step, static_argnums=1)


def _cfgs(arch, **kw):
    return (ref_reduced(ref_get_config(arch), **kw),
            reduced(get_config(arch), **kw))


@pytest.fixture(scope="module")
def ref_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            rcfg, _ = _cfgs(arch)
            cache[arch] = _ref_init(rcfg, jax.random.PRNGKey(0))
        return cache[arch]
    return get


def _batch(vocab, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labs = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labs)})


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _leaves_close(got: dict, want: dict, tol=LEAF_TOL):
    for name, g in got.items():
        w = want[name]
        gap = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
        assert gap <= tol, (name, gap)


# ---------------------------------------------------------------------------
# Configs and counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ref_all_configs()))
def test_registry_matches_reference(arch):
    """Every config field for field, and the analytic parameter counts
    (total and active) of every architecture."""
    ref, port = ref_get_config(arch), get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.approx_params() == ref.approx_params()
    assert port.approx_active_params() == ref.approx_active_params()
    assert dataclasses.asdict(reduced(port)) \
        == dataclasses.asdict(ref_reduced(ref))
    assert TM.count_params_analytic(reduced(port)) \
        == RM.count_params_analytic(ref_reduced(ref))


def test_registry_lists_the_reference_archs():
    assert list_archs() == sorted(ref_all_configs())
    assert set(all_configs()) == set(ref_all_configs())


# ---------------------------------------------------------------------------
# Initial values
# ---------------------------------------------------------------------------


def test_truncated_normal_matches_reference():
    """The uniform on [erf(-√2), erf(√2)) is jax's bit for bit; the values
    agree within the erfinv gap."""
    for seed, shape in ((0, (64, 4, 16)), (9, (1001,))):
        a, b = (float(jax.lax.erf(jnp.float32(x) / np.float32(np.sqrt(2))))
                for x in (-2.0, 2.0))
        want_u = jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                    minval=a, maxval=b)
        got_u = prng.uniform(prng.PRNGKey(seed), shape, "cpu", a, b)
        np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
        want = jax.random.truncated_normal(jax.random.PRNGKey(seed), -2.0,
                                           2.0, shape)
        got = prng.truncated_normal(prng.PRNGKey(seed), -2.0, 2.0, shape,
                                    "cpu")
        _close(got, want, rtol=1e-5, atol=1e-6)
        assert float(got.abs().max()) < 2.0


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference(arch, ref_params):
    _, cfg = _cfgs(arch)
    model = TM.init_params(cfg, prng.PRNGKey(0), "cpu")
    want = interop.lm_tree_from_ref(ref_params(arch), cfg, "cpu")
    got = TM.params_of(model)
    assert set(got) == set(want)
    for name, g in got.items():
        _close(g, want[name], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm",
                                  "nonparametric_ln"])
def test_norm_matches_reference(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    norm = TL.Norm(kind, 24, "cpu")
    params = {}
    with torch.no_grad():
        for name, p in norm.named_parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(24)
                                     .astype(np.float32)))
            params[name] = jnp.asarray(p.numpy())
    want = RL.apply_norm(params, jnp.asarray(x), kind)
    _close(norm(torch.from_numpy(x)).detach(), want)


def test_rope_mrope_sinusoidal_match_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    for theta in (10000.0, 1e6):
        _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta),
               RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    pos3 = rng.integers(0, 500, (2, 7, 3)).astype(np.int32)
    _close(TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                          10000.0, (4, 2, 2)),
           RL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 10000.0,
                          (4, 2, 2)))
    _close(TL.sinusoidal_positions(torch.from_numpy(pos), 32),
           RL.sinusoidal_positions(jnp.asarray(pos), 32))


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(activation):
    key = jax.random.PRNGKey(4)
    params = RL.init_mlp(key, 24, 40, activation)
    mlp = TL.MLP(None, 24, 40, activation, "cpu")
    with torch.no_grad():
        for name, p in mlp.named_parameters():
            p.copy_(torch.from_numpy(np.asarray(params[name])))
    x = np.random.default_rng(3).standard_normal((2, 5, 24)) \
        .astype(np.float32)
    _close(mlp(torch.from_numpy(x)).detach(),
           RL.apply_mlp(params, jnp.asarray(x), activation))
    # the same draws from the same key
    drawn = TL.MLP(prng.PRNGKey(4), 24, 40, activation, "cpu")
    for name, p in drawn.named_parameters():
        _close(p.detach(), params[name], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("Sq,Skv,H,Hkv,causal,window", [
    (64, 64, 4, 4, True, 0),
    (64, 64, 4, 2, True, 0),
    (33, 33, 4, 1, True, 0),       # ragged (pad path)
    (16, 48, 4, 4, False, 0),      # cross-attention shape
    (64, 64, 4, 2, True, 16),      # sliding window
])
def test_chunked_attention_matches_reference(Sq, Skv, H, Hkv, causal,
                                             window, monkeypatch):
    """The reference's own grid (``tests/test_models_units.py``) at
    16-row chunks in both packages."""
    for mod in (RA, TA):
        monkeypatch.setattr(mod, "Q_CHUNK", 16)
        monkeypatch.setattr(mod, "KV_CHUNK", 16)
    rng = np.random.default_rng(5)
    D = 8
    q = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((2, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((2, Skv, Hkv, D)).astype(np.float32)
    want = RA._chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 window=window)
    got = TA._chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                window=window)
    _close(got, want)


@pytest.mark.parametrize("V,chunk", [(1000, 16), (257, 7), (64, 128)])
def test_cross_entropy_chunked_matches_reference(V, chunk):
    rng = np.random.default_rng(6)
    B, S, d = 2, 33, 32
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    table = (rng.standard_normal((V, d)) / math.sqrt(d)).astype(np.float32)
    tgt = rng.integers(0, V, (B, S)).astype(np.int32)
    want_l, want_g = jax.value_and_grad(
        lambda xx, tt: RM.cross_entropy_chunked(xx, tt, jnp.asarray(tgt),
                                                chunk=chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(table))
    xt = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    got = TM.cross_entropy_chunked(xt, tt, torch.from_numpy(tgt),
                                   chunk=chunk)
    gx, gt = torch.autograd.grad(got, (xt, tt))
    _close(got.detach(), want_l)
    _leaves_close({"x": gx, "table": gt},
                  {"x": torch.from_numpy(np.asarray(want_g[0])),
                   "table": torch.from_numpy(np.asarray(want_g[1]))})


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch, ref_params):
    rcfg, cfg = _cfgs(arch)
    params = ref_params(arch)
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    rb, tb = _batch(cfg.vocab_size)
    x, _, _ = RM.forward(params, rcfg, rb)
    want_logits = RM.logits_from_hidden(params, rcfg, x)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: RM.loss_fn(p, rcfg, rb))(params)
    with torch.no_grad():
        xt, _, _ = TM.forward(model, tb)
        _close(TM.logits_from_hidden(model, xt), want_logits)
    loss = TM.loss_fn(model, tb)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    _close(loss.detach(), want_loss)
    _leaves_close(dict(zip(names, grads)),
                  interop.lm_tree_from_ref(want_grads, cfg, "cpu"))


def test_remat_changes_nothing(ref_params):
    """``remat="block"`` recomputes each block in the backward: the same
    loss and gradients as without it."""
    _, cfg = _cfgs("olmo-1b")
    _, tb = _batch(cfg.vocab_size)
    out = []
    for remat in ("none", "block"):
        c = dataclasses.replace(cfg, remat=remat)
        model = interop.lm_params_from_ref(ref_params("olmo-1b"), c, "cpu")
        loss = TM.loss_fn(model, tb)
        out.append((loss, torch.autograd.grad(loss,
                                              list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, ref_params):
    """8 decode steps' logits against the reference's, and against the
    port's own prefill within the reference's 2e-3."""
    rcfg, cfg = _cfgs(arch)
    params = ref_params(arch)
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    rb, tb = _batch(cfg.vocab_size, S=8, seed=7)
    rstate = RM.init_decode_state(rcfg, 2, 16)
    state = TM.init_decode_state(model, 2, 16)
    got = []
    with torch.no_grad():
        for t in range(8):
            want, rstate = _ref_decode(params, rcfg,
                                          rb["tokens"][:, t:t + 1], rstate)
            lg, state = TM.decode_step(model, tb["tokens"][:, t:t + 1],
                                       state)
            _close(lg, want)
            got.append(lg[:, 0])
        x, _, _ = TM.forward(model, tb)
        prefill = TM.logits_from_hidden(model, x)
    assert int(state.pos) == 8
    _close(torch.stack(got, 1), prefill, rtol=2e-3, atol=2e-3)


def test_windowed_decode_matches_reference(ref_params):
    """The ring cache of a sliding-window layer (window 4 < 12 steps) and
    the windowed chunked attention."""
    rcfg, cfg = _cfgs("olmo-1b")
    rcfg = dataclasses.replace(
        rcfg, attention=dataclasses.replace(rcfg.attention, window=4))
    cfg = dataclasses.replace(
        cfg, attention=dataclasses.replace(cfg.attention, window=4))
    params = ref_params("olmo-1b")
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    rb, tb = _batch(cfg.vocab_size, S=12, seed=8)
    rstate = RM.init_decode_state(rcfg, 2, 32)
    state = TM.init_decode_state(model, 2, 32)
    assert state.caches[0].k.shape[2] == 4
    with torch.no_grad():
        for t in range(12):
            want, rstate = _ref_decode(params, rcfg,
                                          rb["tokens"][:, t:t + 1], rstate)
            got, state = TM.decode_step(model, tb["tokens"][:, t:t + 1],
                                        state)
            _close(got, want)
        x, _, _ = TM.forward(model, tb)
    want_x, _, _ = RM.forward(params, rcfg, rb)
    _close(x, want_x)


def test_decode_continues_from_reference_state(ref_params):
    """``interop.decode_state_from_ref``: the reference's caches after 5
    steps, carried across, continue as the reference does."""
    rcfg, cfg = _cfgs("qwen2-0.5b")
    params = ref_params("qwen2-0.5b")
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    rb, tb = _batch(cfg.vocab_size, S=8, seed=9)
    rstate = RM.init_decode_state(rcfg, 2, 16)
    for t in range(5):
        _, rstate = _ref_decode(params, rcfg, rb["tokens"][:, t:t + 1],
                                   rstate)
    state = interop.decode_state_from_ref(rstate, cfg, "cpu")
    assert int(state.pos) == 5
    with torch.no_grad():
        for t in range(5, 8):
            want, rstate = _ref_decode(params, rcfg,
                                          rb["tokens"][:, t:t + 1], rstate)
            got, state = TM.decode_step(model, tb["tokens"][:, t:t + 1],
                                        state)
            _close(got, want)


def test_bf16_forward_matches_reference(ref_params):
    """bf16 compute from float32 masters (olmo-1b's and qwen2-0.5b's
    ``dtype``), reduced olmo-1b; ``cast_for_serving`` keeps the bits."""
    rcfg, cfg = _cfgs("olmo-1b")
    rcfg = dataclasses.replace(rcfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = ref_params("olmo-1b")
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    rb, tb = _batch(cfg.vocab_size)
    x, _, _ = RM.forward(params, rcfg, rb)
    want = np.asarray(RM.logits_from_hidden(params, rcfg, x)
                      .astype(jnp.float32))
    with torch.no_grad():
        xt, _, _ = TM.forward(model, tb)
        got = TM.logits_from_hidden(model, xt)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        loss = TM.loss_fn(model, tb)
        served = TM.cast_for_serving(
            interop.lm_params_from_ref(params, cfg, "cpu"))
        xs, _, _ = TM.forward(served, tb)
        assert torch.equal(TM.logits_from_hidden(served, xs).float(),
                           torch.from_numpy(got))
    assert np.abs(got - want).max() <= 4 * 2**-8 * np.abs(want).max()
    _close(loss, RM.loss_fn(params, rcfg, rb), rtol=1e-3, atol=0)


def test_lm_params_round_trip(ref_params):
    """``lm_params_to_ref`` inverts ``lm_params_from_ref`` bit for bit,
    with the reference's tree structure (empty dicts for OLMo's norms)."""
    rcfg, cfg = _cfgs("olmo-1b")
    params = ref_params("olmo-1b")
    back = interop.lm_params_to_ref(
        interop.lm_params_from_ref(params, cfg, "cpu"))
    flat_want, tree_want = jax.tree_util.tree_flatten(params)
    flat_got, tree_got = jax.tree_util.tree_flatten(back)
    assert tree_got == tree_want
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_lm_entry_points_need_a_card_or_cpu(monkeypatch):
    """Without a card the model is refused unless the caller names the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs("olmo-1b")
    for make in (lambda d: TM.init_params(cfg, prng.PRNGKey(0), d),
                 lambda d: TM.TransformerLM(cfg, None, d),
                 lambda d: interop.lm_params_from_ref(
                     interop.lm_params_to_ref(
                         TM.TransformerLM(cfg, None, "cpu")), cfg, d)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(None)
        assert make("cpu").device.type == "cpu"


def test_attention_config_kinds():
    """``make_attention`` builds GQA and MLA with the reference's leaves and
    refuses an unknown kind."""
    gqa = TA.make_attention(None, AttentionConfig(kind="gqa"), 16, "cpu")
    assert isinstance(gqa, TA.Attention)
    mla_cfg = AttentionConfig(kind="mla", n_heads=2, q_lora_rank=8,
                              kv_lora_rank=4, qk_nope_head_dim=4,
                              qk_rope_head_dim=2, v_head_dim=4)
    mla = TA.make_attention(None, mla_cfg, 16, "cpu")
    assert isinstance(mla, TA.MLA)
    assert {n: tuple(p.shape) for n, p in mla.named_parameters()} == {
        k: v.shape for k, v in RA.init_attention(
            jax.random.PRNGKey(0), mla_cfg, 16).items()}
    with pytest.raises(ValueError, match="unknown attention kind"):
        TA.make_attention(None, AttentionConfig(kind="bogus"), 16, "cpu")
    with pytest.raises(ValueError):
        TA.Attention(None, mla_cfg, 16, "cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_continues_from_reference_state(arch, ref_params):
    """``decode_state_from_ref`` carries the reference's MLA latent caches
    (deepseek) and GQA caches (arctic) across after 5 steps."""
    rcfg, cfg = _cfgs(arch)
    params = ref_params(arch)
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    rb, tb = _batch(cfg.vocab_size, S=8, seed=9)
    rstate = RM.init_decode_state(rcfg, 2, 16)
    for t in range(5):
        _, rstate = _ref_decode(params, rcfg, rb["tokens"][:, t:t + 1],
                                rstate)
    state = interop.decode_state_from_ref(rstate, cfg, "cpu")
    kind = TA.MLACache if cfg.attention.kind == "mla" else TA.KVCache
    assert int(state.pos) == 5 and all(isinstance(c, kind)
                                       for c in state.caches)
    with torch.no_grad():
        for t in range(5, 8):
            want, rstate = _ref_decode(params, rcfg,
                                       rb["tokens"][:, t:t + 1], rstate)
            got, state = TM.decode_step(model, tb["tokens"][:, t:t + 1],
                                        state)
            _close(got, want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_params_round_trip(arch, ref_params):
    """``lm_params_to_ref`` inverts ``lm_params_from_ref`` bit for bit on
    the MoE and MLA leaves, with the reference's tree structure."""
    params = ref_params(arch)
    _, cfg = _cfgs(arch)
    back = interop.lm_params_to_ref(
        interop.lm_params_from_ref(params, cfg, "cpu"))
    flat_want, tree_want = jax.tree_util.tree_flatten(params)
    flat_got, tree_got = jax.tree_util.tree_flatten(back)
    assert tree_got == tree_want
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_with_groups_matches_reference(arch, ref_params):
    """``num_groups`` 4 (dividing the 64 tokens) and 3 (not: gcd 1) in
    ``forward`` and ``loss_fn``: the same pre-logits, aux and loss as the
    reference's."""
    rcfg, cfg = _cfgs(arch)
    params = ref_params(arch)
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    rb, tb = _batch(cfg.vocab_size)
    for g in (4, 3):
        want_x, _, want_aux = RM.forward(params, rcfg, rb, num_groups=g)
        with torch.no_grad():
            x, _, aux = TM.forward(model, tb, num_groups=g)
            loss = TM.loss_fn(model, tb, num_groups=g)
        _close(x, want_x)
        _close(aux, want_aux)
        assert float(aux) > 0
        _close(loss, RM.loss_fn(params, rcfg, rb, num_groups=g))


def test_moe_serving_cast_keeps_mla_norms_float32(ref_params):
    """``cast_for_serving`` keeps ``q_norm``/``kv_norm`` float32 and casts
    the MoE and MLA matrices; ``init_params(dtype=bf16)`` gives the same
    bits without the float32 model."""
    _, cfg = _cfgs("deepseek-v2-236b")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    served = TM.cast_for_serving(TM.init_params(cfg, prng.PRNGKey(0),
                                                "cpu"))
    direct = TM.init_params(cfg, prng.PRNGKey(0), "cpu",
                            dtype=torch.bfloat16)
    for (n, p), (n2, q) in zip(served.named_parameters(),
                               direct.named_parameters()):
        assert n == n2 and p.dtype == q.dtype and torch.equal(p, q), n
        want = torch.float32 if n.endswith(("q_norm", "kv_norm", "scale")) \
            else torch.bfloat16
        assert p.dtype == want, n

