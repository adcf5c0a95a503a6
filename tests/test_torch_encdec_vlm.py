"""The port's enc-dec and VLM families, seamless-m4t-medium (an encoder
stack over audio frames, cross-attention in every decoder layer) and
qwen2-vl-72b (patch embeddings before the text, M-RoPE), held against
the reference on ``reduced()`` configs in one process, on the CPU.

Inputs come from numpy seeds (frames scaled 0.1, patches 0.02, as
``tests/test_arch_smoke.py`` draws them); parameters are the reference's
own ``init_params`` output carried across by ``interop``. Tolerances are
``tests/test_torch_models.py``'s: logits and losses rtol/atol 1e-5,
gradients within 1e-4 of each leaf's largest magnitude, prefill against
decode within 2e-3, initial values within the ``erfinv`` gap; M-RoPE
positions, greedy tokens and parameter round trips bit for bit. The
train steps are held as ``tests/test_torch_ssm_lm.py`` holds the
recurrent families', the second step from the reference's first-step
state. Each reference entry point is jitted once a process.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.configs import reduced as ref_reduced
from repro.models import attention as RA
from repro.models import model as RM
from repro.models import transformer as RT
from repro.train import checkpoint as rckpt
from repro.train.optimizer import AdamWConfig as RAdamW
from repro.train.optimizer import init_opt_state as ref_init_opt
from repro.train.train_loop import make_serve_step as ref_serve_step
from repro_torch import interop
from repro_torch import random as prng
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import AttentionConfig
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.transformer import Memory
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.optimizer import AdamWConfig, init_opt_state, lr_at
from repro_torch.train.train_loop import (make_eval_step, make_prefill_step,
                                          make_serve_step, make_train_step)
from test_torch_models import _close, _leaves_close
from test_torch_train_loop import (LEAF_TOL, OPT, RTOL, UNRESOLVED,
                                   _leaf_gap, _ref_step)

ARCHS = ["seamless-m4t-medium", "qwen2-vl-72b"]
N_PATCHES = 8        # not a square: the grid's rows run past its side
N_FRAMES = 16

_ref_init = jax.jit(RM.init_params, static_argnums=0)
_ref_decode = jax.jit(RM.decode_step, static_argnums=1)
_ref_forward = jax.jit(RM.forward, static_argnums=1)
_ref_loss_grad = jax.jit(jax.value_and_grad(RM.loss_fn), static_argnums=1)
_ref_encoder = jax.jit(RM._run_encoder, static_argnums=(1, 3))


def _cfgs(arch):
    return ref_reduced(ref_get_config(arch)), reduced(get_config(arch))


@pytest.fixture(scope="module")
def ref_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _ref_init(_cfgs(arch)[0], jax.random.PRNGKey(0))
        return cache[arch]
    return get


def _batch(cfg, B=2, S=32, seed=0, n_patches=N_PATCHES):
    """(reference batch, port batch) from one numpy seed: ``S`` positions
    in all, of which ``n_patches`` are patches for a VLM; an enc-dec
    batch also holds ``N_FRAMES`` frames."""
    rng = np.random.default_rng(seed)
    S_t = S - n_patches if cfg.family == "vlm" else S
    arrays = {k: rng.integers(0, cfg.vocab_size, (B, S_t)).astype(np.int32)
              for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        arrays["patches"] = (0.02 * rng.standard_normal(
            (B, n_patches, cfg.d_model))).astype(np.float32)
    if cfg.family == "enc_dec":
        arrays["frames"] = (0.1 * rng.standard_normal(
            (B, N_FRAMES, cfg.d_model))).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _decode_states(arch, params, model, rb, tb, B=2, S=16):
    """Fresh decode states of both packages; an enc-dec state's memory is
    the encoder's output on the batch's frames, as a server sets it."""
    rcfg, _ = _cfgs(arch)
    rstate = RM.init_decode_state(rcfg, B, S)
    state = TM.init_decode_state(model, B, S)
    if rcfg.family == "enc_dec":
        rstate["enc_out"], rstate["enc_pos"] = _ref_encoder(
            params, rcfg, rb["frames"], jnp.float32)
        with torch.no_grad():
            enc_out, enc_pos = TM.run_encoder(model, tb["frames"])
        state = state._replace(enc_out=enc_out, enc_pos=enc_pos)
    return rstate, state


# ---------------------------------------------------------------------------
# Building, initial values, positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ref_list_archs())
def test_every_config_builds(arch):
    """Every registry config, reduced, builds on the CPU with the
    reference's parameter names and shapes."""
    rcfg, cfg = _cfgs(arch)
    model = TM.init_params(cfg, prng.PRNGKey(0), "cpu")
    want = jax.eval_shape(lambda: RM.init_params(rcfg,
                                                 jax.random.PRNGKey(0)))
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    skel = interop.lm_tree_from_ref(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), want), cfg, "cpu")
    assert shapes == {n: tuple(t.shape) for n, t in skel.items()}
    assert jax.tree.structure(interop.lm_params_to_ref(model)) \
        == jax.tree.structure(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference(arch, ref_params):
    """The decoder (with ``norm_x``/``cross`` for enc-dec), the encoder
    stack from the key's ``split(·, 8)[3]`` and ``enc_norm``."""
    _, cfg = _cfgs(arch)
    model = TM.init_params(cfg, prng.PRNGKey(0), "cpu")
    want = interop.lm_tree_from_ref(ref_params(arch), cfg, "cpu")
    got = TM.params_of(model)
    assert set(got) == set(want)
    if cfg.family == "enc_dec":
        assert any(n.startswith("enc_layers.") for n in got)
        assert any(".cross.wq" in n for n in got)
    for name, g in got.items():
        _close(g, want[name], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n_patches", [0, 8, 16, 1024])
def test_mrope_positions_match_reference(n_patches):
    """Bit for bit: no patches, 8 (not a square: ``side`` 2, rows 0–3),
    16 and ``N_PATCHES``."""
    S = n_patches + 5
    want = RM._mrope_positions(3, S, n_patches)
    got = TM._mrope_positions(3, S, n_patches, "cpu")
    assert got.dtype == torch.int32 and got.shape == (3, S, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert TM.N_PATCHES == RM.N_PATCHES and TM.ENC_FRAMES == RM.ENC_FRAMES


# ---------------------------------------------------------------------------
# The encoder and cross-attention
# ---------------------------------------------------------------------------


def test_run_encoder_matches_reference(ref_params):
    rcfg, cfg = _cfgs("seamless-m4t-medium")
    params = ref_params("seamless-m4t-medium")
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    rb, tb = _batch(cfg)
    want_out, want_pos = _ref_encoder(params, rcfg, rb["frames"],
                                      jnp.float32)
    with torch.no_grad():
        out, pos = TM.run_encoder(model, tb["frames"])
    _close(out, want_out)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))


@functools.partial(jax.jit, static_argnums=1)
def _ref_block(lp, rcfg, x, enc, w):
    """A reference decoder layer over ``enc`` and the gradients of
    ``sum(y · w)`` to its input and to the memory."""
    B, Sq, _ = x.shape
    pos = jnp.broadcast_to(jnp.arange(Sq, dtype=jnp.int32)[None], (B, Sq))
    epos = jnp.broadcast_to(jnp.arange(enc.shape[1], dtype=jnp.int32)[None],
                            enc.shape[:2])

    def ref(xx, ee):
        y, _, _ = RT.apply_layer(lp, rcfg, RT.LayerSpec("attn", "dense"),
                                 xx, pos, mode="forward", enc_out=ee,
                                 enc_positions=epos, causal=True)
        return y
    y = ref(x, enc)
    return y, jax.grad(lambda xx, ee: jnp.sum(ref(xx, ee) * w),
                       argnums=(0, 1))(x, enc)


@pytest.mark.parametrize("Sq", [1, 8])
def test_cross_attention_block_matches_reference(Sq, ref_params):
    """A decoder block of reduced seamless over 16 frames: the output and
    its gradients to the block's input and to the memory."""
    rcfg, cfg = _cfgs("seamless-m4t-medium")
    params = ref_params("seamless-m4t-medium")
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    blk = model.layers[0][0]["pos0"]
    assert blk.cross_attention
    lp = jax.tree.map(lambda a: a[0], params["layers"][0]["pos0"])
    rng = np.random.default_rng(Sq)
    x = rng.standard_normal((2, Sq, cfg.d_model)).astype(np.float32)
    enc = (0.1 * rng.standard_normal((2, N_FRAMES, cfg.d_model))) \
        .astype(np.float32)
    w = rng.standard_normal((2, Sq, cfg.d_model)).astype(np.float32)
    want, (want_gx, want_ge) = _ref_block(lp, rcfg, jnp.asarray(x),
                                          jnp.asarray(enc), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    et = torch.from_numpy(enc).requires_grad_()
    y, aux = blk(xt, None, memory=Memory(et, None))
    assert aux is None
    gx, ge = torch.autograd.grad((y * torch.from_numpy(w)).sum(), (xt, et))
    _close(y.detach(), want)
    _leaves_close({"x": gx, "enc": ge},
                  {"x": torch.from_numpy(np.asarray(want_gx)),
                   "enc": torch.from_numpy(np.asarray(want_ge))})


@pytest.mark.parametrize("rope", ["sinusoidal", "rope", "mrope"])
def test_cross_attention_rotates_keys_at_memory_positions(rope):
    """``Attention(kv=...)`` in the general case: the keys rotated at the
    memory's positions, the queries at their own, with QKV biases;
    ``"sinusoidal"`` is the identity in attention."""
    att = AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=16,
                          qkv_bias=True, rope=rope,
                          mrope_sections=(4, 2, 2) if rope == "mrope"
                          else ())
    d, Sq, Sk = 32, 5, 12
    params = RA.init_attention(jax.random.PRNGKey(3), att, d)
    rng = np.random.default_rng(4)
    for b in ("bq", "bk", "bv"):
        params[b] = jnp.asarray(0.1 * rng.standard_normal(params[b].shape),
                                jnp.float32)
    x = rng.standard_normal((2, Sq, d)).astype(np.float32)
    enc = rng.standard_normal((2, Sk, d)).astype(np.float32)
    shape = (3,) if rope == "mrope" else ()
    qpos = rng.integers(0, 50, (2, Sq) + shape).astype(np.int32)
    kpos = rng.integers(0, 50, (2, Sk) + shape).astype(np.int32)
    want = RA.gqa_forward(params, att, jnp.asarray(x), jnp.asarray(qpos),
                          causal=False, kv=(jnp.asarray(enc),
                                            jnp.asarray(enc),
                                            jnp.asarray(kpos)))
    a = TA.Attention(None, att, d, "cpu")
    with torch.no_grad():
        for n, p in a.named_parameters():
            p.copy_(torch.from_numpy(np.asarray(params[n])))
        e = torch.from_numpy(enc)
        got = a(torch.from_numpy(x),
                TL.positional_tables(att, torch.from_numpy(qpos)),
                causal=False,
                kv=(e, e, TL.positional_tables(att,
                                               torch.from_numpy(kpos))))
    _close(got, want)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch, ref_params):
    """Logits over the whole sequence (patches included), the loss over
    the text, every gradient leaf (the encoder's, the patches' own
    positions' through M-RoPE)."""
    rcfg, cfg = _cfgs(arch)
    params = ref_params(arch)
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    rb, tb = _batch(cfg)
    x, pos, _ = _ref_forward(params, rcfg, rb)
    want_logits = RM.logits_from_hidden(params, rcfg, x)
    want_loss, want_grads = _ref_loss_grad(params, rcfg, rb)
    with torch.no_grad():
        xt, post, _ = TM.forward(model, tb)
        _close(TM.logits_from_hidden(model, xt), want_logits)
    np.testing.assert_array_equal(post.numpy(), np.asarray(pos))
    loss = TM.loss_fn(model, tb)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    _close(loss.detach(), want_loss)
    _leaves_close(dict(zip(names, grads)),
                  interop.lm_tree_from_ref(want_grads, cfg, "cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_nothing(arch, ref_params):
    """``remat="block"`` checkpoints the encoder's periods and the
    decoder's, whose cross-attention reads the memory: the same loss and
    gradients as without it."""
    _, cfg = _cfgs(arch)
    _, tb = _batch(cfg)
    out = []
    for remat in ("none", "block"):
        c = dataclasses.replace(cfg, remat=remat)
        model = interop.lm_params_from_ref(ref_params(arch), c, "cpu")
        loss = TM.loss_fn(model, tb)
        out.append((loss, torch.autograd.grad(loss,
                                              list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_from_reference_state(arch, ref_params):
    """``decode_state_from_ref`` after 5 reference steps (seamless: its
    memory set by the encoder, carried across with the caches) continues
    as the reference does; M-RoPE decodes at ``(p, p, p)``."""
    rcfg, cfg = _cfgs(arch)
    params = ref_params(arch)
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    rb, tb = _batch(cfg, S=8 + (N_PATCHES if cfg.family == "vlm" else 0),
                    seed=9)
    rstate, _ = _decode_states(arch, params, model, rb, tb)
    for t in range(5):
        _, rstate = _ref_decode(params, rcfg, rb["tokens"][:, t:t + 1],
                                rstate)
    state = interop.decode_state_from_ref(rstate, cfg, "cpu")
    assert int(state.pos) == 5
    assert (state.enc_out is None) == (cfg.family != "enc_dec")
    with torch.no_grad():
        for t in range(5, 8):
            want, rstate = _ref_decode(params, rcfg,
                                       rb["tokens"][:, t:t + 1], rstate)
            got, state = TM.decode_step(model, tb["tokens"][:, t:t + 1],
                                        state)
            _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_decode(arch, ref_params):
    """8 decode steps within 2e-3 of the port's prefill of the same
    tokens: seamless over its encoder memory, qwen2-vl with 0 patches
    (``tests/test_arch_smoke.py``)."""
    _, cfg = _cfgs(arch)
    params = ref_params(arch)
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    rb, tb = _batch(cfg, S=8, seed=5, n_patches=0)
    _, state = _decode_states(arch, params, model, rb, tb)
    with torch.no_grad():
        x, _, _ = TM.forward(model, tb)
        prefill = TM.logits_from_hidden(model, x)
        got = []
        for t in range(8):
            lg, state = TM.decode_step(model, tb["tokens"][:, t:t + 1],
                                       state)
            got.append(lg[:, 0])
    _close(torch.stack(got, 1), prefill, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_reference(arch, ref_params):
    """12 greedy steps from a 4-token prompt: the same int32 tokens."""
    rcfg, cfg = _cfgs(arch)
    params = ref_params(arch)
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    rb, tb = _batch(cfg, seed=2)
    rserve = jax.jit(ref_serve_step(rcfg))
    serve = make_serve_step(model)
    p = TM.params_of(model)
    rstate, state = _decode_states(arch, params, model, rb, tb, S=32)
    rtok, tok = rb["tokens"][:, :1], tb["tokens"][:, :1]
    for t in range(16):
        if t < 4:                       # the prompt, teacher-forced
            rtok, tok = rb["tokens"][:, t:t + 1], tb["tokens"][:, t:t + 1]
        rtok, rstate = rserve(params, rtok, rstate)
        tok, state = serve(p, tok, state)
        assert tok.dtype == torch.int32 and tok.shape == (2, 1)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_and_checkpoint(arch, ref_params, tmp_path):
    """``lm_params_to_ref`` inverts ``lm_params_from_ref`` bit for bit
    both ways, with the reference's tree (``enc_layers``, ``enc_norm``,
    ``cross``, ``norm_x``); the port's checkpoint of it restores in the
    reference bit for bit."""
    params = ref_params(arch)
    _, cfg = _cfgs(arch)
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    back = interop.lm_params_to_ref(model)
    flat_want, tree_want = jax.tree_util.tree_flatten(params)
    flat_got, tree_got = jax.tree_util.tree_flatten(back)
    assert tree_got == tree_want
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g, np.asarray(w))
    again = TM.params_of(interop.lm_params_from_ref(back, cfg, "cpu"))
    assert all(torch.equal(t, again[n])
               for n, t in TM.params_of(model).items())
    tckpt.save(os.path.join(tmp_path, "params"), back, 1)
    got = rckpt.restore(os.path.join(tmp_path, "params"), params)
    for g, w in zip(jax.tree_util.tree_leaves(got), flat_want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, ref_params):
    """Two ``make_train_step`` steps, the first from the same carried
    parameters, the second from the reference's first-step parameters
    and moments: metrics, moments and parameters at
    ``tests/test_torch_train_loop.py``'s tolerances; the batch's
    ``frames`` and ``patches`` pass through the step."""
    rcfg, cfg = _cfgs(arch)
    rb, tb = _batch(cfg, seed=3)
    rstep = _ref_step(arch)
    p_r = ref_params(arch)
    o_r = ref_init_opt(p_r, RAdamW(**OPT))
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


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_and_prefill_steps_match_reference(arch, ref_params):
    """The eval loss and the prefill's last logits as the reference's,
    the batch's ``frames`` and ``patches`` passed through unchanged."""
    rcfg, cfg = _cfgs(arch)
    params = ref_params(arch)
    model = interop.lm_params_from_ref(params, cfg, "cpu")
    p = TM.params_of(model)
    rb, tb = _batch(cfg)
    # the reference's eval step is its loss_fn, its prefill step the
    # forward's last logits: their jitted functions, compiled once
    np.testing.assert_allclose(
        float(make_eval_step(model)(p, tb)),
        float(_ref_loss_grad(params, rcfg, rb)[0]), rtol=RTOL)
    x, _, _ = _ref_forward(params, rcfg, rb)
    want = RM.logits_from_hidden(params, rcfg, x[:, -1:, :])
    got = make_prefill_step(model)(
        p, {k: v for k, v in tb.items() if k != "labels"})
    assert got.shape == (2, 1, cfg.vocab_size)
    _close(got, want)
