"""The port's AdamW (repro_torch/train/optimizer.py), its params and
optimiser checkpoints (train/checkpoint.py) and ``TrainSupervisor``
(distributed/fault_tolerance.py) against the JAX reference, in one
process.

* ``apply_updates`` over 50 steps, without and with int8 compression,
  with the global-norm clip active and inactive: params and moments
  within ``TREE_TOL`` of each leaf's largest magnitude (the clip scales
  every gradient by a norm whose float32 sum runs in another order), the
  int8 residuals (so the codes) bit for bit at every step; ``lr_at`` and ``global_norm`` within 1e-6;
  ``compress_int8`` bit for bit, its codes and residual.
* The reference's own unit tests, ported: descent, clipping, schedule,
  error feedback, compressed training, the global norm.
* Checkpoints in the reference's format both ways, for params plus
  ``OptState`` with and without ``error``: the same files, byte for
  byte, and each package restores the other's.
* ``TrainSupervisor``: a crash and a resume from the last checkpoint
  equal the uninterrupted run bit for bit, with the reference's
  counters; its run equals the reference's supervisor within the
  tolerance.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import fault_tolerance as jft
from repro.obs.registry import MetricsRegistry as JRegistry
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro_torch import interop
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.train import checkpoint as tck
from repro_torch.train import optimizer as topt

TREE_TOL = 2e-6
SHAPES = {"a": (64, 16), "b": (300,), "c": (7, 3, 5)}


def _params(rng):
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def _close_tree(ref, got, what):
    for k in SHAPES:
        want = np.asarray(ref[k])
        gap = np.abs(got[k].numpy() - want).max()
        assert gap <= TREE_TOL * np.abs(want).max(), (what, k, gap)


def _equal_tree(ref, got, what):
    for k in SHAPES:
        np.testing.assert_array_equal(got[k].numpy().view(np.uint32),
                                      np.asarray(ref[k]).view(np.uint32),
                                      err_msg=f"{what}/{k}")


@pytest.mark.parametrize("compression", ["none", "int8"])
@pytest.mark.parametrize("clip_norm", [1.0, 100.0])
def test_apply_updates_matches_reference(compression, clip_norm):
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, warmup_steps=5, total_steps=60, clip_norm=clip_norm,
              compression=compression)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp, tp = _both(_params(rng))
    js, ts = jopt.init_opt_state(jp, jcfg), topt.init_opt_state(tp, tcfg)
    assert (ts.error is None) == (compression == "none")
    for _ in range(50):
        jg, tg = _both({k: (0.3 * rng.normal(size=s)).astype(np.float32)
                        for k, s in SHAPES.items()})
        jp, js, jm = jopt.apply_updates(jp, jg, js, jcfg)
        tp, ts, tm = topt.apply_updates(tp, tg, ts, tcfg)
        assert int(ts.step) == int(js.step) and ts.step.dtype == torch.int32
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        _close_tree(jp, tp, "params")
        _close_tree(js.mu, ts.mu, "mu")
        _close_tree(js.nu, ts.nu, "nu")
        if compression == "int8":
            _equal_tree(js.error, ts.error, "error")


def test_lr_at_and_global_norm_match_reference():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100),
               dict(lr=3e-4, warmup_steps=0, total_steps=50,
                    min_lr_ratio=0.0)):
        for s in range(0, 121, 3):
            np.testing.assert_allclose(
                float(topt.lr_at(topt.AdamWConfig(**kw), torch.tensor(s))),
                float(jopt.lr_at(jopt.AdamWConfig(**kw), jnp.asarray(s))),
                rtol=1e-6, atol=1e-12)
    jt, tt = _both(_params(np.random.default_rng(1)))
    np.testing.assert_allclose(float(topt.global_norm(tt)),
                               float(jopt.global_norm(jt)), rtol=1e-6)


def test_compress_int8_matches_reference_bitwise():
    rng = np.random.default_rng(2)
    for _ in range(20):
        g = (rng.normal(size=1000) * rng.uniform(0.01, 10)).astype(np.float32)
        e = (0.01 * rng.normal(size=1000)).astype(np.float32)
        jd, je = jopt.compress_int8(jnp.asarray(g), jnp.asarray(e))
        td, te = topt.compress_int8(torch.from_numpy(g), torch.from_numpy(e))
        q, scale = topt.quantize_int8(torch.from_numpy(g + e))
        assert q.dtype == torch.int8 and int(q.abs().max()) == 127
        for got, want in ((td, jd), (te, je),
                          (q.to(torch.float32) * scale, jd)):
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          np.asarray(want).view(np.uint32))


# ---- the reference's own unit tests (tests/test_optimizer.py), ported ----

def test_adamw_descends_quadratic():
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                           total_steps=1000, clip_norm=100.0)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = topt.init_opt_state(params, cfg)
    for _ in range(200):
        params, state, _ = topt.apply_updates(
            params, {"x": 2 * params["x"]}, state, cfg)
    assert float(params["x"].abs().max()) < 0.2


def test_grad_clipping():
    cfg = topt.AdamWConfig(clip_norm=1.0, warmup_steps=0)
    params = {"x": torch.zeros(4)}
    state = topt.init_opt_state(params, cfg)
    new, _, metrics = topt.apply_updates(
        params, {"x": torch.full((4,), 1e6)}, state, cfg)
    assert float(metrics["grad_norm"]) > 1e5   # raw norm reported
    assert torch.isfinite(new["x"]).all()


def test_lr_schedule_shape():
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                           min_lr_ratio=0.1)
    lrs = [float(topt.lr_at(cfg, torch.tensor(s))) for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 1.0) < 1e-6        # end of warmup
    assert lrs[-1] <= lrs[1]
    assert lrs[-1] >= 0.1 - 1e-6           # min ratio floor


def test_int8_compression_error_feedback():
    """Error feedback makes compression unbiased over repeated steps."""
    g = torch.tensor([0.001, 0.5, -0.3, 1.0])
    err = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    for _ in range(100):
        deq, err = topt.compress_int8(g, err)
        acc = acc + deq
    np.testing.assert_allclose((acc / 100).numpy(), g.numpy(), atol=2e-3)


def test_compressed_training_matches_uncompressed_coarsely():
    w_true = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(0), (8,))))
    for comp in ("none", "int8"):
        cfg = topt.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                               compression=comp)
        params = {"w": torch.zeros(8)}
        state = topt.init_opt_state(params, cfg)
        for _ in range(300):
            params, state, _ = topt.apply_updates(
                params, {"w": 2 * (params["w"] - w_true)}, state, cfg)
        assert float((params["w"] - w_true).abs().max()) < 0.05, comp


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(topt.global_norm(t)) - 5.0) < 1e-6


# ---- checkpoints and the supervisor ---------------------------------------

def _trained_states(compression):
    """(reference, port) (params, OptState) after 3 steps from one start."""
    rng = np.random.default_rng(3)
    kw = dict(lr=1e-2, warmup_steps=0, compression=compression)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp, _ = _both(_params(rng))
    js = jopt.init_opt_state(jp, jcfg)
    for _ in range(3):
        jg, _ = _both(_params(rng))
        jp, js, _ = jopt.apply_updates(jp, jg, js, jcfg)
    tp = interop.tree_from_ref(jp, "cpu")
    ts = interop.opt_state_from_ref(js, "cpu")
    assert (ts.error is None) == (compression == "none")
    return (jp, js), (tp, ts)


def _files(d):
    """The checkpoint's files and their bytes (the reference leaves empty
    temporaries beside them, which are not part of the format)."""
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if not f.endswith(".tmp")}


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_checkpoints_cross_both_ways(tmp_path, compression):
    (jp, js), (tp, ts) = _trained_states(compression)
    for name, jtree, ttree in (("params", jp, tp), ("opt", js, ts)):
        jdir, tdir = str(tmp_path / f"j_{name}"), str(tmp_path / f"t_{name}")
        jck.save(jdir, jtree, 7)
        tck.save(tdir, ttree, 7)
        assert _files(tdir) == _files(jdir)
        got = tck.restore(jdir, ttree)
        back = jck.restore(tdir, jtree)
        for (k, a), (_, b) in zip(tck._flatten_with_paths(got),
                                  tck._flatten_with_paths(ttree)):
            assert a.dtype == b.dtype and torch.equal(a, b), k
        jleaves = jax.tree_util.tree_flatten_with_path(back)[0]
        assert len(jleaves) == len(tck._flatten_with_paths(ttree))
        for (_, a), (_, b) in zip(jleaves, tck._flatten_with_paths(ttree)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    names = set(_files(str(tmp_path / "t_opt")))
    assert ".step.npy" in names and ".mu__a.npy" in names
    assert any(n.startswith(".error") for n in names) \
        == (compression == "int8")


def _supervised(pkg_opt, sup, params, opt, batches, cfg, **kw):
    def step_fn(p, o, batch):
        grads = {"w": p["w"] - batch}
        return pkg_opt.apply_updates(p, grads, o, cfg)
    return sup.run(step_fn, params, opt, batches, **kw)


def test_train_supervisor_resume_is_bitwise(tmp_path):
    cfg = topt.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.0,
                           compression="int8")
    params = {"w": torch.ones(4)}
    opt = topt.init_opt_state(params, cfg)
    reg = MetricsRegistry()
    sup = tft.TrainSupervisor(str(tmp_path / "t"), save_every=5,
                              registry=reg)
    batches = [torch.full((4,), float(i)) for i in range(12)]
    p1, o1, step = _supervised(topt, sup, params, opt, batches, cfg,
                               max_steps=12)
    assert step == 12 and sup.resume_step() == 10
    assert reg.value("checkpoints_total", {"kind": "train"}) == 2
    # "crash": restart from the checkpoint and replay the tail
    p2, o2 = sup.restore(params, opt, device="cpu")
    assert int(o2.step) == 10 and o2.step.dtype == torch.int32
    p2, o2, step2 = _supervised(topt, sup, p2, o2, batches[10:], cfg,
                                start_step=10, max_steps=12)
    assert step2 == 12
    for a, b in zip(tck._flatten_with_paths((p1, o1)),
                    tck._flatten_with_paths((p2, o2))):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]

    # the reference's supervisor on the same steps
    jcfg = jopt.AdamWConfig(**cfg._asdict())
    jparams = {"w": jnp.ones(4)}
    jsup = jft.TrainSupervisor(str(tmp_path / "j"), save_every=5,
                               registry=JRegistry())
    jp1, jo1, _ = _supervised(jopt, jsup, jparams,
                              jopt.init_opt_state(jparams, jcfg),
                              [jnp.full((4,), float(i)) for i in range(12)],
                              jcfg, max_steps=12)
    np.testing.assert_allclose(p1["w"].numpy(), np.asarray(jp1["w"]),
                               rtol=1e-6)
    np.testing.assert_allclose(o1.mu["w"].numpy(), np.asarray(jo1.mu["w"]),
                               rtol=1e-6)
    # each restores the other's checkpoint
    jp2, jo2 = jsup.restore(jparams, jopt.init_opt_state(jparams, jcfg))
    tp2, to2 = sup.restore(params, opt, device="cpu")
    got = tft.TrainSupervisor(str(tmp_path / "j")).restore(params, opt,
                                                            device="cpu")
    assert int(got[1].step) == int(jo2.step) == 10
    np.testing.assert_array_equal(got[0]["w"].numpy(), np.asarray(jp2["w"]))
    back = jft.TrainSupervisor(str(tmp_path / "t")).restore(
        jparams, jopt.init_opt_state(jparams, jcfg))
    np.testing.assert_array_equal(np.asarray(back[0]["w"]),
                                  tp2["w"].numpy())
    np.testing.assert_array_equal(np.asarray(back[1].error["w"]),
                                  to2.error["w"].numpy())


def test_train_supervisor_reports_stragglers(tmp_path):
    reg = MetricsRegistry()
    events = []
    sup = tft.TrainSupervisor(
        str(tmp_path), save_every=100, registry=reg,
        straggler=tft.StragglerPolicy(threshold=3.0, max_flags=2))
    times = iter([0.01] * 5 + [0.1, 0.1, 0.01])

    def step_fn(p, o, batch):
        import time
        time.sleep(next(times))
        return p, o, {}
    sup.run(step_fn, {}, {}, range(8), on_event=lambda s, v: events.append(v))
    assert events == ["straggler", "remesh"]
    assert reg.value("straggler_events_total", {"verdict": "remesh"}) == 1
