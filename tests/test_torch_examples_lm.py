"""The port's training and LM entry points (``tools/examples/
train_embeddings.py``, ``serve_lm.py``, ``train_lm_on_walks.py``) held
against the reference's scripts of the same names (``examples/``) in one
process, on the CPU.

Each reference script runs as written (its ``main``, its arguments in
``sys.argv``), what it computes recorded by wrapping the names it looked
up in its own module (``train_on_walks``, ``link_prediction_auc``, its
``np``'s ``stack``, its ``jax``'s ``jit``); the port's runs with
``--device cpu``. The LM scripts start from the reference's own
``init_params`` output, carried across by ``interop.lm_params_from_ref``
in place of the port's ``init_params`` (equal to it only within the
``erfinv`` gap).

* ``train_embeddings`` at 256 nodes, 8,000 edges in 10 batches, dim 16
  (``main``'s keywords in both): every loss within rtol 1e-5, every AUC
  within 1e-3 (``tests/test_torch_train.py``'s tolerances).
* ``serve_lm``, reduced qwen2-0.5b, float32: the greedy ids equal
  (``tests/test_torch_models.py``: float32 logits within 1e-5 and greedy
  tokens equal), and the printed lines but the throughput.
* ``train_lm_on_walks --steps 2``: both losses within rtol 1e-5
  (``tests/test_torch_train_loop.py``); a checkpoint that the
  reference's ``train.checkpoint.save`` wrote in the script's three
  directories is restored by the port's script, which prints ``restored
  checkpoint at step 2`` and continues with the reference's loss.
"""
import importlib.util
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.models import model as RM
from repro_torch import interop
from repro_torch.models import model as TM

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
AUC_TOL = 1e-3


def load(path: str, name: str):
    """The script at ``path`` (from the repository root) as a module."""
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Proxy:
    """A module whose attribute ``name`` is wrapped by ``wrap``."""

    def __init__(self, module, name, wrap):
        self._module, self._name, self._wrap = module, name, wrap

    def __getattr__(self, attr):
        got = getattr(self._module, attr)
        return self._wrap(got) if attr == self._name else got


def carry_params(monkeypatch):
    """Record the reference's ``init_params`` outputs and make the port's
    ``init_params`` carry the last of them across."""
    made = []
    init = RM.init_params
    monkeypatch.setattr(RM, "init_params",
                        lambda *a, **k: made.append(init(*a, **k))
                        or made[-1])
    monkeypatch.setattr(TM, "init_params",
                        lambda cfg, key, device=None, dtype=None:
                        interop.lm_params_from_ref(made[-1], cfg, device))
    return made


def record_jit(monkeypatch, ref, metrics):
    """Record the metrics of every call of a function the script jits."""
    def jit(fn, **kw):
        compiled = jax.jit(fn, **kw)

        def call(*args):
            out = compiled(*args)
            metrics.append(out[2])
            return out
        return call
    monkeypatch.setattr(ref, "jax", _Proxy(jax, "jit", lambda _: jit))


def test_train_embeddings_matches_reference(monkeypatch):
    sizes = dict(num_nodes=256, num_edges=8000, batches=10, dim=16)
    ref = load("examples/train_embeddings.py", "ref_train_embeddings")
    losses, aucs = [], []
    train, auc = ref.train_on_walks, ref.link_prediction_auc

    def train_rec(*a, **k):
        state, loss = train(*a, **k)
        losses.append(loss)
        return state, loss
    monkeypatch.setattr(ref, "train_on_walks", train_rec)
    monkeypatch.setattr(ref, "link_prediction_auc",
                        lambda *a: aucs.append(auc(*a)) or aucs[-1])
    ref.main(**sizes)
    port = load("tools/examples/train_embeddings.py",
                "port_train_embeddings")
    got = port.main(["--device", "cpu"], **sizes)
    assert len(got["losses"]) == len(losses) == 8
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL)
    np.testing.assert_allclose(got["aucs"] + [got["final_auc"]], aucs,
                               rtol=0, atol=AUC_TOL)
    assert got["final_auc"] > 0.5


def test_serve_lm_matches_reference(capsys, monkeypatch):
    carry_params(monkeypatch)
    ref = load("examples/serve_lm.py", "ref_serve_lm")
    stacked = []
    monkeypatch.setattr(ref, "np", _Proxy(
        np, "stack", lambda f: lambda *a, **k: stacked.append(f(*a, **k))
        or stacked[-1]))
    monkeypatch.setattr(sys, "argv", ["serve_lm.py"])
    ref.main()
    want = capsys.readouterr().out.splitlines()
    port = load("tools/examples/serve_lm.py", "port_serve_lm")
    ids = port.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert ids.shape == stacked[0].shape == (4, 32)
    assert np.array_equal(ids, stacked[0])
    assert [got[0], got[2]] == [want[0], want[2]]


def test_train_lm_on_walks_matches_reference(tmp_path, capsys, monkeypatch):
    carry_params(monkeypatch)
    ref = load("examples/train_lm_on_walks.py", "ref_train_lm_on_walks")
    metrics = []
    record_jit(monkeypatch, ref, metrics)
    monkeypatch.setattr(sys, "argv", ["train_lm_on_walks.py", "--steps",
                                      "2", "--ckpt-dir",
                                      str(tmp_path / "ref")])
    ref.main()
    want = capsys.readouterr().out.splitlines()
    port = load("tools/examples/train_lm_on_walks.py",
                "port_train_lm_on_walks")
    losses = port.main(["--device", "cpu", "--steps", "2", "--ckpt-dir",
                        str(tmp_path / "port")])
    got = capsys.readouterr().out.splitlines()
    assert len(losses) == len(metrics) == 2
    np.testing.assert_allclose(losses, [float(m["loss"]) for m in metrics],
                               rtol=RTOL)
    assert [line.split(" lr=")[0] for line in got] \
        == [line.split(" lr=")[0] for line in want]


def test_train_lm_on_walks_restores_reference_checkpoint(tmp_path, capsys,
                                                         monkeypatch):
    """The reference's checkpoint in the script's layout (``params``,
    ``opt`` and the top directory's manifest) at step 2: the port's
    script restores it and takes step 2 as the reference's script does
    from it."""
    from repro.configs import get_config, reduced
    from repro.train import checkpoint as rckpt
    from repro.train.optimizer import AdamWConfig, init_opt_state
    cfg = reduced(get_config("olmo-1b"), layers=4, d_model=128, vocab=1024)
    params = RM.init_params(cfg, jax.random.PRNGKey(5))
    opt = init_opt_state(params, AdamWConfig(lr=3e-4, warmup_steps=20,
                                             total_steps=3))
    for run in ("ref", "port"):
        d = str(tmp_path / run)
        rckpt.save(os.path.join(d, "params"), params, 2)
        rckpt.save(os.path.join(d, "opt"), opt, 2)
        rckpt.save(d, {"placeholder": np.zeros(1)}, 2)
    ref = load("examples/train_lm_on_walks.py", "ref_train_lm_restore")
    metrics = []
    record_jit(monkeypatch, ref, metrics)
    monkeypatch.setattr(sys, "argv", ["train_lm_on_walks.py", "--steps",
                                      "3", "--ckpt-dir",
                                      str(tmp_path / "ref")])
    ref.main()
    want = capsys.readouterr().out.splitlines()
    port = load("tools/examples/train_lm_on_walks.py", "port_train_lm_restore")
    losses = port.main(["--device", "cpu", "--steps", "3", "--ckpt-dir",
                        str(tmp_path / "port")])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] == "restored checkpoint at step 2"
    assert len(losses) == len(metrics) == 1
    np.testing.assert_allclose(losses[0], float(metrics[0]["loss"]),
                               rtol=RTOL)


@pytest.mark.parametrize("script", ["train_embeddings", "serve_lm",
                                    "train_lm_on_walks"])
def test_lm_entry_point_needs_a_card_or_cpu(script, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = load(f"tools/examples/{script}.py", f"port_{script}_nocard")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
