"""Checks of ``chip_smoke.py`` that run on the CPU.

``_zero_leaf_limit`` bounds the card-vs-CPU gap of the first AdamW step of
a leaf that is 0 before it, given gradients within the gradient check's
tolerance and a grad norm within its own: the port's ``apply_updates``
on gradients perturbed anywhere inside those tolerances stays within the
limit, and an update that is wrong (another ε, another lr, a flipped
element) does not.

``dryrun_against_card`` (phase ``lm_pipeline_full``) sets the dry-run's
projection of a train step beside the card's reading: the measured time
over the largest of its three projected terms, the counted FLOPs over
6·N·tokens, on a row that ``launch.dryrun.lower_cell`` returns; on the
one-chip mesh that row moves no collective bytes.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.train.optimizer import (AdamWConfig, apply_updates,
                                         init_opt_state, lr_at)

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _smoke()
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)


def _leaf(G, seed):
    """A zero leaf's gradient [4096] spanning many decades under its
    largest magnitude ``G``, and another leaf's that sets the clip."""
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn(4096, generator=gen) * torch.exp(
        3 * torch.randn(4096, generator=gen))
    return g / g.abs().max() * G, gen


def _first_step(g, other, eps=OPT.eps, lr_scale=1.0):
    cfg = AdamWConfig(lr=OPT.lr * lr_scale, warmup_steps=1, total_steps=10,
                      eps=eps)
    p = {"z": torch.zeros_like(g), "o": torch.zeros_like(other)}
    new, _, metrics = apply_updates(p, {"z": g, "o": other},
                                    init_opt_state(p, cfg), cfg)
    return new["z"], float(metrics["grad_norm"])


def _of_limit(g, got):
    """The largest gap of ``got`` against the CPU's step from ``g``, over
    the resolved elements, in units of their limits."""
    other = torch.linspace(-1.0, 1.0, 100)
    want, gnorm = _first_step(g, other)
    lr = float(lr_at(OPT, 1))
    clip = min(OPT.clip_norm / max(gnorm, 1e-12), 1.0)
    res = g.abs() > CS.LM_EQ_UNRESOLVED * g.abs().max()
    lim = CS._zero_leaf_limit(g, clip, OPT.eps)
    return float(((got - want).abs() / lr / lim)[res].max())


@pytest.mark.parametrize("G", [1e-7, 1e-5, 1e-3, 1e-1, 10.0])
def test_gradients_within_tolerance_stay_within_the_limit(G):
    other = torch.linspace(-1.0, 1.0, 100)
    worst = 0.0
    for seed in range(8):
        g, gen = _leaf(G, seed)
        gc = g + CS.LM_EQ_LEAF_TOL * G * (
            2 * torch.rand(4096, generator=gen) - 1)
        got, _ = _first_step(gc, other * (1 + CS.LM_EQ_LOSS_RTOL / 2))
        worst = max(worst, _of_limit(g, got))
    assert worst <= 1.0, worst


@pytest.mark.parametrize("wrong", ["eps", "lr", "sign"])
def test_a_wrong_update_exceeds_the_limit(wrong):
    g, _ = _leaf(1e-2, 0)
    other = torch.linspace(-1.0, 1.0, 100)
    if wrong == "eps":
        got, _ = _first_step(g, other, eps=10 * OPT.eps)
    elif wrong == "lr":
        got, _ = _first_step(g, other, lr_scale=1 + 1e-4)
    else:
        got, _ = _first_step(g, other)
        i = int(g.abs().argmax())
        got[i] = -got[i]
    assert _of_limit(g, got) > 1.0


@pytest.mark.parametrize("t_compute,t_memory,t_collective",
                         [(0.5, 0.2, 0.0), (0.1, 0.4, 0.0), (0.1, 0.4, 0.8)])
def test_dryrun_against_card(t_compute, t_memory, t_collective):
    terms = dict(compute=t_compute, memory=t_memory, collective=t_collective)
    row = dict(t_compute_s=t_compute, t_memory_s=t_memory,
               t_collective_s=t_collective,
               bottleneck=max(terms, key=terms.get),
               counted_flops_total=3e14, counted_bytes_total=1e12,
               flops_per_chip=3e14 / 4, bytes_per_chip=1e12 / 4)
    r = CS.dryrun_against_card(row, 1250.0, 2e14)
    assert r["measured_over_projected"] == pytest.approx(
        1.25 / max(t_compute, t_memory, t_collective))
    assert r["counted_over_6nd"] == pytest.approx(1.5)
    assert (r["steady_ms"], r["flops_6nd"]) == (1250.0, 2e14)
    assert (r["t_collective_s"], r["flops_per_chip"], r["bytes_per_chip"]) \
        == (t_collective, 7.5e13, 2.5e11)


def test_dryrun_against_card_reads_a_lower_cell_row():
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import dev_mesh
    cfg = reduced(get_config("olmo-1b"))
    row = dryrun.lower_cell(cfg.name, ShapeConfig("lm_train_full", 32, 2,
                                                  "train"),
                            mesh=dev_mesh(), cfg=cfg)
    r = CS.dryrun_against_card(row, 10.0, row["model_flops"])
    assert r["counted_over_6nd"] == pytest.approx(1 / row["useful_ratio"])
    assert r["measured_over_projected"] > 0
    # phase 15's requirement on the one-chip mesh
    assert r["t_collective_s"] == 0 and not any(row["collectives"].values())
    assert r["flops_per_chip"] == pytest.approx(row["counted_flops_total"],
                                                rel=1e-12)
    assert r["bytes_per_chip"] == pytest.approx(row["counted_bytes_total"],
                                                rel=1e-12)
