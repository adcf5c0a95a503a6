"""The port's dry-run rows against the reference's compiled modules, on
small host meshes.

The reference's own step builders, plans and ``hlo_cost.analyze_hlo_text``
run in subprocesses with 8 forced host devices (the test process keeps
one, ``tests/conftest.py``), as its ``launch/dryrun.py:55-110`` lowers a
cell: reduced olmo-1b, deepseek-v2-236b and qwen2-0.5b, train, prefill
and decode, at batch 8 × 32 tokens, on meshes 2×4 and 1×8. Their axes
are ``Auto``: under jax 0.9.0 ``jax.make_mesh`` makes ``Explicit`` axes,
on which the reference's ``hint`` raises (ROADMAP queue 3 item 13). The
port counts the same cells with ``launch.dryrun.count_step``,
``op_cost.per_chip`` and ``comm_cost.plan_collectives``.

The collective rules were read off olmo-1b's and deepseek-v2-236b's
compiled modules; qwen2-0.5b (GQA, 2 kv heads for 4, and qkv biases)
is held to the same bands as a config they were not read off.

* A chip's FLOPs: port / reference within [0.8, 1.25] on every cell (on
  1×8, where 4 heads do not divide 8, an even split of the global count
  read 0.26–0.61 of the reference).
* A chip's total collective bytes: port / reference within [0.5, 2] on
  every cell. XLA on the CPU chooses its own kinds (no reduce-scatter at
  all), so the kinds are printed, not held.
* A chip's bytes are printed, not held.

``python tests/test_torch_launch_vs_reference.py ARCH...`` prints the
same cells of any config. The SSM and hybrid families (jamba-v0.1-52b,
xlstm-125m) are held at the same bands in
``tests/test_torch_launch_recurrent_vs_reference.py``, which shares this
file's helpers.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import comm_cost, dryrun, op_cost

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("olmo-1b", "deepseek-v2-236b", "qwen2-0.5b")
MESHES = {"2x4": {"data": 2, "model": 4}, "1x8": {"data": 1, "model": 8}}
KINDS = ("train", "prefill", "decode")
BATCH, SEQ = 8, 32
FLOPS_BAND = (0.8, 1.25)
COLLECTIVE_BAND = (0.5, 2.0)

SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import NamedSharding
from repro.configs import get_config, reduced
from repro.configs.base import ShapeConfig
from repro.distributed import sharding as shd
from repro.launch import hlo_cost
from repro.launch.specs import (abstract_opt_state, abstract_params,
                                decode_specs, input_specs)
from repro.train.optimizer import AdamWConfig
from repro.train.train_loop import (make_prefill_step, make_serve_step,
                                    make_train_step)

arch, path = sys.argv[1], sys.argv[2]
hlo_dir = sys.argv[3] if len(sys.argv) > 3 else None
meshes, kinds, B, S = %r, %r, %d, %d
out = {}
cfg = reduced(get_config(arch))
params = abstract_params(cfg)
for name, sizes in meshes.items():
    mesh = jax.make_mesh(tuple(sizes.values()), tuple(sizes),
                         axis_types=(jax.sharding.AxisType.Auto,)
                         * len(sizes))
    groups = sizes["data"]
    pshard = shd.tree_shardings(params, mesh)
    for kind in kinds:
        shape = ShapeConfig(kind, S, B, kind)
        with mesh:
            if kind == "train":
                opt_cfg = AdamWConfig()
                opt = abstract_opt_state(cfg, opt_cfg)
                oshard = shd.tree_shardings(opt, mesh)
                batch = input_specs(cfg, shape)
                lowered = jax.jit(
                    make_train_step(cfg, opt_cfg, num_groups=groups),
                    in_shardings=(pshard, oshard,
                                  shd.batch_shardings(cfg, mesh, batch)),
                    out_shardings=(pshard, oshard, None),
                    donate_argnums=(0, 1)).lower(params, opt, batch)
            elif kind == "prefill":
                batch = input_specs(cfg, shape)
                lowered = jax.jit(
                    make_prefill_step(cfg, num_groups=groups),
                    in_shardings=(pshard, shd.batch_shardings(cfg, mesh,
                                                              batch)),
                ).lower(params, batch)
            else:
                tokens, state = decode_specs(cfg, shape)
                sshard = shd.state_shardings(mesh, state, B)
                lowered = jax.jit(
                    make_serve_step(cfg, num_groups=groups),
                    in_shardings=(pshard, NamedSharding(
                        mesh, shd.batch_pspec(mesh, B)), sshard),
                    out_shardings=(None, sshard),
                    donate_argnums=(2,)).lower(params, tokens, state)
            text = lowered.compile().as_text()
            totals = hlo_cost.analyze_hlo_text(text)
        if hlo_dir:
            with open(os.path.join(hlo_dir, f"{arch}_{name}_{kind}.txt"),
                      "w") as f:
                f.write(text)
        out[f"{name}/{kind}"] = dict(
            flops=totals.flops, bytes=totals.bytes,
            collectives={k: float(v) for k, v in totals.collectives.items()})
with open(path, "w") as f:
    json.dump(out, f)
"""


def _reference(archs, tmp: Path, hlo_dir: Path = None) -> dict:
    """The reference's per-chip counts of every cell, by arch, from one
    subprocess an arch (run side by side); with ``hlo_dir``, each cell's
    compiled module too, as ``{arch}_{mesh}_{kind}.txt``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    code = SCRIPT % (MESHES, KINDS, BATCH, SEQ)
    procs = {arch: subprocess.Popen(
        [sys.executable, "-c", code, arch, str(tmp / f"{arch}.json")]
        + ([str(hlo_dir)] if hlo_dir else []),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch in archs}
    out = {}
    for arch, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        out[arch] = json.loads((tmp / f"{arch}.json").read_text())
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _reference(ARCHS, tmp_path_factory.mktemp("ref"))


_COUNTS = {}


def _port(arch: str, mesh_name: str, kind: str):
    """(FLOPs, bytes, collective bytes by kind) on one chip, by the
    port."""
    mesh = MESHES[mesh_name]
    cfg = reduced(get_config(arch))
    shape = ShapeConfig(kind, SEQ, BATCH, kind)
    groups = dryrun.num_token_groups(mesh)
    key = dryrun.counts_key(cfg, shape, groups)
    if key not in _COUNTS:
        _COUNTS[key] = dryrun.count_step(cfg, shape, groups)
    counts = _COUNTS[key]
    flops, nbytes, _ = op_cost.per_chip(counts, mesh)
    comm = comm_cost.plan_collectives(cfg, shape, mesh, counts,
                                      groups=groups)
    return flops, nbytes, comm.by_kind


def _report(arch, mesh_name, kind, ref, port):
    flops, nbytes, kinds = port
    total = sum(kinds.values())
    ref_total = sum(ref["collectives"].values())
    print(f"{arch} {kind} {mesh_name}: FLOPs/chip port {flops:.4g} "
          f"ref {ref['flops']:.4g} ({flops / ref['flops']:.3f}); "
          f"bytes/chip port {nbytes:.4g} ref {ref['bytes']:.4g} "
          f"({nbytes / ref['bytes']:.3f}); "
          f"collective bytes/chip port {total:.0f} ref {ref_total:.0f} "
          f"({total / ref_total:.3f})")
    for k in comm_cost.KINDS:
        print(f"  {k}: port {kinds.get(k, 0):.0f} "
              f"ref {ref['collectives'].get(k, 0):.0f}")
    return total, ref_total


HELD = [(a, m, k) for a in ARCHS for m in MESHES for k in KINDS]


@pytest.mark.parametrize("arch,mesh_name,kind", HELD)
def test_flops_per_chip_match_reference(reference, arch, mesh_name, kind):
    ref = reference[arch][f"{mesh_name}/{kind}"]
    port = _port(arch, mesh_name, kind)
    _report(arch, mesh_name, kind, ref, port)
    lo, hi = FLOPS_BAND
    assert lo <= port[0] / ref["flops"] <= hi


@pytest.mark.parametrize("arch,mesh_name,kind", HELD)
def test_collective_bytes_match_reference(reference, arch, mesh_name,
                                          kind):
    ref = reference[arch][f"{mesh_name}/{kind}"]
    total, ref_total = _report(arch, mesh_name, kind, ref,
                               _port(arch, mesh_name, kind))
    lo, hi = COLLECTIVE_BAND
    assert lo <= total / ref_total <= hi


if __name__ == "__main__":
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        refs = _reference(sys.argv[1:], Path(tmp))
    for arch in sys.argv[1:]:
        for mesh_name in MESHES:
            for kind in KINDS:
                _report(arch, mesh_name, kind,
                        refs[arch][f"{mesh_name}/{kind}"],
                        _port(arch, mesh_name, kind))
