"""Dry-run of every (architecture × input shape × mesh) cell on meta
tensors, with an H100 roofline, in place of repro/launch/dryrun.py.

For each cell the real step runs on the meta device (shapes, no
storage) under ``op_cost.OpCounter``:

* ``train_4k``                   ``make_train_step`` with AdamW,
* ``prefill_32k``                ``make_prefill_step``,
* ``decode_32k`` / ``long_500k`` ``make_serve_step``,

each with ``num_groups`` from the mesh, as the reference passes it. The
plans of ``distributed.sharding`` are checked to be coherent on the mesh
(every sharded dimension divides its axes' product, no axis twice in a
spec), the port's analogue of the reference's lowering with production
shardings, and give the bytes a chip holds. The counts do not depend on
the mesh but through ``num_groups``, which only an MoE layer reads, so
``run_all`` counts once per (arch, shape) and MoE group count.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json

The times are projections from counts at data-sheet constants
(``roofline``), not readings of a card. Needs no card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Optional, Union

import torch

from repro_torch.configs import SHAPES_BY_NAME, get_config, list_archs, shapes_for
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import mesh_name, production_mesh
from repro_torch.launch.comm_cost import plan_collectives
from repro_torch.launch.op_cost import (OpCounts, count_ops, per_chip,
                                        step_seeds)
from repro_torch.launch.specs import (abstract_model, decode_specs,
                                      input_specs)
from repro_torch.models.model import params_of
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_loop import (make_prefill_step, make_serve_step,
                                          make_train_step)

Mesh = Dict[str, int]


def num_token_groups(mesh: Mesh, mode: Optional[str] = None) -> int:
    """The token groups an MoE layer dispatches in: the batch axes'
    product (every axis under ``fsdp``)."""
    if mode is None:
        mode = os.environ.get("REPRO_SHARDING_MODE")
    g = mesh.get("data", 1) * mesh.get("pod", 1)
    if mode == "fsdp":
        g *= mesh.get("model", 1)
    return g


def check_spec(name: str, shape, spec, mesh: Mesh) -> None:
    """Raise ``ValueError`` unless ``spec`` is a coherent layout of a leaf
    of ``shape`` on ``mesh``."""
    if len(spec) > len(shape):
        raise ValueError(f"{name}: spec {spec} longer than shape {shape}")
    used = []
    for dim, entry in zip(shape, spec):
        parts = shd._parts(entry)
        unknown = [p for p in parts if p not in mesh]
        if unknown:
            raise ValueError(f"{name}: spec {spec} names axes {unknown} "
                             f"not in the mesh {mesh}")
        used += parts
        if dim % math.prod(mesh[p] for p in parts):
            raise ValueError(f"{name}: dimension {dim} of {shape} does not "
                             f"divide over {entry} on {mesh}")
    if len(set(used)) < len(used):
        raise ValueError(f"{name}: spec {spec} uses a mesh axis twice")


def plan_state_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                     model=None) -> int:
    """Bytes one chip holds under the plans: params (float32 masters),
    plus AdamW's two moments and the gradients for train, the decode
    state for decode; the batch in every kind. Each spec is checked on
    the way (``check_spec``)."""
    model = model if model is not None else abstract_model(cfg)
    params = {}
    for _, path, pshape, dtype in shd.param_leaves(model):
        params.setdefault(path, (pshape, dtype))
    prefixes = ["", "mu/", "nu/", "grad/"] if shape.kind == "train" else [""]
    leaves = [(pre + path, s, dt if pre == "" else torch.float32,
               shd.param_pspec(pre + path, s, mesh))
              for pre in prefixes for path, (s, dt) in params.items()]
    B = shape.global_batch
    if shape.kind == "decode":
        leaves.append(("tokens", (B, 1), torch.int32,
                       shd.batch_pspec(mesh, B)))
        specs = shd.state_pspecs(cfg, mesh, B, shape.seq_len)
        state = {}      # a stacked leaf once, not once per period
        for name, path, s, dt in shd.state_leaves(cfg, B, shape.seq_len):
            state.setdefault(path, (path, s, dt, specs[name]))
        leaves += list(state.values())
    else:
        batch = input_specs(cfg, shape)
        specs = shd.batch_pspecs(cfg, mesh, batch)
        leaves += [(k, tuple(v.shape), v.dtype, specs[k])
                   for k, v in batch.items()]
    total = 0
    for name, s, dt, spec in leaves:
        check_spec(name, s, spec, mesh)
        total += shd.shard_bytes(s, dt, spec, mesh)
    return total


def count_step(cfg: ModelConfig, shape: ShapeConfig, groups: int,
               model=None) -> OpCounts:
    """Counts of one step of ``shape.kind`` on meta tensors (AdamW at its
    defaults for train)."""
    model = model if model is not None else abstract_model(cfg)
    params = params_of(model)
    if shape.kind == "train":
        opt_cfg = AdamWConfig()
        opt = init_opt_state(params, opt_cfg)
        batch = input_specs(cfg, shape)
        step = make_train_step(model, opt_cfg, num_groups=groups)
        return count_ops(step, params, opt, batch, seeds=step_seeds(
            model, params, opt, batch), residual=cfg.d_model)
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape)
        step = make_prefill_step(model, num_groups=groups)
        return count_ops(step, params, batch,
                         seeds=step_seeds(model, params, batch=batch),
                         residual=cfg.d_model)
    tokens, state = decode_specs(cfg, shape, model)
    step = make_serve_step(model, num_groups=groups)
    return count_ops(step, params, tokens, state, seeds=step_seeds(
        model, params, tokens=tokens, state=state, max_seq=shape.seq_len),
        residual=cfg.d_model)


def _shape(shape: Union[str, ShapeConfig]) -> ShapeConfig:
    return SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape


def counts_key(cfg: ModelConfig, shape: ShapeConfig, groups: int):
    """What a cell's counts depend on: the group count only with MoE."""
    return (cfg, shape, groups if cfg.moe is not None else 1)


def lower_cell(arch: str, shape: Union[str, ShapeConfig], *,
               multi_pod: bool = False, mesh: Optional[Mesh] = None,
               cfg: Optional[ModelConfig] = None,
               cache: Optional[dict] = None) -> dict:
    """One cell's row (``RooflineReport.row``, ``status`` "ok"): the
    plans checked on ``mesh`` (the production mesh by default), the step
    counted on meta. ``cfg`` defaults to ``get_config(arch)``; ``shape``
    is a name or a ``ShapeConfig``; ``cache`` (a dict) keeps the counts
    by ``counts_key`` for the next cell that shares them."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = _shape(shape)
    mesh = mesh if mesh is not None else production_mesh(multi_pod)
    chips = math.prod(mesh.values())
    groups = num_token_groups(mesh)
    model = abstract_model(cfg)
    state_bytes = plan_state_bytes(cfg, shape, mesh, model)
    t0 = time.perf_counter()
    cache = {} if cache is None else cache
    key = counts_key(cfg, shape, groups)
    if key not in cache:
        cache[key] = count_step(cfg, shape, groups, model)
    counts = cache[key]
    flops, nbytes, _ = per_chip(counts, mesh)
    comm = plan_collectives(cfg, shape, mesh, counts, groups=groups,
                            model=model)
    by_axes, secs = rl.collective_terms(comm, mesh)
    report = rl.RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name(mesh), chips=chips,
        flops=counts.flops, bytes=counts.bytes,
        transcendentals=counts.transcendentals,
        state_bytes_per_chip=state_bytes,
        model_flops=rl.model_flops_for(cfg, shape),
        flops_per_chip=flops, bytes_per_chip=nbytes,
        collective_breakdown=comm.by_kind, collective_by_axes=by_axes,
        collective_s_by_axes=secs)
    row = report.row()
    row.update(status="ok", groups=groups, ops=counts.ops,
               count_s=time.perf_counter() - t0)
    return row


def run_all(archs=None, meshes=None, out_path=None):
    """Every cell of ``archs`` (all) on ``meshes`` (16×16 and 2×16×16);
    a cell that raises is a row with ``status`` ``FAIL: ...``."""
    meshes = meshes or [production_mesh(False), production_mesh(True)]
    rows, cache = [], {}
    for arch in (archs or list_archs()):
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            for mesh in meshes:
                t0 = time.time()
                try:
                    row = lower_cell(arch, shape, mesh=mesh, cache=cache)
                    row["wall_s"] = time.time() - t0
                    print(f"[OK] {arch:22s} {shape.name:12s} "
                          f"mesh={mesh_name(mesh):8s} "
                          f"wall={row['wall_s']:7.1f}s "
                          f"bottleneck={row['bottleneck']:10s} "
                          f"mem={row['state_gib']:.2f}GiB", flush=True)
                except Exception as e:  # a failed cell is a row
                    traceback.print_exc()
                    row = {"arch": arch, "shape": shape.name,
                           "mesh": mesh_name(mesh),
                           "status": f"FAIL: {type(e).__name__}: {e}"}
                    print(f"[FAIL] {arch} {shape.name} {mesh_name(mesh)}: "
                          f"{e}", flush=True)
                rows.append(row)
                if out_path:
                    with open(out_path, "w") as f:
                        json.dump(rows, f, indent=1, default=str)
    n_ok = sum(r.get("status") == "ok" for r in rows)
    print(f"\n{n_ok}/{len(rows)} cells counted OK")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        rows = run_all(archs=[args.arch] if args.arch else None,
                       out_path=args.out)
        return 0 if all(r.get("status") == "ok" for r in rows) else 1

    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    row = lower_cell(args.arch, args.shape, multi_pod=args.multi_pod)
    print(json.dumps(row, indent=2, default=str))
    if args.out:
        with open(args.out, "w") as f:
            json.dump([row], f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
