"""The port's dry-run rows against the reference's compiled modules on the
recurrent families: reduced jamba-v0.1-52b (mamba, attention, MoE) and
xlstm-125m (mLSTM, sLSTM), train, prefill and decode at batch 8 × 32
tokens, on meshes 2×4 and 1×8, at the bands of
``tests/test_torch_launch_vs_reference.py``, whose reference script and
helpers this file shares (a file of its own, so that ``--dist loadfile``
puts its reference compiles on another worker).

What the rules read off these modules (PERF.md §6):

* XLA computes a weight product whose weight and activation carry no
  ``model`` replicated over ``model`` unless it writes the residual
  stream (xlstm's q/k/v projections: split over the batch only), so the
  counter splits such a product's output features only at ``d_model``
  (``op_cost.OpCounter(residual=)``);
* in decode, the mLSTM's q and k take the decode state's layout (``dk``
  over ``model``, ``models/ssm.py``'s ``hint``);
* the mamba scan all-gathers and all-reduces ``[B, di]`` slices inside
  its time loop, once a step (``comm_cost.recurrence_steps``, rule 7).

``python tests/test_torch_launch_recurrent_vs_reference.py [ARCH...]``
prints each cell of these configs (of any, given) and what its compiled
module shows: the FLOPs by op name, the ``while`` loops and their trip
counts, and the collectives by kind, op name and whether a loop holds
them, trip counts multiplied through as ``hlo_cost`` multiplies them.
"""
import re
import sys
from collections import defaultdict
from pathlib import Path

import pytest

from test_torch_launch_vs_reference import (COLLECTIVE_BAND, FLOPS_BAND,
                                            KINDS, MESHES, _port,
                                            _reference, _report)

ARCHS = ("jamba-v0.1-52b", "xlstm-125m")
CELLS = [(a, m, k) for a in ARCHS for m in MESHES for k in KINDS]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _reference(ARCHS, tmp_path_factory.mktemp("ref"))


@pytest.mark.parametrize("arch,mesh_name,kind", CELLS)
def test_recurrent_flops_per_chip_match_reference(reference, arch,
                                                  mesh_name, kind):
    ref = reference[arch][f"{mesh_name}/{kind}"]
    port = _port(arch, mesh_name, kind)
    _report(arch, mesh_name, kind, ref, port)
    lo, hi = FLOPS_BAND
    assert lo <= port[0] / ref["flops"] <= hi


@pytest.mark.parametrize("arch,mesh_name,kind", CELLS)
def test_recurrent_collective_bytes_match_reference(reference, arch,
                                                    mesh_name, kind):
    ref = reference[arch][f"{mesh_name}/{kind}"]
    total, ref_total = _report(arch, mesh_name, kind, ref,
                               _port(arch, mesh_name, kind))
    lo, hi = COLLECTIVE_BAND
    assert lo <= total / ref_total <= hi


# the ops whose called computations ``hlo_cost`` counts
_CALLERS = ("fusion", "call", "conditional", "sort", "reduce",
            "reduce-window", "scatter", "map", "select-and-scatter",
            "custom-call")


def read_module(text: str):
    """(FLOPs by op name, loops as (trips, op name), collective bytes by
    (kind, in a loop, op name)) of a compiled module, each trip count
    multiplied through (the rules of ``repro.launch.hlo_cost``)."""
    from repro.launch import hlo_cost as H
    comps, entry = H.parse_hlo(text)
    flops, colls, loops = defaultdict(float), defaultdict(float), []

    def name(op):
        m = re.search(r'op_name="([^"]*)"', op.attrs)
        n = m.group(1).split("/", 1)[-1] if m else "?"
        return re.sub(r"closed_call/|checkpoint/|rematted_computation/",
                      "", n)

    def walk(comp_name, mult):
        for op in comps[comp_name].ops if comp_name in comps else ():
            oc = op.opcode
            if oc == "while":
                cond = H._called(op.attrs, "condition")
                trips = H._while_trip_count(comps, cond) if cond else 1
                loops.append((trips, name(op)))
                walk(H._called(op.attrs, "body"), mult * trips)
                continue
            if oc in _CALLERS:
                for key in ("calls", "to_apply", "called_computations",
                            "branch_computations"):
                    called = H._called(op.attrs, key)
                    if called:
                        walk(called, mult)
            f = (H._dot_flops(comps[comp_name], op) if oc == "dot" else
                 H.shape_elems_bytes(op.type_str)[0]
                 if oc in H._ELEMENTWISE_FLOP_OPS else 0.0)
            flops[name(op)] += f * mult
            base = oc.replace("-start", "")
            if base in H.COLLECTIVES and not oc.endswith("-done"):
                nbytes = H.shape_elems_bytes(op.type_str)[1]
                colls[(base, mult > 1, name(op))] += nbytes * mult

    walk(entry, 1)
    return dict(flops), loops, dict(colls)


def print_module(text: str, top: int = 8) -> None:
    flops, loops, colls = read_module(text)
    total = sum(flops.values())
    print(f"  module FLOPs {total:.4g}; largest by op:")
    for n, f in sorted(flops.items(), key=lambda x: -x[1])[:top]:
        print(f"    {f:11.4g} {f / total:6.3f}  {n}")
    for trips, n in loops:
        print(f"  loop x{trips}: {n}")
    print("  collective bytes by (kind, in a loop, op):")
    for (kind, looped, n), b in sorted(colls.items(), key=lambda x: -x[1]):
        print(f"    {b:11.0f}  {kind:18s} {'loop' if looped else 'top ':4s}"
              f"  {n}")


if __name__ == "__main__":
    import tempfile
    archs = sys.argv[1:] or list(ARCHS)
    with tempfile.TemporaryDirectory() as tmp:
        refs = _reference(archs, Path(tmp), hlo_dir=Path(tmp))
        for arch in archs:
            for mesh_name in MESHES:
                for kind in KINDS:
                    _report(arch, mesh_name, kind,
                            refs[arch][f"{mesh_name}/{kind}"],
                            _port(arch, mesh_name, kind))
                    print_module((Path(tmp) / f"{arch}_{mesh_name}_{kind}"
                                  ".txt").read_text())
