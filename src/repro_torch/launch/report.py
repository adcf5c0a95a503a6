"""Render the dry-run table from dry-run rows (JSON), PyTorch port of
repro/launch/report.py; ``mem/chip`` reads ``state_gib``.

    python -m repro_torch.launch.report dryrun.json         # per mesh
    python -m repro_torch.launch.report dryrun.json --by-arch  # one line an arch
"""
from __future__ import annotations

import json
import sys


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def render(rows, mesh_filter=None):
    out = []
    out.append("| arch | shape | mesh | t_compute | t_memory | t_collective"
               " | bottleneck | 6ND/HLO | roofline-frac | mem/chip |")
    out.append("|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"FAILED: {r['status']} |||||||")
            continue
        if mesh_filter and r["mesh"] != mesh_filter:
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {fmt_s(r['t_compute_s'])} | {fmt_s(r['t_memory_s'])} "
            f"| {fmt_s(r['t_collective_s'])} | {r['bottleneck']} "
            f"| {r['useful_ratio']:.3f} | {r['roofline_fraction']:.2e} "
            f"| {r['state_gib']:.1f}GiB |")
    return "\n".join(out)


def render_by_arch(rows, meshes=("16x16", "2x16x16")):
    """One line per arch, one column per (mesh, shape): ``t_compute /
    t_memory / t_collective, mem/chip``, or the failure."""
    shapes, cells = [], {}
    for r in rows:
        if r["shape"] not in shapes:
            shapes.append(r["shape"])
        cells.setdefault(r["arch"], {})[(r["mesh"], r["shape"])] = r
    cols = [(m, sh) for m in meshes for sh in shapes]
    out = ["| arch | " + " | ".join(f"{m} {sh}" for m, sh in cols) + " |",
           "|---|" + "---|" * len(cols)]
    for arch, by_cell in cells.items():
        parts = []
        for col in cols:
            r = by_cell.get(col)
            if r is None:
                parts.append("")
            elif r.get("status") != "ok":
                parts.append(r["status"])
            else:
                parts.append(f"{fmt_s(r['t_compute_s'])} / "
                             f"{fmt_s(r['t_memory_s'])} / "
                             f"{fmt_s(r['t_collective_s'])}, "
                             f"{r['state_gib']:.1f}GiB")
        out.append(f"| {arch} | " + " | ".join(parts) + " |")
    return "\n".join(out)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_results.json"
    with open(path) as f:
        rows = json.load(f)
    if "--by-arch" in sys.argv[2:]:
        print(render_by_arch(rows))
        return
    print("## Single-pod (16x16 = 256 chips)\n")
    print(render(rows, "16x16"))
    print("\n## Multi-pod (2x16x16 = 512 chips)\n")
    print(render(rows, "2x16x16"))


if __name__ == "__main__":
    main()
