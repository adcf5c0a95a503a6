#!/usr/bin/env python3
"""Where the time of the ``weight_prefix`` kernel goes, on one H100.

Run from the root of a checkout on a machine with a card:

    python3 tools/weight_prefix_variants.py

It times ``weight_prefix`` at E = 2^26 (random weights, seed 0) beside
``torch.cumsum`` of the same weights, for the kernel as committed and for
copies of ``src`` with one edit each, built under
``src/repro_torch/_build/variants/``:

* ``no_lookback``: every tile's exclusive prefix is 0 (the chain across
  tiles is skipped; the output is wrong): the cost of the local scan and
  the memory traffic alone;
* ``passes_1`` / ``passes_4``: tiles of 4096 / 16384 edges instead of
  8192.

Each variant runs in its own process and prints one JSON line: device ms
per call (profiler), ms per call by CUDA events, ``torch.cumsum``'s ms,
and whether three calls agree bitwise and the output is non-decreasing.
The last line is the card's name and power limit. With no CUDA device it
exits 2.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNEL = Path("repro_torch/csrc/weight_prefix.cu")
WRAPPER = Path("repro_torch/kernels/weight_prefix.py")
LOOKBACK = "excl = look_back(status, incl_out, tile, epoch, s_look);"
VARIANTS = {
    "committed": [],
    "no_lookback": [(KERNEL, LOOKBACK, "excl = 0.0;")],
    "passes_1": [(KERNEL, "kPasses = 2;", "kPasses = 1;"),
                 (WRAPPER, "_TILE = 8192 ", "_TILE = 4096 ")],
    "passes_4": [(KERNEL, "kPasses = 2;", "kPasses = 4;"),
                 (WRAPPER, "_TILE = 8192 ", "_TILE = 16384 ")],
}


def measure(tag: str) -> None:
    """Time weight_prefix from the package on sys.path (in a subprocess)."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms, device_ms
    from repro_torch.kernels.weight_prefix import weight_prefix
    E = 1 << 26
    rng = np.random.default_rng(0)
    dt = torch.as_tensor(-rng.exponential(3.0, E).astype(np.float32),
                         device="cuda")
    valid = torch.as_tensor(rng.uniform(size=E) < 0.75, device="cuda")
    runs = [weight_prefix(dt, valid) for _ in range(3)]
    w = torch.where(valid, torch.exp(dt), 0.0)
    call = lambda: weight_prefix(dt, valid)   # noqa: E731
    print(json.dumps(dict(
        variant=tag, edges=E,
        ms=device_ms(call, ("weight_prefix_lookback",)),
        issue_ms=cuda_ms(call, reps=20),
        cumsum_ms=cuda_ms(lambda: torch.cumsum(w, 0), reps=20),
        bitwise_equal_calls=all(torch.equal(r, runs[0]) for r in runs[1:]),
        monotone=bool((runs[0][1:] >= runs[0][:-1]).all()))), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        measure(sys.argv[2])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    out = ROOT / "src/repro_torch/_build/variants"
    rc = 0
    for tag, edits in VARIANTS.items():
        src = ROOT / "src"
        if edits:
            src = out / tag
            shutil.rmtree(src, ignore_errors=True)
            shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                            ignore=shutil.ignore_patterns("_build"))
            for rel, old, new in edits:
                text = (src / rel).read_text()
                if text.count(old) != 1:
                    raise RuntimeError(f"{tag}: {old!r} not found once")
                (src / rel).write_text(text.replace(old, new))
        env = dict(os.environ, PYTHONPATH=str(src))
        rc |= subprocess.run([sys.executable, __file__, "--measure", tag],
                             env=env).returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
