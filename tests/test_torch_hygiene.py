"""Hygiene of the PyTorch port.

* No file of ``src/repro_torch``, ``tools/`` (the examples included) nor
  ``chip_smoke.py`` imports ``jax`` or the reference package ``repro``
  (AST scan, and an import of every module with both blocked).
* Importing the package builds nothing and needs neither ``nvcc`` nor a
  card; without a card, an entry point called without ``device="cpu"``
  raises instead of running on the CPU.
* Kernel wrappers given CPU tensors take the plain version and count no
  launch.
* ``chip_smoke.py`` exits non-zero and prints no result without a CUDA
  device, and when it stands alone in a directory.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch import random as prng
from repro_torch.configs.base import (EngineConfig, SchedulerConfig,
                                      WalkConfig)
from repro_torch.core import edge_store as es
from repro_torch.core.streaming import StreamingEngine
from repro_torch.core.temporal_index import build_index
from repro_torch.core.walk_engine import alloc_walk_buffers
from repro_torch.core.window import init_window
from repro_torch.kernels import fused_step as kf
from repro_torch.kernels import runtime
from repro_torch.kernels.weight_prefix import weight_prefix
from repro_torch.serve import (ShardedSnapshotManager, WalkQuery,
                               WalkService, pack_queries)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PKG.rglob("*.py")) + sorted((ROOT / "tools").rglob(
        "*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_every_module_imports_with_reference_blocked():
    modules = sorted(
        ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
        for p in PKG.rglob("*.py"))
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro', 'triton'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.replace('.__init__', ''))\n"
        "from repro_torch.kernels import runtime\n"
        "assert runtime._LIB is None\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: runtime.resolve_device(None),
        lambda: prng.uniform(prng.PRNGKey(0), (4,)),
        lambda: es.make_batch([1], [2], [3]),
        lambda: es.stack_batches([([1], [2], [3])], 4),
        lambda: es.empty_store(16, 4),
        lambda: es.store_from_arrays([1], [2], [3], 16, 4),
        lambda: init_window(16, 4, 10),
        lambda: StreamingEngine(EngineConfig(), 16),
        lambda: interop.store_from_ref(dict(
            src=[0], dst=[0], ts=[0], num_edges=1)),
        lambda: WalkService(EngineConfig()),
        # sharded serving: its shards default to the visible cards
        lambda: WalkService(EngineConfig(), num_shards=2),
        lambda: ShardedSnapshotManager(EngineConfig(), num_shards=1),
        # the lane batch generate_walk_lanes takes, and its buffers
        lambda: pack_queries([WalkQuery(start_nodes=(1,))], 8, 16),
        lambda: alloc_walk_buffers(WalkConfig()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # an explicit CPU device is honoured
    assert es.empty_store(16, 4, device="cpu").src.device.type == "cpu"


def test_wrappers_take_plain_version_on_cpu():
    before = dict(runtime.LAUNCHES)
    rng = np.random.default_rng(0)
    g_src = rng.integers(0, 8, 200)
    store = es.store_from_arrays(g_src, rng.integers(0, 8, 200),
                                 rng.integers(0, 100, 200), 512, 8,
                                 device="cpu")
    idx = build_index(store, 8)
    weight_prefix(torch.zeros(64), torch.ones(64, dtype=torch.bool))
    W = 32
    nodes = torch.sort(torch.from_numpy(
        rng.integers(0, 8, W).astype(np.int32))).values
    times = torch.from_numpy(rng.integers(0, 100, W).astype(np.int32))
    for mode in ("index", "weight"):
        res = kf.fused_walk_step(
            idx, nodes, times, torch.full((W,), 2, dtype=torch.int32),
            torch.rand(W), mode,
            SchedulerConfig(path="fused", tile_walks=8, tile_edges=128))
        assert res.k.device.type == "cpu"
    assert runtime.LAUNCHES == before
    assert runtime._LIB is None          # nothing was built or loaded


def _run_smoke(cwd: Path, script: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_cuda():
    out = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    out = _run_smoke(tmp_path, alone)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
