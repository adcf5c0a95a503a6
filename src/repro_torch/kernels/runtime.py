"""Device choice, the CUDA kernel library, and launch counters.

The Hopper kernels live as CUDA C++ in ``repro_torch/csrc``. At first CUDA
use they are compiled with ``nvcc`` (one process per source, started
together, then one link) into a shared library with a plain C interface
under ``repro_torch/_build/``, named by a hash of the sources and flags,
and loaded with ``ctypes``. Importing the package needs neither ``nvcc``
nor a card.

Every kernel wrapper adds one to its entry of ``LAUNCHES`` where it
launches its kernel, and nowhere else, so a run can show that the main
path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "--fmad=false",
                           "-Xcompiler", "-fPIC")

LAUNCHES: Dict[str, int] = {
    "fused_hop": 0,
    "weight_prefix": 0,
    "walk_step_tiled": 0,
}

_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. With no card and no explicit device this raises; it never
    falls back to the CPU by itself."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librepro_kernels_{h.hexdigest()[:16]}.so"


def build_library(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` in parallel and link one library.
    A library already built from the same sources is reused."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu, _ = _sources()
    tag = f"{os.getpid()}"
    objs, procs = [], []
    extra = ("-Xptxas", "-v") if verbose else ()
    for src in cu:
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC_DIR), "-c", str(src),
             "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [(src, p.communicate()[0], p.returncode)
            for src, p in zip(cu, procs)]
    for src, log, rc in logs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        if verbose and log:
            print(log, end="")
    tmp = out.with_suffix(f".{tag}.tmp")
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def kernel(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """C entry point ``name`` with its argument types set."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(status: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if status != 0:
        msg = library().repro_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status}: {msg}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def expect(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: Sequence[int], device: torch.device) -> None:
    """Wrapper-side argument check: device, dtype, shape, contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
