"""Production meshes, PyTorch port of repro/launch/mesh.py.

A mesh is an ordered ``{axis name: size}`` dict: the plans
(``distributed.sharding``) and the dry-run read only the axis names and
sizes, and nothing here touches a device. The shapes are the
reference's, so the plans can be held to its; the dry-run reckons them
as 256 and 512 H100s.
"""
from __future__ import annotations

from typing import Dict


def production_mesh(multi_pod: bool = False) -> Dict[str, int]:
    """16 × 16 = 256 chips a pod; multi-pod adds a leading pod axis."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def dev_mesh(data: int = 1, model: int = 1) -> Dict[str, int]:
    """A small mesh (one chip by default)."""
    return {"data": data, "model": model}


def mesh_name(mesh: Dict[str, int]) -> str:
    """``16x16``, ``2x16x16``: the reference's row label."""
    return "x".join(str(s) for s in mesh.values())
