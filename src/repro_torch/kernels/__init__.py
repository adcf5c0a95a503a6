"""Hopper kernels of the port (CUDA C++ in ``repro_torch/csrc``), each
beside its plain PyTorch version.

fused_step.py    — fused hop, tiers S and L in one launch (path="fused")
walk_step.py     — tiled hop over a staged panel (path="tiled")
weight_prefix.py — fused exp + scan behind the index's ``pexp``
ops.py           — the tiled path's wrapper: task table, one hop launch
runtime.py       — device choice, the kernel library, launch counters
"""
