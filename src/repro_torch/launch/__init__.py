"""The dry-run, PyTorch port of repro/launch: every (architecture ×
input shape × mesh) cell's step counted on meta tensors and reckoned at
H100 constants.

* mesh — the production meshes (16×16, 2×16×16) as ``{axis: size}``.
* specs — meta-tensor inputs, decode states, params and AdamW states.
* op_cost — FLOPs, transcendentals and bytes of an eager step
  (``OpCounter``, a ``TorchDispatchMode``), globally and as a chip's
  share on any mesh (``per_chip``), from each tensor's layout.
* comm_cost — the collectives a plan implies for one step, a chip's
  bytes by kind and mesh axes (``plan_collectives``).
* roofline — the compute, memory and collective terms at H100
  data-sheet constants, and the link model.
* dryrun — the cells and the CLI (``python -m repro_torch.launch.dryrun``).
* report — the markdown table of dry-run rows (``python -m
  repro_torch.launch.report``).

The two CLIs are not imported here, so that ``-m`` runs each fresh.
"""
from repro_torch.launch import (comm_cost, mesh, op_cost,  # noqa: F401
                                roofline, specs)
