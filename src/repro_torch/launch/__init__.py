"""The dry-run, PyTorch port of repro/launch: every (architecture ×
input shape × mesh) cell's step counted on meta tensors and reckoned at
H100 constants.

* mesh — the production meshes (16×16, 2×16×16) as ``{axis: size}``.
* specs — meta-tensor inputs, decode states, params and AdamW states.
* op_cost — FLOPs, transcendentals and bytes of an eager step
  (``OpCounter``, a ``TorchDispatchMode``); collectives are not counted.
* roofline — the compute and memory terms at H100 data-sheet constants.
* dryrun — the cells and the CLI (``python -m repro_torch.launch.dryrun``).
* report — the markdown table of dry-run rows (``python -m
  repro_torch.launch.report``).

The two CLIs are not imported here, so that ``-m`` runs each fresh.
"""
from repro_torch.launch import mesh, op_cost, roofline, specs  # noqa: F401
