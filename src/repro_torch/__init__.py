"""PyTorch/CUDA port of the temporal window-based random walk sampler.

The JAX package ``repro`` is the reference; this package imports nothing
of it (nor ``jax``). Entry points run on CUDA unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version. See README.md, section "PyTorch/CUDA port".
"""
