"""Config registry: ``get_config(name)`` / ``list_archs()``.

One module per architecture of the reference, each exposing ``CONFIG``
(copied as data). Every config builds a model in the port
(``repro_torch.models``).
"""
from __future__ import annotations

from importlib import import_module
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    SHAPES_BY_NAME,
    AttentionConfig,
    EngineConfig,
    ModelConfig,
    MoEConfig,
    SamplerConfig,
    SchedulerConfig,
    ServeConfig,
    ShapeConfig,
    ShardConfig,
    SSMConfig,
    WalkConfig,
    WindowConfig,
    reduced,
    shapes_for,
)

ARCH_MODULES = {
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
}


def list_archs():
    return sorted(ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    return import_module(ARCH_MODULES[name]).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_MODULES}
