"""Meta-tensor stand-ins for every model input, the decode state, the
params and the optimizer state (no storage), PyTorch port of
repro/launch/specs.py.

``input_specs(cfg, shape)`` is the batch of a train or prefill step;
``decode_specs`` the tokens and the decode state of a serve step.
Modality frontends are stubs: precomputed frame and patch embeddings
appear directly as inputs, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.train.optimizer import AdamWConfig, OptState, init_opt_state

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """``tokens`` [B, S] int32 (a VLM's text ``[B, S − n_p]`` after
    ``patches`` [B, n_p, d], n_p = min(N_PATCHES, S // 2)); an enc-dec's
    ``frames`` [B, ENC_FRAMES, d]; ``labels`` like ``tokens`` for
    train."""
    B, S = shape.global_batch, shape.seq_len
    dt = M.compute_dtype(cfg)
    batch = {"tokens": _spec((B, S), torch.int32)}
    if cfg.family == "vlm":
        n_p = min(M.N_PATCHES, S // 2)
        batch["tokens"] = _spec((B, S - n_p), torch.int32)
        batch["patches"] = _spec((B, n_p, cfg.d_model), dt)
    if cfg.family == "enc_dec":
        batch["frames"] = _spec((B, M.ENC_FRAMES, cfg.d_model), dt)
    if shape.kind == "train":
        batch["labels"] = _spec(batch["tokens"].shape, torch.int32)
    return batch


def abstract_model(cfg: ModelConfig) -> M.TransformerLM:
    """The model on the meta device."""
    return M.TransformerLM(cfg, None, META)


def decode_specs(cfg: ModelConfig, shape: ShapeConfig,
                 model: M.TransformerLM = None
                 ) -> Tuple[torch.Tensor, M.DecodeState]:
    """(tokens [B, 1], the decode state at ``max_seq`` = S) for a serve
    step."""
    B, S = shape.global_batch, shape.seq_len
    model = model if model is not None else abstract_model(cfg)
    return _spec((B, 1), torch.int32), M.init_decode_state(model, B, S)


def abstract_params(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The params tree (``params_of``) on meta: float32 masters."""
    return M.params_of(abstract_model(cfg))


def abstract_opt_state(cfg: ModelConfig, opt_cfg: AdamWConfig) -> OptState:
    return init_opt_state(abstract_params(cfg), opt_cfg)
