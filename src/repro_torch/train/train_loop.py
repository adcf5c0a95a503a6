"""Train/eval/serve/prefill step factories, PyTorch port of
repro/train/train_loop.py.

The reference's steps are pure functions of a params tree; here the
model is an ``nn.Module`` and the params tree is ``models.model.
params_of(model)``, its parameters by name. A step points the module at
the tree it is given (``bind_params``, no copy), so each step computes
with exactly the tensors passed in:

* ``make_train_step(model, opt_cfg)`` → ``(params, opt_state, batch)
  -> (params, opt_state, metrics)``: the loss and its gradient by autograd,
  then ``train.optimizer.apply_updates``; metrics ``loss``, ``lr``,
  ``grad_norm`` (device tensors, nothing read back);
* ``make_eval_step`` → ``(params, batch) -> loss``;
* ``make_serve_step`` → ``(params, tokens, state) -> (next [B, 1] int32,
  state)``, greedy (the first maximal index, as ``jnp.argmax``);
* ``make_prefill_step`` → ``(params, batch) -> last-position logits``.

Each factory takes the reference's ``num_groups`` (1 by default): the
token groups an MoE layer dispatches in.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import model as M
from repro_torch.train.optimizer import AdamWConfig, OptState, apply_updates


def make_train_step(model: M.TransformerLM, opt_cfg: AdamWConfig,
                    num_groups: int = 1):
    def train_step(params: Dict[str, torch.Tensor], opt_state: OptState,
                   batch: Dict[str, Any]):
        M.bind_params(model, params)
        names = list(params)
        with torch.enable_grad():
            loss = M.loss_fn(model, batch, num_groups=num_groups)
            named = dict(model.named_parameters())
            grads = torch.autograd.grad(loss, [named[n] for n in names])
        with torch.no_grad():
            params, opt_state, metrics = apply_updates(
                params, dict(zip(names, grads)), opt_state, opt_cfg)
        M.bind_params(model, params)
        return params, opt_state, dict(metrics, loss=loss.detach())

    return train_step


def make_eval_step(model: M.TransformerLM, num_groups: int = 1):
    @torch.no_grad()
    def eval_step(params, batch):
        M.bind_params(model, params)
        return M.loss_fn(model, batch, num_groups=num_groups)
    return eval_step


def make_serve_step(model: M.TransformerLM, num_groups: int = 1):
    @torch.no_grad()
    def serve_step(params, tokens, state):
        M.bind_params(model, params)
        logits, state = M.decode_step(model, tokens, state,
                                      num_groups=num_groups)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], state
    return serve_step


def make_prefill_step(model: M.TransformerLM, num_groups: int = 1):
    """Prefill: full-sequence forward returning last-position logits
    (the cache is filled by ``decode_step`` over the prompt, as in the
    reference)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        M.bind_params(model, params)
        x, _, _ = M.forward(model, batch, num_groups=num_groups)
        return M.logits_from_hidden(model, x[:, -1:, :])
    return prefill_step
