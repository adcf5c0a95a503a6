"""Incremental skipgram embedding training on temporal walks (paper §3.9),
PyTorch port of repro/train/embeddings.py.

Streaming regime: after each ingested batch, walks are generated from the
active window and the embeddings are updated incrementally [Mikolov'13;
CTDNE]. Link prediction scores held-out edges against corrupted targets.

The step takes its gradient in closed form. With ``s = u·v`` for the
positive pair and ``s_k = u·vn_k`` for the negatives, the loss
``−mean(logσ(s) + Σ_k logσ(−s_k))`` has ``∂/∂s = −σ(−s)/P`` and
``∂/∂s_k = σ(s_k)/P``, so the row gradients are two products each.
Autograd through the table gathers would form the dense ``[N, D]``
gradient (1 GiB per table at 2^22 × 64), and autograd on the gathered
rows builds a graph on the host every step for the same arithmetic.

The update equals the reference's ``emb − lr·g`` and touches only the
rows the step read: each row's gradient is summed over all of its
occurrences (centre, context, negative) first, in a fixed order (rows
sorted stably, then ``index_put_(accumulate=True)``, which sums each row
in that order on the CPU and, sorting by row, on CUDA too), then
``x − lr·g`` is written once per row. Rows the step did not read stay
bitwise unchanged, as ``x − lr·0 = x`` leaves them in the reference.
The tables are updated in place: the state returned shares them with
the state given, as a donated argument would.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random as prng
from repro_torch.data.walk_dataset import skipgram_pairs
from repro_torch.kernels.runtime import resolve_device

# mini-batches whose negatives are drawn in one threefry batch
NEG_DRAW_STEPS = 32


class SkipgramState(NamedTuple):
    emb_in: torch.Tensor      # float32 [N, D]
    emb_out: torch.Tensor     # float32 [N, D]


def init_skipgram(num_nodes: int, dim: int, key,
                  device=None) -> SkipgramState:
    """``emb_in`` normal scaled by ``1/sqrt(dim)``, ``emb_out`` zero, on
    CUDA unless ``device`` names another."""
    device = resolve_device(device)
    k1, _ = prng.split(key)
    scale = float(1.0 / np.sqrt(dim))
    return SkipgramState(
        emb_in=scale * prng.normal(k1, (num_nodes, dim), device),
        emb_out=torch.zeros((num_nodes, dim), dtype=torch.float32,
                            device=device))


def _sgd_rows(table: torch.Tensor, rows: torch.Tensor, grads: torch.Tensor,
              lr: float) -> None:
    """``table[r] −= lr · Σ grads[rows == r]`` for every row read, in
    place; the sum per row in occurrence order."""
    rows = rows.to(torch.int64)
    order = torch.sort(rows, stable=True).indices
    r = rows[order]
    head = torch.ones_like(r, dtype=torch.bool)
    head[1:] = r[1:] != r[:-1]
    seg = torch.cumsum(head, 0) - 1
    summed = torch.zeros_like(grads).index_put_((seg,), grads[order],
                                                accumulate=True)
    # every occurrence of a row writes the same value
    table.index_put_((r,), table[r] - lr * summed[seg])


def _step(state: SkipgramState, centers, contexts, negs, lr: float):
    """One SGD step on given negatives; returns the 0-d loss tensor."""
    emb_in, emb_out = state
    P = centers.shape[0]
    u = emb_in[centers.long()]                          # [P, D]
    v = emb_out[contexts.long()]                        # [P, D]
    vn = emb_out[negs.long()]                           # [P, K, D]
    s = (u * v).sum(-1)
    s_neg = (u[:, None, :] * vn).sum(-1)                # [P, K]
    loss = -torch.mean(F.logsigmoid(s) + F.logsigmoid(-s_neg).sum(-1))
    g_s = -torch.sigmoid(-s) / P
    g_neg = torch.sigmoid(s_neg) / P
    g_u = g_s[:, None] * v + (g_neg[..., None] * vn).sum(1)
    g_v = g_s[:, None] * u
    g_vn = g_neg[..., None] * u[:, None, :]
    _sgd_rows(emb_in, centers, g_u, lr)
    _sgd_rows(emb_out, torch.cat([contexts.reshape(-1), negs.reshape(-1)]),
              torch.cat([g_v, g_vn.reshape(-1, g_v.shape[1])]), lr)
    return loss


def skipgram_step(state: SkipgramState, centers, contexts, key,
                  n_neg: int = 5, lr: float = 0.025):
    """One SGD step of skipgram with negative sampling; the negatives are
    ``jax.random.randint(key, (P, n_neg), 0, N)`` bit for bit. Returns
    ``(state, loss)`` with the loss a 0-d tensor on the tables' device."""
    dev = state.emb_in.device
    negs = prng.randint(key, (centers.shape[0], n_neg), 0,
                        state.emb_in.shape[0], dev)
    loss = _step(state, torch.as_tensor(centers).to(dev),
                 torch.as_tensor(contexts).to(dev), negs, lr)
    return state, loss


def train_on_walks(state: SkipgramState, nodes, lengths, key, *,
                   window: int = 2, epochs: int = 1,
                   batch_pairs: int = 8192, n_neg: int = 5,
                   lr: float = 0.025):
    """Incremental update from one walk batch, on the tables' device.

    As the reference: pairs from ``skipgram_pairs``, each epoch's order
    ``np.random.default_rng(ep).permutation`` (seeded by the epoch number
    alone, so every call draws the same order), one ``split`` of ``key``
    per mini-batch, and the mean of the float32 losses as a Python float
    (``(state, 0.0)`` without pairs). The negatives of up to
    ``NEG_DRAW_STEPS`` mini-batches are drawn in one batch, the same bits
    as each step's own ``randint``. Host syncs per call: the pair count
    and the losses' one copy back."""
    dev = state.emb_in.device
    N = state.emb_in.shape[0]
    c, x = skipgram_pairs(torch.as_tensor(nodes).to(dev),
                          torch.as_tensor(lengths).to(dev), window=window)
    P = c.numel()
    if P == 0:
        return state, 0.0
    steps = math.ceil(P / batch_pairs)
    losses = []
    for ep in range(epochs):
        perm = torch.from_numpy(np.random.default_rng(ep).permutation(P))
        perm = perm.to(dev, non_blocking=True)
        key, subs = prng.split_chain(key, steps)
        for s0 in range(0, steps, NEG_DRAW_STEPS):
            negs = prng.randint_keys(subs[s0:s0 + NEG_DRAW_STEPS],
                                     (batch_pairs, n_neg), 0, N, dev)
            for s, neg in enumerate(negs, start=s0):
                sel = perm[s * batch_pairs:(s + 1) * batch_pairs]
                losses.append(_step(state, c[sel], x[sel],
                                    neg[:sel.numel()], lr))
    host = torch.stack(losses).cpu().numpy()
    return state, float(np.mean(host.tolist()))


def link_prediction_auc(state: SkipgramState, pos_src, pos_dst,
                        num_nodes: int, seed: int = 0) -> float:
    """AUC of dot-product scores, negatives = corrupted targets (host
    numpy, as the reference: untouched ``emb_out`` rows score exactly 0,
    and the rank statistic's order of those ties is ``np.argsort``'s).
    The two tables are copied to the host once."""
    rng = np.random.default_rng(seed)
    neg_dst = rng.integers(0, num_nodes, len(pos_dst))
    emb_in = state.emb_in.cpu().numpy()
    emb_out = state.emb_out.cpu().numpy()
    pos_src = np.asarray(pos_src)
    pos_dst = np.asarray(pos_dst)
    pos_s = np.sum(emb_in[pos_src] * emb_out[pos_dst], -1)
    neg_s = np.sum(emb_in[pos_src] * emb_out[neg_dst], -1)
    # AUC = P(pos > neg) via rank statistic
    scores = np.concatenate([pos_s, neg_s])
    labels = np.concatenate([np.ones_like(pos_s), np.zeros_like(neg_s)])
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    n_pos = len(pos_s)
    n_neg = len(neg_s)
    auc = (ranks[labels == 1].sum() - n_pos * (n_pos + 1) / 2) \
        / (n_pos * n_neg)
    return float(auc)
