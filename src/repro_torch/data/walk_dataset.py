"""Walks → training data: skipgram pairs (CTDNE-style) and LM token
sequences (walk-native training, paper conclusion). PyTorch port of
repro/data/walk_dataset.py.

``skipgram_pairs`` runs on the walks' device, vectorised: every
(walk, centre, offset) cell of the walk tensor is a candidate pair, and
the valid ones are read off in row-major order, which is the reference's
loop order (walk ``w``, then centre ``i``, then context ``j`` ascending).
``walks_to_lm_batch`` is a host function, a copy of the reference's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def skipgram_pairs(nodes, lengths, window: int = 2,
                   max_pairs: Optional[int] = None,
                   seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(center, context) int32 pairs from walk node sequences.

    ``nodes`` int ``[W, L]`` and ``lengths`` int ``[W]`` are tensors (or
    arrays, taken onto the CPU); the pairs come back on ``nodes``'s
    device. Centre ``i`` of walk ``w`` pairs with every ``j != i`` of
    ``[max(0, i − window), min(n, i + window + 1))``. With more than
    ``max_pairs`` pairs, the reference's
    ``default_rng(seed).choice(..., replace=False)`` picks them on the
    host and one gather applies the pick. Reading the pair count costs
    one host sync."""
    nodes = torch.as_tensor(nodes)
    dev = nodes.device
    lengths = torch.as_tensor(lengths).to(dev, torch.int64)
    W, L = nodes.shape
    if window <= 0 or W == 0 or L == 0:
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        return empty, empty.clone()
    offs = torch.cat([torch.arange(-window, 0, device=dev),
                      torch.arange(1, window + 1, device=dev)])
    K = offs.numel()
    i = torch.arange(L, device=dev)
    j = i[:, None] + offs                               # [L, K]
    n = lengths[:, None, None]
    ok = (i[None, :, None] < n) & (j >= 0) & (j < n)    # [W, L, K]
    cell = ok.reshape(-1).nonzero().squeeze(1)          # row-major order
    w, rest = cell // (L * K), cell % (L * K)
    ci, k = rest // K, rest % K
    flat = nodes.reshape(-1)
    c = flat[w * L + ci].to(torch.int32)
    x = flat[w * L + ci + offs[k]].to(torch.int32)
    if max_pairs is not None and c.numel() > max_pairs:
        rng = np.random.default_rng(seed)
        idx = torch.from_numpy(rng.choice(c.numel(), max_pairs,
                                          replace=False))
        idx = idx.to(dev, non_blocking=True)
        c, x = c[idx], x[idx]
    return c, x


def walks_to_lm_batch(nodes: np.ndarray, lengths: np.ndarray,
                      seq_len: int, batch: int, vocab: int,
                      pad_id: int = 0, seed: int = 0):
    """Pack walks into fixed [batch, seq_len] token/label arrays.

    Node ids are the token ids (walk-native LM training); walks shorter
    than seq_len are concatenated with a separator (vocab-1)."""
    nodes = np.asarray(nodes)
    lengths = np.asarray(lengths)
    rng = np.random.default_rng(seed)
    sep = vocab - 1
    stream = []
    order = rng.permutation(nodes.shape[0])
    for w in order:
        n = int(lengths[w])
        if n > 1:
            stream.extend(int(t) % (vocab - 1) for t in nodes[w, :n])
            stream.append(sep)
    need = batch * (seq_len + 1)
    while len(stream) < need:
        stream.append(pad_id)
    arr = np.asarray(stream[:need], np.int32).reshape(batch, seq_len + 1)
    return arr[:, :-1], arr[:, 1:]
