"""End-to-end driver #2: train an LM on walk-token sequences
(walk-native training, paper conclusion) with checkpoint/restart.

Default: a reduced olmo-1b topology for a few hundred steps. ``--full``
uses the real olmo-1b config (~1B params).

    PYTHONPATH=src python tools/examples/train_lm_on_walks.py --steps 200 [--device cpu]

The port's counterpart of ``examples/train_lm_on_walks.py``: the same
steps, sizes, seeds and printed lines, on the card unless ``--device``
names another device. Checkpoints are the reference's: its params and
``OptState`` trees (``interop.lm_tree_to_ref``) in its on-disk format,
in the same three directories, so either package resumes the other's.
``--ckpt-dir`` defaults to ``tempest_lm_ckpt`` in the temporary
directory. ``main`` returns every step's loss.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import interop
from repro_torch import random as prng
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import (
    EngineConfig,
    SamplerConfig,
    SchedulerConfig,
    WalkConfig,
    WindowConfig,
)
from repro_torch.core.streaming import StreamingEngine
from repro_torch.data.synthetic import chronological_batches, powerlaw_temporal_graph
from repro_torch.data.walk_dataset import walks_to_lm_batch
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_loop import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "tempest_lm_ckpt"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("olmo-1b")
    if not args.full:
        cfg = reduced(cfg, layers=4, d_model=128, vocab=1024)

    # walk engine as the data pipeline
    g = powerlaw_temporal_graph(1000, 200_000, seed=3, device=dev)
    eng = StreamingEngine(EngineConfig(
        window=WindowConfig(duration=3000, edge_capacity=1 << 16,
                            node_capacity=1024),
        sampler=SamplerConfig(bias="exponential", mode="index"),
        scheduler=SchedulerConfig()), batch_capacity=16384, device=dev)
    batches = list(chronological_batches(g, 16))

    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    model = M.init_params(cfg, prng.PRNGKey(0), device=dev)
    params = M.params_of(model)
    opt = init_opt_state(params, opt_cfg)
    step0 = 0
    if ckpt.latest_step(args.ckpt_dir) is not None:
        step0 = ckpt.latest_step(args.ckpt_dir)
        ref_p = ckpt.restore(os.path.join(args.ckpt_dir, "params"),
                             interop.tree_from_ref(
                                 interop.lm_tree_to_ref(params, cfg), "cpu"))
        ref_o = ckpt.restore(os.path.join(args.ckpt_dir, "opt"),
                             interop.tree_from_ref(
                                 interop.lm_opt_state_to_ref(opt, cfg),
                                 "cpu"))
        model = interop.lm_params_from_ref(ref_p, cfg, dev)
        params = M.params_of(model)
        opt = interop.lm_opt_state_from_ref(ref_o, cfg, dev)
        print(f"restored checkpoint at step {step0}")

    train_step = make_train_step(model, opt_cfg)
    wcfg = WalkConfig(num_walks=1024, max_length=32, start_mode="nodes")

    bi = 0
    losses = []
    for step in range(step0, args.steps):
        if step % 20 == 0:                      # advance the stream
            bs, bd, bt = batches[bi % len(batches)]
            eng.ingest_batch(bs, bd, bt)
            bi += 1
        walks = eng.sample_walks(wcfg)
        toks, labels = walks_to_lm_batch(
            walks.nodes.cpu().numpy(), walks.lengths.cpu().numpy(),
            args.seq, args.batch, cfg.vocab_size, seed=step)
        params, opt, metrics = train_step(
            params, opt, {"tokens": torch.from_numpy(toks).to(dev),
                          "labels": torch.from_numpy(labels).to(dev)})
        losses.append(metrics["loss"])
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d}: loss={float(metrics['loss']):.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f}")
        if (step + 1) % 100 == 0:
            ckpt.save(os.path.join(args.ckpt_dir, "params"),
                      interop.lm_tree_to_ref(params, cfg), step + 1)
            ckpt.save(os.path.join(args.ckpt_dir, "opt"),
                      interop.lm_opt_state_to_ref(opt, cfg), step + 1)
            ckpt.save(args.ckpt_dir, {"placeholder": np.zeros(1)}, step + 1)
            print(f"checkpointed at step {step + 1}")
    return [float(x) for x in torch.stack(losses).cpu()] if losses else []


if __name__ == "__main__":
    main()
