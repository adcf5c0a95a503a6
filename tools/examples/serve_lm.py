"""Example: batched autoregressive serving with the KV-cache serve step.

    PYTHONPATH=src python tools/examples/serve_lm.py --arch qwen2-0.5b [--device cpu]

The port's counterpart of ``examples/serve_lm.py``: the same steps,
sizes, seed and printed lines, on the card unless ``--device`` names
another device. The greedy tokens stay on the device until the last step
(``decode`` makes no host sync). ``main`` returns the token ids
``[batch, steps]``.
"""
import argparse
import time

import torch

from repro_torch import random as prng
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import model as M
from repro_torch.train.train_loop import make_serve_step


def decode(serve, params, tok, state, steps: int):
    """``steps`` greedy tokens from ``tok``: the list of each step's
    ``[batch]`` ids, on the device, and the state."""
    outs = []
    for _ in range(steps):
        tok, state = serve(params, tok, state)
        outs.append(tok[:, 0])
    return outs, state


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    model = M.init_params(cfg, prng.PRNGKey(0), device=dev)
    params = M.params_of(model)
    serve = make_serve_step(model)

    state = M.init_decode_state(model, args.batch, args.steps + 8)
    tok = torch.ones((args.batch, 1), dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    outs, state = decode(serve, params, tok, state, args.steps)
    seqs = torch.stack(outs, 1).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} batch={args.batch} steps={args.steps}")
    print(f"throughput: {args.batch*args.steps/dt:.1f} tok/s "
          f"({1e3*dt/args.steps:.1f} ms/step)")
    print("sampled ids (greedy):", seqs[0][:16], "...")
    return seqs


if __name__ == "__main__":
    main()
