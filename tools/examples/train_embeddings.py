"""End-to-end driver #1: streaming walks -> incremental CTDNE-style
skipgram embeddings -> temporal link prediction (paper §3.9).

    PYTHONPATH=src python tools/examples/train_embeddings.py [--device cpu]

The port's counterpart of ``examples/train_embeddings.py``: the same
steps, sizes, seeds and printed lines, on the card unless ``--device``
names another device. ``main`` returns each batch's loss and AUC and
the final AUC.
"""
import argparse

from repro_torch import random as prng
from repro_torch.configs.base import (
    EngineConfig,
    SamplerConfig,
    SchedulerConfig,
    WalkConfig,
    WindowConfig,
)
from repro_torch.core.streaming import StreamingEngine
from repro_torch.data.synthetic import chronological_batches, powerlaw_temporal_graph
from repro_torch.kernels.runtime import resolve_device
from repro_torch.train.embeddings import (
    init_skipgram,
    link_prediction_auc,
    train_on_walks,
)


def main(argv=None, num_nodes=512, num_edges=50_000, batches=20, dim=64):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = powerlaw_temporal_graph(num_nodes, num_edges, seed=21, device=dev)
    n_test = int(0.85 * num_edges)
    cfg = EngineConfig(
        window=WindowConfig(duration=(int(g.ts.max()) + 1) / batches * 2,
                            edge_capacity=1 << 16,
                            node_capacity=num_nodes),
        sampler=SamplerConfig(bias="exponential", mode="index"),
        scheduler=SchedulerConfig(),
    )
    eng = StreamingEngine(cfg, batch_capacity=num_edges // batches + 64,
                          device=dev)
    state = init_skipgram(num_nodes, dim, prng.PRNGKey(1), device=dev)
    key = prng.PRNGKey(2)
    wcfg = WalkConfig(num_walks=2048, max_length=12, start_mode="nodes")
    losses, aucs = [], []

    for bi, (bs, bd, bt) in enumerate(chronological_batches(g, batches)):
        if bi / batches > 0.7:
            break                              # chronological train split
        eng.ingest_batch(bs, bd, bt)
        walks = eng.sample_walks(wcfg)
        key, sub = prng.split(key)
        state, loss = train_on_walks(state, walks.nodes, walks.lengths,
                                     sub, epochs=1)
        auc = link_prediction_auc(state, g.src[n_test:], g.dst[n_test:],
                                  num_nodes)
        losses.append(loss)
        aucs.append(auc)
        print(f"batch {bi:2d}: skipgram_loss={loss:.4f} test_auc={auc:.3f}")

    final = link_prediction_auc(state, g.src[n_test:], g.dst[n_test:],
                                num_nodes)
    print("\nfinal test AUC:", final)
    return dict(losses=losses, aucs=aucs, final_auc=final)


if __name__ == "__main__":
    main()
