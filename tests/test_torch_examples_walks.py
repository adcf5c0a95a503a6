"""The port's walk entry points (``tools/examples/quickstart.py``,
``streaming_walks.py``, ``serve_walks.py``) held against the reference's
scripts of the same names (``examples/``) in one process, on the CPU.

Each reference script runs as written (its ``main``), its printed lines
captured and the walks or tickets it computes recorded by wrapping the
names it looked up in its own module; the port's runs with ``--device
cpu``. The printed lines must be equal once the timing fields (ms,
latency, p50/p99, walks/s, seconds) are masked; walks and tickets must
be byte-identical. ``streaming_walks`` runs at a smaller stream (1,000
nodes, 20,000 edges in 4 batches, 256 walks a batch), given to the
reference by wrapping its graph, batch and walk-config constructors and
to the port through ``main``'s keywords. ``serve_walks --shards 4``
serves the tenants over 4 shards of the CPU and every ticket must equal
the reference's single-device solo run.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


def load(path: str, name: str):
    """The script at ``path`` (from the repository root) as a module."""
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def masked(text: str) -> list:
    """The printed lines with every timing field masked."""
    out = []
    for line in text.splitlines():
        line = re.sub(r"(ingest|sample|latency|p50|p99)= *[0-9.]+ms",
                      r"\1=<t>", line)
        line = re.sub(r"[0-9.]+ walks/s", "<t> walks/s", line)
        line = re.sub(r"ingest [0-9.]+ms/batch", "ingest <t>/batch", line)
        line = re.sub(r"batches in [0-9.]+s[^,]*,", "batches in <t>,", line)
        out.append(line)
    return out


def section(lines: list, head: str) -> list:
    """The lines after ``head`` up to the next blank line."""
    i = lines.index(head) + 1
    j = lines.index("", i) if "" in lines[i:] else len(lines)
    return lines[i:j]


def same_walks(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), y.cpu().numpy())
               for x, y in zip((a.nodes, a.times, a.lengths),
                               (b.nodes, b.times, b.lengths)))


def test_quickstart_matches_reference(capsys, monkeypatch):
    ref = load("examples/quickstart.py", "ref_quickstart")
    made = []
    generate = ref.generate_walks
    monkeypatch.setattr(ref, "generate_walks",
                        lambda *a, **k: made.append(generate(*a, **k))
                        or made[-1])
    ref.main()
    want = capsys.readouterr().out
    port = load("tools/examples/quickstart.py", "port_quickstart")
    walks = port.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert "hop validity  : 1.000" in got.splitlines()
    assert same_walks(made[0], walks)


def test_streaming_walks_matches_reference(capsys, monkeypatch):
    nodes, edges, batches, walks_n = 1000, 20_000, 4, 256
    ref = load("examples/streaming_walks.py", "ref_streaming_walks")
    graph, chrono, wcfg = (ref.powerlaw_temporal_graph,
                           ref.chronological_batches, ref.WalkConfig)
    monkeypatch.setattr(ref, "powerlaw_temporal_graph",
                        lambda num_nodes, num_edges, seed: graph(
                            num_nodes=nodes, num_edges=edges, seed=seed))
    monkeypatch.setattr(ref, "chronological_batches",
                        lambda g, n: chrono(g, batches))
    monkeypatch.setattr(ref, "WalkConfig",
                        lambda num_walks, **k: wcfg(num_walks=walks_n, **k))
    seen = []
    validate = ref.validate_walks
    monkeypatch.setattr(ref, "validate_walks",
                        lambda index, w: seen.append(w) or validate(index, w))
    ref.main()
    want = masked(capsys.readouterr().out)
    port = load("tools/examples/streaming_walks.py", "port_streaming_walks")
    walks, stats, _ = port.main(["--device", "cpu"], num_nodes=nodes,
                                num_edges=edges, batches=batches,
                                num_walks=walks_n)
    got = masked(capsys.readouterr().out)
    # per-batch active edges, validity and drops; the device replay's
    # drops; the Prometheus counters
    assert got[:batches + 3] == want[:batches + 3]
    assert all("valid=1.00" in line for line in got[:batches])
    head = "--- Prometheus exposition (excerpt) ---"
    assert section(got, head) == section(want, head)
    assert any(line.startswith("stream_batches_total")
               for line in section(got, head))
    assert len(walks) == len(seen) == batches
    assert all(same_walks(a, b) for a, b in zip(seen, walks))
    assert len(stats.edges_active) == batches


def test_serve_walks_matches_reference(capsys, monkeypatch):
    ref = load("examples/serve_walks.py", "ref_serve_walks")
    polled = []

    class Recorded(ref.WalkService):
        def poll(self, ticket):
            r = super().poll(ticket)
            polled.append(r)
            return r

    monkeypatch.setattr(ref, "WalkService", Recorded)
    ref_svc, _, tenants = ref.main()
    want = masked(capsys.readouterr().out)
    port = load("tools/examples/serve_walks.py", "port_serve_walks")
    svc, _, port_tenants, results, sharded_svc, sharded = port.main(
        ["--device", "cpu", "--shards", "4"])
    got = masked(capsys.readouterr().out)
    # per-tenant walk counts and mean lengths, solo == coalesced, the
    # snapshot version and the served totals; then the sharded line
    assert got[:len(want)] == want
    assert "4-shard service: all 3 tenants bit-identical" in got[-1]
    assert "walk drops=0, ingest drops=0" in got[-1]
    assert sharded_svc.num_shards == 4
    assert [repr(q) for q in port_tenants] == [repr(q) for q in tenants]
    # the coalesced tickets, tenant by tenant, byte-identical
    for r, name in zip(polled[:3], ("recommender", "fraud", "embedder")):
        p = results[name]
        for f in ("nodes", "times", "lengths"):
            assert np.array_equal(np.asarray(getattr(r, f)),
                                  np.asarray(getattr(p, f))), (name, f)
    # the 4-shard tickets equal the reference's single-device solo runs
    for q, r in zip(tenants, sharded):
        nodes, _, lengths = ref_svc.run_query_solo(q)
        assert np.array_equal(np.asarray(nodes), np.asarray(r.nodes))
        assert np.array_equal(np.asarray(lengths), np.asarray(r.lengths))


@pytest.mark.parametrize("script", ["quickstart", "streaming_walks",
                                    "serve_walks"])
def test_walk_entry_point_needs_a_card_or_cpu(script, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = load(f"tools/examples/{script}.py", f"port_{script}_nocard")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
