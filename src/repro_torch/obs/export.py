"""Exporters: Prometheus text exposition, JSON snapshots, health dumps,
and the shared benchmark schema (DESIGN.md §16), the PyTorch port's copy
of repro/obs/export.py (plain Python and numpy). The three document
schemas are the reference's unchanged; ``bench_doc`` tags the backend in
the schema's free ``config`` object.

Three schema-tagged document shapes, each with a hand-rolled validator
(no external jsonschema dependency — the container ships none):

* ``tempest-obs/v1`` (``export_json``/``validate_snapshot``) — the whole
  registry: every family, every label series; histograms export count /
  sum / min / max / p50 / p90 / p99 over their bounded reservoirs.
* ``tempest-health/v1`` (``health_snapshot``/``validate_health``) — the
  live streaming-health view assembled from registry metrics (plus an
  optional sharded engine for fresh per-shard loads and an optional
  service for its live queue and latency view): ingest progress,
  window occupancy + eviction rate, per-shard load/drift, dispatch-tier
  mix, serve p50/p99, and the consolidated drop taxonomy.
* ``tempest-bench/v1`` (``bench_doc``/``validate_bench``) — one schema
  for every ``BENCH_*.json`` benchmark artifact: the suite's CSV rows
  (name, us_per_call, derived) plus optional suite-specific ``results``.

``to_prometheus`` renders the registry in Prometheus text exposition
format (counters/gauges as-is; histograms as summaries with p50/p99
quantile lines), so a scrape endpoint or a file-based textfile collector
can lift the whole system's telemetry without bespoke glue.
"""
from __future__ import annotations

import json
import math
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.registry import (
    DROP_KINDS,
    DropCounters,
    MetricsRegistry,
    get_registry,
)

OBS_SCHEMA = "tempest-obs/v1"
HEALTH_SCHEMA = "tempest-health/v1"
BENCH_SCHEMA = "tempest-bench/v1"
# the backend tag bench_doc writes into the document's config object
BACKEND = "pytorch"

_HIST_QUANTILES = (50.0, 90.0, 99.0)


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------


def _fmt_value(v) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_labels(key) -> str:
    if not key:
        return ""
    parts = []
    for k, v in key:
        esc = str(v).replace("\\", r"\\").replace('"', r'\"').replace(
            "\n", r"\n")
        parts.append(f'{k}="{esc}"')
    return "{" + ",".join(parts) + "}"


def to_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """Render the registry in Prometheus text exposition format."""
    reg = registry if registry is not None else get_registry()
    out: List[str] = []
    for fam in reg.families():
        ptype = "summary" if fam.kind == "histogram" else fam.kind
        if fam.help:
            out.append(f"# HELP {fam.name} {fam.help}")
        out.append(f"# TYPE {fam.name} {ptype}")
        for key, inst in sorted(fam.series.items()):
            if fam.kind == "histogram":
                for q in _HIST_QUANTILES:
                    qkey = key + (("quantile", str(q / 100.0)),)
                    out.append(f"{fam.name}{_fmt_labels(qkey)} "
                               f"{_fmt_value(inst.percentile(q))}")
                out.append(f"{fam.name}_count{_fmt_labels(key)} "
                           f"{_fmt_value(inst.count)}")
                out.append(f"{fam.name}_sum{_fmt_labels(key)} "
                           f"{_fmt_value(inst.sum)}")
            else:
                out.append(f"{fam.name}{_fmt_labels(key)} "
                           f"{_fmt_value(inst.value)}")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# JSON snapshot of the whole registry
# ---------------------------------------------------------------------------


def export_json(registry: Optional[MetricsRegistry] = None) -> dict:
    """Snapshot every registered metric as one schema-tagged document."""
    reg = registry if registry is not None else get_registry()
    metrics: Dict[str, dict] = {}
    for fam in reg.families():
        series = []
        for key, inst in sorted(fam.series.items()):
            entry: dict = {"labels": dict(key)}
            if fam.kind == "histogram":
                vals = np.asarray(inst.reservoir)
                entry.update(
                    count=int(inst.count),
                    sum=float(inst.sum),
                    min=float(vals.min()) if vals.size else None,
                    max=float(vals.max()) if vals.size else None,
                )
                for q in _HIST_QUANTILES:
                    p = inst.percentile(q)
                    entry[f"p{int(q)}"] = None if math.isnan(p) else float(p)
            else:
                entry["value"] = (int(inst.value)
                                  if float(inst.value) == int(inst.value)
                                  else float(inst.value))
            series.append(entry)
        metrics[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "series": series}
    doc = {"schema": OBS_SCHEMA, "generated_unix_s": time.time(),
           "metrics": metrics}
    validate_snapshot(doc)
    return doc


def _fail(msg: str):
    raise ValueError(f"schema validation failed: {msg}")


def validate_snapshot(doc: dict) -> dict:
    """Validate a ``tempest-obs/v1`` document; returns it on success."""
    if not isinstance(doc, dict):
        _fail("document is not an object")
    if doc.get("schema") != OBS_SCHEMA:
        _fail(f"schema tag {doc.get('schema')!r} != {OBS_SCHEMA!r}")
    if not isinstance(doc.get("generated_unix_s"), (int, float)):
        _fail("generated_unix_s missing or not a number")
    metrics = doc.get("metrics")
    if not isinstance(metrics, dict):
        _fail("metrics missing or not an object")
    for name, fam in metrics.items():
        if not isinstance(fam, dict):
            _fail(f"{name}: family is not an object")
        kind = fam.get("kind")
        if kind not in ("counter", "gauge", "histogram"):
            _fail(f"{name}: unknown kind {kind!r}")
        series = fam.get("series")
        if not isinstance(series, list):
            _fail(f"{name}: series is not a list")
        for entry in series:
            if not isinstance(entry.get("labels"), dict):
                _fail(f"{name}: series entry lacks labels object")
            if kind == "histogram":
                if not isinstance(entry.get("count"), int):
                    _fail(f"{name}: histogram entry lacks integer count")
                if not isinstance(entry.get("sum"), (int, float)):
                    _fail(f"{name}: histogram entry lacks numeric sum")
            elif not isinstance(entry.get("value"), (int, float)):
                _fail(f"{name}: {kind} entry lacks numeric value")
    return doc


# ---------------------------------------------------------------------------
# Streaming-health view
# ---------------------------------------------------------------------------


def _series_by_label(registry, name: str, label: str) -> Dict[str, float]:
    fam = registry.get_family(name)
    out: Dict[str, float] = {}
    if fam is None:
        return out
    for key, inst in fam.series.items():
        labels = dict(key)
        if label in labels:
            out[labels[label]] = out.get(labels[label], 0) + inst.value
    return out


def _hist_summary(registry, name: str) -> dict:
    fam = registry.get_family(name)
    if fam is None or not fam.series:
        return {"count": 0, "p50_s": None, "p99_s": None}
    # merge all label series of the family into one summary view
    count, vals = 0, []
    for inst in fam.series.values():
        count += inst.count
        vals.extend(inst.reservoir.values())
    if not vals:
        return {"count": count, "p50_s": None, "p99_s": None}
    a = np.asarray(vals, dtype=np.float64)
    return {"count": count,
            "p50_s": float(np.percentile(a, 50)),
            "p99_s": float(np.percentile(a, 99))}


def health_snapshot(registry: Optional[MetricsRegistry] = None, *,
                    engine=None, service=None) -> dict:
    """Assemble the live streaming-health document (``tempest-health/v1``).

    Reads the registry only; ``engine`` (a ``DistributedStreamingEngine``
    or anything exposing ``shard_loads()``) refreshes per-shard resident
    loads at snapshot time, else they come from the registry's
    ``shard_edges_active`` series that a sharded replay writes; ``service``
    (a ``WalkService``) refreshes queue depth and latency percentiles from
    its live stats view.
    """
    reg = registry if registry is not None else get_registry()

    ingested = int(reg.sum_values("stream_edges_ingested_total"))
    late = int(reg.value("drops_total", labels={"kind": "ingest_late"},
                         default=0))
    overflow = int(reg.value("drops_total",
                             labels={"kind": "window_overflow"}, default=0))
    evicted = late + overflow
    ingest = {
        "batches": int(reg.sum_values("stream_batches_total")),
        "edges_ingested": ingested,
        "edges_active": int(reg.value("window_edges_active", default=0)),
        "stage_seconds": _hist_summary(reg, "stage_seconds"),
    }
    window = {
        "occupancy": float(reg.value("window_occupancy", default=0.0)),
        "t_now": int(reg.value("window_t_now", default=0)),
        "eviction_rate": (evicted / ingested) if ingested else 0.0,
    }

    if engine is not None and hasattr(engine, "shard_loads"):
        loads = np.asarray(engine.shard_loads(), dtype=np.int64)
        per_shard = {str(d): int(v) for d, v in enumerate(loads)}
    else:
        per_shard = {k: int(v) for k, v in sorted(
            _series_by_label(reg, "shard_edges_active", "shard").items())}
    if per_shard:
        vals = np.asarray(list(per_shard.values()), dtype=np.float64)
        mean = float(vals.mean())
        drift = float((vals.max() - mean) / mean) if mean else 0.0
    else:
        drift = 0.0
    shards = {"edges_active": per_shard, "load_drift": drift}

    dispatch = {
        "walks_by_path": {k: int(v) for k, v in sorted(_series_by_label(
            reg, "walks_dispatched_total", "path").items())},
        "lane_claims_by_shard": {k: int(v) for k, v in sorted(
            _series_by_label(reg, "serve_lane_claims_total",
                             "shard").items())},
    }

    lat = _hist_summary(reg, "serve_latency_seconds")
    serving = {
        "submitted": int(reg.sum_values("serve_submitted_total")),
        "completed": int(reg.sum_values("serve_completed_total")),
        "batches": int(reg.sum_values("serve_batches_total")),
        "queue_depth": int(reg.value("serve_queue_depth", default=0)),
        "latency": lat,
    }
    if service is not None:
        serving["queue_depth"] = int(service.pending_count)
        if len(service.stats.latencies_s):
            serving["latency"] = {
                "count": service.stats.latencies_s.count,
                "p50_s": service.stats.latency_percentile(50),
                "p99_s": service.stats.latency_percentile(99),
            }

    doc = {
        "schema": HEALTH_SCHEMA,
        "generated_unix_s": time.time(),
        "ingest": ingest,
        "window": window,
        "shards": shards,
        "dispatch": dispatch,
        "serving": serving,
        "drops": DropCounters.from_registry(reg).as_dict(),
    }
    validate_health(doc)
    return doc


def validate_health(doc: dict) -> dict:
    """Validate a ``tempest-health/v1`` document; returns it on success."""
    if not isinstance(doc, dict):
        _fail("document is not an object")
    if doc.get("schema") != HEALTH_SCHEMA:
        _fail(f"schema tag {doc.get('schema')!r} != {HEALTH_SCHEMA!r}")
    for section in ("ingest", "window", "shards", "dispatch", "serving",
                    "drops"):
        if not isinstance(doc.get(section), dict):
            _fail(f"section {section!r} missing or not an object")
    for field in ("batches", "edges_ingested", "edges_active"):
        if not isinstance(doc["ingest"].get(field), int):
            _fail(f"ingest.{field} missing or not an integer")
    for field in ("occupancy", "eviction_rate"):
        if not isinstance(doc["window"].get(field), (int, float)):
            _fail(f"window.{field} missing or not a number")
    if not isinstance(doc["shards"].get("edges_active"), dict):
        _fail("shards.edges_active missing or not an object")
    drops = doc["drops"]
    for kind in DROP_KINDS + ("total",):
        if not isinstance(drops.get(kind), int):
            _fail(f"drops.{kind} missing or not an integer")
    return doc


def dump_health(path: str, registry: Optional[MetricsRegistry] = None, *,
                engine=None, service=None) -> dict:
    """Write a validated health snapshot to ``path``; returns the doc."""
    doc = health_snapshot(registry, engine=engine, service=service)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return doc


# ---------------------------------------------------------------------------
# Benchmark artifact schema (one shape for every BENCH_*.json)
# ---------------------------------------------------------------------------


def bench_doc(suite: str, rows: Optional[List[dict]] = None, *,
              config: Optional[dict] = None,
              results: Optional[dict] = None) -> dict:
    """Build a ``tempest-bench/v1`` document from a suite's emitted rows;
    ``config`` gains ``"backend": BACKEND``."""
    doc: dict = {
        "schema": BENCH_SCHEMA,
        "suite": suite,
        "rows": list(rows or []),
        "config": {**(config or {}), "backend": BACKEND},
    }
    if results is not None:
        doc["results"] = results
    validate_bench(doc)
    return doc


def validate_bench(doc: dict) -> dict:
    """Validate a ``tempest-bench/v1`` document; returns it on success."""
    if not isinstance(doc, dict):
        _fail("document is not an object")
    if doc.get("schema") != BENCH_SCHEMA:
        _fail(f"schema tag {doc.get('schema')!r} != {BENCH_SCHEMA!r}")
    if not isinstance(doc.get("suite"), str) or not doc["suite"]:
        _fail("suite missing or not a non-empty string")
    rows = doc.get("rows")
    if not isinstance(rows, list):
        _fail("rows missing or not a list")
    for i, row in enumerate(rows):
        if not isinstance(row, dict):
            _fail(f"rows[{i}] is not an object")
        if not isinstance(row.get("name"), str):
            _fail(f"rows[{i}].name missing or not a string")
        us = row.get("us_per_call")
        if not isinstance(us, (int, float)) or (
                isinstance(us, float) and math.isnan(us)):
            _fail(f"rows[{i}].us_per_call missing or not a finite number")
        if not isinstance(row.get("derived", ""), str):
            _fail(f"rows[{i}].derived is not a string")
    for opt in ("config", "results"):
        if opt in doc and not isinstance(doc[opt], dict):
            _fail(f"{opt} is not an object")
    return doc
