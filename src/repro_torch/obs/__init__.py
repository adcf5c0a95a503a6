"""Observability (DESIGN.md §16), PyTorch port of repro/obs:

* ``registry`` — the host-side metrics registry with the consolidated
  ``drops_total{kind=...}`` taxonomy;
* ``probes`` — fixed-slot int32 stat vectors updated on the device and
  flushed into the registry at an existing host sync;
* ``tracing`` — ``span(stage)`` around host pipeline stages;
* ``export`` — Prometheus text, ``tempest-obs/v1`` JSON snapshots,
  ``tempest-health/v1`` health dumps and the ``tempest-bench/v1`` schema.
"""
from repro_torch.obs.registry import (  # noqa: F401
    DROP_KINDS,
    DROPS_METRIC,
    RESERVOIR_SIZE,
    Counter,
    DropCounters,
    Family,
    Gauge,
    Histogram,
    MetricsRegistry,
    Reservoir,
    count_drop,
    get_registry,
    new_registry,
)
from repro_torch.obs.probes import (  # noqa: F401
    NUM_REPLAY_PROBES,
    NUM_SERVE_PROBES,
    RP_BATCHES,
    RP_EDGES_INGESTED,
    RP_EXCHANGE_DROPS,
    RP_HOPS,
    RP_LATE_DROPS,
    RP_OVERFLOW_DROPS,
    RP_WALK_DROPS,
    RP_WALKS_EMITTED,
    SP_HOPS,
    SP_LANES_CLAIMED,
    SP_WALK_DROPS,
    flush_replay_probes,
    flush_serve_probes,
    replay_probe_update,
    replay_probe_zeros,
    serve_probe_zeros,
)
from repro_torch.obs.tracing import Span, span  # noqa: F401
from repro_torch.obs.export import (  # noqa: F401
    BACKEND,
    BENCH_SCHEMA,
    HEALTH_SCHEMA,
    OBS_SCHEMA,
    bench_doc,
    dump_health,
    export_json,
    health_snapshot,
    to_prometheus,
    validate_bench,
    validate_health,
    validate_snapshot,
)
