"""Observability (DESIGN.md §16), PyTorch port: the host-side metrics
registry with the consolidated ``drops_total{kind=...}`` taxonomy, and
``span(stage)`` tracing. The reference's device probe vectors and
exporters (obs/probes.py, obs/export.py) are not yet ported."""
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
from repro_torch.obs.tracing import Span, span  # noqa: F401
