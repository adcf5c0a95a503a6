"""Span-based stage tracing (DESIGN.md §16), PyTorch port of
repro/obs/tracing.py.

``span(stage)`` is a context manager around one host-observable pipeline
stage — ingest merge, snapshot publish, coalesce, dispatch, result
slicing — that records the stage's wall time into the registry
(``stage_seconds{stage=...}`` histogram + ``stage_calls_total`` counter)
and, under ``torch.profiler``, marks the span as
``record_function("obs:<stage>")`` so host stages line up with the
device's kernels in the trace::

    with span("ingest_merge", registry=reg):
        state = ingest(state, batch, nc)

The wall time is the host's: device work the body enqueued and did not
wait for is not in it. Spans nest freely.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Iterator, Optional

from torch.profiler import record_function

from repro_torch.obs.registry import MetricsRegistry, get_registry

STAGE_METRIC = "stage_seconds"
STAGE_CALLS_METRIC = "stage_calls_total"


class Span:
    """Handle yielded by ``span``; ``elapsed_s`` is set on exit."""

    __slots__ = ("stage", "elapsed_s")

    def __init__(self, stage: str):
        self.stage = stage
        self.elapsed_s: float = 0.0


@contextmanager
def span(stage: str, registry: Optional[MetricsRegistry] = None,
         labels: Optional[dict] = None,
         annotate: bool = True) -> Iterator[Span]:
    """Time one pipeline stage into the registry (and the profiler trace).

    ``labels`` merge into the ``stage_seconds`` series key beside the
    stage name; ``annotate=False`` skips the profiler mark. The stage
    time is recorded even when the body raises.
    """
    reg = registry if registry is not None else get_registry()
    handle = Span(stage)
    lab = {"stage": stage}
    if labels:
        lab.update(labels)
    t0 = time.perf_counter()
    try:
        if annotate:
            with record_function(f"obs:{stage}"):
                yield handle
        else:
            yield handle
    finally:
        handle.elapsed_s = time.perf_counter() - t0
        reg.observe(STAGE_METRIC, handle.elapsed_s, labels=lab,
                    help="host wall time per pipeline stage")
        reg.inc(STAGE_CALLS_METRIC, 1, labels=lab,
                help="invocations per pipeline stage")
