"""Unified metrics registry (DESIGN.md §16), the PyTorch port's copy of
repro/obs/registry.py (plain Python and numpy).

One process-wide home for every counter the system used to scatter across
ad-hoc structs (``StreamStats``, ``ReplayStats``, ``ServeStats``,
``scheduler.dispatch_stats``): named **counters** (monotonic totals),
**gauges** (last-written level) and **histograms** (bounded ring-buffer
reservoirs, see ``Reservoir``) with label support, e.g.::

    reg = get_registry()
    reg.inc("walks_dispatched_total", 2048, labels={"path": "fused"})
    reg.set_gauge("window_edges_active", 53_241)
    reg.observe("serve_latency_seconds", 0.0031)

Naming scheme (validated): ``snake_case`` matching ``[a-z][a-z0-9_]*``;
counters end in ``_total``, time histograms in ``_seconds``. A metric
name owns ONE kind for the registry's lifetime — re-registering it as a
different kind raises, so the exposition formats (obs/export.py) never
see a name flip types.

The registry is host-side and cheap (dict + lock): callers write to it at
points where the host already holds the values, never by reading the
device for it.

``DropCounters`` is the consolidated drop taxonomy: every place the
system sheds work (serving queue backpressure, oversize queries, sharded
ingest exchange clips, walk-slot overflow, reshard clips, window
late/capacity drops) publishes into the single ``drops_total{kind=...}``
family, and ``DropCounters.from_registry`` reads them back as one view.
"""
from __future__ import annotations

import re
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

# Shared reservoir bound: the latency/batch histograms (and the
# ``ServeStats`` views on top of them) keep at most this many recent
# observations, so a long-running service neither grows without bound nor
# pays O(history) per percentile read.
RESERVOIR_SIZE = 65536

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

LabelDict = Optional[Dict[str, object]]
LabelKey = Tuple[Tuple[str, str], ...]


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name or ""):
        raise ValueError(
            f"metric name {name!r} violates the naming scheme "
            f"(snake_case, [a-z][a-z0-9_]*; DESIGN.md §16)")
    return name


def _label_key(labels: LabelDict) -> LabelKey:
    if not labels:
        return ()
    for k in labels:
        _check_name(k)
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Reservoir:
    """Bounded ring-buffer sample reservoir (the histogram backing store).

    Keeps the most recent ``capacity`` observations in insertion order
    (oldest first once wrapped); ``count``/``total`` are lifetime
    accumulators, unaffected by eviction. Deque-compatible surface
    (``append``/``__len__``/``__iter__``/``__array__``) so it can sit
    behind existing stats fields like ``ServeStats.latencies_s``.

    Percentile contract (tested in tests/test_obs.py):
    * empty reservoir  -> ``nan`` for every q
    * single sample    -> that sample for every q
    * q outside [0, 100] -> ``ValueError``
    """

    __slots__ = ("capacity", "_buf", "_idx", "count", "total")

    def __init__(self, capacity: int = RESERVOIR_SIZE):
        if capacity <= 0:
            raise ValueError(f"reservoir capacity must be > 0 (got {capacity})")
        self.capacity = int(capacity)
        self._buf: List[float] = []
        self._idx = 0
        self.count = 0          # lifetime observations
        self.total = 0.0        # lifetime sum

    def add(self, value: float) -> None:
        v = float(value)
        if len(self._buf) < self.capacity:
            self._buf.append(v)
        else:
            self._buf[self._idx] = v
            self._idx = (self._idx + 1) % self.capacity
        self.count += 1
        self.total += v

    # deque-compatible alias: existing call sites do ``.append(x)``
    append = add

    def values(self) -> List[float]:
        """Retained samples, oldest first."""
        if len(self._buf) < self.capacity:
            return list(self._buf)
        return self._buf[self._idx:] + self._buf[:self._idx]

    def percentile(self, q: float) -> float:
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q must be in [0, 100] (got {q})")
        if not self._buf:
            return float("nan")
        return float(np.percentile(np.asarray(self._buf, dtype=np.float64), q))

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self):
        return iter(self.values())

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.values(), dtype=dtype or np.float64)

    def __repr__(self) -> str:
        return (f"Reservoir(capacity={self.capacity}, retained={len(self)}, "
                f"count={self.count})")


class Counter:
    """Monotonic counter. ``inc`` rejects negative increments."""

    kind = "counter"
    __slots__ = ("value", "written")

    def __init__(self):
        self.value = 0
        self.written = False

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0 (got {n})")
        self.value += n
        self.written = True


class Gauge:
    """Last-written level (can move both ways)."""

    kind = "gauge"
    __slots__ = ("value", "written")

    def __init__(self):
        self.value = 0.0
        self.written = False

    def set(self, v: float) -> None:
        self.value = v
        self.written = True

    def inc(self, n: float = 1) -> None:
        self.set(self.value + n)

    def dec(self, n: float = 1) -> None:
        self.set(self.value - n)


class Histogram:
    """Reservoir-backed distribution (p50/p99 reads, lifetime count/sum)."""

    kind = "histogram"
    __slots__ = ("reservoir", "written")

    def __init__(self, reservoir_size: int = RESERVOIR_SIZE):
        self.reservoir = Reservoir(reservoir_size)
        self.written = False

    def observe(self, v: float) -> None:
        self.reservoir.add(v)
        self.written = True

    @property
    def count(self) -> int:
        return self.reservoir.count

    @property
    def sum(self) -> float:
        return self.reservoir.total

    def percentile(self, q: float) -> float:
        return self.reservoir.percentile(q)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """All label-series of one metric name (one kind, one help string)."""

    __slots__ = ("name", "kind", "help", "series")

    def __init__(self, name: str, kind: str, help: str = ""):
        self.name = name
        self.kind = kind
        self.help = help
        self.series: Dict[LabelKey, object] = {}

    @property
    def written(self) -> bool:
        return any(s.written for s in self.series.values())


class MetricsRegistry:
    """Named metric families with label support (thread-safe).

    ``counter``/``gauge``/``histogram`` return the instrument for a
    (name, labels) pair, creating it on first use; ``inc``/``set_gauge``/
    ``observe`` are the one-line conveniences the instrumented call sites
    use. ``families()`` snapshots everything for the exporters.
    """

    def __init__(self):
        self._families: Dict[str, Family] = {}
        self._lock = threading.Lock()

    # -- instrument access -------------------------------------------------

    def _get(self, name: str, kind: str, labels: LabelDict, help: str,
             **kwargs):
        _check_name(name)
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, kind, help)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"requested {kind}")
            elif help and not fam.help:
                fam.help = help
            inst = fam.series.get(key)
            if inst is None:
                inst = _KINDS[kind](**kwargs)
                fam.series[key] = inst
            return inst

    def counter(self, name: str, labels: LabelDict = None,
                help: str = "") -> Counter:
        return self._get(name, "counter", labels, help)

    def gauge(self, name: str, labels: LabelDict = None,
              help: str = "") -> Gauge:
        return self._get(name, "gauge", labels, help)

    def histogram(self, name: str, labels: LabelDict = None, help: str = "",
                  reservoir_size: int = RESERVOIR_SIZE) -> Histogram:
        return self._get(name, "histogram", labels, help,
                         reservoir_size=reservoir_size)

    # -- one-line write conveniences ---------------------------------------

    def inc(self, name: str, n: float = 1, labels: LabelDict = None,
            help: str = "") -> None:
        self.counter(name, labels, help).inc(n)

    def set_gauge(self, name: str, v: float, labels: LabelDict = None,
                  help: str = "") -> None:
        self.gauge(name, labels, help).set(v)

    def observe(self, name: str, v: float, labels: LabelDict = None,
                help: str = "") -> None:
        self.histogram(name, labels, help).observe(v)

    # -- read side ---------------------------------------------------------

    def families(self) -> List[Family]:
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)

    def get_family(self, name: str) -> Optional[Family]:
        with self._lock:
            return self._families.get(name)

    def value(self, name: str, labels: LabelDict = None, default=None):
        """Current value of a counter/gauge series (None when absent)."""
        fam = self.get_family(name)
        if fam is None:
            return default
        inst = fam.series.get(_label_key(labels))
        if inst is None:
            return default
        return inst.value

    def sum_values(self, name: str) -> float:
        """Sum of a counter/gauge family over all label series (0 absent)."""
        fam = self.get_family(name)
        if fam is None:
            return 0
        return sum(s.value for s in fam.series.values())

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._families)

    def written_names(self) -> set:
        """Family names with at least one written (non-default) series."""
        return {f.name for f in self.families() if f.written}

    def reset(self) -> None:
        with self._lock:
            self._families.clear()


# ---------------------------------------------------------------------------
# Default process registry
# ---------------------------------------------------------------------------

_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-default registry (engines/services fall back to it)."""
    return _DEFAULT


def new_registry() -> MetricsRegistry:
    """A fresh isolated registry (tests, one per tenant)."""
    return MetricsRegistry()


# ---------------------------------------------------------------------------
# Consolidated drop taxonomy (DESIGN.md §16)
# ---------------------------------------------------------------------------

# Every loss path in the system, one canonical kind each. Publishers use
# ``count_drop``; the single ``drops_total{kind=...}`` family replaces the
# three incompatible homes drops used to live in (`exchange_drops`,
# `shard_walk_drops`, `dropped_backpressure`).
DROP_KINDS = (
    "queue_backpressure",    # serve: submit queue at capacity
    "oversize",              # serve: query exceeds largest shape bucket
    "deadline_expired",      # serve: queued query evicted past its deadline
    "exchange_clip",         # sharded ingest: all_to_all bucket overflow
    "walk_slot_overflow",    # sharded walks/lanes: slot or bucket overflow
    "reshard_clip",          # live reshard: per-shard capacity clip
    "ingest_late",           # window: edge older than the eviction cutoff
    "window_overflow",       # window: capacity eviction of in-window edges
)

DROPS_METRIC = "drops_total"


def count_drop(registry: MetricsRegistry, kind: str, n: float = 1) -> None:
    """Publish ``n`` drops of ``kind`` into the canonical taxonomy."""
    if kind not in DROP_KINDS:
        raise ValueError(f"unknown drop kind {kind!r}; known: {DROP_KINDS}")
    if n:
        registry.inc(DROPS_METRIC, n, labels={"kind": kind},
                     help="work shed, by canonical drop kind")


@dataclass(frozen=True)
class DropCounters:
    """One read-side view over the whole drop taxonomy."""

    queue_backpressure: int = 0
    oversize: int = 0
    deadline_expired: int = 0
    exchange_clip: int = 0
    walk_slot_overflow: int = 0
    reshard_clip: int = 0
    ingest_late: int = 0
    window_overflow: int = 0

    @classmethod
    def from_registry(cls, registry: MetricsRegistry) -> "DropCounters":
        vals = {}
        for kind in DROP_KINDS:
            vals[kind] = int(registry.value(
                DROPS_METRIC, labels={"kind": kind}, default=0))
        return cls(**vals)

    @property
    def total(self) -> int:
        return sum(getattr(self, k) for k in DROP_KINDS)

    def as_dict(self) -> Dict[str, int]:
        d = {k: getattr(self, k) for k in DROP_KINDS}
        d["total"] = self.total
        return d
