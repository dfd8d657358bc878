"""Counters, gauges and histograms: the trace stream's aggregate half.

A copy of ``poisson_ellipse_tpu.obs.metrics`` (pure Python).

The reference's five stage4 accumulators (``T_gpu/T_copy/T_mpi/T_prec/
T_dot``, ``poisson_mpi_cuda2.cu:696-700``) are exactly this shape — named
scalars incremented around work and printed once at the end. Here the
registry is generic (any subsystem can mint a counter or gauge), and
:meth:`MetricsRegistry.emit` publishes the whole registry into the
ambient JSONL trace as ``counter``/``gauge`` records, so the aggregates
land in the same machine-readable stream as the spans they summarise.

Counters and gauges are *host-side* state: incrementing one from inside
a loop body would be a host read per iteration (the stage-4 loop's
flaw). On-device per-iteration series belong to
:mod:`.convergence`; this module is for per-run aggregates.

:class:`Histogram` adds the latency-distribution kind (p50/p90/p99 over
a sliding window, lifetime count/sum); :mod:`.export` renders a
registry snapshot in the OpenMetrics text format for scrapers.
"""

from __future__ import annotations

import dataclasses
import threading

from poisson_ellipse_tpu_torch.obs import trace as _trace


@dataclasses.dataclass
class Counter:
    """A monotonically increasing named value."""

    name: str
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (inc({n}))")
        self.value += n


@dataclasses.dataclass
class Gauge:
    """A named value that holds its most recent observation."""

    name: str
    value: float | None = None

    def set(self, v: float) -> None:
        self.value = float(v)


# sliding-window cap per histogram: quantiles are computed over the most
# recent observations only, so a long-lived serving process stays O(1)
HISTOGRAM_WINDOW = 4096

HISTOGRAM_QUANTILES = (0.5, 0.9, 0.99)


@dataclasses.dataclass
class Histogram:
    """Latency-style observations with p50/p90/p99 quantiles.

    ``count``/``sum`` are lifetime totals; quantiles are nearest-rank
    over a sliding window of the last :data:`HISTOGRAM_WINDOW`
    observations (a bounded buffer — good enough for run reports and
    the OpenMetrics summary rendering, not a streaming sketch).
    """

    name: str
    count: int = 0
    sum: float = 0.0
    _window: list = dataclasses.field(default_factory=list)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self._window.append(v)
        if len(self._window) > HISTOGRAM_WINDOW:
            del self._window[: len(self._window) - HISTOGRAM_WINDOW]

    def quantile(self, q: float) -> float | None:
        """Nearest-rank quantile over the window (None when empty)."""
        if not self._window:
            return None
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        ordered = sorted(self._window)
        idx = min(int(q * len(ordered)), len(ordered) - 1)
        return ordered[idx]

    @property
    def window_occupancy(self) -> int:
        """Observations currently in the sliding window.

        The staleness guard: quantiles never age out by *time*, so a
        stalled server keeps publishing the p99 of whenever it last did
        work — identical, on the quantile samples alone, to a healthy
        quiet one. Occupancy rides next to the quantiles (snapshot
        ``window`` key, ``<name>_window`` OpenMetrics sample, a
        ``<name>_window`` gauge in the trace) so a scraper can pair a
        frozen p99 with a non-advancing lifetime ``count`` and flag the
        stall instead of trusting the latency.
        """
        return len(self._window)

    def summary(self) -> dict:
        """{"count", "sum", "p50", "p90", "p99", "window"} — the
        snapshot entry (``window`` = sliding-window occupancy, the
        staleness guard next to the quantiles it qualifies)."""
        out = {"count": self.count, "sum": self.sum}
        for q in HISTOGRAM_QUANTILES:
            out[f"p{int(q * 100)}"] = self.quantile(q)
        out["window"] = self.window_occupancy
        return out


class MetricsRegistry:
    """Create-or-get registry of counters and gauges.

    A name is permanently one kind: asking for ``counter("x")`` after
    ``gauge("x")`` is a programming error and raises, instead of silently
    shadowing one metric with another.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def _check_kind(self, name: str, want: str) -> None:
        for kind, table in (
            ("counter", self._counters),
            ("gauge", self._gauges),
            ("histogram", self._histograms),
        ):
            if kind != want and name in table:
                raise ValueError(f"{name!r} is already a {kind}")

    def counter(self, name: str) -> Counter:
        with self._lock:
            self._check_kind(name, "counter")
            return self._counters.setdefault(name, Counter(name))

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            self._check_kind(name, "gauge")
            return self._gauges.setdefault(name, Gauge(name))

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            self._check_kind(name, "histogram")
            return self._histograms.setdefault(name, Histogram(name))

    def snapshot(self) -> dict:
        """{"counters": {...}, "gauges": {...}, "histograms": {...}} —
        set gauges only (an unobserved gauge has nothing to report).

        Deterministic: every table is name-sorted, not creation-ordered,
        so two snapshots of the same state serialize identically and
        snapshot-derived artifacts (OpenMetrics files, trace records)
        diff cleanly across runs.
        """
        with self._lock:
            return {
                "counters": {
                    n: self._counters[n].value
                    for n in sorted(self._counters)
                },
                "gauges": {
                    n: self._gauges[n].value
                    for n in sorted(self._gauges)
                    if self._gauges[n].value is not None
                },
                "histograms": {
                    n: self._histograms[n].summary()
                    for n in sorted(self._histograms)
                    if self._histograms[n].count
                },
            }

    def emit(self, tracer=None) -> None:
        """Publish every metric into the JSONL trace (ambient tracer by
        default; silently nothing when tracing is inactive or the tracer
        is already closed — a late emit after ``trace.stop()`` must not
        raise on a closed file, it has nowhere to publish)."""
        tracer = tracer or _trace.active()
        if tracer is None or getattr(tracer, "closed", False):
            return
        snap = self.snapshot()
        for name, value in snap["counters"].items():
            tracer.emit("counter", name, value=value)
        for name, value in snap["gauges"].items():
            tracer.emit("gauge", name, value=value)
        for name, summary in snap["histograms"].items():
            # the closed record-kind set has no histogram kind: quantiles
            # publish as gauges, the lifetime count as a counter
            tracer.emit("counter", f"{name}_count", value=summary["count"])
            tracer.emit("gauge", f"{name}_sum", value=summary["sum"])
            # the staleness guard: window occupancy as its own gauge, so
            # a frozen p99 is distinguishable from a healthy quiet one
            tracer.emit("gauge", f"{name}_window", value=summary["window"])
            for q in HISTOGRAM_QUANTILES:
                key = f"p{int(q * 100)}"
                if summary[key] is not None:
                    tracer.emit("gauge", f"{name}_{key}", value=summary[key])

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


# the process-default registry (the harness and bench entry points use it)
REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


# -- the fleet vocabulary ----------------------------------------------------
#
# One spelling for the replicated-serving series (fleet.*), so dashboards,
# tests and the OpenMetrics snapshot agree on names:
#
#   fleet_queue_depth_r{i}       gauge      per-replica admission depth
#   fleet_in_flight_r{i}         gauge      per-replica laned requests
#   lease_expiry_total           counter    leases the router declared dead
#   fleet_handoff_total          counter    journal handoffs executed
#   fleet_handoff_requests_total counter    requests re-admitted by handoff
#   fleet_stale_writes_total     counter    fenced zombie writes rejected
#   handoff_latency_seconds      histogram  per-handoff journal→survivor time
#   fleet_rejoin_total           counter    dead replicas re-issued as fresh
#                                           incarnations (fleet survivability)
#   rejoin_latency_seconds       histogram  kill → first completed solve
#                                           delivered by the rejoined replica
#   fleet_starvation_total       counter    tenant-class starvation episodes
#                                           announced (serve.queue — loud,
#                                           never silent)

LEASE_EXPIRY_TOTAL = "lease_expiry_total"
FLEET_HANDOFF_TOTAL = "fleet_handoff_total"
FLEET_HANDOFF_REQUESTS_TOTAL = "fleet_handoff_requests_total"
FLEET_STALE_WRITES_TOTAL = "fleet_stale_writes_total"
HANDOFF_LATENCY_SECONDS = "handoff_latency_seconds"
FLEET_REJOIN_TOTAL = "fleet_rejoin_total"
REJOIN_LATENCY_SECONDS = "rejoin_latency_seconds"
FLEET_STARVATION_TOTAL = "fleet_starvation_total"


def replica_gauge(name: str, replica: int) -> Gauge:
    """The per-replica gauge ``<name>_r<replica>`` (flat names: the
    registry is label-free by design, so the replica index rides in the
    metric name exactly like the OpenMetrics snapshot renders it)."""
    return REGISTRY.gauge(f"{name}_r{replica}")
