"""obs — the observability layer (the counterpart of
``poisson_ellipse_tpu.obs``).

- :mod:`.convergence` — the on-device per-iteration history (zr / diff /
  α / β): a ring preallocated on the solve's device and written at the
  device-side iteration counter, surfaced as ``history=True`` on the
  ``xla``, ``pallas``, ``fused``, ``pipelined`` and ``pipelined-pallas``
  engines and on the classical mesh.
- :mod:`.trace` + :mod:`.metrics` + :mod:`.export` — dependency-free
  JSONL run tracing (schema v3, the JAX package's, so one validator reads
  both) behind ``--trace FILE`` / ``POISSON_TRACE=``, counters, gauges and
  histograms, and their OpenMetrics snapshot (``--metrics FILE``);
  ``utils.timing.PhaseTimer`` emits its phases as spans.
- :mod:`.spectrum` — Lanczos spectral diagnostics from the history: Ritz
  values, κ(M⁻¹A), the CG rate, predicted iterations, plateaus
  (``harness diagnose``).
- :mod:`.profile` — the build / compile / h2d / solve / d2h phases of one
  engine, fenced with CUDA events (``harness diagnose``).
- :mod:`.static_cost` — kernel launches and collectives a loop body,
  counted over a capped run, beside the roofline model's passes and bytes
  (``harness inspect``).

:mod:`.static_cost` and :mod:`.profile` import the solver engines, so
they are not imported here: the solver modules import this package.
"""

from poisson_ellipse_tpu_torch.obs.convergence import (
    HISTORY_FIELDS,
    ConvergenceTrace,
    history_init,
    history_record,
    trace_of,
)
from poisson_ellipse_tpu_torch.obs.export import (
    MetricsExporter,
    render_openmetrics,
)
from poisson_ellipse_tpu_torch.obs.metrics import (
    REGISTRY,
    Histogram,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
)
from poisson_ellipse_tpu_torch.obs.spectrum import (
    ritz_values,
    spectrum_report,
)
from poisson_ellipse_tpu_torch.obs.trace import (
    Tracer,
    event,
    note,
    span,
    start,
    stop,
)

__all__ = [
    "HISTORY_FIELDS",
    "ConvergenceTrace",
    "Histogram",
    "MetricsExporter",
    "MetricsRegistry",
    "REGISTRY",
    "Tracer",
    "counter",
    "event",
    "gauge",
    "histogram",
    "history_init",
    "history_record",
    "note",
    "render_openmetrics",
    "ritz_values",
    "span",
    "spectrum_report",
    "start",
    "stop",
    "trace_of",
]
