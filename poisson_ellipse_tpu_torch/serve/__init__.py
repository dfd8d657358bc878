"""serve — the continuous-batching serving front-end on one device.

The counterpart of ``poisson_ellipse_tpu.serve``: an async request
scheduler that packs queued requests into the warm-pool grid/lane buckets
and **retires and refills lanes at chunk boundaries** — the in-loop
freeze-out mask of ``batch.batched_pcg`` generalized to swap-in. Around
it, the robustness envelope a service needs: bounded admission with
backpressure and load-shedding (:mod:`.queue`), per-request deadlines
enforced at chunk granularity, a retry budget walking the resilience
degradation ladder (:mod:`.scheduler`), a crash-safe temp-then-rename
request journal with restart replay (:mod:`.journal`), classified
terminal outcomes mapped onto the exit-code contract (:mod:`.request`),
and a seeded chaos harness that proves zero-lost / zero-double /
all-classified under injected faults and kills (:mod:`.chaos`). Every
lifecycle transition is a request-addressed ``obs.trace`` event (schema
v3) and an ``obs.metrics`` series.
"""

from poisson_ellipse_tpu_torch.serve.chaos import ChaosReport, run_chaos
from poisson_ellipse_tpu_torch.serve.journal import (
    DoubleCompletionError,
    RequestJournal,
)
from poisson_ellipse_tpu_torch.serve.queue import AdmissionQueue
from poisson_ellipse_tpu_torch.serve.request import (
    EXIT_BY_OUTCOME,
    OUTCOMES,
    ServeRequest,
    ServeResult,
)
from poisson_ellipse_tpu_torch.serve.scheduler import Scheduler

__all__ = [
    "AdmissionQueue",
    "ChaosReport",
    "DoubleCompletionError",
    "EXIT_BY_OUTCOME",
    "OUTCOMES",
    "RequestJournal",
    "Scheduler",
    "ServeRequest",
    "ServeResult",
    "run_chaos",
]
