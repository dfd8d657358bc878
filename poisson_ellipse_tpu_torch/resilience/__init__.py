"""resilience — guarded solves, classified failures, fault injection,
silent-corruption detection, degraded-mesh recovery.

The port's counterpart of ``poisson_ellipse_tpu.resilience``:

- :mod:`.guard` — ``guarded_solve``: a loop engine's bodies in chunks with
  one device-side health word a chunk (breakdown / NaN-Inf / stagnation),
  and the recovery ladder (true residual restart, storage promotion,
  f64 escalation, engine fallback), capped by ``max_recoveries`` and
  classified on exhaustion; the whole-solve engines guarded down the
  capacity ladder.
- :mod:`.errors` — the ``SolveError`` taxonomy and the exit-code
  contract (2 diverged, 3 oom, 4 timeout, … 9), and the one place a
  device-runtime exception is classified.
- :mod:`.faultinject` — deterministic fault injection at exact
  iterations (on a mesh too: halo bit flips on the owning rank, sign-
  flipped reductions, lost ranks, stragglers), the shrunken on-chip
  budget (``simulated_vmem``) and the checkpoint truncation.
- :mod:`.abft` — the mesh's silent-corruption checks, their partials
  riding the loops' existing reductions, answered by rollback and re-run;
  persistent corruption raises ``SilentCorruptionError`` (exit 6).
- :mod:`.meshguard` — rank loss and stragglers detected at chunk
  boundaries, the mesh shrunk over the survivors, the last durable
  checkpoint resharded and resumed (``elastic_solve``; exhaustion raises
  ``DeviceLossError``, exit 7).
"""

from poisson_ellipse_tpu_torch.resilience.errors import (
    EXIT_DEVICE_LOSS,
    EXIT_DIVERGED,
    EXIT_FLEET_UNAVAILABLE,
    EXIT_OOM,
    EXIT_SDC,
    EXIT_TIMEOUT,
    DeviceLossError,
    DivergedError,
    FleetUnavailableError,
    OutOfMemoryError,
    SilentCorruptionError,
    SolveError,
    SolveTimeout,
    classify_error,
    is_device_loss_error,
    is_oom_error,
)
from poisson_ellipse_tpu_torch.resilience.faultinject import (
    Fault,
    FaultPlan,
    corrupt_halo,
    device_loss,
    force_breakdown,
    halo_bitflip,
    inject_nan,
    inject_stagnation,
    lease_clock_skew,
    psum_corrupt,
    replica_hang,
    replica_kill,
    simulate_oom,
    simulated_vmem,
    straggler,
    truncate_latest_checkpoint,
)
from poisson_ellipse_tpu_torch.resilience.guard import (
    HEALTH_BREAKDOWN,
    HEALTH_CONVERGED,
    HEALTH_NONFINITE,
    HEALTH_SDC,
    HEALTH_STAGNATION,
    GuardedResult,
    RecoveryEvent,
    guarded_solve,
    health_name,
)
from poisson_ellipse_tpu_torch.resilience.meshguard import (
    ElasticResult,
    MeshEvent,
    elastic_solve,
)

__all__ = [
    "DeviceLossError",
    "ElasticResult",
    "EXIT_DEVICE_LOSS",
    "EXIT_DIVERGED",
    "EXIT_FLEET_UNAVAILABLE",
    "EXIT_OOM",
    "EXIT_SDC",
    "EXIT_TIMEOUT",
    "DivergedError",
    "Fault",
    "FaultPlan",
    "FleetUnavailableError",
    "GuardedResult",
    "HEALTH_BREAKDOWN",
    "HEALTH_CONVERGED",
    "HEALTH_NONFINITE",
    "HEALTH_SDC",
    "HEALTH_STAGNATION",
    "MeshEvent",
    "OutOfMemoryError",
    "RecoveryEvent",
    "SilentCorruptionError",
    "SolveError",
    "SolveTimeout",
    "classify_error",
    "corrupt_halo",
    "device_loss",
    "elastic_solve",
    "force_breakdown",
    "guarded_solve",
    "halo_bitflip",
    "health_name",
    "inject_nan",
    "inject_stagnation",
    "is_device_loss_error",
    "is_oom_error",
    "lease_clock_skew",
    "psum_corrupt",
    "replica_hang",
    "replica_kill",
    "simulate_oom",
    "simulated_vmem",
    "straggler",
    "truncate_latest_checkpoint",
]
