"""Classified solve failures: one exception taxonomy, one exit-code contract.

The port's own copy of ``poisson_ellipse_tpu.resilience.errors``: the same
classes, tags and exit codes, so a caller of either package (and the
command line of either) classifies a failure the same way:

  ========  ======================  =========================================
  exit      class                   meaning
  ========  ======================  =========================================
  2         DivergedError           recovery ladder exhausted: persistent
                                    breakdown / NaN poisoning / stagnation
  3         OutOfMemoryError        device memory exhausted with no engine
                                    left to degrade to
  4         SolveTimeout            ``--timeout`` deadline passed at a chunk
                                    boundary (partial trace artifact emitted)
  5         AdmissionRejected       the serving layer shed the request at
                                    admission; carries ``retry_after_s``
  6         SilentCorruptionError   the ABFT checks saw silent data
                                    corruption a rollback could not clear
  7         DeviceLossError         a mesh device was lost and no degraded
                                    mesh remains to resume on
  8         InvalidGeometryError    the geometry admissibility gate rejected
                                    the problem before any device loop ran
  9         FleetUnavailableError   every replica of the serving fleet is
                                    dead or draining
  ========  ======================  =========================================

(exit 0 = converged, 1 = iteration cap reached without convergence, and 2
also covers invalid invocations.) Classes 5-9 and the lease-store errors
are raised by modules the port has not ported yet (serving, the mesh
guard, geometry, the fleet); they are here so the contract is whole.

:func:`classify_error` is the one place a device-runtime exception is
sniffed. On CUDA an allocation that does not fit raises
``torch.OutOfMemoryError`` ("CUDA out of memory"); the JAX runtime's
spellings are kept beside it. Two kinds of failure classify as
``unknown`` whatever their message says, because no retry and no engine
fallback can fix them and a fallback would hide them: a kernel that does
not build (``ops/_build.py``, nvcc) and a sticky CUDA error (an illegal
memory access, a launch failure), after which the process's CUDA context
is unusable.
"""

from __future__ import annotations

import torch

EXIT_DIVERGED = 2
EXIT_OOM = 3
EXIT_TIMEOUT = 4
EXIT_SHED = 5
EXIT_SDC = 6
EXIT_DEVICE_LOSS = 7
EXIT_INVALID_GEOMETRY = 8
EXIT_FLEET_UNAVAILABLE = 9


class SolveError(RuntimeError):
    """Base of the classified solve failures.

    ``classification`` is the stable machine-readable tag used in trace
    events and JSON reports; ``exit_code`` the contracted process exit.
    ``iters`` is the last healthy iteration count the guard reached.
    """

    classification = "error"
    exit_code = 1

    def __init__(self, message: str, iters: int | None = None):
        super().__init__(message)
        self.iters = iters


class DivergedError(SolveError):
    """Recovery ladder exhausted: the solve keeps producing breakdown,
    non-finite iterates, or no progress past ``max_recoveries``."""

    classification = "diverged"
    exit_code = EXIT_DIVERGED


class OutOfMemoryError(SolveError):
    """Device memory exhausted with no smaller engine left on the
    capacity ladder to degrade to."""

    classification = "oom"
    exit_code = EXIT_OOM


class SolveTimeout(SolveError):
    """The per-solve deadline passed. Raised only at chunk boundaries:
    the in-flight chunk completes, so the carry the guard holds and the
    trace events already written stay consistent."""

    classification = "timeout"
    exit_code = EXIT_TIMEOUT


class AdmissionRejected(SolveError):
    """The serving layer refused the request at admission (queue full, or
    the projected wait overruns its deadline); safe to resubmit after
    ``retry_after_s``."""

    classification = "shed"
    exit_code = EXIT_SHED

    def __init__(self, message: str, retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class SilentCorruptionError(SolveError):
    """The ABFT checks caught silent data corruption that re-fired from a
    clean carry after a rollback-and-rerun: a persistent source. Raised
    instead of returning an iterate the corruption may have touched."""

    classification = "sdc"
    exit_code = EXIT_SDC


class DeviceLossError(SolveError):
    """A mesh device was lost and the degraded-mesh ladder has nowhere
    left to go."""

    classification = "device-loss"
    exit_code = EXIT_DEVICE_LOSS


class InvalidGeometryError(SolveError):
    """The geometry admissibility gate classified the problem as
    unsolvable as stated, before any device loop ran; ``reason`` is the
    machine-readable sub-tag (``malformed-spec``, ``sdf-nonfinite``,
    ``empty-domain``, ``under-resolved``, ``boundary-contact``,
    ``operator-nonfinite``, ``operator-not-m-matrix``,
    ``operator-asymmetric``, ``operator-not-spd``)."""

    classification = "invalid-geometry"
    exit_code = EXIT_INVALID_GEOMETRY

    def __init__(self, message: str, reason: str = "invalid"):
        super().__init__(message)
        self.reason = reason


class FleetUnavailableError(SolveError):
    """Every scheduler replica of the serving fleet is down: refused now
    with a ``retry_after_s`` hint, never parked on a queue no replica
    will drain."""

    classification = "fleet-unavailable"
    exit_code = EXIT_FLEET_UNAVAILABLE

    def __init__(self, message: str, retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class LeaseStoreError(RuntimeError):
    """Base of the lease-store failures: infrastructure errors the fleet
    router turns into :class:`FleetUnavailableError` or deferred work,
    never raised to a caller."""

    classification = "lease-store"


class LeaseStoreOutageError(LeaseStoreError):
    """The lease store is unreachable; unexpired leases keep serving."""

    classification = "lease-store-outage"


class LeaseStoreCorruptError(LeaseStoreError):
    """The persisted lease-store state failed to parse: classified loudly
    instead of re-initialising the epoch table (which would let a fenced
    replica's stale token validate again)."""

    classification = "lease-store-corrupt"


# the JAX runtime's spellings of memory exhaustion, and CUDA's ("CUDA out
# of memory", cudaErrorMemoryAllocation's "out of memory"); matched
# case-sensitively
_OOM_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "Out of memory",
    "out of memory",
    "exceeds the memory capacity",
    "Attempting to allocate",
)

# failures no retry or engine fallback can fix, whatever else their text
# says: a kernel that did not build or launch (ops/_build.py; a launch
# refused for memory reads "CUDA launch failed (2: out of memory)"), a
# whole-solve kernel that did not run to its end (ops/whole_solve.py), and
# the sticky CUDA errors that leave the context unusable
_LOUD_MARKERS = (
    "kernel build failed",
    "nvcc not found",
    "CUDA launch failed",
    "the kernel did not run to its end",
    "illegal memory access",
    "unspecified launch failure",
    "misaligned address",
    "illegal instruction",
    "device-side assert",
)


def _is_loud_error(exc: BaseException) -> bool:
    """True for a kernel build or launch failure or a sticky CUDA
    error."""
    text = str(exc)
    return any(marker in text for marker in _LOUD_MARKERS)


def is_oom_error(exc: BaseException) -> bool:
    """True when ``exc`` is a device memory-exhaustion failure."""
    if isinstance(exc, (OutOfMemoryError, torch.OutOfMemoryError,
                        MemoryError)):
        return True
    if _is_loud_error(exc):
        return False
    text = str(exc)
    return any(marker in text for marker in _OOM_MARKERS)


# the runtime's spellings of a device that died under a dispatch; the
# injected faultinject.SimulatedDeviceLoss carries the first verbatim
_DEVICE_LOSS_MARKERS = (
    "DEVICE_LOST",
    "device is in an error state",
    "Device or resource busy",
    "DATA_LOSS",
)


def is_device_loss_error(exc: BaseException) -> bool:
    """True when ``exc`` reads as a lost device under a dispatch."""
    if isinstance(exc, DeviceLossError):
        return True
    text = str(exc)
    return any(marker in text for marker in _DEVICE_LOSS_MARKERS)


def classify_error(exc: BaseException) -> str:
    """The classification tag of an exception out of a solve dispatch:
    ``oom`` / ``device-loss`` (classified errors keep their own tag), or
    ``unknown`` for everything else, a kernel build or launch failure and
    a sticky CUDA error included. An unknown is never retried."""
    if isinstance(exc, SolveError):
        return exc.classification
    if isinstance(exc, LeaseStoreError):
        return exc.classification
    if _is_loud_error(exc):
        return "unknown"
    if is_oom_error(exc):
        return "oom"
    if is_device_loss_error(exc):
        return "device-loss"
    return "unknown"
