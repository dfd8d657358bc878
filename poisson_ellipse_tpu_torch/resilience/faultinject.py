"""Deterministic fault injection: the recovery paths get exercised.

The port's own copy of ``poisson_ellipse_tpu.resilience.faultinject``:
the same fault kinds, constructors, plans and addressing, applied to the
port's carries (the NamedTuples of ``solver.pcg``, ``ops.pipelined_pcg``
and ``batch``). Every fault class the guard claims to survive can be
injected at an exact, reproducible iteration, with no randomness:

- ``nan``          poison a carry field (default ``r``) with NaN;
- ``breakdown``    raise the carry's breakdown flag;
- ``stagnation``   blow the classical carry's zr up to 1e30, or set the
                   pipelined carry's s = A·p to 1e12 (a drifted
                   recurrence that satisfies the stopping rule at a
                   garbage iterate: the false convergence the guard's
                   residual-drift check exists for);
- ``halo``         NaN a ``rows``-high slab of a field;
- ``oom``          raise a RESOURCE_EXHAUSTED-classified error where the
                   dispatch would;
- ``halo_bitflip`` flip one bit of one element (a view to the integer
                   dtype of the same width, int16 for bf16 and f16);
- ``psum_corrupt`` flip the sign of the carried (z, r);
- ``device_loss``  raise a DEVICE_LOST-classified error at a chunk
                   boundary, naming the lost rank (``resilience.meshguard``
                   shrinks the mesh past it);
- ``straggler``    sleep at the chunk boundary (the mesh guard's deadline
                   turns it into a degradation);
- the replica, lease-store, admission and cache kinds: data here; their
  consumers (serving, the fleet) are ported with ROADMAP Queue A items 10
  and 15.

On a mesh (``apply(mesh=)``, the mesh guard's and the mesh adapters')
every rank applies the same plan to its own block of the carry, and a
fault lands where the JAX package's lands on the global array:
``halo_bitflip`` flips the element at the global site (shard ``shard``'s
first row of the padded grid, its middle column) on the rank that owns
it alone; ``nan``, ``breakdown``, ``stagnation`` and ``psum_corrupt``
(the replicated zr's sign) change every rank's part; ``halo`` the ranks
holding the grid's first ``rows`` rows; ``device_loss`` raises on every
rank at the same iteration; ``straggler`` sleeps on the named rank only.

:func:`simulated_vmem` shrinks the on-chip budget the capacity gates
(``ops.resident_pcg.fits_resident``, ``ops.streamed_pcg.fits_streamed``)
read, so ``auto``'s ladder can be walked without a smaller card, and
:func:`truncate_latest_checkpoint` damages an on-disk checkpoint the way a
kill mid-write does.

Injection happens at the guard's chunk boundaries: the guard stops a
chunk at each fault's iteration (``next_stop``) and corrupts the carry
there (``apply``). The bodies are the production bodies; only the carry
between chunks is touched, and never in place: ``apply`` returns new
tensors, so the guard's rollback point is left as it was.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

FAULT_KINDS = (
    "nan", "breakdown", "stagnation", "halo", "oom",
    "halo_bitflip", "psum_corrupt", "device_loss", "straggler",
    "malformed_spec", "degenerate_geometry",
    "replica_kill", "replica_hang", "lease_clock_skew",
    "lease_store_outage", "lease_store_latency",
    "cache_poison",
)

# dispatch-level faults: consulted by the driver holding the dispatch,
# never applied to a carry
DISPATCH_KINDS = ("oom", "device_loss", "straggler")

# admission-level faults: they swap a request's geometry before it
# reaches the serving queue
ADMISSION_KINDS = ("malformed_spec", "degenerate_geometry")

# replica-level faults: consulted by the fleet router at arrival
# boundaries; they kill, hang or clock-skew a whole scheduler replica
REPLICA_KINDS = ("replica_kill", "replica_hang", "lease_clock_skew")

# lease-store faults: they partition or slow the fleet's coordination
# service; ``delay_s`` is the outage's length or a round trip's stall
LEASE_STORE_KINDS = ("lease_store_outage", "lease_store_latency")

# warm-start faults: the addressed request's solve-cache consult returns
# a deliberately wrong cached solution
CACHE_KINDS = ("cache_poison",)


class SimulatedResourceExhausted(RuntimeError):
    """The injected stand-in for a device OOM; its message carries the
    ``RESOURCE_EXHAUSTED`` marker, so it classifies as the real thing."""


class SimulatedDeviceLoss(RuntimeError):
    """The injected stand-in for a dead mesh device; its message carries
    the ``DEVICE_LOST`` marker. ``device`` names the lost device."""

    def __init__(self, message: str, device: int | None = None):
        super().__init__(message)
        self.device = device


@dataclasses.dataclass
class Fault:
    """One injected fault: ``kind`` at iteration ``at_iter``.

    ``field`` names the carry field to corrupt (classical ``w/r/p/zr``,
    pipelined ``x/r/u/w/z/s/p/gamma``); ``rows`` is a ``halo`` slab's
    height. ``lane`` addresses one lane of a batched carry
    (``batch.driver``); ``request_id`` one request of the serving
    scheduler, resolved to a lane when it fires (lane-addressed consumers
    refuse it). A fault fires once (``fired``) unless ``persistent``,
    which re-fires on every visit to its iteration (the unfixable fault
    that drives the guard up its ladder).
    """

    kind: str
    at_iter: int = 0
    field: str | None = None
    rows: int = 1
    lane: int | None = None
    request_id: str | None = None
    fired: bool = False
    persistent: bool = False
    # halo_bitflip: shard ``shard`` of ``shards`` blocks along the leading
    # axis picks the row; ``bit`` is the flipped bit (None: width - 5, a
    # high exponent bit below the top one)
    shard: int = 0
    shards: int = 2
    bit: int | None = None
    # device_loss / straggler: the device the failure names, the delay
    device: int | None = None
    delay_s: float = 0.0
    # degenerate_geometry: the clamp threshold of the sliver spec
    theta: float | None = None
    # replica-level addressing: the replica, the arrival it fires at, and
    # the lease clock's skew
    replica: int = 0
    at_request: int = 0
    skew_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind: {self.kind!r} (one of {FAULT_KINDS})"
            )
        if self.at_iter < 0:
            raise ValueError("at_iter must be >= 0")
        if self.lane is not None and self.request_id is not None:
            raise ValueError(
                "a fault is addressed by lane OR by request_id, not both "
                "(the scheduler resolves request_id to a lane at fire time)"
            )
        if self.kind == "halo_bitflip" and not (
            0 <= self.shard < self.shards
        ):
            raise ValueError(
                f"shard {self.shard} out of range for {self.shards} shards"
            )
        if self.kind == "straggler" and self.delay_s < 0:
            raise ValueError("delay_s must be >= 0")
        if self.kind in REPLICA_KINDS:
            if self.replica < 0:
                raise ValueError("replica must be >= 0")
            if self.at_request < 0:
                raise ValueError("at_request must be >= 0")
            if self.kind == "replica_hang" and self.delay_s < 0:
                raise ValueError("delay_s must be >= 0")
        if self.kind in LEASE_STORE_KINDS:
            if self.at_request < 0:
                raise ValueError("at_request must be >= 0")
            if self.delay_s <= 0:
                raise ValueError(
                    "lease-store faults need delay_s > 0 (the outage "
                    "duration or the per-round-trip stall)"
                )


def inject_nan(at_iter: int, field: str = "r",
               lane: int | None = None) -> Fault:
    """NaN-poison carry field ``field`` at iteration ``at_iter``,
    optionally only lane ``lane`` of a batched carry."""
    return Fault("nan", at_iter=at_iter, field=field, lane=lane)


def force_breakdown(at_iter: int) -> Fault:
    """Raise the breakdown flag at iteration ``at_iter``."""
    return Fault("breakdown", at_iter=at_iter)


def inject_stagnation(at_iter: int) -> Fault:
    """Corrupt the carried zr (or the pipelined s) so the solve stops
    progressing."""
    return Fault("stagnation", at_iter=at_iter)


def corrupt_halo(at_iter: int, field: str = "r", rows: int = 1) -> Fault:
    """NaN a ``rows``-high slab of ``field`` at ``at_iter``."""
    return Fault("halo", at_iter=at_iter, field=field, rows=rows)


def simulate_oom(at_iter: int = 0) -> Fault:
    """Raise a RESOURCE_EXHAUSTED-classified error at ``at_iter``."""
    return Fault("oom", at_iter=at_iter)


def halo_bitflip(at_iter: int, field: str = "r", shard: int = 1,
                 shards: int = 2, bit: int | None = None,
                 lane: int | None = None,
                 persistent: bool = False) -> Fault:
    """Flip one bit of one element of ``field`` on shard ``shard``'s
    first row (the default shard 1 avoids the Dirichlet ring)."""
    return Fault(
        "halo_bitflip", at_iter=at_iter, field=field, shard=shard,
        shards=shards, bit=bit, lane=lane, persistent=persistent,
    )


def psum_corrupt(at_iter: int, lane: int | None = None) -> Fault:
    """Flip the sign of the carried (z, r): a corrupted all-reduce."""
    return Fault("psum_corrupt", at_iter=at_iter, lane=lane)


def device_loss(chunk: int = 0, device: int = 0) -> Fault:
    """Raise a DEVICE_LOST-classified error at chunk-boundary iteration
    ``chunk`` naming ``device`` as the casualty."""
    return Fault("device_loss", at_iter=chunk, device=device)


def straggler(delay_s: float, at_iter: int = 0,
              device: int | None = None) -> Fault:
    """Sleep ``delay_s`` at the chunk boundary: the slow-device shape."""
    return Fault("straggler", at_iter=at_iter, delay_s=delay_s,
                 device=device)


def malformed_spec(request_id: str | None = None) -> Fault:
    """Swap the addressed request's geometry for an unparseable spec at
    admission (the ``invalid`` outcome, exit 8)."""
    return Fault("malformed_spec", request_id=request_id)


def degenerate_geometry(theta: float | None = None,
                        request_id: str | None = None) -> Fault:
    """Swap the addressed request's geometry for the sliver-cut domain
    (:func:`sliver_spec`) at admission, with clamp threshold ``theta``."""
    return Fault("degenerate_geometry", request_id=request_id, theta=theta)


def cache_poison(request_id: str | None = None) -> Fault:
    """Replace the addressed request's solve-cache consult with
    :func:`poisoned_guess`."""
    return Fault("cache_poison", request_id=request_id)


def poisoned_guess(shape, np_dtype):
    """The deterministic wrong warm start ``cache_poison`` injects: a
    ±1e3 checkerboard, boundary ring included."""
    import numpy as np

    idx = np.indices(shape).sum(axis=0)
    return (np.where(idx % 2 == 0, 1e3, -1e3)).astype(np_dtype)


def replica_kill(at_request: int = 0, replica: int = 0) -> Fault:
    """Kill one scheduler replica of the fleet when arrival
    ``at_request`` lands."""
    return Fault("replica_kill", at_request=at_request, replica=replica)


def replica_hang(delay_s: float = float("inf"), at_request: int = 0,
                 replica: int = 0) -> Fault:
    """Stop a live replica's heartbeat for ``delay_s`` seconds from
    arrival ``at_request`` (the zombie drill)."""
    return Fault("replica_hang", at_request=at_request, replica=replica,
                 delay_s=delay_s)


def lease_clock_skew(skew_s: float, at_request: int = 0,
                     replica: int = 0) -> Fault:
    """Compute a replica's lease renewals on a clock ``skew_s`` seconds
    behind the router's from arrival ``at_request``."""
    return Fault("lease_clock_skew", at_request=at_request,
                 replica=replica, skew_s=skew_s)


def lease_store_outage(duration_s: float, at_request: int = 0) -> Fault:
    """Partition the lease store for ``duration_s`` seconds from arrival
    ``at_request``."""
    return Fault("lease_store_outage", at_request=at_request,
                 delay_s=duration_s)


def lease_store_latency(delay_s: float, at_request: int = 0) -> Fault:
    """Stall every lease-store round trip by ``delay_s`` from arrival
    ``at_request``."""
    return Fault("lease_store_latency", at_request=at_request,
                 delay_s=delay_s)


MALFORMED_SPEC = {"kind": "dodecahedron", "r": -1.0}


def sliver_spec(gap_frac: float = 1e-3) -> dict:
    """The degenerate-cut domain: the ellipse with a comb of internal
    slits ``gap_frac`` of a cell wide, their centres off the coarse
    grids' node lines."""
    half = 0.0006 * gap_frac / 1e-3
    slits = [
        {"kind": "rectangle", "x0": -0.9, "x1": 0.9,
         "y0": 0.017 + 0.123 * k - half,
         "y1": 0.017 + 0.123 * k + half}
        for k in (-2, -1, 0, 1, 2)
    ]
    return {
        "kind": "difference",
        "a": {"kind": "ellipse"},
        "b": {"kind": "union", "shapes": slits},
    }


class FaultPlan:
    """An ordered set of faults the guard consults at chunk boundaries.
    An empty plan is the production path."""

    def __init__(self, *faults: Fault):
        self.faults = list(faults)

    def __bool__(self) -> bool:
        return any(not f.fired for f in self.faults)

    def next_stop(self, k: int) -> int | None:
        """The earliest unfired fault iteration strictly past ``k``: the
        guard ends its next chunk there."""
        pending = [f.at_iter for f in self.faults
                   if not f.fired and f.at_iter > k]
        return min(pending) if pending else None

    def apply(self, k: int, state, fields: dict[str, int],
              breakdown_index: int, zr_index: int, mesh=None):
        """Fire every unfired fault scheduled at iteration ``k`` against
        ``state`` (a carry NamedTuple; on ``mesh``, this rank's blocks of
        it); returns a carry of the same type. ``oom`` and ``device_loss``
        faults raise where a dispatch would."""
        for fault in self.faults:
            if fault.fired or fault.at_iter != k:
                continue
            if not fault.persistent:
                fault.fired = True
            if fault.kind == "oom":
                raise SimulatedResourceExhausted(
                    "RESOURCE_EXHAUSTED: simulated device OOM "
                    f"(fault injection at iteration {k})"
                )
            if fault.kind == "device_loss":
                raise SimulatedDeviceLoss(
                    f"DEVICE_LOST: simulated loss of device "
                    f"{fault.device} (fault injection at iteration {k})",
                    device=fault.device,
                )
            if fault.kind == "straggler":
                if (mesh is None or fault.device is None
                        or fault.device == mesh.global_rank):
                    time.sleep(fault.delay_s)
                continue
            state = _corrupt(state, fault, fields, breakdown_index, zr_index,
                             mesh)
        return state

    def lost_devices(self) -> list[int]:
        """Device ids named by fired device_loss/straggler faults."""
        return [
            f.device
            for f in self.faults
            if f.fired and f.kind in ("device_loss", "straggler")
            and f.device is not None
        ]


_INT_OF_WIDTH = {16: torch.int16, 32: torch.int32, 64: torch.int64}


def _flip_bit(value: torch.Tensor, bit: int | None) -> torch.Tensor:
    """``value`` with one bit flipped: a view to the integer dtype of the
    same width, an XOR, a view back. ``bit=None`` flips width - 5, a high
    exponent bit (x2^16 in f32) below the top one, whose flip would
    overflow the first inner product to inf."""
    width = value.element_size() * 8
    if bit is None:
        bit = width - 5
    if not 0 <= bit < width:
        raise ValueError(f"bit {bit} out of range for {value.dtype}")
    mask = 1 << bit
    if bit == width - 1:
        mask -= 1 << width  # the sign bit, as a signed integer
    as_int = value.clone().view(_INT_OF_WIDTH[width])
    return (as_int ^ mask).view(value.dtype)


def _bitflip_site(arr: torch.Tensor, fault: Fault) -> tuple[int, int]:
    """(row, col) of the flipped element: shard ``shard``'s first row at
    the middle column."""
    rows, cols = arr.shape[-2], arr.shape[-1]
    row = min((rows // fault.shards) * fault.shard, rows - 1)
    return row, cols // 2


def _rebuild(state, fields: list):
    """A carry of ``state``'s own type holding ``fields``."""
    return type(state)(*fields) if hasattr(state, "_fields") else tuple(
        fields)


def _field(fields: dict[str, int], fault: Fault) -> int:
    field = fault.field or "r"
    if field not in fields:
        raise ValueError(
            f"engine carry has no field {field!r} (has {sorted(fields)})"
        )
    return fields[field]


def _local_site(arr: torch.Tensor, fault: Fault, mesh):
    """(row, col) in this rank's block of the flipped element, or None
    when another rank owns it: the global site of ``_bitflip_site`` on
    the mesh's padded grid."""
    if mesh is None:
        return _bitflip_site(arr, fault)
    bm, bn = arr.shape[-2], arr.shape[-1]
    row, col = _bitflip_site(torch.empty((mesh.px * bm, mesh.py * bn),
                                         device="meta"), fault)
    if (row // bm, col // bn) != (mesh.ix, mesh.iy):
        return None
    return row % bm, col % bn


def _corrupt(state, fault: Fault, fields: dict[str, int],
             breakdown_index: int, zr_index: int, mesh=None):
    if fault.lane is not None:
        return _corrupt_lane(state, fault, fields, breakdown_index, zr_index)
    out = list(state)
    if fault.kind == "psum_corrupt":
        out[zr_index] = -out[zr_index]
    elif fault.kind == "halo_bitflip":
        idx = _field(fields, fault)
        site = _local_site(out[idx], fault, mesh)
        if site is not None:
            arr = out[idx].clone()
            row, col = site
            arr[row, col] = _flip_bit(arr[row, col], fault.bit)
            out[idx] = arr
    elif fault.kind == "breakdown":
        out[breakdown_index] = torch.ones_like(out[breakdown_index])
    elif fault.kind == "stagnation":
        if "s" in fields:
            # the pipelined carry: the recurrence-maintained s = A·p
            out[fields["s"]] = torch.full_like(out[fields["s"]], 1e12)
        else:
            out[zr_index] = torch.full_like(out[zr_index], 1e30)
    elif fault.kind in ("nan", "halo"):
        idx = _field(fields, fault)
        if fault.kind == "nan":
            out[idx] = torch.full_like(out[idx], float("nan"))
        else:
            # the grid's first rows: on a mesh, the part of them this
            # rank's block holds
            rows = fault.rows if mesh is None else max(
                fault.rows - mesh.ix * out[idx].shape[-2], 0)
            if rows:
                arr = out[idx].clone()
                arr[:rows] = float("nan")
                out[idx] = arr
    return _rebuild(state, out)


def _corrupt_lane(state, fault: Fault, fields: dict[str, int],
                  breakdown_index: int, zr_index: int):
    """Lane-addressed corruption of a batched carry: only slice
    ``fault.lane`` of the named field or flag changes."""
    lane = fault.lane
    out = list(state)
    if fault.kind == "psum_corrupt":
        zr = out[zr_index].clone()
        zr[lane] = -zr[lane]
        out[zr_index] = zr
    elif fault.kind == "halo_bitflip":
        idx = _field(fields, fault)
        arr = out[idx].clone()
        row, col = _bitflip_site(arr, fault)
        arr[lane, row, col] = _flip_bit(arr[lane, row, col], fault.bit)
        out[idx] = arr
    elif fault.kind == "breakdown":
        flags = out[breakdown_index].clone()
        flags[lane] = True
        out[breakdown_index] = flags
    elif fault.kind == "stagnation":
        zr = out[zr_index].clone()
        zr[lane] = 1e30
        out[zr_index] = zr
    elif fault.kind in ("nan", "halo"):
        idx = _field(fields, fault)
        arr = out[idx]
        if fault.kind == "halo" and arr.dim() < 3:
            raise ValueError(
                f"field {fault.field or 'r'!r} is not a lane-stacked grid; "
                "halo faults need a (B, g1, g2) carry field"
            )
        arr = arr.clone()
        if fault.kind == "nan":
            arr[lane] = float("nan")
        else:
            arr[lane, : fault.rows] = float("nan")
        out[idx] = arr
    return _rebuild(state, out)


@contextlib.contextmanager
def simulated_vmem(capacity_bytes: int):
    """Shrink the on-chip budget every capacity gate sees.

    Inside the context ``fits_resident`` and ``fits_streamed`` (and with
    them ``select_engine``) budget a block's shared memory at no more than
    ``capacity_bytes`` (``utils.device.smem_override``): the stand-in for
    a card too small for the engine ``auto`` would pick. The launches
    themselves keep the card's real budget."""
    from poisson_ellipse_tpu_torch.utils.device import smem_override

    with smem_override(capacity_bytes):
        yield


def truncate_latest_checkpoint(directory: str) -> str:
    """Truncate the largest file of the newest checkpoint step in
    ``directory`` to half its size: the on-disk shape of a kill during a
    checkpoint write. Returns the truncated path."""
    steps = [
        name for name in os.listdir(directory)
        if name.isdigit() and os.path.isdir(os.path.join(directory, name))
    ]
    if not steps:
        raise FileNotFoundError(f"no checkpoint steps under {directory}")
    step_dir = os.path.join(directory, max(steps, key=int))
    largest, size = None, -1
    for dirpath, _dirnames, filenames in os.walk(step_dir):
        for name in filenames:
            path = os.path.join(dirpath, name)
            n = os.path.getsize(path)
            if n > size:
                largest, size = path, n
    if largest is None:
        raise FileNotFoundError(f"no files under {step_dir}")
    with open(largest, "r+b") as fh:
        fh.truncate(size // 2)
    return largest
