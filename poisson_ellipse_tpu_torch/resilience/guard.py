"""Guarded solves: failure as a handled state, not a wrong answer.

The port's counterpart of ``poisson_ellipse_tpu.resilience.guard`` for one
device. Every engine detects failure (the carry's breakdown flag, a NaN
that reaches the sums) but none recovers. The guard runs a loop engine's
bodies in chunks of K iterations and, between chunks, reads one health
word built on the device from the carry:

  bit 0  breakdown   the carry's (Ap, p) < 1e-15 exit fired
  bit 1  nonfinite   NaN/Inf in the carry's vectors or scalars
  bit 2  stagnation  a full chunk ran and neither zr nor the step norm
                     improved, or zr <= 0 before convergence
  bit 3  converged   the loop's own stopping rule fired

The bodies are the production bodies (``make_body`` of ``solver.pcg``,
``ops.pipelined_pcg``, ``ops.sstep_pcg``), issued from the iteration the
guard knows on the host, so a guarded clean run is bitwise the unguarded
solve: chunking moves only where the host looks. The health word, the
carry's iteration count and its step norm come back in one ``.tolist()``
a chunk, the guard's only host read (the unguarded loop reads its flags
once every ``solver.pcg.DEFAULT_CHUNK`` iterations).

On an unhealthy chunk the guard walks a recovery ladder:

1. **True residual restart** from the last trustworthy carry (breakdown
   keeps its own pre-update carry; NaN and stagnation roll back to the
   previous healthy chunk boundary): r = rhs − A·w, a fresh z and zr,
   the search direction p kept (the residual replacement the pipelined
   engine performs every 32 iterations), which reconverges at the clean
   run's count.
2. **Precision escalation** on the ``xla`` stencil below f64: the carry
   and the operands recast to f64 (the kernel engines run no f64).
3. **Engine fallback**: pipelined → classical (iterate and the
   phase-corrected direction carried over), s-step → pipelined →
   classical, pallas → xla. An OOM at dispatch takes this rung directly.

A narrow-storage solve (``storage_dtype``) also has the **storage
promotion** rung: bf16 or f16 storage → compute width. It is the designed
finish of every narrow solve: the guard promotes when the narrow loop
claims convergence or a full chunk no longer halves the step norm, and
re-earns convergence at full width.

Every recovery emits an ``obs.trace`` ``recovery:*`` event and counts
against ``max_recoveries``; exhaustion raises the classified
``resilience.errors.SolveError``, never a NaN result dressed as a
converged ``PCGResult``. An exception that is not an OOM (a kernel that
does not build, a sticky CUDA error) is raised as it is: no fallback
hides a kernel. The whole-solve engines (``resident``, ``streamed``,
``xl``, ``fused``, and ``auto``) keep their scalars inside the kernel, so
they are guarded at whole-solve granularity: the result is checked, and
an OOM or an unhealthy result degrades down the capacity ladder resident
→ streamed → xl → the chunked guarded ``xla`` loop.

On the mesh (``mesh=``, every rank of it calling together) the chunked
steppers of ``parallel.pcg_sharded`` (``xla``/``auto``, ``pallas``),
``sstep_sharded`` (``sstep``, ``sstep-pallas``) and ``pipelined_sharded``
(``pipelined``) run under the same ladder: restart, f64 escalation on
``xla``, fallback to the classical ``xla`` stepper. ``abft=True`` turns on
the in-loop silent-corruption checks (``resilience.abft``); their sticky
flag is the health word's ``HEALTH_SDC`` bit, answered by a rollback to
the last healthy chunk boundary and a re-run, and by
``SilentCorruptionError`` (exit 6) when it fires again. Every branch is
taken from the same bits on every rank: the health word is OR-ed over the
ranks (a NaN in one rank's block), the drift check's norm summed over
them, and the deadline read from the first rank's clock, one collective
each at a chunk boundary, counted as "agree" (``parallel.mesh``).

Not ported here: the geometry and multigrid engines (ROADMAP Queue A
items 11 and 21c).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.obs import trace as obs_trace
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.ops import pipelined_pcg as pp
from poisson_ellipse_tpu_torch.ops import sstep_pcg as ss
from poisson_ellipse_tpu_torch.ops.precision import (
    dtype_name,
    load,
    resolve_storage_dtype,
    store,
)
from poisson_ellipse_tpu_torch.ops.reduction import grid_dot
from poisson_ellipse_tpu_torch.ops.stencil import (
    apply_a,
    apply_dinv,
    diag_d,
    spacing,
)
from poisson_ellipse_tpu_torch.resilience import abft as abft_layer
from poisson_ellipse_tpu_torch.resilience.errors import (
    DivergedError,
    OutOfMemoryError,
    SilentCorruptionError,
    SolveError,
    SolveTimeout,
    classify_error,
)
from poisson_ellipse_tpu_torch.resilience.faultinject import (
    FaultPlan,
    SimulatedResourceExhausted,
)
from poisson_ellipse_tpu_torch.solver import pcg
from poisson_ellipse_tpu_torch.solver.pcg import PCGResult, PCGState, unported
from poisson_ellipse_tpu_torch.utils.device import (
    DeviceCapacity,
    capacity as device_capacity,
    resolve_device,
)

HEALTH_BREAKDOWN = 1
HEALTH_NONFINITE = 2
HEALTH_STAGNATION = 4
HEALTH_CONVERGED = 8
# the ABFT layer's silent-corruption bit (the mesh adapters with abft);
# routed to rollback and re-run, never to a restart, which would launder
# the corrupted iterate into the answer
HEALTH_SDC = 16

_UNHEALTHY = HEALTH_BREAKDOWN | HEALTH_NONFINITE | HEALTH_STAGNATION

# the single-device capacity ladder the whole-solve guard degrades down;
# the last rung is the chunked guarded xla loop, which has no gate
_CAPACITY_LADDER = ("resident", "streamed", "xl")

DEFAULT_CHUNK = 128

# the convergence-claim check: a drifted recurrence can satisfy the
# step-norm rule at a garbage iterate; a converged chunk is accepted only
# if ‖r_carried − (rhs − A·w)‖ / ‖rhs‖ is below this (healthy recurrences
# track the true residual to round-off)
RESIDUAL_DRIFT_TOL = 1e-2

# the engines the JAX guard chunk-steps that the port has not ported
_UNPORTED_ENGINES = ("mg-pcg", "cheb-pcg", "fmg")


@dataclasses.dataclass(frozen=True)
class RecoveryEvent:
    """One recovery action: what fired, where, and what the guard did."""

    kind: str  # residual-restart / precision-escalation / engine-fallback
    at_iter: int
    health: int
    engine: str
    detail: str = ""


class GuardedResult(NamedTuple):
    """A guarded solve's outcome: the PCGResult, the recovery story (empty
    ``recoveries``: the healthy path ran start to finish), the engine and
    dtype that finished the solve, and the host reads it made."""

    result: PCGResult
    recoveries: tuple[RecoveryEvent, ...]
    engine: str
    dtype: str
    host_syncs: int = 0


def health_name(word: int) -> str:
    """Human label for a health word's unhealthy bits."""
    names = []
    if word & HEALTH_BREAKDOWN:
        names.append("breakdown")
    if word & HEALTH_NONFINITE:
        names.append("nonfinite")
    if word & HEALTH_STAGNATION:
        names.append("stagnation")
    if word & HEALTH_SDC:
        names.append("sdc")
    return "+".join(names) or "healthy"


def _health_word(vectors, zr, diff, k, converged, breakdown, zr_prev,
                 diff_prev, limit: int) -> torch.Tensor:
    """The packed int32 health word, from device tensors only (``limit`` is
    a Python int compared against, never put in a ``where``)."""
    finite = torch.isfinite(zr) & ~torch.isnan(diff)
    for v in vectors:
        finite = finite & torch.isfinite(v).all()
    # no progress over a full chunk, or a non-positive zr: (z, r) is an
    # energy inner product, positive for the SPD operator until convergence
    live = ~converged & ~breakdown
    stalled = ((k == limit) & live & (zr >= zr_prev) & (diff >= diff_prev)) \
        | (live & (zr <= 0))
    i32 = torch.int32
    return (breakdown.to(i32) * HEALTH_BREAKDOWN
            + (~finite).to(i32) * HEALTH_NONFINITE
            + stalled.to(i32) * HEALTH_STAGNATION
            + converged.to(i32) * HEALTH_CONVERGED)


def _cast_carry(state, dtype):
    """Recast a carry's floating fields (precision escalation); the
    counter and the flags pass through."""
    return type(state)(*(x.to(dtype) if x.is_floating_point() else x
                         for x in state))


def _false(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.bool, device=like.device)


# --------------------------------------------------------------------------
# engine adapters: one chunk / health / recover interface per carry
# --------------------------------------------------------------------------


class _Adapter:
    """What the adapters share: operands, the chunk, the probe, and the
    mesh hooks, which on one device agree with nobody."""

    FIELDS: dict = {}
    K = ZR = DIFF = CONV = BD = 0
    mesh = None
    abft = False

    def _setup(self, problem: Problem, dtype, stencil: str, operands,
               storage_dtype, device) -> None:
        self.problem = problem
        self.dtype = dtype
        self.stencil = stencil
        self.storage_dtype = resolve_storage_dtype(storage_dtype, dtype)
        if operands is None:
            operands = assembly.assemble(problem, dtype,
                                         resolve_device(device))
        self._operands = operands
        a, b, rhs = operands
        self.device = rhs.device
        self.rhs_norm = float(torch.sqrt(torch.sum(rhs.float() ** 2)))
        self._h1 = spacing(problem.h1, rhs)
        self._h2 = spacing(problem.h2, rhs)
        self._d = diag_d(a, b, self._h1, self._h2)

    def _a(self, v):
        a, b, _ = self._operands
        return apply_a(v, a, b, self._h1, self._h2)

    def _dinv(self, v):
        return apply_dinv(v, self._d)

    def scalars(self, state):
        return state[self.ZR], state[self.DIFF]

    def vectors(self, state) -> tuple:
        raise NotImplementedError

    def advance(self, state, k: int, limit: int):
        """The bodies from iteration ``k`` (the carry's own count) to
        ``limit``, as the unguarded loop issues them."""
        body = self._body
        for it in range(k, limit):
            state = body(state, it)
        return state

    def probe(self, new, prev, limit: int) -> torch.Tensor:
        """(health word, iteration count, step norm) of the chunk's carry
        ``new`` against the chunk-start carry ``prev``, as one float64
        device tensor: the guard reads it once. With ABFT the carry's
        sticky flag sets ``HEALTH_SDC``; on a mesh the word is OR-ed over
        the ranks (the scalars are the same on every rank)."""
        zr_prev, diff_prev = self.scalars(prev)
        word = _health_word(
            self.vectors(new), new[self.ZR], new[self.DIFF], new[self.K],
            new[self.CONV], new[self.BD], zr_prev, diff_prev, limit)
        if self.abft:
            word = word + new.sdc.to(torch.int32) * HEALTH_SDC
        if self.mesh is not None:
            word = self.mesh.agree_or(word)
        return torch.stack([word.double(), new[self.K].double(),
                            new[self.DIFF].double()])

    def norm(self, v: torch.Tensor) -> float:
        """‖v‖ over the whole grid: this block's, summed over the ranks
        on a mesh."""
        local = torch.sum(v.float() ** 2)
        if self.mesh is not None:
            return float(self.mesh.agree_sum(local)) ** 0.5
        return float(torch.sqrt(local))

    def agree(self, late: bool) -> bool:
        """A decision from this process's clock, taken by every rank: the
        mesh's first rank's."""
        return late if self.mesh is None else self.mesh.agree_first(late)

    def init(self):
        return self._init()


class _ClassicalAdapter(_Adapter):
    """The classical carry (``solver.pcg.PCGState``): (k, w, r, p, zr,
    diff, converged, breakdown), on the xla or pallas stencil.

    ``sstep_s`` (2 or 4) swaps the bodies for the s-step recurrence
    (``ops.sstep_pcg``, the same carry), engine "sstep" / "sstep-pallas";
    its fallback is sstep → pipelined → classical. ``storage_dtype`` runs
    the narrow-storage loop, whose escalation is storage promotion."""

    FIELDS = {"w": 1, "r": 2, "p": 3, "zr": 4}
    K, ZR, DIFF, CONV, BD = 0, 4, 5, 6, 7

    def __init__(self, problem: Problem, dtype, stencil: str = "xla",
                 operands=None, storage_dtype=None, sstep_s=None,
                 device=None):
        self._setup(problem, dtype, stencil, operands, storage_dtype, device)
        self.sstep_s = sstep_s
        if sstep_s is not None:
            self.engine = "sstep" if stencil == "xla" else "sstep-pallas"
        else:
            self.engine = "xla" if stencil == "xla" else "pallas"
        a, b, rhs = self._operands
        st = self.storage_dtype
        self._init = lambda: pcg.init_state(problem, a, b, rhs,
                                            storage_dtype=st)
        if sstep_s is None:
            # the body masks at the iteration cap; the guard issues exactly
            # the bodies of the chunk, so a chunk's limit needs no body
            self._body = pcg.make_body(problem, a, b, rhs,
                                       problem.max_iterations, stencil, st)

    def advance(self, state, k: int, limit: int):
        if self.sstep_s is None:
            return super().advance(state, k, limit)
        # an s-step block masks its iterations at the chunk's limit
        a, b, rhs = self._operands
        body = ss.make_body(self.problem, a, b, rhs, limit, self.sstep_s,
                            self.stencil, self.storage_dtype)
        for it in range(k, limit, self.sstep_s):
            state = body(state, it)
        return state

    def vectors(self, state) -> tuple:
        return state.w, state.r, state.p

    def recover(self, state: PCGState) -> PCGState:
        """True residual restart keeping the search direction; a narrow
        carry is rebuilt at full width and rounded on store. A direction
        that is not finite restarts as p = z."""
        dtype, st = self.dtype, self.storage_dtype
        rhs = self._operands[2]
        w = load(state.w, dtype, st)
        p = load(state.p, dtype, st)
        r2 = rhs - self._a(w)
        z2 = self._dinv(r2)
        zr2 = grid_dot(z2, r2, self._h1, self._h2)
        p2 = torch.where(torch.isfinite(p).all(), p, z2)
        return PCGState(k=state.k, w=state.w, r=store(r2, st),
                        p=store(p2, st), zr=zr2, diff=state.diff,
                        converged=_false(rhs), breakdown=_false(rhs))

    def result(self, state) -> PCGResult:
        return pcg.result_of(state)

    def promote(self):
        """Storage promotion: the iterate hands over to the full-width
        classical loop, the direction restarts from the rebuilt z (the
        NaN p routes ``recover`` into p = z): a narrow direction fed to a
        full-width α breaks conjugacy."""
        if self.storage_dtype is None:
            return None
        return _promotion(self, diff_index=self.DIFF)

    def escalate(self):
        if self.storage_dtype is not None:
            # narrow storage first goes back to compute width
            return self.promote()
        if self.sstep_s is not None:
            # the s-step ladder is fallback first
            return None
        if self.stencil != "xla" or self.dtype.itemsize >= 8:
            return None
        adapter = _ClassicalAdapter(self.problem, torch.float64,
                                    stencil="xla", device=self.device)
        return adapter, lambda state: _cast_carry(state, torch.float64)

    def fallback(self):
        if self.sstep_s is not None:
            adapter = _PipelinedAdapter(self.problem, self.dtype,
                                        stencil="xla", device=self.device)
            return adapter, self._to_pipelined
        if self.stencil == "pallas":
            adapter = _ClassicalAdapter(self.problem, self.dtype,
                                        stencil="xla",
                                        operands=self._operands)
            return adapter, lambda state: state
        return None

    def _to_pipelined(self, state: PCGState):
        """The s-step carry handed to the pipelined recurrence through a
        ground-truth rebuild: x and the direction p carry across."""
        dtype, st = self.dtype, self.storage_dtype
        rhs = self._operands[2]
        x = load(state.w, dtype, st)
        p = load(state.p, dtype, st)
        r2 = rhs - self._a(x)
        u2 = self._dinv(r2)
        w2 = self._a(u2)
        s2 = self._a(p)
        z2 = self._a(self._dinv(s2))
        zr = state.zr
        g2 = torch.where(torch.isfinite(zr) & (zr > 0), zr,
                         torch.ones_like(zr))
        return pp.PipelinedState(
            k=state.k, x=x, r=r2, u=u2, w=w2, z=z2, s=s2, p=p,
            gamma_prev=g2, diff=state.diff, converged=_false(rhs),
            breakdown=_false(rhs))


class _PipelinedAdapter(_Adapter):
    """The pipelined carry (``ops.pipelined_pcg.PipelinedState``): (k, x,
    r, u, w, z, s, p, γ₋₁, diff, converged, breakdown); its zr series is
    γ."""

    FIELDS = {
        "x": 1, "r": 2, "u": 3, "w": 4, "z": 5, "s": 6, "p": 7, "gamma": 8,
    }
    K, ZR, DIFF, CONV, BD = 0, 8, 9, 10, 11

    def __init__(self, problem: Problem, dtype, stencil: str = "xla",
                 storage_dtype=None, device=None):
        self._setup(problem, dtype, stencil, None, storage_dtype, device)
        self.engine = "pipelined" if stencil == "xla" else "pipelined-pallas"
        a, b, rhs = self._operands
        st = self.storage_dtype
        self._init = lambda: pp.init_state(problem, a, b, rhs,
                                           stencil=stencil, storage_dtype=st)
        self._body = pp.make_body(problem, a, b, rhs, problem.max_iterations,
                                  stencil, st)

    def vectors(self, state) -> tuple:
        return tuple(state[1:8])

    def recover(self, state):
        """The in-loop residual replacement's rebuild on demand: every
        recurrence-maintained vector from x and p, p kept; a narrow carry
        rebuilt at full width and rounded on store."""
        dtype, st = self.dtype, self.storage_dtype
        rhs = self._operands[2]
        x = load(state.x, dtype, st)
        p = load(state.p, dtype, st)
        r2 = rhs - self._a(x)
        u2 = self._dinv(r2)
        w2 = self._a(u2)
        s2 = self._a(p)
        z2 = self._a(self._dinv(s2))
        g = state.gamma_prev
        g2 = torch.where(torch.isfinite(g), g, torch.ones_like(g))
        return pp.PipelinedState(
            k=state.k, x=state.x, r=store(r2, st), u=store(u2, st),
            w=store(w2, st), z=store(z2, st), s=store(s2, st), p=state.p,
            gamma_prev=g2, diff=state.diff, converged=_false(rhs),
            breakdown=_false(rhs))

    def result(self, state) -> PCGResult:
        return pp.result_of(state)

    def promote(self):
        """Storage promotion to the full-width classical loop (see the
        classical adapter's)."""
        if self.storage_dtype is None:
            return None
        return _promotion(self, diff_index=self.DIFF)

    def escalate(self):
        if self.storage_dtype is not None:
            return self.promote()
        if self.stencil != "xla" or self.dtype.itemsize >= 8:
            return None
        adapter = _PipelinedAdapter(self.problem, torch.float64,
                                    stencil="xla", device=self.device)
        return adapter, lambda state: _cast_carry(state, torch.float64)

    def fallback(self):
        # pipelined -> classical on the same operands; the iterate and the
        # phase-corrected direction carry over
        adapter = _ClassicalAdapter(self.problem, self.dtype, stencil="xla",
                                    operands=self._operands)
        return adapter, self._to_classical

    def _to_classical(self, state):
        """The pipelined carry holds the direction its last iteration used;
        the classical one the direction for the next. The conversion
        applies the classical end-of-iteration update once, p₀ = z +
        (zr/γ)·p; a narrow carry lands at full width."""
        dtype, st = self.dtype, self.storage_dtype
        rhs = self._operands[2]
        x = load(state.x, dtype, st)
        p = load(state.p, dtype, st)
        r2 = rhs - self._a(x)
        z2 = self._dinv(r2)
        zr2 = grid_dot(z2, r2, self._h1, self._h2)
        p2 = z2 + (zr2 / state.gamma_prev) * p
        return PCGState(k=state.k, w=x, r=r2, p=p2, zr=zr2, diff=state.diff,
                        converged=_false(rhs), breakdown=_false(rhs))


class _ShardedAdapter(_Adapter):
    """The mesh's classical carry (``parallel.pcg_sharded``'s stepper, or
    the s-step stepper's, the same layout): each rank's blocks of w, r, p
    and the replicated scalars, the ABFT tail with ``abft``. Engines
    ``xla`` and ``pallas``, and ``sstep`` (``sstep_s`` iterations a block,
    the classical ``xla`` recover)."""

    FIELDS = {"w": 1, "r": 2, "p": 3, "zr": 4}
    K, ZR, DIFF, CONV, BD = 0, 4, 5, 6, 7
    SDC = abft_layer.SDC  # the abft module's tail layout

    def __init__(self, problem: Problem, mesh, dtype, stencil: str = "xla",
                 abft: bool = False, sstep_s=None):
        from poisson_ellipse_tpu_torch.parallel import pcg_sharded as ps

        self.problem = problem
        self.mesh = mesh
        self.dtype = dtype
        self.stencil = stencil
        self.abft = abft
        self.sstep_s = sstep_s
        self.storage_dtype = None  # the mesh ladder runs at full width
        self.device = mesh.device
        if stencil == "sstep":
            # the s-step carry is the classical one: the classical recover
            # applies as it is
            from poisson_ellipse_tpu_torch.parallel.sstep_sharded import (
                build_sstep_sharded_stepper,
            )

            self.engine = "sstep"
            parts = ps.stepper_parts(problem, mesh, dtype, "xla", abft)
            self._init, self._advance = build_sstep_sharded_stepper(
                problem, mesh, dtype, s=sstep_s or 4, abft=abft)
        else:
            self.engine = stencil
            parts = ps.stepper_parts(problem, mesh, dtype, stencil, abft)
            self._init, self._advance = parts.init, parts.advance
        self.recover = parts.recover
        self.rhs_norm = parts.rhs_norm

    def advance(self, state, k: int, limit: int):
        return self._advance(state, limit, k)

    def vectors(self, state) -> tuple:
        return state.w, state.r, state.p

    def result(self, state) -> PCGResult:
        """The global (M+1, N+1) solution on every rank (one gather)."""
        from poisson_ellipse_tpu_torch.parallel.pcg_sharded import (
            gather_w,
            sharded_result_of,
        )

        result = sharded_result_of(self.problem, state)
        return result._replace(w=gather_w(self.problem, self.mesh,
                                          result.w))

    def escalate(self):
        if self.stencil != "xla" or self.dtype.itemsize >= 8:
            return None
        adapter = _ShardedAdapter(self.problem, self.mesh, torch.float64,
                                  stencil="xla", abft=self.abft)
        return adapter, lambda state: _cast_carry(state, torch.float64)

    def fallback(self):
        if self.stencil in ("pallas", "sstep"):
            # the same carry: the iterate and the direction hand over
            adapter = _ShardedAdapter(self.problem, self.mesh, self.dtype,
                                      stencil="xla", abft=self.abft)
            return adapter, lambda state: state
        return None


class _PipelinedShardedAdapter(_Adapter):
    """The mesh's pipelined carry (``parallel.pipelined_sharded``'s
    stepper): each rank's blocks of x, r, u, w, z, s, p, the replicated
    γ₋₁, step norm and flags, and the lagged ABFT tail with ``abft``. Its
    ladder is restart, then fallback to the classical ``xla`` stepper."""

    FIELDS = {"x": 1, "r": 2, "u": 3, "w": 4, "z": 5, "s": 6, "p": 7}
    K, ZR, DIFF, CONV, BD = 0, 8, 9, 10, 11
    SDC = 16  # = pipelined_sharded.PIPE_SDC

    def __init__(self, problem: Problem, mesh, dtype, abft: bool = False):
        from poisson_ellipse_tpu_torch.parallel.pipelined_sharded import (
            PIPE_SDC,
            stepper_parts,
        )

        assert self.SDC == PIPE_SDC  # the recurrence owns its tail layout
        self.problem = problem
        self.mesh = mesh
        self.dtype = dtype
        self.stencil = "xla"
        self.abft = abft
        self.storage_dtype = None
        self.device = mesh.device
        self.engine = "pipelined"
        parts = stepper_parts(problem, mesh, dtype, abft)
        self._init, self._advance = parts.init, parts.advance
        self.recover = parts.recover
        self._to_classical = parts.to_classical
        self.rhs_norm = parts.rhs_norm

    def advance(self, state, k: int, limit: int):
        return self._advance(state, limit, k)

    def vectors(self, state) -> tuple:
        return tuple(state[1:8])

    def result(self, state) -> PCGResult:
        from poisson_ellipse_tpu_torch.parallel.pcg_sharded import gather_w
        from poisson_ellipse_tpu_torch.parallel.pipelined_sharded import (
            pipelined_sharded_result_of,
        )

        result = pipelined_sharded_result_of(self.problem, state)
        return result._replace(w=gather_w(self.problem, self.mesh,
                                          result.w))

    def escalate(self):
        return None  # the mesh ladder is restart, then classical fallback

    def fallback(self):
        adapter = _ShardedAdapter(self.problem, self.mesh, self.dtype,
                                  stencil="xla", abft=self.abft)
        return adapter, self._to_classical


def _promotion(adapter: _Adapter, diff_index: int):
    """(full-width classical adapter, carry conversion) of a narrow
    adapter's storage promotion: the iterate at compute width, r zero, p
    NaN (so ``recover`` restarts it from z), zr 1."""
    dtype = adapter.dtype
    target = _ClassicalAdapter(adapter.problem, dtype, stencil="xla",
                               operands=adapter._operands)

    def convert(state):
        x = state[1].to(dtype)
        return PCGState(
            k=state[0], w=x, r=torch.zeros_like(x),
            p=torch.full_like(x, float("nan")),
            zr=torch.ones((), dtype=dtype, device=x.device),
            diff=state[diff_index].to(dtype), converged=_false(x),
            breakdown=_false(x))

    return target, convert


def _make_adapter(problem: Problem, engine: str, dtype, storage_dtype=None,
                  sstep_s: int = 4, device=None, mesh=None,
                  abft: bool = False, geometry=None) -> _Adapter:
    from poisson_ellipse_tpu_torch.solver.engine import (
        BATCHED_ENGINES,
        ENGINE_CAPS,
    )

    if geometry is not None and mesh is not None:
        raise ValueError(
            "guarded sharded solves do not take geometry= yet — run the "
            "sharded build (parallel.pcg_sharded.build_sharded_solver) "
            "directly, or guard the single-chip engines"
        )
    if abft and mesh is None:
        raise ValueError(
            "abft covers the sharded engines (the checksum partials ride "
            "the mesh's stacked convergence psum); single-device solves "
            "are guarded by the health word + final residual gate alone"
        )
    if mesh is not None:
        if storage_dtype is not None:
            raise ValueError(
                "the guarded mesh ladder runs at full width; narrow-"
                "storage sharded solves run the steppers directly "
                "(parallel.pcg_sharded / parallel.sstep_sharded with "
                "storage_dtype=) — drop --storage-dtype or --mesh"
            )
        if engine in ("auto", "xla"):
            return _ShardedAdapter(problem, mesh, dtype, stencil="xla",
                                   abft=abft)
        if engine == "pallas":
            return _ShardedAdapter(problem, mesh, dtype, stencil="pallas",
                                   abft=abft)
        if engine in ("sstep", "sstep-pallas"):
            return _ShardedAdapter(problem, mesh, dtype, stencil="sstep",
                                   abft=abft, sstep_s=sstep_s)
        if engine in ("mg-pcg", "cheb-pcg"):
            raise unported(f"the guarded {engine!r} engine on the mesh",
                           "Queue A item 21c")
        if engine == "pipelined":
            return _PipelinedShardedAdapter(problem, mesh, dtype, abft=abft)
        raise ValueError(
            f"guarded sharded solves run the chunked steppers "
            f"('xla'/'pallas'/'pipelined'/'sstep'/'mg-pcg'/'cheb-pcg'); "
            f"got engine={engine!r} — the fused sharded iteration has no "
            "resumable stepper form"
        )
    if geometry is not None:
        raise unported("geometry=", "Queue A item 11")
    if engine in _UNPORTED_ENGINES:
        raise unported(f"the guarded {engine!r} engine", "Queue A item 11")
    if engine in BATCHED_ENGINES:
        raise ValueError(
            f"engine {engine!r} has its own chunked guard — the lane "
            "driver (batch.driver.solve_batched) quarantines poisoned "
            "lanes per chunk instead of walking the single-solve ladder"
        )
    if engine not in ("xla", "pallas", "pipelined", "pipelined-pallas",
                      "sstep", "sstep-pallas"):
        raise ValueError(f"no chunked adapter for engine {engine!r}")
    if dtype not in ENGINE_CAPS[engine]["dtypes"]:
        raise ValueError(f"engine {engine!r} does not run {dtype}")
    stencil = "pallas" if engine.endswith("pallas") else "xla"
    if engine.startswith("pipelined"):
        return _PipelinedAdapter(problem, dtype, stencil=stencil,
                                 storage_dtype=storage_dtype, device=device)
    if engine.startswith("sstep"):
        if sstep_s not in ss.SSTEP_CHOICES:
            raise ValueError(f"s must be one of {ss.SSTEP_CHOICES}, got "
                             f"{sstep_s}")
        return _ClassicalAdapter(problem, dtype, stencil=stencil,
                                 storage_dtype=storage_dtype,
                                 sstep_s=sstep_s, device=device)
    return _ClassicalAdapter(problem, dtype, stencil=stencil,
                             storage_dtype=storage_dtype, device=device)


# --------------------------------------------------------------------------
# the guard driver
# --------------------------------------------------------------------------


def guarded_solve(
    problem: Problem,
    engine: str = "xla",
    dtype=torch.float32,
    *,
    mesh=None,
    chunk: int = DEFAULT_CHUNK,
    max_recoveries: int = 3,
    timeout: Optional[float] = None,
    faults: Optional[FaultPlan] = None,
    abft: bool = False,
    geometry=None,
    theta=None,
    storage_dtype=None,
    sstep_s: int = 4,
    device=None,
    capacity: DeviceCapacity | None = None,
) -> GuardedResult:
    """Solve with failure detection and the recovery ladder (module
    docstring), on ``device`` (cuda unless ``device='cpu'``).

    The loop engines (``xla``, ``pallas``, ``pipelined``,
    ``pipelined-pallas``, ``sstep``, ``sstep-pallas``) run chunked with a
    health word a chunk; the whole-solve engines (``resident``,
    ``streamed``, ``xl``, ``fused``, and ``auto``, resolved on
    ``capacity``: the card's by default, none on the CPU, where ``auto``
    takes ``xl``) run whole with the capacity-ladder fallback.

    ``timeout`` (seconds) is enforced at chunk boundaries: the in-flight
    chunk completes, then :class:`SolveTimeout` carries the last healthy
    iteration count out. ``faults`` is the injection plan (tests,
    ``harness inject``). ``storage_dtype`` runs the narrow-storage loop
    under the guard, promoted to compute width before its convergence is
    accepted. ``sstep_s`` sizes the s-step engines' blocks.

    ``mesh`` (a ``parallel.mesh.Mesh``; every rank of it calls together)
    runs the mesh's chunked steppers (``xla``/``auto``, ``pallas``,
    ``pipelined``, ``sstep``/``sstep-pallas``), the result's w the global
    solution on every rank; ``abft=True`` (the mesh only) turns on the
    in-loop silent-corruption checks, a flagged chunk rolled back and
    re-run, a second flag from a clean carry raising
    ``SilentCorruptionError``.

    Raises the classified ``SolveError`` subclasses on recovery
    exhaustion (``DivergedError``), memory exhaustion with no engine left
    (``OutOfMemoryError``), silent corruption that a rollback does not
    clear (``SilentCorruptionError``), or deadline (``SolveTimeout``).
    """
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    t0 = time.monotonic()
    plan = faults if faults is not None else FaultPlan()
    events: list[RecoveryEvent] = []
    if theta is not None and geometry is None:
        raise unported("geometry=", "Queue A item 11")

    if mesh is None and engine in ("auto", "resident", "streamed", "xl",
                                   "fused"):
        if abft:
            raise ValueError(
                "abft covers the sharded engines; the whole-solve VMEM "
                f"engines ({engine!r}) are validated by the final "
                "health check alone"
            )
        if geometry is not None:
            raise unported("geometry=", "Queue A item 11")
        dev = resolve_device(device)
        if storage_dtype is not None:
            raise ValueError(
                "guarded narrow-storage solves run the chunked loop "
                "engines (xla/pallas/pipelined*/sstep*) — the whole-"
                "solve VMEM engines have no chunk boundary to promote "
                "at; run build_solver(storage_dtype=…) directly for "
                "their operand-narrow forms"
            )
        if capacity is None and dev.type == "cuda":
            capacity = device_capacity(dev)
        return _guarded_whole_solve(
            problem, engine, dtype, chunk=chunk,
            max_recoveries=max_recoveries, timeout=timeout, t0=t0,
            plan=plan, events=events, device=dev, capacity=capacity,
        )

    adapter = _make_adapter(problem, engine, dtype,
                            storage_dtype=storage_dtype, sstep_s=sstep_s,
                            device=None if mesh is not None
                            else resolve_device(device),
                            mesh=mesh, abft=abft, geometry=geometry)
    return _run_chunked(
        problem, adapter, chunk=chunk, max_recoveries=max_recoveries,
        timeout=timeout, t0=t0, plan=plan, events=events,
    )


def _record(events: list[RecoveryEvent], kind: str, at_iter: int,
            health: int, engine: str, detail: str = "",
            lane: int | None = None) -> None:
    events.append(RecoveryEvent(kind, at_iter, health, engine, detail))
    obs_trace.event(
        f"recovery:{kind}",
        # a lane-addressed event carries the lane as the schema's
        # top-level key
        lane=lane,
        iter=at_iter,
        health=health_name(health) if health else "error",
        engine=engine,
        detail=detail,
    )


def _residual_drift(adapter: _Adapter, state) -> float:
    """Relative drift of the carried residual from the true one (the
    convergence-claim check; one extra read, at the final chunk only; on
    a mesh the norm is summed over the ranks)."""
    rebuilt = adapter.recover(state)
    idx = adapter.FIELDS["r"]
    return adapter.norm(state[idx] - rebuilt[idx]) / max(adapter.rhs_norm,
                                                         1e-30)


def _check_deadline(timeout, t0, k: int, adapter=None) -> None:
    """Raise ``SolveTimeout`` past the deadline; on a mesh the first
    rank's clock decides for every rank."""
    if timeout is None:
        return
    late = time.monotonic() - t0 > timeout
    if adapter is not None:
        late = adapter.agree(late)
    if late:
        obs_trace.event("recovery:timeout", iter=k, timeout_s=timeout)
        raise SolveTimeout(
            f"solve exceeded --timeout {timeout:g}s at iteration {k} "
            "(chunk-boundary cancel; partial trace flushed)",
            iters=k,
        )


def _release_device_memory() -> None:
    """Return the blocks a real CUDA OOM left cached to the card before
    the fallback allocates its own."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _run_chunked(problem: Problem, adapter: _Adapter, *, chunk: int,
                 max_recoveries: int, timeout, t0, plan: FaultPlan,
                 events: list) -> GuardedResult:
    """The chunked guard, branch for branch the JAX ``_run_chunked``.

    ``k`` is the JAX guard's host counter (it sets the chunk's limit, the
    deadline's and the faults' iteration); the carries' own counts
    (``k_state`` of ``state``, ``k_prev`` of the rollback point ``prev``)
    and step norms are known on the host from the reads, so a chunk
    issues exactly its bodies and a narrow solve's promotion test needs
    no read of its own."""
    state = adapter.init()
    prev = state  # last healthy chunk-boundary carry: the rollback point
    k = k_state = k_prev = 0
    inf = float("inf")
    diff_state = diff_prev = inf
    nrec = consecutive = stag_strikes = sdc_strikes = 0
    reads = 0
    max_iter = problem.max_iterations

    while True:
        _check_deadline(timeout, t0, k, adapter)
        stop = plan.next_stop(k - 1)  # a fault AT k fires before this chunk
        limit = min(k + chunk, max_iter)
        if stop is not None and k < stop:
            limit = min(limit, stop)
        failure = None
        try:
            run_state = plan.apply(
                k, state, adapter.FIELDS, adapter.BD, adapter.ZR,
                mesh=adapter.mesh,
            ) if plan else state
            new = adapter.advance(run_state, k_state, limit)
            word, k_new, diff_new = adapter.probe(new, state, limit).tolist()
            reads += 1
            word, k_new = int(word), int(k_new)
        except SolveError:
            raise
        except Exception as e:  # noqa: BLE001 — classified, re-raised below
            if classify_error(e) != "oom":
                raise  # unknown failures stay loud, never retried
            failure = (str(e), isinstance(e, torch.OutOfMemoryError))
        if failure is not None:
            # out of the except block, the traceback's tensors are gone
            text, real = failure
            if real:
                _release_device_memory()
            nrec += 1
            if nrec > max_recoveries:
                raise OutOfMemoryError(
                    f"OOM after {max_recoveries} recoveries: {text}", iters=k
                )
            fb = adapter.fallback()
            if fb is None:
                raise OutOfMemoryError(
                    f"{adapter.engine} hit RESOURCE_EXHAUSTED with no "
                    f"smaller engine to degrade to: {text}",
                    iters=k,
                )
            adapter2, convert = fb
            _record(
                events, "engine-fallback", k, 0, adapter2.engine,
                detail=f"oom on {adapter.engine}: {text}",
            )
            state = prev = adapter2.recover(convert(prev))
            k_state, diff_state = k_prev, diff_prev
            adapter = adapter2
            consecutive = 1
            stag_strikes = 0
            continue

        if word & HEALTH_SDC and not word & HEALTH_NONFINITE:
            # silent corruption: roll back and re-run, never restart
            nrec += 1
            if sdc_strikes >= 1 or nrec > max_recoveries:
                raise SilentCorruptionError(
                    "silent data corruption re-detected after a clean "
                    f"rollback-and-rerun at iteration ~{k_prev} — "
                    "persistent corruption source; refusing to return "
                    "an iterate it may have touched",
                    iters=k_prev,
                )
            _record(
                events, "sdc-rollback", k_prev, word, adapter.engine,
                detail="ABFT checksum/invariant violation; rolling back "
                "to the last healthy chunk boundary and re-running",
            )
            state = prev
            k = k_state = k_prev
            diff_state = diff_prev
            sdc_strikes += 1
            stag_strikes = 0
            continue

        storage = adapter.storage_dtype
        if storage is not None and not word & _UNHEALTHY:
            # a narrow-storage solve never finishes narrow: promote when
            # it claims convergence, or when a full chunk no longer halved
            # the step norm (the storage floor). The designed finish, not
            # a failure: it spends no recovery budget, and happens once.
            db, da = diff_state, diff_new
            full_chunk = (limit - k) >= chunk
            at_floor = (
                full_chunk and da == da and db == db
                and db != inf and da >= 0.5 * db
            )
            if word & HEALTH_CONVERGED or at_floor:
                adapter2, convert = adapter.promote()
                _record(
                    events, "storage-promotion", k_new, word,
                    adapter2.engine,
                    detail=f"{dtype_name(storage)} storage -> "
                    f"{dtype_name(adapter.dtype)} compute ("
                    + ("converged at storage width"
                       if word & HEALTH_CONVERGED else "storage floor")
                    + "); polishing at full width",
                )
                state = prev = adapter2.recover(convert(new))
                k = k_state = k_prev = k_new
                diff_state = diff_prev = diff_new
                adapter = adapter2
                consecutive = 0
                stag_strikes = 0
                sdc_strikes = 0
                continue

        if word & HEALTH_CONVERGED and not word & _UNHEALTHY:
            drift = _residual_drift(adapter, new)
            reads += 1
            if drift <= RESIDUAL_DRIFT_TOL:
                state = new
                break
            # the stopping rule fired on a drifted recurrence: treat as
            # stagnation and recover now (it cannot resolve itself)
            word = (word & ~HEALTH_CONVERGED) | HEALTH_STAGNATION
            stag_strikes = 1
        if not word & _UNHEALTHY:
            state = prev = new
            k = limit
            k_state = k_prev = k_new
            diff_state = diff_prev = diff_new
            consecutive = 0
            stag_strikes = 0
            sdc_strikes = 0
            if k >= max_iter:
                break
            continue

        if (
            (word & _UNHEALTHY) == HEALTH_STAGNATION
            and stag_strikes == 0
            and limit < max_iter
        ):
            # debounce pure stagnation one chunk (a recovery legitimately
            # bumps zr/diff while CG re-adapts); prev stays pinned
            stag_strikes = 1
            state = new
            k = limit
            k_state, diff_state = k_new, diff_new
            continue

        # ---- unhealthy chunk: walk the recovery ladder -------------------
        nrec += 1
        if nrec > max_recoveries:
            raise DivergedError(
                f"recovery budget exhausted ({max_recoveries}): solve is "
                f"{health_name(word)} at iteration ~{k}",
                iters=k,
            )
        # breakdown discards its own update, so the carry it stops with
        # is trustworthy; NaN/stagnation poison the chunk — roll back
        if (word & _UNHEALTHY) == HEALTH_BREAKDOWN:
            base, k, base_diff = new, k_new, diff_new
        else:
            base, k, base_diff = prev, k_prev, diff_prev
        stag_strikes = 0

        if consecutive == 0:
            _record(events, "residual-restart", k, word, adapter.engine)
            state = prev = adapter.recover(base)
            consecutive = 1
        else:
            esc = adapter.escalate()
            fb = adapter.fallback() if esc is None else None
            if esc is None and fb is None:
                raise DivergedError(
                    f"recovery ladder exhausted: {adapter.engine} solve "
                    f"still {health_name(word)} at iteration ~{k} after "
                    "restart",
                    iters=k,
                )
            adapter2, convert = esc or fb
            if esc is not None:
                _record(
                    events, "precision-escalation", k, word, adapter2.engine,
                    detail=f"{dtype_name(adapter.dtype)} -> "
                    f"{dtype_name(adapter2.dtype)}",
                )
            else:
                _record(
                    events, "engine-fallback", k, word, adapter2.engine,
                    detail=f"from {adapter.engine}",
                )
            state = prev = adapter2.recover(convert(base))
            adapter = adapter2
            consecutive = 1
        k_state = k_prev = k
        diff_state = diff_prev = base_diff

    return GuardedResult(
        result=adapter.result(state),
        recoveries=tuple(events),
        engine=adapter.engine,
        dtype=dtype_name(adapter.dtype),
        host_syncs=reads,
    )


def _fire_whole_solve_oom(plan: FaultPlan) -> None:
    """Whole-solve engines have no iteration boundaries: a pending
    ``oom`` fault fires at the next engine attempt."""
    for fault in plan.faults:
        if not fault.fired and fault.kind == "oom":
            fault.fired = True
            raise SimulatedResourceExhausted(
                "RESOURCE_EXHAUSTED: simulated device OOM (fault "
                "injection, whole-solve attempt)"
            )


def _guarded_whole_solve(problem: Problem, engine: str, dtype, *,
                         chunk: int, max_recoveries: int, timeout, t0,
                         plan: FaultPlan, events: list, device,
                         capacity) -> GuardedResult:
    """The guard of the whole-solve engines: check the solve's result,
    degrade down the capacity ladder on an OOM or an unhealthy result,
    and finish on the chunked guarded xla loop."""
    from poisson_ellipse_tpu_torch.solver.engine import (
        build_solver,
        select_engine,
    )

    if any(not f.fired and f.kind != "oom" for f in plan.faults):
        raise ValueError(
            "carry-field faults need a chunked engine (xla/pallas/"
            f"pipelined/pipelined-pallas); {engine!r} runs whole-solve "
            "and only supports 'oom' injection"
        )
    resolved = (select_engine(problem, dtype, capacity) if engine == "auto"
                else engine)
    if resolved in _CAPACITY_LADDER:
        chain = _CAPACITY_LADDER[_CAPACITY_LADDER.index(resolved):]
    else:
        chain = (resolved,)

    nrec = 0
    reads = 0
    for cand in chain:
        _check_deadline(timeout, t0, 0)
        failure = None
        try:
            _fire_whole_solve_oom(plan)
            solver, args, _ = build_solver(problem, cand, dtype, device,
                                           capacity=capacity)
            result = solver(*args)
            finite, broke = torch.stack([
                torch.isfinite(result.w).all(), result.breakdown]).tolist()
            reads += solver.host_syncs + 1
            if finite and not broke:
                return GuardedResult(
                    result=result,
                    recoveries=tuple(events),
                    engine=cand,
                    dtype=dtype_name(dtype),
                    host_syncs=reads,
                )
            word = HEALTH_BREAKDOWN if broke else HEALTH_NONFINITE
            detail = f"unhealthy whole-solve result from {cand}"
            del solver, args, result
        except SolveError:
            raise
        except Exception as e:  # noqa: BLE001 — classified, re-raised below
            if classify_error(e) != "oom":
                raise  # unknown failures stay loud
            failure = (f"oom on {cand}: {e}",
                       isinstance(e, torch.OutOfMemoryError))
        if failure is not None:
            detail, real = failure
            word = 0
            if real:
                _release_device_memory()
        nrec += 1
        if nrec > max_recoveries:
            raise OutOfMemoryError(
                f"recovery budget exhausted ({max_recoveries}) degrading "
                f"the capacity ladder at {cand}",
                iters=0,
            )
        # the event names the engine fallen back TO; the failed one rides
        # in the detail
        idx = chain.index(cand)
        target = chain[idx + 1] if idx + 1 < len(chain) else "xla"
        _record(events, "engine-fallback", 0, word, target, detail=detail)

    # the ladder's floor: the chunked guarded xla loop
    remaining_timeout = (
        None if timeout is None
        else max(timeout - (time.monotonic() - t0), 0.1)
    )
    adapter = _ClassicalAdapter(problem, dtype, stencil="xla", device=device)
    out = _run_chunked(
        problem, adapter, chunk=chunk,
        max_recoveries=max(max_recoveries - nrec, 0),
        timeout=remaining_timeout, t0=time.monotonic(), plan=plan,
        events=events,
    )
    return out._replace(host_syncs=out.host_syncs + reads)
