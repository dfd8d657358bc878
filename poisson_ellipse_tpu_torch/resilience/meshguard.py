"""Degraded-mesh recovery: survive the ranks the solve runs on.

The port's counterpart of ``poisson_ellipse_tpu.resilience.meshguard``.
``resilience.guard`` recovers numerical failure on a healthy mesh; this
module recovers the mesh itself:

1. **Detect at chunk boundaries.** A lost rank surfaces as a classified
   dispatch error (``errors.is_device_loss_error``: the runtime's
   phrasings or the injected ``SimulatedDeviceLoss``), a straggler as a
   chunk past ``chunk_deadline_s`` on the first rank's clock (the first
   chunk on a new mesh is exempt: it builds the kernels). ABFT flags
   (``abft=True``) are read at the same boundary and answered by a reload
   of the last checkpoint and a re-run, before a flagged carry could be
   saved; a second flag from the clean reload raises
   ``SilentCorruptionError`` (exit 6).
2. **Durable state, elastic layout.** Every chunk boundary saves the
   classical 8-field carry through ``solver.checkpoint`` (the mesh's
   first rank writes, after one gather); a step written on another mesh
   shape is resharded on restore.
3. **Shrink and resume.** On detection: a ``degrade:mesh`` trace event,
   the survivors' near-square mesh (``parallel.elastic.shrink_mesh``, a
   process group of their own), the last durable step restored, and the
   solve goes on. ``max_degrades`` shrinks (or no survivor) raise the
   classified ``DeviceLossError`` (exit 7).

A mesh here is one process a rank, so every decision is taken from the
same bits on every rank: k and the flags are reduced scalars, the ABFT
flag too, the deadline is the first rank's verdict, the restored step
the first rank's choice. A rank the ladder drops issues no halo
exchange, reduction or launch after its degrade: it follows. At each
later degrade the old mesh's first rank tells the followers the
survivors (one broadcast over the original group) and every process
makes the survivors' group, so every process numbers its groups alike;
at the end the last mesh's first rank sends the outcome, and every
process of the original mesh ends with the same ``ElasticResult`` or
the same exception. The original mesh spans the default process group.
The trace events are written by the first surviving rank. A process
that really dies ends its group's collectives, which no in-process
recovery survives (ROADMAP: it waits for a multi-card machine).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
import torch.distributed as dist

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.obs import trace as obs_trace
from poisson_ellipse_tpu_torch.resilience.errors import (
    DeviceLossError,
    SilentCorruptionError,
    classify_error,
)
from poisson_ellipse_tpu_torch.resilience.faultinject import FaultPlan
from poisson_ellipse_tpu_torch.solver.pcg import PCGResult

# the classical sharded carry's addressing (the faults' fields)
_FIELDS = {"w": 1, "r": 2, "p": 3, "zr": 4}
_BD, _ZR = 7, 4

DEFAULT_CHUNK = 64


@dataclasses.dataclass(frozen=True)
class MeshEvent:
    """One mesh-level action: what was detected and what the guard did."""

    kind: str       # degrade:mesh / sdc-rollback
    at_iter: int
    cause: str      # device-loss / straggler-deadline / abft
    mesh_before: tuple[int, int]
    mesh_after: tuple[int, int]


@dataclasses.dataclass
class ElasticResult:
    """A mesh-guarded solve's outcome: the ``PCGResult`` (w the global
    solution), the degradation story (no events: the first mesh survived),
    the mesh shape that finished the solve and the degrades it took."""

    result: PCGResult
    events: tuple
    mesh_shape: tuple[int, int]
    degrades: int


def elastic_solve(
    problem: Problem,
    mesh=None,
    dtype=torch.float32,
    *,
    directory: str,
    chunk: int = DEFAULT_CHUNK,
    abft: bool = False,
    chunk_deadline_s: Optional[float] = None,
    faults: Optional[FaultPlan] = None,
    max_degrades: int = 2,
    stencil: str = "xla",
    device=None,
) -> ElasticResult:
    """Solve on ``mesh`` (every rank of it calling together) with rank
    loss and straggler detection and degraded-mesh recovery (the module
    docstring). ``directory`` holds the checkpoints every chunk boundary
    writes: it is the recovery point, so it must be one every rank sees
    and that outlives the ranks.

    ``chunk_deadline_s`` arms the straggler check: a chunk that overruns
    it degrades the mesh as a loss does, dropping the straggler the fault
    plan names, else the highest rank (the hedge policy). ``stencil`` is
    the classical stepper's (``xla``, as the JAX package runs it, or
    ``pallas``, K-a on every rank)."""
    outcome, _ = run_elastic(problem, mesh, dtype, directory=directory,
                             chunk=chunk, abft=abft,
                             chunk_deadline_s=chunk_deadline_s,
                             faults=faults, max_degrades=max_degrades,
                             stencil=stencil, device=device)
    if isinstance(outcome, BaseException):
        raise outcome
    return outcome


def run_elastic(problem: Problem, mesh=None, dtype=torch.float32, *,
                directory: str, chunk: int = DEFAULT_CHUNK,
                abft: bool = False,
                chunk_deadline_s: Optional[float] = None,
                faults: Optional[FaultPlan] = None, max_degrades: int = 2,
                stencil: str = "xla", device=None):
    """``elastic_solve``'s (outcome, run): the outcome the ElasticResult
    or the exception every rank raises, the run holding this rank's
    ``dropped`` counts (the collectives and launches it had made when the
    ladder dropped it, or None)."""
    from poisson_ellipse_tpu_torch.parallel.mesh import make_mesh

    if mesh is None:
        mesh = make_mesh(device=device)
    if mesh.ranks is not None and mesh.world > 1:
        raise ValueError(
            "elastic_solve runs over the whole process group (its degrades "
            "make groups every process joins); pass make_mesh()'s mesh"
        )
    run = _ElasticRun(problem, dtype, directory, chunk, abft,
                      chunk_deadline_s,
                      faults if faults is not None else FaultPlan(),
                      max_degrades, stencil, mesh)
    try:
        outcome = run.solve(mesh)
    except Exception as e:  # noqa: BLE001 — sent to the followers, raised
        if not run.degrades:
            raise  # every rank of the mesh is here and raises the same
        outcome = e
    if run.degrades and run.dropped is None:
        # the last mesh's first rank sends the outcome to the followers
        run.control(("done", _to(outcome, "cpu")), run.mesh.peer(0))
    return outcome, run


class _ElasticRun:
    """The mesh-guarded loop on one rank: one pass per mesh incarnation."""

    def __init__(self, problem: Problem, dtype, directory: str, chunk: int,
                 abft: bool, deadline: Optional[float], plan: FaultPlan,
                 max_degrades: int, stencil: str, original):
        self.problem = problem
        self.dtype = dtype
        self.directory = directory
        self.chunk = chunk
        self.abft = abft
        self.deadline = deadline
        self.plan = plan
        self.max_degrades = max_degrades
        self.stencil = stencil
        self.events: list[MeshEvent] = []
        self.degrades = 0
        self.dropped = None
        self.original = original
        self.mesh = original

    def control(self, message, src: int):
        """``message`` from global rank ``src`` to every process of the
        original mesh (one broadcast of a small object)."""
        if self.original.backend == "none":
            return message
        box = [message]
        dist.broadcast_object_list(box, src=src, group=self.original.group)
        return box[0]

    def follow(self, src: int):
        """A dropped rank's wait: it joins each later degrade's group
        making (it issues nothing else) until the outcome comes."""
        from poisson_ellipse_tpu_torch.parallel.elastic import (
            join_survivors,
        )

        while True:
            kind, value = self.control(None, src)
            if kind == "done":
                return _to(value, self.original.device)
            join_survivors(self.original, value)
            src = value[0]

    def solve(self, mesh):
        """This rank's outcome: the survivors' ``ElasticResult``; on a
        rank the ladder dropped, the outcome it follows to (the
        ElasticResult or the exception the last mesh's first rank
        sends)."""
        from poisson_ellipse_tpu_torch.parallel.elastic import (
            join_survivors,
            surviving_devices,
        )
        from poisson_ellipse_tpu_torch.parallel.mesh import (
            choose_process_grid,
        )
        from poisson_ellipse_tpu_torch.solver.checkpoint import (
            CheckpointingSolver,
        )

        while True:  # one pass per mesh incarnation
            self.mesh = mesh
            store = CheckpointingSolver(self.problem, self.directory,
                                        chunk=self.chunk, dtype=self.dtype,
                                        stencil=self.stencil, mesh=mesh)
            try:
                found = self._on_mesh(mesh, store)
                if isinstance(found, ElasticResult):
                    return found
                lost, cause = found
            except Exception as e:  # noqa: BLE001 — classified; others raised
                if classify_error(e) != "device-loss":
                    raise
                present = set(mesh.global_ranks)
                named = getattr(e, "device", None)
                lost = [named] if named in present else [
                    d for d in self.plan.lost_devices() if d in present]
                lost = lost or [max(present)]
                cause = "device-loss"
            finally:
                store.close()
            # every rank's writes have landed before the survivors read
            mesh.barrier()

            # ---- degrade: shrink the mesh, resume from the checkpoint ----
            self.degrades += 1
            shape = mesh.shape
            if self.degrades > self.max_degrades:
                raise DeviceLossError(
                    f"mesh degraded {self.degrades - 1} time(s) already and "
                    f"{cause} struck again — degradation budget exhausted",
                    iters=None,
                )
            survivors = surviving_devices(mesh, lost)
            if not survivors:
                raise DeviceLossError(
                    f"all {mesh.world} mesh devices lost "
                    f"({sorted(set(lost))}) — no degraded mesh remains to "
                    "resume on"
                )
            # the ranks dropped earlier learn the survivors, and every
            # process makes their group
            self.control(("degrade", survivors), mesh.peer(0))
            new_mesh = join_survivors(mesh, survivors)
            after = choose_process_grid(len(survivors))
            if new_mesh is not None and new_mesh.rank == 0:
                obs_trace.event(
                    "degrade:mesh",
                    cause=cause,
                    lost_devices=sorted(lost),
                    from_mesh=list(shape),
                    to_mesh=list(after),
                )
            self.events.append(MeshEvent("degrade:mesh", 0, cause, shape,
                                         after))
            if new_mesh is None:
                from poisson_ellipse_tpu_torch.ops import _build
                from poisson_ellipse_tpu_torch.parallel.mesh import (
                    COLLECTIVES,
                )

                self.dropped = {"collectives": dict(COLLECTIVES),
                                "launches": dict(_build.LAUNCHES)}
                return self.follow(survivors[0])
            mesh = new_mesh

    def _on_mesh(self, mesh, store):
        """Chunks on one mesh incarnation until the solve ends (the
        ``ElasticResult``) or a straggler degrades it ((lost, cause));
        a lost rank raises out of here."""
        from poisson_ellipse_tpu_torch.parallel.pcg_sharded import (
            gather_w,
            sharded_result_of,
            stepper_parts,
        )

        problem, plan = self.problem, self.plan
        parts = stepper_parts(problem, mesh, self.dtype, self.stencil,
                              self.abft)
        restored = store.restore_latest()
        if restored is None:
            state = parts.init()
        else:
            # a restored carry has no shadow tail: the recover rebuilds r
            # and anchors it against this mesh's reductions
            state = parts.recover(restored) if self.abft else restored
        max_iter = problem.max_iterations
        sdc_strikes = 0
        # the first chunk on a (re)built mesh builds its kernels: the
        # deadline judges the steady-state chunks only
        first_chunk = True
        while True:
            k, converged, breakdown = (int(v) for v in torch.stack([
                state.k, state.converged.to(state.k.dtype),
                state.breakdown.to(state.k.dtype)]).tolist())
            if converged or breakdown or k >= max_iter:
                result = sharded_result_of(problem, state)
                return ElasticResult(
                    result=result._replace(w=gather_w(problem, mesh,
                                                      result.w)),
                    events=tuple(self.events),
                    mesh_shape=mesh.shape,
                    degrades=self.degrades,
                )
            stop = plan.next_stop(k - 1)
            limit = min(k + self.chunk, max_iter)
            if stop is not None and k < stop:
                limit = min(limit, stop)
            t0 = time.monotonic()
            # dispatch faults (device_loss raises, straggler sleeps) and
            # carry faults fire here, exactly at the boundary
            run_state = plan.apply(k, state, _FIELDS, _BD, _ZR,
                                   mesh=mesh) if plan else state
            new = parts.advance(run_state, limit, k)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)  # the deadline's fence
            elapsed = time.monotonic() - t0
            was_first, first_chunk = first_chunk, False
            if self.deadline is not None and not was_first and (
                    mesh.agree_first(elapsed > self.deadline)):
                # only ranks still in this mesh count: an earlier degrade
                # already dropped theirs
                present = set(mesh.global_ranks)
                lost = [d for d in plan.lost_devices() if d in present]
                return lost or [max(present)], "straggler-deadline"
            if self.abft and bool(new.sdc):
                # the durable checkpoint is the rollback point: reload it
                # and re-run the chunk; the flagged carry is never saved
                sdc_strikes += 1
                if sdc_strikes > 1:
                    raise SilentCorruptionError(
                        "silent corruption re-detected after a clean "
                        f"reload at iteration ~{k} — persistent SDC source "
                        "under this mesh",
                        iters=k,
                    )
                if mesh.rank == 0:
                    obs_trace.event(
                        "recovery:sdc-rollback", iter=k, engine=self.stencil,
                        detail="meshguard: reload last checkpoint + rerun",
                    )
                self.events.append(MeshEvent("sdc-rollback", k, "abft",
                                             mesh.shape, mesh.shape))
                reloaded = store.restore_latest()
                state = (parts.init() if reloaded is None
                         else parts.recover(reloaded))
                continue
            sdc_strikes = 0
            state = new
            store.save(state)


def _to(outcome, device):
    """An outcome with its result's tensors on ``device`` (an exception
    as it is)."""
    if not isinstance(outcome, ElasticResult):
        return outcome
    result = outcome.result._replace(**{
        f: getattr(outcome.result, f).to(device)
        for f in outcome.result._fields})
    return dataclasses.replace(outcome, result=result)
