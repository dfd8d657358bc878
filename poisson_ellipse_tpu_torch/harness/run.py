"""One measured solve: the reference's ``main`` driver on one device.

Phases as the reference splits them (init + solver + finalize,
``poisson_mpi_cuda2.cu:992-1034``): init is the host assembly and the
upload; the first solve is a warm-up outside every timed phase (on the
card it also builds the kernels); T_solver is the median of ``repeat``
timed solves; finalize is the L2 error against the analytic solution.

``lanes > 1`` runs that many solves of the problem in one loop on a
lane-batched engine (``auto`` resolves to ``batched``, as in the JAX
harness). The report reduces the lanes as the JAX one does: iterations
and step norm of the worst lane, converged only if every lane converged,
breakdown if any lane broke down, the L2 error of lane 0, and
``solves_per_sec = lanes / T_solver``. A batched run reports no roofline.

``storage_dtype`` ("bf16", "f16" or "f32") runs the storage-vs-compute
split (``ops.precision``); the report carries it, and the roofline counts
the bytes at the storage width (on ``streamed`` and ``xl``, which store
only their operands narrow, those passes alone). ``dtype="bf16"`` is bf16
compute on every engine the JAX harness runs it on (``auto`` walks the
resident → streamed → xl ladder with the gates at 2 bytes a node), the
lane-batched engines and every engine of the mesh included, as the JAX
harness's ``--dtype bf16``.

``mode="sharded"`` runs the mesh (``parallel``): ``mesh_shape`` (px, py)
ranks of a ``torch.distributed`` group each solve their block with
``engine`` ``xla`` (``auto``), ``pallas`` (K-a on every rank), ``fused``
(K1-shard and K2-shard), ``pipelined`` (one reduction an iteration) or
``sstep`` / ``sstep-pallas`` (one deep halo exchange and one reduction per
``sstep_s`` iterations, the one sharded engine that takes
``storage_dtype``; both names run ``sstep``, as in the JAX harness). With
``lanes`` > 1 or a lane-batched engine each rank solves ``lanes / world``
whole lanes instead (``parallel.batched_sharded``, one reduction an
iteration), in the classical recurrence unless the engine is
``batched-pipelined``, as the JAX harness routes them. Inside a group
(torchrun, ``multihost.spawn``) every rank calls ``run_once`` together
and gets the report; without one,
``run_once`` starts the px·py rank processes itself
(``multihost.spawn``) and returns rank 0's. The backend follows the
layout: NCCL when each rank has a card of its own, gloo on the CPU and
when ranks share a card. The warm-up is one chunk of iterations (it loads
the kernels and opens the group's connections); T_solver is rank 0's
solve up to its owned block (its lanes), after a barrier; the global w (the
lanes) is gathered for the L2 error afterwards. The report names the mesh
and the backend and counts the timed solve's loop bodies, collectives
(every rank's) and kernel launches (every rank's).

``guard=True`` (or any ``timeout``) routes one solve through
``resilience.guard.guarded_solve``: the bodies in chunks with a health
word a chunk, the recovery ladder, classified ``SolveError``s instead of
NaN results, ``timeout`` seconds checked at each chunk boundary
(``SolveTimeout``, exit 4 on the command line); with ``lanes`` > 1 or a
lane-batched engine, through the chunked lane driver
(``batch.driver.solve_batched``). ``checkpoint_dir`` runs one
``solver.checkpoint.CheckpointingSolver`` solve (``xla`` or ``pallas``),
saving the carry every ``chunk`` iterations and resuming from the newest
valid step there. Both are timed by a plain wall clock around the one
solve, after a device fence, as the JAX harness times them (a restartable
solve is not the bench protocol); the report's ``recoveries`` lists the
guard's recovery kinds in order, and a resumed run's roofline covers only
the iterations it ran (``timed_iters``). With ``mode="sharded"`` both run
on the mesh, every rank together (``guarded_solve(mesh=)``,
``CheckpointingSolver(mesh=)``; a step written on another mesh shape
resumes resharded), and rank 0's report is the run's; a classified
``SolveError`` (or a refusal) raised in the ranks is raised by
``run_once`` as it is.
"""

from __future__ import annotations

import math
import statistics
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from poisson_ellipse_tpu_torch.harness.roofline import roofline
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.parallel.mesh import (
    COLLECTIVES,
    Mesh,
    make_mesh,
    reset_collectives,
)
from poisson_ellipse_tpu_torch.parallel.batched_sharded import (
    build_batched_sharded_solver,
    gather_lanes,
)
from poisson_ellipse_tpu_torch.parallel.multihost import spawn
from poisson_ellipse_tpu_torch.parallel.pcg_sharded import (
    build_sharded_solver,
    gather_w,
)
from poisson_ellipse_tpu_torch.parallel.sstep_sharded import (
    build_sstep_sharded_solver,
)
from poisson_ellipse_tpu_torch.solver.engine import (
    BATCHED_ENGINES,
    ENGINES,
    SHARDED_ENGINES,
    build_solver,
)
from poisson_ellipse_tpu_torch.solver.pcg import DEFAULT_CHUNK
from poisson_ellipse_tpu_torch.utils.device import capacity, resolve_device
from poisson_ellipse_tpu_torch.utils.error import l2_error_vs_analytic
from poisson_ellipse_tpu_torch.utils.timing import PhaseTimer

DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}


@dataclass
class RunReport:
    """The reference's rank-0 summary plus L2 error and the roofline."""

    problem: Problem
    mesh_shape: tuple[int, int]
    dtype: str
    engine: str
    iters: int
    converged: bool
    breakdown: bool
    diff: float
    l2_error: float
    t_init: float
    t_solver: float
    times: list[float] = field(default_factory=list)
    passes_per_iter: float = 0.0
    hbm_gbps: float | None = None
    hbm_peak_frac: float | None = None
    device: str = "cpu"
    host_syncs: int = 0
    # lane width of a batched run (1: the single-solve protocol), the
    # throughput it achieved (lanes / T_solver) and the lanes quarantined
    # after a non-finite carry
    lanes: int = 1
    solves_per_sec: float | None = None
    quarantined: int = 0
    # the storage width of the state and operands when one was asked for
    # ("bf16": ops.precision); None = storage == compute
    storage_dtype: str | None = None
    # a sharded run: the group's backend ("gloo", "nccl", "none" for one
    # rank without a group), the loop bodies the timed solve issued, and
    # each rank's collectives and kernel launches in it
    backend: str | None = None
    bodies: int = 0
    rank_collectives: list = field(default_factory=list)
    rank_launches: list = field(default_factory=list)
    # iterations T_solver covers when it differs from ``iters``: a resumed
    # checkpointed run times only the iterations it ran
    timed_iters: int | None = None
    # the recovery actions of a guarded run (resilience.guard event kinds,
    # in order); empty: the healthy path ran start to finish
    recoveries: list = field(default_factory=list)

    def summary(self) -> str:
        p = self.problem
        if self.converged:
            status = f"Converged after {self.iters} iterations (diff={self.diff:.3e})"
        elif self.breakdown:
            status = f"BREAKDOWN after {self.iters} iterations"
        else:
            status = (f"NOT converged after {self.iters} iterations "
                      f"(diff={self.diff:.3e})")
        lines = [
            f"Grid: {p.M} x {p.N}  (h1={p.h1:.6g}, h2={p.h2:.6g}, "
            f"eps={p.eps_value:.6g}, delta={p.delta:g}, norm={p.norm})",
            *([f"Mesh: {self.mesh_shape[0]}x{self.mesh_shape[1]} ranks, "
               f"backend {self.backend}"] if self.backend else []),
            f"Device: {self.device}  dtype={self.dtype}"
            + (f" (storage {self.storage_dtype})" if self.storage_dtype
               else "")
            + f"  engine={self.engine}",
            status,
            f"T_init   {self.t_init:10.4f} s",
            f"T_solver {self.t_solver:10.4f} s"
            + (f"  (median of {len(self.times)})" if len(self.times) > 1
               else ""),
            f"Host syncs per solve: {self.host_syncs}",
            f"L2 error vs analytic: {self.l2_error:.6e}",
        ]
        if self.lanes > 1:
            lines.append(
                f"Lanes: {self.lanes}  throughput {self.solves_per_sec:.2f} "
                "solves/s"
                + (f"  ({self.quarantined} lane(s) quarantined)"
                   if self.quarantined else "")
            )
        if self.recoveries:
            lines.append(f"Recoveries: {len(self.recoveries)} "
                         f"({', '.join(self.recoveries)})")
        n = self.timed_iters if self.timed_iters is not None else self.iters
        if self.hbm_gbps is not None and n:
            frac = (f"  ({self.hbm_peak_frac:.1%} of peak)"
                    if self.hbm_peak_frac is not None else "")
            lines.append(
                f"Roofline: {self.t_solver / n * 1e6:.1f} us/iter, "
                f"{self.passes_per_iter:g} passes/iter -> "
                f"{self.hbm_gbps:.0f} GB/s{frac}"
            )
        return "\n".join(lines)

    def json_dict(self) -> dict:
        """The JAX package's ``RunReport.json_dict`` keys for a single-mode
        run, so reports from the two packages diff key for key."""
        p = self.problem
        return {
            "M": p.M,
            "N": p.N,
            "mesh": list(self.mesh_shape),
            "dtype": self.dtype,
            "engine": self.engine,
            "eps": p.eps_value,
            "delta": p.delta,
            "iters": self.iters,
            "converged": self.converged,
            "diff": self.diff,
            "l2_error": self.l2_error if math.isfinite(self.l2_error) else None,
            "t_init_s": self.t_init,
            "t_solver_s": self.t_solver,
            "passes_per_iter": self.passes_per_iter,
            "hbm_gbps": self.hbm_gbps,
            "hbm_peak_frac": self.hbm_peak_frac,
            **({"recoveries": self.recoveries} if self.recoveries else {}),
            **({"lanes": self.lanes, "solves_per_sec": self.solves_per_sec,
                "quarantined": self.quarantined} if self.lanes > 1 else {}),
            **({"storage_dtype": self.storage_dtype}
               if self.storage_dtype else {}),
            **({"backend": self.backend} if self.backend else {}),
        }


def resolve_mesh(mesh_shape: tuple[int, int] | None = None,
                 device=None) -> Mesh:
    """This rank's mesh: explicit PX×PY, or near-square over every rank
    of the group (the reference's ``choose_process_grid`` policy); raises
    when the shape does not match the group's size."""
    return make_mesh(None if mesh_shape is None else tuple(mesh_shape),
                     device)


def check_sharded(engine: str, lanes: int = 1,
                  storage_dtype: str | None = None) -> str:
    """The engine a sharded run takes, with the JAX harness's refusals.

    ``auto`` → ``xla``, or ``batched`` with ``lanes`` > 1. On the spatial
    mesh: ``xla``, ``pipelined`` and ``sstep`` in f32, f64 and bf16;
    ``pallas`` (K-a) and ``fused`` (K1-shard and K2-shard) in f32 and bf16,
    f64 raising in ``build_sharded_solver`` as in the JAX package;
    ``sstep-pallas`` runs ``sstep``, and ``storage_dtype`` is taken by the
    s-step engine alone. ``lanes`` > 1 or a lane-batched engine shards whole lanes over
    the ranks, in f32, f64 and bf16. A single-device engine gets the JAX
    harness's refusal, whose text names the JAX package's sharded
    engines."""
    if lanes < 1:
        raise ValueError("lanes must be >= 1")
    if lanes > 1 or engine in BATCHED_ENGINES:
        if engine == "auto":
            engine = "batched"
        if engine not in BATCHED_ENGINES:
            raise ValueError(
                f"engine {engine!r} runs one solve per dispatch; "
                "--lanes needs --engine batched or batched-pipelined"
            )
    if storage_dtype is not None and engine not in ("sstep", "sstep-pallas"):
        raise ValueError(
            "sharded --storage-dtype covers the sstep engine (whose "
            "deep-halo exchange ships the narrow state); the classical/"
            "pipelined/batched sharded forms run full width"
        )
    if engine not in ("auto", "sstep-pallas") + BATCHED_ENGINES + (
            SHARDED_ENGINES):
        raise ValueError(
            f"engine {engine!r} is single-device only; sharded mode "
            "runs the XLA block stencil ('xla', default), the "
            "per-shard Pallas stencil kernel ('pallas'), the "
            "two-kernel fused per-shard iteration ('fused', f32/bf16), "
            "the one-psum-per-iteration pipelined recurrence "
            "('pipelined'), the one-psum-per-s-iterations s-step "
            "form ('sstep'), or the preconditioned forms ('mg-pcg' / "
            "'cheb-pcg': V-cycle/Chebyshev per shard, halo-ppermute "
            "only — the scalar-collective cadence stays classical)"
        )
    if engine == "sstep-pallas":
        engine = "sstep"  # the sharded s-step runs the plain block stencil
    return "xla" if engine == "auto" else engine


def run_sharded_jobs(jobs: list, device=None) -> list:
    """``run_once(mode="sharded", **job)`` for each job on this rank of the
    group, in order: the rank function the command line and ``run_once``
    start their ranks with (``multihost.spawn``). A classified
    ``SolveError`` or a refusal (``ValueError``, ``NotImplementedError``)
    ends the list as its last entry, in place of a report: every rank
    raises it at the same point, and the caller raises it as it is."""
    from poisson_ellipse_tpu_torch.resilience.errors import SolveError

    out = []
    for job in jobs:
        try:
            out.append(run_once(**job, mode="sharded", device=device))
        except (SolveError, ValueError, NotImplementedError) as e:
            out.append(e)
            break
    return out


def raise_failed(reports: list) -> list:
    """``reports`` of ``run_sharded_jobs``, raising the error that ended
    them, if one did."""
    if reports and isinstance(reports[-1], BaseException):
        raise reports[-1]
    return reports


def _rank_counts(mesh: Mesh, counts: dict) -> list:
    """Every rank's ``counts``, in rank order."""
    if mesh.backend == "none":
        return [counts]
    out = [None] * mesh.world
    dist.all_gather_object(out, counts, group=mesh.group)
    return out


def _outcome(result, batched: bool) -> tuple:
    """(iterations, converged, breakdown, step norm, w) of a solve: of a
    batched one the worst lane's count and step norm, every lane
    converged, any lane broken down, and lane 0's solution."""
    if batched:
        return (int(result.iters.max()), bool(result.converged.all()),
                bool(result.breakdown.any()), float(result.diff.max()),
                result.w[0])
    return (int(result.iters), bool(result.converged),
            bool(result.breakdown), float(result.diff), result.w)


def _build_sharded(problem: Problem, mesh: Mesh, tdtype, engine: str,
                   sstep_s: int, lanes: int, storage_dtype):
    """(solver, args) of the sharded ``engine`` on this rank."""
    if engine in BATCHED_ENGINES:
        # the JAX harness's routing: only "batched-pipelined" runs the
        # pipelined lanes on the mesh
        return build_batched_sharded_solver(
            problem, mesh, lanes, tdtype,
            pipelined=engine == "batched-pipelined")
    if engine == "sstep":
        return build_sstep_sharded_solver(problem, mesh, tdtype, s=sstep_s,
                                          storage_dtype=storage_dtype)
    return build_sharded_solver(problem, mesh, tdtype, stencil_impl=engine)


def _run_sharded(problem: Problem, dtype: str, engine: str, repeat: int,
                 device, mesh_shape, sstep_s: int = 4, lanes: int = 1,
                 storage_dtype: str | None = None) -> RunReport:
    """The sharded run on this rank of an initialised group."""
    mesh = resolve_mesh(mesh_shape, device)
    tdtype = DTYPES[dtype]
    timer = PhaseTimer(mesh.device)
    with timer.phase("init"):
        solver, args = _build_sharded(problem, mesh, tdtype, engine, sstep_s,
                                      lanes, storage_dtype)
    # warm-up, one chunk of bodies: it loads the kernels and opens the
    # group's connections (a whole warm-up solve would double the run)
    solver(*args, limit=DEFAULT_CHUNK)
    times = []
    for _ in range(repeat):
        mesh.barrier()
        reset_collectives()
        _build.reset_launches()
        step = PhaseTimer(mesh.device)
        with step.phase("solver"):
            result = solver(*args)
        times.append(step.totals["solver"])
    counts = dict(COLLECTIVES), dict(_build.LAUNCHES)
    timer.add("solver", statistics.median(times))
    batched = engine in BATCHED_ENGINES
    with timer.phase("finalize"):
        if batched:
            result = gather_lanes(mesh, result)
        iters, converged, breakdown, diff, w = _outcome(result, batched)
        if not batched:
            w = gather_w(problem, mesh, w)
        l2 = float(l2_error_vs_analytic(problem, w))
    rank_counts = _rank_counts(mesh, counts)
    t_solver = timer.totals["solver"]
    return RunReport(
        problem=problem,
        mesh_shape=mesh.shape,
        dtype=dtype,
        engine=engine,
        iters=iters,
        converged=converged,
        breakdown=breakdown,
        diff=diff,
        l2_error=l2,
        t_init=timer.totals["init"],
        t_solver=t_solver,
        times=times,
        device=(torch.cuda.get_device_name(mesh.device)
                if mesh.device.type == "cuda" else "cpu"),
        host_syncs=solver.host_syncs,
        lanes=lanes,
        solves_per_sec=(lanes / t_solver if batched and t_solver > 0
                        else None),
        quarantined=int(result.quarantined.sum()) if batched else 0,
        storage_dtype=storage_dtype,
        backend=mesh.backend,
        bodies=solver.bodies,
        rank_collectives=[c for c, _ in rank_counts],
        rank_launches=[n for _, n in rank_counts],
    )


def run_once(problem: Problem, mode: str = "single", dtype: str = "f32",
             engine: str = "auto", repeat: int = 1,
             device=None, sstep_s: int = 4, lanes: int = 1,
             storage_dtype: str | None = None,
             mesh_shape: tuple[int, int] | None = None,
             checkpoint_dir: str | None = None, chunk: int = 500,
             timeout: float | None = None, guard: bool = False,
             max_recoveries: int = 3) -> RunReport:
    """Assemble, warm up, and time ``repeat`` solves on one device, or
    with ``mode="sharded"`` over a ``mesh_shape`` mesh of ranks;
    ``sstep_s`` is the s-step engines' block size, ``lanes`` the number of
    solves a batched engine runs together, ``storage_dtype`` the narrow
    width the state and operands are stored at. ``guard``, ``timeout`` and
    ``max_recoveries`` run one guarded solve, ``checkpoint_dir`` and
    ``chunk`` one checkpointed solve (the module docstring)."""
    if mode not in ("single", "auto", "sharded"):
        raise ValueError(f"unknown mode: {mode!r}")
    if dtype not in DTYPES:
        raise ValueError(f"unknown dtype {dtype!r} (choose from {sorted(DTYPES)})")
    if repeat < 1:
        raise ValueError("repeat must be >= 1")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine: {engine!r} (choose from {ENGINES})")
    if mode == "auto" and mesh_shape is not None:
        mode = "sharded"  # as the JAX harness: an explicit mesh is sharded
    if checkpoint_dir is not None:
        if storage_dtype is not None:
            raise ValueError(
                "checkpoint fingerprints do not cover a storage dtype "
                "yet; drop --checkpoint-dir or --storage-dtype"
            )
        if lanes > 1 or engine in BATCHED_ENGINES:
            raise ValueError(
                "checkpointing persists the single-solve PCG carry; "
                "drop --checkpoint-dir or --lanes"
            )
    if timeout is not None or guard:
        if checkpoint_dir is not None:
            raise ValueError(
                "guarded/timeout runs and checkpointed runs are separate "
                "chunked drivers; drop --checkpoint-dir or --timeout/--guard"
            )
        if repeat > 1:
            raise ValueError(
                "guarded/timeout runs are one wall-clocked chunked solve; "
                "the repeat/batch timing protocol does not apply"
            )
        if lanes > 1 and engine == "auto":
            engine = "batched"
        if lanes > 1 and engine not in BATCHED_ENGINES:
            raise ValueError(
                f"engine {engine!r} runs one solve per dispatch; "
                "--lanes needs --engine batched or batched-pipelined"
            )
        if engine in BATCHED_ENGINES:
            if mode == "sharded":
                raise ValueError(
                    "guarded batched solves run the single-device chunked "
                    "lane driver (batch.driver); drop --mesh/--mode sharded"
                )
            return _run_batched_guarded(problem, dtype, engine, lanes,
                                        timeout, device)
        if mode == "sharded":
            if dist.is_initialized():
                return _run_sharded_guarded(
                    problem, dtype, engine, timeout, max_recoveries,
                    storage_dtype, sstep_s, mesh_shape, device)
            return _in_ranks(dict(
                problem=problem, dtype=dtype, engine=engine,
                mesh_shape=mesh_shape, sstep_s=sstep_s,
                storage_dtype=storage_dtype, timeout=timeout, guard=True,
                max_recoveries=max_recoveries), device)
        return _run_guarded(problem, dtype, engine, timeout, max_recoveries,
                            storage_dtype, sstep_s, device)
    if checkpoint_dir is not None:
        if repeat > 1:
            raise ValueError(
                "checkpointed runs are one wall-clocked chunked solve; "
                "the repeat/batch timing protocol does not apply "
                "(drop --repeat/--batch or --checkpoint-dir)"
            )
        if mode == "sharded":
            if dist.is_initialized():
                return _run_sharded_checkpointed(
                    problem, dtype, engine, checkpoint_dir, chunk,
                    mesh_shape, device)
            return _in_ranks(dict(
                problem=problem, dtype=dtype, engine=engine,
                mesh_shape=mesh_shape, checkpoint_dir=checkpoint_dir,
                chunk=chunk), device)
        return _run_checkpointed(problem, dtype, engine, checkpoint_dir,
                                 chunk, device)
    if mode == "sharded":
        engine = check_sharded(engine, lanes, storage_dtype)
        if dist.is_initialized():
            return _run_sharded(problem, dtype, engine, repeat, device,
                                mesh_shape, sstep_s, lanes, storage_dtype)
        return _in_ranks(dict(
            problem=problem, dtype=dtype, engine=engine, repeat=repeat,
            mesh_shape=mesh_shape, sstep_s=sstep_s, lanes=lanes,
            storage_dtype=storage_dtype), device)
    if lanes > 1 and engine == "auto":
        engine = "batched"  # build_solver refuses lanes on any other engine
    dev = resolve_device(device)
    tdtype = DTYPES[dtype]
    cap = capacity(dev) if dev.type == "cuda" else None
    timer = PhaseTimer(dev)
    with timer.phase("init"):
        solver, args, engine = build_solver(problem, engine, tdtype, dev,
                                            capacity=cap, sstep_s=sstep_s,
                                            lanes=lanes,
                                            storage_dtype=storage_dtype)
    result = solver(*args)  # warm-up: builds the kernels on first use
    times = []
    for _ in range(repeat):
        step = PhaseTimer(dev)
        with step.phase("solver"):
            result = solver(*args)
        times.append(step.totals["solver"])
    timer.add("solver", statistics.median(times))
    return _single_report(problem, dtype, engine, result, timer, times, dev,
                          cap, solver.host_syncs, lanes, storage_dtype,
                          sstep_s)


def _single_report(problem: Problem, dtype: str, engine: str, result,
                   timer: PhaseTimer, times: list, dev, cap,
                   host_syncs: int, lanes: int = 1,
                   storage_dtype: str | None = None, sstep_s: int = 4,
                   timed_iters: int | None = None) -> RunReport:
    """The single-device report: the outcome, the L2 error (timed as the
    finalize phase) and the roofline over the iterations T_solver covers
    (none for a batched run, or for a resumed run with nothing left)."""
    t_solver = timer.totals["solver"]
    batched = engine in BATCHED_ENGINES
    iters, converged, breakdown, diff, w0 = _outcome(result, batched)
    with timer.phase("finalize"):
        l2 = float(l2_error_vs_analytic(problem, w0))
    n = timed_iters if timed_iters is not None else iters
    roof = (dict(passes_per_iter=0.0, hbm_gbps=None, hbm_peak_frac=None)
            if batched or (timed_iters is not None and n <= 0) else
            roofline(problem, engine, n, t_solver, DTYPES[dtype], dev, cap,
                     sstep_s, storage_dtype))
    return RunReport(
        problem=problem,
        mesh_shape=(1, 1),
        dtype=dtype,
        engine=engine,
        iters=iters,
        converged=converged,
        breakdown=breakdown,
        diff=diff,
        l2_error=l2,
        t_init=timer.totals.get("init", 0.0),
        t_solver=t_solver,
        times=times,
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
        host_syncs=host_syncs,
        lanes=lanes,
        solves_per_sec=(lanes / t_solver if batched and t_solver > 0
                        else None),
        quarantined=int(result.quarantined.sum()) if batched else 0,
        storage_dtype=storage_dtype,
        timed_iters=timed_iters,
        **roof,
    )


def _wall_clock(dev, run):
    """(``run()``'s value, its seconds on the host clock, the device
    fenced before and after): the plain wall clock the guarded and
    checkpointed drivers are timed by."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def _run_guarded(problem: Problem, dtype: str, engine: str,
                 timeout: float | None, max_recoveries: int,
                 storage_dtype: str | None, sstep_s: int,
                 device) -> RunReport:
    """One guarded (and/or deadlined) solve through
    ``resilience.guard.guarded_solve``, on a plain wall clock: no warm-up
    solve (a guarded solve is one solve, its kernels built inside it)."""
    from poisson_ellipse_tpu_torch.resilience.guard import guarded_solve

    dev = resolve_device(device)
    cap = capacity(dev) if dev.type == "cuda" else None
    timer = PhaseTimer(dev)
    timer.add("init", 0.0)
    guarded, t_solve = _wall_clock(dev, lambda: guarded_solve(
        problem, engine, DTYPES[dtype], timeout=timeout,
        max_recoveries=max_recoveries, storage_dtype=storage_dtype,
        sstep_s=sstep_s, device=dev, capacity=cap))
    timer.add("solver", t_solve)
    report = _single_report(problem, dtype, guarded.engine, guarded.result,
                            timer, [t_solve], dev, cap, guarded.host_syncs,
                            storage_dtype=storage_dtype, sstep_s=sstep_s)
    report.recoveries = [event.kind for event in guarded.recoveries]
    return report


def _run_batched_guarded(problem: Problem, dtype: str, engine: str,
                         lanes: int, timeout: float | None,
                         device) -> RunReport:
    """One guarded lane-batched solve through the chunked lane driver
    (``batch.driver.solve_batched``): per-chunk lane health, quarantine
    events on the trace, the chunk-boundary timeout; a plain wall
    clock."""
    from poisson_ellipse_tpu_torch.batch.driver import solve_batched

    dev = resolve_device(device)
    timer = PhaseTimer(dev)
    timer.add("init", 0.0)
    guarded, t_solve = _wall_clock(dev, lambda: solve_batched(
        problem, lanes, engine, DTYPES[dtype], timeout=timeout, device=dev))
    timer.add("solver", t_solve)
    report = _single_report(problem, dtype, engine, guarded.result, timer,
                            [t_solve], dev, None, 0, lanes=lanes)
    report.recoveries = [event.kind for event in guarded.recoveries]
    return report


def _checkpoint_engine(engine: str) -> str:
    """The checkpointed run's engine (``auto`` → ``xla``), with the JAX
    harness's refusal."""
    if engine == "auto":
        engine = "xla"
    if engine not in ("xla", "pallas"):
        raise ValueError(
            "checkpointed runs persist the XLA-loop PCG carry; "
            "--engine must be xla or pallas (the per-op/per-shard stencil "
            f"kernel), got {engine!r}"
        )
    return engine


def _run_checkpointed(problem: Problem, dtype: str, engine: str,
                      directory: str, chunk: int, device) -> RunReport:
    """One checkpointed solve, resumed from ``directory`` if it holds a
    matching checkpoint, on a plain wall clock. A resumed run's roofline
    covers only the iterations it ran."""
    from poisson_ellipse_tpu_torch.solver.checkpoint import (
        CheckpointingSolver,
    )

    engine = _checkpoint_engine(engine)
    dev = resolve_device(device)
    cap = capacity(dev) if dev.type == "cuda" else None
    timer = PhaseTimer(dev)
    with timer.phase("init"):
        solver = CheckpointingSolver(problem, directory, chunk=chunk,
                                     dtype=DTYPES[dtype], stencil=engine,
                                     device=dev)
    with solver:
        start_k = solver.latest_step() or 0
        result, t_solve = _wall_clock(dev, solver.run)
    timer.add("solver", t_solve)
    return _single_report(problem, dtype, engine, result, timer, [t_solve],
                          dev, cap, solver.host_syncs,
                          timed_iters=int(result.iters) - start_k)


def _in_ranks(job: dict, device) -> RunReport:
    """``run_once(**job, mode="sharded")`` in the mesh's rank processes,
    started here (``multihost.spawn``): rank 0's report, or the error the
    ranks ended with, raised."""
    resolve_device(device)  # no card and no CPU request: raise here
    px, py = job["mesh_shape"] or (1, 1)
    job = dict(job, mesh_shape=(px, py))
    return raise_failed(spawn(run_sharded_jobs, px * py, ([job], device),
                              device=device or "cuda"))[0]


def _mesh_report(problem: Problem, mesh: Mesh, dtype: str, engine: str,
                 result, t_solve: float, host_syncs: int,
                 timed_iters: int | None = None) -> RunReport:
    """A guarded or checkpointed mesh run's report (w the global
    solution), as the sharded runs report: the mesh and backend, no
    roofline."""
    timer = PhaseTimer(mesh.device)
    timer.add("init", 0.0)
    timer.add("solver", t_solve)
    iters, converged, breakdown, diff, w = _outcome(result, False)
    with timer.phase("finalize"):
        l2 = float(l2_error_vs_analytic(problem, w))
    return RunReport(
        problem=problem,
        mesh_shape=mesh.shape,
        dtype=dtype,
        engine=engine,
        iters=iters,
        converged=converged,
        breakdown=breakdown,
        diff=diff,
        l2_error=l2,
        t_init=0.0,
        t_solver=t_solve,
        times=[t_solve],
        device=(torch.cuda.get_device_name(mesh.device)
                if mesh.device.type == "cuda" else "cpu"),
        host_syncs=host_syncs,
        backend=mesh.backend,
        timed_iters=timed_iters,
    )


def _run_sharded_guarded(problem: Problem, dtype: str, engine: str,
                         timeout: float | None, max_recoveries: int,
                         storage_dtype: str | None, sstep_s: int,
                         mesh_shape, device) -> RunReport:
    """One guarded solve on the mesh (``guarded_solve(mesh=)``) on this
    rank, on a plain wall clock after a barrier, its build included."""
    from poisson_ellipse_tpu_torch.resilience.guard import guarded_solve

    mesh = resolve_mesh(mesh_shape, device)
    if engine == "auto":
        engine = "xla"
    mesh.barrier()
    guarded, t_solve = _wall_clock(mesh.device, lambda: guarded_solve(
        problem, engine, DTYPES[dtype], mesh=mesh, timeout=timeout,
        max_recoveries=max_recoveries, storage_dtype=storage_dtype,
        sstep_s=sstep_s))
    report = _mesh_report(problem, mesh, dtype, guarded.engine,
                          guarded.result, t_solve, guarded.host_syncs)
    report.recoveries = [event.kind for event in guarded.recoveries]
    return report


def _run_sharded_checkpointed(problem: Problem, dtype: str, engine: str,
                              directory: str, chunk: int, mesh_shape,
                              device) -> RunReport:
    """One checkpointed solve on the mesh on this rank, resumed from
    ``directory`` if it holds a step of this problem (written on any mesh
    shape), on a plain wall clock."""
    from poisson_ellipse_tpu_torch.solver.checkpoint import (
        CheckpointingSolver,
    )

    engine = _checkpoint_engine(engine)
    mesh = resolve_mesh(mesh_shape, device)
    with CheckpointingSolver(problem, directory, chunk=chunk,
                             dtype=DTYPES[dtype], stencil=engine,
                             mesh=mesh) as solver:
        start_k = solver.latest_step() or 0
        mesh.barrier()
        result, t_solve = _wall_clock(mesh.device, solver.run)
    return _mesh_report(problem, mesh, dtype, engine, result, t_solve,
                        solver.host_syncs,
                        timed_iters=int(result.iters) - start_k)
