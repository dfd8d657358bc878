"""The mesh's resilience drills as rank functions, for a caller that holds
them against a reference.

Each function is called by every rank of a process group together
(``parallel.multihost.run_jobs`` in a ``multihost.spawn``, the way
``parallel.pcg_sharded.solve_report`` is) and returns plain host data, the
same on every rank that returns it (rank 0's is what ``spawn`` hands
back): the guard's matrix of faults on one adapter, the steppers chunked
against the straight solve with their collectives a body, a carry
resharded onto a shrunk mesh, a halo exchange on a survivors' group, a
mesh checkpoint resumed on another shape, and ``elastic_solve`` with
every rank's counts at its drop. The command-line drills run through
``harness`` itself.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import _build
from poisson_ellipse_tpu_torch.parallel import mesh as mesh_mod
from poisson_ellipse_tpu_torch.parallel.mesh import make_mesh
from poisson_ellipse_tpu_torch.resilience import faultinject as fi
from poisson_ellipse_tpu_torch.resilience.errors import SolveError
from poisson_ellipse_tpu_torch.utils.error import l2_error_vs_analytic


def _counts() -> dict:
    return {"collectives": dict(mesh_mod.COLLECTIVES),
            "launches": dict(_build.LAUNCHES)}


def _host(x: torch.Tensor):
    return (x.float() if x.dtype.itemsize < 4 else x).cpu().numpy()


def _outcome(problem: Problem, guarded) -> dict:
    result = guarded.result
    return {"events": [(e.kind, e.at_iter, e.health, e.engine)
                       for e in guarded.recoveries],
            "engine": guarded.engine, "dtype": guarded.dtype,
            "iters": int(result.iters), "converged": bool(result.converged),
            "w": _host(result.w),
            "l2": float(l2_error_vs_analytic(problem, result.w)),
            "host_syncs": guarded.host_syncs, "error": None}


def _failure(e: SolveError) -> dict:
    return {"error": (type(e).__name__, e.exit_code, e.iters,
                      e.classification)}


def guard_matrix(problem: Problem, engine: str, dtype, chunk: int,
                 cells: dict, abft: bool = False, sstep_s: int = 4,
                 max_recoveries: int = 3, mesh_shape=None,
                 device=None) -> dict:
    """{cell: outcome} of the guarded mesh solve on one adapter (built
    once, as the JAX package's tests build theirs) for each ``cells``
    entry, a FaultPlan or None: the recovery events (kind, iteration,
    health word, engine), the count, the global w and its l2, or the
    classified error; with every rank's collectives and launches of the
    cell (``counts``)."""
    from poisson_ellipse_tpu_torch.resilience import guard

    mesh = make_mesh(mesh_shape, device)
    adapter = guard._make_adapter(problem, engine, dtype, mesh=mesh,
                                  abft=abft, sstep_s=sstep_s)
    out = {}
    for name, plan in cells.items():
        mesh_mod.reset_collectives()
        _build.reset_launches()
        t0 = time.perf_counter()
        try:
            got = _outcome(problem, guard._run_chunked(
                problem, adapter, chunk=chunk,
                max_recoveries=max_recoveries, timeout=None,
                t0=time.monotonic(),
                plan=plan if plan is not None else fi.FaultPlan(),
                events=[]))
        except SolveError as e:
            got = _failure(e)
        got["seconds"] = time.perf_counter() - t0
        counts = [None] * mesh.world
        if mesh.backend == "none":
            counts = [_counts()]
        else:
            dist.all_gather_object(counts, _counts(), group=mesh.group)
        got["counts"] = counts
        out[name] = got
    return out


def _stepper(problem: Problem, mesh, dtype, engine: str, abft: bool,
             sstep_s: int):
    if engine == "pipelined":
        from poisson_ellipse_tpu_torch.parallel.pipelined_sharded import (
            build_pipelined_sharded_stepper,
        )

        return build_pipelined_sharded_stepper(problem, mesh, dtype,
                                               abft=abft)
    if engine == "sstep":
        from poisson_ellipse_tpu_torch.parallel.sstep_sharded import (
            build_sstep_sharded_stepper,
        )

        return build_sstep_sharded_stepper(problem, mesh, dtype, s=sstep_s,
                                           abft=abft)
    from poisson_ellipse_tpu_torch.parallel.pcg_sharded import (
        build_sharded_stepper,
    )

    return build_sharded_stepper(problem, mesh, dtype, stencil_impl=engine,
                                 abft=abft)


def stepper_runs(problem: Problem, dtype, engine: str, chunk: int,
                 spans=(8, 24), sstep_s: int = 4, mesh_shape=None,
                 device=None) -> dict:
    """The stepper of ``engine`` ("xla", "pallas", "pipelined" or
    "sstep"), abft off and on: run in chunks of ``chunk`` to the end (the
    count, the flags, the global w, ABFT's flag), and the collectives and
    launches of a dispatch from iteration 0 to each of ``spans`` (their
    difference over the iterations between is the cadence of a body)."""
    from poisson_ellipse_tpu_torch.parallel.pcg_sharded import gather_w

    mesh = make_mesh(mesh_shape, device)
    out = {}
    for abft in (False, True):
        init, advance = _stepper(problem, mesh, dtype, engine, abft, sstep_s)
        state = init()
        limit = 0
        while not (bool(state.converged) or bool(state.breakdown)) and (
                limit < problem.max_iterations):
            limit += chunk
            state = advance(state, limit)
        w = state.x if engine == "pipelined" else state.w
        run = {"iters": int(state.k), "converged": bool(state.converged),
               "breakdown": bool(state.breakdown),
               "w": _host(gather_w(problem, mesh, w)),
               "sdc": bool(state.sdc) if abft else None, "spans": []}
        for span in spans:
            start = init()
            mesh_mod.reset_collectives()
            _build.reset_launches()
            advance(start, span, 0)
            run["spans"].append(_counts())
        out["abft" if abft else "plain"] = run
    return out


def reshard_resume(problem: Problem, dtype, at: int, lost, chunk: int = 13,
                   device=None) -> dict | None:
    """A classical carry advanced to ``at`` on the group's mesh, gathered,
    resharded onto the mesh of the survivors of ``lost`` and advanced to
    the end there in chunks of ``chunk``, against the straight solve on
    that mesh; with the refusal of an ABFT carry. The survivors' first
    rank's report reaches every rank."""
    from poisson_ellipse_tpu_torch.parallel import elastic
    from poisson_ellipse_tpu_torch.parallel.pcg_sharded import (
        build_sharded_stepper,
        gather_w,
        solve_sharded,
    )

    mesh = make_mesh(device=device)
    init, advance = build_sharded_stepper(problem, mesh, dtype)
    state = advance(init(), at)
    carry = elastic.gather_state(state, mesh)
    abft_init, _ = build_sharded_stepper(problem, mesh, dtype, abft=True)
    extended = abft_init()
    small = elastic.shrink_mesh(mesh, lost)
    report = None
    if small is not None:
        try:
            elastic.reshard_state(problem, extended, small, dtype)
            refusal = None
        except ValueError as e:
            refusal = str(e)
        moved = elastic.reshard_state(problem, carry, small, dtype)
        init2, advance2 = build_sharded_stepper(problem, small, dtype)
        limit = at
        while not (bool(moved.converged) or bool(moved.breakdown)) and (
                limit < problem.max_iterations):
            limit += chunk
            moved = advance2(moved, limit)
        straight = solve_sharded(problem, small, dtype)
        w = gather_w(problem, small, moved.w)
        ws = gather_w(problem, small, straight.w)
        if small.rank == 0:
            report = {"mesh": small.shape, "ranks": small.global_ranks,
                      "iters": int(moved.k),
                      "converged": bool(moved.converged),
                      "straight_iters": int(straight.iters),
                      "max_abs_w": float((w - ws).abs().max()),
                      "refusal": refusal}
    return _from_any(mesh, report)


def _from_any(mesh, report):
    """The one non-None ``report`` of the group's ranks, on every rank."""
    if mesh.backend == "none":
        return report
    everyone = [None] * mesh.world
    dist.all_gather_object(everyone, report, group=mesh.group)
    return next((x for x in everyone if x is not None), None)


def survivors_halo(global_array, lost, device=None) -> dict:
    """The halo exchange on the mesh of the survivors of ``lost`` (a
    sub-group whose positions are not its global ranks): each survivor's
    extended block of the global array padded to the survivors' mesh, in
    grid order, with their global ranks."""
    import numpy as np

    from poisson_ellipse_tpu_torch.parallel import elastic
    from poisson_ellipse_tpu_torch.parallel.halo import halo_extend
    from poisson_ellipse_tpu_torch.parallel.mesh import padded_dims_of

    mesh = make_mesh(device=device)
    small = elastic.shrink_mesh(mesh, lost)
    report = None
    if small is not None:
        g1p, g2p = padded_dims_of(np.shape(global_array), small.px,
                                  small.py)
        full = np.zeros((g1p, g2p))
        full[:global_array.shape[0], :global_array.shape[1]] = global_array
        bm, bn = g1p // small.px, g2p // small.py
        block = torch.as_tensor(full[small.ix * bm:(small.ix + 1) * bm,
                                     small.iy * bn:(small.iy + 1) * bn])
        ext = halo_extend(block.to(small.device), small)
        blocks = [x.cpu().numpy() for x in small.all_gather(ext)]
        if small.rank == 0:
            report = {"mesh": small.shape, "ranks": small.global_ranks,
                      "padded": full, "blocks": blocks}
    return _from_any(mesh, report)


def checkpoint_reshard(problem: Problem, dtype, directory: str, chunk: int,
                       saves: int, lost, stencil: str = "xla",
                       device=None) -> dict | None:
    """``saves`` chunks of a checkpointed solve on the group's mesh (each
    saved), then the solve resumed from that directory on the mesh of the
    survivors of ``lost`` (the resharded restore) and run to the end,
    against the straight solve there."""
    from poisson_ellipse_tpu_torch.parallel import elastic
    from poisson_ellipse_tpu_torch.parallel.pcg_sharded import (
        gather_w,
        solve_sharded,
    )
    from poisson_ellipse_tpu_torch.solver.checkpoint import (
        CheckpointingSolver,
    )

    mesh = make_mesh(device=device)
    with CheckpointingSolver(problem, directory, chunk=chunk, dtype=dtype,
                             stencil=stencil, mesh=mesh) as first:
        init, advance = first._parts()
        state = init()
        for i in range(saves):
            state = advance(state, (i + 1) * chunk)
            first.save(state)
        written = first.latest_step()
    mesh.barrier()
    small = elastic.shrink_mesh(mesh, lost)
    report = None
    if small is not None:
        with CheckpointingSolver(problem, directory, chunk=chunk,
                                 dtype=dtype, stencil=stencil,
                                 mesh=small) as second:
            resumed_from = second.latest_step()
            result = second.run(resume=True)
        straight = solve_sharded(problem, small, dtype, stencil_impl=stencil)
        ws = gather_w(problem, small, straight.w)
        if small.rank == 0:
            report = {"mesh": small.shape, "written": written,
                      "resumed_from": resumed_from,
                      "iters": int(result.iters),
                      "converged": bool(result.converged),
                      "straight_iters": int(straight.iters),
                      "max_abs_w": float((result.w - ws).abs().max())}
    return _from_any(mesh, report)


def elastic(problem: Problem, dtype, directory: str, chunk: int,
            faults=None, abft: bool = False, chunk_deadline_s=None,
            max_degrades: int = 2, stencil: str = "xla", trace=None,
            device=None) -> dict:
    """One ``elastic_solve`` over the group's mesh: its outcome (the
    count, flags, global w and l2, the events, the final mesh and the
    degrades; or the classified error), the same on every rank, and every
    rank's collectives and launches when the ladder dropped it and at the
    end. ``trace`` is a path global rank 0 writes its trace to."""
    from poisson_ellipse_tpu_torch.obs import trace as obs_trace
    from poisson_ellipse_tpu_torch.resilience.meshguard import run_elastic

    mesh = make_mesh(device=device)
    if trace is not None and mesh.global_rank == 0:
        obs_trace.start(trace)
    mesh_mod.reset_collectives()
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        outcome, run = run_elastic(problem, mesh, dtype,
                                   directory=directory, chunk=chunk,
                                   abft=abft,
                                   chunk_deadline_s=chunk_deadline_s,
                                   faults=faults, max_degrades=max_degrades,
                                   stencil=stencil)
        dropped = run.dropped
    except SolveError as e:
        outcome, dropped = e, None
    finally:
        if trace is not None and mesh.global_rank == 0:
            obs_trace.stop()
    seconds = time.perf_counter() - t0
    if isinstance(outcome, SolveError):
        report = _failure(outcome)
    else:
        result = outcome.result
        report = {"error": None, "iters": int(result.iters),
                  "converged": bool(result.converged), "w": _host(result.w),
                  "l2": float(l2_error_vs_analytic(problem, result.w)),
                  "events": [(e.kind, e.at_iter, e.cause, e.mesh_before,
                              e.mesh_after) for e in outcome.events],
                  "mesh_shape": tuple(outcome.mesh_shape),
                  "degrades": outcome.degrades}
    mine = {"dropped": dropped, "end": _counts(), "seconds": seconds}
    ranks = [mine]
    if mesh.backend != "none":
        ranks = [None] * mesh.world
        dist.all_gather_object(ranks, mine, group=mesh.group)
    report["ranks"] = ranks
    return report
