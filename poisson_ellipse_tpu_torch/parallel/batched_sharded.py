"""Lane-sharded batched solves: one reduction an iteration.

The counterpart of ``poisson_ellipse_tpu.parallel.batched_sharded``. The
spatial mesh (``pcg_sharded`` and its kin) splits one problem's grid over
the ranks and reduces every global dot. A batch has a better axis: its
lanes are independent problems, so here each rank owns ``lanes / world``
whole lanes of ``batch.batched_pcg.batched_operands``' right-hand-side
stack, the coefficients are on every rank, and each rank runs the batched
iteration (``batch.batched_pcg.make_lane_step`` or
``batch.batched_pipelined.make_lane_step``, with the plain stencil) on its
own lanes.

A lane's grid is whole on its rank, so its dot bundle is never reduced over
the mesh. The one collective of a body is the count of active lanes, added
over the ranks (``Mesh.reduce`` of one integer a rank), which keeps every
rank issuing bodies until the last lane anywhere is done: one reduction an
iteration whatever the lane count and the recurrence, and no halo exchange.
The loop's clock is that count's: it advances in every body that began with
a lane active anywhere, the same on every rank, so every rank reads the
same flags and issues the same bodies. A rank whose lanes are all done
issues bodies that change nothing (each lane step masks a frozen lane).

``solver(*args)`` returns this rank's lanes; ``gather_lanes`` puts every
rank's back together in lane order (off the timed loop). f32, f64 and
bf16 compute; a bf16 lane is the single-device bf16 lane of ``batch/``
(the pipelined lanes rebuild every 8 iterations), bitwise on the CPU.
"""

from __future__ import annotations

import torch

from poisson_ellipse_tpu_torch.batch import batched_pcg, batched_pipelined
from poisson_ellipse_tpu_torch.batch.batched_pcg import (
    BatchedPCGResult,
    _lane_ops,
    batched_operands,
    diag_d_batched,
)
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops.stencil import spacing
from poisson_ellipse_tpu_torch.parallel.mesh import Mesh, count, make_mesh
from poisson_ellipse_tpu_torch.parallel.pcg_sharded import (
    ShardedSolver,
    measured_solve,
)
from poisson_ellipse_tpu_torch.solver.pcg import (
    DEFAULT_CHUNK,
    run_chunked,
    unported,
)


def _check_lanes(lanes: int, world: int, why: str) -> None:
    if lanes % world != 0:
        raise ValueError(
            f"lanes={lanes} must be a multiple of the mesh's {world} "
            f"devices ({why})"
        )


def build_batched_sharded_solver(problem: Problem, mesh: Mesh | None = None,
                                 lanes: int | None = None,
                                 dtype=torch.float32, pipelined: bool = False,
                                 chunk: int = DEFAULT_CHUNK, operands=None):
    """(solver, args) for this rank's part of a lane-sharded batched solve.

    ``lanes`` (default: one a rank) must be a multiple of the mesh's rank
    count. ``operands`` is an optional (a, b, rhs) with (M+1, N+1)
    coefficients and the whole (lanes, M+1, N+1) right-hand-side stack on
    this rank's device; by default ``batched_operands`` tiles the problem's
    over the lanes. args = (a, b, rhs): the coefficients whole, and this
    rank's (lanes / world, M+1, N+1) lanes of the stack. ``solver(*args)``
    returns this rank's ``BatchedPCGResult`` (a ``ShardedSolver``:
    ``host_syncs`` and ``bodies`` of its last call)."""
    if mesh is None:
        mesh = make_mesh()
    if lanes is None:
        lanes = mesh.world
    _check_lanes(lanes, mesh.world, "whole lanes per device; pad the "
                 "request to the next lane bucket")
    per_rank = lanes // mesh.world
    a, b, rhs = (operands if operands is not None
                 else batched_operands(problem, lanes, dtype, mesh.device))
    if rhs.shape[0] != lanes:
        raise ValueError(f"rhs carries {rhs.shape[0]} lanes, expected {lanes}")
    rhs = rhs[mesh.rank * per_rank:(mesh.rank + 1) * per_rank].contiguous()
    mod = batched_pipelined if pipelined else batched_pcg
    weighted = problem.norm == "weighted"

    def run(a, b, rhs, limit=None):
        cap = problem.max_iterations
        limit = cap if limit is None else min(int(limit), cap)
        h1, h2 = spacing(problem.h1, rhs), spacing(problem.h2, rhs)
        delta = spacing(problem.delta, rhs)
        a3, b3, _ = _lane_ops(a, b, None)
        d = diag_d_batched(a3, b3, h1, h2)
        if pipelined:
            lane_step = batched_pipelined.make_lane_step(
                rhs, a3, b3, d, None, h1, h2, delta, weighted, limit=limit)
            state0 = batched_pipelined.init_state(problem, a, b, rhs)
        else:
            classical = batched_pcg.make_lane_step(
                a3, b3, d, None, h1, h2, delta, weighted, limit=limit)
            lane_step = lambda st, _k: classical(st)  # noqa: E731
            state0 = batched_pcg.init_state(problem, a, b, rhs)
        dev = rhs.device
        # (lane carry, lanes active anywhere, the mesh's clock)
        carry = [state0, torch.tensor(lanes, dtype=torch.int32, device=dev),
                 torch.zeros((), dtype=torch.int32, device=dev)]
        bodies = [0]

        def step(k: int):
            st, n_active, clock = carry
            st = lane_step(st, k)
            active = ~st.converged & ~st.breakdown & ~st.quarantined
            # the one collective of the iteration: the active lanes,
            # added over the ranks
            mine = active.sum(dtype=torch.float64)[None]
            ran = (n_active > 0) & (clock < limit)
            carry[:] = [st, mesh.reduce(mine, torch.int32)[0],
                        clock + ran.to(clock.dtype)]
            bodies[0] += 1

        def flags():
            _st, n_active, clock = carry
            return torch.stack([clock, (n_active == 0).to(clock.dtype),
                                torch.zeros_like(clock)])

        syncs = run_chunked(step, flags, limit, chunk)
        return mod.result_of(carry[0]), syncs, bodies[0]

    return ShardedSolver(run), (a, b, rhs)


def gather_lanes(mesh: Mesh, result: BatchedPCGResult) -> BatchedPCGResult:
    """Every rank's lanes in lane order, on every rank (one gather of each
    field; every rank calls it together)."""
    count("gather")

    def gathered(x):
        # the flags cross as bytes: not every backend sends bool
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        parts = [t.to(mesh.device) for t in mesh.all_gather(wire)]
        return torch.cat(parts).to(x.dtype)

    return BatchedPCGResult(*(gathered(x) for x in result))


def build_sharded_chunk_advance(*_args, **_kwargs):
    """The serve scheduler's lane-refill advance on the mesh: the
    scheduler composed with the lane-sharded mesh, one process a rank."""
    raise unported("build_sharded_chunk_advance", "Queue A item 10b")


def solve_batched_sharded(problem: Problem, lanes: int | None = None,
                          mesh: Mesh | None = None, dtype=torch.float32,
                          pipelined: bool = False,
                          chunk: int = DEFAULT_CHUNK) -> BatchedPCGResult:
    """Assemble, lane-shard and solve over the mesh; every lane's result,
    in lane order, on every rank."""
    if mesh is None:
        mesh = make_mesh()
    solver, args = build_batched_sharded_solver(problem, mesh, lanes, dtype,
                                                pipelined=pipelined,
                                                chunk=chunk)
    return gather_lanes(mesh, solver(*args))


def solve_report(problem: Problem, lanes: int, dtype=torch.float32,
                 pipelined: bool = False, chunk: int = DEFAULT_CHUNK,
                 scales=None, device=None) -> dict:
    """One lane-sharded solve on this rank, for a caller that compares it:
    every lane's w, iterations, step norm and flags as host arrays in lane
    order, the bodies and host reads, and every rank's collectives and
    launches during the solve. With ``scales`` (one a lane) lane l's
    right-hand side is the problem's times ``scales[l]``, so that distinct
    lanes show their order. Every rank calls it together, with the
    ``device`` type its group was started on."""
    mesh = make_mesh(device=device)
    operands = None
    if scales is not None:
        a, b, rhs = batched_operands(problem, lanes, dtype, mesh.device)
        scale = torch.tensor(scales, dtype=dtype, device=mesh.device)
        operands = (a, b, rhs * scale[:, None, None])
    solver, args = build_batched_sharded_solver(problem, mesh, lanes, dtype,
                                                pipelined=pipelined,
                                                chunk=chunk,
                                                operands=operands)
    result, per_rank = measured_solve(mesh, solver, args)
    whole = gather_lanes(mesh, result)
    # numpy has no bf16: a narrow field crosses as its exact f32 widening
    return dict(
        **{name: (x if x.dtype.itemsize >= 4 or x.dtype == torch.bool
                  else x.float()).cpu().numpy()
           for name, x in whole._asdict().items()},
        local_lanes=int(result.w.shape[0]), bodies=solver.bodies,
        host_syncs=solver.host_syncs, ranks=per_rank, mesh=mesh.shape,
        backend=mesh.backend,
    )
