"""Distributed PCG over the rank grid: the classical loop on every rank.

The counterpart of ``poisson_ellipse_tpu.parallel.pcg_sharded``, and of the
reference's distributed drivers (``solve_mpi``,
``stage2-mpi/poisson_mpi_decomp.cpp:356-460``; ``gradient_solver_mpi``,
``poisson_mpi_cuda2.cu:687-982``). Each rank owns one (bm, bn) block of the
zero-padded node grid (``parallel.mesh.padded_dims``) and runs, an
iteration:

  1 halo exchange of p          (``parallel.halo``; the reference's 4
                                 host-staged ``MPI_Sendrecv``)
  A·p on its block              ("xla": the plain block stencil;
                                 "pallas": K-a, ``csrc/stencil.cu``)
  1 reduction                   the denominator (Ap, p)
  1 reduction                   [Σz·r, Σ(Δw)²] stacked

so 2 reductions and 1 halo exchange an iteration, the JAX package's
``sharded_psum=2, sharded_halo=1`` (``ENGINE_CAPS`` there). A reduction
gathers each rank's double partial and adds them in rank order
(``Mesh.reduce``), so every rank takes the same branch at the same
iteration.

As on one device (``solver.pcg``) the carry and the scalar recurrence stay
on the rank's device; the host reads the flags once per chunk, and a body
issued after the exit changes nothing (α = 0, p and zr held), so a chunked
run is a straight run. Under gloo each halo edge and each partial goes
through the host, which is the reference's stage 4.

``assembly_mode``: "host" assembles in f64 on the host, rounds once, and
hands each rank its block (args = (a, b, rhs) blocks; the coefficient
halos are exchanged once); "device" has each rank assemble its
halo-extended block from global indices with no communication
(``ops.assembly.coefficients_at``; args = ()). ``stencil_impl="fused"``
is the two-kernel iteration of ``parallel.fused_sharded``, and
``"pipelined"`` the one-reduction recurrence of
``parallel.pipelined_sharded``.

The solver returns each rank's owned block of w; ``gather_w`` assembles the
global (M+1, N+1) solution (off the timed path: the JAX package never
gathers its sharded result either).

``history=True`` (the classical loops, "xla" and "pallas", as in the JAX
package) records each iteration into a ring of ``obs.convergence`` on
every rank, from the reduced scalars, so every rank holds the same ring
bits; the solver then returns (PCGResult, ConvergenceTrace). The fused and
pipelined iterations raise the JAX package's ValueError.

The resilience hooks (the JAX package's): ``build_sharded_stepper`` is the
chunked form the guard, the checkpointing solver and the elastic mesh
drive (``init_fn()``, ``advance_fn(state, limit, k)`` issuing the bodies
from the carry's iteration ``k`` to ``limit`` with no host read), and
``build_sharded_recover`` the true-residual restart. ``abft=True`` extends
the carry with the silent-corruption checks of ``resilience.abft``
(``ABFTState``): ten partials more ride the body's second reduction, so a
body keeps its 1 halo exchange and 2 reductions, and the checksum field
c = A·1 is one stencil call (one halo exchange, one K-a launch on
"pallas") a dispatch, outside the loop.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.obs.convergence import (
    HISTORY_FIELDS,
    history_record,
)
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.ops.stencil import (
    apply_a_block,
    apply_dinv,
    diag_d_block,
    spacing,
)
from poisson_ellipse_tpu_torch.parallel.halo import halo_extend
from poisson_ellipse_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    padded_dims,
    rank_sums,
)
from poisson_ellipse_tpu_torch.resilience.abft import (
    ClassicalChecks,
    checksum_field,
    classical_partials,
    plain_sums,
    with_tail,
)
from poisson_ellipse_tpu_torch.solver.pcg import (
    DEFAULT_CHUNK,
    DENOM_GUARD,
    PCGResult,
    PCGState,
    Solver,
    new_ring,
    run_chunked,
    unported,
    with_history,
)

# the sharded stencils of the classical loop, the fused iteration and the
# pipelined recurrence (the s-step and lane-sharded engines have builders
# of their own: ``sstep_sharded``, ``batched_sharded``)
STENCIL_IMPLS = ("xla", "pallas", "fused", "pipelined")


def block_shape(problem: Problem, mesh: Mesh) -> tuple[int, int]:
    """The (bm, bn) block each rank owns."""
    g1p, g2p = padded_dims(problem.node_shape, mesh)
    return g1p // mesh.px, g2p // mesh.py


def global_indices(mesh: Mesh, bm: int, bn: int, halo: int = 0):
    """The global node indices (gi, gj) of this rank's block, extended by
    ``halo`` nodes on every side."""
    gi = mesh.ix * bm - halo + torch.arange(bm + 2 * halo, device=mesh.device)
    gj = mesh.iy * bn - halo + torch.arange(bn + 2 * halo, device=mesh.device)
    return gi, gj


def _shard_ops(problem: Problem, mesh: Mesh, bm: int, bn: int, a_ext, b_ext,
               dtype, stencil_impl: str = "xla"):
    """(stencil, pdot, d, maskd) for this rank's block: the stencil closure
    exchanges p's halo and applies A masked to the global interior; pdot is
    the h1·h2-weighted dot over the mesh; d the diagonal, zero outside the
    interior, so ``apply_dinv`` keeps every iterate zero on the ring and
    the padding."""
    h1, h2 = spacing(problem.h1, a_ext), spacing(problem.h2, a_ext)
    gi, gj = global_indices(mesh, bm, bn)
    interior = assembly.interior_mask(problem, gi, gj)
    d = torch.where(interior, diag_d_block(a_ext, b_ext, h1, h2),
                    torch.zeros((), dtype=dtype, device=a_ext.device))
    maskd = interior.to(dtype)
    if stencil_impl == "pallas":
        from poisson_ellipse_tpu_torch.ops.hopper_kernels import (
            apply_a_block_kernel,
        )

        def stencil(p):
            return apply_a_block_kernel(halo_extend(p, mesh), a_ext, b_ext,
                                        problem.h1, problem.h2) * maskd
    elif stencil_impl == "xla":
        def stencil(p):
            return apply_a_block(halo_extend(p, mesh), a_ext, b_ext, h1,
                                 h2) * maskd
    else:
        raise ValueError(f"unknown stencil_impl: {stencil_impl!r}")

    def pdot(u, v):
        return mesh.reduce(rank_sums((u, v)), dtype)[0] * h1 * h2

    return stencil, pdot, d, maskd


def _reject(precond=None, x0_blk=None) -> None:
    if precond is not None:
        raise unported("precond= on the mesh", "Queue A item 21c")
    if x0_blk is not None:
        raise unported("x0_blk=", "Queue A item 21c")


def _shard_init(problem: Problem, pdot, d, rhs_blk, dtype, precond=None,
                abft: bool = False, x0_blk=None, mesh: Mesh | None = None):
    """The carry at iteration 0 on this rank: w = 0, r = rhs, p = D⁻¹r and
    zr over the mesh (one reduction). ``abft`` appends the shadow tail,
    anchored by one reduction more over ``mesh`` (once a solve)."""
    _reject(precond, x0_blk)
    dev = rhs_blk.device
    z0 = apply_dinv(rhs_blk, d)
    state = PCGState(
        k=torch.zeros((), dtype=torch.int32, device=dev),
        w=torch.zeros_like(rhs_blk),
        r=rhs_blk.clone(),
        p=z0,
        zr=pdot(z0, rhs_blk),
        diff=torch.full((), float("inf"), dtype=dtype, device=dev),
        converged=torch.zeros((), dtype=torch.bool, device=dev),
        breakdown=torch.zeros((), dtype=torch.bool, device=dev),
    )
    if not abft:
        return state
    sums = mesh.reduce(plain_sums(rhs_blk, z0), dtype)
    return with_tail(state, (sums[0], torch.zeros_like(sums[0]), sums[1],
                             torch.zeros((), dtype=torch.bool, device=dev)))


def _make_body(problem: Problem, mesh: Mesh, stencil, d, dtype, like,
               limit: int, history=None, abft: bool = False, abft_c=None):
    """One iteration of this rank's carry as ``body(state, k)``, ``k`` the
    iteration the host issues it as: 1 halo exchange and 2 reductions, and
    a no-op once the loop has exited (past ``limit``, converged, broken
    down, or flagged by ABFT). ``abft`` runs the checks of
    ``resilience.abft`` on the extended carry with ``abft_c`` the checksum
    field: the ten partials (Σap, Σr, Σw, Σp, Σc·p, Σz, Σ|ap|, Σ|r|, Σ|w|,
    Σ|p|) ride the second reduction beside Σz·r and Σ(Δw)², which stay
    bitwise those of the plain loop; every check reads a NaN as a
    violation (``abft.ClassicalChecks``)."""
    if abft and (history is not None or abft_c is None):
        raise ValueError(
            "abft needs the checksum field (abft_c) and excludes history "
            "capture — both extend the carry tail"
        )
    h1, h2 = spacing(problem.h1, like), spacing(problem.h2, like)
    delta = spacing(problem.delta, like)
    one = torch.ones((), dtype=dtype, device=like.device)
    zero = torch.zeros((), dtype=dtype, device=like.device)
    weighted = problem.norm == "weighted"
    checks = ClassicalChecks(dtype, like.device) if abft else None

    def body(s, k: int):
        active = (s.k < limit) & ~s.converged & ~s.breakdown
        if abft:
            # a flagged carry stops at once: the guard rolls the chunk back
            active = active & ~s.sdc
        ap = stencil(s.p)
        denom = mesh.reduce(rank_sums((ap, s.p)), dtype)[0] * h1 * h2
        breakdown = denom < DENOM_GUARD
        step = active & ~breakdown
        # α = 0 once the loop has exited or on breakdown: w, r unchanged
        alpha = torch.where(step, s.zr / torch.where(breakdown, one, denom),
                            zero)
        w_new = s.w + alpha * s.p
        r_new = s.r - alpha * ap
        z = apply_dinv(r_new, d)
        # the realised increment, not α·p
        dw = w_new - s.w
        # one reduction for both scalars (and the ABFT partials)
        partials = rank_sums((z, r_new), (dw, dw))
        if abft:
            partials = torch.cat([partials, classical_partials(
                ap, r_new, w_new, s.p, abft_c, z)])
        sums = mesh.reduce(partials, dtype)
        zr_new = sums[0] * h1 * h2
        dw2 = sums[1]
        diff = torch.sqrt(dw2 * h1 * h2) if weighted else torch.sqrt(dw2)
        converged = step & (diff < delta)
        beta = zr_new / s.zr
        advance = step & ~converged
        diff = torch.where(step, diff, s.diff)
        if history is not None:
            history_record(history, k, active, zr_new, diff, alpha, beta)
        out = PCGState(
            k=s.k + active.to(s.k.dtype),
            w=w_new,
            r=r_new,
            p=torch.where(advance, z + beta * s.p, s.p),
            zr=torch.where(advance, zr_new, s.zr),
            diff=diff,
            converged=s.converged | converged,
            breakdown=s.breakdown | (active & breakdown),
        )
        if not abft:
            return out
        tail = (s.s_r, s.s_w, s.s_p_pred)
        ok = checks(sums, tail, alpha, s.zr)
        # the next iteration's shadows: the reduced Σr and Σw, and the
        # predicted Σp⁺ = Σz + β·Σp
        s_r, s_w, s_p, s_z = sums[3], sums[4], sums[5], sums[7]
        shadows = torch.where(step, torch.stack([s_r, s_w, s_z + beta * s_p]),
                              torch.stack(tail))
        return with_tail(out, (*shadows.unbind(), s.sdc | (step & ~ok)))

    return body


def _shard_advance(problem: Problem, mesh: Mesh, stencil, d, state: PCGState,
                   dtype, limit=None, chunk: int = DEFAULT_CHUNK,
                   history=None, precond=None):
    """Advance this rank's carry until convergence, breakdown or iteration
    ``limit`` (default ``max_iterations``); returns (carry, host reads,
    bodies issued). Every rank must call it together: each body makes 1
    halo exchange and 2 reductions. ``history`` is a ring
    (``solver.pcg.new_ring``) each iteration is recorded into, or None."""
    _reject(precond)
    cap = problem.max_iterations
    limit = cap if limit is None else min(int(limit), cap)
    body = _make_body(problem, mesh, stencil, d, dtype, state.r, limit,
                      history=history)
    carry = [state]
    bodies = [0]

    def step(k):
        carry[0] = body(carry[0], k)
        bodies[0] += 1

    def flags():
        s = carry[0]
        return torch.stack([s.k, s.converged.to(s.k.dtype),
                            s.breakdown.to(s.k.dtype)])

    syncs = run_chunked(step, flags, limit, chunk)
    return carry[0], syncs, bodies[0]


def _local_pcg(problem: Problem, mesh: Mesh, bm: int, bn: int, a_ext, b_ext,
               rhs_blk, dtype, stencil_impl: str = "xla",
               chunk: int = DEFAULT_CHUNK, limit=None, history: bool = False):
    """This rank's whole solve: init, then advance to the cap (or
    ``limit``). Returns (PCGResult over the owned block, host reads, bodies
    issued), the result (PCGResult, ConvergenceTrace) with ``history``."""
    stencil, pdot, d, _maskd = _shard_ops(problem, mesh, bm, bn, a_ext, b_ext,
                                          dtype, stencil_impl)
    state = _shard_init(problem, pdot, d, rhs_blk, dtype)
    ring = new_ring(problem, rhs_blk) if history else None
    state, syncs, bodies = _shard_advance(problem, mesh, stencil, d, state,
                                          dtype, limit, chunk, history=ring)
    result = PCGResult(w=state.w, iters=state.k, diff=state.diff,
                       converged=state.converged, breakdown=state.breakdown)
    return with_history(result, ring), syncs, bodies


class ShardedSolver(Solver):
    """A built sharded solve: ``solver(*args)`` returns this rank's
    ``PCGResult``, ``solver(*args, limit=n)`` stops at iteration n (the
    harness's warm-up); ``host_syncs`` and ``bodies`` are the host reads and
    the loop bodies its last call issued (each body makes the loop's
    collectives and launches, also after the exit)."""

    def __init__(self, run):
        super().__init__(run)
        self.bodies = 0

    def __call__(self, *args, limit=None) -> PCGResult:
        result, self.host_syncs, self.bodies = self._run(*args, limit=limit)
        return result


def build_sharded_solver(problem: Problem, mesh: Mesh | None = None,
                         dtype=torch.float32, assembly_mode: str = "host",
                         stencil_impl: str = "xla", history: bool = False,
                         geometry=None, theta=None,
                         chunk: int = DEFAULT_CHUNK):
    """(solver, args) for this rank's part of the mesh-sharded solve.

    Every rank of the mesh builds and calls it together. ``solver(*args)``
    returns a ``PCGResult`` whose ``w`` is this rank's (bm, bn) block and
    whose scalars are the same on every rank (a ``ShardedSolver``).
    ``stencil_impl``: "xla", "pallas" (K-a on every rank), "fused"
    (``parallel.fused_sharded``, host assembly, f32 and bf16) or
    "pipelined" (``parallel.pipelined_sharded``, host assembly, f32, f64
    and bf16). ``history=True`` ("xla" and "pallas") returns (PCGResult,
    ConvergenceTrace), the same ring bits on every rank."""
    if geometry is not None or theta is not None:
        raise unported("geometry=/theta=", "Queue A item 11")
    if history and stencil_impl not in ("xla", "pallas"):
        raise ValueError(
            "history capture covers the classical sharded loops "
            f"('xla'/'pallas'); got stencil_impl={stencil_impl!r} — the "
            "fused/pipelined sharded iterations keep their scalars inside "
            "kernels/recurrences with their own carry layouts"
        )
    if mesh is None:
        mesh = make_mesh()
    if stencil_impl == "pipelined":
        if assembly_mode != "host":
            raise ValueError(
                "stencil_impl='pipelined' assembles on the host (the "
                f"rounded-once operand set); got assembly_mode={assembly_mode!r}"
            )
        from poisson_ellipse_tpu_torch.parallel.pipelined_sharded import (
            build_pipelined_sharded_solver,
        )

        return build_pipelined_sharded_solver(problem, mesh, dtype,
                                              chunk=chunk)
    if stencil_impl == "fused":
        if assembly_mode != "host":
            raise ValueError(
                "stencil_impl='fused' assembles on the host (the rounded-"
                f"once operand set); got assembly_mode={assembly_mode!r}"
            )
        from poisson_ellipse_tpu_torch.parallel.fused_sharded import (
            build_fused_sharded_solver,
        )

        return build_fused_sharded_solver(problem, mesh, dtype, chunk=chunk)
    if stencil_impl not in STENCIL_IMPLS:
        raise ValueError(f"unknown stencil_impl: {stencil_impl!r}")
    bm, bn = block_shape(problem, mesh)

    if assembly_mode == "host":
        def run(a_blk, b_blk, rhs_blk, limit=None):
            # the one coefficient halo exchange of the solve
            a_ext = halo_extend(a_blk, mesh)
            b_ext = halo_extend(b_blk, mesh)
            return _local_pcg(problem, mesh, bm, bn, a_ext, b_ext, rhs_blk,
                              dtype, stencil_impl, chunk, limit, history)

        args = _host_sharded_args(problem, mesh, dtype)
    elif assembly_mode == "device":
        def run(limit=None):
            gi, gj = global_indices(mesh, bm, bn, halo=1)
            a_ext, b_ext = assembly.coefficients_at(problem, gi, gj, dtype)
            rhs_blk = assembly.rhs_at(problem, gi[1:-1], gj[1:-1], dtype)
            return _local_pcg(problem, mesh, bm, bn, a_ext, b_ext, rhs_blk,
                              dtype, stencil_impl, chunk, limit, history)

        args = ()
    else:
        raise ValueError(f"unknown assembly_mode: {assembly_mode!r}")
    return ShardedSolver(run), args


def stepper_parts(problem: Problem, mesh: Mesh | None, dtype,
                  stencil_impl: str = "xla", abft: bool = False):
    """The stepper's parts over one build (this rank's host blocks, the
    coefficient halos exchanged once, the loop's operators), as a
    namespace: ``init``, ``advance``, ``recover`` (``build_sharded_stepper``
    and ``build_sharded_recover``) and ``rhs_norm``, ‖rhs‖ over the whole
    grid from the host assembly (the guard's drift scale)."""
    if stencil_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown stencil_impl: {stencil_impl!r}")
    if mesh is None:
        mesh = make_mesh()
    bm, bn = block_shape(problem, mesh)
    a_blk, b_blk, rhs_blk, rhs_norm = _host_blocks(problem, mesh, dtype)
    a_ext = halo_extend(a_blk, mesh)
    b_ext = halo_extend(b_blk, mesh)
    stencil, pdot, d, maskd = _shard_ops(problem, mesh, bm, bn, a_ext, b_ext,
                                         dtype, stencil_impl)
    cap = problem.max_iterations

    def init_fn():
        return _shard_init(problem, pdot, d, rhs_blk, dtype, abft=abft,
                           mesh=mesh)

    def advance_fn(state, limit, k=None):
        limit = min(int(limit), cap)
        k = int(state.k) if k is None else int(k)
        if k >= limit:
            return state
        # the checksum field, one stencil call a dispatch
        c = checksum_field(stencil, maskd) if abft else None
        body = _make_body(problem, mesh, stencil, d, dtype, rhs_blk, limit,
                          abft=abft, abft_c=c)
        for it in range(k, limit):
            state = body(state, it)
        return state

    def recover_fn(state):
        w, p = state.w, state.p
        r2 = rhs_blk - stencil(w)
        z2 = apply_dinv(r2, d)
        out = PCGState(k=state.k, w=w, r=r2, p=p, zr=pdot(z2, r2),
                       diff=state.diff,
                       converged=torch.zeros_like(state.converged),
                       breakdown=torch.zeros_like(state.breakdown))
        if not abft:
            return out
        # the tail re-anchored to the rebuilt carry (one reduction)
        sums = mesh.reduce(plain_sums(r2, w, p), dtype)
        return with_tail(out, (sums[0], sums[1], sums[2],
                               torch.zeros_like(state.converged)))

    return types.SimpleNamespace(init=init_fn, advance=advance_fn,
                                 recover=recover_fn, rhs_norm=rhs_norm)


def build_sharded_stepper(problem: Problem, mesh: Mesh | None = None,
                          dtype=torch.float32, stencil_impl: str = "xla",
                          abft: bool = False):
    """(init_fn, advance_fn) for chunked, resumable sharded solves on this
    rank; every rank builds and calls them together.

    ``init_fn()`` is the iteration-0 carry (``PCGState`` over this rank's
    block, ``ABFTState`` with ``abft``); ``advance_fn(state, limit, k=None)``
    issues the bodies from iteration ``k`` (the carry's count, read from it
    when None) to ``limit``: the loop's own bodies, so a chunked run is a
    straight run. ``abft`` runs the silent-corruption checks, the
    checksum field built once a call, outside the loop."""
    parts = stepper_parts(problem, mesh, dtype, stencil_impl, abft)
    return parts.init, parts.advance


def build_sharded_recover(problem: Problem, mesh: Mesh | None = None,
                          dtype=torch.float32, stencil_impl: str = "xla",
                          abft: bool = False):
    """The true-residual restart of a sharded carry on this rank, the
    recovery the guard applies on the mesh: ``recover_fn(state)`` rebuilds
    r = rhs − A·w (one halo exchange), z and zr (one reduction), keeps the
    search direction p and clears the flags; with ``abft`` the shadow tail
    is re-anchored to the rebuilt carry (one reduction more). An 8-field
    carry is taken too (a restored checkpoint's)."""
    return stepper_parts(problem, mesh, dtype, stencil_impl, abft).recover


def sharded_result_of(problem: Problem, state) -> PCGResult:
    """A sharded carry (any ABFT tail ignored) as a ``PCGResult`` over this
    rank's block (``gather_w`` assembles the global solution)."""
    return PCGResult(w=state.w, iters=state.k, diff=state.diff,
                     converged=state.converged, breakdown=state.breakdown)


def solve_sharded(problem: Problem, mesh: Mesh | None = None,
                  dtype=torch.float32, assembly_mode: str = "host",
                  stencil_impl: str = "xla", history: bool = False,
                  chunk: int = DEFAULT_CHUNK) -> PCGResult:
    """Assemble, shard and solve over the mesh; ``w`` is this rank's block
    (``gather_w`` assembles the global solution); with ``history``
    (PCGResult, ConvergenceTrace)."""
    solver, args = build_sharded_solver(problem, mesh, dtype, assembly_mode,
                                        stencil_impl, history, chunk=chunk)
    return solver(*args)


def gather_w(problem: Problem, mesh: Mesh, w_blk) -> torch.Tensor:
    """The global (M+1, N+1) solution from every rank's block, on every
    rank (one gather; call it on every rank)."""
    g1, g2 = problem.node_shape
    return mesh.gather_blocks(w_blk)[:g1, :g2]


def rank_block(problem: Problem, mesh: Mesh, arr: np.ndarray) -> np.ndarray:
    """This rank's (bm, bn) block of a global (M+1, N+1) host array,
    zero-padded to the mesh multiple."""
    g1p, g2p = padded_dims(problem.node_shape, mesh)
    bm, bn = g1p // mesh.px, g2p // mesh.py
    padded = np.pad(arr, ((0, g1p - arr.shape[0]), (0, g2p - arr.shape[1])))
    return padded[mesh.ix * bm:(mesh.ix + 1) * bm,
                  mesh.iy * bn:(mesh.iy + 1) * bn]


def _host_sharded_args(problem: Problem, mesh: Mesh, dtype):
    """This rank's blocks of the host-f64-assembled a, b, rhs, rounded once
    to ``dtype`` on its device (the "host" assembly mode's operand set)."""
    return _host_blocks(problem, mesh, dtype)[:3]


def _host_blocks(problem: Problem, mesh: Mesh, dtype):
    """(a, b, rhs blocks, ‖rhs‖): ``_host_sharded_args`` and the f64 norm
    of the whole assembled right-hand side, from one assembly."""
    arrays = assembly.assemble_numpy(problem)
    return (*(assembly.to_device(rank_block(problem, mesh, x), dtype,
                                 mesh.device) for x in arrays),
            float(np.linalg.norm(arrays[2])))


def measured_solve(mesh: Mesh, solver, args):
    """One call of a built sharded ``solver`` on this rank, with every
    rank's collectives and kernel launches during it: (result, per-rank
    counts in rank order). Every rank calls it together."""
    import torch.distributed as dist

    from poisson_ellipse_tpu_torch.ops import _build
    from poisson_ellipse_tpu_torch.parallel.mesh import (
        COLLECTIVES,
        reset_collectives,
    )

    reset_collectives()
    _build.reset_launches()
    result = solver(*args)
    counts = {"collectives": dict(COLLECTIVES),
              "launches": dict(_build.LAUNCHES)}
    per_rank = [counts]
    if mesh.backend != "none":
        per_rank = [None] * mesh.world
        dist.all_gather_object(per_rank, counts, group=mesh.group)
    return result, per_rank


def host_report(problem: Problem, mesh: Mesh, solver, result,
                per_rank) -> dict:
    """A sharded solve's result for a caller that compares it: the global
    w gathered to a host array, the scalars, the bodies and host reads,
    and every rank's counts (``measured_solve``). A history solve's result
    (PCGResult, ConvergenceTrace) adds ``history`` (every field's full
    buffer) and ``history_same_on_every_rank`` (every rank's ring gathered
    and held bitwise against this rank's)."""
    trace = None
    if isinstance(result, tuple) and not isinstance(result, PCGResult):
        result, trace = result
    w = gather_w(problem, mesh, result.w)
    report = dict(
        w=_widened(w).cpu().numpy(), block=tuple(result.w.shape),
        w_dtype=str(result.w.dtype),
        iters=int(result.iters), converged=bool(result.converged),
        breakdown=bool(result.breakdown), diff=float(result.diff),
        bodies=solver.bodies, host_syncs=solver.host_syncs,
        ranks=per_rank, mesh=mesh.shape, backend=mesh.backend,
    )
    if trace is not None:
        ring = torch.stack([getattr(trace, f) for f in HISTORY_FIELDS])
        rings = [r.to(ring.device) for r in mesh.all_gather(ring)]
        report["history"] = {f: _widened(x).cpu().numpy()
                             for f, x in zip(HISTORY_FIELDS, ring)}
        report["history_same_on_every_rank"] = all(
            torch.equal(_bits(r), _bits(ring)) for r in rings)
    return report


_INT_OF_SIZE = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bits as integers of its width (NaN and -0 compare as
    bits)."""
    return x.view(_INT_OF_SIZE[x.dtype.itemsize])


def _widened(x: torch.Tensor) -> torch.Tensor:
    """``x``, a narrow one widened exactly to f32 (numpy has no bf16)."""
    return x if x.dtype.itemsize >= 4 else x.float()


def solve_report(problem: Problem, dtype=torch.float32,
                 stencil_impl: str = "xla", assembly_mode: str = "host",
                 chunk: int = DEFAULT_CHUNK, device=None,
                 history: bool = False) -> dict:
    """One sharded solve on this rank (``host_report``). Every rank calls
    it together (``multihost.run_jobs``), with the ``device`` type its
    group was started on."""
    mesh = make_mesh(device=device)
    solver, args = build_sharded_solver(problem, mesh, dtype, assembly_mode,
                                        stencil_impl, history, chunk=chunk)
    return host_report(problem, mesh, solver,
                       *measured_solve(mesh, solver, args))
