"""Pipelined sharded PCG: one stacked reduction an iteration.

The counterpart of ``poisson_ellipse_tpu.parallel.pipelined_sharded``: the
pipelined recurrence of ``ops.pipelined_pcg`` on every rank of the mesh.
Every inner product an iteration needs is a function of vectors already in
hand, so the eight bundle partials (``ops.pipelined_pcg._bundle``) go out
in one reduction, and the iteration's halo exchange and stencil use none of
its results. A body, on every rank:

  1 reduction        the eight partials, stacked (``Mesh.reduce``)
  1 halo exchange    of m = D⁻¹w
  1 stencil          n = A·m on the block
  scalar tail        β, α, breakdown and convergence
  7 updates          z s p x r u w

against 2 reductions and 1 halo exchange for the classical sharded loop.
Every ``REPLACE_EVERY`` iterations the body first rebuilds r, u, w, z and s
from the ground-truth x and p: two stacked halo exchanges and four
stencils, and no reduction. As in the JAX module the cadence is
``ops.pipelined_pcg.REPLACE_EVERY`` (32) at every dtype.

As on one device, the host decides what the JAX loop decides on the
device: ``solver.pcg.run_chunked`` passes each body the iteration it runs,
so the rebuild is issued only in the bodies where it fires, and β = 0 only
in the first; every rank issues the same collectives, since k and the
flags come from reduced scalars. A body issued after the exit changes
nothing (every field is masked by whether the loop was active).

The operands are the host assembly of ``pcg_sharded`` (f64, rounded once),
each rank's block of the grid padded to the mesh. f32, f64 and bf16
compute. At bf16 the cadence stays the JAX module's 32, where the port's
single-device and lane recurrences replace every 8: neither cadence
converges on the bf16 mesh at 10²-40² (JAX's engine breaks down at
iteration 11-17, the port's at 11-13 or runs on to the cap; at cadence 8
the port's diverges), so nothing argues for departing from JAX
(``tests/test_torch_mesh_bf16_rest.py``).
"""

from __future__ import annotations

import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.ops.pipelined_pcg import (
    REPLACE_EVERY,
    PipelinedState,
    _bundle,
)
from poisson_ellipse_tpu_torch.ops.stencil import (
    apply_a_block,
    apply_dinv,
    diag_d_block,
    spacing,
)
from poisson_ellipse_tpu_torch.parallel.halo import (
    halo_extend,
    halo_extend_stacked,
)
from poisson_ellipse_tpu_torch.parallel.mesh import Mesh, make_mesh, rank_sums
from poisson_ellipse_tpu_torch.parallel.pcg_sharded import (
    ShardedSolver,
    _host_sharded_args,
    block_shape,
    global_indices,
    host_report,
    measured_solve,
)
from poisson_ellipse_tpu_torch.solver.pcg import (
    DEFAULT_CHUNK,
    DENOM_GUARD,
    PCGResult,
    run_chunked,
    unported,
)


def _pipelined_parts(problem: Problem, mesh: Mesh, bm: int, bn: int, a_blk,
                     b_blk, rhs_blk, dtype):
    """(state0, body) for this rank's block of the pipelined iteration;
    ``body(state, k, limit)`` is one iteration, ``k`` the one the host
    expects it to run. Making them exchanges the coefficient halos and w₀'s
    (3 halo exchanges, no reduction)."""
    like = rhs_blk
    h1, h2 = spacing(problem.h1, like), spacing(problem.h2, like)
    hw = h1 * h2
    delta = spacing(problem.delta, like)
    weighted = problem.norm == "weighted"
    one = torch.ones((), dtype=dtype, device=like.device)
    gi, gj = global_indices(mesh, bm, bn)
    interior = assembly.interior_mask(problem, gi, gj)

    # the one coefficient halo exchange (loop invariant)
    a_ext = halo_extend(a_blk, mesh)
    b_ext = halo_extend(b_blk, mesh)
    d = torch.where(interior, diag_d_block(a_ext, b_ext, h1, h2),
                    torch.zeros((), dtype=dtype, device=like.device))
    maskd = interior.to(dtype)

    def stencil(v_ext):
        return apply_a_block(v_ext, a_ext, b_ext, h1, h2) * maskd

    def stencil_of(v):
        return stencil(halo_extend(v, mesh))

    def dinv(v):
        return apply_dinv(v, d)

    def rebuilt(x, p):
        """Residual replacement from the ground-truth x and p: two stacked
        halo exchanges and four stencils, no reduction."""
        xp_ext = halo_extend_stacked(torch.stack([x, p]), mesh)
        r = rhs_blk - stencil(xp_ext[0])
        s = stencil(xp_ext[1])
        u = dinv(r)
        uq_ext = halo_extend_stacked(torch.stack([u, dinv(s)]), mesh)
        return r, u, stencil(uq_ext[0]), stencil(uq_ext[1]), s

    u0 = dinv(rhs_blk)
    zeros = torch.zeros_like(rhs_blk)
    state0 = PipelinedState(
        k=torch.zeros((), dtype=torch.int32, device=like.device),
        x=zeros, r=rhs_blk, u=u0, w=stencil_of(u0), z=zeros, s=zeros,
        p=zeros,
        gamma_prev=torch.ones((), dtype=dtype, device=like.device),
        diff=torch.full((), float("inf"), dtype=dtype, device=like.device),
        converged=torch.zeros((), dtype=torch.bool, device=like.device),
        breakdown=torch.zeros((), dtype=torch.bool, device=like.device),
    )

    def body(st: PipelinedState, k: int, limit: int) -> PipelinedState:
        active = (st.k < limit) & ~st.converged & ~st.breakdown
        x, r, u, w, z, s, p = st.x, st.r, st.u, st.w, st.z, st.s, st.p
        if k > 0 and k % REPLACE_EVERY == 0:
            r, u, w, z, s = rebuilt(x, p)

        # the one reduction of the iteration: all eight partials stacked
        sums = mesh.reduce(rank_sums(*_bundle(r, u, w, s, p)), dtype)
        # which this halo exchange and stencil do not consume
        n = stencil_of(dinv(w))

        gamma = sums[0] * hw
        wu, wp, su, sp = sums[1], sums[2], sums[3], sums[4]
        uu, up, pp = sums[5], sums[6], sums[7]
        beta = torch.zeros_like(gamma) if k == 0 else gamma / st.gamma_prev
        denom = (wu + beta * (wp + su) + beta * beta * sp) * hw
        breakdown = denom < DENOM_GUARD
        alpha = gamma / torch.where(breakdown, one, denom)

        z_new = n + beta * z
        s_new = w + beta * s
        p_new = u + beta * p
        x_new = x + alpha * p_new
        r_new = r - alpha * s_new
        u_new = u - alpha * dinv(s_new)
        w_new = w - alpha * z_new

        pp_new = uu + 2.0 * beta * up + beta * beta * pp
        dw2 = alpha * alpha * pp_new
        diff = torch.sqrt(dw2 * hw) if weighted else torch.sqrt(dw2)
        converged = ~breakdown & (diff < delta)

        # a breakdown iteration discards its update; a body past the exit
        # changes nothing
        upd = active & ~breakdown

        def keep(old, new):
            return torch.where(upd, new, old)

        return PipelinedState(
            k=st.k + active.to(st.k.dtype),
            x=keep(st.x, x_new), r=keep(st.r, r_new), u=keep(st.u, u_new),
            w=keep(st.w, w_new), z=keep(st.z, z_new), s=keep(st.s, s_new),
            p=keep(st.p, p_new),
            gamma_prev=keep(st.gamma_prev, gamma),
            diff=keep(st.diff, diff),
            converged=st.converged | (active & converged),
            breakdown=st.breakdown | (active & breakdown),
        )

    return state0, body


def _advance(problem: Problem, body, state: PipelinedState, limit=None,
             chunk: int = DEFAULT_CHUNK):
    """Advance the carry until convergence, breakdown or iteration
    ``limit``; returns (carry, host reads, bodies issued)."""
    cap = problem.max_iterations
    limit = cap if limit is None else min(int(limit), cap)
    carry = [state]
    bodies = [0]

    def step(k: int):
        carry[0] = body(carry[0], k, limit)
        bodies[0] += 1

    def flags():
        st = carry[0]
        return torch.stack([st.k, st.converged.to(st.k.dtype),
                            st.breakdown.to(st.k.dtype)])

    syncs = run_chunked(step, flags, limit, chunk)
    return carry[0], syncs, bodies[0]


def build_pipelined_sharded_solver(problem: Problem, mesh: Mesh | None = None,
                                   dtype=torch.float32, geometry=None,
                                   theta=None, chunk: int = DEFAULT_CHUNK):
    """(solver, args) for this rank's part of the pipelined mesh-sharded
    solve: args are this rank's blocks of the host-assembled (a, b, rhs)
    (``pcg_sharded``'s host assembly), and ``solver(*args)`` returns a
    ``PCGResult`` whose ``w`` is this rank's block (a ``ShardedSolver``)."""
    if geometry is not None or theta is not None:
        raise unported("geometry=/theta=", "Queue A item 11")
    if mesh is None:
        mesh = make_mesh()
    bm, bn = block_shape(problem, mesh)

    def run(a_blk, b_blk, rhs_blk, limit=None):
        state0, body = _pipelined_parts(problem, mesh, bm, bn, a_blk, b_blk,
                                        rhs_blk, dtype)
        state, syncs, bodies = _advance(problem, body, state0, limit, chunk)
        return pipelined_sharded_result_of(problem, state), syncs, bodies

    return ShardedSolver(run), _host_sharded_args(problem, mesh, dtype)


def build_pipelined_sharded_stepper(*_args, **_kwargs):
    """The chunked/resumable pipelined mesh stepper (``resilience.guard``'s
    and the contract checker's) is not ported yet."""
    raise unported("build_pipelined_sharded_stepper", "Queue A item 21b")


def pipelined_sharded_result_of(problem: Problem,
                                state: PipelinedState) -> PCGResult:
    """View a pipelined sharded carry as a ``PCGResult`` over this rank's
    block (``pcg_sharded.gather_w`` crops the padding of the global w)."""
    return PCGResult(w=state.x, iters=state.k, diff=state.diff,
                     converged=state.converged, breakdown=state.breakdown)


def solve_pipelined_sharded(problem: Problem, mesh: Mesh | None = None,
                            dtype=torch.float32,
                            chunk: int = DEFAULT_CHUNK) -> PCGResult:
    """Assemble, shard and solve with the pipelined one-reduction
    iteration; ``w`` is this rank's block."""
    solver, args = build_pipelined_sharded_solver(problem, mesh, dtype,
                                                  chunk=chunk)
    return solver(*args)


def solve_report(problem: Problem, dtype=torch.float32,
                 chunk: int = DEFAULT_CHUNK, device=None) -> dict:
    """One pipelined sharded solve from this module's builder on this rank
    (``pcg_sharded.host_report``); every rank calls it together, with the
    ``device`` type its group was started on."""
    mesh = make_mesh(device=device)
    solver, args = build_pipelined_sharded_solver(problem, mesh, dtype,
                                                  chunk=chunk)
    return host_report(problem, mesh, solver,
                       *measured_solve(mesh, solver, args))
