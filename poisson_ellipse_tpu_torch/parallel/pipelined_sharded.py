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

``build_pipelined_sharded_stepper`` is the chunked form the guard drives
(``pcg_sharded.build_sharded_stepper``'s contract over this carry), with
the residual replacement keyed on the host's iteration, so a chunked run
is a straight run. ``abft=True`` runs the JAX module's checks adapted to
this recurrence: the one reduction comes before the updates, so the Σr
recurrence is checked one iteration late (iteration k+1's reduced Σr
against the prediction Σr − α·(Σw + β·Σs) carried from k, skipped where
the replacement rebuilt r), Σp against Σu + β·Σp, and γ > 0; the ten
partials ride the same reduction (``PipelinedABFTState``, the tail at
``PIPE_PRED`` … ``PIPE_SDC``).

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

import types
from typing import NamedTuple

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
    _host_blocks,
    _host_sharded_args,
    block_shape,
    global_indices,
    host_report,
    measured_solve,
)
from poisson_ellipse_tpu_torch.resilience.abft import (
    abft_dummy_tail,
    abft_rtol,
    drift_ok,
    plain_and_abs_sums,
    with_tail,
)
from poisson_ellipse_tpu_torch.solver.pcg import (
    DEFAULT_CHUNK,
    DENOM_GUARD,
    PCGResult,
    PCGState,
    run_chunked,
    unported,
)

# the ABFT tail's places in the pipelined carry: (…, pred_r, scale_r,
# pred_p, scale_p, sdc), the lagged checks of the module docstring
PIPE_PRED, PIPE_SCALE, PIPE_PRED_P, PIPE_SCALE_P, PIPE_SDC = (
    12, 13, 14, 15, 16
)


class PipelinedABFTState(NamedTuple):
    """The pipelined carry (``ops.pipelined_pcg.PipelinedState``'s twelve
    fields) with the lagged ABFT tail."""

    k: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor
    u: torch.Tensor
    w: torch.Tensor
    z: torch.Tensor
    s: torch.Tensor
    p: torch.Tensor
    gamma_prev: torch.Tensor
    diff: torch.Tensor
    converged: torch.Tensor
    breakdown: torch.Tensor
    pred_r: torch.Tensor
    scale_r: torch.Tensor
    pred_p: torch.Tensor
    scale_p: torch.Tensor
    sdc: torch.Tensor


def _pipelined_parts(problem: Problem, mesh: Mesh, bm: int, bn: int, a_blk,
                     b_blk, rhs_blk, dtype, abft: bool = False,
                     extras: dict | None = None):
    """(state0, body) for this rank's block of the pipelined iteration;
    ``body(state, k, limit)`` is one iteration, ``k`` the one the host
    expects it to run. Making them exchanges the coefficient halos and w₀'s
    (3 halo exchanges, no reduction). ``abft`` extends the carry with the
    lagged checks' tail. ``extras``, a dict, gets the operators the
    stepper's recover uses ("stencil_of", "dinv", "maskd")."""
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

    if extras is not None:
        extras.update(stencil_of=stencil_of, dinv=dinv, maskd=maskd)
    rtol = abft_rtol(dtype) if abft else None
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
    if abft:
        # the lagged checks start at k = 1
        zero = torch.zeros((), dtype=dtype, device=like.device)
        state0 = PipelinedABFTState(*state0, zero, zero, zero, zero,
                                    torch.zeros_like(state0.converged))

    def body(st, k: int, limit: int):
        active = (st.k < limit) & ~st.converged & ~st.breakdown
        if abft:
            # a flagged carry stops at once: the guard rolls it back
            active = active & ~st.sdc
        x, r, u, w, z, s, p = st.x, st.r, st.u, st.w, st.z, st.s, st.p
        replaced = k > 0 and k % REPLACE_EVERY == 0
        if replaced:
            r, u, w, z, s = rebuilt(x, p)

        # the one reduction of the iteration: all eight partials stacked
        # (and the ABFT partials Σr, Σ|r|, Σw, Σ|w|, Σs, Σ|s|, Σp, Σ|p|,
        # Σu, Σ|u| of the vectors the bundle reads)
        partials = rank_sums(*_bundle(r, u, w, s, p))
        if abft:
            partials = torch.cat([partials,
                                  plain_and_abs_sums(r, w, s, p, u)])
        sums = mesh.reduce(partials, dtype)
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

        out = PipelinedState(
            k=st.k + active.to(st.k.dtype),
            x=keep(st.x, x_new), r=keep(st.r, r_new), u=keep(st.u, u_new),
            w=keep(st.w, w_new), z=keep(st.z, z_new), s=keep(st.s, s_new),
            p=keep(st.p, p_new),
            gamma_prev=keep(st.gamma_prev, gamma),
            diff=keep(st.diff, diff),
            converged=st.converged | (active & converged),
            breakdown=st.breakdown | (active & breakdown),
        )
        if not abft:
            return out
        (s_r, s_absr, s_w, s_absw, s_s, s_abss, s_p, s_absp, s_u,
         s_absu) = sums[8:18]
        # the replacement rebuilt r away from the carried prediction: no
        # r check there (p holds: the rebuild takes p as ground truth)
        ok = (drift_ok(s_p, st.pred_p, st.scale_p, rtol)
              # γ is an energy product: positive until convergence
              & (st.gamma_prev > 0))
        if not replaced:
            ok = ok & drift_ok(s_r, st.pred_r, st.scale_r, rtol)
        fault = active & ~ok if k > 0 else torch.zeros_like(active)
        # this iteration's incoming r and p for the next: r − α(w + βs)
        # and u + βp, with the round-off scale of each prediction
        ab, bb = torch.abs(alpha), torch.abs(beta)
        return PipelinedABFTState(
            *out,
            keep(st.pred_r, s_r - alpha * (s_w + beta * s_s)),
            keep(st.scale_r, s_absr + ab * (s_absw + bb * s_abss)),
            keep(st.pred_p, s_u + beta * s_p),
            keep(st.scale_p, s_absu + bb * s_absp),
            st.sdc | fault)

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


def stepper_parts(problem: Problem, mesh: Mesh | None, dtype,
                  abft: bool = False):
    """The stepper's parts over one build of this rank's operands (the
    coefficient halos exchanged once), as a namespace: ``init``,
    ``advance``, ``recover`` (the replacement's rebuild on demand),
    ``to_classical`` (the guard's fallback conversion) and ``rhs_norm``."""
    if mesh is None:
        mesh = make_mesh()
    bm, bn = block_shape(problem, mesh)
    a_blk, b_blk, rhs_blk, rhs_norm = _host_blocks(problem, mesh, dtype)
    ops: dict = {}
    state0, body = _pipelined_parts(problem, mesh, bm, bn, a_blk, b_blk,
                                    rhs_blk, dtype, abft=abft, extras=ops)
    stencil_of, dinv, maskd = ops["stencil_of"], ops["dinv"], ops["maskd"]
    h1, h2 = spacing(problem.h1, rhs_blk), spacing(problem.h2, rhs_blk)
    cap = problem.max_iterations

    def advance_fn(state, limit, k=None):
        limit = min(int(limit), cap)
        k = int(state.k) if k is None else int(k)
        for it in range(k, limit):
            state = body(state, it, limit)
        return state

    def true_residual(x):
        return (rhs_blk - stencil_of(x)) * maskd

    def recover_fn(state):
        """The replacement's rebuild on demand: every recurrence vector
        from x and p, p kept, γ₋₁ reset to 1 where it is not a positive
        number; the ABFT tail re-anchored to r and p (one reduction)."""
        x, p, g = state.x, state.p, state.gamma_prev
        r2 = true_residual(x)
        u2 = dinv(r2)
        w2 = stencil_of(u2)
        s2 = stencil_of(p)
        z2 = stencil_of(dinv(s2))
        g2 = torch.where(torch.isfinite(g) & (g > 0), g, torch.ones_like(g))
        false = torch.zeros_like(state.converged)
        out = PipelinedState(k=state.k, x=x, r=r2, u=u2, w=w2, z=z2, s=s2,
                             p=p, gamma_prev=g2, diff=state.diff,
                             converged=false, breakdown=false)
        if not abft:
            return out
        sums = mesh.reduce(plain_and_abs_sums(r2, p), dtype)
        return PipelinedABFTState(*out, *sums.unbind(), false)

    def to_classical(state):
        """The classical carry from a pipelined one: the classical
        end-of-iteration update once, p₀ = z + (zr/γ)·p (one halo
        exchange, one reduction); with ``abft`` a placeholder tail, which
        the recover that follows re-anchors."""
        x, p = state.x, state.p
        r2 = true_residual(x)
        z2 = dinv(r2)
        zr2 = mesh.reduce(rank_sums((z2, r2)), dtype)[0] * h1 * h2
        false = torch.zeros_like(state.converged)
        out = PCGState(k=state.k, w=x, r=r2, p=z2 + (zr2 / state.gamma_prev)
                       * p, zr=zr2, diff=state.diff, converged=false,
                       breakdown=false)
        return with_tail(out, abft_dummy_tail(zr2)) if abft else out

    return types.SimpleNamespace(init=lambda: state0, advance=advance_fn,
                                 recover=recover_fn,
                                 to_classical=to_classical,
                                 rhs_norm=rhs_norm)


def build_pipelined_sharded_stepper(problem: Problem,
                                    mesh: Mesh | None = None,
                                    dtype=torch.float32, abft: bool = False):
    """(init_fn, advance_fn) for chunked, resumable pipelined mesh solves
    on this rank (``pcg_sharded.build_sharded_stepper``'s contract over
    the twelve-field pipelined carry, ``PipelinedABFTState`` with
    ``abft``); every rank builds and calls them together."""
    parts = stepper_parts(problem, mesh, dtype, abft)
    return parts.init, parts.advance


def pipelined_sharded_result_of(problem: Problem, state) -> PCGResult:
    """View a pipelined sharded carry (any ABFT tail ignored) as a
    ``PCGResult`` over this rank's block (``pcg_sharded.gather_w`` crops
    the padding of the global w)."""
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
