"""Batched pipelined PCG: B lanes, one stacked (8, B) dot bundle a body.

The counterpart of ``poisson_ellipse_tpu.batch.batched_pipelined``: the
Ghysels–Vanroose recurrence of ``ops.pipelined_pcg`` widened by a lane
axis. Every inner product of an iteration is a function of vectors already
in hand, so the whole batch's bundle, eight sums for each of B lanes, is
one stacked reduction, and the iteration's stencil does not depend on it.

Per-lane semantics are ``ops.pipelined_pcg``'s: the expanded α
denominator, breakdown under ``DENOM_GUARD`` discarding the iteration's
update, residual replacement keyed on the global counter, and the
±2-of-classical iteration-count contract. The replacement comes every
``ops.precision.replace_every`` iterations of the run dtype, the single
engine's cadence: 32 at f32 and f64, 8 at bf16. At bf16 this departs, on
purpose, from the JAX batched engine
(``poisson_ellipse_tpu/batch/batched_pipelined.py``), which replaces
every 32 iterations at every dtype: there the bf16 recurrence grows
without bound from iteration 9 or so, γ by 2-10× an iteration, until the
rebuild at 32, and whether a lane's denominator first dips under the
guard depends on how the stencil rounds (with the bf16 stencil rounded
once, as K-e's and K-f's bf16 forms round it, 40×40 broke down at
iteration 14). So a bf16 lane here is the single-device bf16 pipelined
solve of its right-hand side, and where a JAX lane breaks down before
its first rebuild, the port's lane runs on: on lanes of distinct
scalings at 40² the JAX lanes break down at 15-18 and the port's run to
the cap (``tests/test_torch_batched.py``
``test_bf16_lane_pipelined_departs_from_jax_on_scaled_lanes``).
Lane freezing, quarantine and the bucket-embedding arguments follow
``batch.batched_pcg``.

As in ``ops.pipelined_pcg``, the host decides what the JAX loop decides on
the device: ``solver.pcg.run_chunked`` passes each body the iteration it
runs while the loop is active, so the four rebuild stencils are issued
only in the bodies where the replacement fires, and β = 0 only in the
first. Each lane's fields are masked against the carry the body was given,
not against the rebuilt vectors, so a frozen lane does not move at all (in
the JAX body a frozen lane's r, u, w, z and s are rebuilt with the rest;
its x, p, γ, diff and flags are not, so its result is the same). A body
issued after every lane has exited therefore changes nothing, and chunked
and straight runs are bitwise equal.

``stencil="pallas"`` runs K-f (``ops.hopper_kernels.apply_a_dots_batched_kernel``)
once a body for n and the whole (8, B) bundle, and K-e for w₀ and the
rebuilds, in f32 or in their bf16 forms (the bundle's sums in double,
rounded once to bf16).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from poisson_ellipse_tpu_torch.batch.batched_pcg import (
    BatchedPCGResult,
    _lane_ops,
    _scalar,
    apply_dinv_batched,
    diag_d_batched,
    lane_dots,
    running,
    stencil_closure,
)
from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops.precision import replace_every
from poisson_ellipse_tpu_torch.solver.pcg import (
    DEFAULT_CHUNK,
    DENOM_GUARD,
    run_chunked,
)


class BatchedPipelinedState(NamedTuple):
    """The resumable carry, in the JAX carry's 14-field order."""

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
    quarantined: torch.Tensor
    iters: torch.Tensor


def _bundle(r, u, w, s, p):
    """The iteration's eight dot pairs per lane, in
    ``ops.pipelined_pcg._bundle`` order: γ, the four α-denominator terms,
    the three ‖Δx‖-recurrence terms."""
    return (
        (r, u),
        (w, u), (w, p), (s, u), (s, p),
        (u, u), (u, p), (p, p),
    )


def _stencil_closure(a3, b3, m3, h1, h2, stencil: str, hs):
    """The per-lane A·(·) closure (``batched_pcg.stencil_closure``), with
    the bucket mask applied to its output."""
    fn = stencil_closure(a3, b3, h1, h2, stencil, hs)
    if m3 is None:
        return fn
    return lambda v: fn(v) * m3


def _reject_h_overrides(stencil: str, h1, h2) -> None:
    if stencil == "pallas" and (h1 is not None or h2 is not None):
        raise ValueError(
            "the batched Pallas kernels bake h1/h2 in as compile-time "
            "constants; traced overrides need stencil='xla'"
        )


def init_state(problem: Problem, a, b, rhs, mask=None, h1=None, h2=None,
               stencil: str = "xla") -> BatchedPipelinedState:
    """The batched pipelined carry at iteration 0: x = 0, r = rhs,
    u = D⁻¹r, w = A·u, z = s = p = 0, γ₋₁ = 1, diff = inf, with (B,)
    per-lane scalars and flags."""
    _reject_h_overrides(stencil, h1, h2)
    dev, lanes = rhs.device, rhs.shape[0]
    hh1 = _scalar(h1, problem.h1, rhs)
    hh2 = _scalar(h2, problem.h2, rhs)
    a3, b3, m3 = _lane_ops(a, b, mask)
    d = diag_d_batched(a3, b3, hh1, hh2, m3)
    apply_stencil = _stencil_closure(a3, b3, m3, hh1, hh2, stencil,
                                     (problem.h1, problem.h2))
    u0 = apply_dinv_batched(rhs, d)
    zeros = torch.zeros_like(rhs)
    flags = torch.zeros(lanes, dtype=torch.bool, device=dev)
    return BatchedPipelinedState(
        k=torch.zeros((), dtype=torch.int32, device=dev),
        x=zeros,
        r=rhs,
        u=u0,
        w=apply_stencil(u0),
        z=zeros,
        s=zeros,
        p=zeros,
        gamma_prev=torch.ones(lanes, dtype=rhs.dtype, device=dev),
        diff=torch.full((lanes,), float("inf"), dtype=rhs.dtype, device=dev),
        converged=flags,
        breakdown=flags,
        quarantined=flags,
        iters=torch.zeros(lanes, dtype=torch.int32, device=dev),
    )


def make_lane_step(rhs, a3, b3, d, m3, h1, h2, delta, weighted: bool,
                   stencil: str = "xla", hs=None, limit=None):
    """One batched-pipelined iteration as ``body(state, k)``, where ``k`` is
    the iteration the host expects the body to run (exact while any lane
    is active; a body with no active lane changes nothing). A lane is
    active while it has neither converged, broken down nor been
    quarantined, and k is below ``limit`` (None: no limit)."""
    hw = h1 * h2
    cadence = replace_every(None, rhs.dtype)
    apply_stencil = _stencil_closure(a3, b3, m3, h1, h2, stencil, hs)
    one = torch.ones((), dtype=rhs.dtype, device=rhs.device)

    if stencil == "pallas":
        from poisson_ellipse_tpu_torch.ops.hopper_kernels import (
            apply_a_dots_batched_kernel,
        )

        def stencil_and_dots(m, r, u, w, s, p):
            # one launch: n = A·m and the (8, B) bundle, every operand
            # read once
            n, sums = apply_a_dots_batched_kernel(
                m, a3[0], b3[0], hs[0], hs[1], _bundle(r, u, w, s, p))
            return (n if m3 is None else n * m3), sums
    else:
        def stencil_and_dots(m, r, u, w, s, p):
            return apply_stencil(m), lane_dots(*_bundle(r, u, w, s, p))

    def dinv(v):
        return apply_dinv_batched(v, d)

    def body(st: BatchedPipelinedState, k: int) -> BatchedPipelinedState:
        active = ~st.converged & ~st.breakdown & ~st.quarantined
        if limit is not None:
            active = active & (st.k < limit)
        r, u, w, z, s = st.r, st.u, st.w, st.z, st.s
        if k > 0 and k % cadence == 0:
            # residual replacement from the ground-truth x and p, all
            # lanes at once
            r = rhs - apply_stencil(st.x)
            u = dinv(r)
            s = apply_stencil(st.p)
            w = apply_stencil(u)
            z = apply_stencil(dinv(s))

        m = dinv(w)
        n, sums = stencil_and_dots(m, r, u, w, s, st.p)
        gamma = sums[0] * hw
        wu, wp, su, sp = sums[1], sums[2], sums[3], sums[4]
        uu, up, pp = sums[5], sums[6], sums[7]

        beta = torch.zeros_like(gamma) if k == 0 else gamma / st.gamma_prev
        denom = (wu + beta * (wp + su) + beta * beta * sp) * hw
        breakdown = denom < DENOM_GUARD
        alpha = gamma / torch.where(breakdown, one, denom)

        be = beta[:, None, None]
        al = alpha[:, None, None]
        z_new = n + be * z
        s_new = w + be * s
        p_new = u + be * st.p
        x_new = st.x + al * p_new
        r_new = r - al * s_new
        u_new = u - al * dinv(s_new)
        w_new = w - al * z_new

        pp_new = uu + 2.0 * beta * up + beta * beta * pp
        dw2 = alpha * alpha * pp_new
        diff = torch.sqrt(dw2 * hw) if weighted else torch.sqrt(dw2)
        converged = ~breakdown & (diff < delta)
        diff = torch.where(breakdown, st.diff, diff)

        # lane quarantine from the scalars already in hand
        sick = active & ~(torch.isfinite(gamma) & torch.isfinite(denom)
                          & torch.isfinite(diff))
        breakdown = breakdown & ~sick
        converged = converged & ~sick

        # a breakdown lane discards its update; an inactive or sick lane
        # keeps the carry it came in with
        upd = active & ~breakdown & ~sick
        upd3 = upd[:, None, None]

        def keep(old, new):
            return torch.where(upd3, new, old)

        return BatchedPipelinedState(
            k=st.k + active.any().to(st.k.dtype),
            x=keep(st.x, x_new),
            r=keep(st.r, r_new),
            u=keep(st.u, u_new),
            w=keep(st.w, w_new),
            z=keep(st.z, z_new),
            s=keep(st.s, s_new),
            p=keep(st.p, p_new),
            gamma_prev=torch.where(upd, gamma, st.gamma_prev),
            diff=torch.where(active & ~sick, diff, st.diff),
            converged=st.converged | (active & converged),
            breakdown=st.breakdown | (active & breakdown),
            quarantined=st.quarantined | sick,
            iters=torch.where(active, st.k + 1, st.iters),
        )

    return body


def make_body(problem: Problem, a, b, rhs, limit: int, mask=None, h1=None,
              h2=None, delta=None, stencil: str = "xla"):
    """``body(state, k)`` with the operands, overrides and stencil
    resolved once (``batched_pcg.make_body``'s contract)."""
    _reject_h_overrides(stencil, h1, h2)
    hh1 = _scalar(h1, problem.h1, rhs)
    hh2 = _scalar(h2, problem.h2, rhs)
    dl = _scalar(delta, problem.delta, rhs)
    a3, b3, m3 = _lane_ops(a, b, mask)
    d = diag_d_batched(a3, b3, hh1, hh2, m3)
    return make_lane_step(rhs, a3, b3, d, m3, hh1, hh2, dl,
                          problem.norm == "weighted", stencil=stencil,
                          hs=(problem.h1, problem.h2), limit=limit)


def advance(problem: Problem, a, b, rhs, state: BatchedPipelinedState,
            limit=None, mask=None, h1=None, h2=None, delta=None,
            stencil: str = "xla", chunk: int = DEFAULT_CHUNK):
    """Advance the batched pipelined carry until no lane is active or k
    reaches ``limit``. Returns (new carry, host reads). The same bucket
    arguments as ``batched_pcg.advance``; chunked runs are bitwise equal
    to a straight run (the replacement keys on the global counter)."""
    cap = problem.max_iterations
    limit = cap if limit is None else min(int(limit), cap)
    body = make_body(problem, a, b, rhs, limit, mask, h1, h2, delta, stencil)
    carry = [state]

    def step(k: int):
        carry[0] = body(carry[0], k)

    syncs = run_chunked(step, lambda: running(carry[0]), limit, chunk)
    return carry[0], syncs


def result_of(state: BatchedPipelinedState) -> BatchedPCGResult:
    """View a batched pipelined carry as a BatchedPCGResult."""
    return BatchedPCGResult(w=state.x, iters=state.iters, diff=state.diff,
                            converged=state.converged,
                            breakdown=state.breakdown,
                            quarantined=state.quarantined)


def pcg_batched_pipelined(problem: Problem, a, b, rhs, mask=None,
                          stencil: str = "xla",
                          chunk: int = DEFAULT_CHUNK) -> BatchedPCGResult:
    """Run batched pipelined PCG on pre-assembled operands (the
    ``batched_pcg.pcg_batched`` contract); ``stencil="pallas"`` takes K-f
    once a body and K-e for w₀ and the rebuilds."""
    state = init_state(problem, a, b, rhs, mask=mask, stencil=stencil)
    state, _ = advance(problem, a, b, rhs, state, mask=mask, stencil=stencil,
                       chunk=chunk)
    return result_of(state)
