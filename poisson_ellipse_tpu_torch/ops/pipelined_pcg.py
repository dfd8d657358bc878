"""Pipelined PCG (Ghysels–Vanroose): one fused reduction per iteration.

The counterpart of ``poisson_ellipse_tpu.ops.pipelined_pcg``, with the
same recurrence, carry and bundle order. All inner products of an
iteration are functions of vectors carried in from the previous one, so
they form one eight-pair bundle, and the iteration's stencil does not
depend on it:

  [one dot bundle]  γ = (r,u)  (w,u) (w,p) (s,u) (s,p)  (u,u) (u,p) (p,p)
  [one stencil]     m = M⁻¹w;  n = A m
  β  = γ/γ₋₁ (0 at the first iteration)
  α  = γ / [(w,u) + β((w,p) + (s,u)) + β²(s,p)]
  z⁺ = n + βz    s⁺ = w + βs    p⁺ = u + βp
  x⁺ = x + αp⁺   r⁺ = r − αs⁺   u⁺ = u − αM⁻¹s⁺   w⁺ = w − αz⁺

with M = D (Jacobi) and the reference's h1·h2-weighted dots. The
α-denominator is the bundle's expansion of (Ap⁺, p⁺), under the
reference's breakdown guard; ‖Δx‖² = α²[(u,u) + 2β(u,p) + β²(p,p)].

Every ``REPLACE_EVERY`` iterations the recurrence-maintained r, u, w, z, s
are rebuilt from x and p (four stencil applications), which bounds their
drift from the true residual in f32.

Stencils: ``"xla"`` applies the plain stencil and sums the bundle with
``grid_dots``; ``"pallas"`` runs K-d (``hopper_kernels.apply_a_dots_kernel``)
once per iteration for n and the whole bundle, every operand read once,
and K-a for w₀ and the rebuilds.

Where the JAX loop decides on the device, this loop decides on the host
(``solver.pcg.run_chunked``), which passes each body the iteration it
runs while the loop is active. The host therefore issues the four rebuild
stencils only in the bodies where the replacement fires, and β = 0 only
in the first. A body issued after the loop has exited must change
nothing: unlike the classical loop, α = 0 would not freeze this state
(z⁺ = n + βz still moves), so every carried field is masked by
``active`` and by the breakdown exit, which discards the iteration's
update. Chunked and straight runs then agree bitwise in every field.

``storage_dtype`` (``ops.precision``) stores the carry's seven vectors
narrow, rebuilds every ``replace_every(storage_dtype)`` iterations (8 under
bf16 or f16) and rounds a, b and D once. m = D⁻¹w stays at compute width.
``"pallas"`` then runs K-h (``apply_a_dots_mixed_kernel``) on m and the
stored bundle operands, and K-g for the rebuilds. w₀ is A·u₀ at full
width (K-a for ``"pallas"``), as in the JAX ``init_state``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.ops.precision import (
    load,
    replace_every,
    resolve_storage_dtype,
    store,
)
from poisson_ellipse_tpu_torch.ops.reduction import grid_dots
from poisson_ellipse_tpu_torch.ops.stencil import apply_dinv, diag_d, spacing
from poisson_ellipse_tpu_torch.solver.pcg import (
    DEFAULT_CHUNK,
    DENOM_GUARD,
    PCGResult,
    reject_unported,
    run_chunked,
    stencil_fn,
    stored_operands,
)
from poisson_ellipse_tpu_torch.utils.device import resolve_device

# Residual-replacement period (iterations) with no storage dtype: the JAX
# package's f32 and f64 cadence (``ops.precision.replace_every``)
REPLACE_EVERY = replace_every()


class PipelinedState(NamedTuple):
    """The resumable carry, in the JAX carry's order."""

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


def _stencil_and_dots_fn(problem: Problem, a, b, h1, h2, stencil: str,
                         storage_dtype=None):
    """(n, raw bundle sums) for m and the carried (r, u, w, s, p); with
    ``storage_dtype`` and "pallas" the bundle operands are the stored ones
    and ``a``, ``b`` the stored coefficients (K-h)."""
    if stencil == "pallas" and storage_dtype is not None:
        from poisson_ellipse_tpu_torch.ops.hopper_kernels import (
            apply_a_dots_mixed_kernel,
        )

        return lambda m, r, u, w, s, p: apply_a_dots_mixed_kernel(
            m, a, b, problem.h1, problem.h2, _bundle(r, u, w, s, p),
            h1.dtype)
    if stencil == "pallas":
        from poisson_ellipse_tpu_torch.ops.hopper_kernels import (
            apply_a_dots_kernel,
        )

        return lambda m, r, u, w, s, p: apply_a_dots_kernel(
            m, a, b, problem.h1, problem.h2, _bundle(r, u, w, s, p))
    apply_stencil = stencil_fn(problem, a, b, h1, h2, stencil, storage_dtype)
    return lambda m, r, u, w, s, p: (apply_stencil(m),
                                     grid_dots(*_bundle(r, u, w, s, p)))


def _bundle(r, u, w, s, p):
    """The iteration's eight dot pairs, in bundle order: γ, the four
    α-denominator terms, and the three ‖Δx‖-recurrence terms."""
    return (
        (r, u),
        (w, u), (w, p), (s, u), (s, p),
        (u, u), (u, p), (p, p),
    )


def init_state(problem: Problem, a, b, rhs, stencil: str = "xla",
               history: bool = False,
               storage_dtype=None) -> PipelinedState:
    """The pipelined carry at iteration 0: x = 0, r = rhs, u = D⁻¹r,
    w = A·u (the one stencil application outside the loop), z = s = p = 0
    (β = 0 in the first iteration rebuilds them), γ₋₁ = 1 (it divides
    only under that β = 0), diff = inf. With ``storage_dtype`` the seven
    vectors are stored in it (u₀ and w₀ computed at full width first)."""
    reject_unported(history, storage_dtype=storage_dtype)
    st = resolve_storage_dtype(storage_dtype, rhs.dtype)
    dtype, dev = rhs.dtype, rhs.device
    h1, h2 = spacing(problem.h1, rhs), spacing(problem.h2, rhs)
    d = diag_d(a, b, h1, h2)
    u0 = apply_dinv(rhs, d)
    w0 = stencil_fn(problem, a, b, h1, h2, stencil)(u0)
    zeros = torch.zeros_like(rhs, dtype=st or dtype)
    return PipelinedState(
        k=torch.zeros((), dtype=torch.int32, device=dev),
        x=zeros,
        r=store(rhs, st),
        u=store(u0, st),
        w=store(w0, st),
        z=zeros,
        s=zeros,
        p=zeros,
        gamma_prev=torch.ones((), dtype=dtype, device=dev),
        diff=torch.full((), float("inf"), dtype=dtype, device=dev),
        converged=torch.zeros((), dtype=torch.bool, device=dev),
        breakdown=torch.zeros((), dtype=torch.bool, device=dev),
    )


def make_body(problem: Problem, a, b, rhs, limit: int, stencil: str = "xla",
              storage_dtype=None):
    """One pipelined iteration as ``body(state, k)``, where ``k`` is the
    iteration the host expects the body to run (exact while the loop is
    active, and irrelevant after it has exited, when the body is a
    no-op)."""
    dtype = rhs.dtype
    sd = resolve_storage_dtype(storage_dtype, dtype)
    cadence = replace_every(sd, dtype)
    h1, h2 = spacing(problem.h1, rhs), spacing(problem.h2, rhs)
    hw = h1 * h2
    delta = spacing(problem.delta, rhs)
    weighted = problem.norm == "weighted"
    one = torch.ones((), dtype=dtype, device=rhs.device)
    a_s, b_s, d_s = stored_operands(a, b, diag_d(a, b, h1, h2), sd)
    d = load(d_s, dtype, sd)
    apply_stencil = stencil_fn(problem, a_s, b_s, h1, h2, stencil, sd)
    stencil_and_dots = _stencil_and_dots_fn(problem, a_s, b_s, h1, h2,
                                            stencil, sd)
    # K-h reads the bundle at storage width; every other form at compute
    # width
    narrow_bundle = sd is not None and stencil == "pallas"

    def dinv(v):
        return apply_dinv(v, d)

    def body(st: PipelinedState, k: int) -> PipelinedState:
        active = (st.k < limit) & ~st.converged & ~st.breakdown
        x, r, u, w, z, s, p = (load(v, dtype, sd) for v in
                               (st.x, st.r, st.u, st.w, st.z, st.s, st.p))
        # the stored bundle operands: the carried tensors themselves
        # (store(load(v)) == v), rounded anew only where rebuilt
        bundle = (st.r, st.u, st.w, st.s, st.p)
        if k > 0 and k % cadence == 0:
            # residual replacement: rebuild the recurrence-maintained
            # vectors from the ground-truth x and p
            r = rhs - apply_stencil(x)
            u = dinv(r)
            s = apply_stencil(p)
            w = apply_stencil(u)
            z = apply_stencil(dinv(s))
            bundle = tuple(store(v, sd) for v in (r, u, w, s)) + (st.p,)
        m = dinv(w)
        if narrow_bundle:
            n, sums = stencil_and_dots(m, *bundle)
        else:
            n, sums = stencil_and_dots(m, r, u, w, s, p)
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

        # a breakdown iteration discards its update (the reference exits
        # before touching w/r); a body past the exit changes nothing
        upd = active & ~breakdown

        def keep(old, new):
            return torch.where(upd, store(new, sd), old)

        return PipelinedState(
            k=st.k + active.to(st.k.dtype),
            x=keep(st.x, x_new),
            r=keep(st.r, r_new),
            u=keep(st.u, u_new),
            w=keep(st.w, w_new),
            z=keep(st.z, z_new),
            s=keep(st.s, s_new),
            p=keep(st.p, p_new),
            gamma_prev=torch.where(upd, gamma, st.gamma_prev),
            diff=torch.where(upd, diff, st.diff),
            converged=st.converged | (active & converged),
            breakdown=st.breakdown | (active & breakdown),
        )

    return body


def advance(problem: Problem, a, b, rhs, state: PipelinedState, limit=None,
            stencil: str = "xla", chunk: int = DEFAULT_CHUNK,
            history: bool = False, storage_dtype=None):
    """Advance the pipelined carry until convergence/breakdown or
    iteration ``limit`` (default ``max_iterations``). Returns (new carry,
    host reads). Chunked runs (limit = k, k + K, …; any ``chunk``) are
    bitwise equal to one straight run: the replacement is keyed on the
    iteration counter, not on where the host looks. ``storage_dtype`` must
    be the one the carry was made with."""
    reject_unported(history, storage_dtype=storage_dtype)
    cap = problem.max_iterations
    limit = cap if limit is None else min(int(limit), cap)
    body = make_body(problem, a, b, rhs, limit, stencil, storage_dtype)
    carry = [state]

    def step(k: int):
        carry[0] = body(carry[0], k)

    def flags():
        st = carry[0]
        return torch.stack([st.k, st.converged.to(st.k.dtype),
                            st.breakdown.to(st.k.dtype)])

    syncs = run_chunked(step, flags, limit, chunk)
    return carry[0], syncs


def result_of(state: PipelinedState) -> PCGResult:
    """View a pipelined carry as a PCGResult."""
    return PCGResult(w=state.x, iters=state.k, diff=state.diff,
                     converged=state.converged, breakdown=state.breakdown)


def pcg_pipelined(problem: Problem, a, b, rhs, stencil: str = "xla",
                  chunk: int = DEFAULT_CHUNK, history: bool = False,
                  storage_dtype=None) -> PCGResult:
    """Run pipelined PCG on pre-assembled (M+1, N+1) tensors on their
    device. stencil: "xla" (plain PyTorch) or "pallas" (K-d once per
    iteration, K-a for w₀ and the rebuilds; f32; with ``storage_dtype``
    K-h once per iteration and K-g for the rebuilds)."""
    reject_unported(history, storage_dtype=storage_dtype)
    state = init_state(problem, a, b, rhs, stencil=stencil,
                       storage_dtype=storage_dtype)
    state, _ = advance(problem, a, b, rhs, state, stencil=stencil,
                       chunk=chunk, storage_dtype=storage_dtype)
    return result_of(state)


def solve(problem: Problem, dtype: torch.dtype = torch.float32,
          stencil: str = "xla", device=None, chunk: int = DEFAULT_CHUNK,
          history: bool = False, storage_dtype=None) -> PCGResult:
    """Assemble and solve on one device (cuda unless ``device='cpu'``)
    with the pipelined recurrence."""
    reject_unported(history, storage_dtype=storage_dtype)
    dev = resolve_device(device)
    a, b, rhs = assembly.assemble(problem, dtype, dev)
    return pcg_pipelined(problem, a, b, rhs, stencil=stencil, chunk=chunk,
                         storage_dtype=storage_dtype)
