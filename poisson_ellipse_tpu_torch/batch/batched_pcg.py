"""Batched classical PCG: B independent solves in one loop.

The counterpart of ``poisson_ellipse_tpu.batch.batched_pcg``. The PCG
recurrence is the same for every problem; only the operands (a, b, rhs,
and through them ε) differ. So B problems are stacked on a leading lane
axis, (B, M+1, N+1), and run through one loop:

- **Per-lane masked updates.** Each lane carries its own scalars (zr,
  diff, α, β as (B,) tensors) and its own exit flags. A lane that
  converges, breaks down or is quarantined is frozen: later bodies
  compute its update and discard it with ``torch.where``. The ``where``
  tree is the JAX body's clause for clause: breakdown discards the
  update; a converged lane keeps its update but freezes p and zr;
  ``iters = where(active, k + 1, iters)``.
- **Stacked reductions.** The iteration's sums for all lanes are one
  (k, B) stack (``lane_dots``).
- **Lane quarantine** from the non-finite scalars already in hand: a NaN
  in a lane's carry shows in that lane's sums, so no extra array pass is
  needed to find it.
- **Bucket embedding.** h1, h2 and δ may be scalars or (B,) per lane, and
  an optional ``mask``, shared or per lane, pins nodes outside an embedded
  problem to zero.

The loop is the port's chunked loop (``solver.pcg.run_chunked``): the host
reads the flags once a chunk, and the loop has exited when no lane is
active or k has reached the limit. A body issued after that changes
nothing (every lane is inactive, k does not advance), so chunked and
straight runs are bitwise equal.

The contract held here is lane independence: lane l's w, iters and diff
are bitwise the same whatever the other lanes hold, a NaN lane included.
The per-lane sums (``torch.sum`` over a lane's grid) need not add in the
order of the single engine's ``torch.sum`` over one grid, so lane l agrees
with the single solve in iterations and to round-off in w, not bitwise as
the JAX package's lane 0 does.

``stencil="pallas"`` takes K-e (``ops.hopper_kernels.apply_a_batched_kernel``)
for A·p, in f32 or in its bf16 form. It needs lane-shared coefficients
and the problem's own spacings (the kernel takes h as scalars, rounded to
the run dtype as the plain loop's spacings are). At bf16 the lane fields,
the (B,) scalars and the stencil's output are bf16, as in the JAX bf16
body; the kernel computes the stencil in float and rounds it once, where
the plain ``xla`` stencil rounds each operation.

``storage_dtype`` (``ops.precision``) stores the lane fields w, r and p
narrow, with a, b and D rounded once; the per-lane scalars stay at compute
width. As in the JAX package it rides the plain stencil: K-e reads its
compute dtype only, and ``stencil="pallas"`` with a storage dtype is
refused.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.ops.precision import (
    load,
    resolve_storage_dtype,
    store,
)
from poisson_ellipse_tpu_torch.ops.stencil import apply_a, apply_dinv, diag_d
from poisson_ellipse_tpu_torch.solver.pcg import (
    DEFAULT_CHUNK,
    DENOM_GUARD,
    run_chunked,
    unported,
)
from poisson_ellipse_tpu_torch.utils.device import resolve_device


class BatchedPCGResult(NamedTuple):
    """Per-lane solver output: everything ``PCGResult`` reports, plus the
    quarantine mask (lanes masked out after a non-finite carry)."""

    w: torch.Tensor            # (B, M+1, N+1) per-lane solutions
    iters: torch.Tensor        # (B,) iteration each lane finished at
    diff: torch.Tensor         # (B,) final step norm per lane
    converged: torch.Tensor    # (B,) bool
    breakdown: torch.Tensor    # (B,) bool
    quarantined: torch.Tensor  # (B,) bool: non-finite lane, masked out


class BatchedPCGState(NamedTuple):
    """The resumable carry, in the JAX carry's order: the global iteration
    counter, the (B, M+1, N+1) fields, (B,) scalars and flags."""

    k: torch.Tensor
    w: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    zr: torch.Tensor
    diff: torch.Tensor
    converged: torch.Tensor
    breakdown: torch.Tensor
    quarantined: torch.Tensor
    iters: torch.Tensor


def _lane_ops(a, b, mask):
    """Operands in lane form: (g1, g2) coefficients and mask (shared by
    every lane) gain a leading axis of 1; (B, g1, g2) stay per lane."""
    a3 = a if a.dim() == 3 else a[None]
    b3 = b if b.dim() == 3 else b[None]
    m3 = None if mask is None else (mask if mask.dim() == 3 else mask[None])
    return a3, b3, m3


def _grid_scale(h):
    """``h`` as a lane-broadcastable grid factor: a 0-dim spacing stays
    0-dim (the single-problem expression tree); a (B,) per-lane spacing
    gains the (B, 1, 1) lane axis."""
    return h if h.dim() == 0 else h[:, None, None]


def _scalar(value, default, like: torch.Tensor) -> torch.Tensor:
    """An override (float, 0-dim or (B,)) or the problem's ``default`` as
    a tensor of ``like``'s dtype on its device."""
    return torch.as_tensor(default if value is None else value,
                           dtype=like.dtype, device=like.device)


def apply_a_batched(w, a3, b3, h1, h2):
    """A·w per lane: (B, g1, g2) iterate, (1|B, g1, g2) coefficients, zero
    boundary ring. ``ops.stencil.apply_a``'s expression tree term for term
    (each difference divided by h before combining); ``h1``/``h2`` 0-dim or
    (B,) per lane."""
    return apply_a(w, a3, b3, _grid_scale(h1), _grid_scale(h2))


def diag_d_batched(a3, b3, h1, h2, mask=None):
    """Per-lane diagonal of A with a zero ring; ``mask`` also zeroes it
    outside an embedded interior, which makes D⁻¹ pin those nodes to 0."""
    d = diag_d(a3, b3, _grid_scale(h1), _grid_scale(h2))
    return d if mask is None else d * mask


def apply_dinv_batched(r, d):
    """z = r / D with the zero guard, per lane ((1|B, ...) broadcasts)."""
    return apply_dinv(r, d)


def lane_dots(*pairs):
    """All per-lane Σ uᵢ·vᵢ as one stacked (k, B) tensor of raw sums;
    callers apply their h1·h2 weights."""
    return torch.stack([torch.sum(u * v, dim=(1, 2)) for u, v in pairs])


def init_state(problem: Problem, a, b, rhs, mask=None, h1=None, h2=None,
               storage_dtype=None, x0=None) -> BatchedPCGState:
    """The batched carry at iteration 0: w = 0, r = rhs, p = z = D⁻¹r,
    zr = (z, r) per lane, diff = inf, no flags, iters 0. ``h1``/``h2``
    override the problem's spacings (scalars or (B,)). With
    ``storage_dtype`` w, r and p are stored in it."""
    st = resolve_storage_dtype(storage_dtype, rhs.dtype)
    if x0 is not None:
        raise unported("x0=", "Queue A item 13")
    dev, lanes = rhs.device, rhs.shape[0]
    h1 = _scalar(h1, problem.h1, rhs)
    h2 = _scalar(h2, problem.h2, rhs)
    a3, b3, m3 = _lane_ops(a, b, mask)
    d = diag_d_batched(a3, b3, h1, h2, m3)
    z0 = apply_dinv_batched(rhs, d)
    zr0 = torch.sum(z0 * rhs, dim=(1, 2)) * h1 * h2
    flags = torch.zeros(lanes, dtype=torch.bool, device=dev)
    return BatchedPCGState(
        k=torch.zeros((), dtype=torch.int32, device=dev),
        w=torch.zeros_like(rhs, dtype=st or rhs.dtype),
        r=store(rhs, st),
        p=store(z0, st),
        zr=zr0,
        diff=torch.full((lanes,), float("inf"), dtype=rhs.dtype, device=dev),
        converged=flags,
        breakdown=flags,
        quarantined=flags,
        iters=torch.zeros(lanes, dtype=torch.int32, device=dev),
    )


def stencil_closure(a3, b3, h1, h2, stencil: str, hs):
    """The per-lane A·(·) closure: "xla" broadcasts through
    ``apply_a_batched``; "pallas" launches K-e with the lane-shared
    coefficients and the concrete spacings ``hs`` (per-lane coefficients
    raise, with the JAX error)."""
    if stencil == "pallas":
        from poisson_ellipse_tpu_torch.ops.hopper_kernels import (
            apply_a_batched_kernel,
        )

        if a3.shape[0] != 1 or b3.shape[0] != 1:
            raise ValueError(
                "the batched Pallas stencil streams lane-shared "
                "coefficients; per-lane (B, g1, g2) a/b need stencil='xla'"
            )
        return lambda p: apply_a_batched_kernel(p, a3[0], b3[0], hs[0],
                                                hs[1])
    if stencil == "xla":
        return lambda p: apply_a_batched(p, a3, b3, h1, h2)
    raise ValueError(f"unknown stencil: {stencil!r}")


def make_lane_step(a3, b3, d, m3, h1, h2, delta, weighted: bool,
                   stencil: str = "xla", hs=None, limit=None,
                   storage_dtype=None):
    """One batched-classical iteration as a carry → carry function.

    A lane is active while it has neither converged, broken down nor been
    quarantined, and k is below ``limit`` (None: no limit). A body with no
    active lane returns its carry unchanged, k included. With
    ``storage_dtype`` the lane fields are loaded at compute width and the
    new ones stored narrow, and a, b and D are rounded once here (the
    plain stencil on their upcast values).
    """
    st = storage_dtype
    dtype = d.dtype
    if st is not None:
        if stencil != "xla":
            raise ValueError(
                "storage_dtype on the batched engines rides the XLA stencil "
                "(the convert fuses into the consumers); the batched Pallas "
                "kernel is full-width"
            )
        # rounded once; their upcast values, once (the same values as a
        # load in every body)
        a3, b3, d = (load(store(x, st), dtype, st) for x in (a3, b3, d))
    apply_stencil = stencil_closure(a3, b3, h1, h2, stencil, hs)
    one = torch.ones((), dtype=dtype, device=d.device)

    def body(s: BatchedPCGState) -> BatchedPCGState:
        active = ~s.converged & ~s.breakdown & ~s.quarantined
        if limit is not None:
            active = active & (s.k < limit)
        w, r, p = (load(x, dtype, st) for x in (s.w, s.r, s.p))
        ap = apply_stencil(p)
        if m3 is not None:
            # bucket embedding: nodes outside the true interior stay
            # exactly zero (×1.0 elsewhere: a bitwise identity)
            ap = ap * m3
        denom = torch.sum(ap * p, dim=(1, 2)) * h1 * h2
        breakdown = denom < DENOM_GUARD
        alpha = s.zr / torch.where(breakdown, one, denom)

        al = alpha[:, None, None]
        w_new = w + al * p
        r_new = r - al * ap
        z = apply_dinv_batched(r_new, d)

        # the realised update (w_new − w), one stacked (2, B) reduction
        dw = w_new - w
        sums = lane_dots((z, r_new), (dw, dw))
        zr_new = sums[0] * h1 * h2
        dw2 = sums[1]
        diff = torch.sqrt(dw2 * h1 * h2) if weighted else torch.sqrt(dw2)
        converged = ~breakdown & (diff < delta)
        diff = torch.where(breakdown, s.diff, diff)

        # lane quarantine from the scalars already in hand: a poisoned
        # lane's sums are non-finite; the lane keeps its pre-fault carry
        sick = active & ~(torch.isfinite(denom) & torch.isfinite(zr_new)
                          & torch.isfinite(diff))
        breakdown = breakdown & ~sick
        converged = converged & ~sick

        beta = zr_new / s.zr
        p_new = z + beta[:, None, None] * p

        # per-lane freeze: an inactive or sick lane keeps its carry; a
        # breakdown lane discards its update; a converged lane keeps the
        # update but freezes p and zr
        upd = (active & ~breakdown & ~sick)[:, None, None]
        follow = active & ~breakdown & ~converged & ~sick
        return BatchedPCGState(
            k=s.k + active.any().to(s.k.dtype),
            w=torch.where(upd, store(w_new, st), s.w),
            r=torch.where(upd, store(r_new, st), s.r),
            p=torch.where(follow[:, None, None], store(p_new, st), s.p),
            zr=torch.where(follow, zr_new, s.zr),
            diff=torch.where(active & ~sick, diff, s.diff),
            converged=s.converged | (active & converged),
            breakdown=s.breakdown | (active & breakdown),
            quarantined=s.quarantined | sick,
            iters=torch.where(active, s.k + 1, s.iters),
        )

    return body


def make_body(problem: Problem, a, b, rhs, limit: int, mask=None, h1=None,
              h2=None, delta=None, stencil: str = "xla", storage_dtype=None):
    """``body(state, k)``: one iteration of every active lane below
    ``limit``, with the operands, overrides and stencil resolved once.
    ``k`` (the host's count) is unused: the classical body needs none."""
    if stencil == "pallas" and (h1 is not None or h2 is not None):
        raise ValueError(
            "the batched Pallas stencil bakes h1/h2 in as compile-time "
            "constants; traced overrides need stencil='xla' (the "
            "bucket-generic path)"
        )
    hh1 = _scalar(h1, problem.h1, rhs)
    hh2 = _scalar(h2, problem.h2, rhs)
    dl = _scalar(delta, problem.delta, rhs)
    a3, b3, m3 = _lane_ops(a, b, mask)
    d = diag_d_batched(a3, b3, hh1, hh2, m3)
    step = make_lane_step(a3, b3, d, m3, hh1, hh2, dl,
                          problem.norm == "weighted", stencil=stencil,
                          hs=(problem.h1, problem.h2), limit=limit,
                          storage_dtype=resolve_storage_dtype(storage_dtype,
                                                              rhs.dtype))
    return lambda state, _k: step(state)


def running(state) -> torch.Tensor:
    """(k, 1 if no lane is active else 0, 0) as one int32 device tensor:
    ``run_chunked``'s flags for a batched carry (either layout)."""
    active = ~state.converged & ~state.breakdown & ~state.quarantined
    done = (~active.any()).to(state.k.dtype)
    return torch.stack([state.k, done, torch.zeros_like(done)])


def advance(problem: Problem, a, b, rhs, state: BatchedPCGState, limit=None,
            mask=None, h1=None, h2=None, delta=None, stencil: str = "xla",
            chunk: int = DEFAULT_CHUNK, storage_dtype=None):
    """Advance the carry until no lane is active or k reaches ``limit``
    (default ``max_iterations``). Returns (new carry, host reads).

    ``h1``/``h2``/``delta`` may be scalars or (B,) per lane and ``mask``
    (g1, g2) shared or (B, g1, g2) per lane: the bucket-embedding
    arguments. Chunked runs (any ``chunk``, any sequence of ``limit``s)
    are bitwise equal to one straight run. ``storage_dtype`` must be the
    one the carry was made with.
    """
    cap = problem.max_iterations
    limit = cap if limit is None else min(int(limit), cap)
    body = make_body(problem, a, b, rhs, limit, mask, h1, h2, delta, stencil,
                     storage_dtype)
    carry = [state]

    def step(k: int):
        carry[0] = body(carry[0], k)

    syncs = run_chunked(step, lambda: running(carry[0]), limit, chunk)
    return carry[0], syncs


def result_of(state: BatchedPCGState) -> BatchedPCGResult:
    """View a batched carry as a BatchedPCGResult."""
    return BatchedPCGResult(w=state.w, iters=state.iters, diff=state.diff,
                            converged=state.converged,
                            breakdown=state.breakdown,
                            quarantined=state.quarantined)


def pcg_batched(problem: Problem, a, b, rhs, mask=None, stencil: str = "xla",
                chunk: int = DEFAULT_CHUNK,
                storage_dtype=None) -> BatchedPCGResult:
    """Run batched PCG on pre-assembled operands on their device: ``rhs``
    (B, M+1, N+1), ``a``/``b`` (M+1, N+1) shared or (B, M+1, N+1) per
    lane. ``stencil``: "xla" (plain PyTorch, any operands) or "pallas"
    (K-e; lane-shared coefficients, f32 or bf16). ``storage_dtype``: the lane
    fields stored narrow ("xla" only)."""
    state = init_state(problem, a, b, rhs, mask=mask,
                       storage_dtype=storage_dtype)
    state, _ = advance(problem, a, b, rhs, state, mask=mask, stencil=stencil,
                       chunk=chunk, storage_dtype=storage_dtype)
    return result_of(state)


def batched_operands(problem: Problem, lanes: int, dtype=torch.float32,
                     device=None, eps_values=None, geometry=None,
                     theta=None):
    """(a, b, rhs) for a ``lanes``-wide batch of this problem on ``device``
    (cuda unless ``device='cpu'``), from the f64 host assembly.

    With ``eps_values`` (one a lane) each lane gets its own ε and so its own
    (B, g1, g2) coefficients; otherwise a and b are (g1, g2), shared. The
    RHS is the problem's, tiled over the lanes and materialised on the
    host: the kernels take contiguous lanes, and a stride-0 view could not
    be updated in place.
    """
    if geometry is not None or theta is not None:
        raise unported("geometry=", "Queue A item 11")
    dev = resolve_device(device)
    if eps_values is not None:
        if len(eps_values) != lanes:
            raise ValueError(
                f"eps_values has {len(eps_values)} entries for {lanes} lanes"
            )
        abrs = [assembly.assemble_numpy(dataclasses.replace(problem, eps=eps))
                for eps in eps_values]
        return tuple(assembly.to_device(np.stack([x[i] for x in abrs]),
                                        dtype, dev) for i in range(3))
    a, b, rhs = assembly.assemble_numpy(problem)
    return (assembly.to_device(a, dtype, dev),
            assembly.to_device(b, dtype, dev),
            assembly.to_device(np.broadcast_to(rhs, (lanes,) + rhs.shape),
                               dtype, dev))
