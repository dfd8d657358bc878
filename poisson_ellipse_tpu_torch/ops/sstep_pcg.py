"""s-step PCG: s iterations per basis build and Gram reduction.

The counterpart of ``poisson_ellipse_tpu.ops.sstep_pcg``. One body

1. rebuilds r = rhs − A·x when its s iterations contain a multiple of
   the replacement cadence (the host decides, from the iteration the body
   starts at);
2. builds the ρ-scaled monomial basis of Â = D⁻¹A,
       V = [p, Âp/ρ, …, Âˢp/ρˢ,  z, Âz/ρ, …, Âˢ⁻¹z/ρˢ⁻¹]   (K = 2s+1),
   with z = D⁻¹r and ρ = ``BASIS_SCALE``;
3. forms the Gram matrices Gm = h₁h₂·VᵀDV and Ge = VᵀV, accumulated in
   f64 (``gram_dtype``), with ``einsum``;
4. runs s masked CG iterations in coordinates (``sstep_inner``), where Â
   is the shift matrix (``shift_matrix``);
5. reconstructs x, p and z = D⁻¹r against V (``tensordot``), r = D·z.

The Gram and the reconstruction are plain PyTorch calls, as the JAX
package leaves them to XLA. ``"pallas"`` runs the basis chain's stencil
through K-a (``hopper_kernels.apply_a_kernel``).

The carry is the classical one (``solver.pcg.PCGState``). A limit inside
a block stops at exactly that iteration: ``sstep_inner`` masks its steps
at ``limit``, and the next call re-anchors the basis there (so a chunked
run matches a straight one in its iteration count, not bitwise, as in the
JAX engine). A body the host issues after the loop has exited changes no
field: its outputs are masked by whether the loop was active when it
started.
"""

from __future__ import annotations

import numpy as np
import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.ops.pipelined_pcg import REPLACE_EVERY
from poisson_ellipse_tpu_torch.ops.stencil import apply_dinv, diag_d, spacing
from poisson_ellipse_tpu_torch.solver.pcg import (
    DEFAULT_CHUNK,
    DENOM_GUARD,
    PCGResult,
    PCGState,
    init_state as _classical_init,
    reject_unported,
    result_of,
    run_chunked,
    stencil_fn,
)
from poisson_ellipse_tpu_torch.utils.device import resolve_device

# block sizes: both divide the replacement cadence
SSTEP_CHOICES = (2, 4)
DEFAULT_S = 4

# each stored basis vector is Âʲv/ρʲ; Gershgorin bounds λmax(D⁻¹A) ≤ 2
BASIS_SCALE = 2.0


def basis_size(s: int) -> int:
    """K = 2s+1: s+1 powers of the direction, s of the residual."""
    return 2 * s + 1


def gram_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    """The Gram accumulation dtype: f64 for any compute dtype narrower
    than 8 bytes (the JAX engine's choice under x64: an f32 Gram loses the
    digits the s = 4 recurrence needs near convergence, 773 iterations
    against 546 at 400×600 there)."""
    if torch.empty((), dtype=compute_dtype).element_size() < 8:
        return torch.float64
    return compute_dtype


def shift_matrix(s: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The K×K matrix B with coords(Â·v) = B·coords(v) for every vector
    the inner iterations produce: the ρ-scaled basis shifts each power to
    the next with weight ρ (p-part indices 0…s, z-part s+1…2s)."""
    K = basis_size(s)
    B = np.zeros((K, K))
    for i in range(s):
        B[i + 1, i] = BASIS_SCALE
    for i in range(s - 1):
        B[s + 2 + i, s + 1 + i] = BASIS_SCALE
    return torch.tensor(B, dtype=dtype, device=device)


def init_state(problem: Problem, a, b, rhs, storage_dtype=None) -> PCGState:
    """The s-step carry at iteration 0: exactly the classical carry."""
    return _classical_init(problem, a, b, rhs, storage_dtype=storage_dtype)


def sstep_inner(Gm, Ge, Bm, s: int, k, limit, delta, hw, weighted: bool,
                diff0, conv0, bd0, dtype):
    """The s masked CG iterations in K-dimensional coordinates.

    Small tensors only (the K×K Grams, K-vectors, 0-dim scalars), on the
    Grams' device: nothing here reduces over the grid. Returns
    (k, x_c, z_c, p_c, zr, diff, converged, breakdown) with the classical
    per-iteration semantics, masked, so an exit or ``limit`` inside the
    block freezes the remaining steps.
    """
    K = Gm.shape[0]
    iz = s + 1
    dev = Gm.device
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    x_c = torch.zeros((K,), dtype=dtype, device=dev)
    z_c = torch.zeros((K,), dtype=dtype, device=dev)
    z_c[iz] = 1.0
    p_c = torch.zeros((K,), dtype=dtype, device=dev)
    p_c[0] = 1.0
    # (z, r) = zᵀDz = Gm[z₀, z₀]
    zr = Gm[iz, iz]
    conv, bd, diff = conv0, bd0, diff0
    for _ in range(s):
        active = ~conv & ~bd & (k < limit)
        ap_c = Bm @ p_c
        denom = p_c @ (Gm @ ap_c)
        guard = denom < DENOM_GUARD
        bd_fire = active & guard
        alpha = zr / torch.where(guard, one, denom)
        x_n = x_c + alpha * p_c
        z_n = z_c - alpha * ap_c
        zr_n = z_n @ (Gm @ z_n)
        # Ge is PSD up to round-off: a −ε quadratic form must not give NaN
        dw2 = alpha * alpha * torch.maximum(p_c @ (Ge @ p_c), zero)
        diff_n = torch.sqrt(dw2 * hw) if weighted else torch.sqrt(dw2)
        conv_n = diff_n < delta
        beta = zr_n / torch.where(zr == 0.0, one, zr)
        p_n = z_n + beta * p_c
        upd = active & ~bd_fire
        k = k + active.to(k.dtype)
        x_c = torch.where(upd, x_n, x_c)
        z_c = torch.where(upd, z_n, z_c)
        diff = torch.where(upd, diff_n, diff)
        adv = upd & ~conv_n
        p_c = torch.where(adv, p_n, p_c)
        zr = torch.where(adv, zr_n, zr)
        conv = conv | (upd & conv_n)
        bd = bd | bd_fire
    return k, x_c, z_c, p_c, zr, diff, conv, bd


def replaces(k: int, s: int, cadence: int = REPLACE_EVERY) -> bool:
    """Whether the block of s iterations starting at ``k`` contains a
    multiple of the replacement cadence (so it rebuilds r). Phrased as
    containment: a limit inside a block moves later block starts off the
    multiples of s."""
    km = k % cadence
    return k > 0 and (km == 0 or km > cadence - s)


def make_body(problem: Problem, a, b, rhs, limit: int, s: int = DEFAULT_S,
              stencil: str = "xla"):
    """One s-step block as ``body(state, k)``, ``k`` being the iteration
    the host expects the block to start at."""
    if s not in SSTEP_CHOICES:
        raise ValueError(f"s must be one of {SSTEP_CHOICES}, got {s}")
    dtype = rhs.dtype
    h1, h2 = spacing(problem.h1, rhs), spacing(problem.h2, rhs)
    hw = h1 * h2
    delta = spacing(problem.delta, rhs)
    weighted = problem.norm == "weighted"
    d = diag_d(a, b, h1, h2)
    apply_stencil = stencil_fn(problem, a, b, h1, h2, stencil)

    def dinv(v):
        return apply_dinv(v, d)

    def ahat(v):
        return dinv(apply_stencil(v))

    gd = gram_dtype(dtype)
    Bm = shift_matrix(s, gd, rhs.device)
    scale = spacing(1.0 / BASIS_SCALE, rhs)
    d_g = d.to(gd)
    hw_g, delta_g = hw.to(gd), delta.to(gd)

    def body(st: PCGState, k: int) -> PCGState:
        active = (st.k < limit) & ~st.converged & ~st.breakdown
        r = rhs - apply_stencil(st.w) if replaces(k, s) else st.r

        # the basis: one stencil chain, no reductions
        z = dinv(r)
        vs = [st.p]
        for _ in range(s):
            vs.append(ahat(vs[-1]) * scale)
        zs = [z]
        for _ in range(s - 1):
            zs.append(ahat(zs[-1]) * scale)
        V = torch.stack(vs + zs)  # (K, M+1, N+1)
        del vs, zs

        # the block's one reduction: both Grams, accumulated in f64
        Vg = V.to(gd)
        Gm = torch.einsum("kij,lij->kl", Vg, Vg * d_g) * hw_g
        Ge = torch.einsum("kij,lij->kl", Vg, Vg)
        del Vg

        k_n, x_c, z_c, p_c, zr_n, diff_n, conv_n, bd_n = sstep_inner(
            Gm, Ge, Bm, s, st.k, limit, delta_g, hw_g, weighted,
            st.diff.to(gd), st.converged, st.breakdown, gd,
        )
        x_c, z_c, p_c = x_c.to(dtype), z_c.to(dtype), p_c.to(dtype)

        # reconstruct against the basis; r = D·z exactly
        x_new = st.w + torch.tensordot(x_c, V, dims=1)
        r_new = d * torch.tensordot(z_c, V, dims=1)
        p_new = torch.tensordot(p_c, V, dims=1)

        # a body issued after the loop has exited changes nothing
        def keep(old, new):
            return torch.where(active, new, old)

        return PCGState(
            k=k_n,
            w=keep(st.w, x_new),
            r=keep(st.r, r_new),
            p=keep(st.p, p_new),
            zr=keep(st.zr, zr_n.to(dtype)),
            diff=keep(st.diff, diff_n.to(dtype)),
            converged=conv_n,
            breakdown=bd_n,
        )

    return body


def advance(problem: Problem, a, b, rhs, state: PCGState, s: int = DEFAULT_S,
            limit=None, stencil: str = "xla", chunk: int = DEFAULT_CHUNK,
            storage_dtype=None):
    """Advance the s-step carry until convergence/breakdown or iteration
    ``limit`` (default ``max_iterations``), honoured exactly. Returns (new
    carry, host reads): one read per ``chunk`` iterations, issued as
    bodies of s."""
    reject_unported(storage_dtype=storage_dtype)
    cap = problem.max_iterations
    limit = cap if limit is None else min(int(limit), cap)
    body = make_body(problem, a, b, rhs, limit, s, stencil)
    carry = [state]

    def step(k: int):
        carry[0] = body(carry[0], k)

    def flags():
        st = carry[0]
        return torch.stack([st.k, st.converged.to(st.k.dtype),
                            st.breakdown.to(st.k.dtype)])

    syncs = run_chunked(step, flags, limit, chunk, per_body=s)
    return carry[0], syncs


def pcg_sstep(problem: Problem, a, b, rhs, s: int = DEFAULT_S,
              stencil: str = "xla", chunk: int = DEFAULT_CHUNK,
              storage_dtype=None) -> PCGResult:
    """Run s-step PCG on pre-assembled (M+1, N+1) tensors on their device.
    stencil: "xla" (plain PyTorch) or "pallas" (K-a in the basis chain;
    f32)."""
    reject_unported(storage_dtype=storage_dtype)
    state = init_state(problem, a, b, rhs)
    state, _ = advance(problem, a, b, rhs, state, s=s, stencil=stencil,
                       chunk=chunk)
    return result_of(state)


def solve(problem: Problem, dtype: torch.dtype = torch.float32,
          s: int = DEFAULT_S, stencil: str = "xla", device=None,
          chunk: int = DEFAULT_CHUNK, storage_dtype=None) -> PCGResult:
    """Assemble and solve on one device (cuda unless ``device='cpu'``)
    with the s-step recurrence."""
    reject_unported(storage_dtype=storage_dtype)
    dev = resolve_device(device)
    a, b, rhs = assembly.assemble(problem, dtype, dev)
    return pcg_sstep(problem, a, b, rhs, s=s, stencil=stencil, chunk=chunk)
