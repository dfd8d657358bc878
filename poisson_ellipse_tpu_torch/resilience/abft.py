"""Algorithm-based fault tolerance: silent corruption caught inside the
mesh's loops.

The port's own copy of ``poisson_ellipse_tpu.resilience.abft``. A flipped
word in memory or a corrupted halo exchange changes the iterate and
nothing else, and CG would converge its stopping rule on the wrong
answer. The mesh's loops hold three algebraic identities that corruption
breaks and round-off does not:

- **the stencil checksum** (Huang and Abraham): with c = A·1, the masked
  row sums (one stencil call a dispatch, outside the loop), every
  iteration has Σ(A·p) = Σ(c∘p), which a halo the owner never sent breaks;
- **sum recurrences on the carry**: Σr⁺ = Σr − α·Σ(Ap), Σw⁺ = Σw + α·Σp
  and Σp⁺ = Σz + β·Σp, one scalar shadow a vector, re-anchored every
  iteration to the reduced sum, so a flip between two iterations shows at
  the next reduction;
- **(z, r) > 0**: an energy product, positive until convergence; a
  sign-flipped reduction (``psum_corrupt``) breaks it at once.

Every partial these checks need rides a reduction the loop already makes
(``parallel.pcg_sharded``, ``pipelined_sharded``, ``sstep_sharded``), so a
body's collectives are those of the plain loop. The carry gains four
scalars in the JAX package's order, addressed by JAX's index constants
(``SR, SW, SP_PRED, SDC``): ``ABFTState`` for the classical and s-step
carries (the pipelined carry's lagged tail lives with its recurrence,
``pipelined_sharded.PIPE_*``).

Detection model: a corruption is flagged when its drift passes ``rtol``
of the field's 1-norm (a high exponent or sign bit, NaN patterns, a
corrupted slab); a low-mantissa flip sits below the round-off floor and is
absorbed, and the guard's final true-residual gate validates what is
returned. The port adds each rank's partials in double and rounds once
(``parallel.mesh.Mesh.reduce``), so JAX's f32 band (set for pairwise f32
sums) has more room here. A flagged chunk is rolled back and re-run
(``resilience.guard``), never restarted from its iterate; a flag that
fires again from a clean carry raises ``SilentCorruptionError`` (exit 6).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# the ABFT shadow scalars' places in the extended classical carry:
# (k, w, r, p, zr, diff, converged, breakdown, S_r, S_w, S_p_pred, sdc)
SR, SW, SP_PRED, SDC = 8, 9, 10, 11
N_ABFT_SCALARS = 4

# the drift tolerance by item size: two orders and more above the round-off
# of a reduction at that width; bf16 and f16 share a band
_RTOL_BY_ITEMSIZE = {2: 3e-2, 4: 1e-3, 8: 1e-8}

# the floor of a relative scale, |drift| <= rtol·(scale + ABFT_TINY), so an
# all-zero field (converged, padding) divides by nothing
ABFT_TINY = 1e-30


class ABFTState(NamedTuple):
    """The classical (and s-step) carry with the four shadow scalars: the
    eight fields of ``solver.pcg.PCGState``, then S_r, S_w (Σx on the
    s-step mesh), the predicted Σp and the sticky corruption flag."""

    k: torch.Tensor
    w: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    zr: torch.Tensor
    diff: torch.Tensor
    converged: torch.Tensor
    breakdown: torch.Tensor
    s_r: torch.Tensor
    s_w: torch.Tensor
    s_p_pred: torch.Tensor
    sdc: torch.Tensor


def abft_rtol(dtype) -> float:
    """The relative drift tolerance of the checks at ``dtype``."""
    return _RTOL_BY_ITEMSIZE[dtype.itemsize]


def abft_dummy_tail(like: torch.Tensor) -> tuple:
    """Placeholder shadow scalars for a converted or restored carry, at
    ``like``'s dtype and device: every conversion is followed by a recover
    that re-anchors them; shadow sums never cross a layout change."""
    zero = torch.zeros((), dtype=like.dtype, device=like.device)
    return (zero, zero, zero,
            torch.zeros((), dtype=torch.bool, device=like.device))


def with_tail(state, tail) -> ABFTState:
    """The 8-field carry ``state`` extended by ``tail``."""
    return ABFTState(*tuple(state)[:8], *tail)


def checksum_field(stencil, interior_mask: torch.Tensor) -> torch.Tensor:
    """c = A·1 for this rank's block, through the loop's own masked stencil
    (its halo exchange included), so Σ(A·p) = Σ(c∘p) holds for exactly the
    operator the loop runs. One call a dispatch, outside the loop."""
    return stencil(interior_mask)


def drift_ok(got, want, scale, rtol) -> torch.Tensor:
    """|got − want| <= rtol·(scale + ABFT_TINY): False for a NaN drift."""
    return torch.abs(got - want) <= rtol * (scale + ABFT_TINY)


def plain_sums(*arrays) -> torch.Tensor:
    """Σx of each array, each in double: one reduction an array, reading
    it once (no stacked copy)."""
    return torch.stack([x.sum(dtype=torch.float64) for x in arrays])


def classical_partials(ap, r, w, p, c, z) -> torch.Tensor:
    """The classical body's ten ABFT partials in double, in the order
    ``ClassicalChecks`` reads them: Σap, Σr, Σw, Σp, Σc·p, Σz, then
    Σ|ap|, Σ|r|, Σ|w|, Σ|p|. One stack and two reductions (the mesh's
    loop is paced by its launches, not by these passes)."""
    stacked = torch.stack([ap, r, w, p, c * p, z])
    return torch.cat([
        stacked.sum(dim=(1, 2), dtype=torch.float64),
        torch.linalg.vector_norm(stacked[:4], 1, dim=(1, 2),
                                 dtype=torch.float64)])


class ClassicalChecks:
    """The classical body's four drift checks (the JAX package's
    ``ok_stencil``, ``ok_r``, ``ok_w``, ``ok_p``) as one small linear map.

    With v = [Σz·r, Σ(Δw)², the ten partials of ``classical_partials``,
    S_r, S_w, S_p_pred, 1], ``M @ v`` gives each check's drift as
    base − α·coef and its bound as base + |α|·coef (the bound already
    times rtol, with rtol·ABFT_TINY from the constant 1), so the checks of
    a body take a few launches in place of a few dozen; a NaN anywhere
    reads as a violation."""

    def __init__(self, dtype, device):
        rtol = abft_rtol(dtype)
        m = torch.zeros((16, 16), dtype=torch.float64)
        # v: 0 zr, 1 dw2, 2 Σap, 3 Σr, 4 Σw, 5 Σp, 6 Σc·p, 7 Σz, 8 Σ|ap|,
        # 9 Σ|r|, 10 Σ|w|, 11 Σ|p|, 12 S_r, 13 S_w, 14 S_p_pred, 15 one
        for row, (plus, minus) in enumerate(((2, 6), (3, 12), (4, 13),
                                             (5, 14))):
            m[row, plus], m[row, minus] = 1.0, -1.0
        m[5, 2] = -1.0      # Σr⁺ = S_r − α·Σap
        m[6, 5] = 1.0       # Σw⁺ = S_w + α·Σp
        for row, scale in zip(range(8, 12), (8, 9, 10, 11)):
            m[row, scale], m[row, 15] = rtol, rtol * ABFT_TINY
        m[13, 8] = rtol     # |α|·Σ|ap| in the r check's bound
        m[14, 11] = rtol    # |α|·Σ|p| in the w check's bound
        self.m = m.to(dtype=dtype, device=device)
        self.one = torch.ones(1, dtype=dtype, device=device)

    def __call__(self, sums, tail, alpha, zr):
        """Whether every check holds (and (z, r) > 0), from the body's
        reduced ``sums`` (its twelve) and the carried ``tail``
        (S_r, S_w, S_p_pred)."""
        v = torch.cat([sums, *(t.reshape(1) for t in tail), self.one])
        a = self.m @ v
        drift = a[:4] - alpha * a[4:8]
        bound = a[8:12] + torch.abs(alpha) * a[12:]
        return (torch.abs(drift) <= bound).all() & (zr > 0)


def plain_and_abs_sums(*arrays) -> torch.Tensor:
    """[Σx₀, Σ|x₀|, Σx₁, Σ|x₁|, …] in double: the partials the checks
    compare against their predictions and the scales of those
    predictions, two reductions an array and no intermediate array."""
    return torch.stack([s for x in arrays for s in (
        x.sum(dtype=torch.float64),
        torch.linalg.vector_norm(x, 1, dtype=torch.float64))])
