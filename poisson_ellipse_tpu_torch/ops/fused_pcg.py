"""Fused-iteration PCG: the whole loop body as two CUDA kernels.

The counterpart of ``poisson_ellipse_tpu.ops.fused_pcg``. One iteration:

  K1  p = z + beta*p;  ap = A(p);  denominator and α    (csrc K-b)
  K2  w += α p;  r −= α ap;  z = r·(1/D);  (z,r), ‖Δw‖², β, diff,
      k and the exit flags                               (csrc K-c)

The loop is rotated as in the JAX engine: β is applied at the start of
the next body, which gives the reference's value sequence. The stencil
runs in normalised form ap = d*p − (an*p↑ + as*p↓ + bw*p← + be*p→) with
the neighbour coefficients pre-divided by h² and masked to the interior,
and the preconditioner multiplies by a precomputed guarded 1/D. The
operands are computed in f64 on the host and rounded once
(``fused_operands``), the oracle-exact operand set.

Where the TPU engine ends each iteration with an XLA scalar fusion, here
the scalar tail runs in the last block of each kernel, on a carry kept in
device memory (``scal`` and ``flags`` below), so an iteration is two
launches with no host round trip; the host reads the flags once per chunk
(``solver.pcg.run_chunked``). Once the loop has exited both kernels return
without writing, so extra bodies in the last chunk change nothing.

Arrays are the unpadded (M+1, N+1) node grid: the TPU's (row-tile, 128)
padding is gone (``interop.fused_operands_from_reference`` strips it from
the JAX operand set).

Each wrapper (``k1``, ``k2``) runs its plain PyTorch version (``k1_plain``,
``k2_plain``) only for CPU tensors; for CUDA tensors it launches the
kernel or raises.

The loop runs at f32 or bf16 (``DTYPES``), as the JAX K1/K2 run at the
solve's dtype: every value is computed in float and rounded to bf16 where
it is stored, in the kernels and in the plain versions alike
(``whole_solve.rounder``). The bf16 form's sums are taken in double and
rounded through float (``grid_sum``); the f32 form sums in float, as
before. K1's bf16 form marches two nodes a lane, one 4-byte word of each
array (csrc/pn_march.cuh), so its wrapper refuses an array that does not
start on a 4-byte boundary; its launch shape comes from the grid's shape
alone (``partials_count`` mirrors it on the host).

``history=True`` records each iteration into the ring of
``obs.convergence`` after K2, from the carry the kernels leave: zr, diff
and α (K1's guarded α, 0 on a breakdown) from ``scal``, β from ``scal``
too but for a breakdown iteration, whose held β the JAX engine replaces
by its raw zr_new / 1 (here the held zr: α = 0 leaves r and z, so K2's
sum gives the held zr back). The column is the iteration the host issues
the body as; the body ran an iteration iff K2 advanced ``flags[FLAG_K]``
past it, and a body after the exit keeps the column (zero). No kernel
changes, and no host read.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.obs.convergence import history_record
from poisson_ellipse_tpu_torch.ops import _build, assembly
from poisson_ellipse_tpu_torch.ops import whole_solve as ws
from poisson_ellipse_tpu_torch.ops.stencil import spacing
from poisson_ellipse_tpu_torch.solver.pcg import (
    DEFAULT_CHUNK,
    DENOM_GUARD,
    PCGResult,
    Solver,
    new_ring,
    run_chunked,
    with_history,
)
from poisson_ellipse_tpu_torch.utils.device import resolve_device

LIBRARY = "fused_pcg"
K1 = "fused_k1"
K2 = "fused_k2"

# the kernels' forms: run dtype → the launchers' suffix
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

# the device-resident scalar carry; csrc/fused_pcg.cu holds the same layout
SCAL_ZR, SCAL_BETA, SCAL_DIFF, SCAL_DENOM, SCAL_ALPHA = range(5)
N_SCAL = 5
(FLAG_K, FLAG_CONVERGED, FLAG_BREAKDOWN, FLAG_PENDING_BREAKDOWN,
 FLAG_TICKET_K1, FLAG_TICKET_K2) = range(6)
N_FLAGS = 6


def normalized_unmasked(problem: Problem, a, b):
    """(an, bw) = (a/h1², b/h2²) over the full grid, unmasked, in the
    input precision."""
    ih1 = 1.0 / (float(problem.h1) * float(problem.h1))
    ih2 = 1.0 / (float(problem.h2) * float(problem.h2))
    return a * ih1, b * ih2


def interior_normalized(problem: Problem, a, b):
    """(an, as_, bw, be, d, dinv) in the input precision (numpy or torch):
      an_ij = a_ij / h1²        (multiplies p_{i-1,j})
      as_ij = a_{i+1,j} / h1²   (multiplies p_{i+1,j})
      bw_ij = b_ij / h2²        (multiplies p_{i,j-1})
      be_ij = b_{i,j+1} / h2²   (multiplies p_{i,j+1})
      d     = an + as_ + bw + be;  dinv = 1/d where d != 0 else 0
    all masked to the interior 1..M-1 × 1..N-1."""
    is_np = isinstance(a, np.ndarray)
    g1, g2 = a.shape
    an, bw = normalized_unmasked(problem, a, b)
    if is_np:
        as_ = np.roll(an, -1, axis=0)
        be = np.roll(bw, -1, axis=1)
        gi = np.arange(g1)[:, None]
        gj = np.arange(g2)[None, :]
        zero = np.zeros((), an.dtype)
        where = np.where
    else:
        as_ = torch.roll(an, -1, dims=0)
        be = torch.roll(bw, -1, dims=1)
        gi = torch.arange(g1, device=a.device)[:, None]
        gj = torch.arange(g2, device=a.device)[None, :]
        zero = torch.zeros((), dtype=an.dtype, device=an.device)
        where = torch.where
    interior = (gi >= 1) & (gi <= problem.M - 1) & (gj >= 1) & (gj <= problem.N - 1)
    an, as_, bw, be = (where(interior, x, zero) for x in (an, as_, bw, be))
    d = an + as_ + bw + be
    nonzero = d != 0.0
    one = np.ones((), d.dtype) if is_np else torch.ones_like(zero)
    dinv = where(nonzero, one / where(nonzero, d, one), zero)
    return an, as_, bw, be, d, dinv


def normalized_coefficients(problem: Problem, a, b, dtype=None,
                            device=None):
    """The loop-invariant operand set (an, as_, bw, be, d, dinv) as device
    tensors, computed in the inputs' precision and then cast to ``dtype``.
    Pass f64 numpy a/b (``assembly.assemble_numpy``) to get coefficients
    rounded once from the reference's double-precision values."""
    pieces = interior_normalized(problem, a, b)
    if isinstance(a, np.ndarray):
        dev = resolve_device(device)
        return tuple(assembly.to_device(x, dtype or torch.float32, dev)
                     for x in pieces)
    return tuple(x.to(dtype or a.dtype) for x in pieces)


def fused_operands(problem: Problem, dtype=torch.float32, device=None):
    """Device-ready operands rounded once from the f64 host assembly."""
    a64, b64, _ = assembly.assemble_numpy(problem)
    return normalized_coefficients(problem, a64, b64, dtype, device)


@dataclasses.dataclass
class FusedCarry:
    """The rotated loop's state. ``w``, ``r``, ``z`` are updated in place by
    K2; K1 of body i reads ``p[i % 2]`` and writes ``p[(i + 1) % 2]``
    (its halo reads neighbours of p, so it cannot write p in place)."""

    w: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: list
    ap: torch.Tensor
    scal: torch.Tensor      # (N_SCAL,) in the run dtype
    flags: torch.Tensor     # (N_FLAGS,) int32
    partials: torch.Tensor  # the kernels' per-block sums (empty on the CPU)


# K1's timing instantiation (csrc/fused_pcg.cu Part), which no engine
# launches: the kernel whole, its tile pass with each block's own sum but
# no cross-block sum, and the cross-block sum with the scalar tail alone
PARTS = {"whole": 0, "tile": 1, "tail": 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_K1_ARGS = [_P] * 12 + [_I] * 3 + [_F, _F, _P]
_SIGNATURES = {
    **{f"pe_fused_scratch_len_{form}": (_I, [_I, _I])
       for form in DTYPES.values()},
    **{f"pe_fused_k1_{form}": (_I, _K1_ARGS) for form in DTYPES.values()},
    **{f"pe_fused_k1_part_{form}": (_I, [_I] + _K1_ARGS)
       for form in DTYPES.values()},
    **{f"pe_fused_k2_{form}": (_I, [_P] * 9 + [_I] * 3 + [_F, _F, _F, _I, _P])
       for form in DTYPES.values()},
    "pe_fused_error_string": (ctypes.c_char_p, [_I]),
}


def grid_sum(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Σx (x held in f32) as the kernels of the ``dtype`` form take it:
    in float for f32; in double, rounded to float, for bf16 (the caller
    rounds it on to bf16 where it is stored)."""
    if dtype == torch.float32:
        return torch.sum(x)
    return torch.sum(x, dtype=torch.float64).float()


def partials_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulator the kernels keep their per-block sums in."""
    return torch.float32 if dtype == torch.float32 else torch.float64


@functools.lru_cache(maxsize=16)
def scratch_len(g1: int, g2: int, dtype: torch.dtype = torch.float32) -> int:
    """Per-block partial sums one solve of the ``dtype`` form needs at
    (g1, g2) on the card (``pe_fused_scratch_len_<form>``;
    ``partials_count`` computes the same on the host)."""
    lib = _build.load(LIBRARY, _SIGNATURES)
    return int(getattr(lib, f"pe_fused_scratch_len_{DTYPES[dtype]}")(g1, g2))


# the kernels' launch shapes (csrc/fused_pcg.cu): K1 f32's 32x32 tiles;
# K1 bf16's march, a warp a strip of 64 columns over march_rows rows, 8
# warps a block, 16 rows or as few as 4 to give 132 blocks; K2's 256-thread
# blocks, at most 1024
K1_TILE = 32
MARCH_STRIP, MARCH_WARPS = 64, 8
MARCH_MAX_ROWS, MARCH_MIN_ROWS, MARCH_FILL_BLOCKS = 16, 4, 132
K2_THREADS, K2_MAX_BLOCKS = 256, 1024


def march_strips(g2: int) -> int:
    """K1 bf16's strips a row: a row's ceil(g2 / 2) two-column words (in
    either frame, csrc/pn_march.cuh), 32 a strip."""
    words = (g2 + 1) // 2
    return -(-words // (MARCH_STRIP // 2))


def march_rows(g1: int, g2: int) -> int:
    """The rows a warp of K1 bf16 marches: MARCH_MAX_ROWS, halved (down to
    MARCH_MIN_ROWS) while its units would fill fewer than
    MARCH_FILL_BLOCKS blocks."""
    rows = MARCH_MAX_ROWS
    while (rows > MARCH_MIN_ROWS and march_strips(g2) * -(-g1 // rows)
           < MARCH_FILL_BLOCKS * MARCH_WARPS):
        rows //= 2
    return rows


def k1_blocks(g1: int, g2: int, dtype: torch.dtype) -> int:
    """K1's blocks at (g1, g2), its partials: f32 one a 32x32 tile; bf16
    one a row of MARCH_WARPS units, a unit a strip over march_rows rows,
    numbered row tile by row tile."""
    if dtype == torch.float32:
        return -(-g1 // K1_TILE) * -(-g2 // K1_TILE)
    units = march_strips(g2) * -(-g1 // march_rows(g1, g2))
    return -(-units // MARCH_WARPS)


def partials_count(g1: int, g2: int, dtype: torch.dtype) -> int:
    """The partials scratch of the ``dtype`` form at (g1, g2), from the
    grid's shape alone, as ``pe_fused_scratch_len_<form>`` counts it:
    K1's blocks or two a K2 block, whichever is more."""
    k2 = 2 * min(-(-g1 * g2 // K2_THREADS), K2_MAX_BLOCKS)
    return max(k1_blocks(g1, g2, dtype), k2)


def rotated_state0(r0: torch.Tensor, z0: torch.Tensor,
                   zr0: torch.Tensor) -> FusedCarry:
    """Iteration-0 carry: w = 0, p = 0 and β = 0, so the first K1 gives
    p1 = z0, the reference's initial direction; diff = inf."""
    dtype, dev = r0.dtype, r0.device
    scal = torch.zeros(N_SCAL, dtype=dtype, device=dev)
    scal[SCAL_ZR] = zr0
    scal[SCAL_DIFF] = float("inf")
    n_partials = scratch_len(*r0.shape, dtype) if dev.type == "cuda" else 0
    return FusedCarry(
        w=torch.zeros_like(r0),
        r=r0.clone(),
        z=z0,
        p=[torch.zeros_like(r0), torch.empty_like(r0)],
        ap=torch.empty_like(r0),
        scal=scal,
        flags=torch.zeros(N_FLAGS, dtype=torch.int32, device=dev),
        partials=torch.empty(n_partials, dtype=partials_dtype(dtype),
                             device=dev),
    )


def _loop_active(flags: torch.Tensor, max_iter: int) -> bool:
    k, converged, breakdown = (int(v) for v in flags[:3].tolist())
    return not converged and not breakdown and k < max_iter


def k1_plain(z, p, an, as_, bw, be, d, pn, ap, scal, flags, partials, *,
             max_iter: int, h1: float, h2: float) -> None:
    """The plain version of K1: writes pn, ap, scal[DENOM], scal[ALPHA] and
    flags[PENDING_BREAKDOWN]; nothing once the loop has exited. Computed in
    f32, each stored value rounded to the run dtype (``ws.rounder``)."""
    if not _loop_active(flags, max_iter):
        return
    ct = z.dtype
    q = ws.rounder(ct)
    h1t, h2t = (ws.held(spacing(h, z)) for h in (h1, h2))
    z, p, an, as_, bw, be, d, s = (ws.held(x) for x in
                                   (z, p, an, as_, bw, be, d, scal))
    pn_new = q(z + s[SCAL_BETA] * p)
    ext = F.pad(pn_new, (1, 1, 1, 1))  # outside the grid pn is 0
    ap_new = q(d * pn_new - (
        an * ext[:-2, 1:-1]
        + as_ * ext[2:, 1:-1]
        + bw * ext[1:-1, :-2]
        + be * ext[1:-1, 2:]
    ))
    denom = q(q(grid_sum(ap_new * pn_new, ct)) * h1t * h2t)
    breakdown = ws.below_guard(denom, ct)
    alpha = ws.guarded_alpha(s[SCAL_ZR], denom, q, ct)
    pn.copy_(pn_new)
    ap.copy_(ap_new)
    scal[SCAL_DENOM] = denom
    scal[SCAL_ALPHA] = alpha
    flags[FLAG_PENDING_BREAKDOWN] = breakdown.to(flags.dtype)


def rotated_next_state(scal, flags, zr_new, dw2, h1t, h2t, delta,
                       weighted: bool, q) -> None:
    """The plain scalar tail of one rotated iteration, in place on the
    carry: convergence test, breakdown holds (zr, β, diff frozen, as the
    reference exits before touching them), the next β, k + 1. The
    scalars are held in f32 and rounded by ``q`` where they are stored."""
    breakdown = flags[FLAG_PENDING_BREAKDOWN].to(torch.bool)
    zr, beta, diff = (ws.held(scal[i]) for i in
                      (SCAL_ZR, SCAL_BETA, SCAL_DIFF))
    ndiff = q(torch.sqrt(dw2 * h1t * h2t) if weighted else torch.sqrt(dw2))
    converged = ~breakdown & (ndiff < delta)
    ndiff = torch.where(breakdown, diff, ndiff)
    beta_new = q(zr_new / torch.where(breakdown, torch.ones_like(zr), zr))
    scal[:3] = torch.stack([
        torch.where(breakdown, zr, zr_new),
        torch.where(breakdown, beta, beta_new),
        ndiff,
    ])
    flags[:3] = torch.stack([
        flags[FLAG_K] + 1,
        converged.to(flags.dtype),
        breakdown.to(flags.dtype),
    ])


def k2_plain(w, r, pn, ap, dinv, z, scal, flags, partials, *, max_iter: int,
             h1: float, h2: float, delta: float, weighted: bool) -> None:
    """The plain version of K2: updates w, r, z in place and runs the
    scalar tail; nothing once the loop has exited. Computed in f32, each
    stored value rounded to the run dtype (``ws.rounder``)."""
    if not _loop_active(flags, max_iter):
        return
    ct = w.dtype
    q = ws.rounder(ct)
    h1t, h2t, delta_t = (ws.held(spacing(x, w)) for x in (h1, h2, delta))
    w_old, r_old, pn_h, ap_h, dinv_h = (ws.held(x) for x in
                                         (w, r, pn, ap, dinv))
    alpha = ws.held(scal[SCAL_ALPHA])
    w_new = q(w_old + alpha * pn_h)
    r_new = q(r_old - alpha * ap_h)
    z_new = q(r_new * dinv_h)
    dw = w_new - w_old  # the realised increment, not α·p
    sums = torch.stack([q(grid_sum(z_new * r_new, ct)),
                        q(grid_sum(dw * dw, ct))])
    w.copy_(w_new)
    r.copy_(r_new)
    z.copy_(z_new)
    rotated_next_state(scal, flags, q(sums[0] * h1t * h2t), sums[1], h1t,
                       h2t, delta_t, weighted, q)


def _check(kernel: str, arrays: dict, scal, flags, partials) -> None:
    ref = next(iter(arrays.values()))
    if ref.dtype not in DTYPES:
        raise ValueError(f"{kernel}: the kernel is built for float32 and "
                         f"bfloat16, got {ref.dtype}")
    if ref.dim() != 2:
        raise ValueError(f"{kernel}: need 2-D arrays, got {tuple(ref.shape)}")
    for name, t in arrays.items():
        if (t.device != ref.device or t.dtype != ref.dtype
                or t.shape != ref.shape or not t.is_contiguous()):
            raise ValueError(
                f"{kernel}: {name} is {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()}); expected "
                f"contiguous {ref.dtype} {tuple(ref.shape)} on {ref.device}"
            )
    if (scal.shape != (N_SCAL,) or scal.dtype != ref.dtype
            or scal.device != ref.device):
        raise ValueError(f"{kernel}: scal must be ({N_SCAL},) {ref.dtype}")
    if (flags.shape != (N_FLAGS,) or flags.dtype != torch.int32
            or flags.device != ref.device):
        raise ValueError(f"{kernel}: flags must be ({N_FLAGS},) int32")
    need = scratch_len(*ref.shape, ref.dtype)
    if (partials.dtype != partials_dtype(ref.dtype)
            or partials.device != ref.device or partials.numel() < need):
        raise ValueError(f"{kernel}: partials scratch must be "
                         f"{partials_dtype(ref.dtype)}, of {need} at least")
    if (kernel == K1 and ref.dtype == torch.bfloat16
            and any(t.data_ptr() % 4 for t in arrays.values())):
        raise ValueError(f"{kernel}: the bf16 form loads and stores "
                         "aligned pairs of nodes; every array must start "
                         "at a multiple of 4 bytes")


def _launch_k1(name: str, lead: tuple, z, p, an, as_, bw, be, d, pn, ap,
               scal, flags, partials, max_iter: int, h1: float,
               h2: float) -> None:
    """Launch ``pe_fused_<name>_<form>`` with ``lead`` before K1's
    arguments, and count it under ``<name>``'s counter of the form."""
    arrays = dict(z=z, p=p, an=an, as_=as_, bw=bw, be=be, d=d, pn=pn, ap=ap)
    _check(K1, arrays, scal, flags, partials)
    lib = _build.load(LIBRARY, _SIGNATURES)
    g1, g2 = z.shape
    form = DTYPES[z.dtype]
    # h1, h2 as the plain version holds them, rounded to the run dtype on
    # the host (a device tensor's float() would sync every launch)
    rc = getattr(lib, f"pe_fused_{name}_{form}")(
        *lead, *(t.data_ptr() for t in arrays.values()), partials.data_ptr(),
        scal.data_ptr(), flags.data_ptr(), g1, g2, max_iter,
        ws.rounded(h1, z.dtype), ws.rounded(h2, z.dtype),
        _build.stream_handle(z.device),
    )
    _build.check(lib.pe_fused_error_string, f"fused_{name}", rc)
    _build.count_launch(ws.counter(f"fused_{name}", form))


def k1(z, p, an, as_, bw, be, d, pn, ap, scal, flags, partials, *,
       max_iter: int, h1: float, h2: float) -> None:
    """K1 (K-b): pn = z + βp, ap = A(pn), denominator and α, on the carry."""
    if z.device.type == "cpu":
        return k1_plain(z, p, an, as_, bw, be, d, pn, ap, scal, flags,
                        partials, max_iter=max_iter, h1=h1, h2=h2)
    _launch_k1("k1", (), z, p, an, as_, bw, be, d, pn, ap, scal, flags,
               partials, max_iter, h1, h2)


def k1_part(part: str, z, p, an, as_, bw, be, d, pn, ap, scal, flags,
            partials, *, max_iter: int, h1: float, h2: float) -> None:
    """K1's timing instantiation on the card (``PARTS``): "whole" is K1,
    "tile" its tile pass with each block's own sum but no cross-block sum
    (pn and ap as K1 writes them; no denominator), "tail" the cross-block
    sum and the scalar tail alone on zero partials. No engine launches
    it; counted as ``fused_k1_part``."""
    if z.device.type == "cpu":
        raise ValueError("k1_part: the timing instantiation runs only on "
                         "the card")
    _launch_k1("k1_part", (PARTS[part],), z, p, an, as_, bw, be, d, pn, ap,
               scal, flags, partials, max_iter, h1, h2)


def k2(w, r, pn, ap, dinv, z, scal, flags, partials, *, max_iter: int,
       h1: float, h2: float, delta: float, weighted: bool) -> None:
    """K2 (K-c): w, r, z updates, the two sums and the scalar tail."""
    if w.device.type == "cpu":
        return k2_plain(w, r, pn, ap, dinv, z, scal, flags, partials,
                        max_iter=max_iter, h1=h1, h2=h2, delta=delta,
                        weighted=weighted)
    arrays = dict(w=w, r=r, pn=pn, ap=ap, dinv=dinv, z=z)
    _check(K2, arrays, scal, flags, partials)
    lib = _build.load(LIBRARY, _SIGNATURES)
    g1, g2 = w.shape
    rc = getattr(lib, f"pe_fused_k2_{DTYPES[w.dtype]}")(
        *(t.data_ptr() for t in arrays.values()), partials.data_ptr(),
        scal.data_ptr(), flags.data_ptr(), g1, g2, max_iter,
        ws.rounded(h1, w.dtype), ws.rounded(h2, w.dtype),
        ws.rounded(delta, w.dtype), int(weighted),
        _build.stream_handle(w.device),
    )
    _build.check(lib.pe_fused_error_string, K2, rc)
    _build.count_launch(ws.counter(K2, DTYPES[w.dtype]))


def record(ring: torch.Tensor, k: int, scal: torch.Tensor,
           flags: torch.Tensor) -> None:
    """Record into ``ring`` the iteration ``k`` a body was issued as, from
    the carry K2 left (module docstring); nothing if the body ran none."""
    active = flags[FLAG_K] > k
    breakdown = flags[FLAG_BREAKDOWN] != 0
    beta = torch.where(breakdown, scal[SCAL_ZR], scal[SCAL_BETA])
    history_record(ring, k, active, scal[SCAL_ZR], scal[SCAL_DIFF],
                   scal[SCAL_ALPHA], beta)


def _run_fused(problem: Problem, coeffs, r0: torch.Tensor,
               chunk: int = DEFAULT_CHUNK, history: bool = False):
    """The rotated loop over prebuilt operands; returns (result, host
    reads), the result (PCGResult, ConvergenceTrace) with ``history``."""
    an, as_, bw, be, d, dinv = coeffs
    ct = r0.dtype
    q = ws.rounder(ct)
    h1t, h2t = (ws.held(spacing(h, r0)) for h in (problem.h1, problem.h2))
    z0 = q(ws.held(r0) * ws.held(dinv))
    zr0 = q(q(grid_sum(z0 * ws.held(r0), ct)) * h1t * h2t)
    carry = rotated_state0(r0, z0.to(ct), zr0.to(ct))
    limit = problem.max_iterations
    consts = dict(max_iter=limit, h1=problem.h1, h2=problem.h2)
    bodies = [0]
    ring = new_ring(problem, r0) if history else None

    def step(k):
        src = carry.p[bodies[0] % 2]
        dst = carry.p[(bodies[0] + 1) % 2]
        k1(carry.z, src, an, as_, bw, be, d, dst, carry.ap, carry.scal,
           carry.flags, carry.partials, **consts)
        k2(carry.w, carry.r, dst, carry.ap, dinv, carry.z, carry.scal,
           carry.flags, carry.partials, delta=problem.delta,
           weighted=problem.norm == "weighted", **consts)
        if ring is not None:
            record(ring, k, carry.scal, carry.flags)
        bodies[0] += 1

    syncs = run_chunked(step, lambda: carry.flags[:3], limit, chunk)
    result = PCGResult(
        w=carry.w,
        iters=carry.flags[FLAG_K],
        diff=carry.scal[SCAL_DIFF],
        converged=carry.flags[FLAG_CONVERGED].to(torch.bool),
        breakdown=carry.flags[FLAG_BREAKDOWN].to(torch.bool),
    )
    return with_history(result, ring), syncs


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in DTYPES:
        raise ValueError(f"the fused solver supports float32 and bfloat16, "
                         f"not {dtype}; use the xla engine for f64")


def pcg_fused(problem: Problem, a, b, rhs, chunk: int = DEFAULT_CHUNK,
              history: bool = False):
    """PCG with the fused two-kernel iteration on pre-assembled device
    tensors; the coefficient normalisation runs in their dtype (for the
    oracle-exact f64-rounded operands use ``build_fused_solver``).
    ``history=True`` returns (PCGResult, ConvergenceTrace)."""
    _check_dtype(rhs.dtype)
    coeffs = normalized_coefficients(problem, a, b)
    return _run_fused(problem, coeffs, rhs, chunk, history)[0]


def build_fused_solver(problem: Problem, dtype=torch.float32, device=None,
                       chunk: int = DEFAULT_CHUNK, history: bool = False):
    """(solver, args) with the f64-rounded operand set: args are
    (an, as_, bw, be, d, dinv, r0) on the device, and ``solver(*args)``
    may be called many times (returning (PCGResult, ConvergenceTrace)
    with ``history``)."""
    _check_dtype(dtype)
    dev = resolve_device(device)
    coeffs = fused_operands(problem, dtype, dev)
    _, _, rhs64 = assembly.assemble_numpy(problem)
    args = (*coeffs, assembly.to_device(rhs64, dtype, dev))
    solver = Solver(
        lambda an, as_, bw, be, d, dinv, r0: _run_fused(
            problem, (an, as_, bw, be, d, dinv), r0, chunk, history
        )
    )
    return solver, args


def solve_fused(problem: Problem, dtype=torch.float32, device=None,
                chunk: int = DEFAULT_CHUNK) -> PCGResult:
    """Assemble and solve with the fused iteration on one device."""
    solver, args = build_fused_solver(problem, dtype, device, chunk)
    return solver(*args)
