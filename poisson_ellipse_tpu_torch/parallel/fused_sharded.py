"""Fused-sharded PCG: the two-kernel iteration on every rank of the mesh.

The counterpart of ``poisson_ellipse_tpu.parallel.fused_sharded``, and the
heir of the reference stage 4's composition (a kernel per rank in the hot
loop, ringed by halo exchanges and scalar reductions,
``poisson_mpi_cuda2.cu:846-939``). One iteration on every rank:

  1 stacked halo exchange   (z, p) in one message a direction
  K1-shard  pn = z + βp; ap = A(pn); the rank's Σap·pn      (one launch)
  1 reduction               the denominator
  K2-shard  α; w += α·pn; r −= α·ap; z = r·(1/D);
            the rank's [Σz·r, Σ(Δw)²]                       (one launch)
  1 reduction               the pair, stacked
  the scalar tail           ``ops.fused_pcg.rotated_next_state`` on the
                            device carry

so 2 launches, 2 reductions and 1 halo exchange an iteration, as in the
JAX package (``fused_sharded.py:10-17`` there). The loop is rotated as on
one device (β is applied at the start of the next body), and its carry
(scal, flags) has the layout of ``ops.fused_pcg``. The tail runs on
device tensors, masked so that a body issued after the exit changes
nothing; the host reads the flags once per 64-iteration chunk.

The kernels (``csrc/fused_sharded.cu``): K1-shard runs the
``apply_a_block`` tree (each difference divided by h), which keeps its
count equal to the sharded ``xla`` loop's, on the exchanged
(bm+2, bn+2) windows of z, p, a and b; K2-shard is K-c's body without the
scalar tail. Each writes per-block partial sums in double, as many as its
form launches blocks (``partial_counts``); the rank adds them
(``torch.sum`` in double) and ``Mesh.reduce`` adds the ranks' in rank
order, rounded once to f32. Beside each kernel is its plain version
(``k1_plain``, ``k2_plain``); the launcher takes it only for CPU tensors
and otherwise launches the kernel or raises. K1-shard's bf16 form is the
vector-lane march of ``csrc/lane_march.cuh``: it loads aligned words, so
a, b, d, pn and ap must start on a 4-byte boundary (the windows z and p
may start on any element; the halo exchange's stack puts p mid-word
where (bm+2)(bn+2) is odd), and it indexes a window in 32 bits, about
2³¹ elements.

The loop runs at f32 or bf16, as the JAX K1/K2 run at the solve's dtype.
At bf16 the arrays and the scalar carry are bf16; every value is computed
in float on the widened operands and rounded once to bf16 where it is
stored (``ops.whole_solve.rounder``), in the kernels' bf16 forms and in
the plain versions alike: pn, ap, w, r, z, and the reduced sums (double,
then float, then bf16) before they are scaled by h1·h2 and rounded again,
as the single-device bf16 ``fused`` engine rounds them. Each term of a sum
is a product of two bf16 values, exact in float, added in double.

The TPU's (8·px, 128·py) tile padding (``padded_dims_fused`` there) has no
counterpart: the grid is padded to the mesh multiple (``padded_dims``).
Padded nodes are exact zeros, so the stripped w is the same. f64 raises as
in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import _build, assembly
from poisson_ellipse_tpu_torch.ops import whole_solve as ws
from poisson_ellipse_tpu_torch.ops.fused_pcg import (
    DTYPES,
    FLAG_BREAKDOWN,
    FLAG_CONVERGED,
    FLAG_K,
    FLAG_PENDING_BREAKDOWN,
    N_FLAGS,
    N_SCAL,
    SCAL_BETA,
    SCAL_DENOM,
    SCAL_DIFF,
    SCAL_ZR,
    interior_normalized,
    rotated_next_state,
)
from poisson_ellipse_tpu_torch.ops.stencil import apply_a_block, spacing
from poisson_ellipse_tpu_torch.parallel.halo import (
    halo_extend,
    halo_extend_stacked,
)
from poisson_ellipse_tpu_torch.parallel.mesh import Mesh, make_mesh, rank_sums
from poisson_ellipse_tpu_torch.parallel.pcg_sharded import (
    ShardedSolver,
    block_shape,
    rank_block,
)
from poisson_ellipse_tpu_torch.solver.pcg import (
    DEFAULT_CHUNK,
    PCGResult,
    run_chunked,
    unported,
)

LIBRARY = "fused_sharded"
K1 = "fused_sharded_k1"
K2 = "fused_sharded_k2"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    **{f"pe_fused_sharded_k{k}_blocks": (_I, [_I, _I]) for k in (1, 2)},
    "pe_fused_sharded_k1_bf16_blocks": (_I, [_I, _I]),
    # z, p, a, b, d, pn, ap, partials, scal, flags, bm, bn, max_iter, h1,
    # h2, stream
    **{f"pe_fused_sharded_k1_{form}": (_I, [_P] * 10 + [_I] * 3
                                       + [_F, _F, _P])
       for form in DTYPES.values()},
    # w, r, pn, ap, dinv, z, partials, scal, flags, bm, bn, max_iter, stream
    **{f"pe_fused_sharded_k2_{form}": (_I, [_P] * 9 + [_I] * 3 + [_P])
       for form in DTYPES.values()},
    "pe_fused_sharded_error_string": (ctypes.c_char_p, [_I]),
}


@functools.lru_cache(maxsize=16)
def partial_counts(bm: int, bn: int,
                   dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """(K1's, K2's) per-block partials for a (bm, bn) block on the card in
    the form of ``dtype``: K1's f32 form is a node a thread, its bf16 form
    the lane march, each with a grid of its own; K2's is either form's."""
    lib = _build.load(LIBRARY, _SIGNATURES)
    k1_blocks = (lib.pe_fused_sharded_k1_bf16_blocks
                 if dtype == torch.bfloat16 else lib.pe_fused_sharded_k1_blocks)
    return int(k1_blocks(bm, bn)), int(lib.pe_fused_sharded_k2_blocks(bm, bn))


def scratch(bm: int, bn: int, device,
            dtype: torch.dtype = torch.float32
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' partials buffers in double, zeroed, for the form of
    ``dtype``: (n1,) for K1 and (n2, 2) for K2; one row each for the plain
    versions on the CPU."""
    dev = torch.device(device)
    n1, n2 = partial_counts(bm, bn, dtype) if dev.type == "cuda" else (1, 1)
    return (torch.zeros(n1, dtype=torch.float64, device=dev),
            torch.zeros((n2, 2), dtype=torch.float64, device=dev))


def _loop_active(flags: torch.Tensor, max_iter: int) -> bool:
    k, converged, breakdown = (int(v) for v in flags[:3].tolist())
    return not converged and not breakdown and k < max_iter


def k1_plain(z_ext, p_ext, a_ext, b_ext, d, pn, ap, scal, flags, partials,
             *, max_iter: int, h1: float, h2: float) -> None:
    """The plain version of K1-shard: writes pn, ap and the rank's Σap·pn
    (in double, into ``partials[0]``); nothing once the loop has exited.
    Computed in float, pn and ap rounded to the run dtype
    (``ws.rounder``)."""
    if not _loop_active(flags, max_iter):
        return
    q = ws.rounder(z_ext.dtype)
    h1t, h2t = (ws.held(spacing(h, z_ext)) for h in (h1, h2))
    z, p, a, b = (ws.held(x) for x in (z_ext, p_ext, a_ext, b_ext))
    pn_w = q(z + ws.held(scal[SCAL_BETA]) * p)
    wc = pn_w[1:-1, 1:-1]
    ap_new = torch.where(d != 0.0, q(apply_a_block(pn_w, a, b, h1t, h2t)),
                         torch.zeros_like(wc))
    pn.copy_(wc)
    ap.copy_(ap_new)
    partials.zero_()
    partials[0] = torch.sum(ap_new * wc, dtype=torch.float64)


def k2_plain(w, r, pn, ap, dinv, z, scal, flags, partials, *,
             max_iter: int) -> None:
    """The plain version of K2-shard: α from (zr, denom) of the carry with
    the breakdown guard; w, r, z in place; the rank's [Σz·r, Σ(Δw)²] in
    double into ``partials[0]``; no scalar tail; nothing once the loop has
    exited. Computed in float, each stored value rounded to the run dtype
    (``ws.rounder``)."""
    if not _loop_active(flags, max_iter):
        return
    ct = w.dtype
    q = ws.rounder(ct)
    w_old, r_old, pn_h, ap_h, dinv_h = (ws.held(x) for x in
                                         (w, r, pn, ap, dinv))
    alpha = ws.guarded_alpha(ws.held(scal[SCAL_ZR]),
                             ws.held(scal[SCAL_DENOM]), q, ct)
    w_new = q(w_old + alpha * pn_h)
    r_new = q(r_old - alpha * ap_h)
    z_new = q(r_new * dinv_h)
    dw = w_new - w_old  # the realised increment, not α·pn
    sums = rank_sums((z_new, r_new), (dw, dw))
    w.copy_(w_new)
    r.copy_(r_new)
    z.copy_(z_new)
    partials.zero_()
    partials[0] = sums


def _check(kernel: str, arrays: dict, shape, scal, flags, partials,
           n_partials: int) -> None:
    """Raise unless every array is contiguous in the form's dtype (the
    first array's: float32 or bfloat16) at its ``shape(name)`` on scal's
    device, scal is (N_SCAL,) of that dtype, flags (N_FLAGS,) int32 and
    partials double of ``n_partials`` at least."""
    dev = scal.device
    dtype = next(iter(arrays.values())).dtype
    if dtype not in DTYPES:
        raise ValueError(f"{kernel}: the kernel is built for float32 and "
                         f"bfloat16, got {dtype}")
    for name, t in arrays.items():
        want = shape(name)
        if (t.device != dev or t.dtype != dtype
                or tuple(t.shape) != want or not t.is_contiguous()):
            raise ValueError(
                f"{kernel}: {name} is {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()}); expected "
                f"contiguous {dtype} {want} on {dev}")
    if scal.shape != (N_SCAL,) or scal.dtype != dtype:
        raise ValueError(f"{kernel}: scal must be ({N_SCAL},) {dtype}")
    if (flags.shape != (N_FLAGS,) or flags.dtype != torch.int32
            or flags.device != dev):
        raise ValueError(f"{kernel}: flags must be ({N_FLAGS},) int32")
    if (partials.dtype != torch.float64 or partials.device != dev
            or partials.numel() < n_partials
            or not partials.is_contiguous()):
        raise ValueError(f"{kernel}: partials must be contiguous float64 of "
                         f"{n_partials} at least")


def _check_words(arrays: dict) -> None:
    """Raise unless every array starts on a 4-byte boundary: K1-shard
    bf16's march loads and stores aligned words of a, b, d, pn and ap."""
    for name, t in arrays.items():
        if t.data_ptr() % 4:
            raise ValueError(
                f"{K1}: bf16 {name} starts off a 4-byte boundary "
                f"({t.data_ptr():#x}); the lane march takes aligned words")


def k1(z_ext, p_ext, a_ext, b_ext, d, pn, ap, scal, flags, partials, *,
       max_iter: int, h1: float, h2: float) -> None:
    """K1-shard: pn = z + βp and ap = A(pn) over this rank's block, the
    rank's Σap·pn as per-block partials (``partials.sum()``): the port of
    ``fused_sharded.py``'s K1, in f32 or in its bf16 form."""
    if z_ext.device.type == "cpu":
        return k1_plain(z_ext, p_ext, a_ext, b_ext, d, pn, ap, scal, flags,
                        partials, max_iter=max_iter, h1=h1, h2=h2)
    _launch_k1(z_ext, p_ext, a_ext, b_ext, d, pn, ap, scal, flags, partials,
               max_iter, h1, h2)


def _launch_k1(z_ext, p_ext, a_ext, b_ext, d, pn, ap, scal, flags, partials,
               max_iter: int, h1: float, h2: float) -> None:
    """K1-shard's launch in the form of z's dtype, its arguments checked
    first; a refused launch raises (``_build.check``)."""
    bm, bn = d.shape
    ext = dict(z_ext=z_ext, p_ext=p_ext, a_ext=a_ext, b_ext=b_ext)
    _check(K1, {**ext, "d": d, "pn": pn, "ap": ap},
           lambda name: (bm + 2, bn + 2) if name in ext else (bm, bn),
           scal, flags, partials, partial_counts(bm, bn, z_ext.dtype)[0])
    form = DTYPES[z_ext.dtype]
    if form == "bf16":
        _check_words(dict(a_ext=a_ext, b_ext=b_ext, d=d, pn=pn, ap=ap))
    lib = _build.load(LIBRARY, _SIGNATURES)
    rc = getattr(lib, f"pe_fused_sharded_k1_{form}")(
        z_ext.data_ptr(), p_ext.data_ptr(), a_ext.data_ptr(),
        b_ext.data_ptr(), d.data_ptr(), pn.data_ptr(), ap.data_ptr(),
        partials.data_ptr(), scal.data_ptr(), flags.data_ptr(), bm, bn,
        max_iter, ws.rounded(h1, z_ext.dtype), ws.rounded(h2, z_ext.dtype),
        _build.stream_handle(z_ext.device))
    counter = ws.counter(K1, form)
    _build.check(lib.pe_fused_sharded_error_string, counter, rc)
    _build.count_launch(counter)


def k2(w, r, pn, ap, dinv, z, scal, flags, partials, *,
       max_iter: int) -> None:
    """K2-shard: α, the w, r, z updates and the rank's [Σz·r, Σ(Δw)²] as
    per-block partials (``partials.sum(0)``): the port of
    ``fused_sharded.py``'s K2 (``ops/fused_pcg.py`` ``_k2_kernel``), in
    f32 or in its bf16 form."""
    if w.device.type == "cpu":
        return k2_plain(w, r, pn, ap, dinv, z, scal, flags, partials,
                        max_iter=max_iter)
    bm, bn = w.shape
    _check(K2, dict(w=w, r=r, pn=pn, ap=ap, dinv=dinv, z=z),
           lambda name: (bm, bn), scal, flags, partials,
           2 * partial_counts(bm, bn)[1])
    form = DTYPES[w.dtype]
    lib = _build.load(LIBRARY, _SIGNATURES)
    rc = getattr(lib, f"pe_fused_sharded_k2_{form}")(
        w.data_ptr(), r.data_ptr(), pn.data_ptr(), ap.data_ptr(),
        dinv.data_ptr(), z.data_ptr(), partials.data_ptr(), scal.data_ptr(),
        flags.data_ptr(), bm, bn, max_iter, _build.stream_handle(w.device))
    counter = ws.counter(K2, form)
    _build.check(lib.pe_fused_sharded_error_string, counter, rc)
    _build.count_launch(counter)


def _active(flags: torch.Tensor, max_iter: int) -> torch.Tensor:
    """The loop's condition as a device boolean (no host read)."""
    return ((flags[FLAG_K] < max_iter) & (flags[FLAG_CONVERGED] == 0)
            & (flags[FLAG_BREAKDOWN] == 0))


def _masked(active: torch.Tensor, target: torch.Tensor,
            new: torch.Tensor) -> None:
    target.copy_(torch.where(active, new, target))


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in DTYPES:
        raise ValueError(
            "fused-sharded supports f32/bf16; use stencil_impl='xla' for f64"
        )


def _run(problem: Problem, mesh: Mesh, bm: int, bn: int, operands,
         chunk: int, limit=None):
    """This rank's rotated loop, to the cap or ``limit``; returns
    (PCGResult over the owned block, host reads, bodies issued)."""
    a_blk, b_blk, d_blk, dinv_blk, rhs_blk = operands
    ct = rhs_blk.dtype
    # each value held in float, rounded to the run dtype where stored; a
    # reduced sum comes back in float (double, rounded once)
    q = ws.rounder(ct)
    f32 = torch.float32
    # the one coefficient halo exchange of the solve
    a_ext = halo_extend(a_blk, mesh)
    b_ext = halo_extend(b_blk, mesh)
    h1t, h2t, delta_t = (ws.held(spacing(x, rhs_blk)) for x in
                         (problem.h1, problem.h2, problem.delta))
    weighted = problem.norm == "weighted"
    cap = problem.max_iterations
    limit = cap if limit is None else min(int(limit), cap)
    # iteration 0: w = p = 0, β = 0, z = r·(1/D), as K2 forms z
    w = torch.zeros_like(rhs_blk)
    r = rhs_blk.clone()
    z = q(ws.held(r) * ws.held(dinv_blk)).to(ct)
    p = torch.zeros_like(rhs_blk)
    ap = torch.empty_like(rhs_blk)
    scal = torch.zeros(N_SCAL, dtype=ct, device=rhs_blk.device)
    zr0 = mesh.reduce(rank_sums((ws.held(z), ws.held(r))), f32)[0]
    scal[SCAL_ZR] = q(q(zr0) * h1t * h2t)
    scal[SCAL_DIFF] = float("inf")
    flags = torch.zeros(N_FLAGS, dtype=torch.int32, device=rhs_blk.device)
    part1, part2 = scratch(bm, bn, rhs_blk.device, ct)
    consts = dict(max_iter=limit)
    bodies = [0]

    def step(_k):
        bodies[0] += 1
        active = _active(flags, limit)
        zp = halo_extend_stacked(torch.stack([z, p]), mesh)
        # K1 reads the exchanged copies, so pn is written over p
        k1(zp[0], zp[1], a_ext, b_ext, d_blk, p, ap, scal, flags, part1,
           h1=problem.h1, h2=problem.h2, **consts)
        denom = q(q(mesh.reduce(part1.sum()[None], f32)[0]) * h1t * h2t)
        _masked(active, scal[SCAL_DENOM], denom)
        _masked(active, flags[FLAG_PENDING_BREAKDOWN],
                ws.below_guard(denom, ct).to(flags.dtype))
        k2(w, r, p, ap, dinv_blk, z, scal, flags, part2, **consts)
        sums = q(mesh.reduce(part2.sum(0), f32))
        new_scal, new_flags = scal.clone(), flags.clone()
        rotated_next_state(new_scal, new_flags, q(sums[0] * h1t * h2t),
                           sums[1], h1t, h2t, delta_t, weighted, q)
        _masked(active, scal, new_scal)
        _masked(active, flags, new_flags)

    syncs = run_chunked(step, lambda: flags[:3], limit, chunk)
    return PCGResult(
        w=w,
        iters=flags[FLAG_K],
        diff=scal[SCAL_DIFF],
        converged=flags[FLAG_CONVERGED].to(torch.bool),
        breakdown=flags[FLAG_BREAKDOWN].to(torch.bool),
    ), syncs, bodies[0]


def build_fused_sharded_solver(problem: Problem, mesh: Mesh | None = None,
                               dtype=torch.float32, geometry=None, theta=None,
                               chunk: int = DEFAULT_CHUNK):
    """(solver, args) for this rank's part of the fused mesh-sharded solve.

    args = (a, b, d, dinv, rhs), this rank's blocks of the host-f64
    operand set rounded once to ``dtype``, f32 or bf16 (d and dinv from
    ``ops.fused_pcg.interior_normalized``, as in the JAX package)."""
    if geometry is not None or theta is not None:
        raise unported("geometry=/theta=", "Queue A item 11")
    _check_dtype(dtype)
    if mesh is None:
        mesh = make_mesh()
    bm, bn = block_shape(problem, mesh)
    args = _fused_sharded_args(problem, mesh, dtype)
    return (ShardedSolver(lambda *ops, limit=None: _run(
        problem, mesh, bm, bn, ops, chunk, limit)), args)


def _fused_sharded_args(problem: Problem, mesh: Mesh, dtype):
    """This rank's blocks of (a, b, d, dinv, rhs), computed in f64 on the
    host and rounded once to ``dtype`` on its device."""
    a64, b64, rhs64 = assembly.assemble_numpy(problem)
    *_, d64, dinv64 = interior_normalized(problem, a64, b64)
    return tuple(assembly.to_device(rank_block(problem, mesh, x), dtype,
                                    mesh.device)
                 for x in (a64, b64, d64, dinv64, rhs64))


def solve_fused_sharded(problem: Problem, mesh: Mesh | None = None,
                        dtype=torch.float32,
                        chunk: int = DEFAULT_CHUNK) -> PCGResult:
    """Assemble, shard and solve with the fused two-kernel iteration; ``w``
    is this rank's block."""
    solver, args = build_fused_sharded_solver(problem, mesh, dtype,
                                              chunk=chunk)
    return solver(*args)
