"""Mesh-sharded s-step PCG: one s-deep halo and one reduction per s
iterations.

The counterpart of ``poisson_ellipse_tpu.parallel.sstep_sharded``. The
communication an iteration, engine by engine:

  classical (``pcg_sharded``)        1 halo exchange + 2 reductions
  pipelined (``pipelined_sharded``)  1 halo exchange + 1 reduction
  s-step (here, s ∈ {2, 4})          1/s halo exchange + 1/s reduction

One body advances s iterations (``ops.sstep_pcg``). It exchanges one
s-deep halo of the stacked (p, r, x) triple (x rides along so that the
residual replacement r = rhs − A·x is local), builds the matrix-powers
basis by applying the masked stencil chain against per-depth interior
masks and diagonals (loop invariant: computed from the deep coefficient
halos exchanged once a solve), reduces both Gram matrices in one stacked
``Mesh.reduce`` (each rank's partials accumulated in ``gram_dtype``), and
runs the s coordinate-space iterations on every rank
(``ops.sstep_pcg.sstep_inner``, no further collective).

With a ``storage_dtype`` narrower than compute (``ops.precision``) the
carry's x, r and p are stored narrow and loaded at compute width in each
body, the replacement cadence tightens (``replace_every``), a replaced
block restarts p = z, and the exchange is one cell deeper (s + 1), so that
the restart's z is at depth s on the rank itself; the collective count is
the same. As in the JAX module a, b and D stay at compute width.

As on one device the host decides which blocks replace (from the iteration
a block starts at), a limit inside a block stops at exactly that iteration,
and a body issued after the exit changes nothing. The carry is the
classical one (``solver.pcg.PCGState``) over this rank's block. f32, f64
and bf16 compute: bf16 takes the single-device bf16 arithmetic of
``ops.sstep_pcg`` (the Grams accumulated in f64, the cadence
``replace_every(storage_dtype, dtype)``: 8 at bf16, as the JAX module
takes it).

``build_sstep_sharded_stepper`` is the chunked form the guard drives; its
carry is the classical one, so ``pcg_sharded.build_sharded_recover``
restarts it. ``abft=True`` runs the JAX module's block-level checks on the
classical ABFT tail (``resilience.abft``): the column sums σ = Σ basisₘ
and τ = Σ D·basisₘ, Σx and the scales Σ|x|, Σ|p|, Σ|r| ride the Gram
reduction; a block checks Σp = σ₀, Σr = τ_z₀ (not where it replaced r),
Σx against the last block's predictions through the coordinates, and that
the Grams' diagonals (sums of squares) are not negative, which a
sign-flipped reduction breaks. The rtol is that of the storage dtype
where there is one.
"""

from __future__ import annotations

import torch

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops import assembly
from poisson_ellipse_tpu_torch.ops.precision import (
    load,
    replace_every,
    resolve_storage_dtype,
    store,
)
from poisson_ellipse_tpu_torch.ops.sstep_pcg import (
    BASIS_SCALE,
    DEFAULT_S,
    SSTEP_CHOICES,
    basis_size,
    gram_dtype,
    replaces,
    shift_matrix,
    sstep_inner,
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
    _shard_init,
    block_shape,
    global_indices,
    host_report,
    measured_solve,
)
from poisson_ellipse_tpu_torch.resilience.abft import (
    abft_rtol,
    drift_ok,
    with_tail,
)
from poisson_ellipse_tpu_torch.solver.pcg import (
    DEFAULT_CHUNK,
    PCGResult,
    PCGState,
    result_of,
    run_chunked,
    unported,
)


def _crop(arr, m: int):
    """Remove ``m`` halo cells from each side of a 2-D block."""
    return arr[m:-m, m:-m] if m else arr


def make_sstep_parts(problem: Problem, mesh: Mesh | None, dtype, s: int,
                     storage_dtype=None, abft: bool = False, geometry=None,
                     theta=None, chunk: int = DEFAULT_CHUNK):
    """(run, args) for this rank: ``run(a_blk, b_blk, rhs_blk, limit=None,
    state=None)`` exchanges the deep coefficient and right-hand-side halos,
    makes the carry at iteration 0 (one reduction) unless ``state`` hands
    it one (this rank's block of a carry, stored as the run stores it) and
    advances it in blocks of s to the cap or ``limit``; it returns (carry,
    host reads, bodies issued). ``args`` are this rank's blocks of the
    host-assembled (a, b, rhs). ``run.prepare(a_blk, b_blk, rhs_blk)``
    makes the halos and returns (init, body) without running: ``init()``
    the iteration-0 carry, ``body(state, k, limit)`` one block from the
    iteration ``k`` the host issues it at."""
    if s not in SSTEP_CHOICES:
        raise ValueError(f"s must be one of {SSTEP_CHOICES}, got {s}")
    if geometry is not None or theta is not None:
        raise unported("geometry=/theta=", "Queue A item 11")
    if mesh is None:
        mesh = make_mesh()
    st = resolve_storage_dtype(storage_dtype, dtype)
    cadence = replace_every(st, dtype)
    # exchange depth: s for the basis; one deeper under narrow storage so
    # the p = z restart's z is at depth s on the rank
    w_ex = s + (1 if st is not None else 0)
    zd = w_ex - 1  # the residual's and z₀'s depth
    bm, bn = block_shape(problem, mesh)
    if w_ex >= min(bm, bn):
        raise ValueError(
            f"{w_ex}-deep halos need blocks deeper than that; got "
            f"{bm}x{bn} blocks on a {mesh.px}x{mesh.py} mesh"
        )
    K = basis_size(s)
    iz = s + 1
    gd = gram_dtype(dtype)
    weighted = problem.norm == "weighted"
    rtol = abft_rtol(st if st is not None else dtype) if abft else None

    def prepare(a_blk, b_blk, rhs_blk):
        dev = rhs_blk.device
        h1, h2 = spacing(problem.h1, rhs_blk), spacing(problem.h2, rhs_blk)
        hw = h1 * h2
        delta = spacing(problem.delta, rhs_blk)
        scale = spacing(1.0 / BASIS_SCALE, rhs_blk)
        zero = torch.zeros((), dtype=dtype, device=dev)

        # deep coefficient halos, once a solve; the one-cell ones of the
        # classical init are their inner ring
        a_deep = halo_extend(a_blk, mesh, width=w_ex)
        b_deep = halo_extend(b_blk, mesh, width=w_ex)
        rhs_ext = halo_extend(rhs_blk, mesh, width=zd) if zd else rhs_blk

        # per-depth interior masks and masked diagonals, q = 0 … w_ex−1
        masks, diags = [], []
        for q in range(w_ex):
            gi, gj = global_indices(mesh, bm, bn, halo=q)
            interior = assembly.interior_mask(problem, gi, gj)
            a_q1 = _crop(a_deep, w_ex - q - 1)  # depth q+1: diag's extent
            b_q1 = _crop(b_deep, w_ex - q - 1)
            masks.append(interior.to(dtype))
            diags.append(torch.where(interior,
                                     diag_d_block(a_q1, b_q1, h1, h2), zero))
        d0 = diags[0]
        d0_g, hw_g, delta_g = d0.to(gd), hw.to(gd), delta.to(gd)
        Bm = shift_matrix(s, gd, dev)

        def pdot(u, v):
            return mesh.reduce(rank_sums((u, v)), dtype)[0] * hw

        def init():
            state = _shard_init(problem, pdot, d0, rhs_blk, dtype, abft=abft,
                                mesh=mesh)
            return state._replace(w=store(state.w, st),
                                  r=store(state.r, st),
                                  p=store(state.p, st))

        def chain(v_ext, q_in):
            """One Â = D⁻¹A application down the halo chain: depth q_in in,
            masked preconditioned depth q_in − 1 out."""
            q = q_in - 1
            a_q = _crop(a_deep, w_ex - q_in)
            b_q = _crop(b_deep, w_ex - q_in)
            out = apply_a_block(v_ext, a_q, b_q, h1, h2) * masks[q]
            return apply_dinv(out, diags[q])

        def body(sv, k: int, limit: int):
            active = (sv.k < limit) & ~sv.converged & ~sv.breakdown
            if abft:
                # a flagged carry stops at once (the classical stance)
                active = active & ~sv.sdc
            x_own, r_own, p_own = (load(v, dtype, st)
                                   for v in (sv.w, sv.r, sv.p))

            # the block's halo exchange: (p, r, x) as one stacked deep slab
            ext = halo_extend_stacked(torch.stack([p_own, r_own, x_own]),
                                      mesh, width=w_ex)
            p_ext = _crop(ext[0], w_ex - s)  # depth s: the basis root
            r_ext, x_ext = ext[1], ext[2]

            # residual replacement, entirely local: x came at depth w_ex,
            # so A·x is at depth zd without another exchange
            replaced = replaces(k, s, cadence)
            if replaced:
                r_base = rhs_ext - apply_a_block(x_ext, a_deep, b_deep, h1,
                                                 h2) * masks[zd]
            else:
                r_base = _crop(r_ext, 1)  # depth zd
            z0 = apply_dinv(r_base, diags[zd])
            p0 = z0 if replaced and st is not None else p_ext

            # the matrix-powers chains (masked, preconditioned, ρ-scaled)
            vs = [p0]
            for q in range(s, 0, -1):
                vs.append(chain(vs[-1], q) * scale)
            zs = [z0]
            for q in range(zd, zd - (s - 1), -1):
                zs.append(chain(zs[-1], q) * scale)
            V = torch.stack([_crop(v, (v.shape[0] - bm) // 2)
                             for v in vs + zs])  # (K, bm, bn)
            del vs, zs

            # the block's one reduction: both Gram partials, widened (and
            # the ABFT column sums σ, τ and Σx, Σ|x|, Σ|p|, Σ|r|)
            Vg = V.to(gd)
            Vd = Vg * d0_g
            gm_loc = torch.einsum("kij,lij->kl", Vg, Vd)
            ge_loc = torch.einsum("kij,lij->kl", Vg, Vg)
            parts = [gm_loc.reshape(-1), ge_loc.reshape(-1)]
            if abft:
                parts += [Vg.sum(dim=(1, 2)), Vd.sum(dim=(1, 2)),
                          torch.stack([x_own, x_own.abs(), p_own.abs(),
                                       r_own.abs()]).sum(
                              dim=(1, 2), dtype=torch.float64).to(gd)]
            del Vg, Vd
            sums = mesh.reduce(torch.cat(parts), gd)
            Gm = sums[:K * K].reshape(K, K) * hw_g
            Ge = sums[K * K:2 * K * K].reshape(K, K)

            k_n, x_c, z_c, p_c, zr_n, diff_n, conv_n, bd_n = sstep_inner(
                Gm, Ge, Bm, s, sv.k, limit, delta_g, hw_g, weighted,
                sv.diff.to(gd), sv.converged, sv.breakdown, gd,
            )
            x_cd, z_cd, p_cd = x_c.to(dtype), z_c.to(dtype), p_c.to(dtype)
            x_new = x_own + torch.tensordot(x_cd, V, dims=1)
            r_new = d0 * torch.tensordot(z_cd, V, dims=1)
            p_new = torch.tensordot(p_cd, V, dims=1)

            # a body issued after the loop has exited changes nothing
            def keep(old, new):
                return torch.where(active, store(new, st), old)

            out = PCGState(
                k=k_n,
                w=keep(sv.w, x_new),
                r=keep(sv.r, r_new),
                p=keep(sv.p, p_new),
                zr=torch.where(active, zr_n.to(dtype), sv.zr),
                diff=torch.where(active, diff_n.to(dtype), sv.diff),
                converged=conv_n,
                breakdown=bd_n,
            )
            if not abft:
                return out
            off = 2 * K * K
            sigma, tau = sums[off:off + K], sums[off + K:off + 2 * K]
            s_x, s_absx, s_absp, s_absr = sums[off + 2 * K:off + 2 * K + 4]
            # the block-start checks against the last block's predictions:
            # Σp = σ₀ (not where narrow storage restarted p = z), Σr = τ_z₀
            # (not where the block replaced r), Σx; and the Grams'
            # diagonals, sums of squares, not negative
            ok = (drift_ok(s_x, sv.s_w, s_absx, rtol)
                  & (torch.diagonal(Gm) >= 0).all()
                  & (torch.diagonal(Ge) >= 0).all())
            if not (replaced and st is not None):
                ok = ok & drift_ok(sigma[0], sv.s_p_pred, s_absp, rtol)
            if not replaced:
                ok = ok & drift_ok(tau[iz], sv.s_r, s_absr, rtol)
            step = active & ~bd_n

            def next_(old, new):
                return torch.where(step, new.to(dtype), old)

            # the next block's predictions through the coordinates
            return with_tail(out, (
                next_(sv.s_r, z_c @ tau),
                next_(sv.s_w, s_x + x_c @ sigma),
                next_(sv.s_p_pred, p_c @ sigma),
                sv.sdc | (step & ~ok)))

        return init, body

    def run(a_blk, b_blk, rhs_blk, limit=None, state=None):
        cap = problem.max_iterations
        limit = cap if limit is None else min(int(limit), cap)
        init, body = prepare(a_blk, b_blk, rhs_blk)
        carry = [init() if state is None else state]
        bodies = [0]

        def step(k: int):
            carry[0] = body(carry[0], k, limit)
            bodies[0] += 1

        def flags():
            sv = carry[0]
            return torch.stack([sv.k, sv.converged.to(sv.k.dtype),
                                sv.breakdown.to(sv.k.dtype)])

        syncs = run_chunked(step, flags, limit, chunk, per_body=s)
        return carry[0], syncs, bodies[0]

    run.prepare = prepare
    return run, _host_sharded_args(problem, mesh, dtype)


def build_sstep_sharded_solver(problem: Problem, mesh: Mesh | None = None,
                               dtype=torch.float32, s: int = DEFAULT_S,
                               storage_dtype=None, geometry=None, theta=None,
                               chunk: int = DEFAULT_CHUNK):
    """(solver, args) for this rank's part of the mesh-sharded s-step solve:
    args are this rank's blocks of the host-assembled (a, b, rhs), and
    ``solver(*args)`` returns a ``PCGResult`` whose ``w`` is this rank's
    block, stored in ``storage_dtype`` when one is given."""
    run, args = make_sstep_parts(problem, mesh, dtype, s, storage_dtype,
                                 geometry=geometry, theta=theta, chunk=chunk)

    def solve(*blocks, limit=None):
        state, syncs, bodies = run(*blocks, limit=limit)
        return result_of(state), syncs, bodies

    return ShardedSolver(solve), args


def build_sstep_sharded_stepper(problem: Problem, mesh: Mesh | None = None,
                                dtype=torch.float32, s: int = DEFAULT_S,
                                abft: bool = False, storage_dtype=None):
    """(init_fn, advance_fn) for chunked, guarded s-step mesh solves on
    this rank (``pcg_sharded.build_sharded_stepper``'s contract over the
    classical carry): ``advance_fn(state, limit, k=None)`` issues the
    blocks of s from iteration ``k`` (read from the carry when None); a
    limit inside a block stops at exactly that iteration, and the next
    call starts its blocks there. The deep halos are exchanged once, at
    the build; ``abft`` appends the classical shadow tail."""
    run, args = make_sstep_parts(problem, mesh, dtype, s, storage_dtype,
                                 abft=abft)
    init, body = run.prepare(*args)
    cap = problem.max_iterations

    def advance_fn(state, limit, k=None):
        limit = min(int(limit), cap)
        k = int(state.k) if k is None else int(k)
        for it in range(k, limit, s):
            state = body(state, it, limit)
        return state

    return init, advance_fn


def solve_sstep_sharded(problem: Problem, mesh: Mesh | None = None,
                        dtype=torch.float32, s: int = DEFAULT_S,
                        storage_dtype=None,
                        chunk: int = DEFAULT_CHUNK) -> PCGResult:
    """Assemble, shard and solve over the mesh with the s-step engine;
    ``w`` is this rank's block."""
    solver, args = build_sstep_sharded_solver(problem, mesh, dtype, s=s,
                                              storage_dtype=storage_dtype,
                                              chunk=chunk)
    return solver(*args)


def solve_report(problem: Problem, dtype=torch.float32, s: int = DEFAULT_S,
                 storage_dtype=None, chunk: int = DEFAULT_CHUNK,
                 device=None) -> dict:
    """One s-step sharded solve on this rank (``pcg_sharded.host_report``);
    every rank calls it together, with the ``device`` type its group was
    started on."""
    mesh = make_mesh(device=device)
    solver, args = build_sstep_sharded_solver(problem, mesh, dtype, s=s,
                                              storage_dtype=storage_dtype,
                                              chunk=chunk)
    return host_report(problem, mesh, solver,
                       *measured_solve(mesh, solver, args))
