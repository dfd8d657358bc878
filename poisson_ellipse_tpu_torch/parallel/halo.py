"""One-cell halo-ring exchange between the ranks of a mesh (reference L4).

The counterpart of ``poisson_ellipse_tpu.parallel.halo``. Where JAX sends
each direction as one ``lax.ppermute`` of a boundary slice, each rank here
posts its sends and receives of a round together with
``torch.distributed.batch_isend_irecv`` and waits for them (blocking
send/recv pairs deadlock as soon as two neighbours both send first).

As in the reference (``stage2-mpi/poisson_mpi_decomp.cpp:241-347``):

- the x round runs first, on the owned block; the y round then runs on
  the x-extended block, so the corner cells arrive in the second round
  (``stage2:263-280``);
- a side with no neighbour (the physical boundary, and the mesh padding)
  receives zeros: the Dirichlet substitution of ``stage2:288-324``.

Under gloo each edge goes through a host tensor, as the reference's
stage 4 stages its halos (D2H, ``MPI_Sendrecv``, H2D,
``poisson_mpi_cuda2.cu:331-500``); under NCCL the edges stay on the card.
Every call counts one "halo" in ``parallel.mesh.COLLECTIVES``, a stacked
call too: the stacked form sends its k blocks in one message a direction.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from poisson_ellipse_tpu_torch.parallel.mesh import Mesh, count


def _check_width(block_shape, width: int) -> None:
    if width < 1:
        raise ValueError("halo width must be >= 1")
    if width > min(block_shape):
        raise ValueError(
            f"halo width {width} exceeds block extent {min(block_shape)}"
        )


def _round(mesh: Mesh, lo_peer, hi_peer, to_lo, to_hi, recv_shape, dtype):
    """One exchange round along an axis: send ``to_lo`` to the grid
    position ``lo_peer`` and ``to_hi`` to ``hi_peer`` (None: no neighbour
    on that side; a message names the position's global rank,
    ``Mesh.peer``, which differs on a survivors' sub-group); return
    (from_lo, from_hi), zeros from a missing neighbour. Both edges go out
    in one staging copy and come in through one buffer, so under gloo a
    round waits for the card once."""
    n = to_lo.numel()
    out = mesh.wire(torch.cat([to_lo.reshape(-1), to_hi.reshape(-1)]))
    inbox = mesh.wire_zeros((2, n), dtype)
    ops = []
    for side, peer in enumerate((lo_peer, hi_peer)):
        if peer is None:
            continue
        to = mesh.peer(peer)
        ops.append(dist.P2POp(dist.isend, out[side * n:(side + 1) * n], to,
                              mesh.group))
        ops.append(dist.P2POp(dist.irecv, inbox[side], to, mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    got = mesh.unwire(inbox)
    return got[0].reshape(recv_shape), got[1].reshape(recv_shape)


def halo_extend_stacked(us: torch.Tensor, mesh: Mesh,
                        width: int = 1) -> torch.Tensor:
    """The halo exchange of k same-shape blocks in one message a direction:
    (k, bm, bn) → (k, bm+2w, bn+2w). The fused-sharded loop ships its
    (z, p) pair this way (``parallel.fused_sharded``)."""
    k, bm, bn = us.shape
    _check_width((bm, bn), width)
    count("halo")
    w = width
    ext = torch.zeros((k, bm + 2 * w, bn + 2 * w), dtype=us.dtype,
                      device=us.device)
    ext[:, w:w + bm, w:w + bn] = us
    ix, iy = mesh.ix, mesh.iy
    # x round on the owned columns: the predecessor's last rows arrive on
    # top, the successor's first rows below
    lo = mesh.rank_of(ix - 1, iy) if ix > 0 else None
    hi = mesh.rank_of(ix + 1, iy) if ix < mesh.px - 1 else None
    from_lo, from_hi = _round(mesh, lo, hi, us[:, :w, :], us[:, -w:, :],
                              (k, w, bn), us.dtype)
    ext[:, :w, w:w + bn] = from_lo
    ext[:, w + bm:, w:w + bn] = from_hi
    # y round on the x-extended rows, which carries the corners
    lo = mesh.rank_of(ix, iy - 1) if iy > 0 else None
    hi = mesh.rank_of(ix, iy + 1) if iy < mesh.py - 1 else None
    from_lo, from_hi = _round(mesh, lo, hi, ext[:, :, w:2 * w],
                              ext[:, :, bn:bn + w], (k, bm + 2 * w, w),
                              us.dtype)
    ext[:, :, :w] = from_lo
    ext[:, :, w + bn:] = from_hi
    return ext


def halo_extend(u: torch.Tensor, mesh: Mesh, width: int = 1) -> torch.Tensor:
    """Extend this rank's (bm, bn) block to (bm+2w, bn+2w) with its
    neighbours' edges; zeros where there is no neighbour. ``width`` > 1
    exchanges w-cell slabs (``width`` ≤ min(bm, bn))."""
    _check_width(u.shape, width)
    return halo_extend_stacked(u[None], mesh, width)[0]


def exchange_report(global_array, stacked_with=None, width: int = 1,
                    device=None) -> list:
    """Every rank's halo-extended block of a global host array, as host
    arrays in rank order, for a caller that holds the exchange against the
    global array: each rank takes its (bm, bn) block of ``global_array``
    (its shape a multiple of the mesh's) and exchanges it, stacked with its
    block of ``stacked_with`` when that is given (then each entry is the
    (2, ·, ·) pair). Every rank calls it together, with the ``device``
    type its group was started on."""
    import numpy as np

    from poisson_ellipse_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device=device)
    arrays = [global_array] + ([] if stacked_with is None else [stacked_with])
    g1, g2 = np.shape(global_array)
    bm, bn = g1 // mesh.px, g2 // mesh.py
    blocks = torch.stack([
        torch.as_tensor(np.asarray(x)[mesh.ix * bm:(mesh.ix + 1) * bm,
                                      mesh.iy * bn:(mesh.iy + 1) * bn])
        for x in arrays]).to(mesh.device)
    if stacked_with is None:
        ext = halo_extend(blocks[0], mesh, width)
    else:
        ext = halo_extend_stacked(blocks, mesh, width)
    return [x.cpu().numpy() for x in mesh.all_gather(ext.contiguous())]
