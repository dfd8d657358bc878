"""Elastic mesh surgery: shrink a rank mesh and re-lay a carry over it.

The port's counterpart of ``poisson_ellipse_tpu.parallel.elastic``. A lost
rank ends every collective of its mesh; what survives is the state, a
handful of global arrays and replicated scalars whose arithmetic does not
depend on the decomposition (the reductions' grouping moves it by an ulp).
So elasticity is three operations off the loop:

- :func:`surviving_devices` / :func:`shrink_mesh`: the survivors' mesh,
  near-square as the first (``parallel.mesh.choose_process_grid``), so a
  2×2 mesh that loses one rank resumes on 1×3 and one that loses two on
  1×2. A device id of the JAX package is a rank of the original process
  group here; the survivors' mesh is a process group of their own
  (``dist.new_group``), its grid positions mapped to their global ranks
  (``Mesh.ranks``, which is what a halo message names);
- :func:`gather_state`: a carry's blocks as global host arrays (one
  gather on the mesh that holds them);
- :func:`reshard_state`: a carry of global arrays cropped to the node grid
  (dropping whatever padding its mesh had), re-padded to the new mesh's
  dims and cut to this rank's block.

``resilience.meshguard`` composes them with the durable checkpoint
(``solver.checkpoint`` reshards a step written on another mesh shape the
same way) into the degraded-mesh recovery.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.parallel.mesh import (
    Mesh,
    padded_dims,
    sub_mesh,
)
from poisson_ellipse_tpu_torch.resilience.errors import DeviceLossError
from poisson_ellipse_tpu_torch.solver.pcg import PCGState


def surviving_devices(mesh: Mesh, lost_ids) -> list:
    """The mesh's global ranks minus the lost ones, in order."""
    lost = set(lost_ids)
    return [r for r in mesh.global_ranks if r not in lost]


def shrink_mesh(mesh: Mesh, lost_ids) -> Mesh | None:
    """A fresh near-square mesh over the survivors, for this process: its
    ``Mesh`` when it survives, None when it is one of the lost. The
    survivors' process group is made by ``dist.new_group``, which every
    process of the default group calls, in the same order (a rank the
    ladder dropped earlier too: ``resilience.meshguard`` has it follow
    each degrade), so every process numbers its groups alike. Raises the
    classified :class:`DeviceLossError` when nothing survives, the
    ladder's floor."""
    survivors = surviving_devices(mesh, lost_ids)
    if not survivors:
        raise DeviceLossError(
            f"all {mesh.world} mesh devices lost "
            f"({sorted(set(lost_ids))}) — no degraded mesh remains to "
            "resume on"
        )
    return join_survivors(mesh, survivors)


def join_survivors(mesh: Mesh, survivors) -> Mesh | None:
    """The survivors' group made (every process of the default group
    calls this with the same ``survivors``), and this process's mesh in
    it, or None when it is not a survivor."""
    group = None
    if len(survivors) > 1 and dist.is_initialized():
        group = dist.new_group(ranks=list(survivors))
    if mesh.global_rank not in survivors:
        return None
    return sub_mesh(mesh, survivors, group)


def gather_state(state, mesh: Mesh | None = None) -> tuple:
    """A carry as host tensors: each grid field the global (padded) array
    of ``mesh``'s blocks (one gather of the stacked blocks; every rank of
    ``mesh`` calls it), or as it is without a mesh; scalars 0-d."""
    fields = list(state)
    grids = [i for i, x in enumerate(fields) if x.dim() == 2]
    if mesh is not None and grids:
        stacked = mesh.gather_blocks(torch.stack([fields[i] for i in grids]))
        for j, i in enumerate(grids):
            fields[i] = stacked[j]
    return tuple(x.detach().to("cpu") for x in fields)


def reshard_state(problem: Problem, state, mesh: Mesh, dtype,
                  dims: tuple[int, int] | None = None):
    """Re-lay a classical 8-field carry of global arrays out over ``mesh``.

    Grid fields (2-D) are cropped to the node grid, dropping the old
    decomposition's zero padding whatever it was, zero-padded to ``dims``
    (default: ``mesh``'s padded dims) and cut to this rank's block on its
    device; scalars are copied there. The padding is zero in every field
    by construction (each sharded iterate is interior-masked), so the
    carry advances as the old decomposition's would, up to the grouping
    of the reductions.

    An ABFT tail is refused, as in the JAX package: shadow sums are
    re-anchored against the resharded arrays (the stepper's recover),
    never copied across a layout change.
    """
    if len(state) != 8:
        raise ValueError(
            f"reshard_state takes the classical 8-field carry, got "
            f"{len(state)} fields (strip/re-anchor any ABFT or history tail)"
        )
    g1, g2 = problem.node_shape
    g1p, g2p = padded_dims(problem.node_shape, mesh) if dims is None else dims
    bm, bn = g1p // mesh.px, g2p // mesh.py
    out = []
    for x in state:
        x = torch.as_tensor(x)
        if x.dim() == 2:
            full = torch.zeros((g1p, g2p), dtype=x.dtype)
            full[:g1, :g2] = x[:g1, :g2].to("cpu")
            x = full[mesh.ix * bm:(mesh.ix + 1) * bm,
                     mesh.iy * bn:(mesh.iy + 1) * bn]
        out.append(x.to(device=mesh.device).clone())
    return PCGState(*out)
