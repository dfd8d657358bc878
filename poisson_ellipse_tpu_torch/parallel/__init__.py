"""The mesh: PCG over a grid of ``torch.distributed`` ranks.

The counterpart of ``poisson_ellipse_tpu.parallel``, without its
multigrid forms (ROADMAP Queue A item 21c):

- ``mesh``:        the rank grid (``choose_process_grid``, the reference's
                   factorisation), the padding to even blocks, the gathered
                   reductions and the collective counters;
- ``halo``:        the one-cell (or w-cell) halo exchange, corners in the
                   second round;
- ``pcg_sharded``: the classical loop on every rank (``xla``, ``pallas``),
                   2 reductions and 1 halo exchange an iteration, and its
                   chunked stepper, recover and ABFT checks (the guard's);
- ``fused_sharded``: the two-kernel iteration on every rank, K1-shard and
                   K2-shard (``csrc/fused_sharded.cu``);
- ``pipelined_sharded``: the pipelined recurrence, 1 reduction and 1 halo
                   exchange an iteration;
- ``sstep_sharded``: s iterations a body, 1 reduction and 1 s-deep halo
                   exchange per s iterations, with narrow storage;
- ``batched_sharded``: whole lanes of a batch on each rank, 1 reduction an
                   iteration and no halo exchange;
- ``elastic``:     the survivors' mesh after a lost rank, and a carry
                   resharded across mesh shapes (``resilience.meshguard``);
- ``multihost``:   the process group and the rank processes.
"""

from poisson_ellipse_tpu_torch.parallel.batched_sharded import (
    build_batched_sharded_solver,
    solve_batched_sharded,
)
from poisson_ellipse_tpu_torch.parallel.halo import halo_extend
from poisson_ellipse_tpu_torch.parallel.mesh import (
    choose_process_grid,
    make_mesh,
)
from poisson_ellipse_tpu_torch.parallel.multihost import (
    global_mesh,
    initialize_multihost,
    process_info,
    shutdown_multihost,
)
from poisson_ellipse_tpu_torch.parallel.pcg_sharded import (
    build_sharded_solver,
    solve_sharded,
)
from poisson_ellipse_tpu_torch.parallel.pipelined_sharded import (
    build_pipelined_sharded_solver,
    solve_pipelined_sharded,
)
from poisson_ellipse_tpu_torch.parallel.sstep_sharded import (
    build_sstep_sharded_solver,
    solve_sstep_sharded,
)

__all__ = [
    "choose_process_grid",
    "make_mesh",
    "halo_extend",
    "build_sharded_solver",
    "solve_sharded",
    "build_pipelined_sharded_solver",
    "solve_pipelined_sharded",
    "build_sstep_sharded_solver",
    "solve_sstep_sharded",
    "build_batched_sharded_solver",
    "solve_batched_sharded",
    "global_mesh",
    "initialize_multihost",
    "process_info",
    "shutdown_multihost",
]
