"""The mesh: PCG over a grid of ``torch.distributed`` ranks.

The counterpart of ``poisson_ellipse_tpu.parallel``, without its pipelined
forms (ROADMAP Queue A item 21):

- ``mesh``:        the rank grid (``choose_process_grid``, the reference's
                   factorisation), the padding to even blocks, the gathered
                   reductions and the collective counters;
- ``halo``:        the one-cell halo exchange, corners in the second round;
- ``pcg_sharded``: the classical loop on every rank (``xla``, ``pallas``),
                   2 reductions and 1 halo exchange an iteration;
- ``fused_sharded``: the two-kernel iteration on every rank, K1-shard and
                   K2-shard (``csrc/fused_sharded.cu``);
- ``multihost``:   the process group and the rank processes.
"""

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

__all__ = [
    "choose_process_grid",
    "make_mesh",
    "halo_extend",
    "build_sharded_solver",
    "solve_sharded",
    "global_mesh",
    "initialize_multihost",
    "process_info",
    "shutdown_multihost",
]
