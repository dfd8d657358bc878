"""Lane-batched solves: one loop, B independent problems.

The counterpart of ``poisson_ellipse_tpu.batch``: ``batched_pcg`` and
``batched_pipelined`` run B lanes (stacked RHS, per-lane ε allowed)
through one chunked loop with per-lane masked updates and in-loop NaN-lane
quarantine; ``driver.solve_batched`` reports each quarantine as a
``RecoveryEvent``. The ``-pallas`` engines take the batched kernels K-e
and K-f (``ops.hopper_kernels``).
"""

from poisson_ellipse_tpu_torch.batch.batched_pcg import (
    BatchedPCGResult,
    batched_operands,
    pcg_batched,
)
from poisson_ellipse_tpu_torch.batch.batched_pipelined import (
    pcg_batched_pipelined,
)
from poisson_ellipse_tpu_torch.batch.driver import (
    BATCHED_ENGINES,
    GuardedBatchedResult,
    solve_batched,
)

__all__ = [
    "BATCHED_ENGINES",
    "BatchedPCGResult",
    "GuardedBatchedResult",
    "batched_operands",
    "pcg_batched",
    "pcg_batched_pipelined",
    "solve_batched",
]
