"""poisson_ellipse_tpu_torch — the PyTorch/CUDA port of poisson_ellipse_tpu.

The fictitious-domain Poisson solve (-Δu = f on the ellipse x² + 4y² < 1
inside Ω = [-1,1]×[-0.6,0.6]) with diagonally preconditioned conjugate
gradients, on one NVIDIA Hopper card. The module layout mirrors the JAX
package's, so each module's counterpart has the same relative path:

- ``models``  — ``Problem`` and the ellipse's closed forms;
- ``ops``     — f64 host assembly, the plain stencil and reductions, and
  the hand-written CUDA kernels (``csrc/``, built by ``ops._build``):
  the stencil and the stencil fused with dot products
  (``ops.hopper_kernels``), the fused K1/K2 iteration
  (``ops.fused_pcg``) and the whole-solve kernels (``ops.resident_pcg``,
  ``ops.streamed_pcg``, ``ops.xl_pcg``, over ``ops.whole_solve``); the
  pipelined and s-step recurrences (``ops.pipelined_pcg``,
  ``ops.sstep_pcg``); the lane-batched stencil (K-e) and stencil with dot
  bundle (K-f); the storage axis (``ops.precision``: state stored in bf16
  or f16, f32 arithmetic) with the mixed stencil (K-g) and mixed stencil
  with dot bundle (K-h);
- ``batch``   — B independent solves in one loop (``batched_pcg``,
  ``batched_pipelined``) and the chunked driver that reports lane
  quarantines (``driver.solve_batched``);
- ``solver``  — the classical loop with its scalar carry on the device,
  the engine table (``xla``, ``pallas``, ``fused``, ``resident``,
  ``streamed``, ``xl``, ``pipelined``, ``pipelined-pallas``, ``sstep``,
  ``sstep-pallas``, ``batched``, ``batched-pipelined``, ``batched-pallas``,
  ``batched-pipelined-pallas``) and ``auto``'s capacity ladder;
- ``parallel`` — the mesh: a grid of ``torch.distributed`` ranks, each
  solving its block with the classical loop (``xla``, ``pallas``) or the
  fused iteration (K1-shard / K2-shard), halo exchanges and gathered
  reductions between them;
- ``resilience`` — the exit-code contract and the classified errors,
  deterministic fault injection, and the guard (``guarded_solve``: a
  health word a chunk and the recovery ladder); ``solver.checkpoint``
  saves and resumes the classical carry;
- ``obs`` — the convergence ring, spectrum, trace, metrics and profile;
- ``runtime`` — shape buckets and the warm pool (a bucket's buffers and
  its captured chunk graphs, ``compile_cache``), and the kernel
  libraries' directory;
- ``serve`` — continuous batching on one device: bounded admission, the
  retire-and-refill scheduler, the request journal and the chaos drill;
- ``harness`` — ``run_once`` and the command line (``--lanes``,
  ``--storage-dtype``, ``--mode sharded --mesh PX PY``, ``--guard``,
  ``--timeout``, ``--checkpoint-dir``, ``inject``, ``serve``, ``chaos``,
  ``warmup``);
- ``interop`` — the JAX package's arrays into the port, for the tests.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
This package imports neither JAX nor the JAX package.
"""

from poisson_ellipse_tpu_torch.models.problem import Problem
from poisson_ellipse_tpu_torch.ops.pipelined_pcg import (
    PipelinedState,
    pcg_pipelined,
)
from poisson_ellipse_tpu_torch.ops.sstep_pcg import pcg_sstep
from poisson_ellipse_tpu_torch.solver.engine import build_solver, solve
from poisson_ellipse_tpu_torch.solver.pcg import PCGResult, pcg
from poisson_ellipse_tpu_torch.utils.error import l2_error_vs_analytic

__version__ = "0.1.0"

__all__ = [
    "Problem",
    "PCGResult",
    "PipelinedState",
    "build_solver",
    "pcg",
    "pcg_pipelined",
    "pcg_sstep",
    "solve",
    "l2_error_vs_analytic",
]
