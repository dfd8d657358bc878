"""On-device convergence telemetry: per-iteration history with no host read.

The counterpart of ``poisson_ellipse_tpu.obs.convergence``. The port's
loops keep their carry on the device and read it on the host once a chunk
(``solver.pcg.run_chunked``), so a convergence stall or a breakdown is
invisible but for the final scalars. The history is a ring preallocated on
the solve's device and written by each loop body at its iteration ``k``,
its values masked by the loop's device flag: the write issues no host
read, and the whole history comes back with the one read of the result.

Four series are recorded per iteration, in :data:`HISTORY_FIELDS` order:

  zr     the iteration's preconditioned-residual inner product, the
         classical loop's raw ``zr_new = (z, r)``; the pipelined loop's γ
         (the same quantity one recurrence step earlier, as the JAX
         engine records it).
  diff   the step norm ‖Δw‖ as stored into the carry (on a breakdown
         iteration the held previous value, what the solver reports).
  alpha  the step length the iteration applied: exactly 0 on a breakdown
         iteration, whose update is discarded.
  beta   the raw direction update coefficient the iteration computed.

The ring is one (4, cap) tensor in the compute dtype, cap =
``Problem.max_iterations``; its row i is field i. A body writes column k,
k being the iteration the host issues it as (``solver.pcg.run_chunked``
passes it; exact while the loop is active, and never past the limit), so
the column is a host index and the write one copy. The values are masked
by the device flag ``active``: a body issued after the loop has exited
(up to a chunk of them, each a no-op on the carry) writes back the column
it finds past ``iters``, zero, so the buffers stay zero past ``iters``. The recording is pure extra stores: the iterates are
bitwise the same with the ring on and off. At 2400×3200 in f32 the ring
is 123 MB.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

HISTORY_FIELDS = ("zr", "diff", "alpha", "beta")


class ConvergenceTrace(NamedTuple):
    """Per-iteration solver history; entries ``[:iters]`` are valid.

    The buffers are full length (``cap``) and zero past ``iters``:
    trimming is a host-side choice (:meth:`valid`)."""

    iters: torch.Tensor
    zr: torch.Tensor
    diff: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor

    def valid(self) -> dict:
        """Host-side view: {field: numpy array of the iters valid entries}
        (a narrow ring widened exactly to f32: numpy has no bf16)."""
        n = int(self.iters)
        out = {}
        for name in HISTORY_FIELDS:
            x = getattr(self, name)[:n]
            out[name] = (x if x.dtype.itemsize >= 4 else x.float()).cpu(
            ).numpy()
        return out


def history_init(cap: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The zeroed ring: (len(HISTORY_FIELDS), cap) in ``dtype`` on
    ``device``."""
    return torch.zeros((len(HISTORY_FIELDS), int(cap)), dtype=dtype,
                       device=device)


def history_record(ring: torch.Tensor, k: int, active: torch.Tensor,
                   zr, diff, alpha, beta) -> torch.Tensor:
    """Write one iteration's scalars (0-dim device tensors) into column
    ``k`` (a host int) of ``ring`` where the device bool ``active`` is
    true, and keep the column (zeros past ``iters``) where it is false; in
    place, with no host read. Every operand is a device tensor: a Python
    scalar here would be copied from pageable host memory, a copy that
    waits for the device every body. Returns ``ring``."""
    vals = torch.stack([zr, diff, alpha, beta]).to(ring.dtype)
    ring[:, k] = torch.where(active, vals, ring[:, k])
    return ring


def trace_of(ring: torch.Tensor, iters: torch.Tensor) -> ConvergenceTrace:
    """View a ring as a ConvergenceTrace (rows as (cap,) views)."""
    return ConvergenceTrace(iters, *ring)

