"""Phase timers: the reference's init / solver / finalize split.

On a CUDA device a phase is timed with CUDA events recorded on the
current stream around it and closed by the fence
``torch.cuda.synchronize()``. On the CPU the host clock is the only
clock and there is nothing to fence. Every measurement is also a
``phase:<name>`` span on the ambient trace (``obs.trace``; a no-op when
tracing is off), as the JAX package's ``PhaseTimer`` emits it.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

from poisson_ellipse_tpu_torch.obs import trace as _trace


@dataclass
class PhaseTimer:
    """Named accumulators of seconds, one per phase."""

    device: torch.device = torch.device("cpu")
    totals: dict[str, float] = field(default_factory=dict)

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        _trace.span_event(f"phase:{name}", seconds)

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            torch.cuda.synchronize(self.device)
            self.add(name, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            yield
            self.add(name, time.perf_counter() - t0)
