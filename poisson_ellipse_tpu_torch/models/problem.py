"""Problem specification for the fictitious-domain Poisson solve.

The port's own copy of ``poisson_ellipse_tpu.models.problem``: the same
frozen dataclass, field for field, so a ``Problem`` built with the same
arguments in either package describes the same discretisation (the tests
hold the two equal property by property).

Reference constants: ``stage0/Withoutopenmp1.cpp:9-11`` (A1/B1/A2/B2/F_VAL),
``:107-108`` (h1/h2/eps), ``:182`` (max_iter = (M-1)(N-1)), ``:178``
(delta = 1e-6).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Problem:
    """Discretisation of -Δu = f on D = {x² + 4y² < 1} ⊂ Ω = [a1,b1]×[a2,b2].

    M, N       : number of grid cells in x / y; nodes are 0..M × 0..N.
    norm       : convergence-norm convention for ‖w^{k+1} − w^k‖:
                 "weighted"   → sqrt(Σ dw² · h1·h2)  (stages 1-4)
                 "unweighted" → sqrt(Σ dw²)          (stage0 variant 1)
                 Iteration-count oracles: unweighted 17/31/61 at
                 10²/20²/40²; weighted 15/26/50.
    delta      : stopping threshold on the norm above (1e-6 in all stages).
    eps        : fictitious-domain penetration parameter; default
                 max(h1,h2)².
    max_iter   : PCG iteration cap; default (M-1)(N-1).
    """

    M: int
    N: int
    a1: float = -1.0
    b1: float = 1.0
    a2: float = -0.6
    b2: float = 0.6
    f_val: float = 1.0
    delta: float = 1e-6
    norm: str = "weighted"
    eps: Optional[float] = None
    max_iter: Optional[int] = None

    def __post_init__(self) -> None:
        if self.M < 2 or self.N < 2:
            raise ValueError("need M >= 2 and N >= 2 for a nonempty interior")
        if self.norm not in ("weighted", "unweighted"):
            raise ValueError(f"unknown norm convention: {self.norm!r}")
        if self.eps is not None and self.eps <= 0:
            raise ValueError("eps must be positive (or None for the default)")

    @property
    def h1(self) -> float:
        return (self.b1 - self.a1) / self.M

    @property
    def h2(self) -> float:
        return (self.b2 - self.a2) / self.N

    @property
    def eps_value(self) -> float:
        if self.eps is not None:
            return self.eps
        h = max(self.h1, self.h2)
        return h * h

    @property
    def max_iterations(self) -> int:
        if self.max_iter is not None:
            return self.max_iter
        return (self.M - 1) * (self.N - 1)

    @property
    def node_shape(self) -> tuple[int, int]:
        """Shape of the full node grid including the Dirichlet boundary."""
        return (self.M + 1, self.N + 1)
