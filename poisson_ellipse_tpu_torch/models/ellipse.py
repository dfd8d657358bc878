"""Elliptic domain D = {x² + 4y² < 1} (reference "variant 9"), vectorised.

The same closed forms as ``poisson_ellipse_tpu.models.ellipse``. Every
function that needs an array module takes ``xp``: ``numpy`` for the f64
host assembly, ``torch`` for expressions over device tensors. Branches
are ``where``; square roots are clamped at zero first.
"""

from __future__ import annotations

import numpy as np


def safe_sqrt(v, xp=np):
    """sqrt clamped at zero, with the clamp inside a ``where`` on both
    branches (the form that keeps a reverse-mode gradient finite at 0)."""
    positive = v > 0.0
    return xp.where(positive, xp.sqrt(xp.where(positive, v, 1.0)), 0.0)


def is_in_d(x, y):
    """Membership mask of the open ellipse x² + 4y² < 1
    (``stage0/Withoutopenmp1.cpp:14-16``)."""
    return x * x + 4.0 * y * y < 1.0


def analytic_solution(x, y):
    """The exact solution u = (1 − x² − 4y²)/10 of -Δu = 1 on D, u|∂D = 0."""
    return (1.0 - x * x - 4.0 * y * y) / 10.0


def segment_length_vertical(x0, y_start, y_end, xp=np):
    """Length of {x0} × [y_start, y_end] ∩ D
    (``stage0/Withoutopenmp1.cpp:21-28``)."""
    y_max = safe_sqrt((1.0 - x0 * x0) / 4.0, xp)
    length = xp.maximum(
        xp.zeros_like(y_max),
        xp.minimum(y_end, y_max) - xp.maximum(y_start, -y_max),
    )
    return xp.where(xp.abs(x0) >= 1.0, 0.0, length)


def segment_length_horizontal(y0, x_start, x_end, xp=np):
    """Length of [x_start, x_end] × {y0} ∩ D
    (``stage0/Withoutopenmp1.cpp:29-37``)."""
    x_max = safe_sqrt(1.0 - 4.0 * y0 * y0, xp)
    length = xp.maximum(
        xp.zeros_like(x_max),
        xp.minimum(x_end, x_max) - xp.maximum(x_start, -x_max),
    )
    return xp.where(xp.abs(2.0 * y0) >= 1.0, 0.0, length)
