"""Spectral diagnostics from the CG trace: κ(M⁻¹A) without touching A.

A copy of ``poisson_ellipse_tpu.obs.spectrum`` (pure Python and numpy).

CG is a Lanczos process in disguise: the α/β coefficients the solver
already records on device (``obs.convergence``) determine the Lanczos
tridiagonal T_m of the preconditioned operator M⁻¹A in the M-inner
product (Golub & Van Loan §10.2; the same three-term recurrence the
Ghysels–Vanroose pipelined engine reorders). Its eigenvalues — the Ritz
values — approximate the operator's spectrum, the extremal ones first,
so a converged solve's trace yields the condition number κ(M⁻¹A) for
free. That number is what the iteration-count wall (546 @ 400×600 →
5889 @ 8192², BENCH_r05) *is*: iterations scale as √κ, and any future
preconditioner (multigrid/Chebyshev — ROADMAP item 1) must prove it
moved κ, not just anecdotes. This module is the yardstick.

Everything here is host-side numpy over a handful of scalars per
iteration — no solve, no device work, O(m²) at worst for the m-step
eigendecomposition (milliseconds for the bench grids).

Three layers:

- :func:`lanczos_tridiagonal` — (diagonal, off-diagonal) of T_m from a
  :class:`~poisson_ellipse_tpu_torch.obs.convergence.ConvergenceTrace`,
  skipping the exact-0 α entries a breakdown iteration records (its
  update is discarded; 1/α is undefined for it) and the zero-filled
  tail past ``iters``.
- :func:`ritz_values` / :func:`spectrum_report` — Ritz values, κ
  estimate (measured exact to the dense-eigendecomposition oracle on
  small grids — pinned within 10% in ``tests/test_spectrum.py``), the
  asymptotic CG rate (√κ−1)/(√κ+1), the worst-case κ-bound iteration
  count, and the *sharp* prediction: scalar CG replayed on the Ritz
  model problem (:func:`predicted_iterations`). CG's actual iteration
  count sits far below the κ bound (superlinear convergence — measured
  ~75% below at 400×600); the model-problem replay reproduces it
  because T_m carries the whole spectral measure, not just its edges,
  and it extrapolates to tolerances the solve never reached.
- :func:`detect_plateaus` / stagnation flags — spans where the
  step-norm stopped making progress, the trace-level symptom the
  resilience guard's per-chunk stagnation word detects in flight.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "cg_coefficients",
    "detect_plateaus",
    "eigenvalue_bounds",
    "lanczos_tridiagonal",
    "predicted_iterations",
    "ritz_decomposition",
    "ritz_values",
    "spectrum_report",
]

# Ritz values are INTERIOR estimates of the spectrum (λ_min is
# overestimated, λ_max underestimated, both converging outward as the
# Lanczos process runs), so consumers that need a covering interval —
# the Chebyshev setup in ``mg.cheby`` — widen by these defaults. λ_min
# of an ill-conditioned operator converges slowest, hence the larger
# slack on that side; λ_max of the Jacobi-preconditioned 5-point
# operator is provably ≤ 2 (Gershgorin: row center 1, radius ≤ 1), so
# the high side needs only a trim.
LMIN_SLACK = 0.5
LMAX_SLACK = 1.05


def eigenvalue_bounds(
    trace, lo_slack: float = LMIN_SLACK, hi_slack: float = LMAX_SLACK,
) -> tuple[float, float] | None:
    """(λ_lo, λ_hi) covering the spectrum of M⁻¹A, from a CG trace.

    The single source the Chebyshev/multigrid setup consumes
    (``mg.cheby``) and ``harness diagnose`` reports — one Lanczos
    reconstruction, not two. The extremal Ritz values are widened by
    the slack factors (see above) into an interval the true spectrum
    sits inside for any usably long trace. Returns None when the trace
    yields no usable positive spectrum (the caller falls back to the
    Gershgorin interval).
    """
    vals = ritz_values(trace)
    if vals.size == 0:
        return None
    lmin, lmax = float(vals[0]), float(vals[-1])
    if not (math.isfinite(lmin) and math.isfinite(lmax)) or lmin <= 0:
        return None
    return lmin * lo_slack, lmax * hi_slack


def _valid_series(trace) -> dict:
    """{field: float64 array of the valid entries} from a trace or a
    ``trace.valid()``-shaped dict (host-side callers may hold either)."""
    v = trace if isinstance(trace, dict) else trace.valid()
    return {k: np.asarray(val, dtype=np.float64) for k, val in v.items()}


def cg_coefficients(trace) -> tuple[np.ndarray, np.ndarray]:
    """(α, β) aligned and cleaned for the Lanczos reconstruction.

    Two trace conventions feed this, both recorded by
    ``obs.convergence``:

    - the classical engines record (α_k, β_k) computed at iteration k;
    - the pipelined recurrence records β one step earlier by its
      documented reordering, so its series leads with an exact 0 (no
      direction update built iteration 1's p). That sentinel is the
      realignment signature: drop it and the remaining β_j pair with
      α_j exactly as the classical series does.

    The series is then truncated at the first entry that cannot be a
    genuine CG coefficient: α must be finite and > 0 (a breakdown
    iteration discards its update and records α = 0 — terminal by the
    loop contract), β finite and > 0 (β = zr_new/zr of positive inner
    products; a poisoned f32 trace fails here). Truncation, not
    skipping — the recurrence after a corrupt step is meaningless.
    Returns (α of the m usable steps, β with ≥ m−1 entries).
    """
    v = _valid_series(trace)
    alpha, beta = v["alpha"], v["beta"]
    if beta.size and beta[0] == 0.0:
        beta = beta[1:]  # the pipelined one-step shift
    bad_a = np.nonzero(~(np.isfinite(alpha) & (alpha > 0)))[0]
    bad_b = np.nonzero(~(np.isfinite(beta) & (beta > 0)))[0]
    m = alpha.size
    if bad_a.size:
        m = min(m, int(bad_a[0]))
    if bad_b.size:
        # beta[j] first couples steps j and j+1: alpha stays usable
        # through index bad_b[0]
        m = min(m, int(bad_b[0]) + 1)
    return alpha[:m], beta[: max(m - 1, 0)]


def lanczos_tridiagonal(trace) -> tuple[np.ndarray, np.ndarray]:
    """(diagonal d, off-diagonal e) of the Lanczos matrix T_m.

    The textbook change of basis from the CG two-term recurrences:

        d_1 = 1/α_1,   d_j = 1/α_j + β_{j-1}/α_{j-1}   (j ≥ 2)
        e_j = √β_j / α_j                                 (j ≤ m−1)

    T_m is similar to the projection of M⁻¹A onto the Krylov space, so
    its eigenvalues estimate the *preconditioned* spectrum — the one
    that governs the iteration count.
    """
    alpha, beta = cg_coefficients(trace)
    m = alpha.size
    if m == 0:
        return np.empty(0), np.empty(0)
    beta = beta[: m - 1]
    d = np.empty(m)
    d[0] = 1.0 / alpha[0]
    if m > 1:
        d[1:] = 1.0 / alpha[1:] + beta / alpha[: m - 1]
    e = np.sqrt(beta) / alpha[: m - 1]
    return d, e


def _eigh_tridiagonal(d: np.ndarray, e: np.ndarray, vectors: bool = False):
    """Eigen-decomposition of a symmetric tridiagonal, scipy-accelerated
    when available (O(m²)); dense numpy otherwise. Host-side math only —
    the module must work wherever numpy does."""
    try:
        from scipy.linalg import eigh_tridiagonal

        if vectors:
            return eigh_tridiagonal(d, e)
        return eigh_tridiagonal(d, e, eigvals_only=True), None
    except ImportError:
        t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
        if vectors:
            return np.linalg.eigh(t)
        return np.linalg.eigvalsh(t), None


def ritz_values(trace) -> np.ndarray:
    """Ascending Ritz values of M⁻¹A from the trace (empty when the
    trace holds no usable iteration)."""
    vals, _ = ritz_decomposition(trace)
    return vals


def ritz_decomposition(
    trace, max_steps: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """(ascending Ritz values θ, T_m eigenvectors Y) — the vectors form.

    ``Y[:, i]`` expresses the i-th Ritz vector in the Lanczos basis of
    the Krylov space the solve walked, so any stored spanning set of
    that space (``solver.recycle``'s direction ring) turns it into an
    approximate Ritz vector of M⁻¹A: the deflation basis W = P·Y that
    Krylov recycling projects out of the *next* related solve. Returns
    ``(empty, empty)`` when the trace holds no usable step; columns are
    sorted with their values.

    ``max_steps`` truncates the reconstruction to the leading Lanczos
    steps — T_j is itself the Lanczos matrix of the j-step process, so
    a consumer holding only the first j basis vectors (a bounded
    direction ring) gets the decomposition matching what it stored
    rather than coefficients it cannot apply.
    """
    d, e = lanczos_tridiagonal(trace)
    if max_steps is not None and d.size > max_steps:
        d, e = d[:max_steps], e[: max(max_steps - 1, 0)]
    if d.size == 0:
        return np.empty(0), np.empty((0, 0))
    vals, vecs = _eigh_tridiagonal(d, e, vectors=True)
    order = np.argsort(vals)
    if vecs is None:  # unreachable with both scipy and numpy backends
        vecs = np.eye(d.size)
    return vals[order], vecs[:, order]


def extremal_indices(m: int, k: int) -> np.ndarray:
    """Indices of the ``k`` extremal entries of an ascending length-``m``
    spectrum: the low end first (the modes that dominate CG's iteration
    count), the top for the remainder (the cut-cell outliers the
    fictitious-domain blend creates). The one selection rule shared by
    the recycling harvest (``solver.recycle``) and the deflated
    predictor below — the prediction must model the same modes the
    deflation removes."""
    k = max(0, min(int(k), int(m)))
    lo = (k + 1) // 2
    hi = k - lo
    return np.concatenate(
        [np.arange(lo), np.arange(m - hi, m)]
    ).astype(np.intp)


def predicted_iterations(
    trace, delta: float, diff0: float | None = None,
    max_model_iters: int | None = None, deflated_k: int = 0,
) -> int | None:
    """Iterations until the step norm crosses ``delta``, predicted by
    replaying scalar CG on the Ritz model problem.

    T_m = V Θ Vᵀ defines a diagonal model system (eigenvalues Θ, initial
    residual weights V[0,:]²) on which CG produces the *same* scalar
    trajectory the real solve did for its first m steps — so the
    model's step-norm crossing of ``delta/diff0`` (``diff0`` defaults to
    the trace's first recorded step norm) is a sharp iteration
    prediction, unlike the worst-case κ bound (which ignores the
    interior of the spectrum and overpredicts ~75% here). Returns None
    when the model never reaches the target within ``max_model_iters``
    (default 4m) — e.g. a tolerance beyond what m Ritz values resolve.

    The base model assumes a ZERO initial guess — the prediction for a
    warm-started (recycled) solve would be dishonest. ``deflated_k``
    makes it honest for the deflated warm start ``solver.recycle``
    builds: the k extremal Ritz components (``extremal_indices`` — the
    same modes the harvest keeps) are removed from the model's initial
    residual, so the replay runs on the deflated interval and predicts
    the recycled solve, not the cold one.
    """
    v = _valid_series(trace)
    if diff0 is None:
        diff0 = float(v["diff"][0]) if v["diff"].size else None
    if not diff0 or diff0 <= 0 or delta <= 0:
        return None
    d, e = lanczos_tridiagonal(trace)
    m = d.size
    if m == 0:
        return None
    theta, vecs = _eigh_tridiagonal(d, e, vectors=True)
    weights = vecs[0, :] ** 2 if vecs is not None else np.full(m, 1.0 / m)
    if deflated_k > 0:
        if deflated_k >= m:
            return None  # the whole model deflated: nothing left to predict
        weights = weights.copy()
        weights[extremal_indices(m, deflated_k)] = 0.0
        if not np.any(weights > 0):
            return None
    # scalar CG on A = diag(θ) with r0 components √w — exact arithmetic
    # (f64), no arrays bigger than m
    r = np.sqrt(np.maximum(weights, 0.0))
    p = r.copy()
    zr = float(r @ r)
    target_ratio = delta / diff0
    first_step = None
    cap = max_model_iters if max_model_iters is not None else 4 * m
    for k in range(1, cap + 1):
        ap = theta * p
        denom = float(p @ ap)
        if denom <= 0 or zr <= 0:
            return None
        step_alpha = zr / denom
        r = r - step_alpha * ap
        step = abs(step_alpha) * math.sqrt(float(p @ p))
        if first_step is None:
            first_step = step
        if first_step > 0 and step < target_ratio * first_step:
            return k
        zr_new = float(r @ r)
        if zr_new <= 0:
            return None
        p = r + (zr_new / zr) * p
        zr = zr_new
    return None


def detect_plateaus(
    diff: np.ndarray, window: int | None = None, drop: float = 0.9
) -> list[tuple[int, int]]:
    """Spans (start, end) — end exclusive — where the step norm's
    RUNNING MINIMUM failed to shrink below ``drop`` × its value
    ``window`` iterations earlier.

    Two calibration facts from the published-grid traces drive the
    defaults. The raw series is the wrong thing to test: f32 step norms
    oscillate iteration to iteration, so the running best is what
    stalls when the system stalls. And healthy CG *locally* stalls the
    running best for real stretches (measured: 85 consecutive
    no-improvement iterations inside the perfectly healthy 989-count
    800×1200 run) — a fixed window cries wolf on big grids, so the
    default window scales with the trace: ``max(32, n // 4)``, where
    the same healthy runs' worst window ratio is ≤ 0.41 against the
    0.9 threshold. A flagged span therefore means a quarter of the run
    passed without 10% progress — the trace-level version of the
    resilience guard's per-chunk stagnation word.
    """
    diff = np.asarray(diff, dtype=np.float64)
    n = diff.size
    if window is None:
        window = max(32, n // 4)
    if n <= window:
        return []
    best = np.minimum.accumulate(diff)
    flat = best[window:] >= drop * best[:-window]
    spans: list[tuple[int, int]] = []
    start = None
    for i, is_flat in enumerate(flat):
        k = i + window
        if is_flat and start is None:
            start = k
        elif not is_flat and start is not None:
            spans.append((start, k))
            start = None
    if start is not None:
        spans.append((start, n))
    return spans


def spectrum_report(
    trace, delta: float, actual_iters: int | None = None,
    plateau_window: int | None = None, deflated_k: int = 0,
) -> dict:
    """One JSON-able spectral record for a solve's trace.

    Keys: ``available``; ``iters`` (recorded) / ``lanczos_m`` (usable
    steps); ``lambda_min`` / ``lambda_max`` / ``kappa`` of M⁻¹A;
    ``cg_rate`` = (√κ−1)/(√κ+1); ``iters_bound`` — the worst-case
    κ-bound count ln(δ/diff₀)/ln(1/rate) (an upper envelope, not a
    prediction); ``predicted_iters`` — the sharp Ritz-model replay;
    ``predicted_err`` vs ``actual_iters`` (defaults to the trace's
    iteration count); ``plateaus`` spans and the ``stagnated`` flag.

    ``deflated_k`` > 0 marks the trace as feeding a k-mode Krylov-
    recycled warm start (``solver.recycle``): ``predicted_iters`` is
    then the DEFLATED-interval replay and the record carries an extra
    ``predicted_iters_recycled`` alongside the cold prediction — a
    recycled solve judged against the zero-start prediction would read
    as a false regression (or a false win) in ``harness diagnose``.
    """
    v = _valid_series(trace)
    n = int(v["diff"].size)
    if actual_iters is None:
        actual_iters = n
    base = {"available": False, "iters": n, "lanczos_m": 0}
    if n == 0:
        return base
    d, e = lanczos_tridiagonal(trace)
    m = int(d.size)
    if m == 0:
        return base
    vals, _ = _eigh_tridiagonal(d, e)
    lmin, lmax = float(vals.min()), float(vals.max())
    if not (math.isfinite(lmin) and math.isfinite(lmax)) or lmin <= 0:
        return {**base, "lanczos_m": m}
    kappa = lmax / lmin  # unrounded: the dense-oracle tests pin digits
    sq = math.sqrt(kappa)
    rate = (sq - 1.0) / (sq + 1.0)
    diff0 = float(v["diff"][0])
    iters_bound = None
    if 0 < rate < 1 and diff0 > 0 and 0 < delta < diff0:
        iters_bound = int(math.ceil(math.log(delta / diff0) / math.log(rate)))
    cold = predicted_iterations(trace, delta, diff0=diff0)
    recycled = (
        predicted_iterations(trace, delta, diff0=diff0,
                             deflated_k=deflated_k)
        if deflated_k > 0 else None
    )
    predicted = recycled if deflated_k > 0 else cold
    plateaus = detect_plateaus(v["diff"], window=plateau_window)
    return {
        "available": True,
        "iters": n,
        "lanczos_m": m,
        "lambda_min": lmin,
        "lambda_max": lmax,
        "kappa": kappa,
        "cg_rate": rate,
        "iters_bound": iters_bound,
        "predicted_iters": predicted,
        "actual_iters": int(actual_iters),
        "predicted_err": (
            round(predicted / actual_iters - 1.0, 4)
            if predicted is not None and actual_iters
            else None
        ),
        **(
            {"deflated_k": int(deflated_k),
             "predicted_iters_cold": cold,
             "predicted_iters_recycled": recycled}
            if deflated_k > 0 else {}
        ),
        "plateaus": [[int(a), int(b)] for a, b in plateaus],
        "stagnated": bool(plateaus),
    }


def render_report(rep: dict) -> str:
    """Human-readable form of one :func:`spectrum_report` record (the
    spectral half of ``harness diagnose``)."""
    if not rep.get("available"):
        return (
            f"spectrum: unavailable ({rep.get('iters', 0)} iterations "
            "recorded, no usable Lanczos step)"
        )
    lines = [
        f"spectrum ({rep['lanczos_m']} Lanczos steps from "
        f"{rep['iters']} iterations):",
        f"  lambda(M^-1 A)        [{rep['lambda_min']:.6g}, "
        f"{rep['lambda_max']:.6g}]",
        f"  kappa                 {rep['kappa']:.6g}",
        f"  asymptotic CG rate    {rep['cg_rate']:.6f}  "
        "((sqrt(k)-1)/(sqrt(k)+1))",
    ]
    if rep.get("iters_bound") is not None:
        lines.append(
            f"  kappa-bound iters     {rep['iters_bound']}  (worst case)"
        )
    if rep.get("predicted_iters") is not None:
        err = rep.get("predicted_err")
        model = (
            f"deflated Ritz-model replay, k={rep['deflated_k']}"
            if rep.get("deflated_k") else "Ritz-model replay"
        )
        lines.append(
            f"  predicted iters       {rep['predicted_iters']}  "
            f"({model}; actual {rep['actual_iters']}"
            + (f", {err:+.1%}" if err is not None else "")
            + ")"
        )
    elif rep.get("deflated_k"):
        lines.append(
            "  predicted iters       n/a (warm start deflated past the "
            "model's resolution — cold prediction skipped as dishonest)"
        )
    if rep.get("plateaus"):
        spans = ", ".join(f"{a}..{b}" for a, b in rep["plateaus"])
        lines.append(f"  plateaus              {spans} (STAGNATION)")
    else:
        lines.append("  plateaus              none")
    return "\n".join(lines)
