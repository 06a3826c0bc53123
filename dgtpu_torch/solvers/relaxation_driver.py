"""Standalone-smoother solves with residual tracking and a divergence
guard (port of ``dgtpu/solvers/relaxation_driver.py``).

Reference: ``Solver.solve_smoother`` (solver.py:61-66) and the
residual-tracked ``block_gauss_seidel_pyamg`` loop (relaxation.py:197-218):
sweep until the normalized residual drops below 1e-6, diverges above 1e10,
or ``max_iterations`` is reached.  A host loop; divergence returns a status
code instead of ``exit()``.

Status codes: 0 = converged, 1 = max iterations, 2 = diverged.
"""

import math

import torch

from dgtpu_torch.ops.smoothers import (SMOOTHER_ALIASES, apply_smoother,
                                       block_diag_inv, estimate_rho_dinv_a,
                                       normalize_smoother_name, sweep_fronts)
from dgtpu_torch.utils.norms import lp_norm


def _setup(op, name, strategy, Dinv):
    """(Dinv, eig_max, fronts, whether Chebyshev) one smoother needs."""
    kind = SMOOTHER_ALIASES[normalize_smoother_name(name)]
    if Dinv is None:
        Dinv = block_diag_inv(op)
    # chebyshev: rho(D^-1 A) is estimated by power iteration at setup
    eig_max = 1.1 * estimate_rho_dinv_a(op, Dinv) if kind == "cheby" else None
    fronts = ((sweep_fronts(op), sweep_fronts(op, backward=True))
              if kind == "gs" and strategy != "redblack" else None)
    return Dinv, eig_max, fronts, kind == "cheby"


def residual_tracked_smoother(op, rhs, u0=None, name="block_gauss_seidel",
                              direction="symmetric", max_iterations=100,
                              tol=1e-6, div_tol=1e10, omega=1.0,
                              strategy="sequential", colors=None, Dinv=None,
                              degree=3):
    """Sweep-until-converged smoother solve; returns (u, residuals, n,
    status).  ``residuals[i]`` is the normalized residual after sweep i + 1.
    ``degree`` is the Chebyshev polynomial degree applied per tracked sweep
    (ignored for other smoothers)."""
    u = torch.zeros_like(rhs) if u0 is None else u0
    Dinv, eig_max, fronts, is_cheby = _setup(op, name, strategy, Dinv)
    max_iterations = int(max_iterations)
    res0 = float(lp_norm(rhs - op.matvec(u), 2))
    res = 1.0
    history = []
    n = 0
    while n < max_iterations and tol <= res <= div_tol and math.isfinite(res):
        u = apply_smoother(name, op, rhs, u, direction=direction, omega=omega,
                           iterations=int(degree) if is_cheby else 1, Dinv=Dinv,
                           strategy=strategy, colors=colors, eig_max=eig_max,
                           fronts=fronts)
        res = float(lp_norm(rhs - op.matvec(u), 2)) / res0
        history.append(res)
        n += 1
    return u, history, n, tracked_status(res, tol, div_tol)


def tracked_status(res, tol, div_tol):
    """Status of a tracked solve that ended at normalized residual ``res``:
    0 converged, 2 diverged (a NaN/Inf residual included), else 1."""
    if res < tol:
        return 0
    if res > div_tol or not math.isfinite(res):
        return 2
    return 1


def fixed_sweeps_smoother(op, rhs, u0=None, name="block_gauss_seidel",
                          direction="symmetric", iterations=100, omega=1.0,
                          strategy="sequential", colors=None):
    """The reference's non-tracked path: exactly N sweeps (solver.py:65)."""
    u = torch.zeros_like(rhs) if u0 is None else u0
    Dinv, eig_max, fronts, _ = _setup(op, name, strategy, None)
    return apply_smoother(name, op, rhs, u, direction=direction, omega=omega,
                          iterations=int(iterations), Dinv=Dinv,
                          strategy=strategy, colors=colors, eig_max=eig_max,
                          fronts=fronts)
