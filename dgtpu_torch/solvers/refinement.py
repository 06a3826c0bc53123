"""Mixed-precision iterative refinement: float64 accuracy from float32 cycles
(port of ``dgtpu/solvers/refinement.py``).

Classic defect correction::

    loop:  r = b - A u            (float64, ONE matvec per outer step)
           e ~ A^-1 r             (k float32 multigrid cycles — the fast path)
           u = u + e              (float64 accumulation)

The float32 inner solve only has to reduce the defect by ~1e-6 per outer
step, so the outer loop reaches 1e-10 in a handful of rounds.

The defect is native float64.  dgtpu's default ``defect='auto'`` picks a
compensated double-single (df32) residual because float64 on a TPU is
emulated; the H100 computes float64 natively, so the port keeps the plain
float64 defect (dgtpu's ``_make_f64_solver``) and has no df32.  The
GMRES-wrapped inner solve waits for Stokes (ROADMAP Queue 1 item 9).
"""

import math

import torch

from dgtpu_torch.utils.norms import lp_norm


def make_refined_solver(op64, cycle32, n_inner=8, tol=1e-10, max_outer=20,
                        normalize="u0"):
    """Build the mixed-precision solver.

    ``op64``: the float64 operator (``matvec``).  ``cycle32(rhs32, u32)``:
    one float32 cycle.  ``normalize``: 'u0' divides residuals by
    ||b - A u0|| (the relative criterion for a zero guess); 'rhs' divides by
    ||b|| — use it when u0 is an FMG guess, so the tolerance keeps its
    relative-to-zero-iterate meaning.  The inner solve applies ``n_inner``
    cycles from zero to each defect (dgtpu's ``inner='cycles'``).

    Returns solve(rhs64, u0) -> (u, res, n_outer, history): ``history`` is
    the list of normalized residuals, one per outer round plus the last.
    """
    if normalize not in ("u0", "rhs"):
        raise ValueError(normalize)

    def inner_solve(r32):
        e = torch.zeros_like(r32)
        for _ in range(n_inner):
            e = cycle32(r32, e)
        return e

    def solve(rhs, u0):
        r = rhs - op64.matvec(u0)
        res0 = float(lp_norm(rhs if normalize == "rhs" else r, 2))
        u = u0
        res = float(lp_norm(r, 2)) / res0
        history = []
        n = 0
        while n < max_outer and res >= tol and math.isfinite(res):
            history.append(res)
            e32 = inner_solve(r.to(torch.float32))
            u = u + e32.to(rhs.dtype)
            r = rhs - op64.matvec(u)
            res = float(lp_norm(r, 2)) / res0
            n += 1
        history.append(res)
        return u, res, n, history

    return solve
