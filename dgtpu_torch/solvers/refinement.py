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
float64 defect (dgtpu's ``_make_f64_solver``) and has no df32.

The inner solve is ``n_inner`` cycles from zero, or ``n_inner`` steps of
float32 GMRES right-preconditioned by one cycle (``inner='gmres'``), which
converges where the stand-alone cycle iteration does not (deep Stokes
hierarchies).
"""

import math

import torch

from dgtpu_torch.utils.norms import lp_norm


def make_refined_solver(op64, cycle32, n_inner=8, tol=1e-10, max_outer=20,
                        normalize="u0", inner="cycles", matvec32=None):
    """Build the mixed-precision solver.

    ``op64``: the float64 operator (``matvec``).  ``cycle32(rhs32, u32)``:
    one float32 cycle.  ``normalize``: 'u0' divides residuals by
    ||b - A u0|| (the relative criterion for a zero guess); 'rhs' divides by
    ||b|| — use it when u0 is an FMG guess, so the tolerance keeps its
    relative-to-zero-iterate meaning.  ``inner``: 'cycles' applies
    ``n_inner`` cycles from zero to each defect; 'gmres' runs ``n_inner``
    steps of float32 GMRES preconditioned by one cycle (needs
    ``matvec32``, the float32 operator).

    Returns solve(rhs64, u0) -> (u, res, n_outer, history): ``history`` is
    the list of normalized residuals, one per outer round plus the last.
    """
    if normalize not in ("u0", "rhs"):
        raise ValueError(normalize)
    if inner not in ("cycles", "gmres"):
        raise ValueError(inner)
    if inner == "gmres":
        if matvec32 is None:
            raise ValueError("inner='gmres' requires matvec32 (the f32 "
                             "operator matvec)")
        inner_solve = _make_gmres_inner(matvec32, cycle32, n_inner)
    else:
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


def gmres_correction(AM, M, r, m, dot=None, norm=None):
    """e = M z, where z approximately minimizes ``||r - A M z||`` over the
    m-step Krylov space: the correction step of right-preconditioned
    GMRES(m) with a zero initial guess (dgtpu's ``gmres_correction``).

    ``AM(x)`` applies the preconditioned operator A M; ``M(x)`` the
    preconditioner alone (one multigrid cycle from zero).  Modified
    Gram-Schmidt Arnoldi, then an explicit Givens QR of the (m+1) x m
    Hessenberg matrix and back-substitution; a happy breakdown or a zero
    pivot drops that direction.  Right preconditioning keeps the minimized
    residual that of the true system."""
    dot = torch.dot if dot is None else dot
    norm = torch.linalg.norm if norm is None else norm
    dt = r.dtype
    tiny = torch.tensor(1e-35 if dt == torch.float32 else 1e-300, dtype=dt,
                        device=r.device)

    beta = norm(r)
    V = [r / torch.maximum(beta, tiny)]
    H = torch.zeros((m + 1, m), dtype=dt, device=r.device)
    for j in range(m):
        w = AM(V[j])
        for i in range(j + 1):                  # modified Gram-Schmidt
            hij = dot(V[i], w).to(dt)
            H[i, j] = hij
            w = w - hij * V[i]
        hj1 = norm(w).to(dt)
        H[j + 1, j] = hj1
        V.append((hj1 > tiny).to(dt) * w / torch.maximum(hj1, tiny))
    g = torch.zeros((m + 1,), dtype=dt, device=r.device)
    g[0] = beta
    R = H
    for j in range(m):
        a, b = R[j, j], R[j + 1, j]
        safe = torch.maximum(torch.sqrt(a * a + b * b), tiny)
        c, s = a / safe, b / safe
        row_j, row_j1 = c * R[j] + s * R[j + 1], -s * R[j] + c * R[j + 1]
        R[j], R[j + 1] = row_j, row_j1
        gj, gj1 = c * g[j] + s * g[j + 1], -s * g[j] + c * g[j + 1]
        g[j], g[j + 1] = gj, gj1
    y = [None] * m
    for i in reversed(range(m)):
        acc = g[i]
        for k in range(i + 1, m):
            acc = acc - R[i, k] * y[k]
        ok = R[i, i].abs() > tiny
        y[i] = torch.where(ok, acc / torch.where(ok, R[i, i], torch.ones_like(acc)),
                           torch.zeros_like(acc))
    z = sum(y[j] * V[j] for j in range(m))
    return M(z)


def _make_gmres_inner(matvec32, cycle32, n_inner):
    """inner_solve(r32) -> e32 via ``gmres_correction`` over the float32
    cycle."""

    def inner_solve(r32):
        dt = r32.dtype

        def M(x):
            return cycle32(x, torch.zeros_like(x)).to(dt)

        def AM(x):
            return matvec32(M(x)).to(dt)

        return gmres_correction(AM, M, r32, n_inner)

    return inner_solve
