"""Preconditioned Krylov solvers, the ``-k`` route (port of
``dgtpu/solvers/krylov.py``).

The reference's Krylov path is marked broken (``solver.py:79-112``: lgmres
with a dense-inverted block preconditioner that never converged).  dgtpu
re-derives it, and this module follows dgtpu:

* Poisson: CG (the SIP operator is SPD when not mass-premultiplied) or
  GMRES, preconditioned by the element-block-diagonal inverse, one SA-AMG
  V-cycle or one multigrid cycle of the ``solver.multigrid`` hierarchy.
* Stokes (global order): GMRES with the block-diagonal
  P = [[diag_block(A), 0], [0, -S_hat]] preconditioner, S_hat = D diag(A)^-1 G
  approximating the (negative) pressure Schur complement, or with one
  multigrid cycle.

dgtpu calls ``jax.scipy.sparse.linalg.cg`` and ``gmres``; ``cg`` and
``gmres`` here are those two solvers written in torch with JAX's semantics
(float64 plain torch on the operator's device, a host read of the stopping
test per iteration, or per restart for GMRES):

* ``cg`` uses SciPy's "non-legacy" tolerance: it stops when r.r falls to
  max(tol^2 b.b, atol^2);
* ``gmres`` is JAX's ``solve_method='batched'``: left-preconditioned, each
  restart builds the whole ``restart``-dimensional Arnoldi basis (one
  classical Gram-Schmidt pass, stopping early only on breakdown) and solves
  the least-squares problem by Cholesky of its normal equations; restarts
  stop when the preconditioned residual ||M(b - A x)|| falls to
  max(tol ||b||, atol);
* ``maxiter`` counts CG steps or GMRES restarts and defaults to 10 x size.

All knobs come from the ``solver.krylov`` paramfile section
(``method | preconditioner | tolerance | absolute tolerance |
max iterations | restart``); explicit keyword arguments override it.  The
final residual is always checked after the solve, with a warning (or an
error, for CG with a multigrid preconditioner) when it misses the
tolerance.
"""

import logging
import math

import numpy as np
import torch

from dgtpu_torch.ops.smoothers import block_diag_inv, normalize_smoother_name
from dgtpu_torch.solvers.amg import build_sa_cycle
from dgtpu_torch.utils.logger import Logger


def _safe_normalize(x, thresh=None):
    """(x / ||x||, ||x||), or (0, 0) when ||x|| is at most ``thresh``
    (default: the dtype's machine epsilon), as JAX's ``_safe_normalize``."""
    norm = torch.sqrt(torch.dot(x, x))
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(use, x / norm, zero), torch.where(use, norm, zero)


def cg(A, b, x0=None, *, tol=1e-5, atol=0.0, maxiter=None, M=None):
    """Preconditioned conjugate gradients with JAX's semantics; returns
    ``(x, k)`` with k the number of CG steps taken."""
    x = torch.zeros_like(b) if x0 is None else x0
    if maxiter is None:
        maxiter = 10 * b.numel()
    atol2 = max(tol ** 2 * float(torch.dot(b, b)), atol ** 2)
    r = b - A(x)
    z = r if M is None else M(r)
    p = z
    gamma = torch.dot(r, z)
    k = 0
    while k < maxiter:
        rs = gamma if M is None else torch.dot(r, r)
        if not float(rs) > atol2:
            break
        Ap = A(p)
        alpha = gamma / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r if M is None else M(r)
        gamma_new = torch.dot(r, z)
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    return x, k


def _gmres_batched(A, M, b, x0, unit_residual, residual_norm, restart):
    """One GMRES restart, JAX's ``_gmres_batched``: the full Arnoldi basis
    (ending early only on breakdown) and the least-squares problem
    ``min ||H^T y - beta e_0||`` by Cholesky of its normal equations.
    Returns the new iterate, the unit preconditioned residual, its norm and
    the Cholesky's ``info`` (0, or the pivot where H H^T stopped being
    positive definite: the iterate is then NaN, as JAX's)."""
    n = b.numel()
    V = torch.zeros((n, restart + 1), dtype=b.dtype, device=b.device)
    V[:, 0] = unit_residual
    H = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device)
    eps = torch.finfo(b.dtype).eps
    for k in range(restart):
        v = M(A(V[:, k]))
        _, v_norm_0 = _safe_normalize(v)
        # one classical Gram-Schmidt pass: JAX's iterative version with
        # max_iterations=2 never takes its second
        h = V.T @ v
        v = v - V @ h
        unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
        V[:, k + 1] = unit_v
        h[k + 1] = v_norm_1
        H[k] = h
        if float(v_norm_1) == 0.0:
            break
    beta_vec = torch.zeros(restart + 1, dtype=b.dtype, device=b.device)
    beta_vec[0] = residual_norm
    L, info = torch.linalg.cholesky_ex(H @ H.T)
    y = torch.cholesky_solve((H @ beta_vec)[:, None], L)[:, 0]
    x = x0 + V[:, :-1] @ y
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)))
    return x, unit_residual, residual_norm, info


def gmres(A, b, x0=None, *, tol=1e-5, atol=0.0, restart=20, maxiter=None, M=None):
    """Restarted, left-preconditioned GMRES with JAX's semantics
    (``solve_method='batched'``); returns ``(x, k)`` with k the number of
    restarts taken."""
    x = torch.zeros_like(b) if x0 is None else x0
    if M is None:
        def M(v):
            return v
    size = b.numel()
    if maxiter is None:
        maxiter = 10 * size
    restart = min(restart, size)
    atol = max(tol * float(torch.sqrt(torch.dot(b, b))), atol)
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)))
    k = 0
    while k < maxiter and float(residual_norm) > atol:
        x, unit_residual, residual_norm, info = _gmres_batched(
            A, M, b, x, unit_residual, residual_norm, restart)
        k += 1
        if int(info):
            logging.getLogger(__name__).warning(
                f"GMRES restart {k}: the normal equations of its least-squares "
                f"problem are not positive definite (Cholesky stops at pivot "
                f"{int(info)}), so the iterate is NaN, as JAX's batched GMRES's")
    return x, k


def _krylov_params(settings, tol, atol, maxiter, restart):
    """Resolve solver.krylov settings; explicit kwargs win over the paramfile."""
    ks = getattr(getattr(settings, "solver", None), "krylov", None)

    def pick(explicit, attr, default, cast):
        if explicit is not None:
            return explicit
        return cast(getattr(ks, attr, default))

    return {
        "method": str(getattr(ks, "method", "gmres")).lower(),
        "precond": str(getattr(ks, "preconditioner", "block_diagonal")),
        "tol": pick(tol, "tolerance", 1e-8, float),
        "atol": pick(atol, "absolute_tolerance", 1e-5, float),
        "maxiter": pick(maxiter, "max_iterations", 2000, int),
        "restart": pick(restart, "restart", 50, int),
    }


def _check_convergence(op, rhs, u, tol, atol, settings, method, strict=False):
    """Post-solve residual audit against ``||b - Au||_2 <= max(tol ||b||_2,
    atol)``; returns the normalized residual.  ``strict=True`` raises instead
    of warning: for combinations whose failure is a silently wrong answer
    rather than slow convergence (CG with a non-SPD preconditioner)."""
    res = float(torch.linalg.norm(rhs - op.matvec(u)))
    rhs_norm = float(torch.linalg.norm(rhs))
    bound = max(tol * rhs_norm, atol)
    normalized = res / rhs_norm if rhs_norm > 0 else res
    logger = Logger(__name__, settings).logger
    if not math.isfinite(res) or res > bound:
        msg = (f"Krylov ({method}) did NOT reach tolerance: "
               f"||b-Au||={res:.3e} (normalized {normalized:.3e}) > "
               f"max(tol*||b||, atol)={bound:.3e}")
        if strict:
            raise RuntimeError(msg)
        logger.warning(msg)
    else:
        logger.info(f"Krylov ({method}) converged: normalized residual "
                    f"{normalized:.3e}")
    return normalized


# smoothers whose sweep operator is symmetric on its own (so equal pre/post
# counts already make the V-cycle SPD regardless of sweep direction)
_SELF_ADJOINT_SMOOTHERS = {"jacobi", "block_jacobi", "chebyshev"}


def _validate_spd_cycle(settings):
    """CG demands an SPD preconditioner.  A multigrid cycle is SPD only when
    each level's post-smoother is the adjoint of its pre-smoother with equal
    sweep counts (forward pre + backward post, symmetric sweeps, or an
    inherently symmetric smoother).  Otherwise CG misconverges with no error
    signal, so raise early with an actionable message."""
    mgs = settings.solver.multigrid
    for t in ("penalty_parameter", "polynomial", "geometric"):
        node = getattr(mgs, f"{t}_coarsening", None)
        if node is None or not bool(getattr(node, "enabled", False)):
            continue
        pre, post = node.pre_smoother, node.post_smoother
        name_pre = normalize_smoother_name(pre.smoother)
        name_post = normalize_smoother_name(post.smoother)
        ok = (name_pre == name_post
              and int(pre.iterations) == int(post.iterations))
        if ok and name_pre not in _SELF_ADJOINT_SMOOTHERS:
            dirs = (str(getattr(pre, "direction", "forward")).lower(),
                    str(getattr(post, "direction", "forward")).lower())
            ok = dirs in (("forward", "backward"), ("backward", "forward"),
                          ("symmetric", "symmetric"))
        if not ok:
            raise ValueError(
                f"solver.krylov.method 'cg' with preconditioner 'multigrid' "
                f"needs a symmetric cycle, but the {t} coarsening smoothing "
                f"is not self-adjoint (pre={pre.smoother}/"
                f"{getattr(pre, 'direction', '?')}x{pre.iterations}, "
                f"post={post.smoother}/{getattr(post, 'direction', '?')}x"
                f"{post.iterations}).  Use adjoint directions "
                f"(forward/backward), symmetric sweeps, a self-adjoint "
                f"smoother (jacobi/chebyshev), or method 'gmres'.")


def solve_krylov(level, settings, tol=None, atol=None, maxiter=None,
                 restart=None, mg_cycle=None):
    """Dispatch on problem type and solver.krylov.method; returns
    ``(u, k)``: the solution and the CG steps or GMRES restarts taken.

    ``mg_cycle`` is one multigrid cycle from zero (``r -> cycle(r)``), built
    by the orchestrator when ``solver.krylov.preconditioner: multigrid``.
    """
    p = _krylov_params(settings, tol, atol, maxiter, restart)
    if p["precond"] == "multigrid" and mg_cycle is None:
        raise ValueError("preconditioner 'multigrid' requires the assembled "
                         "hierarchy; call through DGFEM.solve()")
    cg_mg = p["method"] == "cg" and p["precond"] == "multigrid"
    if cg_mg:
        _validate_spd_cycle(settings)
    if settings.problem.type == "Poisson" or level.block_A is None:
        u, k = _solve_poisson(level, mg_cycle=mg_cycle, **p)
    else:
        if p["method"] == "cg":
            raise ValueError("solver.krylov.method 'cg' requires an SPD "
                             "operator; the Stokes saddle system is "
                             "indefinite — use 'gmres'")
        u, k = _solve_stokes_gmres(level, p["tol"], p["atol"], p["maxiter"],
                                   p["restart"], mg_cycle=mg_cycle)
    # cg + multigrid: a residual miss here means CG misconverged on a subtly
    # non-SPD M — a wrong answer, not slow convergence; fail loudly
    _check_convergence(level.op, level.rhs, u, p["tol"], p["atol"], settings,
                       p["method"], strict=cg_mg)
    return u, k


def _poisson_preconditioner(op, precond, mg_cycle=None):
    if precond == "multigrid":
        # one cycle of the multigrid hierarchy per Krylov iteration; with
        # symmetric smoothing it is SPD, so admissible for CG as well
        return mg_cycle
    if precond == "amg":
        # one SA-AMG V-cycle as the preconditioner application
        cycle, _ = build_sa_cycle(op)

        def M(x):
            return cycle(x, torch.zeros_like(x))
    else:
        Dinv = block_diag_inv(op)
        n, _, br, _ = op.blocks.shape

        def M(x):
            return torch.einsum("nij,nj->ni", Dinv, x.reshape(n, br)).reshape(-1)

    return M


def _solve_poisson(level, method, precond, tol, atol, maxiter, restart,
                   mg_cycle=None):
    op, rhs = level.op, level.rhs
    M = _poisson_preconditioner(op, precond, mg_cycle)
    if method == "cg":
        # the SIP operator is SPD (face.py:119-126 symmetry asserts in the
        # reference); the block-diagonal / SA-AMG preconditioners are SPD too
        return cg(op.matvec, rhs, tol=tol, atol=atol, maxiter=maxiter, M=M)
    if method != "gmres":
        raise ValueError(f"unknown solver.krylov.method '{method}' "
                         "(expected 'gmres' or 'cg')")
    return gmres(op.matvec, rhs, tol=tol, atol=atol, maxiter=maxiter,
                 restart=restart, M=M)


def _solve_stokes_gmres(level, tol, atol, maxiter, restart, mg_cycle=None):
    """Block-diagonal Schur-complement-preconditioned GMRES for the saddle
    system, or GMRES with one distributive-GS multigrid cycle as M."""
    op, rhs = level.op, level.rhs
    if mg_cycle is not None:
        return gmres(op.matvec, rhs, tol=tol, atol=atol, maxiter=maxiter,
                     restart=restart, M=mg_cycle)
    n, nu, npd = op.sizes
    # host setup, as dgtpu: the element-interleaved diagonal blocks of A, and
    # S_hat = D diag(A)^-1 G from the D and G diagonal slots
    A_diag_inv = np.linalg.inv(op.A.diag_blocks().cpu().numpy())  # (N, 2Nu, 2Nu)
    D_diag = op.D.diag_blocks().cpu().numpy()                      # (N, Np, 2Nu)
    G_diag = op.G.diag_blocks().cpu().numpy()                      # (N, 2Nu, Np)
    S_hat = np.einsum("nij,njk,nkl->nil", D_diag, A_diag_inv, G_diag)
    # regularize the pressure null space (constant mode) before inversion
    S_hat += 1e-12 * np.eye(npd)
    S_hat[0][0, 0] += 1.0
    S_inv = torch.as_tensor(np.linalg.inv(S_hat), device=rhs.device)
    A_diag_inv = torch.as_tensor(A_diag_inv, device=rhs.device)

    def M(x):
        uv_g, p = x[:2 * n * nu], x[2 * n * nu:]
        uv = torch.cat([uv_g[:n * nu].reshape(n, nu), uv_g[n * nu:].reshape(n, nu)],
                       dim=1)
        uv2 = torch.einsum("nij,nj->ni", A_diag_inv, uv)
        p2 = torch.einsum("nij,nj->ni", S_inv, p.reshape(n, npd))
        return torch.cat([uv2[:, :nu].reshape(-1), uv2[:, nu:].reshape(-1),
                          p2.reshape(-1)])

    return gmres(op.matvec, rhs, tol=tol, atol=atol, maxiter=maxiter,
                 restart=restart, M=M)
