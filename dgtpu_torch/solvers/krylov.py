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

dgtpu calls ``jax.scipy.sparse.linalg.cg`` and ``gmres``, each compiled
whole with its loop test on the device; ``cg`` and ``gmres`` here are those
two solvers written in torch with JAX's semantics, float64 plain torch on
the operator's device, their steps run as ``ops/graphs.while_loop``: a CG
step, a GMRES Arnoldi step or residual step, its preconditioner included,
is one masked iteration, on the card a CUDA graph replayed in runs with one
read of the loop test per run.  GMRES reads its residual norm and Cholesky
``info`` once per restart:

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

from dgtpu_torch.ops import graphs
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
    ``(x, k)`` with k the number of CG steps taken.  The steps run as
    ``graphs.run_while`` on the state ``(k, x, r, p, gamma)``: step -1 forms
    ``r = b - A x``, ``p = z = M(r)`` and ``gamma = r.z``, each later step is
    one CG step.  Both are one iteration, one matvec and one preconditioner
    application (on the card a replayed CUDA graph)."""
    x = torch.zeros_like(b) if x0 is None else x0
    if maxiter is None:
        maxiter = 10 * b.numel()
    atol2 = max(tol ** 2 * float(torch.dot(b, b)), atol ** 2)

    def cond(state):
        k, x, r, p, gamma = state
        rs = gamma if M is None else torch.dot(r, r)
        return (k < 0) | ((k < maxiter) & (rs > atol2))

    def body(state):
        k, x, r, p, gamma = state
        first = k < 0
        Ap = A(torch.where(first, x, p))
        alpha = gamma / torch.dot(p, Ap)
        r = torch.where(first, b - Ap, r - alpha * Ap)
        z = r if M is None else M(r)
        gamma_new = torch.dot(r, z)
        return (k + 1, torch.where(first, x, x + alpha * p), r,
                torch.where(first, z, z + (gamma_new / gamma) * p), gamma_new)

    # the loop writes into its state: none of it may be the caller's x0
    state = (torch.full((), -1, dtype=torch.int64, device=b.device), x.clone(),
             torch.zeros_like(b), torch.zeros_like(b),
             torch.zeros((), dtype=b.dtype, device=b.device))
    k, x, *_ = graphs.run_while(cond, body, state, max_steps=maxiter + 1,
                                name="krylov.capture")
    return x, int(k)


def _arnoldi(A, M, b, restart):
    """The steps of GMRES's restarts as one ``graphs.while_loop`` on the
    state ``(k, V, H, v_norm_1, x, beta)``, of fixed shapes ``V (n, restart
    + 1)`` and ``H (restart, restart + 1)``.  A restart starts at k = -1,
    its residual step: ``M(b - A x)``, normalized into ``V[:, 0]`` and its
    norm ``beta``.  Step k >= 0 preconditions ``A V[:, k]``, takes one
    classical Gram-Schmidt pass (JAX's iterative version with
    max_iterations=2 never takes its second) and stores ``V[:, k + 1]`` and
    ``H[k]``; the steps stop after step ``restart - 1`` or after a breakdown
    (``v_norm_1 == 0``, which the breaking step still stores, as JAX's).
    Both kinds of step are one iteration, one matvec and one preconditioner
    application: on the card every preconditioner application of the solve
    replays in the one graph.  ``_residual_step`` resets the state in place
    for each restart."""
    n, dtype, device = b.numel(), b.dtype, b.device
    eps = torch.finfo(dtype).eps

    def cond(state):
        k, _, _, v_norm, _, _ = state
        return (k < 0) | ((k < restart) & (v_norm != 0))

    def body(state):
        k, V, H, v_norm, x, beta = state
        first = k < 0
        # an active Arnoldi step has 0 <= k < restart; the clamp keeps the
        # indices of the residual step and of a frozen step in range
        kk = torch.clamp(k, 0, restart - 1).view(1)
        Av = A(torch.where(first, x, V.index_select(1, kk)[:, 0]))
        v = M(torch.where(first, b - Av, Av))
        unit_r, v_norm_0 = _safe_normalize(v)
        h = V.T @ v
        unit_v, v_norm_1 = _safe_normalize(v - V @ h, thresh=eps * v_norm_0)
        h = h.index_copy(0, kk + 1, v_norm_1.view(1))
        return (k + 1,
                torch.where(first, torch.cat([unit_r[:, None], V[:, 1:]], dim=1),
                            V.index_copy(1, kk + 1, unit_v[:, None])),
                torch.where(first, H, H.index_copy(0, kk, h[None])),
                torch.where(first, v_norm, v_norm_1), x,
                torch.where(first, v_norm_0, beta))

    state = (torch.zeros((), dtype=torch.int64, device=device),
             torch.zeros((n, restart + 1), dtype=dtype, device=device),
             torch.zeros((restart, restart + 1), dtype=dtype, device=device),
             torch.zeros((), dtype=dtype, device=device),
             torch.zeros((n,), dtype=dtype, device=device),
             torch.zeros((), dtype=dtype, device=device))
    return graphs.while_loop(cond, body, state, name="krylov.capture")


def _residual_step(arnoldi, x, info):
    """Reset ``arnoldi``'s state for a restart from ``x`` and run its
    residual step (``M(b - A x)``); returns the residual norm and the
    previous restart's Cholesky ``info`` as floats, in one read."""
    k, V, H, v_norm, x0, beta = arnoldi.state
    k.fill_(-1)
    V.zero_()
    H.copy_(torch.eye(*H.shape, dtype=H.dtype, device=H.device))
    v_norm.fill_(1.0)
    x0.copy_(x)
    arnoldi.run(1)
    return torch.stack([beta, info.to(beta.dtype)]).tolist()


def _gmres_batched(arnoldi, restart):
    """One GMRES restart after its residual step, JAX's ``_gmres_batched``:
    the full Arnoldi basis (ending early only on breakdown) and the
    least-squares problem ``min ||H^T y - beta e_0||`` by Cholesky of its
    normal equations.  Returns the new iterate and the Cholesky's ``info``
    (0, or the pivot where H H^T stopped being positive definite: the
    iterate is then NaN, as JAX's).  The steps replay as one run with no
    read; the least-squares tail runs eagerly (no capture meets the linear
    algebra library's Cholesky)."""
    _, V, H, _, x0, beta = arnoldi.state
    arnoldi.run(restart, chunk=restart)
    beta_vec = torch.zeros(restart + 1, dtype=beta.dtype, device=beta.device)
    beta_vec[0] = beta
    L, info = torch.linalg.cholesky_ex(H @ H.T)
    y = torch.cholesky_solve((H @ beta_vec)[:, None], L)[:, 0]
    return x0 + V[:, :-1] @ y, info


def gmres(A, b, x0=None, *, tol=1e-5, atol=0.0, restart=20, maxiter=None, M=None):
    """Restarted, left-preconditioned GMRES with JAX's semantics
    (``solve_method='batched'``); returns ``(x, k)`` with k the number of
    restarts taken.  The host reads the residual norm and the Cholesky's
    ``info`` in one read per restart."""
    x = torch.zeros_like(b) if x0 is None else x0
    if M is None:
        def M(v):
            return v
    size = b.numel()
    if maxiter is None:
        maxiter = 10 * size
    restart = min(restart, size)
    atol = max(tol * float(torch.sqrt(torch.dot(b, b))), atol)
    arnoldi = _arnoldi(A, M, b, restart)
    norm, _ = _residual_step(arnoldi, x, torch.zeros((), device=b.device))
    k = 0
    while k < maxiter and norm > atol:
        x, info = _gmres_batched(arnoldi, restart)
        k += 1
        norm, pivot = _residual_step(arnoldi, x, info)
        if pivot:
            logging.getLogger(__name__).warning(
                f"GMRES restart {k}: the normal equations of its least-squares "
                f"problem are not positive definite (Cholesky stops at pivot "
                f"{int(pivot)}), so the iterate is NaN, as JAX's batched GMRES's")
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
