"""Algebraic multigrid, the ``-amg`` route (port of ``dgtpu/solvers/amg.py``).

The reference delegates to pyAMG's C++ Ruge-Stuben solver
(``solver.py:68-77``).  dgtpu provides the same capability self-contained:
host-side numpy setup (strength graph, greedy aggregation or the RS C/F
splitting, the prolongator, the Galerkin RAP) and V-cycles on dense
per-level operators.  Here the setup is the same numpy code (copied, so the
port imports nothing of dgtpu) and the cycles run in float64 plain torch on
the operator's device.  If pyamg is importable it solves instead, for parity
with the reference, as in dgtpu.
"""

import math

import numpy as np
import torch

from dgtpu_torch.ops import graphs
from dgtpu_torch.ops.smoothers import block_diag_inv
from dgtpu_torch.ops.stencil import as_dense_operator


def _try_pyamg(A, rhs, tol, maxiter):
    try:
        import pyamg
        import scipy.sparse as sp
    except ImportError:
        return None
    ml = pyamg.ruge_stuben_solver(sp.csr_matrix(A))
    residuals = []
    u, info = ml.solve(rhs.cpu().numpy(), tol=tol, maxiter=maxiter,
                       residuals=residuals, return_info=True)
    return (torch.as_tensor(u, device=rhs.device),
            {"residuals": residuals, "info": info})


def _strength_graph(A, theta=0.08):
    """Symmetric strength-of-connection: |a_ij| >= theta * sqrt(a_ii a_jj)."""
    d = np.sqrt(np.abs(np.diag(A)))
    S = np.abs(A) >= theta * np.outer(d, d)
    np.fill_diagonal(S, False)
    return S


def _aggregate(S):
    """Greedy aggregation over the strength graph; returns agg index per node."""
    n = S.shape[0]
    agg = -np.ones(n, dtype=np.int64)
    next_agg = 0
    # pass 1: seed aggregates from untouched nodes and their strong neighbors
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = np.nonzero(S[i])[0]
        if np.all(agg[nbrs] < 0):
            agg[i] = next_agg
            agg[nbrs] = next_agg
            next_agg += 1
    # pass 2: attach leftovers to a neighboring aggregate (or own aggregate)
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = np.nonzero(S[i])[0]
        assigned = nbrs[agg[nbrs] >= 0]
        if len(assigned):
            agg[i] = agg[assigned[0]]
        else:
            agg[i] = next_agg
            next_agg += 1
    return agg, next_agg


def _rho_dinv_a(A, n_iter=30, seed=0):
    """Power-iteration estimate of rho(D^-1 A) (pyamg approximate_spectral_
    radius analog); the SA omegas must be normalized by it — assuming
    rho ~ 1 diverges for high-p DG operators."""
    Dinv = 1.0 / np.diag(A)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(A.shape[0])
    lam = 1.0
    for _ in range(n_iter):
        x = Dinv * (A @ x)
        lam = np.linalg.norm(x)
        if lam == 0:
            return 1.0
        x /= lam
    return float(lam)


def _rs_strength(A, theta=0.25):
    """Classical strength of connection, absolute-value variant: i strongly
    depends on j when |a_ij| >= theta * max_{k != i} |a_ik| (SIP-DG
    operators carry positive off-diagonal entries, so pyamg's signed form,
    which assumes an M-matrix, is not used)."""
    off = np.abs(A.copy())
    np.fill_diagonal(off, 0.0)
    row_max = off.max(axis=1)
    S = np.zeros(A.shape, dtype=bool)
    nz = row_max > 0
    S[nz] = off[nz] >= theta * row_max[nz, None]
    np.fill_diagonal(S, False)
    return S


def _cf_split(S):
    """Standard RS first-pass C/F splitting (greedy by influence count):
    lambda_i = number of points that strongly depend on i; repeatedly pick
    the max-lambda unassigned point as C, mark its dependents F, and bump
    the weight of each new F point's other influences."""
    n = S.shape[0]
    ST = S.T.copy()                      # ST[i, j]: j strongly depends on i
    lam = ST.sum(axis=1).astype(np.float64)
    state = np.zeros(n, dtype=np.int8)   # 0 unassigned, 1 C, -1 F
    order_bias = 1e-9 * np.arange(n)     # deterministic tie-break
    for _ in range(n):
        un = state == 0
        if not un.any():
            break
        cand = np.where(un, lam + order_bias, -np.inf)
        i = int(np.argmax(cand))
        state[i] = 1
        dependents = np.nonzero(ST[i] & (state == 0))[0]
        state[dependents] = -1
        for f in dependents:
            # influences of the new F point become more valuable
            lam[np.nonzero(S[f] & (state == 0))[0]] += 1
        lam[i] = -np.inf
    # isolated leftovers become C points
    state[state == 0] = 1
    return state == 1


def _rs_direct_interpolation(A, S, is_C):
    """Direct interpolation: w_ij = -(a_ij/a_ii) * (sum_N a_ik)/(sum_C a_ij'),
    positive and negative couplings scaled separately (pyamg
    direct_interpolation semantics) so non-M-matrix rows still interpolate
    the constant exactly."""
    n = A.shape[0]
    C_idx = np.nonzero(is_C)[0]
    col_of = -np.ones(n, dtype=np.int64)
    col_of[C_idx] = np.arange(len(C_idx))
    P = np.zeros((n, len(C_idx)))
    P[C_idx, col_of[C_idx]] = 1.0
    for i in np.nonzero(~is_C)[0]:
        Ci = np.nonzero(S[i] & is_C)[0]
        if len(Ci) == 0:
            continue                      # no strong C neighbor: F point gets 0
        row = A[i]
        nbrs = np.nonzero(row)[0]
        nbrs = nbrs[nbrs != i]
        neg_all = row[nbrs][row[nbrs] < 0].sum()
        pos_all = row[nbrs][row[nbrs] > 0].sum()
        neg_C = row[Ci][row[Ci] < 0].sum()
        pos_C = row[Ci][row[Ci] > 0].sum()
        alpha = neg_all / neg_C if neg_C != 0 else 0.0
        beta = pos_all / pos_C if pos_C != 0 else 0.0
        # unmatched positive mass folds into the diagonal (pyamg behavior)
        diag = A[i, i] + (pos_all if pos_C == 0 else 0.0)
        for j in Ci:
            w = -(alpha * row[j] if row[j] < 0 else beta * row[j]) / diag
            P[i, col_of[j]] = w
    return P


def _rs_hierarchy(A, theta=0.25, max_coarse=40, max_levels=10):
    """Classical Ruge-Stuben setup: list of (A_l, P_l, rho_l), finest first
    (the reference's pyamg.ruge_stuben_solver, solver.py:68-77)."""
    levels = []
    A_l = A
    for _ in range(max_levels):
        n = A_l.shape[0]
        if n <= max_coarse:
            break
        S = _rs_strength(A_l, theta)
        is_C = _cf_split(S)
        n_c = int(is_C.sum())
        if n_c >= n or n_c == 0:
            break
        P = _rs_direct_interpolation(A_l, S, is_C)
        rho = _rho_dinv_a(A_l)
        levels.append((A_l, P, rho))
        A_l = P.T @ A_l @ P
    return levels, A_l


def _sa_hierarchy(A, max_coarse=40, max_levels=10, omega=4.0 / 3.0):
    """Smoothed-aggregation setup: list of (A_l, P_l, rho_l), finest first."""
    levels = []
    A_l = A
    for _ in range(max_levels):
        n = A_l.shape[0]
        if n <= max_coarse:
            break
        S = _strength_graph(A_l)
        agg, n_agg = _aggregate(S)
        if n_agg >= n:
            break
        T = np.zeros((n, n_agg))
        T[np.arange(n), agg] = 1.0
        # normalize columns (constant near-nullspace candidate)
        T /= np.maximum(np.sqrt((T ** 2).sum(axis=0)), 1e-30)
        Dinv = 1.0 / np.diag(A_l)
        rho = _rho_dinv_a(A_l)
        P = T - (omega / rho) * (Dinv[:, None] * (A_l @ T))
        A_c = P.T @ A_l @ P
        levels.append((A_l, P, rho))
        A_l = A_c
    return levels, A_l


def build_sa_cycle(op, variant="sa"):
    """AMG setup on ``op``; returns ``(cycle(b, x), A)``: the one-V-cycle
    applier (torch on the operator's device) and the dense operator (numpy).

    ``variant``: 'sa' (smoothed aggregation, dgtpu's default) or 'rs'
    (classical Ruge-Stuben, the reference's pyamg choice).  Used by
    ``solve_amg`` and as a Krylov preconditioner application.
    """
    A_dev = as_dense_operator(op).A
    A = A_dev.cpu().numpy()
    if variant == "rs":
        levels, A_coarse = _rs_hierarchy(A)
    elif variant == "sa":
        levels, A_coarse = _sa_hierarchy(A)
    else:
        raise ValueError(f"solver.amg.variant must be 'sa' or 'rs', got {variant!r}")

    def put(a):
        return torch.as_tensor(a, device=A_dev.device)

    A_coarse_inv = put(np.linalg.inv(A_coarse))
    dev = [(put(Al), put(P), put(1.0 / np.diag(Al)), rho) for Al, P, rho in levels]

    # finest-level relaxation: element-block Jacobi when the operator carries
    # DG block structure — point Jacobi smooths high-p SIP-DG blocks too
    # weakly (p=5 needs ~1000 cycles; block Jacobi an order fewer)
    Dblk = rho_blk = None
    if hasattr(op, "blocks") and levels:
        Dblk = block_diag_inv(op)
        Dblk_np = Dblk.cpu().numpy()
        Bsz = Dblk_np.shape[-1]
        rng = np.random.default_rng(1)
        x = rng.standard_normal(A.shape[0])
        rho_blk = 1.0
        for _ in range(30):
            x = np.einsum("nij,nj->ni", Dblk_np, (A @ x).reshape(-1, Bsz)).ravel()
            rho_blk = np.linalg.norm(x)
            x /= rho_blk
        rho_blk = float(rho_blk)

    def jacobi(Al, Dinv, b, x, rho, sweeps=2, omega=2.0 / 3.0):
        # damped Jacobi normalized by rho(D^-1 A) so the sweep contracts for
        # any polynomial degree (fixed 2/3 diverges for p >= 3 SIP-DG)
        for _ in range(sweeps):
            x = x + (omega / rho) * Dinv * (b - Al @ x)
        return x

    def block_jacobi(Al, b, x, sweeps=2, omega=2.0 / 3.0):
        Bsz = Dblk.shape[-1]
        for _ in range(sweeps):
            r = (b - Al @ x).reshape(-1, Bsz)
            x = x + (omega / rho_blk) * torch.einsum("nij,nj->ni", Dblk, r).reshape(-1)
        return x

    def smooth(lvl, b, x):
        Al, _, Dinv, rho = dev[lvl]
        if lvl == 0 and Dblk is not None:
            return block_jacobi(Al, b, x)
        return jacobi(Al, Dinv, b, x, rho)

    def v_cycle(b, x):
        # down the levels and back up in two loops: a function that recurses
        # through its own closure sits in a reference cycle, which would keep
        # the levels' device matrices until the garbage collector runs
        down = []
        for lvl, (Al, P, _, _) in enumerate(dev):
            x = smooth(lvl, b, x)
            down.append((b, x))
            b, x = P.T @ (b - Al @ x), torch.zeros(P.shape[1], dtype=b.dtype,
                                                   device=b.device)
        e = A_coarse_inv @ b
        for lvl in reversed(range(len(dev))):
            b, x = down[lvl]
            e = smooth(lvl, b, x + dev[lvl][1] @ e)
        return e

    return v_cycle, A


def solve_amg(op, rhs, tol=1e-6, maxiter=1000, variant="sa"):
    """AMG solve to relative tolerance (reference: solver.py:68-77).

    Returns ``(u, info)``: ``info["residuals"]`` is the normalized residual
    before each cycle (the first is 1, as dgtpu's), ``info["info"]`` 0
    when the tolerance was met, else 1; ``info["cycles"]`` counts the cycles.
    The cycles run as dgtpu's ``while_loop`` (``ops/graphs.run_while``): one
    cycle, its residual and the history store are one masked iteration (on
    the card a CUDA graph replayed in runs, one read of the loop test per
    run); the history, ``maxiter + 1`` entries NaN-padded, is read once at
    the end.
    """
    cycle, A = build_sa_cycle(op, variant=variant)
    res = _try_pyamg(A, rhs, tol, maxiter)
    if res is not None:
        return res
    A_dev = torch.as_tensor(A, device=rhs.device)
    res0 = torch.linalg.norm(rhs)

    def cond(state):
        n, _, r, _ = state
        return (n < maxiter) & (r >= tol) & torch.isfinite(r)

    def body(state):
        n, x, r, hist = state
        hist = hist.index_copy(0, torch.clamp(n, max=maxiter).view(1), r.view(1))
        x = cycle(rhs, x)
        return n + 1, x, torch.linalg.norm(rhs - A_dev @ x) / res0, hist

    state = (torch.zeros((), dtype=torch.int64, device=rhs.device), torch.zeros_like(rhs),
             torch.ones((), dtype=rhs.dtype, device=rhs.device),
             torch.full((maxiter + 1,), math.nan, dtype=rhs.dtype, device=rhs.device))
    n, x, r, hist = graphs.run_while(cond, body, state, max_steps=maxiter,
                                     name="amg.capture")
    n, r = torch.stack([n.to(r.dtype), r]).tolist()
    return x, {"residuals": [v for v in hist.tolist() if math.isfinite(v)],
               "info": 0 if r < tol else 1, "cycles": int(n)}
