"""Opt-in operator diagnostics, the reference's manual test modes (port of
``dgtpu/diagnostics.py``).

Reference flags and sites:
  check_eigenvalues       discrete_system.py:147-151, :756-763
  check_condition_number  discrete_system.py:753-754, :950-951
  check_characteristics   SPD / Cholesky / diagonal dominance,
                          discrete_system.py:153-173, :765-807
  check_orthonormality    discrete_system.py:175-180
  check_iteration_matrix  rho(B) of the smoother, relaxation.py:494-509
  check_consistency       Stokes continuity-system rank test, dgfem.py:129-149

They are dense O(n^3) checks on host numpy, from the operator's dense form
copied off the device, as dgtpu's are.  Unlike the reference they report
and return instead of calling ``exit()``.
"""

import numpy as np

from dgtpu_torch.ops.stencil import as_dense_operator

FLAGS = ("check_eigenvalues", "check_condition_number", "check_characteristics",
         "check_orthonormality", "check_iteration_matrix", "check_consistency")


def is_diagonally_dominant(A):
    abs_A = np.abs(A)
    return bool(np.all(2 * np.diag(abs_A) >= abs_A.sum(axis=1)))


def spectral_radius_gs(A, blocksize, which="forward"):
    """rho of the (block) Gauss-Seidel iteration matrix B = (D-E)^-1 F."""
    n = A.shape[0]
    L = np.zeros_like(A)
    U = np.zeros_like(A)
    nb = n // blocksize
    for i in range(nb):
        for j in range(nb):
            sl_i = slice(i * blocksize, (i + 1) * blocksize)
            sl_j = slice(j * blocksize, (j + 1) * blocksize)
            if j < i:
                L[sl_i, sl_j] = A[sl_i, sl_j]
            elif j > i:
                U[sl_i, sl_j] = A[sl_i, sl_j]
    D = A - L - U
    if which == "forward":
        B = np.linalg.solve(D + L, -U)
    elif which == "backward":
        B = np.linalg.solve(D + U, -L)
    else:  # Jacobi
        B = np.linalg.solve(D, -(L + U))
    return float(np.abs(np.linalg.eigvals(B)).max())


def _host(t):
    return t.detach().cpu().numpy()


def run_diagnostics(dgfem, level):
    """The checks the settings ask for on ``level`` (the finest); the
    results are returned and left in ``dgfem.diagnostics``."""
    p = dgfem.settings.problem
    logger = dgfem.logger
    if not any(getattr(p, f, False) for f in FLAGS):
        return {}

    A = _host(as_dense_operator(level.op).A)
    out = {}

    if p.check_eigenvalues:
        eigs = np.linalg.eigvals(A)
        out["min_eig"], out["max_eig"] = eigs.min(), eigs.max()
        logger.debug(f"The eigenvalues of the coefficient matrix are "
                     f"{out['min_eig']:.5g} (min) and {out['max_eig']:.5g} (max)")

    if p.check_condition_number:
        out["cond"] = float(np.linalg.cond(A))
        logger.debug(f"The condition number of the coefficient matrix is "
                     f"{out['cond']:.5g}")

    if p.check_characteristics:
        name = p.type
        sym = np.abs(A - A.T).max() <= 1e-13 * max(1.0, np.abs(A).max())
        if not sym:
            logger.warning(f"The {name} system is NOT SPD, not symmetric")
        try:
            np.linalg.cholesky(A)
            logger.debug(f"The {name} system is SPD")
            out["spd"] = True
        except np.linalg.LinAlgError:
            logger.warning(f"The {name} system is NOT SPD, not positive definite")
            out["spd"] = False
        out["diag_dominant"] = is_diagonally_dominant(A)
        if out["diag_dominant"]:
            logger.debug(f"The {name} system is diagonally dominant")
        else:
            logger.warning(f"The {name} system is NOT diagonally dominant")

    if p.check_orthonormality and level.inv_mass is not None:
        Minv = _host(level.inv_mass)
        for e in range(min(level.N, 4)):
            M = Minv[e].copy()
            M[np.abs(M) < 1e-10] = 0.0
            logger.debug(f"Inverse mass matrix of element {e}:\n{M}")
        out["orthonormal"] = bool(np.allclose(
            Minv * _host(level.gt["A"])[:, None, None], np.eye(Minv.shape[1]),
            atol=1e-8))

    if p.check_iteration_matrix:
        rho = spectral_radius_gs(A, level.N_DOF_sol_tot)
        out["rho_gs"] = rho
        logger.info(f"The max eigenvalue of forward_Gauss_Seidel iteration "
                    f"matrix B is {rho:.3e}")

    if getattr(p, "check_consistency", False) and level.block_A is not None:
        # Stokes continuity-system consistency: Epsilon and the rank of
        # [D A^-1 G | D A^-1 f - g] (dgfem.py:129-149), in global order
        from dgtpu_torch.models.stokes import _uv_index
        n, nu = level.N, level.N_DOF_sol["u"]
        idx = _uv_index(n, nu).numpy()
        A_blk = _host(level.block_A.to_dense())[idx][:, idx]
        D = _host(level.block_D.to_dense())[:, idx]
        G = _host(level.block_G.to_dense())[idx]
        eps = level.Epsilon
        out["Epsilon"] = eps
        if abs(eps) < 1e-13:
            logger.debug("Epsilon < 1e-13, system is consistent")
        else:
            Ainv = np.linalg.inv(A_blk)
            mat = D @ Ainv @ G
            rhs = _host(level.rhs)
            f_mom, f_cont = rhs[:2 * n * nu], rhs[2 * n * nu:]
            aug = np.hstack([mat, (D @ Ainv @ f_mom - f_cont)[:, None]])
            out["rank"] = int(np.linalg.matrix_rank(mat, tol=1e-10))
            out["rank_aug"] = int(np.linalg.matrix_rank(aug, tol=1e-10))
            if out["rank_aug"] > out["rank"]:
                logger.warning("Stokes continuity system is INCONSISTENT "
                               f"(rank {out['rank']} < augmented {out['rank_aug']})")
    dgfem.diagnostics = out
    return out
