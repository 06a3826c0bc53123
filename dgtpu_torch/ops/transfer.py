"""Inter-level transfer operators for penalty / p / h (geometric) multigrid
(port of ``dgtpu/ops/transfer.py``; the matrices are built with host numpy).

Every operator is *generated* from the L2-projection definition on the
orthonormal tensor-Legendre basis, which reproduces the reference's hardcoded
constants (``dgfem/dgfem.py:269-372``):

    P[(child, j), k] = int_ref phi_j(r) phi_k(child_map(r)) dr,
    R = P^T / cf**2                (Galerkin-consistent scaling)

Column ordering of geometric operators: child_j slowest, child_i, then mode
(solver.py:152-190).  The FVM kinds (``dg_to_fvm``, ``geometric_fvm``) are
ROADMAP Queue 1 item 11.
"""

from functools import lru_cache

import numpy as np
import torch

from dgtpu_torch.basis import gauss_legendre, legendre_orthonormal


def p_restriction(p_fine, p_coarse):
    """Zero-padded identity selecting modes with i,j <= p_coarse (dgfem.py:304-317)."""
    nf, nc = p_fine + 1, p_coarse + 1
    R = np.zeros((nc * nc, nf * nf))
    for j in range(nc):
        for i in range(nc):
            R[i + j * nc, i + j * nf] = 1.0
    return R


@lru_cache(maxsize=None)
def _proj_1d(p, cf):
    """1D child-projection blocks: W[c][j, k] = int phi_j(r) phi_k((r + 2c + 1 - cf)/cf) dr."""
    n = p + 1
    r, w = gauss_legendre(2 * p + 2)
    out = []
    for c in range(cf):
        R_of_r = (r + 2 * c + 1 - cf) / cf   # child c covers R in [-1+2c/cf, -1+2(c+1)/cf]
        W = np.zeros((n, n))
        for j in range(n):
            fj = legendre_orthonormal(r, j)
            for k in range(n):
                W[j, k] = np.sum(w * fj * legendre_orthonormal(R_of_r, k))
        out.append(W)
    return tuple(out)


def geometric_prolongation(p, cf=2):
    """P: (cf^2 * B, B) mapping coarse modal coeffs to the cf x cf children.

    Row ordering: (child_j, child_i, mode) with mode fastest — the layout the
    V-cycle reshape produces.  For p=1, cf=2 this reproduces the reference's
    sqrt(3) 16x4 operator (dgfem.py:362-367, as prolongation = R^T * 4).
    """
    n = p + 1
    B = n * n
    W = _proj_1d(p, cf)
    P = np.zeros((cf * cf * B, B))
    for cj in range(cf):
        for ci in range(cf):
            blk = np.zeros((B, B))
            for j in range(n):          # fine mode (i1, j1); coarse mode (i2, j2)
                for i in range(n):
                    for jj in range(n):
                        for ii in range(n):
                            blk[i + j * n, ii + jj * n] = W[ci][i, ii] * W[cj][j, jj]
            P[(cj * cf + ci) * B:(cj * cf + ci + 1) * B, :] = blk
    return P


def geometric_restriction(p, cf=2):
    """R = P^T / cf^2 — (B, cf^2 * B)."""
    return geometric_prolongation(p, cf).T / (cf * cf)


class TransferOp:
    """One inter-level transfer: its kind, restriction ``R`` and prolongation
    ``P`` as float64 tensors.  Geometric ones act on 2x2 tiles of fine
    cells: columns of R (rows of P) run (child_j, child_i, mode)."""

    def __init__(self, kind, R, P, device="cpu"):
        self.kind = kind
        self.R = torch.as_tensor(R, dtype=torch.float64, device=device)
        self.P = torch.as_tensor(P, dtype=torch.float64, device=device)


def make_transfer(kind, p_fine=None, p_coarse=None, cf=2, device="cpu"):
    """Factory for the penalty / polynomial / geometric transfers."""
    if kind == "penalty":
        B = (p_fine + 1) ** 2
        return TransferOp("penalty", np.eye(B), np.eye(B), device=device)
    if kind == "polynomial":
        R = p_restriction(p_fine, p_coarse)
        return TransferOp("polynomial", R, R.T, device=device)
    if kind == "geometric":
        return TransferOp("geometric", geometric_restriction(p_fine, cf),
                          geometric_prolongation(p_fine, cf), device=device)
    if kind in ("dg_to_fvm", "geometric_fvm"):
        raise NotImplementedError(
            f"the {kind} transfer (FVM coarse level) is not ported yet "
            "(ROADMAP Queue 1 item 11)")
    raise ValueError(kind)
