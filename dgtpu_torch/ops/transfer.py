"""Inter-level transfer operators for penalty / p / h (geometric) multigrid
(port of ``dgtpu/ops/transfer.py``; the matrices are built with host numpy).

Every operator is *generated* from the L2-projection definition on the
orthonormal tensor-Legendre basis, which reproduces the reference's hardcoded
constants (``dgfem/dgfem.py:269-372``):

    P[(child, j), k] = int_ref phi_j(r) phi_k(child_map(r)) dr,
    R = P^T / cf**2                (Galerkin-consistent scaling)

Column ordering of geometric operators: child_j slowest, child_i, then mode
(solver.py:152-190).  The FVM kinds (``dg_to_fvm``, ``geometric_fvm``) are
not ported yet (ROADMAP Queue 1, "The other solver routes").
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


def _gather_tiles(vec, Nj_t, Ni_t, cf, B):
    """(N_f*B,) m-ordered -> (N_tiles, cf^2*B) rows with (tile_j, tile_i) order
    and (child_j, child_i, mode) columns — the V-cycle reshape (solver.py:152-168)."""
    v = vec.reshape(Nj_t, cf, Ni_t, cf, B).permute(0, 2, 1, 3, 4)
    return v.reshape(Nj_t * Ni_t, cf * cf * B)


def _scatter_tiles(rows, Nj_t, Ni_t, cf, B):
    return rows.reshape(Nj_t, Ni_t, cf, cf, B).permute(0, 2, 1, 3, 4).reshape(-1)


class TransferOp:
    """One inter-level transfer: its kind, restriction ``R`` and prolongation
    ``P`` as float64 tensors.  Geometric ones act on 2x2 tiles of fine
    cells: columns of R (rows of P) run (child_j, child_i, mode), and
    ``Ni_t`` x ``Nj_t`` is the coarse level's element grid (needed by
    ``restrict``/``prolong`` on flat vectors only: the SoA and rolled cycles
    carry their own dims).  All vectors are in element m-order
    (m = j*Ni + i, j slow)."""

    def __init__(self, kind, R, P, device="cpu", Ni_t=None, Nj_t=None):
        self.kind = kind
        self.R = torch.as_tensor(R, dtype=torch.float64, device=device)
        self.P = torch.as_tensor(P, dtype=torch.float64, device=device)
        self.Ni_t, self.Nj_t = Ni_t, Nj_t

    def _tiles(self):
        if self.Ni_t is None or self.Nj_t is None:
            raise ValueError("a geometric transfer needs the coarse grid's "
                             "(Ni_t, Nj_t) to act on flat vectors")
        return self.Nj_t, self.Ni_t, 2, self.R.shape[0]

    def restrict(self, residual):
        """Fine residual (N_f*B_f,) -> coarse right-hand side (N_c*B_c,)."""
        if self.kind == "penalty":
            return residual
        R = self.R.to(residual.dtype)
        if self.kind == "geometric":
            rows = _gather_tiles(residual, *self._tiles())
        else:
            rows = residual.reshape(-1, R.shape[1])
        return (rows @ R.T).reshape(-1)

    def prolong(self, u_coarse):
        """Coarse correction (N_c*B_c,) -> fine correction (N_f*B_f,)."""
        if self.kind == "penalty":
            return u_coarse
        P = self.P.to(u_coarse.dtype)
        v = u_coarse.reshape(-1, P.shape[1]) @ P.T
        if self.kind == "geometric":
            return _scatter_tiles(v, *self._tiles())
        return v.reshape(-1)


def make_transfer(kind, p_fine=None, p_coarse=None, cf=2, device="cpu",
                  Ni_c=None, Nj_c=None):
    """Factory for the penalty / polynomial / geometric transfers.
    ``Ni_c, Nj_c``: the coarse level's element counts (the tile grid of a
    geometric transfer)."""
    if kind == "penalty":
        B = (p_fine + 1) ** 2
        return TransferOp("penalty", np.eye(B), np.eye(B), device=device)
    if kind == "polynomial":
        R = p_restriction(p_fine, p_coarse)
        return TransferOp("polynomial", R, R.T, device=device)
    if kind == "geometric":
        return TransferOp("geometric", geometric_restriction(p_fine, cf),
                          geometric_prolongation(p_fine, cf), device=device,
                          Ni_t=Ni_c, Nj_t=Nj_c)
    if kind in ("dg_to_fvm", "geometric_fvm"):
        raise NotImplementedError(
            f"the {kind} transfer (FVM coarse level) is not ported yet "
            '(ROADMAP Queue 1, "The other solver routes")')
    raise ValueError(kind)
