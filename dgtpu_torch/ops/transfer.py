"""Inter-level transfer operators for penalty / p / h (geometric) multigrid
(port of ``dgtpu/ops/transfer.py``; the matrices are built with host numpy).

Every operator is *generated* from the L2-projection definition on the
orthonormal tensor-Legendre basis, which reproduces the reference's hardcoded
constants (``dgfem/dgfem.py:269-372``):

    P[(child, j), k] = int_ref phi_j(r) phi_k(child_map(r)) dr,
    R = P^T / cf**2                (Galerkin-consistent scaling)

Column ordering of geometric operators: child_j slowest, child_i, then mode
(solver.py:152-190).  The FVM kinds: ``dg_to_fvm`` between a DG level and
the FVM level below it (one cell average per element), ``geometric_fvm``
between FVM levels (bilinear, over 4x4 fine / 2x2 coarse cell tiles).
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


def dg_to_fvm_restriction(p):
    """Modal DG(p) element -> FVM cell average: R[0, j] = mean(phi_j).
    For p=1 this is the reference's [[1, 0, 0, 0]] / 2 (dgfem.py:328-331)."""
    n = p + 1
    r, w = gauss_legendre(p + 1)
    means = np.zeros(n * n)
    for j in range(n):
        for i in range(n):
            mi = np.sum(w * legendre_orthonormal(r, i)) / 2.0
            mj = np.sum(w * legendre_orthonormal(r, j)) / 2.0
            means[i + j * n] = mi * mj
    return means[None, :]


def dg_to_fvm_prolongation(p):
    """Constant field -> modal coefficients: u = v gives c_00 = v / phi_00."""
    n = p + 1
    P = np.zeros((n * n, 1))
    phi00 = legendre_orthonormal(np.array([0.0]), 0)[0] ** 2
    P[0, 0] = 1.0 / phi00
    return P


def fvm_geometric_prolongation():
    """Bilinear cell-centered 2->1 prolongation over a 4x4 fine / 2x2 coarse
    tile, from the 1D weights (3/4, 1/4) with out-of-tile neighbors dropped:
    the reference's (9,3,3,1)/16 table (dgfem.py:342-358).  Row order
    (child_j, child_i); column order (coarse_j, coarse_i)."""
    w1d = {0: [(0, 0.75)], 1: [(0, 0.75), (1, 0.25)],
           2: [(0, 0.25), (1, 0.75)], 3: [(1, 0.75)]}
    P = np.zeros((16, 4))
    for fj in range(4):
        for fi in range(4):
            for cj, wj in w1d[fj]:
                for ci, wi in w1d[fi]:
                    P[fj * 4 + fi, cj * 2 + ci] = wi * wj
    return P


def fvm_geometric_restriction():
    return fvm_geometric_prolongation().T / 4.0


def _gather_tiles(vec, Nj_t, Ni_t, cf, B):
    """(N_f*B,) m-ordered -> (N_tiles, cf^2*B) rows with (tile_j, tile_i) order
    and (child_j, child_i, mode) columns — the V-cycle reshape (solver.py:152-168)."""
    v = vec.reshape(Nj_t, cf, Ni_t, cf, B).permute(0, 2, 1, 3, 4)
    return v.reshape(Nj_t * Ni_t, cf * cf * B)


def _scatter_tiles(rows, Nj_t, Ni_t, cf, B):
    return rows.reshape(Nj_t, Ni_t, cf, cf, B).permute(0, 2, 1, 3, 4).reshape(-1)


class TransferOp:
    """One inter-level transfer: its kind, restriction ``R`` and prolongation
    ``P`` as float64 tensors, and its tiling.  The fine side is gathered
    into tiles of ``cf_f`` x ``cf_f`` cells of ``B_f`` entries, the coarse
    side into ``cf_c`` x ``cf_c`` tiles of ``B_c`` (1: per element, no
    tiling); ``Ni_t`` x ``Nj_t`` is the tile grid (for 'geometric' the
    coarse level's element grid: needed by ``restrict``/``prolong`` on flat
    vectors only, the SoA and rolled cycles carry their own dims).
    ``row_scale`` scales each coarse row of a restriction (``dg_to_fvm``
    under the inverse-mass premultiply).  All vectors are in element
    m-order (m = j*Ni + i, j slow)."""

    def __init__(self, kind, R, P, device="cpu", Ni_t=None, Nj_t=None, cf_f=None,
                 cf_c=1, row_scale=None):
        self.kind = kind
        self.R = torch.as_tensor(R, dtype=torch.float64, device=device)
        self.P = torch.as_tensor(P, dtype=torch.float64, device=device)
        self.Ni_t, self.Nj_t = Ni_t, Nj_t
        self.cf_f = cf_f if cf_f is not None else (2 if kind == "geometric" else 1)
        self.cf_c = cf_c
        self.B_f = self.R.shape[1] // self.cf_f ** 2
        self.B_c = self.R.shape[0] // self.cf_c ** 2
        self.row_scale = (None if row_scale is None else
                          torch.as_tensor(row_scale, dtype=torch.float64, device=device))

    def _rows(self, vec, cf, B):
        if cf == 1:
            return vec.reshape(-1, B)
        if self.Ni_t is None or self.Nj_t is None:
            raise ValueError(f"a {self.kind} transfer needs its tile grid "
                             "(Ni_t, Nj_t) to act on flat vectors")
        return _gather_tiles(vec, self.Nj_t, self.Ni_t, cf, B)

    def _flat(self, rows, cf, B):
        if cf == 1:
            return rows.reshape(-1)
        return _scatter_tiles(rows, self.Nj_t, self.Ni_t, cf, B)

    def restrict(self, residual):
        """Fine residual (N_f*B_f,) -> coarse right-hand side (N_c*B_c,)."""
        if self.kind == "penalty":
            return residual
        out = self._rows(residual, self.cf_f, self.B_f) @ self.R.to(residual.dtype).T
        if self.row_scale is not None:
            out = out * self.row_scale.to(out.dtype)[:, None]
        return self._flat(out, self.cf_c, self.B_c)

    def prolong(self, u_coarse):
        """Coarse correction (N_c*B_c,) -> fine correction (N_f*B_f,)."""
        if self.kind == "penalty":
            return u_coarse
        v = self._rows(u_coarse, self.cf_c, self.B_c) @ self.P.to(u_coarse.dtype).T
        return self._flat(v, self.cf_f, self.B_f)


def make_transfer(kind, p_fine=None, p_coarse=None, cf=2, device="cpu",
                  Ni_c=None, Nj_c=None, row_scale=None):
    """Factory for every transfer kind.  ``Ni_c, Nj_c``: the coarse level's
    element (cell) counts."""
    if kind == "penalty":
        B = (p_fine + 1) ** 2
        return TransferOp("penalty", np.eye(B), np.eye(B), device=device)
    if kind == "polynomial":
        R = p_restriction(p_fine, p_coarse)
        return TransferOp("polynomial", R, R.T, device=device)
    if kind == "geometric":
        return TransferOp("geometric", geometric_restriction(p_fine, cf),
                          geometric_prolongation(p_fine, cf), device=device,
                          Ni_t=Ni_c, Nj_t=Nj_c, cf_f=cf)
    if kind == "dg_to_fvm":
        # per element, no tiling (the reference routes this through the
        # geometric reshape, which permutes the element order; dgtpu's
        # per-element transfer is ported)
        return TransferOp("dg_to_fvm", dg_to_fvm_restriction(p_fine),
                          dg_to_fvm_prolongation(p_fine), device=device,
                          row_scale=row_scale)
    if kind == "geometric_fvm":
        # 4x4 fine cells -> 2x2 coarse cells per tile: the tile grid is half
        # the coarse cell grid
        return TransferOp("geometric_fvm", fvm_geometric_restriction(),
                          fvm_geometric_prolongation(), device=device,
                          Ni_t=Ni_c // 2, Nj_t=Nj_c // 2, cf_f=4, cf_c=2)
    raise ValueError(kind)
