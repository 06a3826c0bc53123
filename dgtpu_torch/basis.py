"""Modal tensor-product Legendre bases, quadrature rules and Vandermonde tables.

Semantics match the reference ``dgfem/interpolation.py`` exactly (same
orthonormalization, same column-major 2D mode ordering ``n = i + j*N`` with
the r-index fastest in the row ordering ``m = p + q*len(r)``), but the
dict-of-dict keying is replaced by plain arrays built per (basis-var,
quadrature-var) pair at setup.

Everything here is host-side numpy precompute: the outputs are small constant
matrices that are closed over by the jitted device pipeline.

Reference: dgfem/interpolation.py:29-170 (Jacobi/Legendre evaluation,
quadrature, vandermonde2D/grad_vandermonde2D).
"""

from functools import lru_cache
from math import factorial, gamma

import numpy as np
from scipy.special import eval_jacobi, roots_jacobi


def jacobi_orthonormal(x, alpha, beta, p):
    """Orthonormal Jacobi polynomial of degree ``p`` on [-1, 1].

    Normalized so that ``int_{-1}^{1} (1-x)^a (1+x)^b J_p^2 dx = 1``
    (reference: interpolation.py:29-44).
    """
    x = np.asarray(x, dtype=np.float64)
    norm = (2.0 ** (alpha + beta + 1) * gamma(p + alpha + 1) * gamma(p + beta + 1)
            / ((2 * p + alpha + beta + 1) * gamma(p + alpha + beta + 1) * factorial(p)))
    return eval_jacobi(p, alpha, beta, x) / np.sqrt(norm)


def legendre_orthonormal(x, p):
    """Orthonormal Legendre polynomial: ``P_p(x) * sqrt((2p+1)/2)``."""
    return jacobi_orthonormal(x, 0, 0, p)


def grad_legendre_orthonormal(x, p):
    """d/dx of the orthonormal Legendre polynomial (interpolation.py:52-59)."""
    x = np.asarray(x, dtype=np.float64)
    if p == 0:
        return np.zeros_like(x)
    return np.sqrt(p * (p + 1)) * jacobi_orthonormal(x, 1, 1, p - 1)


@lru_cache(maxsize=None)
def gauss_legendre(n):
    """``n``-point Gauss-Legendre nodes and weights on [-1, 1]."""
    r, w = roots_jacobi(n, 0, 0)
    return np.asarray(r), np.asarray(w)


@lru_cache(maxsize=None)
def legendre_gauss_lobatto(n):
    """``n`` LGL nodes (degree ``n-1``) on [-1, 1]; weights not needed.

    Reference: interpolation.py:88-110 (endpoints + interior roots of
    P'_{P} via Jacobi(1,1) roots).
    """
    p = n - 1
    if p < 1:
        raise ValueError("The polynomial order P must be a positive integer")
    xi = np.zeros(p + 1)
    xi[0], xi[-1] = -1.0, 1.0
    if p > 1:
        xi[1:-1], _ = roots_jacobi(p - 1, 1, 1)
    return xi


def vandermonde_1d(n_modes, r):
    """V[m, j] = L_j(r_m) with orthonormal Legendre columns."""
    r = np.atleast_1d(np.asarray(r, dtype=np.float64))
    V = np.zeros((len(r), n_modes))
    for j in range(n_modes):
        V[:, j] = legendre_orthonormal(r, j)
    return V


def grad_vandermonde_1d(n_modes, r):
    r = np.atleast_1d(np.asarray(r, dtype=np.float64))
    V = np.zeros((len(r), n_modes))
    for j in range(1, n_modes):
        V[:, j] = grad_legendre_orthonormal(r, j)
    return V


def _outer_F(a, b):
    """ravel(outer(a, b), order='F') for each column pair — row index m = p + q*len(a)."""
    return np.ravel(np.outer(a, b), order="F")


def vandermonde_2d(n_modes, r, s):
    """Tensor-product 2D Vandermonde.

    ``V[m, n] = L_i(r_p) * L_j(s_q)`` with ``m = p + q*len(r)`` and
    ``n = i + j*n_modes`` — i.e. the reference's column-major ordering
    (interpolation.py:118-142).  ``r``/``s`` may be scalars or arrays
    (face traces pass a single point such as [-1] or [1]).
    """
    r = np.atleast_1d(np.asarray(r, dtype=np.float64))
    s = np.atleast_1d(np.asarray(s, dtype=np.float64))
    V = np.zeros((len(r) * len(s), n_modes ** 2))
    n = 0
    for j in range(n_modes):
        for i in range(n_modes):
            V[:, n] = _outer_F(legendre_orthonormal(r, i), legendre_orthonormal(s, j))
            n += 1
    return V


def grad_vandermonde_2d(n_modes, r, s):
    """(d/dr, d/ds) 2D Vandermondes, same ordering as :func:`vandermonde_2d`."""
    r = np.atleast_1d(np.asarray(r, dtype=np.float64))
    s = np.atleast_1d(np.asarray(s, dtype=np.float64))
    Vr = np.zeros((len(r) * len(s), n_modes ** 2))
    Vs = np.zeros_like(Vr)
    n = 0
    for j in range(n_modes):
        for i in range(n_modes):
            Vr[:, n] = _outer_F(grad_legendre_orthonormal(r, i), legendre_orthonormal(s, j))
            Vs[:, n] = _outer_F(legendre_orthonormal(r, i), grad_legendre_orthonormal(s, j))
            n += 1
    return Vr, Vs


def legendre_to_lagrange_1d(p, r):
    """Lagrange cardinal functions of the LGL(p) nodes evaluated at ``r``,
    constructed through the Legendre modal basis (interpolation.py:183-187).

    ``T[m, i] = l_i(r[m])``: applying T to nodal values interpolates to r.
    (The reference's comment claims the columns are modes; they are nodes.)
    """
    r_lgl = legendre_gauss_lobatto(p + 1)
    Vg = vandermonde_1d(p + 1, r_lgl)
    leg = np.array([legendre_orthonormal(np.atleast_1d(r), k)
                    for k in range(p + 1)])
    return np.linalg.solve(Vg.T, leg).T


def legendre_to_lagrange_2d(p, r):
    """2D tensor variant along the diagonal line (r, r)
    (interpolation.py:189-200)."""
    r = np.atleast_1d(r)
    r_lgl = legendre_gauss_lobatto(p + 1)
    Vg = vandermonde_2d(p + 1, r_lgl, r_lgl)
    n = p + 1
    lag = np.zeros((n * n, len(r)))
    m = 0
    for i in range(n):
        for j in range(n):
            lag[m, :] = legendre_orthonormal(r, i) * legendre_orthonormal(r, j)
            m += 1
    return np.linalg.solve(Vg.T, lag).T


def lebesgue_function(xi, x):
    """Lebesgue function sum_i |l_i(x)| of the nodal set ``xi`` — the node-
    quality diagnostic behind the reference's Lebesgue plots
    (visualization.py:238-401)."""
    L = lagrange_basis(x, xi)
    return np.abs(L).sum(axis=1)


def lagrange_basis(x, xi):
    """Values of the Lagrange cardinal functions on nodes ``xi`` at point(s) ``x``."""
    xi = np.asarray(xi, dtype=np.float64)
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    n = len(xi)
    out = np.ones((len(x), n))
    for i in range(n):
        for j in range(n):
            if j == i:
                continue
            out[:, i] *= (x - xi[j]) / (xi[i] - xi[j])
    return out


class QuadratureSet:
    """All 1D rules and 2D Vandermonde tables a grid level needs, per variable.

    ``n_sol``: modes per direction of the solution basis (P_sol+1).
    ``n_int``: integration points per direction.
    ``n_grid``: geometry nodes per direction (P_grid+1).
    """

    def __init__(self, n_grid, n_sol, n_int):
        self.n_grid = n_grid
        self.n_sol = dict(n_sol)
        self.n_int = dict(n_int)
        self.vars = list(self.n_sol.keys())

        self.r_grid = legendre_gauss_lobatto(n_grid)
        self.r_sol = {v: (legendre_gauss_lobatto(n) if n > 1 else np.array([0.0]))
                      for v, n in self.n_sol.items()}
        self.r_int, self.w_int = {}, {}
        for v in self.vars:
            r, w = gauss_legendre(self.n_int[v])
            self.r_int[v], self.w_int[v] = r, w
        # 2D tensor weights, F-raveled to match the quadrature row ordering
        self.w_int_2d = {v: np.ravel(np.outer(self.w_int[v], self.w_int[v]), order="F")
                         for v in self.vars}

        # --- geometry-basis tables (always keyed by quadrature variable) ---
        self.V_grid_grid = vandermonde_2d(n_grid, self.r_grid, self.r_grid)
        self.V_grid_grid_inv = np.linalg.inv(self.V_grid_grid)
        self.V_grid_int = {v: vandermonde_2d(n_grid, self.r_int[v], self.r_int[v])
                           for v in self.vars}
        self.Vr_grid_int, self.Vs_grid_int = {}, {}
        for v in self.vars:
            self.Vr_grid_int[v], self.Vs_grid_int[v] = grad_vandermonde_2d(
                n_grid, self.r_int[v], self.r_int[v])
        # face-trace geometry derivative tables: side -> var -> (nq, G)
        self.Vr_grid_face, self.Vs_grid_face = {}, {}
        self.V_grid_face = {}
        for side, (rr, ss) in self._face_coords().items():
            self.Vr_grid_face[side], self.Vs_grid_face[side] = {}, {}
            self.V_grid_face[side] = {}
            for v in self.vars:
                r = rr if rr is not None else self.r_int[v]
                s = ss if ss is not None else self.r_int[v]
                gr, gs = grad_vandermonde_2d(n_grid, r, s)
                self.Vr_grid_face[side][v], self.Vs_grid_face[side][v] = gr, gs
                self.V_grid_face[side][v] = vandermonde_2d(n_grid, r, s)

        # --- solution-basis tables: basis var b evaluated at quadrature of var q ---
        self.V_sol_int = {b: {q: vandermonde_2d(self.n_sol[b], self.r_int[q], self.r_int[q])
                              for q in self.vars} for b in self.vars}
        self.Vr_sol_int, self.Vs_sol_int = {}, {}
        for b in self.vars:
            self.Vr_sol_int[b], self.Vs_sol_int[b] = {}, {}
            for q in self.vars:
                vr, vs = grad_vandermonde_2d(self.n_sol[b], self.r_int[q], self.r_int[q])
                self.Vr_sol_int[b][q], self.Vs_sol_int[b][q] = vr, vs
        # face traces of the solution basis: side -> basis var -> quad var
        self.V_sol_face, self.Vr_sol_face, self.Vs_sol_face = {}, {}, {}
        for side, (rr, ss) in self._face_coords().items():
            self.V_sol_face[side] = {}
            self.Vr_sol_face[side] = {}
            self.Vs_sol_face[side] = {}
            for b in self.vars:
                self.V_sol_face[side][b] = {}
                self.Vr_sol_face[side][b] = {}
                self.Vs_sol_face[side][b] = {}
                for q in self.vars:
                    r = rr if rr is not None else self.r_int[q]
                    s = ss if ss is not None else self.r_int[q]
                    self.V_sol_face[side][b][q] = vandermonde_2d(self.n_sol[b], r, s)
                    vr, vs = grad_vandermonde_2d(self.n_sol[b], r, s)
                    self.Vr_sol_face[side][b][q] = vr
                    self.Vs_sol_face[side][b][q] = vs

        # modal solution -> geometry grid nodes (postprocessing)
        self.V_sol_grid = {b: vandermonde_2d(self.n_sol[b], self.r_grid, self.r_grid)
                           for b in self.vars}

    @staticmethod
    def _face_coords():
        """Reference-element coordinates of the 4 face trace lines.

        ``None`` means 'the quadrature line of the variable'.  Matches the
        reference's min/max trace conventions (grid.py:193-210): the i-faces
        vary in s, the j-faces vary in r.
        """
        return {
            "imin": (np.array([-1.0]), None),
            "imax": (np.array([1.0]), None),
            "jmin": (None, np.array([-1.0])),
            "jmax": (None, np.array([1.0])),
        }
