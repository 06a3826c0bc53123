"""2nd-order curvilinear finite-volume discretization of the Poisson equation
(port of ``dgtpu/models/fvm.py``).

Reference: ``dgfem/discrete_system.py:188-353``
(assemble_BSR_and_RHS_Poisson_FVM): a 5-point scalar stencil with
face-length / center-distance coefficients ``a_N = s_face / |c_N - c_C|``,
ghost-value Dirichlet boundaries weighted by ``bc_order``, and cell-average
sources.  Used standalone (``-fvm``) and as the lowest multigrid levels
(``geometric coarsening: use FVM``).

Cell centers, corners and face midpoints come from the same modal geometry
interpolation as the DG path, evaluated at (0,0), (±1,±1) and (±1,0)/(0,±1).
Float64 on the level's device.
"""

import numpy as np
import torch

from dgtpu_torch.basis import vandermonde_2d
from dgtpu_torch.ops.stencil import StencilOperator


def _interp_at(level, r, s):
    """(1, G) operator evaluating the element geometry map at one reference
    point, float64 on the level's device."""
    V = vandermonde_2d(level.quad.n_grid, np.atleast_1d(r), np.atleast_1d(s))
    return torch.as_tensor(V @ level.quad.V_grid_grid_inv, dtype=torch.float64,
                           device=level.device)


def _coords(level):
    return (torch.as_tensor(level.X, dtype=torch.float64, device=level.device),
            torch.as_tensor(level.Y, dtype=torch.float64, device=level.device))


def fvm_cell_centers(level):
    L0 = _interp_at(level, 0.0, 0.0)
    X, Y = _coords(level)
    return (X @ L0.T)[:, 0], (Y @ L0.T)[:, 0]


def assemble_poisson_fvm(level, mms, bc_order=2):
    """Assemble the FVM operator (scalar 5-point StencilOperator with 1x1
    blocks) and its right-hand side."""
    X, Y = _coords(level)
    dev = level.device
    xc, yc = fvm_cell_centers(level)

    def at(r, s):
        L = _interp_at(level, r, s)
        return (X @ L.T)[:, 0], (Y @ L.T)[:, 0]

    # corners and face midpoints
    c_mm, c_mp, c_pm, c_pp = at(-1, -1), at(-1, 1), at(1, -1), at(1, 1)
    mid = {"iL": at(-1, 0), "iR": at(1, 0), "jL": at(0, -1), "jR": at(0, 1)}

    def dist(a, b):
        return torch.sqrt((a[0] - b[0]) ** 2 + (a[1] - b[1]) ** 2)

    s_face = {"iL": dist(c_mp, c_mm), "iR": dist(c_pp, c_pm),
              "jL": dist(c_pm, c_mm), "jR": dist(c_pp, c_mp)}

    nbr = torch.as_tensor(level.nbr, dtype=torch.int64, device=dev)
    mask = torch.as_tensor(level.nbr_mask, dtype=torch.bool, device=dev)
    centers = (xc, yc)
    N = level.N
    blocks = torch.zeros((N, 5, 1, 1), dtype=torch.float64, device=dev)
    rhs = -mms.f_momentum[0](xc, yc) * level.gt["A"]
    diag = torch.zeros(N, dtype=torch.float64, device=dev)

    for slot, key in {1: "iL", 2: "iR", 3: "jL", 4: "jR"}.items():
        has = mask[:, slot].to(torch.float64)
        idx = nbr[:, slot]
        d_int = dist((xc[idx], yc[idx]), centers)
        d_bnd = dist(mid[key], centers)
        # interior coefficient
        a_int = s_face[key] / torch.where(d_int == 0, torch.ones_like(d_int), d_int)
        # boundary ghost coefficient and Dirichlet data
        a_bnd = bc_order * s_face[key] / (2.0 * d_bnd)
        u_b = mms.u(mid[key][0], mid[key][1])
        blocks[:, slot, 0, 0] = has * a_int
        diag = diag - has * a_int - (1 - has) * a_bnd
        rhs = rhs - (1 - has) * a_bnd * u_b

    blocks[:, 0, 0, 0] = diag
    # The reference assembles the *negative* Laplacian stencil (diag = -sum a,
    # discrete_system.py:275-318), a negative-definite system.  dgtpu negates
    # it globally: the standalone solution is the same, the operator becomes
    # SPD, and its sign matches the SPD DG levels, so FVM works as a
    # multigrid coarse level.
    return StencilOperator(-blocks, nbr, mask), -rhs
