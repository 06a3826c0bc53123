"""Smoother amplification analysis (local Fourier analysis), the ``-amp``
flag (port of ``dgtpu/solvers/amplification.py``).

Reference: ``dgfem/relaxation.py:21-101``.  For each Fourier mode
(theta_x, theta_y) the initial guess ``exp(i(theta_x k + theta_y l))`` is
projected to modal space, one symmetric block-GS sweep is applied to the
homogeneous system, and the amplitude is sampled at the four center
elements.

The reference loops over the 101x101 theta grid in Python (10,201 smoother
calls); dgtpu runs the grid as one vmapped batch of complex sweeps.  Here
the grid is one batch too: a leading mode dimension through the complex128
wavefront sweep (``ops.smoothers._gs_sweep_sequential``), on the level's
device, in float64/complex128 plain torch.
"""

import os

import numpy as np
import torch

from dgtpu_torch.basis import lagrange_basis, vandermonde_2d
from dgtpu_torch.ops.smoothers import _gs_sweep_sequential, sweep_fronts
from dgtpu_torch.ops.stencil import StencilOperator


def _dg_modes(level):
    """(k, l) Fourier coordinates of the solution LGL nodes (N, ns^2), the
    nodal -> modal map Vinv and the modal -> nodal V, as host arrays.
    Sampling at the solution nodes makes the Vandermonde square for any
    P_sol (relaxation.py:71-90); node coordinates are interpolated from the
    grid lattice where P_sol differs from P_grid."""
    ns = level.N_sol["u"]
    if ns < 2:
        raise ValueError("smoother amplification needs P_sol >= 1")
    q = level.quad
    V = np.asarray(vandermonde_2d(ns, q.r_sol["u"], q.r_sol["u"]))
    if ns == level.N_grid:
        Xs, Ys = np.asarray(level.X), np.asarray(level.Y)
    else:
        L1 = lagrange_basis(q.r_sol["u"], q.r_grid)    # (ns, n_grid)
        L2 = np.kron(L1, L1)                           # Fortran n = i + j*G
        Xs, Ys = np.asarray(level.X) @ L2.T, np.asarray(level.Y) @ L2.T
    x0, y0 = float(Xs.min()), float(Ys.min())
    Lx, Ly = float(Xs.max()) - x0, float(Ys.max()) - y0
    k = (Xs - x0) * level.Ni * (ns - 1) / Lx
    l = (Ys - y0) * level.Nj * (ns - 1) / Ly
    return k, l, np.linalg.inv(V), V


def calculate_amplification(level, results_dir, n_theta=101, export=True):
    """{"theta", "A1".."A4"}: the amplitude after one symmetric block-GS
    sweep at the four center elements over the n_theta x n_theta grid.
    With ``export`` the dict is also written to ``amplification.npz`` in
    ``results_dir`` and plotted there (where matplotlib is available)."""
    theta = np.linspace(-np.pi, np.pi, n_theta)
    dev = level.device
    op = level.op
    is_fvm = level.discretization == "fvm"
    c128 = torch.complex128

    TX, TY = np.meshgrid(theta, theta, indexing="ij")
    tx = torch.as_tensor(TX.ravel(), device=dev)[:, None, None]
    ty = torch.as_tensor(TY.ravel(), device=dev)[:, None, None]
    if not is_fvm:
        k, l, Vinv, V = _dg_modes(level)
        k, l = (torch.as_tensor(a, device=dev) for a in (k, l))
        f_nodal = torch.exp(1j * (tx * k + ty * l))                  # (M, N, G)
        u0 = (f_nodal @ torch.as_tensor(Vinv.T, dtype=c128, device=dev))
    else:
        m = torch.arange(level.N, device=dev)
        i_idx, j_idx = (m % level.Ni).to(torch.float64), (m // level.Ni).to(torch.float64)
        u0 = torch.exp(1j * (tx[..., 0] * i_idx + ty[..., 0] * j_idx))   # (M, N)
    u0 = u0.reshape(len(TX.ravel()), -1)

    op_c = StencilOperator(op.blocks.to(c128), op.nbr, op.mask)
    Dinv_c = torch.as_tensor(np.linalg.inv(op.diag_blocks().cpu().numpy()),
                             dtype=c128, device=dev)
    rhs = torch.zeros_like(u0)
    u = _gs_sweep_sequential(op_c, rhs, u0, Dinv_c, 1.0, backward=False,
                             fronts=sweep_fronts(op, False))
    u = _gs_sweep_sequential(op_c, rhs, u, Dinv_c, 1.0, backward=True,
                             fronts=sweep_fronts(op, True))

    def m_of(i, j):
        return j * level.Ni + i

    ic, jc = level.Ni // 2, level.Nj // 2
    cells = [m_of(ic - 1, jc - 1), m_of(ic, jc - 1), m_of(ic - 1, jc), m_of(ic, jc)]
    u_cells = u.reshape(u.shape[0], level.N, -1)[:, cells]           # (M, 4, B)
    if not is_fvm:
        ns = level.N_sol["u"]
        nodal = u_cells @ torch.as_tensor(V.T, dtype=c128, device=dev)
        picks = [-1, -1 - ns, ns, 0]
    else:
        nodal, picks = u_cells, [0, 0, 0, 0]
    amps = torch.stack([nodal[:, q, picks[q]].abs() for q in range(4)], dim=1)
    amps = amps.cpu().numpy().reshape(n_theta, n_theta, 4)

    out = {"theta": theta}
    for q in range(4):
        A = amps[:, :, q]
        out[f"A{q + 1}"] = A
        print(f"np.min(A{q + 1})={A.min()}")
        print(f"np.max(A{q + 1})={A.max()}")
    if export:
        os.makedirs(results_dir, exist_ok=True)
        np.savez(os.path.join(results_dir, "amplification.npz"), **out)
        try:
            from dgtpu_torch.visualization import (plot_amplification_factor,
                                                   plot_amplification_quadrants)
            for q in range(4):
                plot_amplification_factor(out[f"A{q + 1}"], theta, theta, results_dir,
                                          suffix=str(q))
            # the reference's four-quadrant layout (relaxation.py:55-68)
            plot_amplification_quadrants(out, theta, results_dir)
        except Exception:
            # the plots are a by-product: a machine without matplotlib (or
            # one whose backend fails) still gets the npz
            pass
    return out
