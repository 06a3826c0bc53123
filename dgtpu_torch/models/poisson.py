"""Poisson SIP-DG assembly: batched float64 contractions -> block-stencil
operator + RHS (port of ``dgtpu/models/poisson.py``).

Reference: ``dgfem/discrete_system.py:54-186`` (operator) and ``:355-403``
(MMS right-hand side).
"""

import torch

from dgtpu_torch.models.faces import FaceData, sip_dirichlet_rhs, sip_terms
from dgtpu_torch.ops.linalg import host_inv
from dgtpu_torch.ops.orthonormal import element_bases
from dgtpu_torch.ops.stencil import stencil_from_contributions


def _vol_table(level, table, var=None):
    """Shared (nq, B) volume table of the basis of ``var`` -> (N, nq, B):
    per element when that basis is the physical-element orthonormal one
    (element.py:33-50; ``level.element_basis`` is a {var: ElementBasis}
    dict, ``ops/orthonormal.element_bases``), else a broadcast view."""
    eb = (getattr(level, "element_basis", None) or {}).get(var)
    if eb is not None:
        return eb.apply(table)
    table = torch.as_tensor(table, dtype=torch.float64, device=level.device)
    return table.expand(level.N, *table.shape)


def volume_laplace(level, var="u", gt=None):
    """nu * int grad(phi_i) . grad(phi_k) per element -> (N, B, B).

    Reference: element.py:181-199 (compute_momentum_laplace_volume_integral).
    """
    gt = gt if gt is not None else level.gt
    q = level.quad
    g = gt[var]["e"]
    Vr = _vol_table(level, q.Vr_sol_int[var][var], var)
    Vs = _vol_table(level, q.Vs_sol_int[var][var], var)
    Gx = Vr * g["rx"][:, :, None] + Vs * g["sx"][:, :, None]  # (N, nq2, B)
    Gy = Vr * g["ry"][:, :, None] + Vs * g["sy"][:, :, None]
    wJ = g["J"] * torch.as_tensor(q.w_int_2d[var], device=level.device)[None, :]
    nu = level.settings.problem.kinematic_viscosity
    return nu * (torch.einsum("nqk,nq,nqi->nki", Gx, wJ, Gx)
                 + torch.einsum("nqk,nq,nqi->nki", Gy, wJ, Gy))


def mass_matrices(level, var="u", gt=None):
    """Per-element mass matrices V^T diag(w J) V (element.py:132-133)."""
    gt = gt if gt is not None else level.gt
    q = level.quad
    V = _vol_table(level, q.V_sol_int[var][var], var)
    wJ = gt[var]["e"]["J"] * torch.as_tensor(q.w_int_2d[var],
                                             device=level.device)[None, :]
    return torch.einsum("nqi,nq,nqk->nik", V, wJ, V)


def source_volume_rhs(level, f_vals, var="u", gt=None):
    """int f phi_i per element: (N, B).  Reference: element.py:161-167."""
    gt = gt if gt is not None else level.gt
    q = level.quad
    V = _vol_table(level, q.V_sol_int[var][var], var)
    wJ = gt[var]["e"]["J"] * torch.as_tensor(q.w_int_2d[var],
                                             device=level.device)[None, :]
    return torch.einsum("nqi,nq,nq->ni", V, wJ, f_vals)


def assemble_poisson(level, mms=None, gt=None):
    """Assemble the Poisson SIP operator (and MMS RHS when ``mms`` is given).

    Returns ``(StencilOperator, rhs, inv_mass)`` in float64 on the level's
    device; applies the optional inverse-mass premultiply exactly as
    discrete_system.py:139-142 / :398-402.
    """
    settings = level.settings
    nu = settings.problem.kinematic_viscosity
    gt = gt if gt is not None else level.gt
    dev = level.device

    # the physical-element orthonormal basis, when the setting is on
    element_bases(level, gt=gt, vars=("u",))
    vol = volume_laplace(level, gt=gt)

    fd_i = FaceData(level, level.faces_i, "u", gt=gt, element_basis=level.element_basis)
    fd_j = FaceData(level, level.faces_j, "u", gt=gt, element_basis=level.element_basis)
    LL_i, LR_i, RL_i, RR_i = sip_terms(fd_i, nu, level.sigma)
    LL_j, LR_j, RL_j, RR_j = sip_terms(fd_j, nu, level.sigma)

    def idx(a):
        return torch.as_tensor(a, device=dev)

    fi_min, fi_max = idx(level.faces_i.f_min), idx(level.faces_i.f_max)
    fj_min, fj_max = idx(level.faces_j.f_min), idx(level.faces_j.f_max)
    diag = (vol + RR_i[fi_min] + LL_i[fi_max] + RR_j[fj_min] + LL_j[fj_max])
    op = stencil_from_contributions(
        diag, RL_i[fi_min], LR_i[fi_max], RL_j[fj_min], LR_j[fj_max],
        level.nbr, level.nbr_mask)

    inv_mass = host_inv(mass_matrices(level, gt=gt))
    if settings.problem.multiply_inverse_mass_matrix:
        op = op.premultiply_blockdiag(inv_mass)

    rhs = None
    if mms is not None:
        g = gt["u"]["e"]
        f_vals = mms.f_momentum[0](g["x"], g["y"])
        rhs = source_volume_rhs(level, f_vals)
        if not level.fully_periodic:
            for fd, topo in ((fd_i, level.faces_i), (fd_j, level.faces_j)):
                if topo.periodic:
                    continue
                g_min = mms.u(fd.x_R, fd.y_R)   # boundary data at R element's min trace
                g_max = mms.u(fd.x_L, fd.y_L)
                r_min, r_max = sip_dirichlet_rhs(fd, nu, level.sigma, g_min, g_max)
                bmin = torch.as_tensor(~topo.has_L, dtype=rhs.dtype, device=dev)[:, None]
                bmax = torch.as_tensor(~topo.has_R, dtype=rhs.dtype, device=dev)[:, None]
                rhs = rhs.index_add(0, idx(topo.eR), r_min * bmin)
                rhs = rhs.index_add(0, idx(topo.eL), r_max * bmax)
        if settings.problem.multiply_inverse_mass_matrix:
            rhs = torch.einsum("nij,nj->ni", inv_mass, rhs)
        rhs = rhs.reshape(-1)

    return op, rhs, inv_mass
