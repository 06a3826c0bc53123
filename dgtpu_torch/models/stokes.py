"""Stokes pressure-robust SIP-DG assembly and the distributive Gauss-Seidel
smoothers (port of ``dgtpu/models/stokes.py``).

Reference: ``dgfem/discrete_system.py:405-1029`` (local- and global-order
assembly), ``dgfem/relaxation.py:220-441`` (distributive Gauss-Seidel),
``utils/helpers.py:41-80`` (DOF reorderings), ``dgfem/dgfem.py:170-186``
(pressure mean shift), ``dgfem/grid.py:227-269`` (MMS Epsilon).

Local ordering packs one (2Nu + Np) block per element: [u-modes, v-modes,
p-modes].  Global ordering keeps component stencils (A as 2x2 of Nu-blocks,
D as Np x Nu, G as Nu x Np) composed into a saddle operator [[A, G], [D, 0]]
on vectors [all u; all v; all p].  The distributive smoothers run in float64
plain torch on the operators' device, as dgtpu runs them outside any Pallas
kernel: the dense ``DistributiveGS`` (lsq and the classical Schur
splittings) and the stencil-form ``StencilDGS`` (lsq).
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from dgtpu_torch.models.faces import (FaceData, continuity_dirichlet_rhs,
                                      continuity_surface, pressure_dirichlet_rhs,
                                      pressure_surface, sip_dirichlet_rhs,
                                      sip_terms, velocity_penalty_dirichlet_rhs,
                                      velocity_penalty_surface)
from dgtpu_torch.models.poisson import (_vol_table, source_volume_rhs,
                                        volume_laplace)
from dgtpu_torch.ops import rolled
from dgtpu_torch.ops.linalg import host_inv
from dgtpu_torch.ops.orthonormal import element_bases
from dgtpu_torch.ops.stencil import StencilOperator, dense_block_gs_sweep
from dgtpu_torch.ops.transfer import make_transfer, p_restriction
from dgtpu_torch.solvers.relaxation_driver import tracked_status
from dgtpu_torch.utils import caching
from dgtpu_torch.utils.norms import lp_norm

# stencil slot order [self, iL, iR, jL, jR]; _MIRROR[s] = slot of e as seen
# from its s-neighbor
_MIRROR = np.array([0, 2, 1, 4, 3])


# --------------------------------------------------------------------------
# volume kernels (element.py:151-231)
# --------------------------------------------------------------------------

def _w(level, var):
    return torch.as_tensor(level.quad.w_int_2d[var], device=level.device)[None, :]


def _grad_basis(level, var_basis, var_quad, gt):
    """G_x, G_y of a basis at a quadrature: (N, nq2, B) each; per element
    when the physical-element orthonormal basis is active."""
    q = level.quad
    g = gt[var_quad]["e"]
    Vr = _vol_table(level, q.Vr_sol_int[var_basis][var_quad], var_basis)
    Vs = _vol_table(level, q.Vs_sol_int[var_basis][var_quad], var_basis)
    Gx = Vr * g["rx"][:, :, None] + Vs * g["sx"][:, :, None]
    Gy = Vr * g["ry"][:, :, None] + Vs * g["sy"][:, :, None]
    return Gx, Gy


def continuity_volume(level, gt):
    """-int q div(u): (N, Np, 2Nu) (element.py:169-179)."""
    Gx, Gy = _grad_basis(level, "u", "p", gt)
    Vp = _vol_table(level, level.quad.V_sol_int["p"]["p"], "p")
    wJ = gt["p"]["e"]["J"] * _w(level, "p")
    res_u = -torch.einsum("nqi,nq,nqk->nki", Gx, wJ, Vp)
    res_v = -torch.einsum("nqi,nq,nqk->nki", Gy, wJ, Vp)
    return torch.cat([res_u, res_v], dim=2)


def pressure_volume(level, gt):
    """-int p div(psi): (N, 2Nu, Np) (element.py:201-211)."""
    Gx, Gy = _grad_basis(level, "u", "u", gt)
    Vp = _vol_table(level, level.quad.V_sol_int["p"]["u"], "p")
    wJ = gt["u"]["e"]["J"] * _w(level, "u")
    res_x = -torch.einsum("nqi,nq,nqk->nki", Vp, wJ, Gx)
    res_y = -torch.einsum("nqi,nq,nqk->nki", Vp, wJ, Gy)
    return torch.cat([res_x, res_y], dim=1)


def velocity_penalty_volume(level, gt):
    """gamma int div(u) div(psi): (N, 2Nu, 2Nu) (element.py:213-231)."""
    Gx, Gy = _grad_basis(level, "u", "u", gt)
    wJ = gt["u"]["e"]["J"] * _w(level, "u")
    gamma = level.gamma

    def blk(Ga, Gb):
        return gamma * torch.einsum("nqi,nq,nqk->nki", Ga, wJ, Gb)

    top = torch.cat([blk(Gx, Gx), blk(Gy, Gx)], dim=2)
    bot = torch.cat([blk(Gx, Gy), blk(Gy, Gy)], dim=2)
    return torch.cat([top, bot], dim=1)


def _expand_2x2_diag(blocks):
    """Scalar (F, B, B) -> velocity-block-diagonal (F, 2B, 2B) (face.py:174-178)."""
    z = torch.zeros_like(blocks)
    top = torch.cat([blocks, z], dim=2)
    bot = torch.cat([z, blocks], dim=2)
    return torch.cat([top, bot], dim=1)


# --------------------------------------------------------------------------
# assembly
# --------------------------------------------------------------------------

def _element_blocks(level, gt):
    """All Stokes per-element/per-face blocks gathered into stencil slots:
    (N, 5, rows, cols) tensors for the A (2Nu x 2Nu), D (Np x 2Nu) and
    G (2Nu x Np) parts, plus the FaceData the right-hand side reuses."""
    nu = level.settings.problem.kinematic_viscosity
    # physical-element orthonormal bases for both u and p when the setting
    # is on (the reference's transform is u-only, element.py:32)
    eb = element_bases(level, gt=gt, vars=("u", "p"))
    fd_i_u = FaceData(level, level.faces_i, "u", gt=gt, element_basis=eb)
    fd_j_u = FaceData(level, level.faces_j, "u", gt=gt, element_basis=eb)
    fd_i_p = FaceData(level, level.faces_i, "p", gt=gt, element_basis=eb)
    fd_j_p = FaceData(level, level.faces_j, "p", gt=gt, element_basis=eb)

    def per_direction(fd_u, fd_p):
        sip = [_expand_2x2_diag(b) for b in sip_terms(fd_u, nu, level.sigma)]
        vp = velocity_penalty_surface(fd_u, level.gamma)
        A4 = [a + b for a, b in zip(sip, vp)]
        return A4, continuity_surface(fd_p), pressure_surface(fd_u)

    Ai, Di, Gi = per_direction(fd_i_u, fd_i_p)
    Aj, Dj, Gj = per_direction(fd_j_u, fd_j_p)

    def idx(a):
        return torch.as_tensor(a, device=level.device)

    fi_min, fi_max = idx(level.faces_i.f_min), idx(level.faces_i.f_max)
    fj_min, fj_max = idx(level.faces_j.f_min), idx(level.faces_j.f_max)

    def slots(vol, four_i, four_j):
        LL_i, LR_i, RL_i, RR_i = four_i
        LL_j, LR_j, RL_j, RR_j = four_j
        diag = vol + RR_i[fi_min] + LL_i[fi_max] + RR_j[fj_min] + LL_j[fj_max]
        return torch.stack([diag, RL_i[fi_min], LR_i[fi_max],
                            RL_j[fj_min], LR_j[fj_max]], dim=1)

    vol_A = (_expand_2x2_diag(volume_laplace(level, gt=gt))
             + velocity_penalty_volume(level, gt))
    return {"A": slots(vol_A, Ai, Aj),
            "D": slots(continuity_volume(level, gt), Di, Dj),
            "G": slots(pressure_volume(level, gt), Gi, Gj),
            "fd": (fd_i_u, fd_j_u, fd_i_p, fd_j_p)}


def _uv_index(n, nu, device=None):
    """idx[g] = element-interleaved position of global [u; v] position g
    (dgtpu's permutation matrix ``_uv_permutation`` as an index)."""
    e = np.arange(n)[:, None] * 2 * nu + np.arange(nu)[None, :]
    return torch.as_tensor(np.concatenate([e.ravel(), (e + nu).ravel()]),
                           device=device)


def _global_uv_to_elem(uv_g, n, nu):
    u = uv_g[:n * nu].reshape(n, nu)
    v = uv_g[n * nu:].reshape(n, nu)
    return torch.cat([u, v], dim=1).reshape(-1)


def _elem_uv_to_global(uv_e, n, nu):
    uv = uv_e.reshape(n, 2 * nu)
    return torch.cat([uv[:, :nu].reshape(-1), uv[:, nu:].reshape(-1)])


@dataclass
class StokesGlobalOperator:
    """Saddle operator [[A, G], [D, 0]] on globally ordered vectors [u; v; p].

    Component stencils keep the 5-point structure; ``pin`` adds the single
    pressure-DOF pin used for direct solves (discrete_system.py:742).
    """

    A: StencilOperator       # (N, 5, 2Nu, 2Nu)
    D: StencilOperator       # (N, 5, Np, 2Nu)
    G: StencilOperator       # (N, 5, 2Nu, Np)
    pin: bool

    @property
    def sizes(self):
        n, _, nu2, _ = self.A.blocks.shape
        return n, nu2 // 2, self.D.blocks.shape[2]

    @property
    def shape(self):
        n, nu, npp = self.sizes
        tot = n * (2 * nu + npp)
        return (tot, tot)

    def split(self, x):
        n, nu, _ = self.sizes
        return x[:2 * n * nu], x[2 * n * nu:]

    def matvec(self, x):
        n, nu, _ = self.sizes
        uv_g, p = self.split(x)
        # global [all u; all v] -> per-element interleaved (N, 2Nu)
        uv = _global_uv_to_elem(uv_g, n, nu)
        mom = self.A.matvec(uv) + self.G.matvec(p)
        cont = self.D.matvec(uv)
        if self.pin:
            cont = cont.clone()
            cont[0] += p[0]
        return torch.cat([_elem_uv_to_global(mom, n, nu), cont])

    def to_dense(self):
        n, nu, npp = self.sizes
        idx = _uv_index(n, nu, self.A.blocks.device)
        A = self.A.to_dense()[idx][:, idx]
        D = self.D.to_dense()[:, idx]
        G = self.G.to_dense()[idx]
        Z = torch.zeros((n * npp, n * npp), dtype=A.dtype, device=A.device)
        if self.pin:
            Z[0, 0] = 1.0
        return torch.cat([torch.cat([A, G], dim=1), torch.cat([D, Z], dim=1)])


def _stencil(blocks, level):
    nbr = torch.as_tensor(level.nbr, dtype=torch.int64, device=level.device)
    mask = torch.as_tensor(level.nbr_mask, dtype=torch.bool, device=level.device)
    blocks = torch.where(mask[:, :, None, None], blocks,
                         torch.zeros((), dtype=blocks.dtype, device=blocks.device))
    return StencilOperator(blocks, nbr, mask)


def assemble_stokes(level, mms=None, direct=False):
    """Assemble the Stokes system on a level, in either ordering.

    Local order: ``level.op`` is one StencilOperator of block size 2Nu+Np
    (discrete_system.py:812-965).  Global order: ``level.op`` is a
    StokesGlobalOperator and the component stencils are stored on the level
    (``block_A/D/G``) for the distributive smoother (discrete_system.py:
    416-745).  ``direct`` pins one pressure DOF, for the direct solve.
    ``level.rhs`` (when ``mms`` is given) is in the operator's own ordering.
    """
    s = level.settings
    # the per-element bases up front, so a cache hit still leaves them to
    # the error evaluation and the pressure mean shift
    element_bases(level, vars=("u", "p"))
    cached = caching.load_stokes_parts(level)
    # a hit must carry a right-hand side whenever this call needs one
    if cached is not None and (mms is None or cached[3] is not None):
        *blocks, rhs, eps = cached
        A, D, G = (_stencil(b, level) for b in blocks)
        level.Epsilon = eps if eps is not None else 0.0
        parts = None
    else:
        parts = _element_blocks(level, level.gt)
        A, D, G = (_stencil(parts[c], level) for c in "ADG")
    ordering = s.solution.ordering
    if ordering == "global":
        level.block_A, level.block_D, level.block_G = A, D, G
        level.op = StokesGlobalOperator(A, D, G, pin=direct)
    else:
        nu2 = 2 * level.N_DOF_sol["u"]
        B = nu2 + level.N_DOF_sol["p"]
        blocks = A.blocks.new_zeros((level.N, 5, B, B))
        blocks[:, :, :nu2, :nu2] = A.blocks
        blocks[:, :, nu2:, :nu2] = D.blocks
        blocks[:, :, :nu2, nu2:] = G.blocks
        if direct:
            # pin one pressure DOF (discrete_system.py:946)
            blocks[0, 0, nu2, nu2] = 1.0
        level.op = StencilOperator(blocks, A.nbr, A.mask)
    if parts is not None:
        compute_mms_epsilon(level, mms)
        rhs = assemble_rhs_stokes(level, mms, parts["fd"]) if mms is not None else None
        caching.save_stokes_parts(level, A.blocks, D.blocks, G.blocks, rhs,
                                  level.Epsilon)
    if rhs is not None:
        level.rhs = reorder_local_to_global(level, rhs) if ordering == "global" else rhs
    return level.op


def assemble_rhs_stokes(level, mms, fds):
    """MMS right-hand side in local ordering (discrete_system.py:967-1029)."""
    s = level.settings
    nu = s.problem.kinematic_viscosity
    gt = level.gt
    dev = level.device
    nu_dof = level.N_DOF_sol["u"]
    fd_i_u, fd_j_u, fd_i_p, fd_j_p = fds

    gu = gt["u"]["e"]
    gp = gt["p"]["e"]
    rhs_u = source_volume_rhs(level, mms.f_momentum[0](gu["x"], gu["y"]), gt=gt)
    rhs_v = source_volume_rhs(level, mms.f_momentum[1](gu["x"], gu["y"]), gt=gt)
    # continuity source: -int q f_cont at p-quad (element.py:158-159)
    Vp = _vol_table(level, level.quad.V_sol_int["p"]["p"], "p")
    wJp = gp["J"] * _w(level, "p")
    f_cont = mms.f_continuity(gp["x"], gp["y"])
    rhs_p = -torch.einsum("nqi,nq,nq->ni", Vp, wJp, f_cont)

    include_p_bc = s.problem.include_pressure_BC
    for fd_u, fd_p, topo in ((fd_i_u, fd_i_p, level.faces_i),
                             (fd_j_u, fd_j_p, level.faces_j)):
        if topo.periodic:
            continue
        eR = torch.as_tensor(topo.eR, device=dev)
        eL = torch.as_tensor(topo.eL, device=dev)
        # boundary data at u-quad traces, and at p-quad traces
        gmin_u = (mms.u(fd_u.x_R, fd_u.y_R), mms.v(fd_u.x_R, fd_u.y_R))
        gmax_u = (mms.u(fd_u.x_L, fd_u.y_L), mms.v(fd_u.x_L, fd_u.y_L))
        gmin_p = (mms.u(fd_p.x_R, fd_p.y_R), mms.v(fd_p.x_R, fd_p.y_R))
        gmax_p = (mms.u(fd_p.x_L, fd_p.y_L), mms.v(fd_p.x_L, fd_p.y_L))

        bmin = torch.as_tensor(~topo.has_L, dtype=rhs_u.dtype, device=dev)[:, None]
        bmax = torch.as_tensor(~topo.has_R, dtype=rhs_u.dtype, device=dev)[:, None]

        c_min, c_max = continuity_dirichlet_rhs(fd_p, gmin_p, gmax_p)
        rhs_p = rhs_p.index_add(0, eR, c_min * bmin).index_add(0, eL, c_max * bmax)

        pu_min, pu_max = sip_dirichlet_rhs(fd_u, nu, level.sigma,
                                           gmin_u[0], gmax_u[0])
        pv_min, pv_max = sip_dirichlet_rhs(fd_u, nu, level.sigma,
                                           gmin_u[1], gmax_u[1])
        rhs_u = rhs_u.index_add(0, eR, pu_min * bmin).index_add(0, eL, pu_max * bmax)
        rhs_v = rhs_v.index_add(0, eR, pv_min * bmin).index_add(0, eL, pv_max * bmax)

        vp_min, vp_max = velocity_penalty_dirichlet_rhs(fd_u, level.gamma,
                                                        gmin_u, gmax_u)
        rhs_u = rhs_u.index_add(0, eR, vp_min[:, :nu_dof] * bmin)
        rhs_v = rhs_v.index_add(0, eR, vp_min[:, nu_dof:] * bmin)
        rhs_u = rhs_u.index_add(0, eL, vp_max[:, :nu_dof] * bmax)
        rhs_v = rhs_v.index_add(0, eL, vp_max[:, nu_dof:] * bmax)

        if include_p_bc:
            gp_min = mms.p(fd_u.x_R, fd_u.y_R)
            gp_max = mms.p(fd_u.x_L, fd_u.y_L)
            pb_min, pb_max = pressure_dirichlet_rhs(fd_u, gp_min, gp_max)
            rhs_u = rhs_u.index_add(0, eR, pb_min[:, :nu_dof] * bmin)
            rhs_v = rhs_v.index_add(0, eR, pb_min[:, nu_dof:] * bmin)
            rhs_u = rhs_u.index_add(0, eL, pb_max[:, :nu_dof] * bmax)
            rhs_v = rhs_v.index_add(0, eL, pb_max[:, nu_dof:] * bmax)

    return torch.cat([rhs_u, rhs_v, rhs_p], dim=1).reshape(-1)


def _dg_diag_blocks(D_op, G_op):
    """Diagonal (Np x Np) blocks of DG = D @ G from the component stencils
    (dgtpu's ``parallel/stokes_halo._dg_diag_blocks``; it lives here so the
    single-GPU route needs no distributed module).

    (DG)[e,e] = sum_s D[e,s] @ G[nbr(e,s), mirror(s)] — the column block of G
    coupling the s-neighbor's momentum rows back to e's pressure.  Setup
    work in float64 on the host, like ``ops.linalg.host_inv``; the result
    comes back on the operator's device.
    """
    Db = np.where(D_op.mask.cpu().numpy()[:, :, None, None],
                  D_op.blocks.cpu().numpy(), 0.0)
    Gb = np.where(G_op.mask.cpu().numpy()[:, :, None, None],
                  G_op.blocks.cpu().numpy(), 0.0)
    nbr = D_op.nbr.cpu().numpy()
    n = Db.shape[0]
    out = np.zeros((n, Db.shape[2], Db.shape[2]))
    for s in range(5):
        G_back = Gb[nbr[:, s], _MIRROR[s]]          # (N, 2Nu, Np)
        out += np.einsum("npu,nuq->npq", Db[:, s], G_back)
    return torch.from_numpy(out).to(D_op.blocks.device)


# --------------------------------------------------------------------------
# transfers
# --------------------------------------------------------------------------

class StokesPolynomialTransfer:
    """p-coarsening transfer on globally ordered Stokes vectors [u; v; p]:
    each component gets its zero-padded-identity modal restriction applied
    per element."""

    kind = "polynomial"

    def __init__(self, N, pu_fine, pu_coarse, pp_fine, pp_coarse, device="cpu"):
        self.N = N
        self.Ru = torch.as_tensor(p_restriction(pu_fine, pu_coarse), device=device)
        self.Rp = torch.as_tensor(p_restriction(pp_fine, pp_coarse), device=device)
        self.nu_f, self.nu_c = (pu_fine + 1) ** 2, (pu_coarse + 1) ** 2
        self.np_f, self.np_c = (pp_fine + 1) ** 2, (pp_coarse + 1) ** 2

    def _split(self, vec, nu, npd):
        n = self.N
        return (vec[:n * nu].reshape(n, nu), vec[n * nu:2 * n * nu].reshape(n, nu),
                vec[2 * n * nu:].reshape(n, npd))

    def restrict(self, vec):
        u, v, p = self._split(vec, self.nu_f, self.np_f)
        return torch.cat([(u @ self.Ru.T).reshape(-1), (v @ self.Ru.T).reshape(-1),
                          (p @ self.Rp.T).reshape(-1)])

    def prolong(self, vec):
        u, v, p = self._split(vec, self.nu_c, self.np_c)
        return torch.cat([(u @ self.Ru).reshape(-1), (v @ self.Ru).reshape(-1),
                          (p @ self.Rp).reshape(-1)])


def _tiles(vec, nj_c, ni_c, B):
    """(4 N_c B,) element-ordered fine vector -> (N_c, 4 B) rows of 2x2 tiles
    with (child_j, child_i, mode) columns (dgtpu's ``_gather_tiles``)."""
    v = vec.reshape(nj_c, 2, ni_c, 2, B).permute(0, 2, 1, 3, 4)
    return v.reshape(nj_c * ni_c, 4 * B)


def _untile(rows, nj_c, ni_c, B):
    return rows.reshape(nj_c, ni_c, 2, 2, B).permute(0, 2, 1, 3, 4).reshape(-1)


class StokesGeometricTransfer:
    """2x2 geometric (h) transfer on globally ordered Stokes vectors: each
    component restricts / prolongs with the scalar L2-projection
    agglomeration operator of its own degree (``tu`` for u and v, ``tp`` for
    p; dgtpu's StokesGeometricTransfer)."""

    kind = "geometric"

    def __init__(self, Ni_c, Nj_c, pu, pp, device="cpu"):
        self.tu = make_transfer("geometric", p_fine=pu, cf=2, device=device)
        self.tp = make_transfer("geometric", p_fine=pp, cf=2, device=device)
        self.Ni_c, self.Nj_c = Ni_c, Nj_c
        self.N_f, self.N_c = 4 * Ni_c * Nj_c, Ni_c * Nj_c
        self.nu, self.npd = (pu + 1) ** 2, (pp + 1) ** 2

    def _split(self, vec, n):
        nu = self.nu
        return vec[:n * nu], vec[n * nu:2 * n * nu], vec[2 * n * nu:]

    def restrict(self, vec):
        u, v, p = self._split(vec, self.N_f)
        nj, ni = self.Nj_c, self.Ni_c
        out = [(_tiles(x, nj, ni, B) @ t.R.T).reshape(-1)
               for x, t, B in ((u, self.tu, self.nu), (v, self.tu, self.nu),
                               (p, self.tp, self.npd))]
        return torch.cat(out)

    def prolong(self, vec):
        u, v, p = self._split(vec, self.N_c)
        nj, ni = self.Nj_c, self.Ni_c
        out = [_untile(x.reshape(-1, B) @ t.P.T, nj, ni, B)
               for x, t, B in ((u, self.tu, self.nu), (v, self.tu, self.nu),
                               (p, self.tp, self.npd))]
        return torch.cat(out)


# --------------------------------------------------------------------------
# reorderings, pressure post-processing, Epsilon
# --------------------------------------------------------------------------

def reorder_local_to_global(level, vec):
    """[per-element u,v,p] -> [all u; all v; all p] (helpers.py:60-80)."""
    nu, npd = level.N_DOF_sol["u"], level.N_DOF_sol["p"]
    m = vec.reshape(level.N, 2 * nu + npd)
    return torch.cat([m[:, :nu].reshape(-1), m[:, nu:2 * nu].reshape(-1),
                      m[:, 2 * nu:].reshape(-1)])


def reorder_global_to_local(level, vec):
    """[all u; all v; all p] -> [per-element u,v,p] (helpers.py:41-58)."""
    n = level.N
    nu, npd = level.N_DOF_sol["u"], level.N_DOF_sol["p"]
    u = vec[:n * nu].reshape(n, nu)
    v = vec[n * nu:2 * n * nu].reshape(n, nu)
    p = vec[2 * n * nu:].reshape(n, npd)
    return torch.cat([u, v, p], dim=1).reshape(-1)


def pressure_integral(level, p_modal):
    """int p dA per element (element.py:151-153); p_modal (N, Np)."""
    Vp = _vol_table(level, level.quad.V_sol_int["p"]["p"], "p")
    wJ = level.gt["p"]["e"]["J"] * _w(level, "p")
    p_int = torch.einsum("nqi,ni->nq", Vp, p_modal)
    return torch.sum(p_int * wJ, dim=1)


def pressure_mean_shift(level, u_el):
    """Subtract the numerical pressure mean (dgfem.py:170-186): the
    mode-(0,0) coefficient shifts by 2*mean since phi_00 = 1/2; under the
    physical-element orthonormal p basis the constant mode is
    norms_e0 * 1/2 per element, so the shift divides by norms_e0."""
    npd = level.N_DOF_sol["p"]
    mean = (torch.sum(pressure_integral(level, u_el[:, -npd:]))
            / torch.sum(level.gt["A"]))
    shift = -2.0 * mean
    eb_p = (getattr(level, "element_basis", None) or {}).get("p")
    if eb_p is not None:
        shift = shift / eb_p.norms[:, 0]
    out = u_el.clone()
    out[:, -npd] += shift
    return out


def compute_mms_epsilon(level, mms):
    """Global mass-defect constant Epsilon (grid.py:227-269)."""
    if (mms is None or mms.f_continuity is None
            or not level.settings.solution.manufactured_solution):
        level.Epsilon = 0.0
        return 0.0
    gp = level.gt["p"]["e"]
    wJ = gp["J"] * _w(level, "p")
    f_int = torch.sum(mms.f_continuity(gp["x"], gp["y"]) * wJ)
    # boundary integral of u.n (outward; the L-boundary uses -n_R as in
    # face.py:69-77)
    u_dot_n = 0.0
    for topo in (level.faces_i, level.faces_j):
        if topo.periodic:
            continue
        fd = FaceData(level, topo, "p")
        gu_min = (mms.u(fd.x_R, fd.y_R), mms.v(fd.x_R, fd.y_R))
        gu_max = (mms.u(fd.x_L, fd.y_L), mms.v(fd.x_L, fd.y_L))
        gn_min = gu_min[0] * fd.mt_R["nx"] + gu_min[1] * fd.mt_R["ny"]
        gn_max = gu_max[0] * fd.mt_L["nx"] + gu_max[1] * fd.mt_L["ny"]
        bmin = torch.as_tensor(~topo.has_L, dtype=gn_min.dtype, device=level.device)
        bmax = torch.as_tensor(~topo.has_R, dtype=gn_min.dtype, device=level.device)
        u_dot_n = u_dot_n + torch.sum(-bmin[:, None] * gn_min * fd.wJ)
        u_dot_n = u_dot_n + torch.sum(bmax[:, None] * gn_max * fd.wJ)
    level.Epsilon = float((f_int - u_dot_n) / torch.sum(level.gt["A"]))
    return level.Epsilon


# --------------------------------------------------------------------------
# distributive Gauss-Seidel (relaxation.py:220-441)
# --------------------------------------------------------------------------

def _dense_sym_bgs(A, Dinv, b, x, blocksize):
    x = dense_block_gs_sweep(A, b, x, blocksize, backward=False, Dinv=Dinv)
    return dense_block_gs_sweep(A, b, x, blocksize, backward=True, Dinv=Dinv)


def _diag_blocks(A, B):
    """The (n, B, B) diagonal blocks of a dense (n B, n B) matrix."""
    n = A.shape[0] // B
    e = torch.arange(n, device=A.device)
    return A.reshape(n, B, n, B)[e, :, e, :]


class DistributiveGS:
    """Distributive GS smoother state for a global-order Stokes level.

    Materializes the dense A, D, G, D@G (and the Schur pieces for the
    classical splittings) once on the operators' device; each ``sweep`` is
    a fixed sequence of dense products and sequential block-GS sweeps.  The
    diagonal-block inverses run on host LAPACK, as dgtpu's do; the dense
    inverses of the classical splittings run through ``torch.linalg`` on the
    device (dgtpu inverts on the host: the two agree to rounding).
    """

    def __init__(self, level, splitting="lsq"):
        if level.block_A is None:
            raise ValueError("Distributive GS needs a global-order Stokes assembly")
        self.splitting = splitting
        n, nu, npd = level.N, level.N_DOF_sol["u"], level.N_DOF_sol["p"]
        self.n, self.nu, self.npd = n, nu, npd
        idx = _uv_index(n, nu, level.block_A.blocks.device)
        self.A = level.block_A.to_dense()[idx][:, idx]
        self.D = level.block_D.to_dense()[:, idx]
        self.G = level.block_G.to_dense()[idx]
        self.A_Dinv = host_inv(_diag_blocks(self.A, nu))
        if splitting == "lsq":
            self.DG = self.D @ self.G
            self.DG_Dinv = host_inv(_diag_blocks(self.DG, npd))
        elif splitting in ("classical", "classical_exact"):
            if splitting == "classical":
                A_D = torch.zeros_like(self.A)
                e = torch.arange(2 * n, device=A_D.device)
                A_D.view(2 * n, nu, 2 * n, nu)[e, :, e, :] = _diag_blocks(self.A, nu)
                Ainv = torch.linalg.inv(A_D)
                self.A_D = A_D          # its diagonal blocks are A's: A_Dinv
            else:
                Ainv = torch.linalg.inv(self.A)
            self.Schur = -self.D @ Ainv @ self.G
            self.Schur_Dinv = host_inv(_diag_blocks(self.Schur, npd))

    def sweep(self, rhs, x):
        """One distributive GS iteration on the global vector [u; v; p]."""
        n, nu, npd = self.n, self.nu, self.npd
        idx_u = 2 * n * nu
        u_k, p_k = x[:idx_u], x[idx_u:]
        f_mom, f_cont = rhs[:idx_u], rhs[idx_u:]
        rhs_mom = f_mom - self.A @ u_k - self.G @ p_k
        if self.splitting == "lsq":
            du_s = _dense_sym_bgs(self.A, self.A_Dinv, rhs_mom,
                                  torch.zeros_like(u_k), nu)
            rhs_cont = f_cont - self.D @ (u_k + du_s)
            dp_s = _dense_sym_bgs(self.DG, self.DG_Dinv, rhs_cont,
                                  torch.zeros_like(p_k), npd)
            du = du_s + self.G @ dp_s
            rhs_dg = -self.D @ (self.A @ (self.G @ dp_s))
            dp = _dense_sym_bgs(self.DG, self.DG_Dinv, rhs_dg,
                                torch.zeros_like(p_k), npd)
        elif self.splitting in ("classical", "classical_exact"):
            # 'classical' diverges as the reference documents
            # (relaxation.py:286): its Schur complement uses the
            # block-diagonal A inverse.  Kept for parity; 'classical_exact'
            # (relaxation.py:400-438 with the exact Schur complement) and
            # 'lsq' converge.
            A_s = self.A_D if self.splitting == "classical" else self.A
            du_s = _dense_sym_bgs(A_s, self.A_Dinv, rhs_mom, torch.zeros_like(u_k), nu)
            rhs_cont = f_cont - self.D @ (u_k + du_s)
            dp_s = _dense_sym_bgs(self.Schur, self.Schur_Dinv, rhs_cont,
                                  torch.zeros_like(p_k), npd)
            rhs_a = self.A @ du_s - self.G @ dp_s
            du = _dense_sym_bgs(self.A, self.A_Dinv, rhs_a, torch.zeros_like(u_k), nu)
            dp = dp_s
        else:
            raise ValueError(self.splitting)
        return torch.cat([u_k + du, p_k + dp])


class StencilDGS:
    """lsq-splitting distributive GS in 5-point stencil (rolled) form: DG
    applies as two composed stencil matvecs and only the per-element
    diagonal blocks are inverted (host LAPACK at setup).  The component
    solves are red-black colored block-GS passes (dgtpu's documented
    deviation from the reference's lexicographic dense sweeps; the dense
    sequential form is ``splitting='lsq_dense'``)."""

    def __init__(self, level, n_pass=2):
        if level.block_A is None:
            raise ValueError("Distributive GS needs a global-order Stokes assembly")
        self.n, self.nu = level.N, level.N_DOF_sol["u"]
        self.npd = level.N_DOF_sol["p"]
        self.Ni, self.Nj = Ni, Nj = level.Ni, level.Nj
        self.n_pass = n_pass
        self.A = rolled.to_rolled(level.block_A, Ni, Nj)
        self.D = rolled.to_rolled(level.block_D, Ni, Nj)
        self.G = rolled.to_rolled(level.block_G, Ni, Nj)
        self.A_Dinv = host_inv(self.A[:, :, 0])
        self.DG_diag = _dg_diag_blocks(level.block_D, level.block_G).reshape(
            Nj, Ni, self.npd, self.npd)
        self.DG_Dinv = host_inv(self.DG_diag)
        self.colors = rolled.checkerboard(Nj, Ni, device=self.A.device)

    def _bgs(self, blocks, Dinv, rhs, x):
        for _ in range(self.n_pass):
            for c in (0, 1):
                xn = rolled.bmv(Dinv, rhs - rolled.offdiag_matvec(blocks, x))
                x = torch.where((self.colors == c)[:, :, None], xn, x)
        return x

    def _bgs_dg(self, rhs, p):
        for _ in range(self.n_pass):
            for c in (0, 1):
                off = (rolled.matvec(self.D, rolled.matvec(self.G, p))
                       - rolled.bmv(self.DG_diag, p))
                pn = rolled.bmv(self.DG_Dinv, rhs - off)
                p = torch.where((self.colors == c)[:, :, None], pn, p)
        return p

    def sweep(self, rhs, x):
        """One distributive GS iteration on the global vector [u; v; p]."""
        n, nu, npd = self.n, self.nu, self.npd
        Nj, Ni = self.Nj, self.Ni
        idx_u = 2 * n * nu
        uv = _global_uv_to_elem(x[:idx_u], n, nu).reshape(Nj, Ni, 2 * nu)
        p = x[idx_u:].reshape(Nj, Ni, npd)
        f_mom = _global_uv_to_elem(rhs[:idx_u], n, nu).reshape(Nj, Ni, 2 * nu)
        f_cont = rhs[idx_u:].reshape(Nj, Ni, npd)

        rhs_mom = f_mom - rolled.matvec(self.A, uv) - rolled.matvec(self.G, p)
        du_s = self._bgs(self.A, self.A_Dinv, rhs_mom, torch.zeros_like(uv))
        rhs_cont = f_cont - rolled.matvec(self.D, uv + du_s)
        dp_s = self._bgs_dg(rhs_cont, torch.zeros_like(p))
        G_dp = rolled.matvec(self.G, dp_s)
        du = du_s + G_dp
        rhs_dg = -rolled.matvec(self.D, rolled.matvec(self.A, G_dp))
        dp = self._bgs_dg(rhs_dg, torch.zeros_like(p))

        uv_g = _elem_uv_to_global((uv + du).reshape(-1), n, nu)
        return torch.cat([uv_g, (p + dp).reshape(-1)])


def make_dgs(level, splitting="lsq"):
    """Distributive-GS smoother factory: ``lsq`` (the reference default) in
    stencil form, ``lsq_dense`` the dense sequential-sweep variant, the
    ``classical*`` Schur splittings dense (they need an approximation of
    A^-1)."""
    if splitting == "lsq":
        return StencilDGS(level)
    if splitting == "lsq_dense":
        return DistributiveGS(level, splitting="lsq")
    return DistributiveGS(level, splitting=splitting)


def distributive_gauss_seidel_solve(level, rhs, u0=None, splitting="lsq",
                                    max_iterations=1000, tol=1e-6, div_tol=1e10):
    """Residual-tracked distributive GS solve (relaxation.py:236-283).

    Returns ``(u, residual_history, n, status)`` with status 0 (converged),
    1 (max iterations) or 2 (diverged, a non-finite residual included), as
    the relaxation driver.  A host loop with one residual read per sweep;
    the history holds ``min(max_iterations, 20000)`` entries (numpy,
    NaN-padded past the last sweep) as dgtpu's does.
    """
    dgs = make_dgs(level, splitting)
    op = level.op
    u = torch.zeros_like(rhs) if u0 is None else u0
    max_iterations = int(min(max_iterations, 100000))
    hist = np.full(min(max_iterations, 20000), np.nan)
    res0 = float(lp_norm(rhs - op.matvec(u), 2))
    res = float(lp_norm(rhs - op.matvec(u), 2)) / res0 if res0 else math.nan
    n = 0
    while n < max_iterations and tol <= res <= div_tol and math.isfinite(res):
        u = dgs.sweep(rhs, u)
        res = float(lp_norm(rhs - op.matvec(u), 2)) / res0
        if n < hist.size:
            hist[n] = res
        n += 1
    return u, hist, n, tracked_status(res, tol, div_tol)
