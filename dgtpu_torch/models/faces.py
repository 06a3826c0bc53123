"""Batched DG face kernels: SIP flux / penalty / symmetrizing, and the Stokes
continuity, pressure and velocity-penalty terms (port of
``dgtpu/models/faces.py``).

The reference's three face branches (interior / left-boundary /
right-boundary, ``dgfem/face.py:115-372``) collapse into one batched
formula per term with per-face scalars:

    w_L, w_R : trial-side averaging weights (1/2, 1/2 interior; 1/0 one-sided)
    p_L, p_R : presence indicators (penalty terms use full sigma either way)
    J        : face Jacobian — the L element's 'max' trace when L exists,
               else the R element's 'min' trace (face.py:13-35)
    h_F      : mean sqrt(element area) of the present sides

Each kernel returns ``(LL, LR, RL, RR)`` stacks of shape (F, B_test,
B_trial).
"""

import torch


class FaceData:
    """Gathered per-face geometry for one direction and one quadrature var.

    ``trace``: Vandermondes of a basis on the L ('max') / R ('min') side;
    ``grad_normal``: normal-derivative traces of that basis built from each
    side's own metric terms; normals point from L into R (element.py:96-102).
    """

    def __init__(self, level, topo, var_quad, gt=None, element_basis=None):
        gt = gt if gt is not None else level.gt
        self.eb = element_basis
        dev = level.device
        g = gt[var_quad]
        sL, sR = topo.side_L, topo.side_R
        eL = torch.as_tensor(topo.eL, device=dev)
        eR = torch.as_tensor(topo.eR, device=dev)

        def t(a):
            return torch.as_tensor(a, dtype=torch.float64, device=dev)

        self.topo = topo
        self.w_q = t(level.quad.w_int[var_quad])
        has_L = torch.as_tensor(topo.has_L, device=dev)[:, None]
        self.J = torch.where(has_L, g[sL]["Jf"][eL], g[sR]["Jf"][eR])
        self.h_F = level.h_F(topo)
        self.w_L, self.w_R = t(topo.w_L), t(topo.w_R)
        self.p_L, self.p_R = t(topo.p_L), t(topo.p_R)
        # per-side metric terms at the trace quadrature points
        keys = ("rx", "sx", "ry", "sy", "nx", "ny")
        self.mt_L = {k: g[sL][k][eL] for k in keys}
        self.mt_R = {k: g[sR][k][eR] for k in keys}
        # boundary-side physical coordinates (for Dirichlet data)
        self.x_L, self.y_L = g[sL]["x"][eL], g[sL]["y"][eL]
        self.x_R, self.y_R = g[sR]["x"][eR], g[sR]["y"][eR]
        self._level = level
        self._var_quad = var_quad
        self.wJ = self.w_q[None, :] * self.J       # (F, nq)

    def _per_face(self, table, elem_idx, var_basis):
        """Shared (nq, B) table -> (F, nq, B): the element ``elem_idx``'s
        per-element table where the physical-element orthonormal basis of
        ``var_basis`` is active (face.py:43-59; ``element_basis`` is a
        {var: ElementBasis} dict), else a broadcast view."""
        eb = (self.eb or {}).get(var_basis)
        if eb is not None:
            return eb.apply(table)[torch.as_tensor(elem_idx, device=self._level.device)]
        table = torch.as_tensor(table, dtype=torch.float64,
                                device=self._level.device)
        return table.expand(self.topo.n_faces, *table.shape)

    def trace(self, var_basis):
        """(V_L, V_R) trace Vandermondes of a basis, each (F, nq, B)."""
        q = self._level.quad
        sL, sR = self.topo.side_L, self.topo.side_R
        return (self._per_face(q.V_sol_face[sL][var_basis][self._var_quad],
                               self.topo.eL, var_basis),
                self._per_face(q.V_sol_face[sR][var_basis][self._var_quad],
                               self.topo.eR, var_basis))

    def grad_normal(self, var_basis):
        """(Gn_L, Gn_R): n . grad(phi) traces, each (F, nq, B)."""
        q = self._level.quad
        sL, sR = self.topo.side_L, self.topo.side_R
        out = []
        for side_key, mt, idx in ((sL, self.mt_L, self.topo.eL),
                                  (sR, self.mt_R, self.topo.eR)):
            Vr = self._per_face(q.Vr_sol_face[side_key][var_basis][self._var_quad],
                                idx, var_basis)
            Vs = self._per_face(q.Vs_sol_face[side_key][var_basis][self._var_quad],
                                idx, var_basis)
            gx = Vr * mt["rx"][:, :, None] + Vs * mt["sx"][:, :, None]
            gy = Vr * mt["ry"][:, :, None] + Vs * mt["sy"][:, :, None]
            out.append(gx * mt["nx"][:, :, None] + gy * mt["ny"][:, :, None])
        return out[0], out[1]


def sip_terms(fd, nu, sigma, var="u"):
    """Sum of the SIP consistency-flux, penalty, and symmetrizing face terms.

    Reference: face.py:115-280 (compute_momentum_laplace_SIP_*).
    """
    V_L, V_R = fd.trace(var)
    Gn_L, Gn_R = fd.grad_normal(var)
    wJ = fd.wJ

    def contract(A, Bm, coef):
        # coef_f * sum_q wJ[f,q] A[f,q,i] Bm[f,q,k] -> (F, k, i)
        return torch.einsum("fq,fqi,fqk->fki", coef[:, None] * wJ, A, Bm)

    # consistency flux: res_XY = t_X * nu * w_Y * <Gn_Y, V_X>,  t_L=-1, t_R=+1
    LL = contract(Gn_L, V_L, -nu * fd.w_L)
    LR = contract(Gn_R, V_L, -nu * fd.w_R)
    RL = contract(Gn_L, V_R, +nu * fd.w_L)
    RR = contract(Gn_R, V_R, +nu * fd.w_R)

    # penalty: res_XY = s_X * c_Y * sigma*nu/h * p_Y * <V_Y, V_X>
    pen = sigma * nu / fd.h_F
    LL = LL + contract(V_L, V_L, +pen * fd.p_L)
    LR = LR + contract(V_R, V_L, -pen * fd.p_R)
    RL = RL + contract(V_L, V_R, -pen * fd.p_L)
    RR = RR + contract(V_R, V_R, +pen * fd.p_R)

    # symmetrizing: res_XY = -(sign_Y) * nu * w_Y * <V_Y[.,i] Gn_X[.,k]>
    LL = LL + contract(V_L, Gn_L, -nu * fd.w_L)
    LR = LR + contract(V_R, Gn_L, +nu * fd.w_R)
    RL = RL + contract(V_L, Gn_R, -nu * fd.w_L)
    RR = RR + contract(V_R, Gn_R, +nu * fd.w_R)

    return LL, LR, RL, RR


def sip_dirichlet_rhs(fd, nu, sigma, g_min, g_max, var="u"):
    """Dirichlet boundary contributions of the SIP penalty + symmetrizing terms.

    ``g_min[f, q]``: boundary data at min-side boundary faces (element R
    present), ``g_max`` at max-side ones.  Returns (rhs_min, rhs_max) of shape
    (F, B), to be scatter-added to eR / eL on boundary faces only.
    Reference: face.py:180-254 (note the sign flip between min and max sides).
    """
    V_L, V_R = fd.trace(var)
    Gn_L, Gn_R = fd.grad_normal(var)
    pen = sigma * nu / fd.h_F
    rhs_min = torch.einsum("f,fqi,fq,fq->fi", pen, V_R, g_min, fd.wJ)
    rhs_min = rhs_min + nu * torch.einsum("fqi,fq,fq->fi", Gn_R, g_min, fd.wJ)
    rhs_max = torch.einsum("f,fqi,fq,fq->fi", pen, V_L, g_max, fd.wJ)
    rhs_max = rhs_max - nu * torch.einsum("fqi,fq,fq->fi", Gn_L, g_max, fd.wJ)
    return rhs_min, rhs_max


def continuity_surface(fd_p):
    """Stokes continuity face jumps: int_F q [u . n] (face.py:79-113).

    ``fd_p``: FaceData at the *pressure* quadrature.  Returns 4 stacks of
    shape (F, Np, 2*Nu) with trial columns [u | v].
    """
    V_Lu, V_Ru = fd_p.trace("u")
    V_Lp, V_Rp = fd_p.trace("p")
    wJ = fd_p.wJ

    def block(V_test_p, Vu_trial, n_trial, coef):
        # res[f, k, i] = coef_f * sum_q wJ Vu[q,i] n_a[f,q] Vp[q,k]
        cols = [torch.einsum("f,fq,fqi,fq,fqk->fki", coef, wJ, Vu_trial,
                             n_trial[a], V_test_p) for a in range(2)]
        return torch.cat(cols, dim=2)

    n_L = (fd_p.mt_L["nx"], fd_p.mt_L["ny"])
    n_R = (fd_p.mt_R["nx"], fd_p.mt_R["ny"])
    LL = block(V_Lp, V_Lu, n_L, +fd_p.w_L)
    LR = block(V_Lp, V_Ru, n_R, -fd_p.w_R)
    RL = block(V_Rp, V_Lu, n_L, +fd_p.w_L)
    RR = block(V_Rp, V_Ru, n_R, -fd_p.w_R)
    return LL, LR, RL, RR


def continuity_dirichlet_rhs(fd_p, g_min, g_max):
    """Boundary data for the continuity jumps: -/+ int q (g . n)
    (face.py:80-93).  ``g_min``/``g_max``: (g_u, g_v) at the present side's
    p-quadrature trace points; returns (rhs_min, rhs_max), each (F, Np)."""
    V_Lp, V_Rp = fd_p.trace("p")
    wJ = fd_p.wJ
    gn_min = g_min[0] * fd_p.mt_R["nx"] + g_min[1] * fd_p.mt_R["ny"]
    gn_max = g_max[0] * fd_p.mt_L["nx"] + g_max[1] * fd_p.mt_L["ny"]
    rhs_min = -torch.einsum("fqi,fq,fq->fi", V_Rp, gn_min, wJ)
    rhs_max = +torch.einsum("fqi,fq,fq->fi", V_Lp, gn_max, wJ)
    return rhs_min, rhs_max


def pressure_surface(fd_u):
    """Momentum pressure-flux term int_F {p} [psi . n] (face.py:282-320).

    Returns (F, 2*Nu, Np) stacks with test rows [x; y].
    """
    V_Lu, V_Ru = fd_u.trace("u")
    V_Lp, V_Rp = fd_u.trace("p")
    wJ = fd_u.wJ
    n_L = (fd_u.mt_L["nx"], fd_u.mt_L["ny"])
    n_R = (fd_u.mt_R["nx"], fd_u.mt_R["ny"])

    def block(V_test_u, Vp_trial, n_trial, coef):
        rows = [torch.einsum("f,fq,fqi,fq,fqk->fki", coef, wJ, Vp_trial,
                             n_trial[a], V_test_u) for a in range(2)]
        return torch.cat(rows, dim=1)

    LL = block(V_Lu, V_Lp, n_L, +fd_u.w_L)
    LR = block(V_Lu, V_Rp, n_R, +fd_u.w_R)
    RL = block(V_Ru, V_Lp, n_L, -fd_u.w_L)
    RR = block(V_Ru, V_Rp, n_R, -fd_u.w_R)
    return LL, LR, RL, RR


def pressure_dirichlet_rhs(fd_u, gp_min, gp_max):
    """Optional pressure Dirichlet data (include_pressure_BC, face.py:284-300)."""
    V_Lu, V_Ru = fd_u.trace("u")
    wJ = fd_u.wJ

    def rhs(V, gp, n, sign):
        parts = [sign * torch.einsum("fqi,fq->fi", V, gp * wJ * n[a])
                 for a in range(2)]
        return torch.cat(parts, dim=1)

    rhs_min = rhs(V_Ru, gp_min, (fd_u.mt_R["nx"], fd_u.mt_R["ny"]), -1.0)
    rhs_max = rhs(V_Lu, gp_max, (fd_u.mt_L["nx"], fd_u.mt_L["ny"]), +1.0)
    return rhs_min, rhs_max


def velocity_penalty_surface(fd_u, gamma):
    """Grad-div face penalty gamma/h int_F (u.n)(psi.n) (face.py:322-372).

    Returns (F, 2Nu, 2Nu) stacks: trial cols [u|v], test rows [x;y].
    """
    V_Lu, V_Ru = fd_u.trace("u")
    wJ = fd_u.wJ
    n_L = (fd_u.mt_L["nx"], fd_u.mt_L["ny"])
    n_R = (fd_u.mt_R["nx"], fd_u.mt_R["ny"])

    def block(V_test, V_trial, n_trial, coef):
        # res[f, k + b*Nu, i + a*Nu] = coef * sum_q wJ V_trial[q,i] n_a n_b V_test[q,k]
        rows = []
        for b in range(2):
            cols = [torch.einsum("f,fq,fqi,fq,fqk->fki", coef, wJ, V_trial,
                                 n_trial[a] * n_trial[b], V_test)
                    for a in range(2)]
            rows.append(torch.cat(cols, dim=2))
        return torch.cat(rows, dim=1)

    pen_L = gamma / fd_u.h_F * fd_u.p_L
    pen_R = gamma / fd_u.h_F * fd_u.p_R
    LL = block(V_Lu, V_Lu, n_L, +pen_L)
    LR = block(V_Lu, V_Ru, n_R, -pen_R)
    RL = block(V_Ru, V_Lu, n_L, -pen_L)
    RR = block(V_Ru, V_Ru, n_R, +pen_R)
    return LL, LR, RL, RR


def velocity_penalty_dirichlet_rhs(fd_u, gamma, g_min, g_max):
    """Boundary data of the grad-div penalty (face.py:324-342)."""
    V_Lu, V_Ru = fd_u.trace("u")
    wJ = fd_u.wJ

    def rhs(V, g, n, h):
        gn = (g[0] * n[0] + g[1] * n[1]) * wJ
        parts = [gamma / h[:, None] * torch.einsum("fqi,fq->fi", V, gn * n[a])
                 for a in range(2)]
        return torch.cat(parts, dim=1)

    rhs_min = rhs(V_Ru, g_min, (fd_u.mt_R["nx"], fd_u.mt_R["ny"]), fd_u.h_F)
    rhs_max = rhs(V_Lu, g_max, (fd_u.mt_L["nx"], fd_u.mt_L["ny"]), fd_u.h_F)
    return rhs_min, rhs_max
