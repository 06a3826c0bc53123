"""Stokes distributive-GS multigrid cycle in the SoA (cells-in-lanes) layout.

Port of ``dgtpu/ops/pallas_stokes.py`` (``SoAStokesVCycle``).  The state is
four lattices per level: velocity ``uv (2, 2Nu, C)`` (color, element-
interleaved [u-modes; v-modes], cell) and pressure ``p (2, Np, C)``; the
component stencils A (momentum), G (pressure gradient) and D (divergence)
are per-color SoA tensors ``(2, 5, B_src, B_dst, C)``.

The TPU runs a whole cycle as one Pallas kernel.  Here the host recursion
(:meth:`SoAStokesVCycle._cycle`) calls phase functions, each a hand-written
CUDA kernel for CUDA tensors and its plain torch version for CPU tensors:

    K1 half_sweep     (ops/soa.py)  red-black block-GS on A       (_bgs_A)
    K3 small_gemm     (ops/soa.py)  polynomial R/P, dense coarse inverse
    K4 geo_transfer   (ops/soa.py)  2x2 agglomeration, per component
    K5 stencil_apply  (ops/soa.py)  every stencil matvec of the sweep, the
                                    saddle residual, build_matvec
    K6 dg_half_sweep  (here)        one color of the pressure DG pass (_bgs_dg)

All five are in ``csrc/soa_kernels.cu``.  The sweep's vector additions ride
on the kernels' ``base`` operands, so a cycle runs no torch arithmetic
between launches.

The plain versions keep dgtpu's roll-and-blend spelling (``ops/soa.py``
``_mac``/``_off``), so kernel against plain is an independent check of the
kernels' index arithmetic.  ``SoAStokesVCycle(reference=True)`` calls the
plain versions on any device.
"""

import numpy as np
import torch

from dgtpu_torch.models.stokes import (_dg_diag_blocks, _elem_uv_to_global,
                                       _global_uv_to_elem)
from dgtpu_torch.ops import _kernels, rolled, soa
from dgtpu_torch.ops.linalg import host_inv, host_lu_inverse
from dgtpu_torch.ops.soa import (_mac, _off, _packed_pos, is_periodic,
                                 lane_masks, soa_blocks, soa_diag)

_DGS = "distributive_gauss_seidel"


class StokesSoALevel:
    """One level's SoA operands in the per-color (5, B_src, B_dst, C) layout:
    ``A (2, 5, 2Nu, 2Nu, C)``, ``G (2, 5, Np, 2Nu, C)`` (p -> momentum rows),
    ``D (2, 5, 2Nu, Np, C)`` (uv -> continuity rows); ``A_Dinv (2, 2Nu, 2Nu,
    C)``, ``DG_diag`` and ``DG_Dinv (2, Np, Np, C)``, the float lane ``masks``
    (3, 1, C) and the lattice geometry.  ``lvA`` views A and A_Dinv as an
    ``ops.soa.SoALevel`` for K1."""

    def __init__(self, A, G, D, A_Dinv, DG_diag, DG_Dinv, masks, nj, ni,
                 periodic):
        self.A, self.G, self.D = A, G, D
        self.A_Dinv, self.DG_diag, self.DG_Dinv = A_Dinv, DG_diag, DG_Dinv
        self.masks, self.nj, self.ni, self.periodic = masks, nj, ni, periodic
        self.nh = ni // 2
        self.lvA = soa.SoALevel(A, A_Dinv, masks, nj, ni, periodic)


# ---------------------------------------------------------------------------
# plain torch versions (CPU path, and the on-card reference)
# ---------------------------------------------------------------------------

def dg_half_sweep_plain(lv, rhs, p, g, color, base=None):
    c = color
    dg_c = _mac(lv.D[c, 0], g[c]) + _off(lv.D[c], g[1 - c], c, lv)
    off = dg_c - _mac(lv.DG_diag[c], p[c])
    pn = _mac(lv.DG_Dinv[c], rhs[c] - off)
    out = torch.stack([pn, p[1]] if c == 0 else [p[0], pn])
    return out if base is None else base + out


# ---------------------------------------------------------------------------
# the wrappers: the CUDA kernel for CUDA tensors, the plain version otherwise
# ---------------------------------------------------------------------------

def dg_half_sweep(lv, rhs, p, g, color, base=None):
    """K6: ``p_c <- DG_Dinv_c (rhs_c - (D_c g - DG_diag_c p_c))`` for one
    color, ``g = G p`` (both colors, from K5); returns a new (2, Np, C) with
    the other color unchanged, plus ``base`` (2, Np, C) when given."""
    if not p.is_cuda:
        return dg_half_sweep_plain(lv, rhs, p, g, color, base)
    out = _kernels.dg_half_sweep(lv.D, lv.DG_diag, lv.DG_Dinv, rhs, p, g, color,
                                 lv.nh, lv.periodic, base)
    dg_half_sweep.launches += 1
    return out


KERNELS = (dg_half_sweep,)
PLAIN = {dg_half_sweep: dg_half_sweep_plain}
# every kernel the Stokes cycle launches: the Poisson cycle's four and K6
CYCLE_KERNELS = soa.KERNELS + KERNELS


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()


def _blockdiag2(M):
    """blockdiag(M, M) for the [u; v] interleaved velocity block."""
    a, b = M.shape[-2:]
    out = torch.zeros(M.shape[:-2] + (2 * a, 2 * b), dtype=M.dtype, device=M.device)
    out[..., :a, :b] = M
    out[..., a:, b:] = M
    return out


# ---------------------------------------------------------------------------
# the cycle
# ---------------------------------------------------------------------------

class StokesSoAHierarchy:
    """What the Stokes SoA cycle and the streamed Stokes hybrid
    (``ops/stokes_stream.py``) share: the cast, the per-component transfers
    (polynomial (R, P) pairs as matrices for K3, geometric per-child R4 / P4
    for K4) and the finest level's layout conversion.  A subclass sets
    ``dims``, ``nu``, ``npd``, ``dtype``, ``device``, ``transfers`` and the
    ``_gemm``/``_geo`` phase functions."""

    def _cast(self, x):
        return x.to(device=self.device, dtype=self.dtype).contiguous()

    def _pack_transfers(self):
        self.R, self.P = [], []
        for t in self.transfers:
            if t.kind == "penalty":
                self.R.append(None)
                self.P.append(None)
            elif t.kind == "polynomial":
                Ruv, Rp = _blockdiag2(t.Ru), t.Rp
                self.R.append((self._cast(Ruv), self._cast(Rp)))
                self.P.append((self._cast(Ruv.T), self._cast(Rp.T)))
            elif t.kind == "geometric":
                r4, p4 = [], []
                for tb, uv in ((t.tu, True), (t.tp, False)):
                    B = tb.R.shape[1] // 4
                    R4 = torch.stack([tb.R[:, k * B:(k + 1) * B] for k in range(4)])
                    P4 = torch.stack([tb.P[k * B:(k + 1) * B, :] for k in range(4)])
                    r4.append(self._cast(_blockdiag2(R4) if uv else R4))
                    p4.append(self._cast(_blockdiag2(P4) if uv else P4))
                self.R.append(tuple(r4))
                self.P.append(tuple(p4))
            else:
                raise NotImplementedError(
                    f"the Stokes SoA cycle has no {t.kind!r} transfer")

    def _restrict(self, k, r_mom, r_cont):
        kind = self.transfers[k].kind
        if kind == "penalty":
            return r_mom, r_cont
        Ruv, Rp = self.R[k]
        if kind == "polynomial":
            return self._gemm(Ruv, r_mom), self._gemm(Rp, r_cont)
        return (self._geo(Ruv, r_mom, self.dims[k], True),
                self._geo(Rp, r_cont, self.dims[k], True))

    def _prolong(self, k, e_uv, e_p, base_uv=None, base_p=None):
        """(base +) P e per component."""
        kind = self.transfers[k].kind
        if kind == "penalty":
            return (e_uv if base_uv is None else base_uv + e_uv,
                    e_p if base_p is None else base_p + e_p)
        Puv, Pp = self.P[k]
        if kind == "polynomial":
            return self._gemm(Puv, e_uv, base_uv), self._gemm(Pp, e_p, base_p)
        return (self._geo(Puv, e_uv, self.dims[k], False, base_uv),
                self._geo(Pp, e_p, self.dims[k], False, base_p))

    def _pack_parity(self):
        """The finest level's row-parity mask ``even`` (Nj, 1, 1), built once
        on the cycle's device: ``to_soa`` / ``from_soa`` run inside a
        captured cycle (``ops/graphs.py``), where a host copy is refused."""
        self.even = rolled.parity_mask(self.dims[-1][0], self.dtype, self.device)

    def to_soa(self, x):
        """Global [all u; all v; all p] -> (uv (2, 2Nu, C), p (2, Np, C))."""
        nj, ni = self.dims[-1]
        n = nj * ni
        nu = self.nu[-1]
        x = x.to(device=self.device, dtype=self.dtype)
        uv = _global_uv_to_elem(x[:2 * n * nu], n, nu).reshape(nj, ni, 2 * nu)
        p = x[2 * n * nu:].reshape(nj, ni, self.npd[-1])

        def pack(v):
            a, b = rolled.pack_colors(v, self.even)
            B = v.shape[-1]
            return torch.stack([a.reshape(-1, B).T, b.reshape(-1, B).T]).contiguous()

        return pack(uv), pack(p)

    def from_soa(self, uv, p):
        nj, ni = self.dims[-1]

        def unpack(v):
            B = v.shape[1]
            return rolled.unpack_colors(v[0].T.reshape(nj, ni // 2, B),
                                        v[1].T.reshape(nj, ni // 2, B),
                                        self.even).reshape(-1)

        n, nu = nj * ni, self.nu[-1]
        return torch.cat([_elem_uv_to_global(unpack(uv), n, nu), unpack(p)])


def check_dgs(settings, types):
    """{coarsening type: (pre, post) sweeps} after checking that every
    smoother of ``types`` is distributive GS (the only one the Stokes SoA
    and streamed cycles run)."""
    cfg = {}
    for t in set(types):
        node = getattr(settings.solver.multigrid, f"{t}_coarsening")
        for side in (node.pre_smoother, node.post_smoother):
            if str(side.smoother).lower() != _DGS:
                raise ValueError(
                    "the Stokes SoA and streamed cycles smooth with distributive "
                    f"GS; config names {side.smoother!r}")
        cfg[t] = (int(node.pre_smoother.iterations),
                  int(node.post_smoother.iterations))
    return cfg


def stokes_soa_level(lvl, cast):
    """dgtpu's per-level packing (pallas_stokes.py:99-139): the blocks and
    the float64 diagonal inverses on the host, then ``cast``."""
    nj, ni = lvl.Nj, lvl.Ni
    rb_A = rolled.to_rolled(lvl.block_A, ni, nj)
    dgd = _dg_diag_blocks(lvl.block_D, lvl.block_G)
    dgd = dgd.reshape(nj, ni, *dgd.shape[1:])
    soa = [soa_blocks(rolled.to_rolled(op, ni, nj))
           for op in (lvl.block_A, lvl.block_G, lvl.block_D)]
    diag = [soa_diag(m) for m in (host_inv(rb_A[:, :, 0]), dgd, host_inv(dgd))]
    masks = lane_masks(nj, ni, torch.float64, rb_A.device)
    return StokesSoALevel(*(cast(x) for x in soa + diag + [masks]), nj, ni,
                          is_periodic(lvl.block_A, ni))


class SoAStokesVCycle(StokesSoAHierarchy):
    """Stokes DGS V/W/F cycle, cells-in-lanes layout.

    ``levels``: GridLevels coarsest -> finest with a global-order Stokes
    assembly (``block_A/D/G`` set); ``transfers[k]`` between levels k and
    k+1 (StokesPolynomialTransfer / StokesGeometricTransfer / penalty
    TransferOp) with ``types[k]`` naming its coarsening node.  Needs an even
    Ni on every level and distributive-GS smoothing.  The coarse level
    follows ``coarse_grid_solver``: 'smoother' -> 10 DGS sweeps,
    'direct'/'amg' -> the pinned dense saddle inverse.
    """

    def __init__(self, levels, transfers, types, settings, dtype=torch.float32,
                 device=None, reference=False, n_pass=2):
        for lvl in levels:
            if lvl.block_A is None:
                raise ValueError("SoAStokesVCycle needs a global-order "
                                 "Stokes assembly (level.block_A/D/G)")
            if lvl.Ni % 2:
                raise ValueError("SoAStokesVCycle needs an even Ni on every "
                                 f"level (got {lvl.Ni})")
        self.dtype = dtype
        self.device = torch.device(device) if device is not None \
            else levels[-1].block_A.blocks.device
        self.n_lev = len(levels)
        self.transfers = list(transfers)
        self.types = list(types)
        if n_pass < 1:
            raise ValueError(f"SoAStokesVCycle needs n_pass >= 1, got {n_pass}")
        self.n_pass = n_pass
        self.dims = [(l.Nj, l.Ni) for l in levels]
        self.nu = [l.N_DOF_sol["u"] for l in levels]
        self.npd = [l.N_DOF_sol["p"] for l in levels]
        plain = {**soa.PLAIN, **PLAIN}
        kernels = [plain[k] if reference else k for k in CYCLE_KERNELS]
        (self._half_sweep, self._stencil, self._gemm, self._geo,
         self._dg_half) = kernels

        self._cfg = check_dgs(settings, self.types)
        self.cycle_type = str(getattr(settings.solver.multigrid,
                                      "cycle_type", "V")).upper()
        if self.cycle_type not in ("V", "W", "F"):
            raise NotImplementedError(
                f"the Stokes SoA cycle implements V, W and F, not "
                f"{self.cycle_type!r}")

        self.levels = [stokes_soa_level(l, self._cast) for l in levels]
        self._pack_transfers()
        self._pack_parity()
        self.coarse_solver = settings.solver.multigrid.coarse_grid_solver
        self.coarse_W = (self._coarse_matrix(levels[0])
                         if self.coarse_solver in ("direct", "amg") else None)

    @staticmethod
    def device_bytes(levels, transfers, dtype=torch.float32, with_coarse=True):
        """Bytes of the device tensors a cycle over this hierarchy holds,
        from the shapes alone: per level A, G, D (2, 5, B_src, B_dst, C),
        A_Dinv, DG_diag, DG_Dinv (2, B, B, C) and the masks (3, 1, C); per
        transfer R and P of both components (per child for a geometric one);
        with ``with_coarse`` the dense saddle inverse (M, M), M = N0 (2 Nu +
        Np).  The streamed Stokes hybrid's cut rule reads it."""
        nu2 = [2 * l.N_DOF_sol["u"] for l in levels]
        npd = [l.N_DOF_sol["p"] for l in levels]
        count = 0
        for l, a, p in zip(levels, nu2, npd):
            count += (2 * 5 * (a * a + 2 * a * p) + 2 * a * a + 4 * p * p + 3) \
                * l.Nj * (l.Ni // 2)
        for k, t in enumerate(transfers):
            children = {"geometric": 4, "polynomial": 1}.get(t.kind, 0)
            count += 2 * children * (nu2[k] * nu2[k + 1] + npd[k] * npd[k + 1])
        if with_coarse and levels:
            M = levels[0].Nj * levels[0].Ni * (nu2[0] + npd[0])
            count += M * M
        return count * torch.empty((), dtype=dtype).element_size()

    def _coarse_matrix(self, lvl):
        """The coarsest level's pinned dense saddle inverse permuted to the
        order of the flattened SoA pair ``[uv (2, 2Nu, C0); p (2, Np, C0)]``:
        W (M, M), M = (2 Nu + Np) * 2 C0.  dgtpu spells it as
        (2, 2, B0, B0, C0, C0) cross-lane tensors (pallas_stokes.py:288-322)."""
        nj0, ni0 = self.dims[0]
        nh0 = ni0 // 2
        C0 = nj0 * nh0
        n = nj0 * ni0
        nu, npd = self.nu[0], self.npd[0]
        op = lvl.op
        if not op.pin:
            op = type(op)(op.A, op.D, op.G, pin=True)
        inv = host_lu_inverse(op.to_dense().to(torch.float64))
        perm = np.zeros(n * (2 * nu + npd), np.int64)
        p_off = 2 * 2 * nu * C0
        for j in range(nj0):
            for i in range(ni0):
                c, ip = _packed_pos(j, i)
                m, q = j * ni0 + i, j * nh0 + ip
                lanes = c * 2 * nu * C0 + np.arange(2 * nu) * C0 + q
                perm[m * nu:(m + 1) * nu] = lanes[:nu]                      # u
                perm[n * nu + m * nu:n * nu + (m + 1) * nu] = lanes[nu:]     # v
                perm[2 * n * nu + m * npd:2 * n * nu + (m + 1) * npd] = \
                    p_off + c * npd * C0 + np.arange(npd) * C0 + q          # p
        perm = torch.as_tensor(perm, device=inv.device)
        W = torch.zeros_like(inv)
        W[perm[:, None], perm[None, :]] = inv
        return self._cast(W)

    @property
    def periodic(self):
        return [lv.periodic for lv in self.levels]

    # -- distributive GS -----------------------------------------------------

    def _bgs_A(self, k, rhs, base=None):
        """Red-black block-GS passes on the momentum operator A from zero;
        ``base`` is added to the result by the last half-sweep."""
        lvA = self.levels[k].lvA
        x = torch.zeros_like(rhs)
        n = 2 * self.n_pass
        for i in range(n):
            x = self._half_sweep(lvA, rhs, x, i % 2, base if i == n - 1 else None)
        return x

    def _bgs_dg(self, k, rhs, base=None):
        """Red-black GS passes on DG = D G (diagonal precomputed) from zero;
        ``base`` is added to the result by the last half-pass."""
        lv = self.levels[k]
        p = torch.zeros_like(rhs)
        n = 2 * self.n_pass
        for i in range(n):
            g = self._stencil(lv, lv.G, p)
            p = self._dg_half(lv, rhs, p, g, i % 2, base if i == n - 1 else None)
        return p

    def _dgs_sweep(self, k, f_mom, f_cont, uv, p):
        """One lsq-splitting distributive GS sweep (StencilDGS.sweep): every
        addition rides on a kernel's ``base``."""
        lv = self.levels[k]
        st = self._stencil
        rhs_mom = st(lv, lv.G, p, base=st(lv, lv.A, uv, base=f_mom, sign=-1.0),
                     sign=-1.0)
        uv_plus = self._bgs_A(k, rhs_mom, base=uv)                 # uv + du_s
        dp_s = self._bgs_dg(k, st(lv, lv.D, uv_plus, base=f_cont, sign=-1.0))
        G_dp = st(lv, lv.G, dp_s)
        rhs_dg = st(lv, lv.D, st(lv, lv.A, G_dp), sign=-1.0)
        # uv + (du_s + G dp) = uv_plus + G dp_s, p + dp
        return st(lv, lv.G, dp_s, base=uv_plus), self._bgs_dg(k, rhs_dg, base=p)

    def _smooth(self, k, f_mom, f_cont, uv, p, n_sweeps):
        for _ in range(n_sweeps):
            uv, p = self._dgs_sweep(k, f_mom, f_cont, uv, p)
        return uv, p

    def _residual(self, k, f_mom, f_cont, uv, p):
        lv = self.levels[k]
        st = self._stencil
        r_mom = st(lv, lv.G, p, base=st(lv, lv.A, uv, base=f_mom, sign=-1.0),
                   sign=-1.0)
        return r_mom, st(lv, lv.D, uv, base=f_cont, sign=-1.0)

    # -- cycle ---------------------------------------------------------------

    def _coarse_solve(self, f_mom, f_cont, uv, p):
        if self.coarse_W is None:
            return self._smooth(0, f_mom, f_cont, uv, p, 10)
        f = torch.cat([f_mom.reshape(-1), f_cont.reshape(-1)]).reshape(1, -1, 1)
        out = self._gemm(self.coarse_W, f).reshape(-1)
        n_uv = f_mom.numel()
        return out[:n_uv].reshape(f_mom.shape), out[n_uv:].reshape(f_cont.shape)

    def _cycle(self, k, f_mom, f_cont, uv, p, mode=None):
        mode = mode or self.cycle_type
        if k == 0:
            return self._coarse_solve(f_mom, f_cont, uv, p)
        pre, post = self._cfg[self.types[k - 1]]
        uv, p = self._smooth(k, f_mom, f_cont, uv, p, pre)
        r_mom, r_cont = self._residual(k, f_mom, f_cont, uv, p)
        rc_mom, rc_cont = self._restrict(k - 1, r_mom, r_cont)
        ec_uv, ec_p = self._cycle(k - 1, rc_mom, rc_cont, torch.zeros_like(rc_mom),
                                  torch.zeros_like(rc_cont), mode=mode)
        if mode in ("W", "F") and k - 1 > 0:
            # F revisits with a plain V (MultigridSolver.v_cycle semantics)
            ec_uv, ec_p = self._cycle(k - 1, rc_mom, rc_cont, ec_uv, ec_p,
                                      mode="W" if mode == "W" else "V")
        uv, p = self._prolong(k - 1, ec_uv, ec_p, uv, p)
        return self._smooth(k, f_mom, f_cont, uv, p, post)

    def _fmg(self, f_mom, f_cont, skip_finest=False):
        """Full-multigrid (nested-iteration) guess: restrict (f_mom, f_cont)
        to the coarsest level, solve, prolong upward with one configured
        cycle per level.  With ``skip_finest`` only the prolonged finest-level
        guess is returned."""
        rhss = [(f_mom, f_cont)]
        for k in range(self.n_lev - 1, 0, -1):
            rhss.append(self._restrict(k - 1, *rhss[-1]))
        rhss = rhss[::-1]                       # coarsest first
        fm, fc = rhss[0]
        uv, p = self._coarse_solve(fm, fc, torch.zeros_like(fm), torch.zeros_like(fc))
        for k in range(1, self.n_lev):
            uv, p = self._prolong(k - 1, uv, p)
            if skip_finest and k == self.n_lev - 1:
                return uv, p
            uv, p = self._cycle(k, rhss[k][0], rhss[k][1], uv, p)
        return uv, p

    # -- public entry points -------------------------------------------------

    def __call__(self, rhs, u):
        """One cycle on flat global-order vectors [u; v; p]; returns ``dtype``."""
        f_mom, f_cont = self.to_soa(rhs)
        uv, p = self.to_soa(u)
        return self.from_soa(*self._cycle(self.n_lev - 1, f_mom, f_cont, uv, p))

    def build_fmg(self, finest_cycle=None):
        """fmg(rhs) -> u0, the FMG guess.  ``finest_cycle``: a cycle
        ``(rhs, u) -> u`` run in place of the finest level's cycle."""
        skip = finest_cycle is not None and self.n_lev > 1

        def fmg(rhs):
            r = rhs.to(self.dtype)
            u = self.from_soa(*self._fmg(*self.to_soa(r), skip_finest=skip))
            return finest_cycle(r, u) if skip else u

        return fmg

    def build_matvec(self):
        """The finest level's saddle matvec in the cycle's dtype on flat
        global-order vectors: the operator of the GMRES-wrapped refinement
        (``make_refined_solver(inner='gmres')``)."""
        top = self.n_lev - 1

        def matvec(x):
            lv = self.levels[top]
            uv, p = self.to_soa(x)
            mom = self._stencil(lv, lv.G, p, base=self._stencil(lv, lv.A, uv))
            return self.from_soa(mom, self._stencil(lv, lv.D, uv))

        return matvec
