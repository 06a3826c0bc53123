"""Streamed Stokes distributive-GS level and the hybrid Stokes cycle.

Port of ``dgtpu/ops/pallas_stokes_stream.py`` (``StreamedStokesLevel``,
``StreamedStokesVCycle``), which has no TPU kernel of its own: it composes
``StreamedLevel``'s.  Here the composition launches:

    K7 multi_half_sweep  (ops/stream.py)      the velocity block-GS on A, all
                                              2 n_pass half-sweeps in one
                                              launch, float32 or bfloat16
                                              blocks (``block_storage``)
    K5 stencil_apply     (ops/soa.py)         every A / G / D matvec and the
                                              saddle residual, float32
    K6 dg_half_sweep     (ops/stokes_soa.py)  one color of the pressure DG
                                              pass: dgtpu's matvec_color(D)
                                              of g = G p and its two
                                              DG-diagonal MACs in one launch

As in the SoA Stokes cycle the sweep's additions ride on the kernels'
``base`` operands, so no torch arithmetic runs between launches.  Levels
below the cut run as ``ops.stokes_soa.SoAStokesVCycle``; transfers stay in
the SoA layout (K3/K4 through ``StokesSoAHierarchy``).
"""

import torch

from dgtpu_torch.models.stokes import _dg_diag_blocks
from dgtpu_torch.ops import soa
from dgtpu_torch.ops import stokes_soa as ss
from dgtpu_torch.ops.linalg import host_inv
from dgtpu_torch.ops.soa import _mac, soa_diag
from dgtpu_torch.ops.stokes_soa import (SoAStokesVCycle, StokesSoAHierarchy,
                                        StokesSoALevel, check_dgs)
from dgtpu_torch.ops.stream import StreamedLevel, cut_level


def dg_pass_plain(sl, rhs, p, g, color, base=None):
    """dgtpu's streamed DG half-pass (pallas_stokes_stream.py:103-114):
    ``matvec_color(D)`` of g = G p, then the two DG-diagonal MACs; returns
    the new (2, Np, C), plus ``base`` when given."""
    c = color
    off = sl.D_s.matvec_color(c)(g) - _mac(sl.DG_diag[c], p[c])
    pn = _mac(sl.DG_Dinv[c], rhs[c] - off)
    out = torch.stack([pn, p[1]] if c == 0 else [p[0], pn])
    return out if base is None else base + out


def dg_pass(sl, rhs, p, g, color, base=None):
    """The streamed DG half-pass: K6 on CUDA tensors (counted in
    ``stokes_soa.dg_half_sweep.launches``), the plain composition
    otherwise."""
    if not p.is_cuda:
        return dg_pass_plain(sl, rhs, p, g, color, base)
    return ss.dg_half_sweep(sl.lv, rhs, p, g, color, base)


class StreamedStokesLevel:
    """Streamed distributive-GS smoother and saddle residual for one level.

    ``A_s``, ``G_s``, ``D_s``: StreamedLevels of the component stencils;
    ``block_storage`` narrows the A sweeps only (they run from zero on the
    float32 momentum residual, so the narrowing cannot move what the sweep
    converges toward); G and D stay float32.  ``DG_diag`` / ``DG_Dinv``
    (2, Np, Np, C): the DG = D G diagonal and its inverse.  ``lv`` is the
    ``StokesSoALevel`` view K5 and K6 take.  State: color lattices
    uv (2, 2Nu, C), p (2, Np, C)."""

    def __init__(self, level, dtype=torch.float32, device=None, n_pass=2,
                 block_storage=None, reference=False):
        if level.block_A is None:
            raise ValueError("StreamedStokesLevel needs a global-order Stokes "
                             "assembly (level.block_A/D/G)")
        nj, ni = level.Nj, level.Ni
        kw = dict(dtype=dtype, device=device, reference=reference)
        self.A_s = StreamedLevel(level.block_A, nj, ni, block_storage=block_storage, **kw)
        self.G_s = StreamedLevel(level.block_G, nj, ni, **kw)
        self.D_s = StreamedLevel(level.block_D, nj, ni, **kw)
        dgd = _dg_diag_blocks(level.block_D, level.block_G)
        dgd = dgd.reshape(nj, ni, *dgd.shape[1:])
        self.DG_diag = self.A_s._cast(soa_diag(dgd))
        self.DG_Dinv = self.A_s._cast(soa_diag(host_inv(dgd)))
        self.lv = StokesSoALevel(self.A_s.res, self.G_s.res, self.D_s.res,
                                 self.A_s.lv.Dinv, self.DG_diag, self.DG_Dinv,
                                 self.A_s.lv.masks, nj, ni, self.A_s.periodic)
        self.n_pass = n_pass
        self._bgsA = self.A_s.half_sweeps(2 * n_pass)
        self._stencil = soa.stencil_apply_plain if reference else soa.stencil_apply
        self._dg = dg_pass_plain if reference else dg_pass

    def _bgs_dg(self, rhs, base=None):
        """Red-black GS passes on DG from zero (pallas_stokes_stream.py:
        103-114); ``base`` is added by the last half-pass."""
        lv = self.lv
        p = torch.zeros_like(rhs)
        n = 2 * self.n_pass
        for i in range(n):
            g = self._stencil(lv, lv.G, p)
            p = self._dg(self, rhs, p, g, i % 2, base if i == n - 1 else None)
        return p

    def dgs_sweep(self, f_mom, f_cont, uv, p):
        """One lsq-splitting distributive GS sweep (StencilDGS.sweep;
        pallas_stokes_stream.py:116-126)."""
        lv, st = self.lv, self._stencil
        rhs_mom = st(lv, lv.G, p, base=st(lv, lv.A, uv, base=f_mom, sign=-1.0),
                     sign=-1.0)
        uv_plus = self._bgsA(rhs_mom, None, base=uv)               # uv + du_s
        dp_s = self._bgs_dg(st(lv, lv.D, uv_plus, base=f_cont, sign=-1.0))
        G_dp = st(lv, lv.G, dp_s)
        rhs_dg = st(lv, lv.D, st(lv, lv.A, G_dp), sign=-1.0)
        # uv + (du_s + G dp) = uv_plus + G dp_s, p + dp
        return st(lv, lv.G, dp_s, base=uv_plus), self._bgs_dg(rhs_dg, base=p)

    def residual(self, f_mom, f_cont, uv, p):
        lv, st = self.lv, self._stencil
        r_mom = st(lv, lv.G, p, base=st(lv, lv.A, uv, base=f_mom, sign=-1.0),
                   sign=-1.0)
        return r_mom, st(lv, lv.D, uv, base=f_cont, sign=-1.0)


class StreamedStokesVCycle(StokesSoAHierarchy):
    """Hybrid Stokes DGS V/W cycle: levels below ``cut`` run as the SoA
    Stokes cycle, levels from ``cut`` up as StreamedStokesLevels.
    ``budget``: device bytes that the SoA subtree's
    ``SoAStokesVCycle.device_bytes`` must fit (no shipped Stokes grid
    outgrows the card's L2, so the hybrid is driven with an explicit
    budget, as dgtpu's bench and tests drive theirs).  ``block_storage``
    (default ``performance.block_storage``) narrows the streamed A sweeps.
    Interface as SoAStokesVCycle: ``cycle(rhs, u)`` on global-order
    vectors, ``build_fmg``, ``build_matvec``."""

    def __init__(self, levels, transfers, types, settings, budget,
                 dtype=torch.float32, device=None, n_pass=2, block_storage=None,
                 reference=False):
        if block_storage is None:
            block_storage = str(getattr(getattr(settings, "performance", None),
                                        "block_storage", "float32"))
        self.block_storage = block_storage
        self.dtype = dtype
        self.device = torch.device(device) if device is not None \
            else levels[-1].block_A.blocks.device
        self.n_lev = len(levels)
        self.transfers, self.types = list(transfers), list(types)
        self.dims = [(l.Nj, l.Ni) for l in levels]
        self.nu = [l.N_DOF_sol["u"] for l in levels]
        self.npd = [l.N_DOF_sol["p"] for l in levels]
        self.cycle_type = str(getattr(settings.solver.multigrid,
                                      "cycle_type", "V")).upper()
        if self.cycle_type not in ("V", "W"):
            raise NotImplementedError(
                f"the streamed Stokes hybrid implements V and W, not "
                f"{self.cycle_type!r}")
        self._cfg = check_dgs(settings, self.types)
        with_coarse = settings.solver.multigrid.coarse_grid_solver in ("direct", "amg")
        self.cut = cut_level(lambda k: SoAStokesVCycle.device_bytes(
            levels[:k], self.transfers[:k - 1], dtype, with_coarse) <= budget,
            self.n_lev, "Stokes")
        cut = self.cut
        self.sub = SoAStokesVCycle(levels[:cut], self.transfers[:cut - 1],
                                   self.types[:cut - 1], settings, dtype=dtype,
                                   device=self.device, reference=reference,
                                   n_pass=n_pass)
        self.streams = {k: StreamedStokesLevel(levels[k], dtype=dtype, device=self.device,
                                               n_pass=n_pass, block_storage=block_storage,
                                               reference=reference)
                        for k in range(cut, self.n_lev)}
        self._gemm, self._geo = (soa.PLAIN[k] if reference else k
                                 for k in (soa.small_gemm, soa.geo_transfer))
        self._pack_transfers()
        self._pack_parity()

    def _cycle(self, k, f_mom, f_cont, uv, p):
        if k < self.cut:
            return self.sub._cycle(k, f_mom, f_cont, uv, p)
        s = self.streams[k]
        pre, post = self._cfg[self.types[k - 1]]
        for _ in range(pre):
            uv, p = s.dgs_sweep(f_mom, f_cont, uv, p)
        rc_mom, rc_cont = self._restrict(k - 1, *s.residual(f_mom, f_cont, uv, p))
        e_uv, e_p = self._cycle(k - 1, rc_mom, rc_cont, torch.zeros_like(rc_mom),
                                torch.zeros_like(rc_cont))
        if self.cycle_type == "W" and k - 1 > 0:
            # at the subtree boundary this re-runs the whole SoA sub-cycle from
            # the first visit's result (the coarsest level is never revisited)
            e_uv, e_p = self._cycle(k - 1, rc_mom, rc_cont, e_uv, e_p)
        uv, p = self._prolong(k - 1, e_uv, e_p, uv, p)
        for _ in range(post):
            uv, p = s.dgs_sweep(f_mom, f_cont, uv, p)
        return uv, p

    def _fmg(self, f_mom, f_cont):
        """FMG guess (pallas_stokes_stream.py:390-419): restrict down to the
        subtree's top level, the subtree's own FMG there, then one cycle per
        streamed level on the way up."""
        rhss = [(f_mom, f_cont)]
        for k in range(self.n_lev - 1, self.cut - 1, -1):
            rhss.append(self._restrict(k - 1, *rhss[-1]))
        uv, p = self.sub._fmg(*rhss[-1])
        for k, (fm, fc) in zip(range(self.cut, self.n_lev), rhss[-2::-1]):
            uv, p = self._cycle(k, fm, fc, *self._prolong(k - 1, uv, p))
        return uv, p

    def __call__(self, rhs, u):
        """One cycle on flat global-order vectors [u; v; p]; returns ``dtype``."""
        f_mom, f_cont = self.to_soa(rhs)
        uv, p = self.to_soa(u)
        return self.from_soa(*self._cycle(self.n_lev - 1, f_mom, f_cont, uv, p))

    def build_fmg(self, finest_cycle=None):
        """fmg(rhs) -> u0.  ``finest_cycle`` is accepted for the SoA cycle's
        interface and ignored, as in dgtpu."""
        del finest_cycle

        def fmg(rhs):
            return self.from_soa(*self._fmg(*self.to_soa(rhs)))

        return fmg

    def build_matvec(self):
        """The finest level's saddle matvec on its streamed operands (K5), in
        the cycle's dtype on flat global-order vectors: the operator of the
        GMRES-wrapped refinement (pallas_stokes_stream.py:373-388)."""
        top = self.streams[self.n_lev - 1]

        def matvec(x):
            lv, st = top.lv, top._stencil
            uv, p = self.to_soa(x)
            return self.from_soa(st(lv, lv.G, p, base=st(lv, lv.A, uv)),
                                 st(lv, lv.D, uv))

        return matvec
