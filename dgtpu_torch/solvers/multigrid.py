"""Multigrid V-cycle solver in full precision (port of
``dgtpu/solvers/multigrid.py``; reference: ``dgfem/solver.py:114-207``).

Each cycle is smoother sweeps, stencil matvecs, transfer products and the
cached coarse solve, all plain torch in the operators' dtype on their device
(dgtpu runs them outside any Pallas kernel).  On global-order Stokes
levels the smoother is distributive GS (``models/stokes.make_dgs``,
splitting ``performance.dgs_splitting``, default ``classical_exact``).  The
outer tolerance loop is a host loop that carries the residual history (the
reference pickles it for its plots; it is returned here).  Divergence (a non-finite residual) ends
the loop instead of the reference's ``exit()``.
"""

import math
from dataclasses import replace

import torch

from dgtpu_torch.models.stokes import make_dgs
from dgtpu_torch.ops.linalg import host_lu_inverse
from dgtpu_torch.ops.smoothers import (SMOOTHER_ALIASES, ColorPack, apply_smoother,
                                       block_diag_inv, estimate_rho_dinv_a,
                                       normalize_smoother_name, sweep_fronts)
from dgtpu_torch.utils.norms import lp_norm

_DGS = "distributive_gauss_seidel"


class SmootherConfig:
    def __init__(self, name, direction, iterations, omega, eig_ratio=None):
        self.name = normalize_smoother_name(name)
        self.direction = direction
        self.iterations = int(iterations)
        self.omega = float(omega)
        # chebyshev smoothing-interval lower end (fraction of lmax): an
        # optional 'eig ratio' key on the smoother node, so the relaxation
        # factor never has to double as it
        self.eig_ratio = None if eig_ratio is None else float(eig_ratio)

    @classmethod
    def from_settings(cls, node):
        return cls(node.smoother, node.direction, node.iterations,
                   node.relaxation_factor,
                   eig_ratio=getattr(node, "eig_ratio", None))


class MultigridSolver:
    """Multigrid cycles over an assembled level hierarchy (coarsest first).

    Parameters
    ----------
    ops : list of StencilOperator, coarsest -> finest
    transfers : list of TransferOp, transfers[k-2] sits between level k and k-1
    types : list of 'penalty_parameter'|'polynomial'|'geometric' per transfer
    settings : Settings (smoother configs per coarsening type, tolerances)
    colors : list of element colorings per level (for the red-black sweeps)
    levels : the GridLevels, coarsest first (needed by distributive GS)
    """

    def __init__(self, ops, transfers, types, settings, colors=None, levels=None):
        assert len(ops) == len(transfers) + 1 == len(types) + 1
        self.ops = ops
        self.transfers = transfers
        self.types = types
        self.settings = settings
        mg = settings.solver.multigrid
        self.strategy = getattr(getattr(settings, "performance", None),
                                "smoother_parallelization", "sequential")
        self.colors = colors or [None] * len(ops)
        # a Stokes saddle operator (global order) has no block-stencil form
        stencil = [hasattr(op, "blocks") for op in ops]
        self.packs = [ColorPack(op, c)
                      if self.strategy == "redblack" and c is not None and st else None
                      for op, c, st in zip(ops, self.colors, stencil)]
        self.Dinv = [block_diag_inv(op) if st else None for op, st in zip(ops, stencil)]
        self.coarse_solver = mg.coarse_grid_solver
        # V (reference behavior), W (each coarse sub-hierarchy visited
        # twice) or F (first visit recurses as F, second as V)
        self.cycle_type = str(getattr(mg, "cycle_type", "V")).upper()
        if self.cycle_type not in ("V", "W", "F"):
            raise ValueError(
                f"cycle type must be V, W or F, got {self.cycle_type}")
        # full multigrid (nested iteration): solve coarsest first, prolong
        # upward with one cycle per level
        self.full_multigrid = bool(getattr(mg, "full_multigrid", False))
        # dense inverse cached at setup; applied as one product per visit.  A
        # Stokes saddle operator needs its pressure pin to be invertible
        self.coarse_inv = None
        if self.coarse_solver in ("direct", "amg"):
            coarse = ops[0]
            if hasattr(coarse, "pin") and not coarse.pin:
                coarse = replace(coarse, pin=True)
            self.coarse_inv = host_lu_inverse(coarse.to_dense())
        self._smoother_cfg = {}
        for t in set(types):
            node = getattr(mg, f"{t}_coarsening")
            self._smoother_cfg[t] = (SmootherConfig.from_settings(node.pre_smoother),
                                     SmootherConfig.from_settings(node.post_smoother))
        names = {c.name for pair in self._smoother_cfg.values() for c in pair}
        # distributive GS: the smoother state of every level, built at setup
        self._dgs = {}
        if _DGS in names:
            if levels is None:
                raise ValueError("distributive GS smoothing needs GridLevels")
            splitting = getattr(getattr(settings, "performance", None),
                                "dgs_splitting", "classical_exact")
            self._dgs = {k: make_dgs(lvl, splitting) for k, lvl in enumerate(levels)}
        # level k smooths with its transfer's config (k >= 1); the coarsest
        # level only smooths when there is no cached coarse inverse (then
        # with the pre-smoother of types[0])
        used = [[self._smoother_cfg[types[0]][0].name]
                if self.coarse_inv is None else []]
        used += [[c.name for c in self._smoother_cfg[t]] for t in types]
        # Chebyshev smoothing interval: per-level rho(D^-1 A) by power
        # iteration at setup, only on the levels that smooth with it
        self.eig_max = [1.1 * estimate_rho_dinv_a(op, dv)
                        if dv is not None and "chebyshev" in lvl_names else None
                        for op, dv, lvl_names in zip(ops, self.Dinv, used)]
        # wavefronts of the sequential sweeps, per level that runs them
        sequential = self.strategy != "redblack"
        self.fronts = [(sweep_fronts(op), sweep_fronts(op, backward=True))
                       if st and sequential and any(SMOOTHER_ALIASES[n] == "gs"
                                                    for n in lvl_names) else None
                       for op, st, lvl_names in zip(ops, stencil, used)]

    # -- one cycle (host recursion) -----------------------------------------

    def _smooth(self, cfg, k, rhs, u, iterations=None):
        if cfg.name == _DGS:
            # the Stokes saddle smoother
            for _ in range(int(iterations or cfg.iterations)):
                u = self._dgs[k].sweep(rhs, u)
            return u
        if cfg.name == "chebyshev" and self.eig_max[k] is None:
            # a Stokes saddle operator has no block-stencil form to
            # power-iterate
            raise ValueError(
                "chebyshev smoothing needs a block-stencil operator (level "
                f"{k} has none); use distributive_gauss_seidel for saddle "
                "systems")
        return apply_smoother(cfg.name, self.ops[k], rhs, u,
                              direction=cfg.direction, omega=cfg.omega,
                              iterations=iterations or cfg.iterations,
                              Dinv=self.Dinv[k],
                              strategy=self.strategy, colors=self.colors[k],
                              pack=self.packs[k], eig_max=self.eig_max[k],
                              eig_ratio=cfg.eig_ratio, fronts=self.fronts[k])

    def v_cycle(self, k, rhs, u, mode=None):
        """Level index k = number of levels in this sub-hierarchy (as in
        solver.py:141).  ``mode`` is the cycle shape for this sub-tree
        (default: the configured ``cycle_type``): W revisits each coarse
        sub-hierarchy with the same shape, F revisits it with a plain V."""
        mode = mode or self.cycle_type
        if k > 1:
            pre, post = self._smoother_cfg[self.types[k - 2]]
            u = self._smooth(pre, k - 1, rhs, u)
            residual = rhs - self.ops[k - 1].matvec(u)
            rhs_coarse = self.transfers[k - 2].restrict(residual)
            u_coarse = self.v_cycle(k - 1, rhs_coarse,
                                    torch.zeros_like(rhs_coarse), mode=mode)
            if mode in ("W", "F") and k - 1 > 1:
                u_coarse = self.v_cycle(k - 1, rhs_coarse, u_coarse,
                                        mode="W" if mode == "W" else "V")
            u = u + self.transfers[k - 2].prolong(u_coarse)
            u = self._smooth(post, k - 1, rhs, u)
        elif self.coarse_inv is not None:
            u = self.coarse_inv @ rhs
        else:
            pre, _ = self._smoother_cfg[self.types[0]]
            u = self._smooth(pre, 0, rhs, u, iterations=10)
        return u

    def fmg_guess(self, rhs):
        """Full-multigrid (nested-iteration) initial guess: restrict the rhs
        through the hierarchy, solve the coarsest level, then prolong upward
        running one ``cycle_type`` cycle per level."""
        rhss = [rhs]
        for t in reversed(self.transfers):          # fine -> coarse
            rhss.append(t.restrict(rhss[-1]))
        rhss = rhss[::-1]                           # coarsest first
        u = self.v_cycle(1, rhss[0], torch.zeros_like(rhss[0]))
        for k in range(2, len(self.ops) + 1):
            u = self.transfers[k - 2].prolong(u)
            u = self.v_cycle(k, rhss[k - 1], u)
        return u

    # -- outer tolerance loop -------------------------------------------------

    def solve(self, rhs, u0=None, tol=None, max_cycles=None):
        """Run cycles to tolerance; returns (u, final_residual, n_cycles,
        history).

        ``history[i]`` is the normalized residual *before* cycle i (so
        history[0] == 1.0 from a zero guess), matching the reference's
        pickled residual lists (solver.py:118-123); its last entry is the
        final residual.
        """
        mg = self.settings.solver.multigrid
        tol = float(tol if tol is not None else mg.tolerance)
        max_cycles = int(max_cycles if max_cycles is not None else mg.max_cycles)
        A = self.ops[-1]
        n_lev = len(self.ops)
        u = torch.zeros_like(rhs) if u0 is None else u0
        # the normalization stays ||rhs - A*0|| = ||rhs|| when FMG supplies
        # the guess, so "res <= tol" keeps the reference's meaning (relative
        # to the zero iterate, solver.py:117-123) instead of demanding the
        # tolerance beyond the already-good FMG iterate
        if self.full_multigrid:
            u = u + self.fmg_guess(rhs - A.matvec(u))
            res0 = float(lp_norm(rhs, 2))
        else:
            res0 = float(lp_norm(rhs - A.matvec(u), 2))
        res = float(lp_norm(rhs - A.matvec(u), 2)) / res0
        history = []
        n = 0
        while n < max_cycles and res >= tol and math.isfinite(res):
            history.append(res)
            u = self.v_cycle(n_lev, rhs, u)
            res = float(lp_norm(rhs - A.matvec(u), 2)) / res0
            n += 1
        history.append(res)
        return u, res, n, history
