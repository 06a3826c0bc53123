"""DGFEM orchestrator — the port of ``dgtpu/api.py``: for Poisson and
Stokes (local or global ordering) the multigrid (full and mixed precision),
direct, smoother, Krylov (``-k``) and algebraic multigrid (``-amg``) solves,
the finite-volume solve (``-fvm``) and the smoother amplification analysis
(``-amp``).

Builds settings + manufactured solution, reads the grid, constructs the
multigrid hierarchy (penalty / polynomial / geometric coarsening, the
latter optionally down through finite-volume levels) with its transfers (a
single level for the other solves, unless the Krylov solve is
preconditioned by multigrid), assembles every level in float64 on the
chosen device (from the operator cache when ``caching: enabled``, in the
physical-element orthonormal basis when the problem asks for it), runs the
opt-in operator checks, solves, and post-processes: residual norms, the
Stokes pressure mean shift, modal->nodal values, L1/L2 MMS errors, VTK
export and ``summary.txt`` in the reference's schema.  The mixed-precision
route runs float32 cycles (SoA, streamed hybrid or rolled) inside float64
defect correction, optionally seeded by an FMG pass; Stokes retries with
GMRES-wrapped cycles when the plain refinement stalls; where no mixed cycle
builds (a Stokes cycle, a finite-volume transfer) the route runs the
full-precision multigrid, as dgtpu's does.  The full-precision, direct,
smoother, Krylov, AMG, FVM and amplification routes run in float64 plain
torch on the same device.

With ``performance.n_shards > 1`` the multigrid runs sharded over element
rows (``parallel/halo.py``, ``parallel/stokes_halo.py``): one process drives
a list of devices, one per shard, in full precision or with float32 sharded
cycles inside a float64 halo defect loop.  ``automatically open paraview``
starts the configured executable on the exported ``.vts``.  Nothing falls
back to the CPU.
"""

import math
import os
import subprocess

import numpy as np
import torch

from dgtpu_torch.diagnostics import run_diagnostics
from dgtpu_torch.geometry import Geometry
from dgtpu_torch.io.vtk import elements_to_vtk, grid_to_vtk, nodal_lattice
from dgtpu_torch.level import CoarseGridLevel, GridLevel
from dgtpu_torch.mms import ManufacturedSolution
from dgtpu_torch.models.fvm import assemble_poisson_fvm, fvm_cell_centers
from dgtpu_torch.models.poisson import assemble_poisson
from dgtpu_torch.models.stokes import (StokesGeometricTransfer,
                                       StokesPolynomialTransfer, assemble_stokes,
                                       distributive_gauss_seidel_solve,
                                       pressure_mean_shift,
                                       reorder_global_to_local)
from dgtpu_torch.ops.graphs import CycleGraph
from dgtpu_torch.ops.orthonormal import element_bases
from dgtpu_torch.ops.smoothers import element_colors, normalize_smoother_name
from dgtpu_torch.ops.soa import SoAVCycle
from dgtpu_torch.ops.stokes_soa import SoAStokesVCycle
from dgtpu_torch.ops.stokes_stream import StreamedStokesVCycle
from dgtpu_torch.ops.stream import StreamedVCycle
from dgtpu_torch.ops.transfer import make_transfer
from dgtpu_torch.ops.vcycle import RolledVCycle
from dgtpu_torch.parallel.halo import ShardedMultigrid, make_mesh
from dgtpu_torch.parallel.stokes_halo import ShardedStokesMultigrid
from dgtpu_torch.settings import Settings, load_params
from dgtpu_torch.solvers.amg import solve_amg
from dgtpu_torch.solvers.amplification import calculate_amplification
from dgtpu_torch.solvers.direct import solve_direct
from dgtpu_torch.solvers.krylov import solve_krylov
from dgtpu_torch.solvers.multigrid import MultigridSolver
from dgtpu_torch.solvers.refinement import make_refined_solver
from dgtpu_torch.solvers.relaxation_driver import residual_tracked_smoother
from dgtpu_torch.utils import caching
from dgtpu_torch.utils.logger import Logger
from dgtpu_torch.utils.norms import lp_norm
from dgtpu_torch.utils.timer import Timer, synchronize

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# results/ and postprocessing/dgtpu_torch/ are written below this directory
OUTPUT_ROOT = REPO_ROOT


def _wants_mg_precond(settings):
    """Whether the Krylov solve is preconditioned by a multigrid cycle (it
    then assembles the multigrid hierarchy)."""
    return (settings.solver.method == "krylov"
            and str(getattr(getattr(settings.solver, "krylov", None),
                            "preconditioner", "")) == "multigrid")


def _n_shards(settings):
    return int(getattr(getattr(settings, "performance", None), "n_shards", 1) or 1)


def stream_budget(device):
    """Device bytes the SoA cycle's hierarchy may take before the finest
    levels stream: the card's L2 cache (dgtpu's counterpart is its VMEM
    budget, ``dgtpu/api.py:475-484``).  None off the card: the CPU route stays
    SoA, as dgtpu's does off the TPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).L2_cache_size


class DGFEM:
    """``DGFEM(device="cuda", **kwargs)`` — dgtpu's constructor keywords plus
    an explicit ``device``.  A CUDA device must be available: nothing falls
    back to the CPU."""

    def __init__(self, device="cuda", **kwargs):
        if kwargs.get("settings"):
            self.settings = kwargs["settings"]
        else:
            self.settings = Settings(load_params(kwargs.get("paramfile")))
        self.settings.update_settings(kwargs)

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available (pass device='cpu' for a CPU run)")

        self.logger = Logger(__name__, self.settings).logger

        for key, arg in kwargs.items():
            if "solve_" in key and arg:
                self.settings.solver.method = key.removeprefix("solve_")
        if not hasattr(self.settings.solver, "method"):
            self.settings.solver.method = "direct"
        problem = self.settings.problem.type
        if problem not in ("Poisson", "Stokes"):
            raise NotImplementedError(
                f"There exists no implementation for the {problem} equation(s), "
                f"possible equation(s) are: Poisson|Stokes")
        folder = self.settings.grid.folder
        grid_filepath = (folder if os.path.isabs(folder)
                         else os.path.join(REPO_ROOT, folder))
        grid_filepath = os.path.join(grid_filepath, self.settings.grid.filename)
        self.geometry = Geometry(grid_filepath, self.settings)

        self.vars = ["u"] if problem == "Poisson" else ["u", "p"]
        self.P_sol = {v: getattr(self.settings.solution, v).polynomial_degree
                      for v in self.vars}
        exact = {k: getattr(self.settings.problem.exact_solution, k, None)
                 for k in ("u", "v", "p")}
        lam = getattr(self.settings.problem.exact_solution, "lam", None)
        self.mms = ManufacturedSolution(
            exact, problem, self.settings.problem.kinematic_viscosity,
            lam_expr=lam)
        if problem == "Stokes":
            if self.settings.solution.manufactured_solution:
                self.mms.check_divergence_free()
            self.exact_p_mean = self.mms.compute_pressure_mean(
                self.geometry, self.settings.grid.circular)
        self.settings._validate_settings(self.settings)

        # results folder structure (dgfem.py:64-101)
        grid_filename = os.path.splitext(self.settings.grid.filename)[0]
        results_folder = f"exact_sol_{self.settings.problem.exact_solution.tag}"
        mul = self.settings.problem.SIP_penalty_parameter_multiplier
        results_folder += f"_sigmamul{mul}".replace(".", "_")
        if problem == "Stokes":
            results_folder += (f"_gamma{self.settings.problem.velocity_penalty_parameter}"
                               .replace(".", "_"))
        self.results_dir = os.path.join(OUTPUT_ROOT, "results", problem,
                                        f"grid_{grid_filename}", results_folder)
        os.makedirs(self.results_dir, exist_ok=True)
        self.solution_visualization_filepath = os.path.join(
            self.results_dir,
            "solution_" + "_".join(f"P{v}{self.P_sol[v]}" for v in self.vars))
        self.solution_summary_filepath = os.path.join(self.results_dir, "summary.txt")

        self.residuals = []
        self.initialize()

        if self.settings.visualization.export:
            grid_to_vtk(os.path.join(self.results_dir, "grid"),
                        self.geometry.x, self.geometry.y)
        self._write_summary_header(grid_filename)

    # ------------------------------------------------------------------ setup

    def initialize(self):
        s = self.settings
        self.sigma = (s.problem.SIP_penalty_parameter if s.problem.SIP_penalty_parameter
                      else (self.P_sol["u"] + 1) ** 2
                      * s.problem.SIP_penalty_parameter_multiplier)
        self.levels = []
        self.transfers = []
        self.transfer_types = []
        if s.solver.method == "multigrid" or _wants_mg_precond(s):
            # a Krylov solve preconditioned by multigrid assembles the same
            # hierarchy; one cycle per Krylov iteration applies M
            self._build_multigrid_hierarchy()
        else:
            self.levels.append(self._level(self.P_sol, self.sigma,
                                           discretization=s.solver.discretization))
        for idx, lvl in enumerate(self.levels):
            self.logger.debug(
                f"grid number {idx+1}: P_grid={lvl.P_grid}, P_sol={lvl.P_sol}, "
                f"sigma={lvl.sigma}, Ni={lvl.Ni}, Nj={lvl.Nj}")
        self._assemble_all()

    def _level(self, P_sol, sigma, discretization="dg"):
        return GridLevel(self.geometry, self.settings, self.vars, P_sol, sigma,
                         device=self.device, discretization=discretization)

    def _build_multigrid_hierarchy(self):
        """Mirror of dgfem.assemble_multigrid_operators (dgfem.py:269-376).

        Levels are ordered coarsest -> finest; transfers[k] sits between
        levels[k] and levels[k+1].
        """
        s = self.settings
        mg = s.solver.multigrid
        dev = self.device

        if mg.penalty_parameter_coarsening.enabled:
            sigma_min = (self.P_sol["u"] + 1) ** 2
            multipliers = sorted(map(int, str(
                mg.penalty_parameter_coarsening.multipliers).split(",")))
            sigmas = [sigma_min * m for m in multipliers]
            if any(m < 2 for m in multipliers):
                self.logger.warning(
                    "You are trying to use a penalty parameter multiplier lower "
                    "than 2, expect unstable results on curved grids")
            self.levels[0:0] = [self._level(self.P_sol, sig) for sig in sigmas]
            self.transfers[0:0] = [make_transfer("penalty", p_fine=self.P_sol["u"],
                                                 device=dev)
                                   for _ in range(len(sigmas) - 1)]
            self.transfer_types[0:0] = ["penalty_parameter"] * (len(sigmas) - 1)

        if mg.polynomial_coarsening.enabled:
            node = mg.polynomial_coarsening.levels
            p_levels = {"u": sorted(map(int, str(node.u).split(",")))}
            if "p" in self.vars:
                if getattr(node, "p", None) is not None:
                    p_levels["p"] = sorted(map(int, str(node.p).split(",")))
                else:
                    # pressure levels derived from the velocity ones
                    # (Taylor-Hood pairing), as dgtpu does
                    p_levels["p"] = [max(pu - 1, 0) for pu in p_levels["u"]]
            if mg.penalty_parameter_coarsening.enabled:
                p_levels_grids = {v: lv[:-1] for v, lv in p_levels.items()}
                s.problem.SIP_penalty_parameter_multiplier = multipliers[0]
            else:
                p_levels_grids = p_levels
            self.levels[0:0] = [
                self._level(dict(zip(p_levels_grids, ps)), (ps[0] + 1) ** 2
                            * s.problem.SIP_penalty_parameter_multiplier)
                for ps in zip(*p_levels_grids.values())]
            pu = p_levels["u"]
            if "p" in self.vars:
                pp = p_levels["p"]
                p_transfers = [StokesPolynomialTransfer(
                    self.geometry.N, pu_fine=pu[i + 1], pu_coarse=pu[i],
                    pp_fine=pp[i + 1], pp_coarse=pp[i], device=dev)
                    for i in range(len(pu) - 1)]
            else:
                p_transfers = [make_transfer("polynomial", p_fine=pu[i + 1],
                                             p_coarse=pu[i], device=dev)
                               for i in range(len(pu) - 1)]
            self.transfers[0:0] = p_transfers
            self.transfer_types[0:0] = ["polynomial"] * len(p_transfers)

        if mg.geometric_coarsening.enabled:
            if not self.levels:
                self.levels.append(self._level(self.P_sol, self.sigma))
            use_fvm = bool(mg.geometric_coarsening.use_FVM)
            if use_fvm:
                # an FVM level on the finest DG level's cells, then the
                # geometric levels below it are FVM too
                dg_above = self.levels[0]
                # under the inverse-mass premultiply the DG residual is
                # mass-scaled: the cell area / 4 turns it into the FVM
                # integral form (dgtpu's row scale)
                scale = (dg_above.gt["A"] / 4.0
                         if s.problem.multiply_inverse_mass_matrix else None)
                self.levels[0:0] = [self._level(self.P_sol, self.sigma,
                                                discretization="fvm")]
                self.transfers[0:0] = [make_transfer(
                    "dg_to_fvm", p_fine=dg_above.P_sol["u"], row_scale=scale,
                    device=dev)]
                self.transfer_types[0:0] = ["geometric"]
            cfs = mg.geometric_coarsening.coarsening_factors
            cfs = (sorted(map(int, str(cfs).split(",")), reverse=True)
                   if not isinstance(cfs, int) else [cfs])
            # every geometric transfer is a 2x2 agglomeration between
            # consecutive levels: validate the chain
            chain = cfs + [1]
            if any(a != 2 * b for a, b in zip(chain, chain[1:])):
                raise ValueError(
                    "geometric coarsening factors must form a contiguous "
                    f"2x chain down to the fine grid (e.g. '8,4,2'); got {cfs}")
            base = self.levels[0]
            coarse = [CoarseGridLevel(self.geometry, base, s, self.vars, cf, device=dev,
                                      discretization="fvm" if use_fvm else "dg")
                      for cf in cfs]
            self.levels[0:0] = coarse
            if use_fvm:
                geo_transfers = [make_transfer(
                    "geometric_fvm", Ni_c=self.levels[k].Ni, Nj_c=self.levels[k].Nj,
                    device=dev) for k in range(len(coarse))]
            elif "p" in self.vars:
                geo_transfers = [StokesGeometricTransfer(
                    self.levels[k].Ni, self.levels[k].Nj,
                    pu=self.levels[k].P_sol["u"], pp=self.levels[k].P_sol["p"],
                    device=dev) for k in range(len(coarse))]
            else:
                geo_transfers = [make_transfer(
                    "geometric", p_fine=self.levels[k].P_sol["u"], cf=2,
                    device=dev, Ni_c=self.levels[k].Ni, Nj_c=self.levels[k].Nj)
                    for k in range(len(coarse))]
            self.transfers[0:0] = geo_transfers
            self.transfer_types[0:0] = ["geometric"] * len(geo_transfers)

        if not self.levels:
            raise ValueError("multigrid requires at least one coarsening type enabled")

    def _assemble_all(self):
        """Assemble every level (the right-hand side on the finest); a DG
        Poisson level is loaded from the operator cache when caching is on
        and the file holds what the level needs (Stokes levels cache inside
        ``assemble_stokes``); then the opt-in operator checks."""
        finest = self.levels[-1]
        direct = self.settings.solver.method == "direct"
        problem = self.settings.problem.type
        for lvl in self.levels:
            mms = self.mms if lvl is finest else None
            if "p" in self.vars:
                assemble_stokes(lvl, mms, direct=direct)
            elif lvl.discretization == "fvm":
                lvl.op, lvl.rhs = assemble_poisson_fvm(lvl, self.mms)
            else:
                cached = caching.load_operator(lvl, problem)
                if cached is not None and (cached[1] is not None or mms is None):
                    lvl.op, lvl.rhs, lvl.inv_mass = cached
                    # the modal coefficients are in the level's basis
                    element_bases(lvl, vars=("u",))
                    self.logger.debug("loaded assembled system from cache")
                else:
                    lvl.op, lvl.rhs, lvl.inv_mass = assemble_poisson(lvl, mms)
                    caching.save_operator(lvl, problem, lvl.op, lvl.rhs, lvl.inv_mass)
        run_diagnostics(self, finest)

    # ------------------------------------------------------------------ solve

    def solve(self):
        s = self.settings
        method = s.solver.method
        finest = self.levels[-1]
        self.logger.debug(f"Solving with {method} method ...")
        if method != "multigrid" and _n_shards(s) > 1:
            self.logger.warning(
                "performance.n_shards only applies to the multigrid solver; "
                f"running {method} single-device")
        self.graph_seconds = 0.0
        with Timer() as t:
            if method in ("direct", "finite_volume_method"):
                u_modal = solve_direct(finest.op, finest.rhs)
            elif method == "smoother_amplification":
                # the analysis dict, before any post-processing, as dgtpu
                return calculate_amplification(finest, self.results_dir)
            elif method == "smoother":
                u_modal = self._solve_smoother(finest)
            elif method == "krylov":
                u_modal, self.krylov_iterations = solve_krylov(
                    finest, s, mg_cycle=self._krylov_mg_cycle())
            elif method == "pyamg":
                variant = str(getattr(getattr(s.solver, "amg", None), "variant", "sa"))
                u_modal, self.amg_info = solve_amg(finest.op, finest.rhs,
                                                   variant=variant)
            elif method == "multigrid" and _n_shards(s) > 1:
                u_modal, res, n = self._solve_multigrid_sharded(
                    _n_shards(s), str(getattr(s.performance, "precision", "full")))
                self.solve_residual = res
                self.residuals = list(self.mg.history)
            elif method == "multigrid":
                precision = str(getattr(s.performance, "precision", "full"))
                if precision == "mixed":
                    try:
                        u_modal, res, n = self._solve_multigrid_mixed(finest)
                        self.solve_residual, self.outer_rounds = res, n
                    except NotImplementedError as e:
                        # dgtpu's route choice: the full-precision multigrid
                        # where no mixed cycle builds (on the same device)
                        self.logger.warning(str(e))
                        precision = "full"
                if precision != "mixed":
                    u_modal, res, n = self._solve_multigrid_full(finest)
                    self.solve_residual, self.cycles = res, n
            else:
                raise NotImplementedError(method)
            synchronize(u_modal)
        self.solve_seconds = t.elapsed() - self.graph_seconds
        if method == "multigrid":
            self.logger.info(f"multigrid: {int(n)} cycles or outer rounds, final "
                             f"normalized residual {float(res):.6e}")
            self._save_residual_history("multigrid")
        self.logger.info(f"Solving with {method} method took {self.solve_seconds:.4g} "
                         f"seconds (and {self.graph_seconds:.4g} s capturing CUDA graphs)")
        return self._postprocess(u_modal)

    def _solve_multigrid_full(self, finest):
        """Full-precision multigrid: float64 cycles of the generic
        ``MultigridSolver`` with the configured smoothers (sequential or
        red-black, ``performance.smoother_parallelization``; distributive GS
        on Stokes, ``performance.dgs_splitting``) to
        ``solver.multigrid.tolerance``."""
        self.mg = self._multigrid_solver()
        u, res, n, hist = self.mg.solve(finest.rhs)
        self.residuals = [r for r in hist if math.isfinite(r)]
        self.cycle_kind = "full precision"
        return u, res, n

    def _solve_multigrid_sharded(self, n_shards, precision="full"):
        """Multigrid over ``n_shards`` element-row bands (dgtpu's
        ``_solve_multigrid_sharded``, ``api.py:585-672``): Poisson with
        red-black smoothing and a halo exchange, Stokes with the
        distributive-GS smoother in stencil/halo form.  ``precision='mixed'``
        runs float32 sharded cycles inside a float64 halo defect loop to
        min(tol, 1e-10); Stokes retries with GMRES(16)-wrapped cycles when
        the plain refinement stalls.  The shards go to ``make_mesh``'s
        devices: on the card shard k to card k modulo the visible cards,
        so one card may hold every shard (dgtpu refuses fewer devices than
        shards)."""
        mesh = make_mesh(n_shards, self.device)
        finest = self.levels[-1]
        mixed = precision == "mixed"
        if mixed and bool(getattr(self.settings.solver.multigrid, "full_multigrid", False)):
            self.logger.info("sharded mixed-precision refinement seeded with the "
                             "shard-local FMG (nested-iteration) guess")
        if "p" in self.vars:
            # the sharded Stokes smoother is structurally distributive GS
            # (cell-Vanka diverges on SIP-DG): warn if the config names another
            mgs = self.settings.solver.multigrid
            for t in set(self.transfer_types):
                node = getattr(mgs, f"{t}_coarsening")
                for side in (node.pre_smoother, node.post_smoother):
                    if normalize_smoother_name(side.smoother) != "distributive_gauss_seidel":
                        self.logger.warning(
                            f"sharded Stokes multigrid smooths with distributive GS, "
                            f"not the configured {side.smoother!r}")
            self.mg = ShardedStokesMultigrid(self.levels, self.settings, mesh=mesh,
                                             transfers=self.transfers,
                                             transfer_types=self.transfer_types)
        else:
            self.mg = ShardedMultigrid(self.levels, self.transfers, self.settings,
                                       mesh=mesh)
        cards = mesh.cards
        self.mesh = mesh
        self.cycle_kind = f"sharded {'mixed' if mixed else 'full precision'}"
        self.logger.info(f"sharded multigrid over {n_shards} shards on {len(cards)} "
                         f"{cards[0].type} device(s) {[str(d) for d in cards]}")
        if not mixed:
            u, res, n = self.mg.solve(finest.rhs)
            self.cycles = n
            return u, res, n
        tol = min(float(self.settings.solver.multigrid.tolerance), 1e-10)
        self.logger.info("sharded mixed-precision refinement (f32 inner cycles, "
                         "f64 halo defect loop)")
        u, res, n = self.mg.solve_refined(finest.rhs, tol=tol)
        self.inner, self.rounds = "cycles", {"cycles": n}
        if "p" in self.vars and res >= tol:
            # the single-device rescue: deep hierarchies push the stand-alone
            # cycle contraction past 1; GMRES(16) preconditioned by the
            # sharded cycle converges on the isolated divergent modes
            self.logger.warning(f"sharded mixed refinement stalled at {res:.3e}; "
                                "retrying with f32 GMRES-wrapped inner cycles")
            u, res, n = self.mg.solve_refined(finest.rhs, tol=tol, n_inner=16,
                                              inner="gmres")
            self.inner, self.rounds["gmres"] = "gmres", n
        self.outer_rounds = n
        return u, res, n

    def _multigrid_solver(self):
        colors = [element_colors(l.Ni, l.Nj, self.device) for l in self.levels]
        return MultigridSolver([l.op for l in self.levels], self.transfers,
                               self.transfer_types, self.settings, colors=colors,
                               levels=self.levels)

    def _krylov_mg_cycle(self):
        """One multigrid cycle from zero as the Krylov preconditioner
        application (dgtpu's ``_krylov_mg_cycle``, ``api.py:395-426``), or
        None unless ``solver.krylov.preconditioner: multigrid``.  A cycle
        from a zero guess is a fixed linear operator.  It runs eagerly (dgtpu
        jits it)."""
        if not _wants_mg_precond(self.settings):
            return None
        if len(self.levels) < 2:
            raise ValueError(
                "solver.krylov.preconditioner: multigrid needs a coarse "
                "hierarchy — enable at least one solver.multigrid coarsening")
        self.mg = self._multigrid_solver()
        k = len(self.mg.ops)

        def cycle(r):
            return self.mg.v_cycle(k, r, torch.zeros_like(r))

        return cycle

    def _solve_smoother(self, finest):
        """The stand-alone smoother solve (``-s --smoother NAME``): symmetric
        sweeps until the residual drops by 6 orders, diverges or 1000 sweeps
        pass (the reference's cap, relaxation.py:198); distributive GS (lsq
        splitting) sweeps up to 100,000 times, as dgtpu's."""
        s = self.settings
        name = getattr(s.solver, "smoother", "block_gauss_seidel")
        if str(name).lower() == "distributive_gauss_seidel":
            u, hist, n, status = distributive_gauss_seidel_solve(
                finest, finest.rhs, max_iterations=1_000_000, splitting="lsq")
        else:
            u, hist, n, status = residual_tracked_smoother(
                finest.op, finest.rhs, name=name, direction="symmetric",
                max_iterations=1000,
                strategy=getattr(s.performance, "smoother_parallelization",
                                 "sequential"),
                colors=element_colors(finest.Ni, finest.Nj, self.device))
        self.residuals = [r for r in hist if math.isfinite(r)]
        self.sweeps, self.smoother_status = n, status
        self._save_residual_history("relaxation")
        if status == 0:
            self.logger.info(f"Residual reduced by 6 orders in {n} sweeps")
        elif status == 2:
            self.logger.error(f"smoother diverged after {n} sweeps "
                              f"(normalized residual > 1e10 or non-finite)")
        else:
            self.logger.warning(f"smoother hit the iteration cap after {n} sweeps "
                                f"without converging")
        return u

    def _solve_multigrid_mixed(self, finest):
        """Mixed-precision multigrid: float32 cycles (the CUDA kernels on a
        GPU) inside float64 defect correction, optionally seeded by the FMG
        guess (``solver.multigrid.full_multigrid``).  The cycle is dgtpu's
        choice (``api.py:489-535``): the SoA cycle while its hierarchy's
        device bytes fit ``stream_budget`` (the card's L2), else the
        streamed hybrid, for Poisson and for Stokes; for Poisson the rolled
        cycle where neither can be built (an odd Ni on some level, an
        F-cycle past the budget).  When the plain
        refinement stalls and the cycle has a matvec (the Stokes cycles:
        deep hierarchies push the stand-alone contraction past 1), the
        refinement retries with GMRES(16)-wrapped cycles (``api.py:557-578``).
        On the card the chosen cycle (and the GMRES retry's matvec) is
        captured once as a CUDA graph and replayed (``ops/graphs.py``): dgtpu
        compiles its refined solve into one XLA program, the port replays a
        captured cycle; the captures' seconds go to ``graph_seconds``, apart
        from ``solve_seconds``.  The route and the cut are left in
        ``cycle_kind`` and ``cut``."""
        s = self.settings
        mg = s.solver.multigrid
        fmg_on = bool(getattr(mg, "full_multigrid", False))
        # the route targets at least the 1e-10 parity residual
        tol = min(float(mg.tolerance), 1e-10)
        dims = [(l.Nj, l.Ni) for l in self.levels]
        stokes = "p" in self.vars
        # no mixed cycle has the FVM transfers: refuse before any cycle is
        # built, so solve() runs the full-precision multigrid (dgtpu's check)
        unsupported = ({t.kind for t in self.transfers}
                       - {"penalty", "polynomial", "geometric"})
        if unsupported:
            raise NotImplementedError(
                "mixed precision: the float32 cycles do not support transfer "
                f"kind(s) {sorted(unsupported)} (FVM coarse level); running full "
                "precision")
        ops = [l.op for l in self.levels]
        coarse = mg.coarse_grid_solver in ("direct", "amg")
        budget = stream_budget(self.device)
        if stokes:
            held = SoAStokesVCycle.device_bytes(self.levels, self.transfers,
                                                with_coarse=coarse)
        else:
            held = SoAVCycle.device_bytes(ops, dims, self.transfers, with_coarse=coarse)
        big = budget is not None and held > budget
        common = dict(dtype=torch.float32, device=self.device)
        try:
            if stokes and big:
                cycle = StreamedStokesVCycle(self.levels, self.transfers,
                                             self.transfer_types, s, budget, **common)
                kind = "streamed Stokes hybrid"
            elif stokes:
                cycle = SoAStokesVCycle(self.levels, self.transfers,
                                        self.transfer_types, s, **common)
                kind = "Stokes SoA"
            elif big:
                cycle = StreamedVCycle(ops, self.transfers, self.transfer_types, s,
                                       dims, budget, **common)
                kind = "streamed hybrid"
            else:
                cycle = SoAVCycle(ops, self.transfers, self.transfer_types, s, dims,
                                  **common)
                kind = "SoA"
        except (ValueError, NotImplementedError) as e:
            if stokes:
                # the rolled cycle smooths with block GS on the saddle
                # operator, not the configured distributive GS: solve() runs
                # the full-precision multigrid instead
                raise NotImplementedError(
                    "mixed precision: the fused Stokes cycle is unavailable "
                    f"({e}); running full precision") from e
            self.logger.info(f"SoA cycle unavailable ({e}); running the rolled cycle")
            cycle = RolledVCycle(ops, self.transfers, self.transfer_types, s, dims,
                                 **common)
            kind, held = "rolled", cycle.device_bytes()
        self.cycle_kind, self.cut = kind, getattr(cycle, "cut", None)
        self.logger.info(f"inner cycle: {kind}, device bytes {held} against the "
                         f"budget {budget}, cut {self.cut}")
        graphs = []

        def graphed(fn):
            if self.device.type != "cuda":
                return fn
            graphs.append(CycleGraph(fn))
            return graphs[-1]

        run = graphed(cycle)
        rhs = finest.rhs
        u0 = torch.zeros_like(rhs)
        if fmg_on:
            # the FMG pass's finest-level cycle is the same cycle the
            # refinement runs
            u0 = cycle.build_fmg(finest_cycle=run)(rhs).to(rhs.dtype)
            kind += " + FMG guess"
        normalize = "rhs" if fmg_on else "u0"
        refined = make_refined_solver(finest.op, run, n_inner=6, tol=tol,
                                      normalize=normalize)
        u, res, n, hist = refined(rhs, u0)
        self.residuals = [r for r in hist if math.isfinite(r)]
        self.inner, self.rounds = "cycles", {"cycles": n}
        self.logger.info(
            f"mixed-precision multigrid ({kind} inner cycle): {n} outer "
            f"refinement rounds x 6 f32 cycles, residual {res:.3e}")
        if not res < tol and hasattr(cycle, "build_matvec"):
            self.logger.warning(
                f"mixed-precision refinement stalled at {res:.3e}; retrying "
                "with f32 GMRES-wrapped inner cycles")
            refined = make_refined_solver(
                finest.op, run, n_inner=16, tol=tol, normalize=normalize,
                inner="gmres", matvec32=graphed(cycle.build_matvec()))
            u, res, n, hist = refined(rhs, u0)
            self.residuals += [r for r in hist if math.isfinite(r)]
            self.inner, self.rounds["gmres"] = "gmres", n
            self.logger.info(f"GMRES-wrapped refinement: {n} outer rounds, "
                             f"residual {res:.3e}")
        if res >= tol:
            self.logger.warning(
                f"mixed-precision refinement stopped at {res:.3e} "
                f"(tolerance {tol:g})")
        self.graphed = bool(graphs)
        self.graph_seconds = sum(g.capture_seconds for g in graphs)
        return u, res, n

    def _save_residual_history(self, kind):
        """Residual history as .npy (the reference pickles it, solver.py:128-138),
        under the port's own directory so dgtpu's histories stay apart.
        ``kind``: 'multigrid' or 'relaxation'."""
        lvl = self.levels[-1]
        path = os.path.join(OUTPUT_ROOT, "postprocessing", "dgtpu_torch", kind)
        os.makedirs(path, exist_ok=True)
        name = (f"residuals_{self.settings.problem.type}_{lvl.Ni}X{lvl.Nj}"
                f"_nPoly{lvl.P_grid}")
        if kind == "multigrid":
            name += "_" + "_".join(sorted(set(self.transfer_types)))
        name += "_circle" if self.settings.grid.circular else "_rectangle"
        np.save(os.path.join(path, name + ".npy"), np.asarray(self.residuals))

    # ---------------------------------------------------------------- post

    def _postprocess(self, u_modal):
        s = self.settings
        finest = self.levels[-1]
        stokes = "p" in self.vars

        residual_0 = float(lp_norm(finest.rhs, 2))
        self.residual = float(lp_norm(finest.rhs - finest.op.matvec(u_modal), 2))
        self.logger.info(f"L2 norm of the residual (modal): {self.residual:.6e} "
                         f"(not normalized)")
        self.logger.info(f"L2 norm of the residual (modal): "
                         f"{self.residual / residual_0:.6e} (normalized)")

        if finest.discretization == "fvm":
            # cell averages against the exact solution at the cell centers
            exact = self.mms.u(*fvm_cell_centers(finest))
            self.L1_error_u = float(lp_norm(u_modal - exact, 1))
            self.L2_error_u = float(lp_norm(u_modal - exact, 2))
            self.logger.info(f"The norms of the error (nodal) are: "
                             f"L1={self.L1_error_u:.6e}, L2={self.L2_error_u:.6e}")
            self.u_nodal = u_modal.cpu().numpy()
            self._write_summary_results()
            return u_modal

        u_local = (reorder_global_to_local(finest, u_modal)
                   if s.solution.ordering == "global" else u_modal)
        u_el = u_local.reshape(finest.N, finest.N_DOF_sol_tot)
        if stokes and s.solver.method != "smoother":
            u_el = pressure_mean_shift(finest, u_el)

        # modal -> nodal (dgfem.py:201-209), batched; per-element nodal
        # tables under the physical-element orthonormal basis (element.py:43)
        eb = getattr(finest, "element_basis", None) or {}

        def to_nodal(modal, var):
            if eb.get(var) is not None:
                Vg_e = eb[var].apply(finest.quad.V_sol_grid[var])     # (N, G, B)
                return torch.einsum("ngb,nb->ng", Vg_e, modal)
            Vg = torch.as_tensor(finest.quad.V_sol_grid[var], device=self.device)
            return modal @ Vg.T

        nu_dof = finest.N_DOF_sol["u"]
        X = torch.as_tensor(finest.X, device=self.device)
        Y = torch.as_tensor(finest.Y, device=self.device)
        fields = {"u": (to_nodal(u_el[:, :nu_dof], "u"), self.mms.u(X, Y))}
        if stokes:
            np_dof = finest.N_DOF_sol["p"]
            fields["v"] = (to_nodal(u_el[:, nu_dof:2 * nu_dof], "u"), self.mms.v(X, Y))
            fields["p"] = (to_nodal(u_el[:, -np_dof:], "p"), self.mms.p(X, Y))
        for var, (num, exact) in fields.items():
            setattr(self, f"L1_error_{var}", float(lp_norm(num - exact, 1)))
            setattr(self, f"L2_error_{var}", float(lp_norm(num - exact, 2)))
        if stokes:
            for var, name in (("u", "u-velocity"), ("v", "v-velocity"),
                              ("p", "pressure")):
                self.logger.info(
                    f"The norms of the error in {name} (nodal) are: "
                    f"L1={getattr(self, f'L1_error_{var}'):.6e}, "
                    f"L2={getattr(self, f'L2_error_{var}'):.6e}")
        else:
            self.logger.info(f"The norms of the error (nodal) are: "
                             f"L1={self.L1_error_u:.6e}, L2={self.L2_error_u:.6e}")

        self.u_nodal = fields["u"][0].cpu().numpy()
        if s.visualization.export:
            # VTK field names as dgtpu's (_nodal_lattices)
            names = {"u": "phi", "v": "v", "p": "pressure"}
            lattices = {}
            for var, (num, exact) in fields.items():
                nn = nodal_lattice(finest, num.cpu().numpy())
                ne = nodal_lattice(finest, exact.cpu().numpy())
                name = names[var]
                lattices.update({name: nn, f"{name}_exact": ne,
                                 f"abs_error_{name}": np.abs(nn - ne)})
            elements_to_vtk(self.solution_visualization_filepath,
                            self.geometry.x, self.geometry.y, lattices)
        self._write_summary_results()
        if s.visualization.automatically_open_paraview:
            executable = s.visualization.paraview_executable_path
            if not executable:
                raise ValueError("ParaView executable path must be set in paramfile.yml")
            subprocess.Popen([str(executable),
                              self.solution_visualization_filepath + ".vts"])
        return u_modal

    def _write_summary_header(self, grid_filename):
        s = self.settings
        with open(self.solution_summary_filepath, "w") as f:
            f.write("############################################\n")
            f.write("###          SIMULATION SUMMARY          ###\n")
            f.write("############################################\n\n")
            f.write(f"### grid={grid_filename}\n")
            exact = {k: getattr(s.problem.exact_solution, k, None)
                     for k in (("u",) if s.problem.type == "Poisson"
                               else ("u", "v", "p"))}
            f.write(f"### exact solution={exact}\n")
            f.write(f"### Ni={self.geometry.Ni}, Nj={self.geometry.Nj}\n")
            f.write(f"### P grid={s.grid.polynomial_degree}\n")
            f.write(f"### P sol={self.P_sol}\n")
            f.write(f"### epsilon multiplier={s.problem.SIP_penalty_parameter_multiplier}\n")
            if s.problem.type == "Stokes":
                f.write(f"### gamma={s.problem.velocity_penalty_parameter}\n")
            f.write("###\n")
            method = "multigrid" if s.solver.method == "multigrid" else "direct"
            f.write(f"### solver={method}\n\n")
            f.write("############################################\n\n")

    def _write_summary_results(self):
        with open(self.solution_summary_filepath, "a") as f:
            f.write(f"Residual={self.residual}\n")
            if "p" in self.vars:
                for var, name in (("u", "u-velocity"), ("v", "v-velocity"),
                                  ("p", "pressure")):
                    f.write(f"L1 error={getattr(self, f'L1_error_{var}')} ({name})\n")
                    f.write(f"L2 error={getattr(self, f'L2_error_{var}')} ({name})\n")
            else:
                f.write(f"L1 error={self.L1_error_u}\n")
                f.write(f"L2 error={self.L2_error_u}\n")
