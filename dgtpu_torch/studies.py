"""Studies (port of ``dgtpu/studies.py``): h-/p-refinement convergence
sweeps, the smoother's spectral radius over grids and degrees, and the
basis / element figure set, each writing a JSON table and its plot.

The reference collects its convergence figures from per-run ``summary.txt``
files by hand (visualization.py:403-584); these drive the port's ``DGFEM``
over the sweep in one call.  ``device`` is the solves' torch device
(default ``cuda``, as every entry point of the port).  Outputs default to
``postprocessing/dgtpu_torch/<study>`` below ``api.OUTPUT_ROOT``, apart
from dgtpu's ``postprocessing/<study>``.
"""

import json
import os

import numpy as np

from dgtpu_torch import api
from dgtpu_torch import visualization as viz
from dgtpu_torch.diagnostics import spectral_radius_gs
from dgtpu_torch.settings import Settings, load_params


def _default_outdir(study):
    return os.path.join(api.OUTPUT_ROOT, "postprocessing", "dgtpu_torch", study)


def run_convergence_study(grid_sizes=(2, 4, 8), degrees=(1, 2, 3), p_grid=1,
                          method="direct", problem="Poisson", exact=None,
                          paramfile=None, outdir=None, silent=True, device="cuda"):
    """Solve on each grid and degree; returns ({p: [(N, L2_error), ...]},
    {p: observed rates}) and writes ``<problem>_convergence.json`` and its
    plot into ``outdir``."""
    results = {}
    details = []
    for p in degrees:
        pts = []
        for n in grid_sizes:
            params = load_params(paramfile)
            params["problem"]["type"] = problem
            if exact:
                params["problem"]["exact solution"] = dict(exact)
            params["grid"]["filename"] = f"Rectangle_{n}X{n}_nPoly{p_grid}.xyz"
            params["grid"]["polynomial degree"] = p_grid
            params["solution"]["u"]["polynomial degree"] = p
            if problem == "Stokes":
                params["solution"]["p"]["polynomial degree"] = max(p - 1, 0)
            params["visualization"]["export"] = False
            params["visualization"]["automatically open paraview"] = False
            params["logging"]["loglevel"] = "ERROR" if silent else "INFO"
            s = Settings(params)
            s.solver.method = method
            s.update_setting("solver.discretization", "dg")
            dg = api.DGFEM(device=device, settings=s, **{f"solve_{method}": True})
            dg.solve()
            pts.append((n, dg.L2_error_u))
            row = {"p": p, "N": n, "L2_u": dg.L2_error_u, "L1_u": dg.L1_error_u,
                   "residual": dg.residual}
            if problem == "Stokes":
                row.update({"L2_v": dg.L2_error_v, "L2_p": dg.L2_error_p})
            details.append(row)
        results[p] = pts

    rates = {}
    for p, pts in results.items():
        errs = [e for _, e in sorted(pts)]
        rates[p] = [float(np.log2(errs[i] / errs[i + 1])) for i in range(len(errs) - 1)]

    outdir = outdir or _default_outdir("convergence")
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"{problem}_convergence.json"), "w") as f:
        json.dump({"details": details, "rates": rates}, f, indent=1)
    viz.plot_grid_convergence(results, outdir=outdir, name=f"{problem}_convergence")
    return results, rates


def run_spectral_radius_study(grid_sizes=(2, 4), degrees=(1, 2), p_grid=1,
                              grid_kind="rectangle", sigma_multiplier=1,
                              which="forward", outdir=None, device="cuda"):
    """rho(B) of the block-GS iteration matrix over grids x degrees (the
    reference computes each with ``check_iteration_matrix``,
    relaxation.py:494-509, and collects them for plot_spectral_radius,
    visualization.py:586-720).  Returns {p: [(n, rho), ...]} and writes
    ``spectral_radius_<grid_kind>.json`` and its plot."""
    results = {}
    for p in degrees:
        pts = []
        for n in grid_sizes:
            params = load_params()
            prefix = "Rectangle" if grid_kind == "rectangle" else "CircleInCircle"
            params["grid"]["filename"] = f"{prefix}_{n}X{n}_nPoly{p_grid}.xyz"
            params["grid"]["polynomial degree"] = p_grid
            if grid_kind != "rectangle":
                params["grid"]["O grid"] = True
            params["solution"]["u"]["polynomial degree"] = p
            params["problem"]["SIP penalty parameter multiplier"] = sigma_multiplier
            params["visualization"]["export"] = False
            params["visualization"]["automatically open paraview"] = False
            params["logging"]["loglevel"] = "ERROR"
            s = Settings(params)
            s.solver.method = "direct"
            s.update_setting("solver.discretization", "dg")
            dg = api.DGFEM(device=device, settings=s, solve_direct=True)
            lvl = dg.levels[-1]
            A = lvl.op.to_dense().cpu().numpy()
            pts.append((n, float(spectral_radius_gs(A, lvl.N_DOF_sol_tot, which=which))))
        results[p] = pts

    outdir = outdir or _default_outdir("spectral_radius")
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"spectral_radius_{grid_kind}.json"), "w") as f:
        json.dump({str(p): pts for p, pts in results.items()}, f, indent=1)
    try:
        viz.plot_spectral_radius(
            results, outdir=outdir, name=f"spectral_radius_{grid_kind}_sigmamul{sigma_multiplier}")
    except ImportError:         # no matplotlib: the table alone, as dgtpu's
        pass
    return results


def run_figure_suite(p=3, outdir=None):
    """The basis and element figures in one call (the reference's manual
    figure scripts, visualization.py:174-401): standard element, 1D modal
    and nodal bases, the 2D modal basis surfaces, Lebesgue functions and
    constants, and the Runge comparison.  Returns the written paths."""
    outdir = outdir or _default_outdir("plots")
    paths = [
        viz.plot_standard_element(p, outdir=outdir),
        viz.plot_basis_1d(p, outdir=outdir),
        viz.plot_basis_nodal_1d(p, outdir=outdir),
        viz.plot_basis_2d(p, outdir=outdir),
        viz.plot_lebesgue(p, outdir=outdir),
        viz.plot_lebesgue_constant(max(p, 6), outdir=outdir),
        viz.plot_runge(max(p, 6), outdir=outdir),
    ]
    return [p_ for p_ in paths if p_ is not None]
