"""CLI entry point — dgtpu's flag surface plus ``--device``.

    python -m dgtpu_torch -m [--precision full|mixed] [--device cuda|cpu] [options]
    python -m dgtpu_torch -d [--check-eigenvalues] [--check-condition-number]
    python -m dgtpu_torch -s --smoother block_gauss_seidel
    python -m dgtpu_torch -k
    python -m dgtpu_torch -amg
    python -m dgtpu_torch -fvm
    python -m dgtpu_torch -amp --dg-discretization|--fvm-discretization
    python -m dgtpu_torch -m --shards 4 [--precision mixed]
    python -m dgtpu_torch -m --profile DIR

Ported for Poisson and Stokes (``problem.type: Stokes`` in the paramfile,
local or global ordering): the multigrid in full precision (the
paramfile's default) and in mixed precision, with FVM coarse levels
(``geometric coarsening: use FVM``), the direct solve, the stand-alone
smoother solve (``--smoother distributive_gauss_seidel`` for global-order
Stokes), the Krylov solve, algebraic multigrid, the finite-volume solve and
the smoother amplification analysis; the paramfile's check switches, the
physical-element orthonormal basis and operator caching.  ``--shards N``
runs the multigrid over N element-row bands (on the card shard k sits on
card k modulo the visible cards); ``--profile DIR`` writes a
``torch.profiler`` Chrome trace of the solve into DIR.
``--plot-sparsity-pattern`` sets the setting and solves, as dgtpu's route
does (no route of either package draws that plot).
"""

import argparse
import os
import sys
import traceback


class MutuallyInclusiveArgumentError(Exception):
    pass


class MutuallyExclusiveArgumentError(Exception):
    pass


def build_parser():
    parser = argparse.ArgumentParser(
        prog="DG solver (dgtpu_torch)",
        description="PyTorch/CUDA DG solver for the Poisson and Stokes "
                    "problems")
    parser.add_argument("--grid-folder", type=str)
    parser.add_argument("-f", "--grid-file", type=str)
    parser.add_argument("--p-grid", type=int)
    parser.add_argument("--p-solution", type=int)

    solver = parser.add_mutually_exclusive_group(required=True)
    solver.add_argument("-d", "--solve-direct", action="store_true")
    solver.add_argument("-s", "--solve-smoother",
                        help="mutually inclusive with --smoother", action="store_true")
    parser.add_argument("--smoother", type=str)

    solver.add_argument("-amg", "--solve-pyamg", action="store_true")
    solver.add_argument("-k", "--solve-krylov", action="store_true")
    solver.add_argument("-m", "--solve-multigrid", action="store_true")
    solver.add_argument("-fvm", "--solve-finite-volume-method", action="store_true")

    solver.add_argument("-amp", "--solve-smoother-amplification",
                        help="mutually inclusive with --fvm-discretization or "
                             "--dg-discretization", action="store_true")
    parser.add_argument("--dg-discretization", action="store_true")
    parser.add_argument("--fvm-discretization", action="store_true")

    parser.add_argument("--check-eigenvalues", action="store_true")
    parser.add_argument("--check-condition-number", action="store_true")
    parser.add_argument("--plot-sparsity-pattern", action="store_true")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--silent", action="store_true")
    parser.add_argument("--shards", type=int, default=None,
                        help="shard the MULTIGRID solve over N element-row "
                             "bands (one card may hold several; ignored with "
                             "a warning for other solvers)")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="write a torch.profiler Chrome trace of the solve "
                             "into DIR (chrome://tracing or Perfetto)")
    parser.add_argument("--paramfile", type=str, help="alternate paramfile.yml")
    parser.add_argument("--precision", type=str, default=None,
                        choices=("full", "mixed"),
                        help="multigrid precision: full (float64 cycles) or "
                             "mixed (float32 cycles of CUDA kernels + float64 "
                             "defect refinement); default: the paramfile's")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the solve (default cuda; a CPU "
                             "run needs --device cpu)")
    return parser


def profile_solve(dgfem, outdir):
    """``dgfem.solve()`` under ``torch.profiler`` (CPU activity, and CUDA
    activity on the card); the Chrome trace goes to ``outdir/trace.json``,
    whose path is returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if dgfem.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        dgfem.solve()
        if dgfem.device.type == "cuda":
            torch.cuda.synchronize()
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.solve_smoother and not args.smoother:
        raise MutuallyInclusiveArgumentError(
            "--solve-smoother option must be used with --smoother")

    discretization = None
    if args.solve_smoother_amplification:
        if not (args.dg_discretization or args.fvm_discretization):
            raise MutuallyInclusiveArgumentError(
                "--solve-smoother-amplification option must be used with either "
                "--dg-discretization or --fvm-discretization")
        if args.dg_discretization and args.fvm_discretization:
            raise MutuallyExclusiveArgumentError(
                "--dg-discretization cannot be used together with --fvm-discretization")
        discretization = "dg" if args.dg_discretization else "fvm"

    from dgtpu_torch.settings import Settings, load_params
    settings = Settings(load_params(args.paramfile))
    if args.verbose:
        settings.update_setting("logging.loglevel", "DEBUG")
    if args.silent:
        settings.update_setting("logging.loglevel", "ERROR")

    from dgtpu_torch.api import DGFEM
    from dgtpu_torch.utils.logger import Logger
    logger = Logger(__name__, settings).logger
    logger.info("starting DG-FEM (dgtpu_torch)")

    try:
        dgfem = DGFEM(device=args.device, settings=settings,
                      grid_folder=args.grid_folder,
                      grid_file=args.grid_file, p_grid=args.p_grid,
                      p_solution=args.p_solution,
                      solve_direct=args.solve_direct,
                      solve_smoother=args.solve_smoother,
                      solve_smoother_amplification=args.solve_smoother_amplification,
                      solve_pyamg=args.solve_pyamg,
                      solve_krylov=args.solve_krylov,
                      solve_multigrid=args.solve_multigrid,
                      solve_finite_volume_method=args.solve_finite_volume_method,
                      smoother=args.smoother, shards=args.shards,
                      precision=args.precision,
                      discretization=discretization,
                      check_eigenvalues=args.check_eigenvalues,
                      check_condition_number=args.check_condition_number,
                      plot_sparsity_pattern=args.plot_sparsity_pattern)
        if args.profile:
            path = profile_solve(dgfem, args.profile)
            logger.info(f"profiler trace written to {path}")
        else:
            dgfem.solve()
        return dgfem
    except Exception:
        logger.critical(traceback.format_exc())
        sys.exit(1)


if __name__ == "__main__":
    main()
