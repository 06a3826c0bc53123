"""The port's mixed-precision Poisson route end to end against dgtpu's, on
the CPU: DGFEM assembly -> float32 SoA cycles inside float64 defect
correction -> L1/L2 MMS errors -> summary.txt.

8x8 p=2 (p 2->1 plus one geometric level): L1/L2(u) agree to 1e-6
relative and the outer-round counts differ by at most one (the port's
defect is native float64, dgtpu's the df32 compensated one).
"""

import os

import numpy as np
import pytest
import torch
import yaml

import __graft_entry__

import dgtpu_torch.api as tapi
from dgtpu_torch.__main__ import build_parser, main
from dgtpu_torch.settings import Settings, load_params
from dgtpu_torch.utils import caching

torch.set_num_threads(1)


def _port_params(grid, p, levels):
    params = load_params()
    params["grid"]["filename"] = grid
    params["grid"]["polynomial degree"] = p
    params["solution"]["u"]["polynomial degree"] = p
    params["solver"]["multigrid"]["polynomial coarsening"]["levels"]["u"] = levels
    params["performance"]["precision"] = "mixed"
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    return params


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    ref = __graft_entry__._flagship(n=8, p_grid=2, p_sol=2)
    ref.settings.performance.precision = "mixed"
    ref.solve()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "OUTPUT_ROOT", str(tmp_path_factory.mktemp("out")))
        port = tapi.DGFEM(device="cpu", solve_multigrid=True, settings=Settings(
            _port_params("Rectangle_8X8_nPoly2.xyz", 2, "1,2")))
        port.solve()
    return ref, port


def test_hierarchy_matches(solved):
    ref, port = solved
    assert port.transfer_types == ref.transfer_types
    assert [(l.Nj, l.Ni, l.P_sol["u"]) for l in port.levels] == \
        [(l.Nj, l.Ni, l.P_sol["u"]) for l in ref.levels]


def test_errors_match_dgtpu(solved):
    ref, port = solved
    assert port.L1_error_u == pytest.approx(ref.L1_error_u, rel=1e-6)
    assert port.L2_error_u == pytest.approx(ref.L2_error_u, rel=1e-6)


def test_outer_rounds_within_one(solved):
    ref, port = solved
    assert abs(port.outer_rounds - (len(ref.residuals) - 1)) <= 1
    assert port.solve_residual < 1e-10
    assert port.residuals[0] == 1.0 and port.residuals[-1] == port.solve_residual


def test_nodal_solution_matches(solved):
    ref, port = solved
    scale = np.abs(ref.u_nodal).max()
    assert np.abs(port.u_nodal - ref.u_nodal).max() / scale < 1e-8


def _paramfile(tmp_path, **overrides):
    params = _port_params("Rectangle_4X4_nPoly2.xyz", 2, "1,2")
    params["visualization"]["export"] = True
    params["solver"]["multigrid"]["full multigrid"] = True
    for path, value in overrides.items():
        node = params
        *keys, leaf = path.split(".")
        for k in keys:
            node = node[k]
        node[leaf] = value
    path = tmp_path / "paramfile.yml"
    path.write_text(yaml.safe_dump(params))
    return str(path)


def test_cli_writes_summary(tmp_path, monkeypatch):
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    dg = main(["-m", "--precision", "mixed", "--device", "cpu", "--silent",
               "--paramfile", _paramfile(tmp_path)])
    assert dg.solve_residual < 1e-10
    summary = open(dg.solution_summary_filepath).read()
    assert dg.solution_summary_filepath.startswith(str(tmp_path))
    assert "### grid=Rectangle_4X4_nPoly2" in summary
    assert f"L2 error={dg.L2_error_u}" in summary
    assert os.path.exists(dg.solution_visualization_filepath + ".vts")
    hist = os.listdir(tmp_path / "postprocessing" / "dgtpu_torch" / "multigrid")
    assert len(hist) == 1 and hist[0].endswith("_rectangle.npy")


def test_residual_history_leaves_dgtpus_directory(tmp_path, monkeypatch):
    """The port writes its residual histories under its own directory, so a
    port run beside dgtpu never adds a file to dgtpu's
    ``postprocessing/multigrid`` (which dgtpu's own tests read)."""
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    dgtpu_dir = tmp_path / "postprocessing" / "multigrid"
    dgtpu_dir.mkdir(parents=True)
    (dgtpu_dir / "residuals_Poisson_4X4_nPoly2_polynomial_rectangle.npy").write_bytes(b"")
    before = sorted(os.listdir(dgtpu_dir))
    main(["-m", "--precision", "mixed", "--device", "cpu", "--silent",
          "--paramfile", _paramfile(tmp_path, **{"visualization.export": False})])
    assert sorted(os.listdir(dgtpu_dir)) == before
    port_dir = tmp_path / "postprocessing" / "dgtpu_torch" / "multigrid"
    assert [f.startswith("residuals_Poisson_4X4") for f in os.listdir(port_dir)] == [True]


@pytest.mark.parametrize("override, item", [
    ({"performance.n_shards": 2}, "Multi-GPU"),
    ({"solver.multigrid.geometric coarsening.use FVM": True}, "The other solver routes"),
    ({"caching.enabled": True}, "Operator caching"),
    ({"problem.check eigenvalues": True}, "The other solver routes"),
    ({"problem.check condition number": True}, "The other solver routes"),
    ({"problem.orthonormal on physical element": True},
     "The physical-element orthonormal basis"),
    ({"visualization.plot sparsity pattern": True}, "I/O and tools"),
    ({"visualization.automatically open paraview": True}, "I/O and tools"),
])
def test_unported_branches_raise(tmp_path, monkeypatch, override, item):
    """The branches that raised until the port had them (sharding, an FVM
    coarse level, caching, the check flags, the physical-element
    orthonormal basis, the sparsity switch, ParaView; the test keeps its
    name and cases) run as dgtpu's DGFEM runs the same parameters: L2(u)
    within 1e-6 relative (the mixed route stays mixed, sharded over 2 shards
    with ``n_shards: 2``, the FVM level falls back to full precision), the
    check flags' results within 1e-8; the sparsity switch draws no plot in
    either package; ParaView is started with the same argv apart from each
    package's output root."""
    import subprocess
    from dgtpu.api import DGFEM as JDGFEM
    from dgtpu.settings import Settings as JSettings
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    monkeypatch.setattr(caching, "CACHE_ROOT", str(tmp_path / "cache"))
    params = yaml.safe_load(open(_paramfile(tmp_path, **override)))
    params["visualization"]["export"] = False
    key = next(iter(override))
    launched = []
    if "paraview" in key:
        params["visualization"]["paraview executable path"] = "ParaView/bin/paraview"
        monkeypatch.setattr(subprocess, "Popen", lambda argv: launched.append(argv))
    plots_before = _sparsity_plots(tmp_path)
    ref = JDGFEM(settings=JSettings(yaml.safe_load(yaml.safe_dump(params))),
                 solve_multigrid=True)
    ref.solve()
    port = tapi.DGFEM(device="cpu", settings=Settings(params), solve_multigrid=True)
    port.solve()
    assert port.L2_error_u == pytest.approx(ref.L2_error_u, rel=1e-6)
    fvm = "use FVM" in key
    assert port.cycle_kind == ("full precision" if fvm else "sharded mixed"
                               if item == "Multi-GPU" else "SoA")
    assert [l.discretization for l in port.levels] == \
        [l.discretization for l in ref.levels]
    if "check" in key:
        assert port.diagnostics.keys() == ref.diagnostics.keys() != set()
        for name, value in ref.diagnostics.items():
            assert port.diagnostics[name] == pytest.approx(value, rel=1e-8)
    if item == "Multi-GPU":
        assert port.mesh.size == 2 and port.solve_residual < 1e-10
    if "sparsity" in key:
        assert port.settings.visualization.plot_sparsity_pattern
        assert _sparsity_plots(tmp_path) == plots_before
    if "paraview" in key:
        (j_argv, t_argv), roots = launched, (tapi.REPO_ROOT, str(tmp_path))
        assert [j_argv[0], os.path.relpath(j_argv[1], roots[0])] == \
            [t_argv[0], os.path.relpath(t_argv[1], roots[1])]
        assert t_argv[1] == port.solution_visualization_filepath + ".vts"


def _sparsity_plots(out):
    """Every sparsity plot below the port's output root ``out`` and below the
    repository's and the working directory's ``postprocessing`` (dgtpu's
    plots default to ``postprocessing/plots``)."""
    roots = (out, os.path.join(tapi.REPO_ROOT, "postprocessing"),
             os.path.join(os.getcwd(), "postprocessing"))
    return sorted(os.path.join(d, f) for root in roots for d, _, files in os.walk(root)
                  for f in files if f.startswith("sparsity"))


@pytest.mark.parametrize("override, error, match", [
    # full-precision Stokes with the paramfile's block-GS smoothers: the
    # saddle operator has no diagonal blocks
    ({"performance.precision": "full", "problem.type": "Stokes",
      "solution.ordering": "global"}, AttributeError, "diag_blocks"),
    # Stokes multigrid needs global ordering: the settings' own check
    ({"problem.type": "Stokes", "solution.ordering": "local"}, AssertionError,
     'assert settings.solution.ordering == "global"'),
    # mixed precision with block-GS smoothers: no Stokes cycle builds, so the
    # route runs full precision, which stops as above
    ({"problem.type": "Stokes", "solution.ordering": "global"}, AttributeError,
     "diag_blocks"),
])
def test_stokes_branches_stop_where_dgtpu_does(tmp_path, monkeypatch, override,
                                               error, match):
    """The Stokes multigrid configurations that raised NotImplementedError
    before this slice ported them now run dgtpu's path, and stop where
    dgtpu's DGFEM stops on the same parameters: the same error type, with
    the same message, or for an AssertionError the same failing statement
    of ``Settings._validate_settings``."""
    from dgtpu.api import DGFEM as JDGFEM
    from dgtpu.settings import Settings as JSettings
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    params = yaml.safe_load(open(_paramfile(tmp_path, **override)))
    params["visualization"]["export"] = False
    for dgfem, settings in ((JDGFEM, JSettings), (tapi.DGFEM, Settings)):
        kwargs = {"device": "cpu"} if dgfem is tapi.DGFEM else {}
        with pytest.raises(error) as exc:
            dgfem(settings=settings(yaml.safe_load(yaml.safe_dump(params))),
                  solve_multigrid=True, **kwargs).solve()
        if error is AssertionError:
            last = exc.traceback[-1]
            assert last.name == "_validate_settings"
            assert str(last.statement).strip() == match
        else:
            assert match in str(exc.value)


def test_other_solver_routes_raise(tmp_path, monkeypatch):
    """``-k`` and ``-fvm`` run, through the constructor and the CLI (the test
    keeps the name it had while they raised)."""
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    dg = tapi.DGFEM(device="cpu", paramfile=_paramfile(tmp_path), solve_krylov=True)
    dg.solve()
    cli = main(["-k", "--device", "cpu", "--silent", "--paramfile", _paramfile(tmp_path)])
    assert cli.L2_error_u == dg.L2_error_u
    assert cli.krylov_iterations == dg.krylov_iterations >= 1
    dg = tapi.DGFEM(device="cpu", paramfile=_paramfile(tmp_path),
                    solve_finite_volume_method=True)
    dg.solve()
    cli = main(["-fvm", "--device", "cpu", "--silent", "--paramfile", _paramfile(tmp_path)])
    assert cli.levels[-1].discretization == "fvm" and cli.residual < 1e-12
    assert cli.L2_error_u == dg.L2_error_u < 1.0


def test_device_is_explicit(tmp_path, monkeypatch):
    assert build_parser().parse_args(["-m"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.DGFEM(paramfile=_paramfile(tmp_path), solve_multigrid=True)
