"""The port's Poisson routes end to end against dgtpu's runs of the same
settings, on the CPU at 4x4 p=2: ``-m`` in full precision (sequential and
red-black smoothing), ``-d``, ``-s`` and the mixed route through the rolled
cycle (geometric factors 4,2 coarsen to 1x1, an odd Ni).

Bars: L1/L2(u) within 1e-8 relative, the same number of cycles, sweeps or
outer rounds; the rolled route reproduces dgtpu's L2(u) for 4x4 p=2 with
factors 4,2.  Stokes outside the mixed multigrid route runs as dgtpu's
does, and stops where dgtpu's stops; ``-k``, ``-amg`` and ``-fvm`` run to
dgtpu's errors.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from dgtpu.api import DGFEM as JDGFEM
from dgtpu.settings import Settings as JSettings

import dgtpu_torch.api as tapi
from dgtpu_torch.__main__ import main
from dgtpu_torch.ops import vcycle
from dgtpu_torch.settings import Settings, load_params

torch.set_num_threads(1)
# dgtpu's L2(u) of the mixed route at 4x4 p=2 with geometric factors 4,2
# (its rolled cycle, 2 outer rounds), computed on a CPU
DGTPU_L2_4X4_P2_ROLLED = 6.951699755964379e-02


def _params(factors="2", precision="full", strategy="sequential"):
    params = load_params()
    params["grid"]["filename"] = "Rectangle_4X4_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["solution"]["u"]["polynomial degree"] = 2
    mg = params["solver"]["multigrid"]
    mg["polynomial coarsening"]["levels"]["u"] = "1,2"
    mg["geometric coarsening"]["coarsening factors"] = factors
    params["performance"]["precision"] = precision
    params["performance"]["smoother_parallelization"] = strategy
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    return params


def _both(tmp, params, **method):
    """(dgtpu DGFEM, port DGFEM), both solved with ``params``."""
    ref = JDGFEM(settings=JSettings(params), **method)
    ref.solve()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "OUTPUT_ROOT", str(tmp))
        port = tapi.DGFEM(device="cpu", settings=Settings(params), **method)
        port.solve()
    return ref, port


def _errors_match(ref, port):
    assert port.L1_error_u == pytest.approx(ref.L1_error_u, rel=1e-8)
    assert port.L2_error_u == pytest.approx(ref.L2_error_u, rel=1e-8)
    scale = np.abs(ref.u_nodal).max()
    assert np.abs(port.u_nodal - ref.u_nodal).max() / scale < 1e-8


@pytest.mark.parametrize("strategy", ["sequential", "redblack"])
def test_full_precision_multigrid_matches_dgtpu(tmp_path, strategy):
    ref, port = _both(tmp_path, _params(strategy=strategy), solve_multigrid=True)
    assert port.cycle_kind == "full precision"
    assert port.cycles == len(ref.residuals) - 1 == len(port.residuals) - 1
    assert np.allclose(port.residuals, ref.residuals, rtol=1e-7, atol=0)
    assert port.residuals[0] == 1.0
    assert port.solve_residual < float(port.settings.solver.multigrid.tolerance)
    _errors_match(ref, port)


def test_direct_matches_dgtpu(tmp_path):
    ref, port = _both(tmp_path, _params(), solve_direct=True)
    assert len(port.levels) == 1 and port.residual < 1e-12
    _errors_match(ref, port)
    assert "### solver=direct" in open(port.solution_summary_filepath).read()


def test_smoother_matches_dgtpu(tmp_path):
    ref, port = _both(tmp_path, _params(), solve_smoother=True,
                      smoother="block_gauss_seidel")
    assert port.smoother_status == 0
    assert port.sweeps == len(ref.residuals) == len(port.residuals)
    assert np.allclose(port.residuals, ref.residuals, rtol=1e-7, atol=0)
    _errors_match(ref, port)
    hist = os.listdir(tmp_path / "postprocessing" / "dgtpu_torch" / "relaxation")
    assert hist == ["residuals_Poisson_4X4_nPoly2_rectangle.npy"]


def test_rolled_mixed_route_matches_dgtpu(tmp_path):
    vcycle.reset_launch_counts()
    ref, port = _both(tmp_path, _params(factors="4,2", precision="mixed"),
                      solve_multigrid=True)
    assert [(l.Nj, l.Ni) for l in port.levels] == [(1, 1), (2, 2), (4, 4), (4, 4)]
    assert port.cycle_kind == "rolled" and port.cut is None
    assert port.outer_rounds == len(ref.residuals) - 1 == 2
    assert port.solve_residual < 1e-10
    assert port.L2_error_u == pytest.approx(DGTPU_L2_4X4_P2_ROLLED, rel=1e-8)
    _errors_match(ref, port)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert [k.launches for k in vcycle.KERNELS] == [0, 0, 0, 0]


def test_rolled_route_with_fmg_seed(tmp_path, monkeypatch):
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    params = _params(factors="4,2", precision="mixed")
    params["solver"]["multigrid"]["full multigrid"] = True
    port = tapi.DGFEM(device="cpu", settings=Settings(params), solve_multigrid=True)
    port.solve()
    assert port.cycle_kind == "rolled" and port.solve_residual < 1e-10
    assert port.L2_error_u == pytest.approx(DGTPU_L2_4X4_P2_ROLLED, rel=1e-8)


def test_even_hierarchy_stays_on_the_soa_cycle(tmp_path, monkeypatch):
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    port = tapi.DGFEM(device="cpu", settings=Settings(_params(precision="mixed")),
                      solve_multigrid=True)
    port.solve()
    assert port.cycle_kind == "SoA"


def _paramfile(tmp_path, params):
    path = tmp_path / "paramfile.yml"
    path.write_text(yaml.safe_dump(params))
    return str(path)


@pytest.mark.parametrize("argv, attr", [
    (["-m"], "cycles"), (["-d"], "residual"),
    (["-s", "--smoother", "block_gauss_seidel_rb"], "sweeps")])
def test_cli_entry_points(tmp_path, monkeypatch, argv, attr):
    """``-m`` without ``--precision`` (the paramfile's default is full), ``-d``
    and ``-s`` run for Poisson."""
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    dg = main(argv + ["--device", "cpu", "--silent", "--paramfile",
                      _paramfile(tmp_path, _params())])
    assert dg.settings.performance.precision == "full"
    assert hasattr(dg, attr)
    assert dg.L2_error_u == pytest.approx(6.9517e-02, rel=1e-4)
    assert f"L2 error={dg.L2_error_u}" in open(dg.solution_summary_filepath).read()


@pytest.mark.parametrize("method", ["solve_multigrid", "solve_direct", "solve_smoother"])
def test_stokes_outside_the_mixed_route_raises(tmp_path, monkeypatch, method):
    """Global-order Stokes (p_u=2/p_p=1) outside the mixed multigrid route,
    with the block-GS smoother (the test keeps the name it had while the
    port raised here): ``-d`` solves to dgtpu's L1/L2(u, v, p) within 1e-8;
    the multigrid and the stand-alone smoother stop with the AttributeError
    dgtpu stops with (a global-order saddle operator has no diagonal blocks;
    distributive GS is the Stokes smoother there)."""
    params = _params()
    params["problem"]["type"] = "Stokes"
    params["solution"]["ordering"] = "global"
    params["solution"]["p"]["polynomial degree"] = 1
    kw = {method: True, "smoother": "block_gauss_seidel"}
    if method != "solve_direct":
        with pytest.raises(AttributeError, match="diag_blocks"):
            JDGFEM(settings=JSettings(params), **kw).solve()
        monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
        with pytest.raises(AttributeError, match="diag_blocks"):
            tapi.DGFEM(device="cpu", settings=Settings(params), **kw).solve()
        return
    ref, port = _both(tmp_path, params, **kw)
    assert port.levels[-1].op.pin and port.residual < 1e-12
    for var in "uvp":
        for norm in ("L1", "L2"):
            name = f"{norm}_error_{var}"
            assert getattr(port, name) == pytest.approx(getattr(ref, name), rel=1e-8)


@pytest.mark.parametrize("method", ["solve_krylov", "solve_pyamg",
                                    "solve_finite_volume_method"])
def test_other_methods_raise(tmp_path, monkeypatch, method):
    """``-k`` (GMRES, block-diagonal preconditioner) and ``-amg`` (smoothed
    aggregation) run to dgtpu's L1/L2(u) within 1e-8, ``-fvm`` (a direct
    solve of the finite-volume system) to dgtpu's within 1e-10 (the test
    keeps the name it had while they raised)."""
    ref, port = _both(tmp_path, _params(), **{method: True})
    if method == "solve_finite_volume_method":
        assert port.levels[-1].discretization == "fvm" and port.residual < 1e-12
        assert port.L1_error_u == pytest.approx(ref.L1_error_u, rel=1e-10)
        assert port.L2_error_u == pytest.approx(ref.L2_error_u, rel=1e-10)
        return
    assert len(port.levels) == 1
    _errors_match(ref, port)
