"""The port's mixed-precision Stokes route end to end on the CPU, against
dgtpu: DGFEM Stokes assembly -> float32 SoA distributive-GS W-cycles inside
float64 defect correction (GMRES-wrapped when the plain refinement stalls)
-> pressure-mean shift -> L1/L2 errors of u, v and p -> summary.txt.

4x4 p_u=2/p_p=1 with the Stokes flagship settings
(``bench._stokes_settings(4)``).  The route converges to the same discrete
system as dgtpu's direct solve, so its errors are held to that solve's at
1e-6 relative (dgtpu's own mixed Stokes API route is too slow for this lane).
GMRES parity: the port's ``gmres_correction`` against dgtpu's in float64 on
the same matrices, at 1e-12.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import bench
from dgtpu.api import DGFEM as JDGFEM
from dgtpu.solvers.refinement import gmres_correction as j_gmres_correction

import dgtpu_torch.api as tapi
from dgtpu_torch.__main__ import main
from dgtpu_torch.ops.stokes_soa import SoAStokesVCycle
from dgtpu_torch.solvers.refinement import gmres_correction, make_refined_solver
from test_torch_stokes_assembly import port_settings

torch.set_num_threads(1)
ERR_TOL = 1e-6
ERRORS = [f"L{k}_error_{v}" for v in "uvp" for k in (1, 2)]


@pytest.fixture(scope="module")
def direct():
    s = bench._stokes_settings(4)
    s.solver.method = "direct"
    ref = JDGFEM(settings=s, solve_direct=True)
    ref.solve()
    return ref


def _route(tmp_path_factory, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "OUTPUT_ROOT", str(tmp_path_factory.mktemp("out")))
        for name, value in kw.items():
            mp.setattr(tapi, name, value)
        port = tapi.DGFEM(device="cpu", settings=port_settings(4),
                          solve_multigrid=True)
        port.solve()
    return port


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    return _route(tmp_path_factory)


def test_hierarchy(solved):
    assert solved.transfer_types == ["geometric", "polynomial"]
    assert [(l.Nj, l.Ni, l.P_sol) for l in solved.levels] == [
        (2, 2, {"u": 1, "p": 0}), (4, 4, {"u": 1, "p": 0}), (4, 4, {"u": 2, "p": 1})]


def test_route_matches_dgtpu_direct(solved, direct):
    assert solved.solve_residual < 1e-10
    assert solved.inner == "cycles" and solved.rounds["cycles"] <= 3
    for name in ERRORS:
        assert getattr(solved, name) == pytest.approx(getattr(direct, name),
                                                      rel=ERR_TOL), name


class _OverRelaxed(SoAStokesVCycle):
    """The route's cycle over-relaxed 1000-fold: the stand-alone iteration
    blows up (its error map I - 1000 M A has eigenvalues far outside the
    unit disk), while GMRES, invariant to the preconditioner's scale,
    converges with it."""

    def __call__(self, rhs, u):
        return u + 1000.0 * (super().__call__(rhs, u) - u.to(self.dtype))


def test_gmres_retry_after_stall(tmp_path_factory, direct):
    port = _route(tmp_path_factory, SoAStokesVCycle=_OverRelaxed)
    assert port.inner == "gmres"
    assert port.rounds["cycles"] >= 1 and port.rounds["gmres"] >= 1
    assert port.solve_residual < 1e-10
    for name in ERRORS:
        assert getattr(port, name) == pytest.approx(getattr(direct, name),
                                                    rel=ERR_TOL), name


def test_cli_writes_stokes_summary(tmp_path, monkeypatch):
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    params = bench._stokes_settings(4).to_dict()
    params["performance"]["precision"] = "mixed"
    params["visualization"]["export"] = True
    params["solver"]["multigrid"]["full_multigrid"] = True
    path = tmp_path / "stokes.yml"
    path.write_text(yaml.safe_dump(params))
    dg = main(["-m", "--precision", "mixed", "--device", "cpu", "--silent",
               "--paramfile", str(path)])
    assert dg.solve_residual < 1e-10
    summary = open(dg.solution_summary_filepath).read()
    assert dg.solution_summary_filepath.startswith(
        str(tmp_path / "results" / "Stokes" / "grid_Rectangle_4X4_nPoly2"))
    assert "### gamma=1.0" in summary
    assert "'p': 'sin(pi*x)*sin(pi*y)'" in summary
    for var, name in (("u", "u-velocity"), ("v", "v-velocity"), ("p", "pressure")):
        for k in (1, 2):
            assert f"L{k} error={getattr(dg, f'L{k}_error_{var}')} ({name})" in summary
    assert os.path.exists(dg.solution_visualization_filepath + ".vts")
    assert dg.solution_visualization_filepath.endswith("solution_Pu2_Pp1")
    hist = os.listdir(tmp_path / "postprocessing" / "dgtpu_torch" / "multigrid")
    assert len(hist) == 1 and hist[0].startswith("residuals_Stokes_4X4")
    assert not os.path.exists(tmp_path / "postprocessing" / "multigrid")


def test_gmres_correction_matches_dgtpu():
    rng = np.random.default_rng(11)
    n, m = 40, 8
    A = np.eye(n) * 4 + rng.standard_normal((n, n)) * 0.3
    Minv = np.linalg.inv(A + rng.standard_normal((n, n)) * 0.2)
    r = rng.standard_normal(n)
    ref = np.asarray(j_gmres_correction(lambda x: jnp.asarray(A) @ (jnp.asarray(Minv) @ x),
                                        lambda x: jnp.asarray(Minv) @ x,
                                        jnp.asarray(r), m))
    At, Mt = torch.as_tensor(A), torch.as_tensor(Minv)
    got = gmres_correction(lambda x: At @ (Mt @ x), lambda x: Mt @ x,
                           torch.as_tensor(r), m).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-12


class _Dense:
    def __init__(self, A):
        self.A = A

    def matvec(self, x):
        return self.A @ x


def test_refined_solver_inner_switch():
    """inner='gmres' converges where the stationary inner iteration
    diverges: an over-relaxed exact solve (omega=2.5) multiplies the error by
    1.5 per application, while GMRES with the same map as preconditioner
    solves in one step (the mechanism of the Stokes route's retry)."""
    rng = np.random.default_rng(2)
    n = 30
    A = torch.as_tensor(np.eye(n) * 3 + rng.standard_normal((n, n)) * 0.2)
    A32 = A.to(torch.float32)
    rhs = torch.as_tensor(rng.standard_normal(n))

    def bad_cycle(r32, u32):
        return u32 + 2.5 * torch.linalg.solve(A32, r32 - A32 @ u32)

    plain = make_refined_solver(_Dense(A), bad_cycle, n_inner=4, max_outer=8)
    _, res_plain, _, _ = plain(rhs, torch.zeros_like(rhs))
    assert not res_plain < 1e-10
    wrapped = make_refined_solver(_Dense(A), bad_cycle, n_inner=4, max_outer=8,
                                  inner="gmres", matvec32=lambda x: A32 @ x)
    _, res, n_outer, hist = wrapped(rhs, torch.zeros_like(rhs))
    assert res < 1e-10 and n_outer <= 6 and hist[-1] == res
    with pytest.raises(ValueError, match="matvec32"):
        make_refined_solver(_Dense(A), bad_cycle, inner="gmres")
    with pytest.raises(ValueError):
        make_refined_solver(_Dense(A), bad_cycle, inner="richardson")


def test_smoke_settings_are_dgtpus_stokes_flagship():
    """chip_smoke.py drives the port with dgtpu's Stokes flagship settings
    (bench._stokes_settings), written out as a paramfile tree."""
    import chip_smoke
    from dgtpu_torch.settings import Settings
    for n in (4, 8, 32):
        ours = Settings(chip_smoke.stokes_params(n))
        ours.solver.method = "multigrid"
        ours.update_setting("solver.discretization", "dg")
        theirs = bench._stokes_settings(n).to_dict()
        theirs["performance"]["precision"] = "mixed"
        assert ours.to_dict() == theirs, n
