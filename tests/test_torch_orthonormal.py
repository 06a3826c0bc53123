"""The port's physical-element orthonormal basis
(``problem.orthonormal on physical element``) against dgtpu's, on the CPU:
the Gram-Schmidt weights and norms, the Poisson and Stokes blocks assembled
in that basis (on the curvilinear O-grid, where the transform differs from
element to element), dgtpu's basis-invariance cases
(``tests/test_orthonormal_basis.py``) run on the port, the weights carried
across by ``convert``, and the mixed route's SoA cycle on these blocks.

Bars: weights, norms and blocks within 1e-12 of dgtpu's; dgtpu's own bars
for the invariance cases; the mixed route's L2(u) within 1e-6 of the
standard basis's.
"""

import os

import numpy as np
import pytest
import torch

from dgtpu.geometry import Geometry as JGeometry
from dgtpu.level import GridLevel as JGridLevel
from dgtpu.mms import ManufacturedSolution as JMMS
from dgtpu.models.poisson import assemble_poisson as j_assemble_poisson
from dgtpu.models.stokes import assemble_stokes as j_assemble_stokes
from dgtpu.ops.orthonormal import gram_schmidt_weights as j_gram_schmidt
from dgtpu.settings import Settings as JSettings

import dgtpu_torch.api as tapi
from dgtpu_torch.convert import element_basis_from_arrays
from dgtpu_torch.geometry import Geometry
from dgtpu_torch.level import GridLevel
from dgtpu_torch.mms import ManufacturedSolution
from dgtpu_torch.models.poisson import assemble_poisson, mass_matrices
from dgtpu_torch.models.stokes import assemble_stokes
from dgtpu_torch.ops.orthonormal import gram_schmidt_weights
from dgtpu_torch.settings import Settings, load_params
from tests.conftest import INPUT_DIR

torch.set_num_threads(1)
CIRCLE = "CircleInCircle_4X4_nPoly2.xyz"


def _params(ortho, grid="Rectangle_4X4_nPoly1.xyz", p_grid=1, p_sol=2, circ=False,
            stokes=False):
    params = load_params()
    params["grid"]["filename"] = grid
    params["grid"]["polynomial degree"] = p_grid
    params["grid"]["O grid"] = circ
    params["grid"]["circular"] = circ
    if circ:
        params["problem"]["SIP penalty parameter multiplier"] = 2
    params["problem"]["orthonormal on physical element"] = ortho
    params["solution"]["u"]["polynomial degree"] = p_sol
    if stokes:
        params["problem"]["type"] = "Stokes"
        params["solution"]["u"]["polynomial degree"] = 2
        params["solution"]["p"]["polynomial degree"] = 1
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    return params


def _run(tmp, params):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "OUTPUT_ROOT", str(tmp))
        dg = tapi.DGFEM(device="cpu", settings=Settings(params), solve_direct=True)
        dg.solve()
    return dg


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _levels(params, vars_, p_sol):
    js, ts = JSettings(params), Settings(params)
    path = os.path.join(INPUT_DIR, params["grid"]["filename"])
    return (JGridLevel(JGeometry(path, js), js, vars_, p_sol),
            GridLevel(Geometry(path, ts), ts, vars_, p_sol))


def test_gram_schmidt_weights_match_dgtpu():
    rng = np.random.default_rng(0)
    V = rng.standard_normal((16, 9))
    wJ = rng.random((7, 16)) + 0.1
    w, n = gram_schmidt_weights(V, wJ)
    jw, jn = j_gram_schmidt(V, wJ)
    assert _rel(w, jw) < 1e-12 and _rel(n, jn) < 1e-12


def test_poisson_blocks_match_dgtpu():
    """The curvilinear O-grid's Poisson operator, right-hand side and
    inverse mass matrices in the orthonormal basis, and the per-element
    weights and norms."""
    jl, tl = _levels(_params(True, CIRCLE, 2, 3, circ=True), ["u"], {"u": 3})
    U = "sin(pi*x)*sin(pi*y)"
    jop, jrhs, jinv = j_assemble_poisson(jl, JMMS({"u": U}, "Poisson", 1.0))
    top, trhs, tinv = assemble_poisson(tl, ManufacturedSolution({"u": U}, "Poisson", 1.0))
    for a, b in ((tl.element_basis["u"].weights, jl.element_basis["u"].weights),
                 (tl.element_basis["u"].norms, jl.element_basis["u"].norms),
                 (top.blocks, jop.blocks), (trhs, jrhs), (tinv, jinv)):
        assert _rel(a.numpy(), b) < 1e-12


def test_stokes_blocks_match_dgtpu():
    """The global-order Stokes A, D and G stencils and right-hand side on the
    O-grid, both variables in their own orthonormal bases."""
    params = _params(True, CIRCLE, 2, circ=True, stokes=True)
    params["solution"]["ordering"] = "global"
    jl, tl = _levels(params, ["u", "p"], {"u": 2, "p": 1})
    exact = {"u": "-y*(x**2 + y**2 - 1)", "v": "x*(x**2 + y**2 - 1)", "p": "x*y"}
    j_assemble_stokes(jl, JMMS(exact, "Stokes", 1.0))
    assemble_stokes(tl, ManufacturedSolution(exact, "Stokes", 1.0))
    assert set(tl.element_basis) == {"u", "p"}
    for c in ("block_A", "block_D", "block_G"):
        assert _rel(getattr(tl, c).blocks.numpy(), getattr(jl, c).blocks) < 1e-12
    assert _rel(tl.rhs.numpy(), jl.rhs) < 1e-12


def test_solution_invariant_under_basis_change_curvilinear(tmp_path):
    """Same approximation space => the same nodal solution and errors."""
    a = _run(tmp_path, _params(False, CIRCLE, 2, circ=True))
    b = _run(tmp_path, _params(True, CIRCLE, 2, circ=True))
    assert np.isclose(a.L2_error_u, b.L2_error_u, rtol=1e-10)
    assert np.abs(a.u_nodal - b.u_nodal).max() < 1e-9


def test_mass_matrix_near_identity_on_affine(tmp_path):
    """On affine elements the transform is an exact orthonormalization."""
    M = mass_matrices(_run(tmp_path, _params(True)).levels[-1]).numpy()
    assert np.abs(M - np.eye(M.shape[1])).max() < 1e-12


def test_polynomial_exactness_with_ortho_basis(tmp_path):
    params = _params(True)
    params["problem"]["exact solution"] = {"u": "x**2 + y**2", "tag": "quad"}
    assert _run(tmp_path, params).L2_error_u < 1e-11


@pytest.mark.parametrize("grid, p_grid, circ, rtol", [
    ("Rectangle_4X4_nPoly2.xyz", 2, False, (1e-9, 1e-9, 1e-7)),
    (CIRCLE, 2, True, (1e-8, 1e-8, 1e-6))])
def test_stokes_solution_invariant_under_basis_change(tmp_path, grid, p_grid, circ, rtol):
    """Stokes, u and p each in its own basis (the reference's transform is
    u-only): the same errors, on a rectangle and on the O-grid."""
    a = _run(tmp_path, _params(False, grid, p_grid, circ=circ, stokes=True))
    b = _run(tmp_path, _params(True, grid, p_grid, circ=circ, stokes=True))
    for var, tol in zip("uvp", rtol):
        assert np.isclose(getattr(a, f"L2_error_{var}"), getattr(b, f"L2_error_{var}"),
                          rtol=tol), var


def test_stokes_mass_matrices_near_identity(tmp_path):
    lvl = _run(tmp_path, _params(True, "Rectangle_4X4_nPoly2.xyz", 2, stokes=True)).levels[-1]
    for var in ("u", "p"):
        M = mass_matrices(lvl, var=var).numpy()
        assert np.abs(M - np.eye(M.shape[1])).max() < 1e-12, var


def test_weights_carry_across(tmp_path):
    """dgtpu's weights and norms carried in by ``convert`` transform a table
    as the port's own basis does."""
    jl, tl = _levels(_params(True, CIRCLE, 2, 2, circ=True), ["u"], {"u": 2})
    from dgtpu.ops.orthonormal import ElementBasis as JElementBasis
    from dgtpu_torch.ops.orthonormal import ElementBasis
    jb = JElementBasis(jl)
    carried = element_basis_from_arrays(tl, {"weights": np.asarray(jb.weights),
                                             "norms": np.asarray(jb.norms)})
    table = tl.quad.V_sol_grid["u"]
    assert _rel(carried.apply(table).numpy(), ElementBasis(tl).apply(table).numpy()) < 1e-12


def test_mixed_route_runs_the_soa_cycle_on_the_basis(tmp_path, monkeypatch):
    """``-m --precision mixed`` with the orthonormal basis smooths its blocks
    in the SoA cycle; L2(u) within 1e-6 of the standard basis's route."""
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    runs = []
    for ortho in (False, True):
        params = _params(ortho, "Rectangle_4X4_nPoly2.xyz", 2, 2)
        params["solver"]["multigrid"]["polynomial coarsening"]["levels"]["u"] = "1,2"
        params["performance"]["precision"] = "mixed"
        dg = tapi.DGFEM(device="cpu", settings=Settings(params), solve_multigrid=True)
        dg.solve()
        runs.append(dg)
    std, ortho = runs
    assert ortho.cycle_kind == "SoA" and ortho.solve_residual < 1e-10
    assert ortho.levels[-1].element_basis is not None
    assert ortho.L2_error_u == pytest.approx(std.L2_error_u, rel=1e-6)
