"""dgtpu_torch's distributive Gauss-Seidel (DGS) smoothers and the Stokes
multigrid in full precision against dgtpu's, on the CPU in float64.

* One sweep of each DGS variant (``lsq`` = ``StencilDGS``, ``lsq_dense``,
  ``classical``, ``classical_exact``) on dgtpu's 4x4 p_u=2/p_p=1
  global-order level carried across by ``convert.py``, from the same
  numpy-seeded iterate: < 1e-11 relative.
* ``distributive_gauss_seidel_solve``: the same sweep count, status and
  residual history as dgtpu's; ``classical`` diverges (status 2) as dgtpu's
  test documents (``tests/test_stokes.py:94``).
* The full-precision Stokes multigrid with penalty, polynomial and
  geometric hierarchies (dgtpu's ``tests/test_stokes.py:171,203,337``, the
  geometric one on the 2x2 grid down to a 1x1 level): the same cycle
  counts, L1/L2 (u, v, p) within 1e-8.  The geometric hierarchy has an odd Ni, so no
  Stokes SoA cycle builds there: with ``precision: mixed`` both packages
  log the fallback and run the full-precision multigrid.
* ``-s`` with distributive GS: the same sweeps, L1/L2 within 1e-8.
* Where dgtpu raises, the port raises the same: DGS on a local-order level,
  the block-GS smoother on a saddle operator.
"""

import copy
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dgtpu.api import DGFEM as JDGFEM
from dgtpu.models import stokes as jstokes
from dgtpu.settings import Settings as JSettings

import dgtpu_torch.api as tapi
from dgtpu_torch.convert import StokesLevel, stencil_from_arrays
from dgtpu_torch.models import stokes as tstokes
from dgtpu_torch.settings import Settings, load_params

torch.set_num_threads(1)
SWEEP_TOL = 1e-11


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _fields(op):
    return dict(blocks=np.asarray(op.blocks), nbr=np.asarray(op.nbr),
                mask=np.asarray(op.mask))


def _stokes_params(ordering="global", precision="full", splitting="lsq"):
    params = chip_smoke.stokes_params(4)
    params["solution"]["ordering"] = ordering
    params["performance"]["precision"] = precision
    params["performance"]["dgs_splitting"] = splitting
    return params


@pytest.fixture(scope="module")
def dgs_ref():
    """dgtpu's DGFEM for ``-s`` with distributive GS on the 4x4 global-order
    Stokes level (a single level)."""
    return JDGFEM(settings=JSettings(_stokes_params()), solve_smoother=True,
                  smoother="distributive_gauss_seidel")


@pytest.fixture(scope="module")
def levels(dgs_ref):
    """dgtpu's level of ``dgs_ref`` and the port's StokesLevel on the same
    numbers, with its rhs."""
    j = dgs_ref.levels[-1]
    t = StokesLevel(j.Nj, j.Ni, j.P_sol["u"], j.P_sol["p"],
                    *(stencil_from_arrays(_fields(getattr(j, f"block_{c}")))
                      for c in "ADG"))
    t.rhs = torch.as_tensor(np.array(j.rhs))
    return j, t


@pytest.mark.parametrize("splitting, cls", [
    ("lsq", tstokes.StencilDGS), ("lsq_dense", tstokes.DistributiveGS),
    ("classical", tstokes.DistributiveGS), ("classical_exact", tstokes.DistributiveGS)])
def test_one_sweep_matches_dgtpu(levels, splitting, cls):
    j, t = levels
    x0 = np.random.default_rng(5).standard_normal(j.rhs.shape)
    ref = jstokes.make_dgs(j, splitting).sweep(j.rhs, jnp.asarray(x0))
    dgs = tstokes.make_dgs(t, splitting)
    assert type(dgs) is cls
    got = dgs.sweep(t.rhs, torch.as_tensor(x0))
    assert _rel(got, ref) < SWEEP_TOL


@pytest.mark.parametrize("splitting, max_iterations, status", [
    ("lsq", 1000, 0), ("classical", 500, 2), ("classical_exact", 3000, 0)])
def test_dgs_solve_matches_dgtpu(levels, splitting, max_iterations, status):
    j, t = levels
    u_ref, h_ref, n_ref, s_ref = jstokes.distributive_gauss_seidel_solve(
        j, j.rhs, splitting=splitting, max_iterations=max_iterations)
    u, hist, n, s = tstokes.distributive_gauss_seidel_solve(
        t, t.rhs, splitting=splitting, max_iterations=max_iterations)
    assert (n, s) == (int(n_ref), int(s_ref)) and s == status
    h_ref = np.asarray(h_ref)
    assert hist.shape == h_ref.shape and np.isnan(hist[n:]).all()
    if status == 0:
        assert np.allclose(hist[:n], h_ref[:n], rtol=1e-7, atol=0)
        assert _rel(u, u_ref) < 1e-8
    else:
        # diverging: the growth agrees while the iterate is still finite
        assert np.allclose(hist[:n // 2], h_ref[:n // 2], rtol=1e-6, atol=0)


def test_dgs_needs_the_global_order_assembly(levels):
    j, t = levels
    local = copy.copy(t)
    local.block_A = None
    j_local = copy.copy(j)
    j_local.block_A = None
    match = "Distributive GS needs a global-order Stokes assembly"
    for splitting in ("lsq", "classical_exact"):
        with pytest.raises(ValueError, match=match):
            jstokes.make_dgs(j_local, splitting)
        with pytest.raises(ValueError, match=match):
            tstokes.make_dgs(local, splitting)


def _route(tmp, params, **method):
    """(dgtpu DGFEM, port DGFEM), both solved with ``params``."""
    ref = JDGFEM(settings=JSettings(copy.deepcopy(params)), **method)
    ref.solve()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "OUTPUT_ROOT", str(tmp))
        port = tapi.DGFEM(device="cpu", settings=Settings(copy.deepcopy(params)),
                          **method)
        port.solve()
    return ref, port


def _errors_match(ref, port):
    for var in "uvp":
        for norm in ("L1", "L2"):
            name = f"{norm}_error_{var}"
            assert getattr(port, name) == pytest.approx(getattr(ref, name), rel=1e-8)


def test_smoother_route_matches_dgtpu(tmp_path, dgs_ref):
    ref = dgs_ref
    ref.solve()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
        port = tapi.DGFEM(device="cpu", settings=Settings(_stokes_params()),
                          solve_smoother=True, smoother="distributive_gauss_seidel")
        port.solve()
    assert port.smoother_status == 0
    assert port.sweeps == len(ref.residuals) == len(port.residuals)
    assert np.allclose(port.residuals, ref.residuals, rtol=1e-7, atol=0)
    _errors_match(ref, port)


def _dgtpu_test_params(hierarchy):
    """dgtpu's Stokes multigrid test settings (tests/test_stokes.py:171,
    203): penalty multipliers 2,1 with the paramfile's DGS smoothers, or
    p_u 3 -> 2 (p derived 2 -> 1); direct coarse solve, the paramfile's
    splitting (classical_exact)."""
    params = load_params()
    params["problem"]["type"] = "Stokes"
    params["grid"]["filename"] = "Rectangle_4X4_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["solution"]["u"]["polynomial degree"] = 2
    params["solution"]["p"]["polynomial degree"] = 1
    params["solution"]["ordering"] = "global"
    mg = params["solver"]["multigrid"]
    mg["polynomial coarsening"]["enabled"] = hierarchy == "polynomial"
    mg["geometric coarsening"]["enabled"] = False
    mg["coarse grid solver"] = "direct"
    if hierarchy == "penalty":
        params["problem"]["SIP penalty parameter multiplier"] = 2
        mg["penalty parameter coarsening"]["enabled"] = True
        mg["penalty parameter coarsening"]["multipliers"] = "2,1"
    else:
        params["solution"]["u"]["polynomial degree"] = 3
        params["solution"]["p"]["polynomial degree"] = 2
        mg["polynomial coarsening"]["levels"]["u"] = "2,3"
        for side in ("pre smoother", "post smoother"):
            mg["polynomial coarsening"][side]["smoother"] = "distributive_gauss_seidel"
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    return params


@pytest.mark.parametrize("hierarchy", ["penalty", "polynomial"])
def test_full_precision_multigrid_matches_dgtpu(tmp_path, hierarchy):
    params = _dgtpu_test_params(hierarchy)
    ref, port = _route(tmp_path, params, solve_multigrid=True)
    assert port.settings.performance.dgs_splitting == "classical_exact"
    assert port.transfer_types == ref.transfer_types
    assert port.cycle_kind == "full precision"
    assert port.cycles == len(ref.residuals) - 1 == len(port.residuals) - 1
    assert np.allclose(port.residuals, ref.residuals, rtol=1e-6, atol=0)
    assert port.solve_residual < 1e-6
    _errors_match(ref, port)


def test_mixed_falls_back_to_full_as_dgtpu(tmp_path):
    """The flagship Stokes hierarchy on the 2x2 grid, with V(1,1) cycles: the
    geometric level is 1x1, an odd Ni, so neither package builds its Stokes
    SoA cycle; both log the fallback and run the full-precision
    distributive-GS (lsq) multigrid, and the port's equals its own
    ``precision: full`` run."""
    params = _stokes_params(precision="mixed")
    params["grid"]["filename"] = "Rectangle_2X2_nPoly2.xyz"
    mg = params["solver"]["multigrid"]
    mg["geometric coarsening"]["coarsening factors"] = 2
    mg["cycle type"] = "V"
    for node in ("polynomial coarsening", "geometric coarsening"):
        for side in ("pre smoother", "post smoother"):
            mg[node][side]["iterations"] = 1
    params["logging"]["loglevel"] = "WARNING"
    seen = {name: chip_smoke._Messages() for name in ("dgtpu.api", "dgtpu_torch.api")}
    for name, handler in seen.items():
        logging.getLogger(name).addHandler(handler)
    try:
        ref, port = _route(tmp_path, params, solve_multigrid=True)
    finally:
        for name, handler in seen.items():
            logging.getLogger(name).removeHandler(handler)
    for handler in seen.values():
        assert [m for m in handler.messages
                if m.startswith("mixed precision: the fused Stokes cycle is unavailable")
                and m.endswith("running full precision")]
    assert [(l.Nj, l.Ni) for l in port.levels] == [(1, 1), (2, 2), (2, 2)]
    assert port.transfer_types == ref.transfer_types
    assert port.cycle_kind == "full precision"
    assert port.cycles == len(ref.residuals) - 1 == len(port.residuals) - 1
    assert np.allclose(port.residuals, ref.residuals, rtol=1e-6, atol=0)
    _errors_match(ref, port)
    params["performance"]["precision"] = "full"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
        full = tapi.DGFEM(device="cpu", settings=Settings(params), solve_multigrid=True)
        full.solve()
    assert full.residuals == port.residuals and full.L2_error_p == port.L2_error_p


def test_block_gs_on_the_saddle_operator_raises_as_dgtpu(levels):
    """dgtpu smooths a global-order saddle operator only with distributive
    GS: the block smoothers find no diagonal blocks, in both packages."""
    j, t = levels
    from dgtpu.solvers.relaxation_driver import residual_tracked_smoother as jtracked
    from dgtpu_torch.solvers.relaxation_driver import residual_tracked_smoother
    with pytest.raises(AttributeError, match="diag_blocks"):
        jtracked(j.op, j.rhs, name="block_gauss_seidel")
    with pytest.raises(AttributeError, match="diag_blocks"):
        residual_tracked_smoother(t.op, t.rhs, name="block_gauss_seidel")
