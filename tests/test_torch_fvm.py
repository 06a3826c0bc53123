"""The port's finite-volume discretization against dgtpu's, on the CPU: the
assembled 5-point operator and right-hand side, the four FVM transfer
matrices and their tiled application, the ``-fvm`` solve, the multigrid
with FVM coarse levels (``geometric coarsening: use FVM``) in full
precision, its mixed -> full fallback and as the Krylov preconditioner, and
dgtpu's own FVM cases (``tests/test_curvilinear_fvm.py``) run on the port.

Bars: operator, right-hand side and transfers within 1e-13; L1/L2(u) of the
solves within 1e-10 relative; the same number of cycles.
"""

import logging
import os

import numpy as np
import pytest
import torch

from dgtpu.api import DGFEM as JDGFEM
from dgtpu.geometry import Geometry as JGeometry
from dgtpu.level import CoarseGridLevel as JCoarseGridLevel
from dgtpu.level import GridLevel as JGridLevel
from dgtpu.mms import ManufacturedSolution as JMMS
from dgtpu.models.fvm import assemble_poisson_fvm as j_assemble_fvm
from dgtpu.ops import transfer as jtransfer
from dgtpu.settings import Settings as JSettings

import dgtpu_torch.api as tapi
from dgtpu_torch.convert import from_dgtpu_arrays
from dgtpu_torch.geometry import Geometry
from dgtpu_torch.level import CoarseGridLevel, GridLevel
from dgtpu_torch.mms import ManufacturedSolution
from dgtpu_torch.models.fvm import assemble_poisson_fvm
from dgtpu_torch.ops import transfer
from dgtpu_torch.settings import Settings, load_params
from tests.conftest import INPUT_DIR

torch.set_num_threads(1)
TOL = 1e-13
U = "sin(pi*x)*sin(pi*y)"


def _params(grid="Rectangle_8X8_nPoly1.xyz", p_grid=1, p_sol=1, circle=False, **over):
    params = load_params()
    params["grid"]["filename"] = grid
    params["grid"]["polynomial degree"] = p_grid
    params["grid"]["O grid"] = circle
    params["grid"]["circular"] = circle
    params["solution"]["u"]["polynomial degree"] = p_sol
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    for path, value in over.items():
        node = params
        *keys, leaf = path.split(".")
        for k in keys:
            node = node[k]
        node[leaf] = value
    return params


def _use_fvm(**over):
    """dgtpu's use-FVM case (test_curvilinear_fvm.py:112-136): 8x8 p=1,
    geometric factor 2 with FVM levels, no polynomial coarsening."""
    return _params(**{"solver.multigrid.polynomial coarsening.enabled": False,
                      "solver.multigrid.geometric coarsening.enabled": True,
                      "solver.multigrid.geometric coarsening.use FVM": True,
                      "solver.multigrid.geometric coarsening.coarsening factors": 2,
                      **over})


def _both(tmp, params, **method):
    """(dgtpu DGFEM, port DGFEM), both solved with ``params``."""
    import yaml
    ref = JDGFEM(settings=JSettings(yaml.safe_load(yaml.safe_dump(params))), **method)
    ref.solve()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "OUTPUT_ROOT", str(tmp))
        port = tapi.DGFEM(device="cpu", settings=Settings(params), **method)
        port.solve()
    return ref, port


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("grid, p, circle", [
    ("Rectangle_8X8_nPoly2.xyz", 2, False), ("CircleInCircle_4X4_nPoly2.xyz", 2, True)])
def test_fvm_assembly_matches_dgtpu(grid, p, circle):
    """The negated 5-point operator (1x1 blocks), its topology and the
    right-hand side, on a rectangle and on the curvilinear O-grid, and on
    the geometric FVM level below (its cell centers from the fine level)."""
    params = _params(grid, p, p, circle)
    js, ts = JSettings(params), Settings(params)
    jg, tg = JGeometry(os.path.join(INPUT_DIR, grid), js), Geometry(
        os.path.join(INPUT_DIR, grid), ts)
    jl = JGridLevel(jg, js, ["u"], {"u": p}, discretization="fvm")
    tl = GridLevel(tg, ts, ["u"], {"u": p}, discretization="fvm")
    pairs = [(jl, tl)]
    if not circle:
        pairs.append((JCoarseGridLevel(jg, jl, js, ["u"], 2, discretization="fvm"),
                      CoarseGridLevel(tg, tl, ts, ["u"], 2, discretization="fvm")))
    for j, t in pairs:
        assert t.P_sol == j.P_sol and t.discretization == "fvm"
        jop, jrhs = j_assemble_fvm(j, JMMS({"u": U}, "Poisson", 1.0))
        top, trhs = assemble_poisson_fvm(t, ManufacturedSolution({"u": U}, "Poisson", 1.0))
        assert top.blocks.shape == (t.N, 5, 1, 1)
        assert _rel(top.blocks.numpy(), jop.blocks) < TOL
        assert np.array_equal(top.nbr.numpy(), np.asarray(jop.nbr))
        assert np.array_equal(top.mask.numpy(), np.asarray(jop.mask))
        assert _rel(trhs.numpy(), jrhs) < TOL
        # the global negation makes the operator SPD
        A = top.to_dense().numpy()
        assert np.allclose(A, A.T) and np.linalg.eigvalsh(A).min() > 0


@pytest.mark.parametrize("p", [1, 2, 5])
def test_fvm_transfers_match_dgtpu(p):
    """The four FVM transfer matrices, and the tiled restriction (with the
    row scale) and prolongation on the same seeded vectors."""
    for name in ("dg_to_fvm_restriction", "dg_to_fvm_prolongation"):
        assert _rel(getattr(transfer, name)(p), getattr(jtransfer, name)(p)) < TOL
    for name in ("fvm_geometric_prolongation", "fvm_geometric_restriction"):
        assert _rel(getattr(transfer, name)(), getattr(jtransfer, name)()) < TOL
    rng = np.random.default_rng(p)
    nj_c, ni_c = 4, 6
    scale = rng.random(2 * nj_c * 2 * ni_c)
    cases = [("dg_to_fvm", dict(p_fine=p, row_scale=scale),
              2 * nj_c * 2 * ni_c * (p + 1) ** 2, 2 * nj_c * 2 * ni_c),
             ("geometric_fvm", dict(Ni_c=ni_c, Nj_c=nj_c), 4 * nj_c * ni_c, nj_c * ni_c)]
    for kind, kw, n_fine, n_coarse in cases:
        j = jtransfer.make_transfer(kind, **kw)
        t = transfer.make_transfer(kind, **kw)
        r, e = rng.standard_normal(n_fine), rng.standard_normal(n_coarse)
        assert _rel(t.restrict(torch.as_tensor(r)).numpy(), j.restrict(r)) < TOL
        assert _rel(t.prolong(torch.as_tensor(e)).numpy(), j.prolong(e)) < TOL


def test_fvm_standalone_solve(tmp_path):
    """dgtpu's -fvm case on 8x8 p=2: L1/L2(u) within 1e-10 of dgtpu's
    (dgtpu's own bar: L2 < 0.2)."""
    ref, port = _both(tmp_path, _params("Rectangle_8X8_nPoly2.xyz", 2, 2),
                      solve_finite_volume_method=True)
    assert port.residual < 1e-12 and port.L2_error_u < 0.2
    assert port.L1_error_u == pytest.approx(ref.L1_error_u, rel=1e-10)
    assert port.L2_error_u == pytest.approx(ref.L2_error_u, rel=1e-10)


def test_fvm_h_convergence(tmp_path, monkeypatch):
    """dgtpu's case, run on the port: the cell-centered FVM is 2nd order on
    the cell averages (4x4 -> 8x8, p_grid 2)."""
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    errs = []
    for n in (4, 8):
        dg = tapi.DGFEM(device="cpu", settings=Settings(_params(
            f"Rectangle_{n}X{n}_nPoly2.xyz", 2, 2)), solve_finite_volume_method=True)
        dg.solve()
        errs.append(dg.L2_error_u)
    assert np.log2(errs[0] / errs[1]) > 1.5, errs


@pytest.fixture(scope="module")
def use_fvm_full(tmp_path_factory):
    return _both(tmp_path_factory.mktemp("fvm"), _use_fvm(), solve_multigrid=True)


def test_use_fvm_multigrid_converges(use_fvm_full):
    """dgtpu's use-FVM case: levels fvm, fvm, dg; the same cycles and
    residual history as dgtpu's, L1/L2(u) within 1e-10."""
    ref, port = use_fvm_full
    assert [l.discretization for l in port.levels] == ["fvm", "fvm", "dg"]
    assert [l.P_sol["u"] for l in port.levels] == [l.P_sol["u"] for l in ref.levels]
    assert [t.kind for t in port.transfers] == ["geometric_fvm", "dg_to_fvm"]
    assert port.cycle_kind == "full precision" and port.residuals[-1] < 1e-6
    assert port.cycles == len(ref.residuals) - 1
    assert np.allclose(port.residuals, ref.residuals, rtol=1e-8, atol=0)
    assert port.L1_error_u == pytest.approx(ref.L1_error_u, rel=1e-10)
    assert port.L2_error_u == pytest.approx(ref.L2_error_u, rel=1e-10)


def test_use_fvm_hierarchy_carries_across(use_fvm_full):
    """dgtpu's FVM hierarchy carried into the port (``convert``) gives the
    port's own operators and transfers, the row scale included."""
    ref, port = use_fvm_full
    dims = [(l.Nj, l.Ni) for l in ref.levels]
    levels = [{"blocks": np.asarray(l.op.blocks), "nbr": np.asarray(l.op.nbr),
               "mask": np.asarray(l.op.mask)} for l in ref.levels]
    transfers = [{"kind": t.kind, "R": np.asarray(t.R), "P": np.asarray(t.P),
                  **({} if t.row_scale is None else {"row_scale": np.asarray(t.row_scale)})}
                 for t in ref.transfers]
    ops, ts = from_dgtpu_arrays(levels, transfers, ref.transfer_types, dims)
    rng = np.random.default_rng(3)
    for a, b in zip(ops, port.levels):
        assert _rel(a.blocks.numpy(), b.op.blocks.numpy()) < TOL
    for a, b, (nj, ni) in zip(ts, port.transfers, dims):
        assert (a.kind, a.cf_f, a.cf_c, a.B_f, a.B_c) == \
            (b.kind, b.cf_f, b.cf_c, b.B_f, b.B_c)
        if a.cf_f > 1:
            assert (a.Ni_t, a.Nj_t) == (b.Ni_t, b.Nj_t)
        assert (a.row_scale is None) == (b.row_scale is None)
        e = torch.as_tensor(rng.standard_normal(nj * ni * a.B_c))
        assert _rel(a.prolong(e).numpy(), b.prolong(e).numpy()) < TOL
        r = a.prolong(e)
        assert _rel(a.restrict(r).numpy(), b.restrict(r).numpy()) < TOL


def test_mixed_precision_falls_back_to_full(tmp_path, monkeypatch, use_fvm_full):
    """With ``precision: mixed`` no float32 cycle has the FVM transfers: the
    route logs why and runs the full-precision multigrid, to the numbers of
    the full-precision run (dgtpu's: its mixed route falls back the same
    way, ``dgtpu/api.py:457-467``)."""
    full_ref, full = use_fvm_full
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    logger = logging.getLogger("dgtpu_torch.api")
    logger.addHandler(handler)
    try:
        port = tapi.DGFEM(device="cpu", solve_multigrid=True, settings=Settings(_use_fvm(
            **{"performance.precision": "mixed", "logging.loglevel": "WARNING"})))
        port.solve()
    finally:
        logger.removeHandler(handler)
    assert any(m.endswith("running full precision") for m in seen), seen
    assert port.cycle_kind == "full precision"
    assert port.cycles == full.cycles == len(full_ref.residuals) - 1
    assert port.L2_error_u == full.L2_error_u
    assert port.L2_error_u == pytest.approx(full_ref.L2_error_u, rel=1e-10)


def test_krylov_with_fvm_multigrid_preconditioner(tmp_path):
    """``-k`` with ``preconditioner: multigrid`` over the FVM hierarchy:
    dgtpu's iterations and L1/L2(u) within 1e-8."""
    params = _use_fvm(**{"solver.krylov.preconditioner": "multigrid",
                         "solver.krylov.tolerance": 1e-12,
                         "solver.krylov.absolute tolerance": 0.0})
    ref, port = _both(tmp_path, params, solve_krylov=True)
    assert [l.discretization for l in port.levels] == ["fvm", "fvm", "dg"]
    assert port.L1_error_u == pytest.approx(ref.L1_error_u, rel=1e-8)
    assert port.L2_error_u == pytest.approx(ref.L2_error_u, rel=1e-8)
