"""dgtpu_torch's algebraic multigrid (``-amg``) against dgtpu's, on the CPU
in float64, on dgtpu's 4x4 p=2 Poisson operator carried across by
``convert.py``.

* The smoothed-aggregation and Ruge-Stuben hierarchies built from the
  port's dense operator: every level's A and P, the spectral-radius
  estimates and the coarsest A equal dgtpu's to 1e-13 relative.
* One V-cycle from a numpy-seeded iterate: < 1e-12 relative.
* ``solve_amg``: the same cycle count and residual history, the solution
  within 1e-8.
* The ``-amg`` route through ``DGFEM(device="cpu")``, both variants: L1/L2
  (u) within 1e-8 of dgtpu's route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from dgtpu.api import DGFEM as JDGFEM
from dgtpu.settings import Settings as JSettings
from dgtpu.solvers import amg as jamg

import dgtpu_torch.api as tapi
from dgtpu_torch.convert import stencil_from_arrays
from dgtpu_torch.settings import Settings, load_params
from dgtpu_torch.solvers import amg as tamg

torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def ops():
    """dgtpu's finest 4x4 p=2 Poisson level and the port's operator on the
    same numbers."""
    lvl = __graft_entry__._flagship(n=4, p_grid=2, p_sol=2).levels[-1]
    op = stencil_from_arrays(dict(blocks=np.asarray(lvl.op.blocks),
                                  nbr=np.asarray(lvl.op.nbr), mask=np.asarray(lvl.op.mask)))
    return lvl, op, torch.as_tensor(np.array(lvl.rhs))


@pytest.mark.parametrize("variant", ["sa", "rs"])
def test_hierarchy_matches_dgtpu(ops, variant):
    lvl, op, _ = ops
    A_ref = np.asarray(lvl.op.to_dense())
    A = op.to_dense().numpy()
    assert np.array_equal(A, A_ref)
    build = {"sa": (jamg._sa_hierarchy, tamg._sa_hierarchy),
             "rs": (jamg._rs_hierarchy, tamg._rs_hierarchy)}[variant]
    ref_levels, ref_coarse = build[0](A_ref)
    levels, coarse = build[1](A)
    assert len(levels) == len(ref_levels) >= 1
    for (Al, P, rho), (Al_r, P_r, rho_r) in zip(levels, ref_levels):
        assert P.shape == P_r.shape
        assert _rel(Al, Al_r) < 1e-13 and _rel(P, P_r) < 1e-13
        assert rho == pytest.approx(rho_r, rel=1e-13)
    assert coarse.shape == ref_coarse.shape and coarse.shape[0] < A.shape[0]
    assert _rel(coarse, ref_coarse) < 1e-13


@pytest.mark.parametrize("variant", ["sa", "rs"])
def test_one_cycle_matches_dgtpu(ops, variant):
    lvl, op, rhs = ops
    x0 = np.random.default_rng(3).standard_normal(rhs.shape[0])
    ref_cycle, _ = jamg.build_sa_cycle(lvl.op, variant=variant)
    cycle, _ = tamg.build_sa_cycle(op, variant=variant)
    ref = ref_cycle(lvl.rhs, jnp.asarray(x0))
    assert _rel(cycle(rhs, torch.as_tensor(x0)), ref) < 1e-12


@pytest.mark.parametrize("variant", ["sa", "rs"])
def test_solve_amg_matches_dgtpu(ops, variant):
    lvl, op, rhs = ops
    u_ref, info_ref = jamg.solve_amg(lvl.op, lvl.rhs, variant=variant)
    u, info = tamg.solve_amg(op, rhs, variant=variant)
    assert info["cycles"] == len(info["residuals"]) == len(info_ref["residuals"])
    assert info["info"] == info_ref["info"]
    assert np.allclose(info["residuals"], info_ref["residuals"], rtol=1e-8, atol=0)
    assert info["residuals"][0] == 1.0
    assert _rel(u, u_ref) < 1e-8


def test_unknown_variant_raises(ops):
    _, op, _ = ops
    with pytest.raises(ValueError, match="must be 'sa' or 'rs'"):
        tamg.build_sa_cycle(op, variant="ua")


@pytest.mark.parametrize("variant", ["sa", "rs"])
def test_amg_route_matches_dgtpu(tmp_path, monkeypatch, variant):
    params = load_params()
    params["grid"]["filename"] = "Rectangle_4X4_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["solution"]["u"]["polynomial degree"] = 2
    params["solver"]["amg"]["variant"] = variant
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    ref = JDGFEM(settings=JSettings(params), solve_pyamg=True)
    ref.solve()
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    port = tapi.DGFEM(device="cpu", settings=Settings(params), solve_pyamg=True)
    port.solve()
    assert len(port.levels) == 1 and port.amg_info["info"] == 0
    for name in ("L1_error_u", "L2_error_u"):
        assert getattr(port, name) == pytest.approx(getattr(ref, name), rel=1e-8)
    assert np.abs(port.u_nodal - ref.u_nodal).max() / np.abs(ref.u_nodal).max() < 1e-8
