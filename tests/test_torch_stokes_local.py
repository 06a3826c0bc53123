"""dgtpu_torch's local-ordering Stokes assembly and the Stokes direct and
smoother routes against dgtpu's, on the CPU at 4x4 p_u=2/p_p=1
(``chip_smoke.stokes_params(4)`` with ``solution.ordering: local``).

* The local-order operator, one stencil of (2Nu + Np) blocks per element,
  unpinned and pinned for ``-d``, and its right-hand side: < 1e-12
  relative, neighbor maps exactly.
* dgtpu's pinned local-order operator carried across by ``convert.py``:
  the port's dense direct solve of it equals dgtpu's to 1e-10.
* ``-d`` in both orderings: L1/L2 (u, v, p) within 1e-8 of dgtpu's route,
  the local-order post-processing included; the two orderings agree as in
  dgtpu's ``test_global_equals_local_ordering`` (``tests/test_stokes.py:43``).
* ``-s`` with block Gauss-Seidel on the local-order saddle operator: it
  diverges after the same number of sweeps as dgtpu's (status 2).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from dgtpu.api import DGFEM as JDGFEM
from dgtpu.settings import Settings as JSettings
from dgtpu.solvers.direct import solve_direct as j_solve_direct

import dgtpu_torch.api as tapi
from dgtpu_torch.convert import stencil_from_arrays
from dgtpu_torch.settings import Settings
from dgtpu_torch.solvers.direct import solve_direct

torch.set_num_threads(1)
TOL = 1e-12


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _params(ordering="local"):
    params = chip_smoke.stokes_params(4)
    params["solution"]["ordering"] = ordering
    params["performance"]["precision"] = "full"
    return params


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """``pair(ordering, method)``: (dgtpu DGFEM, port DGFEM) for ``-d``
    (``solve_direct``) or ``-s`` with block Gauss-Seidel (``solve_smoother``),
    both solved; each pair is built once per module."""
    out = str(tmp_path_factory.mktemp("out"))
    built = {}

    def get(ordering, method):
        if (ordering, method) not in built:
            kwargs = {method: True, "smoother": "block_gauss_seidel"}
            ref = JDGFEM(settings=JSettings(_params(ordering)), **kwargs)
            ref.solve()
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tapi, "OUTPUT_ROOT", out)
                port = tapi.DGFEM(device="cpu", settings=Settings(_params(ordering)),
                                  **kwargs)
                port.solve()
            built[ordering, method] = ref, port
        return built[ordering, method]
    return get


@pytest.mark.parametrize("method", ["solve_direct", "solve_smoother"])
def test_local_assembly_matches_dgtpu(pair, method):
    ref, port = pair("local", method)
    j, t = ref.levels[-1], port.levels[-1]
    assert t.block_A is None and j.block_A is None
    B = t.N_DOF_sol_tot
    assert t.op.blocks.shape == (t.N, 5, B, B) == j.op.blocks.shape
    assert _rel(t.op.blocks, j.op.blocks) < TOL
    assert np.array_equal(t.op.nbr.numpy(), np.asarray(j.op.nbr))
    assert np.array_equal(t.op.mask.numpy(), np.asarray(j.op.mask))
    nu2 = 2 * t.N_DOF_sol["u"]
    assert t.op.blocks[0, 0, nu2, nu2] == (1.0 if method == "solve_direct" else 0.0)
    assert _rel(t.rhs, j.rhs) < TOL


def test_direct_solve_of_the_carried_operator(pair):
    j = pair("local", "solve_direct")[0].levels[-1]
    op = stencil_from_arrays(dict(blocks=np.asarray(j.op.blocks),
                                  nbr=np.asarray(j.op.nbr), mask=np.asarray(j.op.mask)))
    u = solve_direct(op, torch.as_tensor(np.array(j.rhs)))
    assert _rel(u, j_solve_direct(j.op, j.rhs)) < 1e-10


def _errors(dg):
    return {f"{n}_error_{v}": getattr(dg, f"{n}_error_{v}")
            for v in "uvp" for n in ("L1", "L2")}


@pytest.mark.parametrize("ordering", ["local", "global"])
def test_direct_route_matches_dgtpu(pair, ordering):
    ref, port = pair(ordering, "solve_direct")
    assert port.residual < 1e-12
    for name, value in _errors(port).items():
        assert value == pytest.approx(getattr(ref, name), rel=1e-8), name
    assert np.abs(port.u_nodal - ref.u_nodal).max() / np.abs(ref.u_nodal).max() < 1e-8


def test_global_equals_local_ordering(pair):
    local = pair("local", "solve_direct")[1]
    glob = pair("global", "solve_direct")[1]
    assert np.isclose(local.L2_error_u, glob.L2_error_u, rtol=1e-9)
    assert np.isclose(local.L2_error_p, glob.L2_error_p, rtol=1e-7)


def test_local_block_gs_smoother_diverges_as_dgtpu(pair):
    ref, port = pair("local", "solve_smoother")
    assert port.smoother_status == 2
    assert port.sweeps == len(ref.residuals) == len(port.residuals)
    assert np.allclose(port.residuals, ref.residuals, rtol=1e-6, atol=0)
