"""The port's multigrid hierarchy against dgtpu's with all three DG
coarsenings on: penalty (multipliers 20,2), polynomial (2->1) and one
geometric level, on the 4x4 p=2 rectangle.

Levels, penalties and transfers must match dgtpu's; every level's
operator and the finest right-hand side to 1e-12 relative; the float64
SoA cycle on this hierarchy (penalty transfers included) to 1e-11 after
3 cycles; the port's mixed route on it reaches 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgtpu.api import DGFEM as JDGFEM
from dgtpu.ops.pallas_soa import SoAVCycle as JSoAVCycle
from dgtpu.settings import Settings as JSettings
from dgtpu.settings import load_params

import dgtpu_torch.api as tapi
from dgtpu_torch.convert import from_dgtpu_arrays
from dgtpu_torch.ops.soa import SoAVCycle
from dgtpu_torch.settings import Settings

torch.set_num_threads(1)


def _params():
    params = load_params()
    params["grid"]["filename"] = "Rectangle_4X4_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["solution"]["u"]["polynomial degree"] = 2
    mg = params["solver"]["multigrid"]
    mg["penalty parameter coarsening"]["enabled"] = True
    mg["penalty parameter coarsening"]["multipliers"] = "20,2"
    mg["polynomial coarsening"]["levels"]["u"] = "1,2"
    params["performance"]["precision"] = "mixed"
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    return params


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    js = JSettings(_params())
    js.solver.method = "multigrid"
    js.update_setting("solver.discretization", "dg")
    ref = JDGFEM(settings=js, solve_multigrid=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "OUTPUT_ROOT", str(tmp_path_factory.mktemp("out")))
        port = tapi.DGFEM(device="cpu", settings=Settings(_params()),
                          solve_multigrid=True)
        port.solve()
    return ref, port


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_levels_and_transfers_match(pair):
    ref, port = pair
    assert "penalty_parameter" in port.transfer_types
    assert port.transfer_types == ref.transfer_types
    assert [t.kind for t in port.transfers] == [t.kind for t in ref.transfers]
    assert [(l.Nj, l.Ni, l.P_sol["u"], float(l.sigma)) for l in port.levels] == \
        [(l.Nj, l.Ni, l.P_sol["u"], float(l.sigma)) for l in ref.levels]
    for t, j in zip(port.transfers, ref.transfers):
        assert np.array_equal(t.R.numpy(), np.asarray(j.R))


def test_operators_match(pair):
    ref, port = pair
    for t, j in zip(port.levels, ref.levels):
        assert _rel(t.op.blocks, j.op.blocks) < 1e-12
    assert _rel(port.levels[-1].rhs, ref.levels[-1].rhs) < 1e-12


def test_cycle_with_penalty_transfers_matches_build_xla(pair):
    ref, _ = pair
    dims = [(l.Nj, l.Ni) for l in ref.levels]
    ops, trs = from_dgtpu_arrays(
        [dict(blocks=np.asarray(l.op.blocks), nbr=np.asarray(l.op.nbr),
              mask=np.asarray(l.op.mask)) for l in ref.levels],
        [dict(kind=t.kind, R=np.asarray(t.R), P=np.asarray(t.P))
         for t in ref.transfers], ref.transfer_types, dims)
    j = JSoAVCycle([l.op for l in ref.levels], ref.transfers, ref.transfer_types,
                   ref.settings, dims, dtype=jnp.float64, interpret=True)
    t = SoAVCycle(ops, trs, ref.transfer_types, ref.settings, dims,
                  dtype=torch.float64)
    rhs = np.array(ref.levels[-1].rhs)
    fj, uj, ut = j.build_xla(), jnp.zeros(rhs.shape), torch.zeros(rhs.shape,
                                                                dtype=torch.float64)
    for _ in range(3):
        uj, ut = fj(jnp.asarray(rhs), uj), t(torch.as_tensor(rhs), ut)
    assert _rel(ut, uj) < 1e-11


def test_mixed_route_converges(pair):
    _, port = pair
    assert port.solve_residual < 1e-10
    assert np.isfinite(port.L2_error_u)
