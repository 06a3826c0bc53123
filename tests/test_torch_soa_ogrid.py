"""dgtpu_torch's SoA cycle against dgtpu's on the 4x4 O-grid
(CircleInCircle_4X4_nPoly2: periodic i-direction, so every i-neighbor
wraps and the row-start / row-end cells take the two-roll blend).

float64 plain path vs dgtpu's SoAVCycle.build_xla on the same operators,
< 1e-11 relative after 3 cycles, for V/W/F with the smoother and the
dense-inverse coarse solves.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgtpu.api import DGFEM as JDGFEM
from dgtpu.ops.pallas_soa import SoAVCycle as JSoAVCycle
from dgtpu.settings import Settings as JSettings
from dgtpu.settings import load_params

from dgtpu_torch.convert import from_dgtpu_arrays
from dgtpu_torch.ops.soa import SoAVCycle

torch.set_num_threads(1)
TOL = 1e-11


@pytest.fixture(scope="module")
def ogrid():
    params = load_params()
    params["grid"]["filename"] = "CircleInCircle_4X4_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["grid"]["O grid"] = True
    params["grid"]["circular"] = True
    params["solution"]["u"]["polynomial degree"] = 2
    params["problem"]["SIP penalty parameter multiplier"] = 2
    params["solver"]["multigrid"]["polynomial coarsening"]["levels"]["u"] = "1,2"
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    s = JSettings(params)
    s.solver.method = "multigrid"
    s.update_setting("solver.discretization", "dg")
    return JDGFEM(settings=s, solve_multigrid=True)


def _pair(dg, cycle, coarse):
    s = copy.deepcopy(dg.settings)
    s.solver.multigrid.cycle_type = cycle
    s.solver.multigrid.coarse_grid_solver = coarse
    dims = [(l.Nj, l.Ni) for l in dg.levels]
    ops, trs = from_dgtpu_arrays(
        [dict(blocks=np.asarray(l.op.blocks), nbr=np.asarray(l.op.nbr),
              mask=np.asarray(l.op.mask)) for l in dg.levels],
        [dict(kind=t.kind, R=np.asarray(t.R), P=np.asarray(t.P))
         for t in dg.transfers], dg.transfer_types, dims)
    j = JSoAVCycle([l.op for l in dg.levels], dg.transfers, dg.transfer_types,
                   s, dims, dtype=jnp.float64, interpret=True)
    return j, SoAVCycle(ops, trs, dg.transfer_types, s, dims, dtype=torch.float64)


def test_ogrid_packing_is_periodic(ogrid):
    j, t = _pair(ogrid, "V", "smoother")
    assert t.periodic == j.periodic == [True] * j.n_lev
    for k, lv in enumerate(t.levels):
        for c in (0, 1):
            assert np.array_equal(lv.blocks[c].numpy(), np.asarray(j.soa_blocks[k][c]))


@pytest.mark.parametrize("cycle, coarse", [
    ("V", "smoother"), ("W", "smoother"), ("F", "smoother"),
    ("V", "direct"), ("W", "direct"), ("F", "direct")])
def test_ogrid_cycle_matches_build_xla(ogrid, cycle, coarse):
    j, t = _pair(ogrid, cycle, coarse)
    rhs = np.array(ogrid.levels[-1].rhs)
    uj, ut = jnp.zeros_like(rhs), torch.zeros(rhs.shape, dtype=torch.float64)
    fj = j.build_xla()
    for _ in range(3):
        uj, ut = fj(jnp.asarray(rhs), uj), t(torch.as_tensor(rhs), ut)
    uj = np.asarray(uj)
    assert np.abs(ut.numpy() - uj).max() / np.abs(uj).max() < TOL
