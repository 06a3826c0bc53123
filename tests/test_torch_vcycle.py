"""dgtpu_torch's rolled cycle (plain torch path, float64) against dgtpu's
``PallasVCycle`` on the same operators, carried across with
``convert.from_dgtpu_arrays``.

Bar: < 1e-11 relative after 3 cycles (the repo's bar between cycle builds)
against ``PallasVCycle.build_xla()``, for V/W/F with the smoother and the
dense-inverse coarse solves, on an all-even hierarchy (where dgtpu packs the
colors, ``use_split``), on 4x4 p=2 with factors 4,2 (Ni = 1, 2, 4), on a
generated 6x2 grid (Ni = 6 -> 3) and on a generated annulus whose coarse
level is 3 cells around (the seam joins two cells of one color); the FMG
guess; and one case against the Pallas kernel itself in interpret mode.
"""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgtpu.api import DGFEM as JDGFEM
from dgtpu.geometry import (generate_annulus_grid, generate_rectangle_grid,
                            write_plot3d)
from dgtpu.ops import pallas_vcycle as jv
from dgtpu.settings import Settings as JSettings
from dgtpu.settings import load_params

from dgtpu_torch.convert import from_dgtpu_arrays
from dgtpu_torch.ops import vcycle
from dgtpu_torch.ops.vcycle import RolledVCycle

torch.set_num_threads(1)
TOL = 1e-11


def _dgtpu(grid, p, levels, factors, folder=None, o_grid=False):
    params = load_params()
    params["grid"]["filename"] = grid
    if folder:
        params["grid"]["folder"] = folder
    params["grid"]["polynomial degree"] = p
    params["grid"]["O grid"] = o_grid
    params["grid"]["circular"] = o_grid
    params["solution"]["u"]["polynomial degree"] = p
    mg = params["solver"]["multigrid"]
    mg["polynomial coarsening"]["levels"]["u"] = levels
    mg["geometric coarsening"]["coarsening factors"] = factors
    if o_grid:
        params["problem"]["SIP penalty parameter multiplier"] = 2
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    s = JSettings(params)
    s.solver.method = "multigrid"
    s.update_setting("solver.discretization", "dg")
    return JDGFEM(settings=s, solve_multigrid=True)


@pytest.fixture(scope="module")
def hierarchies(tmp_path_factory):
    """dgtpu hierarchies by name, built on first use."""
    tmp = str(tmp_path_factory.mktemp("grids"))
    built = {}

    def get(name):
        if name not in built:
            if name == "even":            # (2,2) (4,4) (4,4): dgtpu packs colors
                built[name] = _dgtpu("Rectangle_4X4_nPoly2.xyz", 2, "1,2", "2")
            elif name == "deep":          # (1,1) (2,2) (4,4) (4,4)
                built[name] = _dgtpu("Rectangle_4X4_nPoly2.xyz", 2, "1,2", "4,2")
            elif name == "odd":           # (1,3) (2,6) (2,6)
                write_plot3d(os.path.join(tmp, "rect_6x2.xyz"),
                             *generate_rectangle_grid(6, 2, 1))
                built[name] = _dgtpu("rect_6x2.xyz", 1, "0,1", "2", folder=tmp)
            elif name == "annulus":       # (1,3) (2,6) (2,6), periodic in i
                write_plot3d(os.path.join(tmp, "annulus_6x2.xyz"),
                             *generate_annulus_grid(6, 2, 2))
                built[name] = _dgtpu("annulus_6x2.xyz", 2, "1,2", "2", folder=tmp,
                                     o_grid=True)
        return built[name]
    return get


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _pair(dg, cycle="V", coarse="smoother", interpret=False, **kw):
    """(dgtpu PallasVCycle, port RolledVCycle), both float64, same operators."""
    s = copy.deepcopy(dg.settings)
    s.solver.multigrid.cycle_type = cycle
    s.solver.multigrid.coarse_grid_solver = coarse
    dims = [(l.Nj, l.Ni) for l in dg.levels]
    ops, trs = from_dgtpu_arrays(
        [dict(blocks=np.asarray(l.op.blocks), nbr=np.asarray(l.op.nbr),
              mask=np.asarray(l.op.mask)) for l in dg.levels],
        [dict(kind=t.kind, R=np.asarray(t.R), P=np.asarray(t.P))
         for t in dg.transfers], dg.transfer_types, dims)
    j = jv.PallasVCycle([l.op for l in dg.levels], dg.transfers, dg.transfer_types,
                        s, dims, dtype=jnp.float64, interpret=interpret)
    t = RolledVCycle(ops, trs, dg.transfer_types, s, dims, dtype=torch.float64, **kw)
    return j, t


def _cycles(fn, rhs, n=3):
    u = rhs * 0
    for _ in range(n):
        u = fn(rhs, u)
    return np.asarray(u)


@pytest.mark.parametrize("coarse", ["smoother", "direct"])
@pytest.mark.parametrize("cycle", ["V", "W", "F"])
def test_cycle_matches_build_xla(hierarchies, cycle, coarse):
    dg = hierarchies("even")
    j, t = _pair(dg, cycle=cycle, coarse=coarse)
    assert j.use_split and t.use_split
    rhs = np.array(dg.levels[-1].rhs)
    ref = _cycles(j.build_xla(), jnp.asarray(rhs))
    assert _rel(_cycles(t, torch.as_tensor(rhs)), ref) < TOL


@pytest.mark.parametrize("name, dims, cycle, coarse", [
    ("deep", [(1, 1), (2, 2), (4, 4), (4, 4)], "V", "smoother"),
    ("deep", [(1, 1), (2, 2), (4, 4), (4, 4)], "W", "direct"),
    ("deep", [(1, 1), (2, 2), (4, 4), (4, 4)], "F", "smoother"),
    ("odd", [(1, 3), (2, 6), (2, 6)], "V", "smoother"),
    ("odd", [(1, 3), (2, 6), (2, 6)], "W", "direct"),
    ("annulus", [(1, 3), (2, 6), (2, 6)], "V", "smoother"),
    ("annulus", [(1, 3), (2, 6), (2, 6)], "F", "direct"),
])
def test_odd_ni_cycle_matches_build_xla(hierarchies, name, dims, cycle, coarse):
    dg = hierarchies(name)
    assert [(l.Nj, l.Ni) for l in dg.levels] == dims
    j, t = _pair(dg, cycle=cycle, coarse=coarse)
    assert not j.use_split and not t.use_split
    rhs = np.array(dg.levels[-1].rhs)
    ref = _cycles(j.build_xla(), jnp.asarray(rhs))
    assert _rel(_cycles(t, torch.as_tensor(rhs)), ref) < TOL


def test_annulus_wraps_in_i(hierarchies):
    """The generated annulus is periodic in i on every level: the coarse
    level's three cells are each other's neighbors across the seam."""
    dg = hierarchies("annulus")
    for lvl in dg.levels:
        nbr, mask = np.asarray(lvl.op.nbr), np.asarray(lvl.op.mask)
        assert mask[0, 1] and nbr[0, 1] == lvl.Ni - 1


def test_cycle_matches_interpret_kernel(hierarchies):
    """dgtpu's Pallas kernel itself, run in interpret mode on the CPU."""
    dg = hierarchies("deep")
    j, t = _pair(dg, interpret=True)
    rhs = np.array(dg.levels[-1].rhs)
    ref = _cycles(j.build(), jnp.asarray(rhs), n=2)
    assert _rel(_cycles(t, torch.as_tensor(rhs), n=2), ref) < TOL


@pytest.mark.parametrize("name", ["even", "deep", "odd"])
def test_fmg_matches(hierarchies, name):
    dg = hierarchies(name)
    j, t = _pair(dg)
    rhs = np.array(dg.levels[-1].rhs)
    ref = np.asarray(j.build_fmg()(jnp.asarray(rhs)))
    assert _rel(t.build_fmg()(torch.as_tensor(rhs)), ref) < TOL
    # the finest level's cycle handed in, as the mixed route does
    ref = np.asarray(j.build_fmg(finest_cycle=j.build_xla())(jnp.asarray(rhs)))
    assert _rel(t.build_fmg(finest_cycle=t)(torch.as_tensor(rhs)), ref) < TOL


def test_fmg_on_one_level_runs_no_finest_cycle(hierarchies):
    """With one level there is no finest-level cycle to replace: the guess is
    the coarse solve, and the handed-in cycle is not called."""
    dg = hierarchies("even")
    s = copy.deepcopy(dg.settings)
    s.solver.multigrid.coarse_grid_solver = "direct"
    op = dg.levels[0].op
    dims = [(dg.levels[0].Nj, dg.levels[0].Ni)]
    ops, _ = from_dgtpu_arrays(
        [dict(blocks=np.asarray(op.blocks), nbr=np.asarray(op.nbr),
              mask=np.asarray(op.mask))], [], [], dims)
    t = RolledVCycle(ops, [], [], s, dims, dtype=torch.float64)
    rhs = np.random.default_rng(0).standard_normal(op.shape[0])

    def never(rhs, u):
        raise AssertionError("the finest cycle ran on a one-level hierarchy")
    got = t.build_fmg(finest_cycle=never)(torch.as_tensor(rhs))
    assert _rel(got, np.linalg.solve(np.asarray(op.to_dense()), rhs)) < 1e-10


@pytest.mark.parametrize("nj_c, ni_c", [(2, 2), (1, 3), (1, 1)])
def test_tile_transfers_match(nj_c, ni_c):
    rng = np.random.default_rng(3)
    B, Bc = 4, 3
    R4, P4 = rng.standard_normal((4, Bc, B)), rng.standard_normal((4, B, Bc))
    r = rng.standard_normal((2 * nj_c, 2 * ni_c, B))
    e = rng.standard_normal((nj_c, ni_c, Bc))
    ref = jv._tile_restrict(jnp.asarray(r), jnp.asarray(R4), nj_c, ni_c)
    assert _rel(vcycle.tile_restrict(torch.as_tensor(r), torch.as_tensor(R4)), ref) < 1e-14
    ref = jv._tile_prolong(jnp.asarray(e), jnp.asarray(P4), nj_c, ni_c)
    assert _rel(vcycle.tile_prolong(torch.as_tensor(e), torch.as_tensor(P4)), ref) < 1e-14
    # child (b, a) of coarse cell (jc, ic) is fine cell (2 jc + b, 2 ic + a)
    fine = vcycle.tile_prolong(torch.as_tensor(e), torch.as_tensor(P4)).numpy()
    assert np.allclose(fine[2 * (nj_c - 1) + 1, 0], P4[2] @ e[nj_c - 1, 0])


def test_device_bytes_counts_the_held_tensors(hierarchies):
    """The same numbers dgtpu's fused kernel takes as operands, in the
    masked form: its hbm_bytes_per_invocation on an odd-Ni hierarchy."""
    dg = hierarchies("deep")
    j, t = _pair(dg, coarse="direct")
    assert t.device_bytes() == j.hbm_bytes_per_invocation()
    _, t = _pair(dg)
    held = sum(x.numel() * 8 for lv in t.levels for x in (lv.blocks, lv.Dinv, lv.masks))
    held += sum(x.numel() * 8 for x in t.R + t.P)
    assert t.device_bytes() == held and t.coarse_inv is None


def test_rejects_unknown_cycle_and_transfer(hierarchies):
    dg = hierarchies("even")
    s = copy.deepcopy(dg.settings)
    s.solver.multigrid.cycle_type = "X"
    dims = [(l.Nj, l.Ni) for l in dg.levels]
    _, t = _pair(dg)
    ops = [type("Op", (), {"blocks": lv.blocks.reshape(-1, 5, *lv.blocks.shape[-2:])})
           for lv in t.levels]
    with pytest.raises(NotImplementedError, match="V, W and F"):
        RolledVCycle(ops, t.transfers, t.types, s, dims)
    fvm = copy.copy(t.transfers[0])
    fvm.kind = "geometric_fvm"
    with pytest.raises(ValueError, match="no 'geometric_fvm' transfer"):
        RolledVCycle(ops, [fvm] + t.transfers[1:], t.types, dg.settings, dims)


def test_cpu_tensors_take_the_plain_path(hierarchies):
    """On CPU tensors every wrapper runs its plain version and counts no
    kernel launch; the reference cycle is the same computation."""
    dg = hierarchies("deep")
    _, t = _pair(dg, coarse="direct")
    _, ref = _pair(dg, coarse="direct", reference=True)
    vcycle.reset_launch_counts()
    rhs = torch.as_tensor(np.array(dg.levels[-1].rhs))
    assert np.array_equal(_cycles(t, rhs), _cycles(ref, rhs))
    assert [k.launches for k in vcycle.KERNELS] == [0, 0, 0, 0]
