"""dgtpu_torch's sharded Stokes multigrid (``parallel/stokes_halo.py``)
against dgtpu's ``parallel/stokes_halo.py`` on the same global-order
operators (8x8 p_u=2/p_p=1 over p_u=1/p_p=0, dgtpu's own sizes), dgtpu on
its 8 virtual CPU devices, the port's 8 shards on the CPU.

Held: the full-precision solve with the Chebyshev velocity solver (the same
cycle count, the history within 1e-10 of its max, the solution within 1e-11
of its max); the FMG-seeded float64-defect refinement with GMRES-wrapped
cycles against dgtpu's ``defect='f64'`` (outer rounds within one, velocity
within 1e-9 of its max, pressure within 1e-9 of its max up to the free
constant, true residual below 1e-10); and the mixed DGFEM route with
``n_shards: 4`` (plain refinement cycles) against dgtpu's DGFEM: L2(u, v, p)
within 1e-6 relative.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from dgtpu.parallel.halo import make_mesh
from dgtpu.parallel.stokes_halo import ShardedStokesMultigrid

import dgtpu_torch.api as tapi
from dgtpu_torch.convert import from_dgtpu_stokes_arrays
from dgtpu_torch.parallel import halo as T
from dgtpu_torch.parallel import stokes_halo as TS
from dgtpu_torch.settings import Settings as TSettings

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _route_params():
    """dgtpu's sharded Stokes route parameters: 8x8 p_grid 2, p-multigrid
    (2, 1) over (1, 0), direct coarse solve, mixed precision, 4 shards."""
    from dgtpu_torch.settings import load_params
    params = load_params()
    params["problem"]["type"] = "Stokes"
    params["grid"]["filename"] = "Rectangle_8X8_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["solution"]["u"]["polynomial degree"] = 2
    params["solution"]["p"]["polynomial degree"] = 1
    params["solution"]["ordering"] = "global"
    mg = params["solver"]["multigrid"]
    mg["penalty parameter coarsening"]["enabled"] = False
    mg["polynomial coarsening"]["enabled"] = True
    mg["polynomial coarsening"]["levels"]["u"] = "1,2"
    mg["geometric coarsening"]["enabled"] = False
    mg["coarse grid solver"] = "direct"
    params["visualization"]["export"] = False
    params["visualization"]["automatically open paraview"] = False
    params["logging"]["loglevel"] = "ERROR"
    params["caching"]["enabled"] = False
    params["performance"]["precision"] = "mixed"
    params["performance"]["n_shards"] = 4
    return params


@pytest.fixture(scope="module")
def stokes8():
    """dgtpu's DGFEM on the route parameters (its levels serve the class
    tests too); the port's levels are numpy copies of dgtpu's operators."""
    from dgtpu.api import DGFEM as JDGFEM
    from dgtpu.settings import Settings
    dg = JDGFEM(settings=Settings(_route_params()), solve_multigrid=True)

    def fields(op):
        return dict(blocks=np.asarray(op.blocks), nbr=np.asarray(op.nbr),
                    mask=np.asarray(op.mask))
    port, _ = from_dgtpu_stokes_arrays(
        [dict(p_u=l.P_sol["u"], p_p=l.P_sol["p"], A=fields(l.block_A),
              D=fields(l.block_D), G=fields(l.block_G)) for l in dg.levels],
        [dict(kind="penalty")], [(l.Nj, l.Ni) for l in dg.levels])
    return dg, port


def _pair(stokes8, **overrides):
    dg, port = stokes8
    levels = dg.levels
    s = copy.deepcopy(dg.settings)
    for key, value in overrides.items():
        s.update_setting(key, value)
    jm = ShardedStokesMultigrid(levels, s, mesh=make_mesh(8))
    tm = TS.ShardedStokesMultigrid(port, s, mesh=T.make_mesh(8, "cpu"))
    return jm, tm, levels[-1]


def _check_solution(fine, got, ref, bar):
    """Velocity within ``bar`` of its max; pressure within ``bar`` of its max
    once the free constant (the same mode-0 shift on every element) is
    taken out."""
    got, ref = np.asarray(got), np.asarray(ref)
    n_uv = 2 * fine.N * fine.N_DOF_sol["u"]
    assert _rel(got[:n_uv], ref[:n_uv]) < bar
    dp = (got[n_uv:] - ref[n_uv:]).reshape(fine.N, -1)
    dp[:, 0] -= dp[:, 0].mean()
    assert np.abs(dp).max() < bar * np.abs(ref[n_uv:]).max()


def test_sharded_stokes_chebyshev_solve_matches_dgtpu(stokes8):
    """The full-precision sharded solve with ``performance.dgs_velocity_solver:
    chebyshev`` (with dgtpu's interval bounds)."""
    jm, tm, fine = _pair(stokes8, **{"performance.dgs_velocity_solver": "chebyshev"})
    assert tm.vel_solver == "chebyshev" and all(c is not None for c in tm.cheb)
    tm.cheb = list(jm.cheb)
    u, res, n = jm.solve(fine.rhs)
    tu, tres, tn = tm.solve(torch.as_tensor(np.asarray(fine.rhs)))
    assert res < 1e-6 and tres < 1e-6
    assert tn == n
    assert _rel(tm.history, jm.history) < 1e-10
    assert _rel(tu.numpy(), u) < 1e-11


def test_sharded_stokes_fmg_gmres_refinement_matches_dgtpu_f64(stokes8):
    """The float64-defect refinement seeded with the float32 FMG guess, its
    inner solve GMRES(2) right-preconditioned by one sharded cycle, against
    dgtpu's ``defect='f64'``."""
    jm, tm, fine = _pair(stokes8, **{"solver.multigrid.full_multigrid": True})
    u, res, n = jm.solve_refined(fine.rhs, tol=1e-10, n_inner=2, defect="f64",
                                 inner="gmres")
    rhs = torch.as_tensor(np.asarray(fine.rhs))
    tu, tres, tn = tm.solve_refined(rhs, tol=1e-10, n_inner=2, inner="gmres")
    assert res < 1e-10 and tres < 1e-10
    assert abs(tn - n) <= 1
    _check_solution(fine, tu.numpy(), u, 1e-9)
    r = rhs - tm.levels[-1].op.matvec(tu)
    assert float(torch.linalg.norm(r) / torch.linalg.norm(rhs)) < 1e-10


def test_sharded_stokes_route_matches_dgtpu(stokes8, tmp_path, monkeypatch):
    """The mixed route with ``n_shards: 4`` against dgtpu's DGFEM on the same
    parameters (the paramfile's block-GS smoother names make both warn that
    the sharded Stokes cycle smooths with distributive GS)."""
    ref, _ = stokes8
    ref.solve()
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    port = tapi.DGFEM(device="cpu", settings=TSettings(_route_params()),
                      solve_multigrid=True)
    port.solve()
    assert port.cycle_kind == "sharded mixed" and port.mesh.size == 4
    for var in "uvp":
        assert getattr(port, f"L2_error_{var}") == pytest.approx(
            getattr(ref, f"L2_error_{var}"), rel=1e-6)
    assert port.residuals[-1] < 1e-10 and ref.residuals[-1] < 1e-10
    assert abs(len(port.residuals) - len(ref.residuals)) <= 1


def test_dgs_sweep_matches_dgtpu(stokes8):
    """One distributive-GS sweep over 8 shards (one element row each: the
    checkerboard phase flips between shards) from random fields against
    dgtpu's ``_dgs_sweep`` in ``shard_map``, with the packed velocity passes
    and with the masked ones (``_rb_bgs_A``): 1e-13 of the result's max."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from dgtpu.parallel import halo as J
    from dgtpu.parallel import stokes_halo as JS
    _, tm, fine = _pair(stokes8)
    n_dev = 8
    jd = JS._LevelData(fine)
    rng = np.random.default_rng(3)
    nu2, npd = 2 * fine.N_DOF_sol["u"], fine.N_DOF_sol["p"]
    f_mom, uv = (rng.standard_normal((fine.Nj, fine.Ni, nu2)) for _ in range(2))
    f_cont, p = (rng.standard_normal((fine.Nj, fine.Ni, npd)) for _ in range(2))
    mesh = make_mesh(n_dev)
    spec = P(J.AXIS)
    pack = J.ShardColorPack(jd.A, jd.A_Dinv, fine.Nj // n_dev, fine.Ni)
    fn = jax.shard_map(lambda d, pk, *x: JS._dgs_sweep(d, *x, apack=pk), mesh=mesh,
                       in_specs=(tuple(spec for _ in jd.tree()), pack.specs()) + (spec,) * 4,
                       out_specs=(spec, spec), check_vma=False)
    with mesh:
        sh = NamedSharding(mesh, spec)

        def put(x):
            return jax.device_put(x, sh)
        ref = jax.jit(fn)(tuple(put(a) for a in jd.tree()), jax.tree.map(put, pack.tree()),
                          *(put(x) for x in (f_mom, f_cont, uv, p)))
    ref = np.concatenate([np.asarray(r).reshape(-1) for r in ref])
    tmesh = tm.mesh
    data = tm.data[-1]
    args = [tmesh.split(torch.as_tensor(x)) for x in (f_mom, f_cont, uv, p)]
    for apack in (tm.a_packs[-1], None):
        got = TS._dgs_sweep(data, *args, apack=apack)
        got = np.concatenate([tmesh.join(g).numpy().reshape(-1) for g in got])
        assert np.abs(got - ref).max() < 1e-13 * np.abs(ref).max()
