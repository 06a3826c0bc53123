"""dgtpu_torch's sharded Poisson multigrid (``parallel/halo.py``) against
dgtpu's ``parallel/halo.py`` on the same operators, dgtpu on its 8 virtual
CPU devices, the port's shards all on the CPU.

The cases mirror dgtpu's non-slow cases in ``tests/test_parallel.py`` at the
same sizes (8x8 p=2 -> p=1, 2-8 shards): the halo matvec against dgtpu's
``_matvec_with_halo`` in ``shard_map`` and the single-device operator
(1e-13 relative); the packed and masked red-black sweeps (1e-13);
``ShardedMultigrid`` for V/W/F, FMG, Jacobi, Chebyshev, the coarse
smoother, geometric and FVM levels (the same cycle count, the residual
history within 1e-10 of its max, u within 1e-11 of its max); the
indivisible-Nj and tile-misalignment errors with dgtpu's messages;
``solve_refined`` against dgtpu's ``defect='f64'`` (outer rounds within one,
u within 1e-9 of its max, true residual below 1e-10); the DGFEM route with
``n_shards`` and the non-multigrid warning.
"""

import copy
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dgtpu.geometry import Geometry
from dgtpu.level import CoarseGridLevel, GridLevel
from dgtpu.mms import ManufacturedSolution
from dgtpu.models.poisson import assemble_poisson
from dgtpu.ops.linalg import host_inv as j_host_inv
from dgtpu.ops.transfer import make_transfer
from dgtpu.parallel import halo as J

import dgtpu_torch.api as tapi
from dgtpu_torch.convert import from_dgtpu_arrays
from dgtpu_torch.ops.linalg import host_inv
from dgtpu_torch.ops.smoothers import block_gauss_seidel, element_colors
from dgtpu_torch.parallel import halo as T
from dgtpu_torch.settings import Settings as TSettings
from tests.conftest import INPUT_DIR

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _port_levels(levels, transfers):
    """Port levels and transfers from numpy copies of dgtpu's (the port's
    classes read dgtpu's Settings as they read their own)."""
    dims = [(l.Nj, l.Ni) for l in levels]
    ops, trs = from_dgtpu_arrays(
        [dict(blocks=np.asarray(l.op.blocks), nbr=np.asarray(l.op.nbr),
              mask=np.asarray(l.op.mask)) for l in levels],
        [dict(kind=t.kind, R=np.asarray(t.R), P=np.asarray(t.P),
              row_scale=None if getattr(t, "row_scale", None) is None
              else np.asarray(t.row_scale)) for t in transfers],
        [t.kind for t in transfers], dims)

    class Level:
        def __init__(self, op, l):
            self.op, self.Ni, self.Nj = op, l.Ni, l.Nj
            self.N_DOF_sol_tot = l.N_DOF_sol_tot
    return [Level(op, l) for op, l in zip(ops, levels)], trs


@pytest.fixture(scope="module")
def setup8():
    """dgtpu's _setup: 8x8 p_grid 1, p 2 over p 1 (sigma 4)."""
    from dgtpu.settings import Settings, load_params
    s = Settings(load_params())
    for key, value in (("visualization.export", False), ("caching.enabled", False),
                       ("logging.loglevel", "WARNING"), ("grid.polynomial_degree", 1)):
        s.update_setting(key, value)
    geom = Geometry(os.path.join(INPUT_DIR, "Rectangle_8X8_nPoly1.xyz"), s)
    lvl = GridLevel(geom, s, ["u"], {"u": 2})
    mms = ManufacturedSolution({"u": "sin(pi*x)*sin(pi*y)"}, "Poisson", 1.0)
    lvl.op, rhs, _ = assemble_poisson(lvl, mms)
    coarse = GridLevel(geom, s, ["u"], {"u": 1}, sigma=4.0)
    coarse.op, _, _ = assemble_poisson(coarse)
    t = make_transfer("polynomial", p_fine=2, p_coarse=1)
    return s, geom, [coarse, lvl], [t], rhs


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_halo_matvec_matches(setup8, n_dev):
    """The halo matvec over the bands against dgtpu's ``_matvec_with_halo``
    in ``shard_map`` and against the single-device operator."""
    _, _, levels, _, _ = setup8
    lvl = levels[-1]
    B = lvl.N_DOF_sol_tot
    blocks = J.reshape_level(lvl.op, lvl.Ni, lvl.Nj)
    x = np.random.default_rng(0).standard_normal(lvl.N * B)
    mesh = J.make_mesh(n_dev)
    fn = jax.shard_map(J._matvec_with_halo, mesh=mesh, in_specs=(P(J.AXIS), P(J.AXIS)),
                       out_specs=P(J.AXIS), check_vma=False)
    with mesh:
        sh = NamedSharding(mesh, P(J.AXIS))
        ref = np.asarray(jax.jit(fn)(jax.device_put(blocks, sh), jax.device_put(
            J.vec_to_grid(jnp.asarray(x), lvl.Ni, lvl.Nj, B), sh))).reshape(-1)
    tmesh = T.make_mesh(n_dev, "cpu")
    (tl,), _ = _port_levels([lvl], [])
    out = tmesh.join(T._matvec_with_halo(
        tmesh.split(T.reshape_level(tl.op, lvl.Ni, lvl.Nj)),
        tmesh.split(torch.as_tensor(x).reshape(lvl.Nj, lvl.Ni, B)))).reshape(-1).numpy()
    assert _rel(out, ref) < 1e-13
    assert _rel(out, tl.op.matvec(torch.as_tensor(x)).numpy()) < 1e-13
    assert T.EXCHANGES["cpu"] > 0 and T.EXCHANGES["cuda"] == 0


@pytest.mark.parametrize("n_dev,omega", [(4, 1.0), (8, 1.0), (8, 0.8)])
def test_packed_and_masked_sweeps_match(setup8, n_dev, omega):
    """The port's packed and masked red-black sweeps against dgtpu's packed
    sweep (an odd band at 8 shards flips the checkerboard phase between
    shards), and the packed sweep against the port's single-device
    red-black block GS."""
    _, _, levels, _, rhs = setup8
    lvl = levels[-1]
    B = lvl.N_DOF_sol_tot
    blocks = J.reshape_level(lvl.op, lvl.Ni, lvl.Nj)
    Dinv = j_host_inv(blocks[:, :, 0])
    pack = J.ShardColorPack(blocks, Dinv, lvl.Nj // n_dev, lvl.Ni)
    u0 = np.random.default_rng(7).standard_normal((lvl.Nj, lvl.Ni, B))
    rhs_g = J.vec_to_grid(rhs, lvl.Ni, lvl.Nj, B)
    mesh = J.make_mesh(n_dev)
    spec = P(J.AXIS)
    packed = jax.shard_map(
        lambda pk, r, u: J._rb_gs_sweep_packed(pk, r, u, omega=omega, n_pass=2),
        mesh=mesh, in_specs=(pack.specs(), spec, spec), out_specs=spec, check_vma=False)
    with mesh:
        sh = NamedSharding(mesh, spec)

        def put(x):
            return jax.device_put(x, sh)
        ref = np.asarray(jax.jit(packed)(jax.tree.map(put, pack.tree()), put(rhs_g),
                                         put(jnp.asarray(u0))))

    tmesh = T.make_mesh(n_dev, "cpu")
    (tl,), _ = _port_levels([lvl], [])
    tb = T.reshape_level(tl.op, lvl.Ni, lvl.Nj)
    tD = host_inv(tb[:, :, 0])
    r_b = tmesh.split(torch.as_tensor(np.asarray(rhs_g)))
    u_b = tmesh.split(torch.as_tensor(u0))
    tpack = T.ShardColorPack(tb, tD, lvl.Nj // n_dev, lvl.Ni, tmesh)
    up = tmesh.join(T._rb_gs_sweep_packed(tpack, r_b, u_b, omega=omega, n_pass=2)).numpy()
    i = torch.arange(lvl.Ni)[None, :]
    j = torch.arange(lvl.Nj)[:, None]
    colors = tmesh.split(((i + j) % 2).to(torch.int32))
    um = tmesh.join(T._rb_gs_sweep(tmesh.split(tb), tmesh.split(tD), r_b, u_b, colors,
                                   omega=omega, n_pass=2)).numpy()
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(up - ref).max() < 1e-13 * scale
    assert np.abs(um - ref).max() < 1e-13 * scale
    single = block_gauss_seidel(tl.op, torch.as_tensor(np.asarray(rhs)),
                                torch.as_tensor(u0).reshape(-1), omega=omega,
                                direction="symmetric", iterations=1, strategy="redblack",
                                colors=element_colors(lvl.Ni, lvl.Nj)).numpy()
    assert np.abs(up.reshape(-1) - single).max() < 1e-12 * scale


def _smoothers(s, name, iterations=None, omega=None):
    for node in (s.solver.multigrid.polynomial_coarsening,
                 s.solver.multigrid.geometric_coarsening):
        for side in (node.pre_smoother, node.post_smoother):
            side.smoother = name
            if iterations is not None:
                side.iterations = iterations
            if omega is not None:
                side.relaxation_factor = omega


def _geometric_setup(s, geom, levels, transfers):
    """A 2x2 agglomeration below the 8x8 p=1 level: 4x4 -> 8x8 p=1 -> p=2."""
    coarse = levels[0]
    geo = CoarseGridLevel(geom, coarse, s, ["u"], 2)
    geo.op, _, _ = assemble_poisson(geo)
    return [geo] + levels, [make_transfer("geometric", p_fine=1, Ni_c=geo.Ni,
                                          Nj_c=geo.Nj, cf=2)] + transfers


CASES = {
    "V": {}, "W": {"cycle_type": "W"}, "F": {"cycle_type": "F"},
    "FMG": {"full_multigrid": True},
    "jacobi": {"smoother": ("block_jacobi", 3, 0.8)},
    "chebyshev": {"smoother": ("chebyshev", 3, None)},
    "coarse smoother": {"coarse_grid_solver": "smoother"},
    "geometric": {"geometric": True, "coarse_grid_solver": "direct"},
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_multigrid_matches_dgtpu(setup8, case):
    """``ShardedMultigrid.solve`` against dgtpu's on the same operators (4
    or 8 shards): the same cycle count, the residual history within 1e-10
    of its max, u within 1e-11 of its max (Chebyshev with dgtpu's interval
    bound)."""
    s0, geom, levels, transfers, rhs = setup8
    s = copy.deepcopy(s0)
    cfg = CASES[case]
    # 8 shards give one-row bands, 4 shards two-row bands (both halo rows
    # of a band differ)
    n_dev = 4 if case in ("W", "F", "jacobi", "geometric") else 8
    if cfg.get("geometric"):
        levels, transfers = _geometric_setup(s, geom, levels, transfers)
    for key in ("cycle_type", "full_multigrid", "coarse_grid_solver"):
        if key in cfg:
            setattr(s.solver.multigrid, key, cfg[key])
    if "smoother" in cfg:
        _smoothers(s, *cfg["smoother"])
    jm = J.ShardedMultigrid(levels, transfers, s, mesh=J.make_mesh(n_dev))
    u, res, n = jm.solve(rhs)
    tl, tt = _port_levels(levels, transfers)
    tm = T.ShardedMultigrid(tl, tt, s, mesh=T.make_mesh(n_dev, "cpu"))
    if case == "chebyshev":
        assert tm.eig_max[1] is not None
        tm.eig_max = list(jm.eig_max)     # the same interval as dgtpu's
    tu, tres, tn = tm.solve(torch.as_tensor(np.asarray(rhs)))
    assert res < 1e-6 and tres < 1e-6
    assert tn == n
    assert _rel(tm.history, jm.history) < 1e-10
    assert _rel(tu.numpy(), u) < 1e-11


def test_solve_refined_matches_dgtpu_f64(setup8):
    """The sharded float64-defect refinement, seeded with the float32 FMG
    guess, against dgtpu's ``defect='f64'``; ``defect='df32'`` is refused
    with the ROADMAP entry that leaves it out."""
    s0, _, levels, transfers, rhs = setup8
    tl, tt = _port_levels(levels, transfers)
    rhs_t = torch.as_tensor(np.asarray(rhs))
    s = copy.deepcopy(s0)
    s.solver.multigrid.full_multigrid = True
    jm = J.ShardedMultigrid(levels, transfers, s, mesh=J.make_mesh(8))
    u, res, n = jm.solve_refined(rhs, tol=1e-10, defect="f64")
    tm = T.ShardedMultigrid(tl, tt, s, mesh=T.make_mesh(8, "cpu"))
    tu, tres, tn = tm.solve_refined(rhs_t, tol=1e-10)
    assert res < 1e-10 and tres < 1e-10
    assert abs(tn - n) <= 1
    assert _rel(tu.numpy(), u) < 1e-9
    r = rhs_t - tl[-1].op.matvec(tu)
    assert float(torch.linalg.norm(r) / torch.linalg.norm(rhs_t)) < 1e-10
    with pytest.raises(ValueError, match='ROADMAP "Not ported"'):
        tm.solve_refined(rhs_t, defect="df32")


def test_rejects_indivisible_nj():
    """A non-dividing Nj fails early with the usable counts, dgtpu's message."""
    from dgtpu_torch.geometry import Geometry as TGeometry
    from dgtpu_torch.level import GridLevel as TGridLevel
    from dgtpu_torch.models.poisson import assemble_poisson as t_assemble
    from dgtpu_torch.ops.transfer import make_transfer as t_make
    from dgtpu_torch.settings import load_params
    s = TSettings(load_params())
    s.update_setting("grid.polynomial_degree", 1)
    geom = TGeometry(os.path.join(INPUT_DIR, "Rectangle_4X6_nPoly1.xyz"), s)
    lvl = TGridLevel(geom, s, ["u"], {"u": 2}, device="cpu")
    lvl.op, _, _ = t_assemble(lvl)
    coarse = TGridLevel(geom, s, ["u"], {"u": 1}, sigma=4.0, device="cpu")
    coarse.op, _, _ = t_assemble(coarse)
    t = t_make("polynomial", p_fine=2, p_coarse=1)
    with pytest.raises(ValueError, match=r"usable device counts.*\[1, 2, 3, 6\]"):
        T.ShardedMultigrid([coarse, lvl], [t], s, mesh=T.make_mesh(4, "cpu"))


def _api_params(shards=None, fvm=False):
    from dgtpu_torch.settings import load_params
    params = load_params()
    params["grid"]["filename"] = "Rectangle_8X8_nPoly1.xyz"
    params["grid"]["polynomial degree"] = 1
    mg = params["solver"]["multigrid"]
    if fvm:
        params["solution"]["u"]["polynomial degree"] = 1
        mg["polynomial coarsening"]["enabled"] = False
        mg["geometric coarsening"]["use FVM"] = True
    else:
        params["solution"]["u"]["polynomial degree"] = 2
        mg["polynomial coarsening"]["levels"]["u"] = "1,2"
    mg["geometric coarsening"]["enabled"] = True
    mg["geometric coarsening"]["coarsening factors"] = 2
    params["visualization"]["export"] = False
    params["visualization"]["automatically open paraview"] = False
    params["logging"]["loglevel"] = "ERROR"
    params["caching"]["enabled"] = False
    params["performance"]["precision"] = "full"
    if shards:
        params["performance"]["n_shards"] = shards
    return params


def _both(params, monkeypatch, tmp_path, **kw):
    from dgtpu.api import DGFEM as JDGFEM
    from dgtpu.settings import Settings
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    ref = JDGFEM(settings=Settings(copy.deepcopy(params)), solve_multigrid=True, **kw)
    ref.solve()
    port = tapi.DGFEM(device="cpu", settings=TSettings(copy.deepcopy(params)),
                      solve_multigrid=True, **kw)
    port.solve()
    return ref, port


@pytest.mark.parametrize("kind", ["flagship", "fvm"])
def test_dgfem_route_matches_dgtpu(tmp_path, monkeypatch, kind):
    """DGFEM with ``n_shards`` against dgtpu's DGFEM on the same parameters:
    the shipped paramfile (8x8 p=5, full precision) over 4 shards, whose
    cycle count chip_smoke.py holds the card's run to, and the FVM levels
    over 2 shards (their 4x4 tiles need whole tiles per shard): L2(u) within
    1e-6 relative, the same residual history.  (The mixed route over 2
    shards is held to dgtpu's in test_torch_slice.py.)"""
    import chip_smoke
    if kind == "flagship":
        from dgtpu_torch.settings import load_params
        params = load_params()
        params["visualization"]["export"] = False
        params["logging"]["loglevel"] = "ERROR"
        params["performance"]["n_shards"] = 4
        shards = 4
    else:
        shards = 2
        params = _api_params(shards, fvm=True)
    ref, port = _both(params, monkeypatch, tmp_path)
    assert port.cycle_kind == "sharded full precision"
    assert [str(d) for d in port.mesh.devices] == ["cpu"] * shards
    assert port.L2_error_u == pytest.approx(ref.L2_error_u, rel=1e-6)
    assert len(port.residuals) == len(ref.residuals)
    assert _rel(port.residuals, ref.residuals) < 1e-10
    if kind == "flagship":
        assert port.cycles == len(ref.residuals) - 1 == \
            chip_smoke.DGTPU_SHARDED_CYCLES_8X8_P5


def test_fvm_tile_misalignment_errors(tmp_path, monkeypatch):
    """4 shards leave 2 fine FVM rows per shard, not a whole 4-row tile: the
    port raises dgtpu's ValueError."""
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    dg = tapi.DGFEM(device="cpu", settings=TSettings(_api_params(4, fvm=True)),
                    solve_multigrid=True)
    with pytest.raises(ValueError, match=r"geometric_fvm transfer tiles \(4->2 rows\) "
                                         r"do not align with 4 devices"):
        dg.solve()


def test_shards_warn_outside_multigrid(tmp_path, monkeypatch):
    """``n_shards`` with a non-multigrid method warns and solves on one
    device, in both packages, with the same L2(u)."""
    import chip_smoke
    from dgtpu.api import DGFEM as JDGFEM
    from dgtpu.settings import Settings
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    params = _api_params(4)
    params["logging"]["loglevel"] = "WARNING"
    seen = {name: chip_smoke._Messages() for name in ("dgtpu.api", "dgtpu_torch.api")}
    for name, handler in seen.items():
        logging.getLogger(name).addHandler(handler)
    try:
        ref = JDGFEM(settings=Settings(copy.deepcopy(params)), solve_direct=True)
        ref.solve()
        port = tapi.DGFEM(device="cpu", settings=TSettings(copy.deepcopy(params)),
                          solve_direct=True)
        port.solve()
    finally:
        for name, handler in seen.items():
            logging.getLogger(name).removeHandler(handler)
    for handler in seen.values():
        assert ("performance.n_shards only applies to the multigrid solver; running "
                "direct single-device") in handler.messages
    assert port.L2_error_u == pytest.approx(ref.L2_error_u, rel=1e-10)
