"""dgtpu_torch assembly against dgtpu on the same grids.

Geometry terms, topology, the Poisson SIP operator, the MMS right-hand side,
the inverse mass matrices and h-coarsened levels must agree to 1e-12
relative (the README's oracle bar); the manufactured source from torch
autograd must agree with dgtpu's jax.grad source.
"""

import os

import numpy as np
import pytest
import torch

from dgtpu.geometry import Geometry as JGeometry
from dgtpu.geometry import generate_rectangle_grid as j_generate
from dgtpu.level import CoarseGridLevel as JCoarseLevel
from dgtpu.level import GridLevel as JGridLevel
from dgtpu.mms import ManufacturedSolution as JMMS
from dgtpu.models.poisson import assemble_poisson as j_assemble
from dgtpu.ops.transfer import make_transfer as j_make_transfer
from dgtpu.settings import Settings as JSettings
from dgtpu.settings import load_params

from dgtpu_torch import geometry as tgeo
from dgtpu_torch.level import CoarseGridLevel, GridLevel
from dgtpu_torch.mms import ManufacturedSolution, parse_expression
from dgtpu_torch.models.poisson import assemble_poisson
from dgtpu_torch.ops.transfer import make_transfer
from dgtpu_torch.settings import Settings

torch.set_num_threads(1)

INPUT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "input")
TOL = 1e-12
GRIDS = [("Rectangle_4X4_nPoly2.xyz", False),
         ("Rectangle_8X8_nPoly2.xyz", False),
         ("CircleInCircle_4X4_nPoly2.xyz", True)]


def _rel(a, b, floor=1e-300):
    """max |a - b| relative to max |b| (or to ``floor`` where b is ~0, as
    the cross metric terms of a rectangle are)."""
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), floor)


def _params(fname, o_grid):
    params = load_params()
    params["grid"]["filename"] = fname
    params["grid"]["polynomial degree"] = 2
    params["grid"]["O grid"] = o_grid
    params["grid"]["circular"] = o_grid
    params["solution"]["u"]["polynomial degree"] = 2
    params["logging"]["loglevel"] = "ERROR"
    return params


@pytest.fixture(scope="module", params=GRIDS, ids=[g[0] for g in GRIDS])
def pair(request):
    fname, o_grid = request.param
    params = _params(fname, o_grid)
    js, ts = JSettings(params), Settings(params)
    path = os.path.join(INPUT_DIR, fname)
    jg, tg = JGeometry(path, js), tgeo.Geometry(path, ts)
    exact = {"u": params["problem"]["exact solution"]["u"]}
    sigma = 9.0 * (2 if o_grid else 1)
    jl = JGridLevel(jg, js, ["u"], {"u": 2}, sigma)
    tl = GridLevel(tg, ts, ["u"], {"u": 2}, sigma, device="cpu")
    j_out = j_assemble(jl, JMMS(exact, "Poisson", 1.0))
    t_out = assemble_poisson(tl, ManufacturedSolution(exact, "Poisson", 1.0))
    jc = JCoarseLevel(jg, jl, js, ["u"], 2)
    tc = CoarseGridLevel(tg, tl, ts, ["u"], 2, device="cpu")
    return dict(jl=jl, tl=tl, j=j_out, t=t_out, jc=jc, tc=tc,
                jc_op=j_assemble(jc)[0], tc_op=assemble_poisson(tc)[0])


def test_geometry_terms_match(pair):
    jgt, tgt = pair["jl"].gt, pair["tl"].gt
    for side in ("e", "imin", "imax", "jmin", "jmax"):
        for key, val in jgt["u"][side].items():
            assert _rel(tgt["u"][side][key], val, floor=1.0) < TOL, (side, key)
    assert _rel(tgt["A"], jgt["A"]) < TOL


def test_topology_matches(pair):
    jop, top = pair["j"][0], pair["t"][0]
    assert np.array_equal(top.nbr.numpy(), np.asarray(jop.nbr))
    assert np.array_equal(top.mask.numpy(), np.asarray(jop.mask))


def test_operator_blocks_match(pair):
    assert _rel(pair["t"][0].blocks, pair["j"][0].blocks) < TOL


def test_rhs_matches(pair):
    assert _rel(pair["t"][1], pair["j"][1]) < TOL


def test_inverse_mass_matches(pair):
    assert _rel(pair["t"][2], pair["j"][2]) < TOL


def test_coarse_level_matches(pair):
    assert _rel(pair["tc"].X, pair["jc"].X) < TOL
    assert _rel(pair["tc_op"].blocks, pair["jc_op"].blocks) < TOL


def test_matvec_and_dense_match(pair):
    jop, top = pair["j"][0], pair["t"][0]
    u = np.random.default_rng(0).standard_normal(top.shape[1])
    assert _rel(top.matvec(torch.as_tensor(u)), jop.matvec(u)) < TOL
    assert _rel(top.to_dense(), jop.to_dense()) < TOL


EXPRESSIONS = ["-2*sin(pi*x)**2*sin(pi*y)*cos(pi*y)",
               "sin(pi*x)*sin(pi*y)",
               "x**2 + y**3 - x*y",
               "exp(x)*cos(2*y) + sqrt(x*x + 1)",
               "y**2"]


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_mms_source_matches_jax_grad(expr):
    rng = np.random.default_rng(0)
    x, y = rng.uniform(-1, 1, (2, 6, 7))
    jm = JMMS({"u": expr}, "Poisson", 0.7)
    tm = ManufacturedSolution({"u": expr}, "Poisson", 0.7)
    assert _rel(tm.u(x, y), jm.u(x, y)) < TOL
    assert _rel(tm.f_momentum[0](x, y), jm.f_momentum[0](x, y)) < 1e-12


def test_parse_expression_guards():
    f = parse_expression("2*x + y", {})
    assert float(f(torch.tensor(1.0), torch.tensor(3.0))) == 5.0
    assert float(parse_expression(1.5)(torch.tensor(0.0), None)) == 1.5
    with pytest.raises(ValueError):
        parse_expression("__import__('os')")
    with pytest.raises(NotImplementedError):
        ManufacturedSolution({"u": "x"}, "Navier-Stokes", 1.0)


@pytest.mark.parametrize("kind, kw", [
    ("penalty", dict(p_fine=2)),
    ("polynomial", dict(p_fine=5, p_coarse=3)),
    ("polynomial", dict(p_fine=3, p_coarse=1)),
    ("geometric", dict(p_fine=1, Ni_c=4, Nj_c=4)),
    ("geometric", dict(p_fine=2, Ni_c=2, Nj_c=4)),
])
def test_transfers_match(kind, kw):
    j = j_make_transfer(kind, **kw)
    # the port's transfers carry no tile grid: the SoA cycle derives it
    t = make_transfer(kind, **{k: v for k, v in kw.items() if k not in ("Ni_c", "Nj_c")})
    assert t.kind == j.kind
    assert np.array_equal(t.R.numpy(), np.asarray(j.R))
    assert np.array_equal(t.P.numpy(), np.asarray(j.P))


def test_plot3d_roundtrip_and_generator(tmp_path):
    x, y = tgeo.generate_rectangle_grid(3, 2, 2)
    jx, jy = j_generate(3, 2, 2)
    assert np.array_equal(x, jx) and np.array_equal(y, jy)
    path = str(tmp_path / "g.xyz")
    tgeo.write_plot3d(path, x, y)
    rx, ry = tgeo.read_plot3d(path)
    assert np.array_equal(rx, x) and np.array_equal(ry, y)


def test_settings_tree_matches():
    assert Settings(load_params()).to_dict() == JSettings(load_params()).to_dict()
