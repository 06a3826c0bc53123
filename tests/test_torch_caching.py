"""The port's operator caching (``caching: enabled``), on the CPU: a round
trip through the cache, every level of a multigrid hierarchy, the Stokes
parts and the element coordinates; invalidation when sigma or the settings
change; a corrupt file read as a miss; a file that dgtpu writes is never
read by the port (its own directory, ``cache/dgtpu_torch``); and a cache
hit under the physical-element orthonormal basis.
"""

import os

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
import dgtpu_torch.api as tapi
import dgtpu_torch.models.stokes as stokes_mod
from dgtpu_torch.geometry import Geometry
from dgtpu_torch.level import GridLevel
from dgtpu_torch.settings import Settings, load_params
from dgtpu_torch.utils import caching
from tests.conftest import INPUT_DIR

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _dirs(tmp_path, monkeypatch):
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    monkeypatch.setattr(caching, "CACHE_ROOT", str(tmp_path / "cache" / "dgtpu_torch"))


def _params(**over):
    """dgtpu's make_settings (tests/test_aux_subsystems.py) with caching on."""
    params = load_params()
    params["grid"]["filename"] = "Rectangle_4X4_nPoly1.xyz"
    params["grid"]["polynomial degree"] = 1
    params["solution"]["u"]["polynomial degree"] = 2
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    params["caching"]["enabled"] = True
    for path, value in over.items():
        node = params
        *keys, leaf = path.split(".")
        for k in keys:
            node = node[k]
        node[leaf] = value
    return params


def _no_assembly(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("assembly ran despite a warm cache")
    monkeypatch.setattr(tapi, "assemble_poisson", boom)


def test_operator_cache_roundtrip(monkeypatch):
    dg1 = tapi.DGFEM(device="cpu", settings=Settings(_params()), solve_direct=True)
    u1 = dg1.solve()
    files = os.listdir(caching.cache_dir())
    assert files == [caching.cache_key(dg1.levels[-1], "Poisson") + ".npz"]
    assert len(os.listdir(caching.grid_cache_dir())) == 1
    with monkeypatch.context() as mp:
        _no_assembly(mp)
        dg2 = tapi.DGFEM(device="cpu", settings=Settings(_params()), solve_direct=True)
    lvl = dg2.levels[-1]
    assert lvl.op.blocks.device == lvl.rhs.device == lvl.device
    assert torch.equal(lvl.op.blocks, dg1.levels[-1].op.blocks)
    assert torch.equal(dg2.solve(), u1)


def test_cache_covers_all_multigrid_levels(monkeypatch):
    """Every DG level of the hierarchy is cached; a second construction
    assembles nothing and solves to the same numbers."""
    over = {"solver.multigrid.geometric coarsening.enabled": False,
            "solver.multigrid.polynomial coarsening.levels.u": "1,2"}
    dg1 = tapi.DGFEM(device="cpu", settings=Settings(_params(**over)),
                     solve_multigrid=True)
    files = set(os.listdir(caching.cache_dir()))
    assert {caching.cache_key(l, "Poisson") + ".npz" for l in dg1.levels} == files
    with monkeypatch.context() as mp:
        _no_assembly(mp)
        dg2 = tapi.DGFEM(device="cpu", settings=Settings(_params(**over)),
                         solve_multigrid=True)
    assert torch.equal(dg1.solve(), dg2.solve())


def test_cache_invalidated_on_sigma_and_settings_change():
    """sigma (from the penalty multipliers) changes the key and the
    fingerprint; a settings change outside the key misses on the
    fingerprint."""
    s = Settings(_params())
    geom = Geometry(os.path.join(INPUT_DIR, "Rectangle_4X4_nPoly1.xyz"), s)
    lvl_a = GridLevel(geom, s, ["u"], {"u": 2}, sigma=9.0)
    lvl_b = GridLevel(geom, s, ["u"], {"u": 2}, sigma=18.0)
    assert caching.cache_key(lvl_a, "Poisson") != caching.cache_key(lvl_b, "Poisson")
    assert caching._fingerprint(lvl_a) != caching._fingerprint(lvl_b)
    dg = tapi.DGFEM(device="cpu", settings=Settings(_params()), solve_direct=True)
    lvl = dg.levels[-1]
    assert caching.load_operator(lvl, "Poisson") is not None
    lvl.settings.update_setting("problem.kinematic_viscosity", 3.14)
    assert caching.load_operator(lvl, "Poisson") is None


def test_corrupt_file_is_a_miss(monkeypatch):
    dg = tapi.DGFEM(device="cpu", settings=Settings(_params()), solve_direct=True)
    path = os.path.join(caching.cache_dir(),
                        caching.cache_key(dg.levels[-1], "Poisson") + ".npz")
    with open(path, "wb") as f:
        f.write(b"PK\x03\x04 truncated")
    assert caching.load_operator(dg.levels[-1], "Poisson") is None
    calls = []
    real = tapi.assemble_poisson
    monkeypatch.setattr(tapi, "assemble_poisson",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    again = tapi.DGFEM(device="cpu", settings=Settings(_params()), solve_direct=True)
    assert calls == [1]                 # reassembled, and the file rewritten
    assert caching.load_operator(again.levels[-1], "Poisson") is not None


def test_dgtpus_cache_is_never_read(tmp_path, monkeypatch):
    """The keys are dgtpu's, the directory is not: with dgtpu's cache filled
    under the same root, the port misses and assembles its own."""
    import dgtpu.utils.caching as jcaching
    from dgtpu.api import DGFEM as JDGFEM
    from dgtpu.settings import Settings as JSettings

    def j_dir(sub):
        path = tmp_path / "cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        return str(path)

    monkeypatch.setattr(jcaching, "_repo_cache_dir", j_dir)
    ref = JDGFEM(settings=JSettings(_params()), solve_direct=True)
    j_files = os.listdir(j_dir("discrete_system"))
    calls = []
    real = tapi.assemble_poisson
    monkeypatch.setattr(tapi, "assemble_poisson",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    port = tapi.DGFEM(device="cpu", settings=Settings(_params()), solve_direct=True)
    assert calls == [1]
    key = caching.cache_key(port.levels[-1], "Poisson") + ".npz"
    assert j_files == [key] == os.listdir(caching.cache_dir())
    assert caching.cache_dir() != j_dir("discrete_system")
    assert caching.grid_cache_dir() != j_dir("grid")
    assert float(port.solve().abs().max()) > 0 and ref is not None


def test_stokes_cache_roundtrip(monkeypatch):
    """Stokes caches the A/D/G blocks, the right-hand side and Epsilon; the
    second assembly comes from the cache and gives the same system."""
    params = chip_smoke.stokes_params(4)
    params["caching"]["enabled"] = True
    params["performance"]["precision"] = "full"
    params = yaml.safe_load(yaml.safe_dump(params))
    dg1 = tapi.DGFEM(device="cpu", settings=Settings(params), solve_direct=True)
    with monkeypatch.context() as mp:
        mp.setattr(stokes_mod, "_element_blocks", lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("Stokes assembly ran despite a warm cache")))
        dg2 = tapi.DGFEM(device="cpu", settings=Settings(params), solve_direct=True)
    a, b = dg1.levels[-1], dg2.levels[-1]
    for c in ("block_A", "block_D", "block_G"):
        assert torch.equal(getattr(a, c).blocks, getattr(b, c).blocks)
    assert torch.equal(a.rhs, b.rhs) and a.Epsilon == b.Epsilon
    assert torch.equal(dg1.solve(), dg2.solve())


def test_element_coords_cache():
    """Content-addressed by the node lattice: a second level loads the same
    coordinates, a moved lattice misses, caching off reads and writes
    nothing."""
    s = Settings(_params())
    geom = Geometry(os.path.join(INPUT_DIR, "Rectangle_4X4_nPoly1.xyz"), s)
    lvl1 = GridLevel(geom, s, ["u"], {"u": 2})
    args = (geom.x, geom.y, geom.Ni, geom.Nj, geom.P_grid)
    assert caching.load_element_coords(s, *args) is not None
    lvl2 = GridLevel(geom, s, ["u"], {"u": 2})
    assert np.array_equal(lvl1.X, lvl2.X) and np.array_equal(lvl1.Y, lvl2.Y)
    assert caching.load_element_coords(s, geom.x + 1e-3, *args[1:]) is None
    off = Settings(_params(**{"caching.enabled": False}))
    assert caching.load_element_coords(off, *args) is None
    assert caching.save_element_coords(off, *args, lvl1.X, lvl1.Y) is None


def test_cache_hit_keeps_the_orthonormal_basis():
    """A cache hit rebuilds the level's physical-element orthonormal basis,
    so the nodal values of the cached run are the assembled run's (on the
    curvilinear O-grid, where the basis differs from element to element),
    and both runs' L2(u) is dgtpu's assembled run's within 1e-10 relative.
    dgtpu's Poisson cache hit skips the basis and evaluates the same modal
    solution in the standard tables, so its cached L2(u) differs from its
    assembled one: dgtpu is run with caching off here."""
    import yaml

    from dgtpu.api import DGFEM as JDGFEM
    from dgtpu.settings import Settings as JSettings
    over = {"grid.filename": "CircleInCircle_4X4_nPoly2.xyz", "grid.polynomial degree": 2,
            "grid.O grid": True, "grid.circular": True,
            "problem.SIP penalty parameter multiplier": 2,
            "problem.orthonormal on physical element": True}
    ref = JDGFEM(settings=JSettings(yaml.safe_load(yaml.safe_dump(
        _params(**over, **{"caching.enabled": False})))), solve_direct=True)
    ref.solve()
    runs = []
    for _ in range(2):
        dg = tapi.DGFEM(device="cpu", settings=Settings(_params(**over)), solve_direct=True)
        dg.solve()
        runs.append(dg)
    assert runs[1].levels[-1].element_basis is not None
    assert runs[1].L2_error_u == runs[0].L2_error_u
    assert np.array_equal(runs[1].u_nodal, runs[0].u_nodal)
    assert abs(runs[0].L2_error_u - ref.L2_error_u) < 1e-10 * ref.L2_error_u
