"""dgtpu_torch's Stokes assembly against dgtpu's on the same grid and
settings: every level of the 4x4 p_u=2/p_p=1 hierarchy (the Stokes
flagship's settings, ``bench._stokes_settings(4)``: p 2->1 plus one 2x2
geometric level, global ordering).

Bar: < 1e-12 relative (the ROADMAP's bar for the Poisson assembly); the
data-movement pieces (neighbor maps, reorderings) agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from dgtpu.api import DGFEM as JDGFEM
from dgtpu.parallel.stokes_halo import _dg_diag_blocks as j_dg_diag_blocks
from dgtpu.models.stokes import (pressure_mean_shift as j_mean_shift,
                                 reorder_global_to_local as j_to_local)

import dgtpu_torch.api as tapi
from dgtpu_torch.mms import ManufacturedSolution
from dgtpu_torch.models import stokes as tstokes
from dgtpu_torch.settings import Settings

torch.set_num_threads(1)
TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def port_settings(n, **overrides):
    """The port's Settings for dgtpu's Stokes flagship settings at n x n."""
    params = bench._stokes_settings(n).to_dict()
    params["performance"]["precision"] = "mixed"
    for path, value in overrides.items():
        node = params
        *keys, leaf = path.split(".")
        for k in keys:
            node = node[k]
        node[leaf] = value
    return Settings(params)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    ref = JDGFEM(settings=bench._stokes_settings(4), solve_multigrid=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "OUTPUT_ROOT", str(tmp_path_factory.mktemp("out")))
        port = tapi.DGFEM(device="cpu", settings=port_settings(4),
                          solve_multigrid=True)
    return ref, port


def test_hierarchy_matches(pair):
    ref, port = pair
    assert port.transfer_types == ref.transfer_types == ["geometric", "polynomial"]
    assert [(l.Nj, l.Ni, l.P_sol, l.N_DOF_sol_tot, l.sigma, l.gamma)
            for l in port.levels] == \
        [(l.Nj, l.Ni, l.P_sol, l.N_DOF_sol_tot, l.sigma, l.gamma) for l in ref.levels]


@pytest.mark.parametrize("k", [0, 1, 2])
def test_blocks_match(pair, k):
    ref, port = pair
    for name in ("block_A", "block_D", "block_G"):
        t, j = getattr(port.levels[k], name), getattr(ref.levels[k], name)
        assert t.blocks.shape == j.blocks.shape, name
        assert _rel(t.blocks, j.blocks) < TOL, name
        assert np.array_equal(t.nbr.numpy(), np.asarray(j.nbr))
        assert np.array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert port.levels[k].op.pin is ref.levels[k].op.pin is False


@pytest.mark.parametrize("k", [0, 1, 2])
def test_dg_diag_blocks_match(pair, k):
    ref, port = pair
    t, j = port.levels[k], ref.levels[k]
    got = tstokes._dg_diag_blocks(t.block_D, t.block_G)
    assert _rel(got, j_dg_diag_blocks(j.block_D, j.block_G)) < TOL


@pytest.mark.parametrize("k", [0, 1])
def test_transfers_match(pair, k):
    ref, port = pair
    rng = np.random.default_rng(k)
    fine, coarse = ref.levels[k + 1], ref.levels[k]
    x = rng.standard_normal(fine.N * fine.N_DOF_sol_tot)
    e = rng.standard_normal(coarse.N * coarse.N_DOF_sol_tot)
    t, j = port.transfers[k], ref.transfers[k]
    assert t.kind == j.kind
    assert _rel(t.restrict(torch.as_tensor(x)), j.restrict(x)) < TOL
    assert _rel(t.prolong(torch.as_tensor(e)), j.prolong(e)) < TOL


def test_rhs_and_epsilon_match(pair):
    ref, port = pair
    assert _rel(port.levels[-1].rhs, ref.levels[-1].rhs) < TOL
    for t, j in zip(port.levels, ref.levels):
        assert abs(t.Epsilon - j.Epsilon) < 1e-14
    assert [l.rhs is None for l in port.levels] == [True, True, False]


def test_mms_fields_match(pair):
    ref, port = pair
    assert port.exact_p_mean == pytest.approx(ref.exact_p_mean, rel=TOL, abs=1e-15)
    rng = np.random.default_rng(3)
    x, y = rng.uniform(-1, 1, (2, 5, 6))
    tm, jm = port.mms, ref.mms
    for name in ("u", "v", "p_raw", "p"):
        assert _rel(getattr(tm, name)(x, y), getattr(jm, name)(x, y)) < TOL, name
    for c in (0, 1):
        assert _rel(tm.f_momentum[c](x, y), jm.f_momentum[c](x, y)) < TOL
    # the divergence vanishes: compare absolutely
    assert np.abs(tm.f_continuity(x, y).numpy()
                  - np.asarray(jm.f_continuity(x, y))).max() < 1e-12


def test_mms_divergence_check():
    m = ManufacturedSolution({"u": "x", "v": "y", "p": "0.0"}, "Stokes", 1.0)
    with pytest.raises(ValueError, match="divergence-free"):
        m.check_divergence_free()
    assert ManufacturedSolution({"u": "y", "v": "x", "p": "x*y"}, "Stokes",
                                1.0).check_divergence_free()


def test_saddle_operator_matches(pair):
    ref, port = pair
    rng = np.random.default_rng(5)
    for t, j in zip(port.levels, ref.levels):
        x = rng.standard_normal(t.N * t.N_DOF_sol_tot)
        assert _rel(t.op.matvec(torch.as_tensor(x)), j.op.matvec(x)) < TOL
    t, j = port.levels[0], ref.levels[0]
    pinned = tstokes.StokesGlobalOperator(t.block_A, t.block_D, t.block_G, pin=True)
    from dataclasses import replace
    assert _rel(pinned.to_dense(), replace(j.op, pin=True).to_dense()) < TOL
    x = rng.standard_normal(t.N * t.N_DOF_sol_tot)
    assert _rel(pinned.matvec(torch.as_tensor(x)),
                replace(j.op, pin=True).matvec(x)) < TOL


def test_reorder_and_pressure_shift_match(pair):
    ref, port = pair
    t, j = port.levels[-1], ref.levels[-1]
    v = np.random.default_rng(7).standard_normal(t.N * t.N_DOF_sol_tot)
    local = tstokes.reorder_global_to_local(t, torch.as_tensor(v))
    assert np.array_equal(local.numpy(), np.asarray(j_to_local(j, v)))
    assert np.array_equal(tstokes.reorder_local_to_global(t, local).numpy(), v)
    u_el = local.reshape(t.N, t.N_DOF_sol_tot)
    assert _rel(tstokes.pressure_mean_shift(t, u_el),
                j_mean_shift(j, jnp.asarray(u_el.numpy()))) < TOL


def test_local_ordering_raises(pair):
    """Local ordering assembles (the test keeps the name it had while it
    raised): one stencil of (2Nu + Np) blocks holding the global-order
    level's A, D and G blocks, the pressure pin for the direct solve, and
    no component stencils set by it."""
    _, port = pair
    lvl = port.levels[0]
    saved = (lvl.settings.solution.ordering, lvl.op, lvl.rhs)
    A, D, G = lvl.block_A, lvl.block_D, lvl.block_G
    nu2 = 2 * lvl.N_DOF_sol["u"]
    lvl.settings.solution.ordering = "local"
    try:
        for direct in (False, True):
            op = tstokes.assemble_stokes(lvl, direct=direct)
            b = op.blocks.clone()
            assert b.shape[2:] == (lvl.N_DOF_sol_tot,) * 2
            assert (lvl.block_A, lvl.block_D, lvl.block_G) == (A, D, G)
            assert torch.equal(op.nbr, A.nbr) and torch.equal(op.mask, A.mask)
            assert b[0, 0, nu2, nu2] == (1.0 if direct else 0.0)
            b[0, 0, nu2, nu2] = 0.0
            assert _rel(b[:, :, :nu2, :nu2], A.blocks) < TOL
            assert _rel(b[:, :, nu2:, :nu2], D.blocks) < TOL
            assert _rel(b[:, :, :nu2, nu2:], G.blocks) < TOL
            assert not b[:, :, nu2:, nu2:].any()
    finally:
        lvl.settings.solution.ordering, lvl.op, lvl.rhs = saved
