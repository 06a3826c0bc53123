"""dgtpu_torch's Stokes SoA cycle (plain torch path, float64) against dgtpu's
SoAStokesVCycle on the same operators: the (2,2), (4,4), (4,4) hierarchy of
the 4x4 p_u=2/p_p=1 Stokes flagship settings (``bench._stokes_settings(4)``,
the hierarchy of tests/test_pallas_stokes.py).

The hierarchy is carried across with ``convert.from_dgtpu_stokes_arrays``,
so the cycle is tested apart from assembly.  dgtpu's side is its
``build_xla`` cycle (its interpret-mode kernel is too slow for this lane).
Bars: packing element for element; cycles, FMG and the matvec < 1e-11
relative (dgtpu's own bar between its Stokes cycle builds,
tests/test_pallas_stokes.py:73).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from dgtpu.api import DGFEM as JDGFEM
from dgtpu.ops.pallas_stokes import SoAStokesVCycle as JStokes

from dgtpu_torch.convert import from_dgtpu_stokes_arrays
from dgtpu_torch.ops import soa, stokes_soa
from dgtpu_torch.ops.stokes_soa import SoAStokesVCycle
from dgtpu_torch.settings import Settings

torch.set_num_threads(1)
TOL = 1e-11


@pytest.fixture(scope="module")
def hier():
    dg = JDGFEM(settings=bench._stokes_settings(4), solve_multigrid=True)
    levels = [dict(p_u=l.P_sol["u"], p_p=l.P_sol["p"], **{
        c: dict(blocks=np.asarray(op.blocks), nbr=np.asarray(op.nbr),
                mask=np.asarray(op.mask))
        for c, op in (("A", l.block_A), ("D", l.block_D), ("G", l.block_G))})
        for l in dg.levels]
    transfers = []
    for t in dg.transfers:
        if t.kind == "polynomial":
            transfers.append(dict(kind="polynomial", Ru=np.asarray(t.Ru),
                                  Rp=np.asarray(t.Rp)))
        else:
            transfers.append(dict(kind=t.kind, **{
                c: dict(R=np.asarray(tb.R), P=np.asarray(tb.P))
                for c, tb in (("tu", t.tu), ("tp", t.tp))}))
    dims = [(l.Nj, l.Ni) for l in dg.levels]
    return dg, from_dgtpu_stokes_arrays(levels, transfers, dims)


_BUILT = {}


def _pair(hier, cycle="W", coarse="direct", **kw):
    """(dgtpu SoAStokesVCycle, port SoAStokesVCycle), both float64, same
    operators; dgtpu's builder is made once per configuration."""
    dg, (levels, transfers) = hier
    s = copy.deepcopy(dg.settings)
    s.solver.multigrid.cycle_type = cycle
    s.solver.multigrid.coarse_grid_solver = coarse
    if (cycle, coarse) not in _BUILT:
        _BUILT[cycle, coarse] = JStokes(dg.levels, dg.transfers, dg.transfer_types,
                                        s, dtype=jnp.float64)
    t = SoAStokesVCycle(levels, transfers, dg.transfer_types, Settings(s.to_dict()),
                        dtype=torch.float64, **kw)
    return _BUILT[cycle, coarse], t


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _cycles(fn, rhs, n=2):
    u = rhs * 0
    for _ in range(n):
        u = fn(rhs, u)
    return np.asarray(u)


def test_packing_matches(hier):
    j, t = _pair(hier)
    assert t.periodic == j.periodic == [False] * j.n_lev
    for k, lv in enumerate(t.levels):
        for name in ("A", "G", "D", "A_Dinv", "DG_diag", "DG_Dinv"):
            for c in (0, 1):
                assert np.array_equal(getattr(lv, name)[c].numpy(),
                                      np.asarray(getattr(j, name)[k][c])), (k, name)
        assert np.array_equal(lv.masks.numpy(), np.asarray(j.masks[k]))
    for k, tr in enumerate(t.transfers):
        if tr.kind == "polynomial":
            for ours, theirs in ((t.R[k], j.soa_R[k]), (t.P[k], j.soa_P[k])):
                for a, b in zip(ours, theirs):
                    assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("restrict", [True, False])
def test_geo_transfer_matches_dense_lane_tensors(hier, restrict):
    """K4's plain version with per-child R4/P4, per component, against
    dgtpu's dense cross-lane transfer tensors applied with numpy."""
    j, t = _pair(hier)
    k = t.types.index("geometric")
    rng = np.random.default_rng(1)
    for comp, T in enumerate(j._geo_tensors(k, j.transfers[k], restrict)):
        T = np.asarray(T)                    # (2, 2, Bin, Bout, Cout, Cin)
        x = rng.standard_normal((2, T.shape[2], T.shape[5]))
        ref = np.einsum("oibaqp,ibp->oaq", T, x)
        T4 = (t.R if restrict else t.P)[k][comp]
        got = soa.geo_transfer_plain(T4, torch.as_tensor(x), t.dims[k], restrict)
        assert _rel(got, ref) < 1e-14


def test_coarse_matrix_matches(hier):
    """The pinned dense saddle inverse in SoA order against dgtpu's
    (2, 2, B0, B0, C0, C0) coarse tensor, element for element."""
    j, t = _pair(hier)
    T = np.asarray(j.coarse)
    nj0, ni0 = t.dims[0]
    C0, nu2, npd = nj0 * ni0 // 2, 2 * t.nu[0], t.npd[0]

    def pos(c, a, q):
        if a < nu2:
            return c * nu2 * C0 + a * C0 + q
        return 2 * nu2 * C0 + c * npd * C0 + (a - nu2) * C0 + q

    B0 = nu2 + npd
    c, a, q = np.meshgrid(np.arange(2), np.arange(B0), np.arange(C0), indexing="ij")
    idx = np.vectorize(pos)(c, a, q)                  # (2, B0, C0)
    W = t.coarse_W.numpy()
    got = W[idx[:, :, :, None, None, None], idx[None, None, None, :, :, :]]
    # T[co, ci, b, a, qo, qi] = inv[row(co, a, qo), row(ci, b, qi)]
    assert np.array_equal(got, np.transpose(T, (0, 3, 4, 1, 2, 5)))


def test_soa_layout_roundtrip(hier):
    j, t = _pair(hier)
    v = np.random.default_rng(0).standard_normal(t.levels[-1].nj * t.levels[-1].ni
                                                 * (2 * t.nu[-1] + t.npd[-1]))
    uv, p = t.to_soa(torch.as_tensor(v))
    ref = j._to_soa(jnp.asarray(v))
    for c in (0, 1):
        assert np.array_equal(uv[c].numpy(), np.asarray(ref[c]))
        assert np.array_equal(p[c].numpy(), np.asarray(ref[2 + c]))
    assert np.array_equal(t.from_soa(uv, p).numpy(), v)


def test_w_cycle_matches_build_xla(hier):
    """W-cycles with the direct coarse solve (the V-cycles with the smoother
    coarse solve, and FMG, are in test_torch_stokes_fmg.py)."""
    j, t = _pair(hier)
    rhs = np.array(hier[0].levels[-1].rhs)
    ref = _cycles(j.build_xla(), jnp.asarray(rhs))
    assert _rel(_cycles(t, torch.as_tensor(rhs)), ref) < TOL


def test_matvec_matches(hier):
    dg = hier[0]
    j, t = _pair(hier)
    x = np.random.default_rng(7).standard_normal(dg.levels[-1].rhs.shape[0])
    y_ref = np.asarray(dg.levels[-1].op.matvec(jnp.asarray(x)))
    assert _rel(t.build_matvec()(torch.as_tensor(x)), y_ref) < TOL
    assert _rel(hier[1][0][-1].op.matvec(torch.as_tensor(x)), y_ref) < TOL


def test_validation_errors(hier):
    dg, (levels, transfers) = hier
    s = copy.deepcopy(dg.settings)
    s.solver.multigrid.polynomial_coarsening.pre_smoother.smoother = "jacobi"
    with pytest.raises(ValueError, match="distributive"):
        SoAStokesVCycle(levels, transfers, dg.transfer_types, Settings(s.to_dict()))
    s = Settings(dg.settings.to_dict())
    odd = copy.copy(levels[-1])
    odd.Ni = 3
    with pytest.raises(ValueError, match="even Ni"):
        SoAStokesVCycle(levels[:-1] + [odd], transfers, dg.transfer_types, s)
    bare = copy.copy(levels[-1])
    bare.block_A = None
    with pytest.raises(ValueError, match="global-order"):
        SoAStokesVCycle(levels[:-1] + [bare], transfers, dg.transfer_types, s)


def test_cpu_tensors_take_the_plain_path(hier):
    """On CPU tensors every wrapper runs its plain version and counts no
    kernel launch; the reference cycle is the same computation."""
    _, t = _pair(hier)
    _, ref = _pair(hier, reference=True)
    soa.reset_launch_counts()
    stokes_soa.reset_launch_counts()
    rhs = torch.as_tensor(np.array(hier[0].levels[-1].rhs))
    assert np.array_equal(_cycles(t, rhs), _cycles(ref, rhs))
    assert [k.launches for k in stokes_soa.CYCLE_KERNELS] == [0] * 5
