"""dgtpu_torch's SoA cycle (plain torch path, float64) against dgtpu's
SoAVCycle on the same operators (4x4 p=2 rectangle: p 2->1 plus one
geometric level).

The operators are carried across with ``convert.from_dgtpu_arrays`` so the
cycle is tested apart from assembly.  Bars: packing element for element;
cycles to < 1e-11 relative after 3 cycles (the repo's bar between cycle
builds, tests/test_pallas_soa.py:72-73).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from dgtpu.ops.pallas_soa import SoAVCycle as JSoAVCycle

from dgtpu_torch.convert import from_dgtpu_arrays
from dgtpu_torch.ops import soa
from dgtpu_torch.ops.soa import SoAVCycle

torch.set_num_threads(1)
TOL = 1e-11


@pytest.fixture(scope="module")
def rect():
    return __graft_entry__._flagship(n=4, p_grid=2, p_sol=2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _pair(dg, cycle="V", coarse="smoother", **kw):
    """(dgtpu SoAVCycle, port SoAVCycle), both float64, same operators."""
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
    t = SoAVCycle(ops, trs, dg.transfer_types, s, dims, dtype=torch.float64, **kw)
    return j, t


def _cycles(fn, rhs, n=3):
    u = rhs * 0
    for _ in range(n):
        u = fn(rhs, u)
    return np.asarray(u)


def test_packing_matches(rect):
    j, t = _pair(rect)
    assert t.periodic == j.periodic == [False] * j.n_lev
    for k, lv in enumerate(t.levels):
        for c in (0, 1):
            assert np.array_equal(lv.blocks[c].numpy(), np.asarray(j.soa_blocks[k][c]))
            assert np.array_equal(lv.Dinv[c].numpy(), np.asarray(j.soa_Dinv[k][c]))
        assert np.array_equal(lv.masks.numpy(), np.asarray(j.soa_masks[k]))
    for k, tr in enumerate(rect.transfers):
        # per-child R4/P4 for geometric transfers, R/P for polynomial ones
        assert np.array_equal(t.R[k].numpy(), np.asarray(j.R[k]))
        assert np.array_equal(t.P[k].numpy(), np.asarray(j.P[k]))


def test_soa_layout_roundtrip(rect):
    j, t = _pair(rect)
    v = np.random.default_rng(0).standard_normal(rect.levels[-1].rhs.shape[0])
    packed = t.to_soa(torch.as_tensor(v))
    j0, j1 = j._to_soa(jnp.asarray(v))
    assert np.array_equal(packed.numpy(), np.stack([np.asarray(j0), np.asarray(j1)]))
    assert np.array_equal(t.from_soa(packed).numpy(), v)


@pytest.mark.parametrize("cycle", ["V", "W", "F"])
def test_cycle_matches_build_xla(rect, cycle):
    j, t = _pair(rect, cycle=cycle)
    rhs = np.array(rect.levels[-1].rhs)
    ref = _cycles(j.build_xla(), jnp.asarray(rhs))
    assert _rel(_cycles(t, torch.as_tensor(rhs)), ref) < TOL


def test_direct_coarse_cycle_matches_build_xla(rect):
    j, t = _pair(rect, coarse="direct")
    rhs = np.array(rect.levels[-1].rhs)
    ref = _cycles(j.build_xla(), jnp.asarray(rhs))
    assert _rel(_cycles(t, torch.as_tensor(rhs)), ref) < TOL


def test_cycle_matches_interpret_kernel(rect):
    """dgtpu's Pallas kernel itself, run in interpret mode on the CPU."""
    j, t = _pair(rect)
    rhs = np.array(rect.levels[-1].rhs)
    ref = _cycles(j.build(), jnp.asarray(rhs), n=2)
    assert _rel(_cycles(t, torch.as_tensor(rhs), n=2), ref) < TOL


def test_fmg_matches(rect):
    j, t = _pair(rect)
    rhs = np.array(rect.levels[-1].rhs)
    ref = np.asarray(j.build_fmg()(jnp.asarray(rhs)))
    assert _rel(t.build_fmg()(torch.as_tensor(rhs)), ref) < TOL
    # the finest level's cycle handed in, as the mixed route does
    ref = np.asarray(j.build_fmg(finest_cycle=j.build_xla())(jnp.asarray(rhs)))
    assert _rel(t.build_fmg(finest_cycle=t)(torch.as_tensor(rhs)), ref) < TOL


@pytest.mark.parametrize("restrict", [True, False])
def test_geo_transfer_matches_dense_lane_tensors(rect, restrict):
    """K4's plain version (gathers over children / parents) against dgtpu's
    dense cross-lane transfer tensors, applied with numpy."""
    j, t = _pair(rect)
    k = rect.transfer_types.index("geometric")
    T = np.asarray(j._geo_tensors(k, restrict=restrict))   # (2, 2, Bin, Bout, Cout, Cin)
    x = np.random.default_rng(1).standard_normal((2, T.shape[2], T.shape[5]))
    ref = np.einsum("oibaqp,ibp->oaq", T, x)
    T4 = t.R[k] if restrict else t.P[k]
    got = soa.geo_transfer_plain(T4, torch.as_tensor(x), t.dims[k], restrict)
    assert _rel(got, ref) < 1e-14


def test_rejects_odd_ni(rect):
    dims = [(l.Nj, l.Ni) for l in rect.levels]
    dims[-1] = (dims[-1][0], dims[-1][1] - 1)
    ops, trs = from_dgtpu_arrays(
        [dict(blocks=np.asarray(l.op.blocks)[:d[0] * d[1]], nbr=np.asarray(l.op.nbr),
              mask=np.asarray(l.op.mask)) for l, d in zip(rect.levels, dims)],
        [dict(kind=t.kind, R=np.asarray(t.R), P=np.asarray(t.P))
         for t in rect.transfers], rect.transfer_types, dims)
    with pytest.raises(ValueError, match="even Ni"):
        SoAVCycle(ops, trs, rect.transfer_types, rect.settings, dims)


def test_cpu_tensors_take_the_plain_path(rect):
    """On CPU tensors every wrapper runs its plain version and counts no
    kernel launch; the reference cycle is the same computation."""
    _, t = _pair(rect)
    _, ref = _pair(rect, reference=True)
    soa.reset_launch_counts()
    rhs = torch.as_tensor(np.array(rect.levels[-1].rhs))
    assert np.array_equal(_cycles(t, rhs), _cycles(ref, rhs))
    assert [k.launches for k in soa.KERNELS] == [0, 0, 0, 0]
