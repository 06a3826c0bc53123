"""dgtpu_torch.ops.rolled against dgtpu.ops.rolled, function by function, on
the same numpy-seeded float64 inputs: < 1e-13 relative.

The grids include the shapes that take a branch of their own: Ni = 1 (the
i-rolls are the identity), Ni = 2 (the packed lattice is one cell wide),
an odd Ni, and Nj = 1 (both j-neighbors are zero halos).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgtpu.ops import rolled as jr

from dgtpu_torch.ops import rolled as tr

torch.set_num_threads(1)
TOL = 1e-13
B = 3
GRIDS = [(4, 4), (3, 1), (4, 2), (5, 3), (1, 4), (1, 1)]      # (Nj, Ni)
EVEN_GRIDS = [(4, 4), (4, 2), (1, 4), (3, 6)]


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _inputs(nj, ni, seed=0):
    rng = np.random.default_rng(seed)
    blocks = rng.standard_normal((nj, ni, 5, B, B))
    Dinv = rng.standard_normal((nj, ni, B, B)) / B
    rhs, u = rng.standard_normal((2, nj, ni, B))
    return blocks, Dinv, rhs, u


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.as_tensor(a) for a in arrays]


def test_bmv_batched_and_broadcast():
    rng = np.random.default_rng(1)
    M, v, w = rng.standard_normal((4, 5, 3, 2)), rng.standard_normal((4, 5, 2)), \
        rng.standard_normal(2)
    (jM, jv, jw), (tM, tv, tw) = _both(M, v, w)
    assert _rel(tr.bmv(tM, tv), jr.bmv(jM, jv)) < TOL
    assert _rel(tr.bmv(tM, tw), jr.bmv(jM, jw)) < TOL


def test_layout_reshapes():
    from dgtpu_torch.ops.stencil import StencilOperator
    rng = np.random.default_rng(2)
    blocks = rng.standard_normal((6, 5, B, B))
    op = StencilOperator(torch.as_tensor(blocks), torch.zeros(6, 5, dtype=torch.int64),
                         torch.ones(6, 5, dtype=torch.bool))
    assert np.array_equal(tr.to_rolled(op, 3, 2).numpy(), blocks.reshape(2, 3, 5, B, B))
    v = rng.standard_normal(6 * B)
    assert np.array_equal(tr.vec_to_rolled(torch.as_tensor(v), 3, 2, B).numpy(),
                          np.asarray(jr.vec_to_rolled(jnp.asarray(v), 3, 2, B)))


@pytest.mark.parametrize("nj, ni", GRIDS)
def test_neighbor_fields(nj, ni):
    _, _, _, u = _inputs(nj, ni)
    (ju,), (tu,) = _both(u)
    for up in (True, False):
        assert np.array_equal(tr._shift_j(tu, up).numpy(), np.asarray(jr._shift_j(ju, up)))
    for got, ref in zip(tr.neighbor_fields(tu), jr.neighbor_fields(ju)):
        assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("nj, ni", GRIDS)
def test_matvecs(nj, ni):
    blocks, _, _, u = _inputs(nj, ni)
    (jb, ju), (tb, tu) = _both(blocks, u)
    assert _rel(tr.matvec(tb, tu), jr.matvec(jb, ju)) < TOL
    assert _rel(tr.offdiag_matvec(tb, tu), jr.offdiag_matvec(jb, ju)) < TOL


@pytest.mark.parametrize("nj, ni", GRIDS)
def test_checkerboard_and_masks(nj, ni):
    assert np.array_equal(tr.checkerboard(nj, ni).numpy(), np.asarray(jr.checkerboard(nj, ni)))
    assert np.array_equal(tr.color_masks(nj, ni, torch.float64).numpy(),
                          np.asarray(jr.color_masks(nj, ni, jnp.float64)))


@pytest.mark.parametrize("nj, ni", GRIDS)
def test_masked_sweeps(nj, ni):
    """With an odd Ni the cells across the row's wrap share a color and are
    updated from pre-update values, as dgtpu's masked sweep does."""
    blocks, Dinv, rhs, u = _inputs(nj, ni)
    blocks *= 0.2
    (jb, jd, jrhs, ju), (tb, td, trhs, tu) = _both(blocks, Dinv, rhs, u)
    ref = jr.rb_gs_sweeps_masked(jb, jd, jrhs, ju, jr.color_masks(nj, ni, jnp.float64), 3)
    masks = tr.color_masks(nj, ni, torch.float64)
    assert _rel(tr.rb_gs_sweeps_masked(tb, td, trhs, tu, masks, 3), ref) < TOL
    # one color of one pass, the unit the rolled cycle's kernel computes
    half = tr.rb_half_sweep_masked(tb, td, trhs, tu, masks[0])
    one = tr.rb_half_sweep_masked(tb, td, trhs, half, masks[1])
    assert _rel(one, jr.rb_gs_sweeps_masked(jb, jd, jrhs, ju,
                                            jr.color_masks(nj, ni, jnp.float64), 1)) < TOL


@pytest.mark.parametrize("nj, ni", GRIDS)
def test_jacobi_sweeps(nj, ni):
    blocks, Dinv, rhs, u = _inputs(nj, ni)
    blocks *= 0.2
    (jb, jd, jrhs, ju), (tb, td, trhs, tu) = _both(blocks, Dinv, rhs, u)
    assert _rel(tr.jacobi_sweeps(tb, td, trhs, tu, 3, omega=0.7),
                jr.jacobi_sweeps(jb, jd, jrhs, ju, 3, omega=0.7)) < TOL


@pytest.mark.parametrize("nj, ni", EVEN_GRIDS)
def test_color_packing(nj, ni):
    blocks, Dinv, _, u = _inputs(nj, ni)
    (jb, jd, ju), (tb, td, tu) = _both(blocks, Dinv, u)
    je, te = jr.parity_mask(nj, jnp.float64), tr.parity_mask(nj, torch.float64)
    assert np.array_equal(te.numpy(), np.asarray(je))
    jp, tp = jr.pack_colors(ju, je), tr.pack_colors(tu, te)
    for got, ref in zip(tp, jp):
        assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(tr.unpack_colors(*tp, te).numpy(), u)
    (jbc, jdc), (tbc, tdc) = jr.pack_operator_colors(jb, jd), tr.pack_operator_colors(tb, td)
    for got, ref in zip((*tbc, *tdc), (*jbc, *jdc)):
        assert np.array_equal(got.numpy(), np.asarray(ref))
    assert tr.pack_operator_colors(tb)[1] is None


@pytest.mark.parametrize("nj, ni", EVEN_GRIDS)
def test_split_neighbor_fields(nj, ni):
    """Ni = 2 packs to a lattice one cell wide: the rolls are the identity."""
    _, _, _, u = _inputs(nj, ni)
    (ju,), (tu,) = _both(u)
    je, te = jr.parity_mask(nj, jnp.float64), tr.parity_mask(nj, torch.float64)
    jp, tp = jr.pack_colors(ju, je), tr.pack_colors(tu, te)
    for color in (0, 1):
        for got, ref in zip(tr.split_neighbor_fields(tp[1 - color], color, te),
                            jr.split_neighbor_fields(jp[1 - color], color, je)):
            assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("nj, ni", EVEN_GRIDS)
def test_split_sweeps_and_matvec(nj, ni):
    blocks, Dinv, rhs, u = _inputs(nj, ni)
    blocks *= 0.2
    (jb, jd, jrhs, ju), (tb, td, trhs, tu) = _both(blocks, Dinv, rhs, u)
    je, te = jr.parity_mask(nj, jnp.float64), tr.parity_mask(nj, torch.float64)
    (jbc, jdc), (tbc, tdc) = jr.pack_operator_colors(jb, jd), tr.pack_operator_colors(tb, td)
    ref = jr.rb_gs_sweeps_split(jbc, jdc, jr.pack_colors(jrhs, je),
                                jr.pack_colors(ju, je), je, 3)
    got = tr.rb_gs_sweeps_split(tbc, tdc, tr.pack_colors(trhs, te),
                                tr.pack_colors(tu, te), te, 3)
    for g, r in zip(got, ref):
        assert _rel(g, r) < TOL
    # the split sweep is the masked sweep on packed lattices
    masked = tr.rb_gs_sweeps_masked(tb, td, trhs, tu,
                                    tr.color_masks(nj, ni, torch.float64), 3)
    assert _rel(tr.unpack_colors(*got, te), masked) < TOL
    for g, r in zip(tr.matvec_split(tbc, tr.pack_colors(tu, te), te),
                    jr.matvec_split(jbc, jr.pack_colors(ju, je), je)):
        assert _rel(g, r) < TOL
