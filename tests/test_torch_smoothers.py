"""dgtpu_torch.ops.smoothers against dgtpu.ops.smoothers on the same
operators and numpy-seeded vectors, float64, < 1e-12 relative: every
smoother string, the sequential sweep forward / backward / symmetric, the
red-black sweeps (colored and packed) and Chebyshev with a given ``eig_max``.

The port runs the sequential lexicographic sweep by wavefronts; it is held
to a literal cell-by-cell loop to 1e-14, on a rectangle and across an
O-grid's seam.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from dgtpu.api import DGFEM as JDGFEM
from dgtpu.ops import smoothers as js
from dgtpu.settings import Settings as JSettings
from dgtpu.settings import load_params

from dgtpu_torch.convert import from_dgtpu_arrays
from dgtpu_torch.ops import smoothers as ts

torch.set_num_threads(1)
TOL = 1e-12


@pytest.fixture(scope="module")
def rect():
    return __graft_entry__._flagship(n=4, p_grid=2, p_sol=2).levels[-1]


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
    return JDGFEM(settings=s, solve_multigrid=True).levels[-1]


def _port_op(lvl):
    ops, _ = from_dgtpu_arrays(
        [dict(blocks=np.asarray(lvl.op.blocks), nbr=np.asarray(lvl.op.nbr),
              mask=np.asarray(lvl.op.mask))], [], [], [(lvl.Nj, lvl.Ni)])
    return ops[0]


def _vectors(lvl, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, lvl.op.shape[0]))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def test_block_diag_inv_and_colors(rect):
    top = _port_op(rect)
    assert _rel(ts.block_diag_inv(top), js.block_diag_inv(rect.op)) < TOL
    assert np.array_equal(ts.element_colors(rect.Ni, rect.Nj).numpy(),
                          np.asarray(js.element_colors(rect.Ni, rect.Nj)))
    assert np.array_equal(ts.element_colors(3, 2).numpy(),
                          np.asarray(js.element_colors(3, 2)))


def test_stencil_operator_protocol(rect):
    """The rest of the operator protocol of ``ops/stencil.py``: the stencil's
    arithmetic and triangular masks, the dense operator, and the dense
    block-GS sweep (pyamg's semantics) against dgtpu's."""
    from dgtpu.ops import stencil as jst
    from dgtpu_torch.ops import stencil as tst
    top, jop = _port_op(rect), rect.op
    assert (top.n_elem, top.block_shape, top.shape) == \
        (jop.n_elem, tuple(jop.block_shape), tuple(jop.shape))
    assert top.astype(torch.float32).blocks.dtype == torch.float32
    u = _vectors(rect, 8)[0]
    both = top.scale(0.5).add(top)
    assert _rel(both.matvec(torch.as_tensor(u)),
                jop.scale(0.5).add(jop).matvec(jnp.asarray(u))) < 1e-14
    assert _rel(top.offdiag_matvec(torch.as_tensor(u)),
                jop.offdiag_matvec(jnp.asarray(u))) < 1e-14
    for got, ref in zip(top.lower_upper_masks(), jop.lower_upper_masks()):
        assert np.array_equal(got.numpy(), np.asarray(ref))
    dense, jdense = tst.as_dense_operator(top), jst.as_dense_operator(jop)
    assert tst.as_dense_operator(dense) is dense and dense.shape == tuple(jdense.shape)
    assert np.array_equal(dense.to_dense().numpy(), np.asarray(jdense.A))
    assert _rel(dense.astype(torch.float64).matvec(torch.as_tensor(u)),
                jdense.matvec(jnp.asarray(u))) < 1e-14
    B = top.block_shape[0]
    assert np.array_equal(dense.block_partition(B).numpy(),
                          np.asarray(jdense.block_partition(B)))
    assert np.array_equal(dense.diag_blocks_of(B).numpy(), top.diag_blocks().numpy())
    rhs = _vectors(rect, 9)[0]
    for backward in (False, True):
        ref = jst.dense_block_gs_sweep(jdense.A, jnp.asarray(rhs), jnp.asarray(u), B, backward)
        got = tst.dense_block_gs_sweep(dense.A, torch.as_tensor(rhs), torch.as_tensor(u), B,
                                       backward)
        assert _rel(got, ref) < TOL
        # the same sweep as the stencil's sequential one
        seq = ts.block_gauss_seidel(top, torch.as_tensor(rhs), torch.as_tensor(u),
                                    direction="backward" if backward else "forward")
        assert _rel(got, seq) < TOL


def test_aliases_match():
    assert ts.SMOOTHER_ALIASES == js.SMOOTHER_ALIASES
    assert ts.normalize_smoother_name("distributive_Gauss_Seidel") == \
        js.normalize_smoother_name("distributive_Gauss_Seidel")
    with pytest.raises(ValueError, match="Unknown smoother"):
        ts.normalize_smoother_name("sor")


@pytest.mark.parametrize("name", sorted(set(js.SMOOTHER_ALIASES)
                                        - {"distributive_gauss_seidel"}))
def test_every_smoother_string(rect, name):
    """apply_smoother with each reference string: 2 iterations, omega 0.9,
    sequential strategy (the red-black string colors regardless)."""
    top = _port_op(rect)
    rhs, u = _vectors(rect)
    colors = js.element_colors(rect.Ni, rect.Nj)
    kw = dict(direction="symmetric", omega=0.9, iterations=2, eig_max=2.2, eig_ratio=0.25)
    ref = js.apply_smoother(name, rect.op, jnp.asarray(rhs), jnp.asarray(u),
                            colors=colors, **kw)
    got = ts.apply_smoother(name, top, torch.as_tensor(rhs), torch.as_tensor(u),
                            colors=torch.as_tensor(np.array(colors)), **kw)
    assert _rel(got, ref) < TOL


def test_distributive_gs_names_its_roadmap_item(rect):
    """Distributive GS runs on a Stokes level's own state
    (``models/stokes.make_dgs``), not through ``apply_smoother``: both
    packages raise the same ValueError there (the test keeps the name it had
    while the port raised NotImplementedError)."""
    top = _port_op(rect)
    rhs, u = _vectors(rect)
    match = "requires the Stokes distributive driver"
    with pytest.raises(ValueError, match=match):
        js.apply_smoother("distributive_gauss_seidel", rect.op, jnp.asarray(rhs),
                          jnp.asarray(u))
    with pytest.raises(ValueError, match=match):
        ts.apply_smoother("distributive_gauss_seidel", top, torch.as_tensor(rhs),
                          torch.as_tensor(u))


@pytest.mark.parametrize("direction", ["forward", "backward", "symmetric"])
@pytest.mark.parametrize("grid", ["rect", "ogrid"])
def test_sequential_sweep(request, grid, direction):
    lvl = request.getfixturevalue(grid)
    top = _port_op(lvl)
    rhs, u = _vectors(lvl, 1)
    ref = js.block_gauss_seidel(lvl.op, jnp.asarray(rhs), jnp.asarray(u),
                                direction=direction, omega=0.95, iterations=2)
    got = ts.block_gauss_seidel(top, torch.as_tensor(rhs), torch.as_tensor(u),
                                direction=direction, omega=0.95, iterations=2)
    assert _rel(got, ref) < TOL


def _cellwise_sweep(op, rhs, u, Dinv, omega, backward):
    """The lexicographic block-GS sweep as a literal loop over the cells."""
    blocks, nbr = op.blocks.numpy(), op.nbr.numpy()
    n, _, br, bc = blocks.shape
    u = u.reshape(n, bc).copy()
    rhs = rhs.reshape(n, br)
    for e in (range(n - 1, -1, -1) if backward else range(n)):
        contrib = sum(blocks[e, s] @ u[nbr[e, s]] for s in range(1, 5))
        u[e] = omega * (Dinv[e] @ (rhs[e] - contrib)) + (1 - omega) * u[e]
    return u.reshape(-1)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("grid", ["rect", "ogrid"])
def test_wavefront_sweep_equals_cell_by_cell(request, grid, backward):
    lvl = request.getfixturevalue(grid)
    top = _port_op(lvl)
    rhs, u = _vectors(lvl, 2)
    Dinv = ts.block_diag_inv(top)
    fronts = ts.sweep_fronts(top, backward)
    # every cell once, and fewer batched steps than cells
    assert sorted(torch.cat(fronts).tolist()) == list(range(top.n_elem))
    assert len(fronts) == lvl.Ni + lvl.Nj - 1
    got = ts._gs_sweep_sequential(top, torch.as_tensor(rhs), torch.as_tensor(u),
                                  Dinv, 0.9, backward)
    ref = _cellwise_sweep(top, rhs, u, Dinv.numpy(), 0.9, backward)
    assert _rel(got, ref) < 1e-14


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("grid", ["rect", "ogrid"])
def test_redblack_sweeps(request, grid, packed):
    lvl = request.getfixturevalue(grid)
    top = _port_op(lvl)
    rhs, u = _vectors(lvl, 3)
    jcolors = js.element_colors(lvl.Ni, lvl.Nj)
    tcolors = ts.element_colors(lvl.Ni, lvl.Nj)
    jpack = js.ColorPack(lvl.op, jcolors) if packed else None
    tpack = ts.ColorPack(top, tcolors) if packed else None
    if packed:
        for c in (0, 1):
            assert np.array_equal(tpack.idx[c].numpy(), np.asarray(jpack.idx[c]))
            assert np.array_equal(tpack.off_blocks[c].numpy(), np.asarray(jpack.off_blocks[c]))
            assert np.array_equal(tpack.off_nbr[c].numpy(), np.asarray(jpack.off_nbr[c]))
    ref = js.block_gauss_seidel(lvl.op, jnp.asarray(rhs), jnp.asarray(u), omega=0.9,
                                iterations=2, strategy="redblack", colors=jcolors,
                                pack=jpack)
    got = ts.block_gauss_seidel(top, torch.as_tensor(rhs), torch.as_tensor(u), omega=0.9,
                                iterations=2, strategy="redblack", colors=tcolors,
                                pack=tpack)
    assert _rel(got, ref) < TOL
    with pytest.raises(ValueError, match="needs element colors"):
        ts.block_gauss_seidel(top, torch.as_tensor(rhs), torch.as_tensor(u),
                              strategy="redblack")


def test_block_jacobi(rect):
    top = _port_op(rect)
    rhs, u = _vectors(rect, 4)
    ref = js.block_jacobi(rect.op, jnp.asarray(rhs), jnp.asarray(u), omega=0.8, iterations=3)
    got = ts.block_jacobi(top, torch.as_tensor(rhs), torch.as_tensor(u), omega=0.8,
                          iterations=3)
    assert _rel(got, ref) < TOL


@pytest.mark.parametrize("degree", [1, 3, 4])
def test_chebyshev_with_given_eig_max(rect, degree):
    top = _port_op(rect)
    rhs, u = _vectors(rect, 5)
    ref = js.chebyshev(rect.op, jnp.asarray(rhs), jnp.asarray(u), degree=degree,
                       eig_max=2.4, eig_ratio=0.3)
    got = ts.chebyshev(top, torch.as_tensor(rhs), torch.as_tensor(u), degree=degree,
                       eig_max=2.4, eig_ratio=0.3)
    assert _rel(got, ref) < TOL


def test_power_iteration_from_a_given_start(rect):
    """dgtpu draws its start vector from jax's PRNG, which torch cannot
    reproduce; from one numpy-made start the iterations agree, and the
    port's own seeded start lands within the estimate's few percent."""
    top = _port_op(rect)
    v0 = np.random.default_rng(6).standard_normal(rect.op.shape[0])
    Dinv = js.block_diag_inv(rect.op)
    v = jnp.asarray(v0) / jnp.linalg.norm(jnp.asarray(v0))
    n, _, br, _ = rect.op.blocks.shape
    for _ in range(30):
        w = jnp.einsum("nij,nj->ni", Dinv, rect.op.matvec(v).reshape(n, br)).reshape(-1)
        rho = jnp.linalg.norm(w)
        v = w / rho
    got = ts.estimate_rho_dinv_a(top, iterations=30, v0=torch.as_tensor(v0))
    assert got == pytest.approx(float(rho), rel=1e-12)
    assert ts.estimate_rho_dinv_a(top) == pytest.approx(js.estimate_rho_dinv_a(rect.op),
                                                        rel=0.05)
    assert ts.estimate_rho_dinv_a(top) == ts.estimate_rho_dinv_a(top, seed=7)


def test_chebyshev_omega_as_eig_ratio_warns(rect, caplog):
    top = _port_op(rect)
    rhs, u = (torch.as_tensor(v) for v in _vectors(rect, 7))
    with caplog.at_level("WARNING", logger="dgtpu_torch"):
        got = ts.apply_smoother("chebyshev", top, rhs, u, omega=0.4, iterations=2,
                                eig_max=2.4)
    assert "reinterpreted as eig_ratio" in caplog.text
    assert torch.equal(got, ts.chebyshev(top, rhs, u, degree=2, eig_max=2.4, eig_ratio=0.4))
    caplog.clear()
    with caplog.at_level("WARNING", logger="dgtpu_torch"):
        got = ts.apply_smoother("chebyshev", top, rhs, u, omega=1.0, iterations=2,
                                eig_max=2.4)
    assert not caplog.text
    assert torch.equal(got, ts.chebyshev(top, rhs, u, degree=2, eig_max=2.4, eig_ratio=0.3))
