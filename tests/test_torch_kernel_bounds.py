"""What ``chip_smoke.py`` counts for K4 (``geo_transfer``), K7
(``multi_half_sweep``), R1 (``rolled_half_sweep``) and R2
(``rolled_stencil_apply``) on the CPU: the bytes and operations of a call
(``work``), K7's streaming floor (``stream_floor``), the library calls K4,
K5 (``stencil_apply``) and R2 are timed against (``library_of``), and the
swap of the kernel libraries under ``--parent`` (``kernels_of``).

The levels are the port's own: a ``StreamedLevel`` (float32 and bfloat16
sweep blocks) and the levels of a ``RolledVCycle`` over the 4x4 p2
hierarchy assembled on the CPU, and synthetic rolled levels on odd grids.
Each expected count is written out from the shapes, independently of
``chip_smoke.nbytes``.
"""

import contextlib

import numpy as np
import pytest
import torch

import chip_smoke
from dgtpu_torch.api import DGFEM
from dgtpu_torch.ops import _kernels, rolled, soa, stream, vcycle
from dgtpu_torch.ops.stream import StreamedLevel
from dgtpu_torch.ops.vcycle import RolledLevel, RolledVCycle

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def hierarchy():
    settings = chip_smoke.settings_for("Rectangle_4X4_nPoly2.xyz", 2, p_levels="1,2")
    return DGFEM(device="cpu", settings=settings, solve_multigrid=True)


def _k7_args(dg, storage, start, with_base):
    top = dg.levels[-1]
    sl = StreamedLevel(top.op, top.Nj, top.Ni, dtype=torch.float32, device="cpu",
                       block_storage=storage)
    blocks, Dinv = sl.sweep
    B, C = Dinv.shape[1], Dinv.shape[3]
    rng = np.random.default_rng(0)
    rhs, u, base = (torch.as_tensor(rng.standard_normal((2, B, C)), dtype=torch.float32)
                    for _ in range(3))
    args = (sl.lv, blocks, Dinv, rhs, u if start else None, 8)
    return (args + (base,) if with_base else args), B, C


@pytest.mark.parametrize("with_base", [False, True], ids=["no_base", "base"])
@pytest.mark.parametrize("start", [True, False], ids=["from_u", "from_zero"])
@pytest.mark.parametrize("storage, size", [("float32", 4), ("bfloat16", 2)])
def test_k7_work(hierarchy, storage, size, start, with_base):
    """K7's unique bytes: both colors' blocks (slots 1..4) and Dinv in
    their storage type once, rhs, u (when given), base (when given) and the
    output in float32; its operations: 2 per multiply-add, 5 B^2 C per
    half-sweep, less the first half-sweep's blocks from zero."""
    args, B, C = _k7_args(hierarchy, storage, start, with_base)
    vec = 2 * B * C * 4
    want_bytes = (2 * 5 * B * B * C * size + vec * (2 + int(start) + int(with_base)))
    want_ops = 2 * (8 * 5 * B * B * C - (0 if start else 4 * B * B * C))
    assert chip_smoke.work(stream.multi_half_sweep, args) == (want_bytes, want_ops)


@pytest.mark.parametrize("with_base", [False, True], ids=["no_base", "base"])
@pytest.mark.parametrize("start", [True, False], ids=["from_u", "from_zero"])
@pytest.mark.parametrize("storage, size", [("float32", 4), ("bfloat16", 2)])
def test_k7_stream_floor(hierarchy, storage, size, start, with_base):
    """K7's streaming floor: each of the 8 half-sweeps reads one color's
    four off-diagonal blocks and Dinv (5 B^2 C elements); from zero the
    first reads Dinv only.  The base adds nothing."""
    args, B, C = _k7_args(hierarchy, storage, start, with_base)
    want = (8 * 5 * B * B * C - (0 if start else 4 * B * B * C)) * size
    assert chip_smoke.stream_floor(args) == want


def test_k7_floor_at_64x64_p5_shapes():
    """At the 64x64 p5 finest level (B 36, C 2048) 8 float32 half-sweeps
    stream 8 x 53.1 MB: 0.127 ms at 3.35 TB/s, 0.063 ms in bfloat16."""
    B, C = 36, 2048
    for dtype, ms in ((torch.float32, 0.1268), (torch.bfloat16, 0.0634)):
        blocks = torch.empty(2, 5, B, B, C, dtype=dtype, device="meta")
        args = (None, blocks, blocks[:, 0], None, blocks, 8)
        floor = chip_smoke.stream_floor(args)
        assert floor == 8 * 5 * B * B * C * blocks.element_size()
        assert floor / chip_smoke.HBM_BYTES_PER_S * 1e3 == pytest.approx(ms, abs=1e-4)


def _r1_expected(nj, ni, B, color, with_base):
    """R1's bytes and operations from a count of the color's cells."""
    active = int(sum((i + j) % 2 == color for j in range(nj) for i in range(ni)))
    vec = nj * ni * B * 4
    return (active * (5 * B * B + B) * 4 + vec * (2 + int(with_base)),
            2 * 5 * B * B * active)


@pytest.mark.parametrize("with_base", [False, True], ids=["no_base", "base"])
@pytest.mark.parametrize("color", [0, 1])
def test_r1_work_on_the_rolled_cycle(hierarchy, color, with_base):
    """R1's bytes on every level of the rolled cycle over the 4x4 p2
    hierarchy: the color's cells' blocks (slots 1..4), Dinv and rhs, u and
    base once, the output."""
    dg = hierarchy
    cyc = RolledVCycle([l.op for l in dg.levels], dg.transfers, dg.transfer_types,
                       dg.settings, [(l.Nj, l.Ni) for l in dg.levels], device="cpu")
    for lv in cyc.levels:
        nj, ni, B = lv.Dinv.shape[:3]
        v = torch.zeros(nj, ni, B)
        args = (lv, v, v, color) + ((v,) if with_base else ())
        assert chip_smoke.work(vcycle.half_sweep, args) == \
            _r1_expected(nj, ni, B, color, with_base)


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("nj, ni", [(1, 1), (3, 5), (2, 7), (5, 1), (3, 3)])
def test_r1_work_on_odd_grids(color, nj, ni):
    """With an odd cell count the colors differ by one cell (a 1x1 level
    has no cell of color 1); R1's bytes count the color's own cells."""
    B = 4
    lv = RolledLevel(torch.zeros(nj, ni, 5, B, B), torch.zeros(nj, ni, B, B),
                     rolled.color_masks(nj, ni, torch.float32, "cpu"))
    v = torch.zeros(nj, ni, B)
    assert chip_smoke.work(vcycle.half_sweep, (lv, v, v, color)) == \
        _r1_expected(nj, ni, B, color, False)


def test_k7_clusters_keyword_on_the_cpu(hierarchy):
    """On CPU tensors K7's wrapper takes the plain version whatever grid is
    asked for."""
    args, _, _ = _k7_args(hierarchy, "float32", True, True)
    got = stream.multi_half_sweep(*args, clusters=3)
    assert torch.equal(got, stream.multi_half_sweep_plain(*args))


@pytest.mark.parametrize("raises", [False, True], ids=["returns", "raises"])
def test_kernels_of_swaps_in_and_restores_both_libraries(raises):
    """Under ``--parent`` every wrapper launches from the earlier tree's
    libraries inside ``kernels_of``: ``_kernels.library`` and
    ``rolled_library`` give them there, and this tree's loaders are back
    after the block, also when it raises; None leaves this tree's."""
    soa_lib, rolled_lib = object(), object()
    ours = _kernels.library, _kernels.rolled_library
    with pytest.raises(KeyError) if raises else contextlib.nullcontext():
        with chip_smoke.kernels_of((soa_lib, rolled_lib)):
            assert _kernels.library() is soa_lib
            assert _kernels.rolled_library() is rolled_lib
            with chip_smoke.kernels_of(None):
                assert _kernels.library() is soa_lib
            if raises:
                raise KeyError("inside the block")
    assert (_kernels.library, _kernels.rolled_library) == ours


def _rand(rng, *shape):
    return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)


# (B_fine, B_coarse, coarse dims): K4's shapes on the main paths -- the
# Poisson p1 levels (B 4: 8x8 -> 4x4, 64x64 -> 32x32), the Stokes velocity
# (the block-diagonal of two p1 blocks, B 8) and pressure (B 1) levels
# (8x8 -> 4x4, 4x4 -> 2x2) -- and a B 9 level on an odd coarse row count
K4_SHAPES = [(4, 4, (4, 4)), (4, 4, (32, 32)), (8, 8, (4, 4)), (1, 1, (2, 2)),
             (9, 4, (3, 2))]


@pytest.mark.parametrize("mode", ["restrict", "prolong", "prolong_base"])
@pytest.mark.parametrize("Bf, Bc, dims_c", K4_SHAPES)
def test_k4_library_call_matches_plain(Bf, Bc, dims_c, mode):
    """K4's library call (``chip_smoke.library_of``: one torch.einsum on the
    pre-gathered children or parents, + base) computes the plain version's
    function."""
    rng = np.random.default_rng(0)
    njc, nic = dims_c
    Cc, Cf = njc * nic // 2, 2 * njc * nic
    if mode == "restrict":
        args = (_rand(rng, 4, Bc, Bf), _rand(rng, 2, Bf, Cf), dims_c, True)
    else:
        args = (_rand(rng, 4, Bf, Bc), _rand(rng, 2, Bc, Cc), dims_c, False) \
            + ((_rand(rng, 2, Bf, Cf),) if mode == "prolong_base" else ())
    call, what = chip_smoke.library_of(soa.geo_transfer, args)
    assert "gather not timed" in what
    torch.testing.assert_close(call(), soa.geo_transfer_plain(*args), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("nj, ni, B", [(3, 5, 4), (1, 4, 9), (4, 4, 16)])
@pytest.mark.parametrize("residual", [True, False], ids=["residual", "matvec"])
def test_r2_library_call_matches_plain(nj, ni, B, residual):
    """R2's library call (one torch.einsum over the pre-gathered five fields,
    then the add of base and sign, or the sign alone) computes the plain
    version's function on odd, one-row and even grids."""
    rng = np.random.default_rng(1)
    lv = RolledLevel(_rand(rng, nj, ni, 5, B, B), _rand(rng, nj, ni, B, B),
                     rolled.color_masks(nj, ni, torch.float32, "cpu"))
    x, rhs = _rand(rng, nj, ni, B), _rand(rng, nj, ni, B)
    args = (lv, x, rhs, -1.0) if residual else (lv, x)
    call, what = chip_smoke.library_of(vcycle.stencil_apply, args)
    assert what.endswith("gather not timed")
    torch.testing.assert_close(call(), vcycle.stencil_apply_plain(*args), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("periodic", [False, True], ids=["rectangle", "o_grid"])
@pytest.mark.parametrize("call", ["residual", "matvec", "scaled"])
def test_k5_library_call_matches_plain(storage, periodic, call):
    """K5's library call (one torch.einsum over the pre-gathered own and
    neighbor fields of both colors, then the add of base and sign, or the
    sign alone) computes the plain version's function, on a rectangle and
    on an O-grid lattice, with float32 and bfloat16 blocks."""
    rng = np.random.default_rng(3)
    nj, ni, Bs, Bd = 4, 6, 5, 3
    C = nj * ni // 2
    lv = soa.SoALevel(None, None, soa.lane_masks(nj, ni, torch.float32, "cpu"), nj, ni,
                      periodic)
    blk = _rand(rng, 2, 5, Bs, Bd, C).to(storage)
    x, base = _rand(rng, 2, Bs, C), _rand(rng, 2, Bd, C)
    args = {"residual": (lv, blk, x, base, -1.0), "matvec": (lv, blk, x),
            "scaled": (lv, blk, x, None, 0.5)}[call]
    fn, what = chip_smoke.library_of(soa.stencil_apply, args)
    assert what.endswith("gather not timed")
    torch.testing.assert_close(fn(), soa.stencil_apply_plain(*args), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_base", [False, True], ids=["no_base", "base"])
@pytest.mark.parametrize("Bf, Bc, dims_c", K4_SHAPES[:4])
def test_k4_work(Bf, Bc, dims_c, with_base):
    """K4's bytes: T4, the input and base once, the output; its operations:
    2 per multiply-add, 4 B_fine per restricted output, B_coarse per
    prolonged one."""
    rng = np.random.default_rng(2)
    njc, nic = dims_c
    Cc, Cf = njc * nic // 2, 2 * njc * nic
    R = (_rand(rng, 4, Bc, Bf), _rand(rng, 2, Bf, Cf), dims_c, True)
    assert chip_smoke.work(soa.geo_transfer, R) == (
        4 * (4 * Bc * Bf + 2 * Bf * Cf + 2 * Bc * Cc), 2 * 2 * Cc * Bc * 4 * Bf)
    P = (_rand(rng, 4, Bf, Bc), _rand(rng, 2, Bc, Cc), dims_c, False) \
        + ((_rand(rng, 2, Bf, Cf),) if with_base else ())
    assert chip_smoke.work(soa.geo_transfer, P) == (
        4 * (4 * Bf * Bc + 2 * Bc * Cc + 2 * Bf * Cf * (2 if with_base else 1)),
        2 * 2 * Cf * Bf * Bc)


@pytest.mark.parametrize("with_base", [False, True], ids=["no_base", "base"])
def test_r2_work_on_the_rolled_cycle(hierarchy, with_base):
    """R2's bytes on every level of the rolled cycle over the 4x4 p2
    hierarchy: every cell's five blocks, x and base once, the output; its
    operations: 2 per multiply-add, 5 B^2 a cell."""
    dg = hierarchy
    cyc = RolledVCycle([l.op for l in dg.levels], dg.transfers, dg.transfer_types,
                       dg.settings, [(l.Nj, l.Ni) for l in dg.levels], device="cpu")
    for lv in cyc.levels:
        nj, ni, B = lv.Dinv.shape[:3]
        v = torch.zeros(nj, ni, B)
        args = (lv, v, v, -1.0) if with_base else (lv, v)
        vec = nj * ni * B * 4
        assert chip_smoke.work(vcycle.stencil_apply, args) == (
            nj * ni * 5 * B * B * 4 + vec * (2 + int(with_base)), 2 * 5 * B * B * nj * ni)
