"""What ``chip_smoke.py`` counts for K7 (``multi_half_sweep``) and R1
(``rolled_half_sweep``) on the CPU: the bytes and operations of a call
(``work``), K7's streaming floor (``stream_floor``), and the grid an earlier
tree's K7 takes under ``--parent`` (``kernels_of``).

The levels are the port's own: a ``StreamedLevel`` (float32 and bfloat16
sweep blocks) and the levels of a ``RolledVCycle`` over the 4x4 p2
hierarchy assembled on the CPU, and synthetic rolled levels on odd grids.
Each expected count is written out from the shapes, independently of
``chip_smoke.nbytes``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from dgtpu_torch.api import DGFEM
from dgtpu_torch.ops import _kernels, rolled, stream, vcycle
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


class _EarlierSoaLibrary:
    """A stand-in for an earlier tree's SoA library whose K7 counts its grid
    in CTAs: no ``soa_multi_half_sweep_grid``, and 40 co-resident CTAs."""

    def __init__(self):
        self.asked = []

        def ctas(B, bf16, n):
            self.asked.append((B, bf16))
            n._obj.value = 40
            return 0

        self.soa_multi_half_sweep_ctas = ctas


@pytest.mark.parametrize("C, clusters, want", [(2048, None, 40), (96, None, 3),
                                               (2048, 7, 7)])
def test_kernels_of_gives_an_earlier_k7_its_cta_grid(C, clusters, want):
    """Under ``--parent`` an earlier K7 gets its own default grid, one CTA per
    32-cell tile at most the co-resident count, through this tree's
    launcher; an explicit grid passes through; this tree's launcher is
    back after the block."""
    lib = _EarlierSoaLibrary()
    seen = []
    ours = _kernels.multi_half_sweep
    blocks = torch.empty(2, 5, 36, 36, C, dtype=torch.bfloat16, device="meta")
    try:
        _kernels.multi_half_sweep = lambda *a: seen.append(a[-1])
        launcher = _kernels.multi_half_sweep
        with chip_smoke.kernels_of((lib, object())):
            assert _kernels.library() is lib
            _kernels.multi_half_sweep(blocks, None, None, None, 8, 32, False, None,
                                      clusters)
        assert _kernels.multi_half_sweep is launcher
        assert seen == [want]
        assert lib.asked == [(36, 1)]
    finally:
        _kernels.multi_half_sweep = ours
