"""The port's CUDA kernels (dgtpu_torch/csrc/soa_kernels.cu: K1, K3, K4,
K5, K6 and K7; dgtpu_torch/csrc/rolled_kernels.cu: R1-R4) against their
plain torch versions, and the port's import hygiene.

The kernels have no CPU mode: the tests marked ``cuda`` skip without a
card and run on one with ``python -m pytest tests/test_torch_kernels.py``.
Bar on the card: float32 kernel vs float32 plain version < 1e-5 relative to
max|plain| (summation order and FMA contraction differ, so equality is not
expected); bfloat16 blocks are upconverted identically by both, so the same
bar holds.
"""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dgtpu_torch.ops import _kernels, soa, stream, vcycle
from dgtpu_torch.ops import stokes_soa as ss
from dgtpu_torch.ops import stokes_stream as sst

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_import_leaves_jax_out():
    code = ("import sys, dgtpu_torch, dgtpu_torch.api, dgtpu_torch.__main__, "
            "dgtpu_torch.convert, dgtpu_torch.ops.soa, dgtpu_torch.ops.stokes_soa, "
            "dgtpu_torch.ops.stream, dgtpu_torch.ops.stokes_stream, "
            "dgtpu_torch.ops.vcycle, dgtpu_torch.ops.smoothers, "
            "dgtpu_torch.solvers.multigrid, dgtpu_torch.solvers.direct, "
            "dgtpu_torch.solvers.relaxation_driver, dgtpu_torch.models.stokes; "
            "assert 'jax' not in sys.modules and 'dgtpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env={**os.environ, "PYTHONPATH": REPO}, timeout=120)


def test_sources_import_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "dgtpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "dgtpu"), (path, m)


def test_entry_points_match_bindings():
    """Every ctypes signature names an extern "C" function of its kernel
    source with the same number of arguments, and the sources export no
    other entry point."""
    assert {"soa_multi_half_sweep_grid", "soa_multi_half_sweep_clusters"} \
        <= set(_kernels._SIGNATURES)
    for path, prefix, signatures in (
            (_kernels.SOURCE, "soa", _kernels._SIGNATURES),
            (_kernels.ROLLED_SOURCE, "rolled", _kernels._ROLLED_SIGNATURES)):
        src = open(path).read()
        assert set(re.findall(rf"^int ({prefix}_\w+)\(", src, re.M)) == set(signatures)
        for name, argtypes in signatures.items():
            m = re.search(rf"\bint {name}\(([^)]*)\)", src)
            assert m, name
            assert len(m.group(1).split(",")) == len(argtypes), name
        assert f"{prefix}_error_string(int code)" in src


def test_launchers_refuse_cpu_tensors():
    x = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.small_gemm(torch.zeros(4, 4), x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.half_sweep(torch.zeros(2, 5, 4, 4, 8), torch.zeros(2, 4, 4, 8),
                            x, x, 0, 2, False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.stencil_apply(torch.zeros(2, 5, 4, 4, 8), x, 2, False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.multi_half_sweep(torch.zeros(2, 5, 4, 4, 8), torch.zeros(2, 4, 4, 8),
                                  x, x, 4, 2, False)
    blocks, Dinv, v = torch.zeros(2, 3, 5, 4, 4), torch.zeros(2, 3, 4, 4), torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.rolled_half_sweep(blocks, Dinv, v, v, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.rolled_stencil_apply(blocks, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.rolled_transfer(torch.zeros(2, 4), v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.rolled_dense_apply(torch.zeros(24, 24), v)


def _rand(rng, *shape, device="cpu"):
    return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                           device=device)


def _level(rng, B, nj, ni, periodic, device):
    nh = ni // 2
    C = nj * nh
    lanes_j, lanes_ip = np.repeat(np.arange(nj), nh), np.tile(np.arange(nh), nj)
    masks = np.stack([lanes_j % 2 == 0, lanes_ip == 0, lanes_ip == nh - 1])
    return soa.SoALevel(_rand(rng, 2, 5, B, B, C, device=device),
                        _rand(rng, 2, B, B, C, device=device),
                        torch.as_tensor(masks[:, None, :], dtype=torch.float32,
                                        device=device), nj, ni, periodic)


def _close(kern, args, kwargs=None):
    got = kern(*args, **(kwargs or {}))
    ref = {**soa.PLAIN, **ss.PLAIN, **stream.PLAIN}[kern](*args)
    torch.cuda.synchronize()
    return float((got - ref).abs().max() / ref.abs().max())


# (B, Nj, Ni): K1's blocks on the main paths (Poisson p5/p3/p2/p1 B 36, 16,
# 9, 4; the Stokes momentum blocks B 18 and 8) at C = 2, 8, 32, 256, 512 and
# 2048 cells per color (the 8x8, 32x32 and 64x64 hierarchies), C = 30 and 72
# (not multiples of 32), C = 8192 (clusters of one CTA) and B = 5 (the body
# for any B)
LEVEL_SHAPES = [(4, 4, 4), (16, 8, 8), (36, 8, 8), (9, 16, 32), (4, 2, 2),
                (18, 8, 8), (8, 8, 8), (18, 2, 2), (8, 4, 4), (36, 32, 32),
                (18, 32, 32), (36, 64, 64), (16, 64, 64), (4, 64, 64), (36, 6, 10),
                (18, 12, 12), (16, 128, 128), (4, 128, 128), (5, 6, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("B, nj, ni", LEVEL_SHAPES)
def test_half_sweep_and_residual_kernels(cuda, B, nj, ni, periodic):
    """K1 on both colors, with and without a base, at whatever cluster its
    launcher picks for (B, C); two launches give the same bits.  K5 as the
    residual."""
    rng = np.random.default_rng(0)
    lv = _level(rng, B, nj, ni, periodic, cuda)
    rhs, u = (_rand(rng, 2, B, nj * ni // 2, device=cuda) for _ in range(2))
    for color in (0, 1):
        assert _close(soa.half_sweep, (lv, rhs, u, color)) < REL_TOL
        assert _close(soa.half_sweep, (lv, rhs, u, color, rhs)) < REL_TOL
        assert _bitwise_stable(soa.half_sweep, (lv, rhs, u, color, rhs))
    # the residual rhs - A u
    assert _close(soa.stencil_apply, (lv, lv.blocks, u, rhs, -1.0)) < REL_TOL


@pytest.mark.cuda
def test_half_sweep_shapes_cover_every_cluster_size(cuda):
    """LEVEL_SHAPES reach clusters of one CTA, portable ones (2-8 CTAs) and
    non-portable ones (more than 8), and STOKES_SHAPES clusters of 1 and 4
    CTAs for K6."""
    k1 = {_kernels.half_sweep_grid(B, nj * ni // 2)[1] for B, nj, ni in LEVEL_SHAPES}
    k6 = {_kernels.dg_half_sweep_grid(Np, nj * ni // 2, Bu)[1]
          for Bu, Np, nj, ni in STOKES_SHAPES}
    assert 1 in k1 and any(1 < n <= 8 for n in k1) and max(k1) > 8, k1
    assert {1, 4} <= k6, k6


def _check_sweep_grid(modes, C, grid):
    """The cluster rule's invariants (soa_kernels.cu, the K1/K6 note): 32-cell
    tiles, clusters of at most 16 CTAs, the modes spread evenly with no empty
    CTA, one output per thread (a thread row of 32 lanes per mode, at most 16
    rows, at least 4 warps to stage), and at least one CTA per SM wherever the
    modes and a portable cluster (8 CTAs) allow it."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles, size, rows, threads = grid
    assert tiles == -(-C // 32)
    assert 1 <= size <= 16 and 1 <= rows <= 16
    assert rows == -(-modes // size) and size == -(-modes // rows)
    assert size * rows >= modes > (size - 1) * rows
    assert threads == 32 * max(rows, 4)
    portable = -(-modes // -(-modes // min(8, modes)))
    assert tiles * size >= min(sms, tiles * portable)


@pytest.mark.cuda
@pytest.mark.parametrize("B, C", [(36, 32), (16, 32), (4, 32), (9, 32), (4, 8), (18, 32),
                                  (8, 32), (18, 2), (8, 2), (9, 256), (36, 512), (18, 512),
                                  (36, 2048), (16, 2048), (4, 2048), (36, 8192), (4, 8192),
                                  (18, 300), (5, 1000), (36, 30), (36, 1)])
def test_half_sweep_grid(cuda, B, C):
    """K1's launch geometry as its launcher picks it on the card."""
    _check_sweep_grid(B, C, _kernels.half_sweep_grid(B, C))


@pytest.mark.cuda
@pytest.mark.parametrize("Bu, Np, C", [(18, 4, 32), (8, 1, 32), (18, 4, 2), (8, 1, 2),
                                       (18, 4, 128), (18, 4, 512), (8, 1, 512),
                                       (36, 4, 2048), (18, 4, 30), (18, 4, 8192),
                                       (12, 3, 40)])
def test_dg_half_sweep_grid(cuda, Bu, Np, C):
    """K6's launch geometry as its launcher picks it on the card."""
    _check_sweep_grid(Np, C, _kernels.dg_half_sweep_grid(Np, C, Bu))


@pytest.mark.cuda
@pytest.mark.parametrize("M, K, N, batch, base, offset", [
    # the tile body (N > 1): polynomial R / P of the p5/p3/p1 and Stokes
    # velocity / pressure levels, several column tiles, a ragged last tile
    (16, 36, 32, 2, False, 0), (36, 16, 32, 2, True, 0), (4, 16, 2048, 2, False, 0),
    (4, 4, 32, 2, True, 0), (36, 36, 96, 2, True, 0), (12, 6, 40, 2, True, 0),
    (1, 4, 8, 2, False, 0),
    # the dense body (N = 1): coarse inverses, 16-byte rows or not, a W
    # that is not 16-byte aligned, and a batch of two
    (64, 64, 1, 1, False, 0), (28, 28, 1, 1, False, 0), (63, 63, 1, 1, True, 0),
    (512, 512, 1, 1, False, 0), (4, 4, 1, 1, False, 0), (64, 64, 1, 1, False, 1),
    (100, 100, 1, 2, True, 0)])
def test_small_gemm_kernel(cuda, M, K, N, batch, base, offset):
    """K3's two bodies against the plain version (x @ W, + base)."""
    rng = np.random.default_rng(0)
    flat = _rand(rng, M * K + offset, device=cuda)
    W = flat[offset:].view(M, K)
    args = [W, _rand(rng, batch, K, N, device=cuda)]
    if base:
        args.append(_rand(rng, batch, M, N, device=cuda))
    assert _close(soa.small_gemm, tuple(args)) < REL_TOL


# (B_fine, B_coarse, coarse dims): K4 at every shape of the main paths -- the
# Poisson p1 levels of the 8x8 and 64x64 hierarchies (B 4, coarse 4x4 to
# 32x32; 2x2 on the O-grid), the Stokes velocity (B 8, two p1 components)
# and pressure (B 1) levels of the 8x8 and 32x32 hierarchies (coarse 2x2 to
# 16x16) -- and the body for any B_in: B 9 (with B 18 -> 9 on an odd coarse
# row count) and B 36 at 64x64 (16 thread rows a CTA), B 4 <-> 16
GEO_SHAPES = [(4, 4, (4, 4)), (9, 9, (2, 4)), (4, 4, (32, 32)), (4, 4, (16, 16)),
              (4, 4, (8, 8)), (4, 4, (2, 2)), (8, 8, (2, 2)), (8, 8, (4, 4)),
              (8, 8, (8, 8)), (8, 8, (16, 16)), (1, 1, (2, 2)), (1, 1, (4, 4)),
              (1, 1, (8, 8)), (1, 1, (16, 16)), (36, 36, (64, 64)), (18, 9, (3, 2)),
              (4, 16, (1, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("Bf, Bc, dims_c", GEO_SHAPES)
def test_geo_transfer_kernel(cuda, Bf, Bc, dims_c):
    """K4 as restriction, prolongation and prolongation + base, at whatever
    grid its launcher picks; two launches give the same bits."""
    rng = np.random.default_rng(0)
    njc, nic = dims_c
    Cc, Cf = njc * nic // 2, 2 * njc * nic
    R4, P4 = _rand(rng, 4, Bc, Bf, device=cuda), _rand(rng, 4, Bf, Bc, device=cuda)
    cases = [(R4, _rand(rng, 2, Bf, Cf, device=cuda), dims_c, True),
             (P4, _rand(rng, 2, Bc, Cc, device=cuda), dims_c, False),
             (P4, _rand(rng, 2, Bc, Cc, device=cuda), dims_c, False,
              _rand(rng, 2, Bf, Cf, device=cuda))]
    for args in cases:
        assert _close(soa.geo_transfer, args) < REL_TOL
        assert _bitwise_stable(soa.geo_transfer, args)


def _mode_grid(modes, C, sms, min_warps):
    """K4's and K5's rule (soa_kernels.cu, mode_grid): 32-cell tiles by 2
    colors by groups of output modes, the groups needed for one CTA per SM,
    at most 16 modes a CTA, spread evenly."""
    tiles = -(-C // 32)
    need = -(-sms // (2 * tiles))
    rows = min(16, max(1, modes // need))
    rows = -(-modes // -(-modes // rows))
    return tiles, 2, -(-modes // rows), 32 * max(rows, min_warps)


@pytest.mark.cuda
@pytest.mark.parametrize("Bout, C_out", [(4, 8), (4, 32), (4, 2048), (4, 512), (8, 2),
                                         (8, 128), (8, 512), (1, 2), (1, 512), (36, 32),
                                         (36, 8192), (16, 3)])
def test_geo_transfer_grid(cuda, Bout, C_out):
    """K4's launch geometry as its launcher picks it on the card: one output
    per thread, no empty group, at least one CTA per SM wherever the modes
    allow it (else one CTA per mode and tile)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = _kernels.geo_transfer_grid(Bout, C_out)
    assert grid == _mode_grid(Bout, C_out, sms, 1)
    tiles, colors, groups, threads = grid
    rows = threads // 32
    assert groups * rows >= Bout > (groups - 1) * rows
    assert tiles * colors * groups >= min(sms, tiles * colors * Bout)


@pytest.mark.cuda
def test_cycle_and_solve_on_the_card(cuda, tmp_path, monkeypatch):
    """The 8x8 p=5 hierarchy: one kernel cycle vs the plain cycle on the
    card, then the mixed route through the kernels to 1e-10."""
    import dgtpu_torch.api as tapi
    from dgtpu_torch.settings import Settings, load_params
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    params = load_params()
    params["performance"]["precision"] = "mixed"
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    dg = tapi.DGFEM(device="cuda", settings=Settings(params), solve_multigrid=True)
    dims = [(l.Nj, l.Ni) for l in dg.levels]

    def cycle(**kw):
        return soa.SoAVCycle([l.op for l in dg.levels], dg.transfers,
                             dg.transfer_types, dg.settings, dims, **kw)

    rhs = dg.levels[-1].rhs
    u_k = cycle()(rhs, torch.zeros_like(rhs))
    u_p = cycle(reference=True)(rhs, torch.zeros_like(rhs))
    assert float((u_k - u_p).abs().max() / u_p.abs().max()) < REL_TOL
    soa.reset_launch_counts()
    dg.solve()
    assert dg.solve_residual < 1e-10
    assert all(k.launches > 0 for k in soa.KERNELS)


def _stokes_level(rng, Bu, Np, nj, ni, periodic, device):
    nh = ni // 2
    C = nj * nh
    lanes_j, lanes_ip = np.repeat(np.arange(nj), nh), np.tile(np.arange(nh), nj)
    masks = np.stack([lanes_j % 2 == 0, lanes_ip == 0, lanes_ip == nh - 1])
    return ss.StokesSoALevel(
        _rand(rng, 2, 5, Bu, Bu, C, device=device), _rand(rng, 2, 5, Np, Bu, C, device=device),
        _rand(rng, 2, 5, Bu, Np, C, device=device), _rand(rng, 2, Bu, Bu, C, device=device),
        _rand(rng, 2, Np, Np, C, device=device), _rand(rng, 2, Np, Np, C, device=device),
        torch.as_tensor(masks[:, None, :], dtype=torch.float32, device=device),
        nj, ni, periodic)


# (2Nu, Np, Nj, Ni): the p2/p1 and p1/p0 levels of the Stokes hierarchies
# (C = 2, 8, 32, 128 and 512 cells per color), a p5 block on the 8x8 and 64x64
# grids, and C = 30 and 72, not multiples of 32
STOKES_SHAPES = [(18, 4, 4, 4), (8, 1, 8, 8), (18, 4, 32, 32), (8, 1, 2, 2),
                 (18, 4, 2, 2), (18, 4, 8, 8), (8, 1, 4, 4), (8, 1, 32, 32),
                 (36, 4, 8, 8), (36, 4, 64, 64), (18, 4, 6, 10), (8, 1, 12, 12),
                 (18, 4, 16, 16)]


def _bitwise_stable(kern, args):
    """Two launches of ``kern`` give the same bits (no atomics, one order of
    sums)."""
    first = kern(*args)
    return torch.equal(first, kern(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("Bu, Np, nj, ni", STOKES_SHAPES)
def test_stencil_apply_and_dg_half_sweep_kernels(cuda, Bu, Np, nj, ni, periodic):
    """K5 on the three Stokes stencils (A: Bu -> Bu, G: Np -> Bu, D: Bu ->
    Np) with float32 and bfloat16 blocks, as a matvec and with a base and
    sign -1, whatever grid K5's launcher picks for (Bd, C); K6 on both
    colors, whatever cluster its launcher picks for (Np, C).  Two launches
    give the same bits."""
    rng = np.random.default_rng(0)
    lv = _stokes_level(rng, Bu, Np, nj, ni, periodic, cuda)
    C = nj * ni // 2
    for blk, b_src, b_dst in ((lv.A, Bu, Bu), (lv.G, Np, Bu), (lv.D, Bu, Np)):
        for stored in (blk, blk.to(torch.bfloat16)):
            x = _rand(rng, 2, b_src, C, device=cuda)
            assert _close(soa.stencil_apply, (lv, stored, x)) < REL_TOL
            base = _rand(rng, 2, b_dst, C, device=cuda)
            assert _close(soa.stencil_apply, (lv, stored, x, base, -1.0)) < REL_TOL
            assert _bitwise_stable(soa.stencil_apply, (lv, stored, x, base, -1.0))
    rhs, p = (_rand(rng, 2, Np, C, device=cuda) for _ in range(2))
    g = _rand(rng, 2, Bu, C, device=cuda)
    for color in (0, 1):
        assert _close(ss.dg_half_sweep, (lv, rhs, p, g, color)) < REL_TOL
        assert _close(ss.dg_half_sweep, (lv, rhs, p, g, color, rhs)) < REL_TOL
        assert _bitwise_stable(ss.dg_half_sweep, (lv, rhs, p, g, color, rhs))


@pytest.mark.cuda
def test_stokes_cycle_and_solve_on_the_card(cuda, tmp_path, monkeypatch):
    """The 8x8 Stokes hierarchy: one kernel W-cycle vs the plain cycle on
    the card (bar 5e-3, long dependent float32 chains), then the mixed route
    through the kernels to 1e-10."""
    import chip_smoke
    import dgtpu_torch.api as tapi
    from dgtpu_torch.settings import Settings
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    dg = tapi.DGFEM(device="cuda", settings=Settings(chip_smoke.stokes_params(8)),
                    solve_multigrid=True)

    def cycle(**kw):
        return ss.SoAStokesVCycle(dg.levels, dg.transfers, dg.transfer_types,
                                  dg.settings, **kw)

    rhs = dg.levels[-1].rhs
    u_k = cycle()(rhs, torch.zeros_like(rhs))
    u_p = cycle(reference=True)(rhs, torch.zeros_like(rhs))
    assert float((u_k - u_p).abs().max() / u_p.abs().max()) < 5e-3
    soa.reset_launch_counts()
    ss.reset_launch_counts()
    dg.solve()
    assert dg.solve_residual < 1e-10
    assert all(k.launches > 0 for k in ss.CYCLE_KERNELS)


# (B, Nj, Ni): the 64x64 p5 finest level (64 tiles of 32 cells), a 4x4 p3
# level (one tile), a 16x16 p2 level (4 tiles), a p1 level, the 32x32 Stokes
# finest A blocks (B 18, 16 tiles) and the 8x8 Stokes finest (B 18, one tile),
# an 8x8 p5 level (one tile, a cluster of many CTAs) and B 5 (the body for
# any B) on a ragged tile
SWEEP_SHAPES = [(36, 64, 64), (16, 4, 4), (9, 16, 16), (4, 8, 8), (18, 32, 32),
                (18, 8, 8), (36, 8, 8), (5, 6, 10)]


def _sweep_operands(lv, bf16):
    """K7's (blocks, Dinv) as the streamed level holds them: the float32 SoA
    blocks and Dinv, or one bfloat16 [Dinv, iL, iR, jL, jR] tensor."""
    if not bf16:
        return lv.blocks, lv.Dinv
    S = torch.cat([lv.Dinv[:, None], lv.blocks[:, 1:]], dim=1).to(torch.bfloat16)
    return S, S[:, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("B, nj, ni", SWEEP_SHAPES)
def test_multi_half_sweep_kernel(cuda, B, nj, ni, periodic, bf16):
    """K7 against its plain version for n_half 2/4/8, from u and from zero,
    with and without base, on the default grid (one cluster per cell tile),
    on grids of 1 and 2 clusters (they stride over the tiles) and on as many
    clusters as the card holds at once."""
    rng = np.random.default_rng(0)
    lv = _level(rng, B, nj, ni, periodic, cuda)
    blocks, Dinv = _sweep_operands(lv, bf16)
    C = nj * ni // 2
    rhs, u, base = (_rand(rng, 2, B, C, device=cuda) for _ in range(3))
    most = _kernels.resident_clusters(B, C, bf16)
    for n_half in (2, 4, 8):
        for start, b in ((u, None), (None, None), (None, base), (u, base)):
            args = (lv, blocks, Dinv, rhs, start, n_half, b)
            for clusters in (None, 1, 2, most):
                assert _close(stream.multi_half_sweep, args,
                              dict(clusters=clusters)) < REL_TOL, \
                    (n_half, start is None, b is None, clusters)
    assert _bitwise_stable(stream.multi_half_sweep, (lv, blocks, Dinv, rhs, u, 8, base))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("B, C", [(36, 2048), (18, 512), (18, 128), (36, 32), (16, 8),
                                  (9, 128), (4, 32), (5, 30)])
def test_multi_half_sweep_grid(cuda, B, C, bf16):
    """K7's default geometry is K1's rule (32-cell tiles, clusters of at most
    16 CTAs, one output per thread) with one cluster per tile where the card
    holds them all at once (64x64 p5: 64 clusters of 3 CTAs of 12 rows; the
    32x32 Stokes finest: 16 clusters of 9 CTAs)."""
    clusters, size, rows, threads = _kernels.multi_half_sweep_grid(B, C, bf16)
    most = _kernels.resident_clusters(B, C, bf16)
    tiles = -(-C // 32)
    assert clusters == min(tiles, most)
    _check_sweep_grid(B, C, (tiles, size, rows, threads))
    if (B, C) == (36, 2048):
        assert (clusters, size, rows) == (64, 3, 12)
    if (B, C) == (18, 512):
        assert (clusters, size, rows) == (16, 9, 2)


@pytest.mark.cuda
def test_multi_half_sweep_grid_limits(cuda):
    """At 64x64 p5 the card holds one cluster per tile (64) at once; a grid
    of the resident count runs, one more cluster raises, and so does a grid
    of no cluster."""
    most = _kernels.resident_clusters(36, 2048, False)
    assert most >= 64
    rng = np.random.default_rng(1)
    lv = _level(rng, 36, 64, 64, False, cuda)
    rhs = _rand(rng, 2, 36, 2048, device=cuda)
    ok = stream.multi_half_sweep(lv, lv.blocks, lv.Dinv, rhs, None, 2, clusters=most)
    torch.cuda.synchronize()
    assert torch.isfinite(ok).all()
    with pytest.raises(RuntimeError, match="soa_multi_half_sweep launch failed"):
        stream.multi_half_sweep(lv, lv.blocks, lv.Dinv, rhs, None, 2, clusters=most + 1)
    with pytest.raises(ValueError, match="0 clusters"):
        stream.multi_half_sweep(lv, lv.blocks, lv.Dinv, rhs, None, 2, clusters=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("B, nj, ni, clusters", [(36, 64, 64, None), (36, 64, 64, 5),
                                                 (18, 32, 32, None), (9, 16, 16, 1)])
def test_multi_half_sweep_graph_matches_eager(cuda, B, nj, ni, clusters, bf16):
    """K7 captured in a CUDA graph (twice in one graph, each launch with its
    grid barriers) against the eager launches, bit for bit, over three
    replays."""
    rng = np.random.default_rng(3)
    lv = _level(rng, B, nj, ni, False, cuda)
    blocks, Dinv = _sweep_operands(lv, bf16)
    C = nj * ni // 2
    rhs, u, base = (_rand(rng, 2, B, C, device=cuda) for _ in range(3))

    def run():
        v = stream.multi_half_sweep(lv, blocks, Dinv, rhs, u, 8, clusters=clusters)
        return stream.multi_half_sweep(lv, blocks, Dinv, rhs, None, 4, v, clusters=clusters)

    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("B, nj, ni", [(36, 64, 64), (16, 8, 8), (4, 2, 2), (36, 8, 8),
                                      (36, 2, 2), (16, 32, 32), (9, 4, 4), (5, 6, 10)])
def test_stencil_apply_kernel_bf16_blocks(cuda, B, nj, ni, periodic):
    """K5 with bfloat16 blocks: the streamed residual with
    res_storage='bfloat16', and the matvec; B = 5 takes the body for any
    B_src.  Two launches give the same bits."""
    rng = np.random.default_rng(0)
    lv = _level(rng, B, nj, ni, periodic, cuda)
    blk = lv.blocks.to(torch.bfloat16)
    u, rhs = (_rand(rng, 2, B, nj * ni // 2, device=cuda) for _ in range(2))
    assert _close(soa.stencil_apply, (lv, blk, u, rhs, -1.0)) < REL_TOL
    assert _close(soa.stencil_apply, (lv, blk, u)) < REL_TOL
    assert _bitwise_stable(soa.stencil_apply, (lv, blk, u, rhs, -1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("Bd, C", [(18, 32), (4, 32), (1, 2), (8, 8), (36, 32), (8, 128),
                                   (18, 128), (36, 128), (18, 512), (4, 512), (36, 2048),
                                   (36, 8192), (18, 300), (5, 1000)])
def test_stencil_apply_grid(cuda, Bd, C):
    """K5's launch geometry as its launcher picks it on the card: 32-cell
    tiles by 2 colors by groups of output modes, at most 16 modes (thread
    rows) per CTA and at least 4 warps, no empty group, and at least one
    CTA per SM wherever the modes allow it (else one CTA per mode)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles, colors, groups, threads = _kernels.stencil_apply_grid(Bd, C)
    rows = -(-Bd // groups)
    assert (tiles, colors) == (-(-C // 32), 2)
    assert rows <= 16 and threads == 32 * max(rows, 4)
    assert groups * rows >= Bd > (groups - 1) * rows
    assert tiles * colors * groups >= min(sms, tiles * colors * Bd)


@pytest.mark.cuda
def test_streamed_stokes_dg_pass_and_route_on_the_card(cuda, tmp_path, monkeypatch):
    """K6 as the streamed DG pass at the 8x8 Stokes finest shapes against
    dgtpu's composition (matvec_color of D, then the two DG-diagonal MACs),
    then the 8x8 Stokes route through the streamed hybrid (budget: the
    coarsest level) to 1e-10 with K5, K6 and K7 launched."""
    import chip_smoke
    import dgtpu_torch.api as tapi
    from dgtpu_torch.settings import Settings
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    dg = tapi.DGFEM(device="cuda", settings=Settings(chip_smoke.stokes_params(8)),
                    solve_multigrid=True)
    sl = sst.StreamedStokesLevel(dg.levels[-1])
    rng = np.random.default_rng(2)
    Bu, Np, C = sl.lv.A.shape[2], sl.lv.G.shape[2], sl.lv.A.shape[4]
    rhs, p, base = (_rand(rng, 2, Np, C, device=cuda) for _ in range(3))
    g = _rand(rng, 2, Bu, C, device=cuda)
    for color in (0, 1):
        for b in (None, base):
            got = sst.dg_pass(sl, rhs, p, g, color, b)
            ref = sst.dg_pass_plain(sl, rhs, p, g, color, b)
            torch.cuda.synchronize()
            assert float((got - ref).abs().max() / ref.abs().max()) < REL_TOL
    budget = ss.SoAStokesVCycle.device_bytes(dg.levels[:1], [])
    monkeypatch.setattr(tapi, "stream_budget", lambda device: budget)
    chip_smoke.reset_counts()
    dg.solve()
    assert dg.cycle_kind == "streamed Stokes hybrid" and dg.solve_residual < 1e-10
    assert all(k.launches > 0 for k in ss.CYCLE_KERNELS[1:] + stream.KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_streamed_hybrid_route_on_the_card(cuda, tmp_path, monkeypatch, storage):
    """The 8x8 p=5 route through the streamed hybrid (budget: every level but
    the finest): one hybrid cycle of kernels against the plain hybrid, then
    the solve to 1e-10 with K7 launched."""
    import dgtpu_torch.api as tapi
    from dgtpu_torch.settings import Settings, load_params
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    params = load_params()
    params["performance"]["precision"] = "mixed"
    params["performance"]["block storage"] = storage
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    dg = tapi.DGFEM(device="cuda", settings=Settings(params), solve_multigrid=True)
    ops, dims = [l.op for l in dg.levels], [(l.Nj, l.Ni) for l in dg.levels]
    budget = soa.SoAVCycle.device_bytes(ops[:-1], dims[:-1], dg.transfers[:-1],
                                        with_coarse=False)

    def cycle(**kw):
        return stream.StreamedVCycle(ops, dg.transfers, dg.transfer_types,
                                     dg.settings, dims, budget, **kw)

    rhs = dg.levels[-1].rhs
    u_k = cycle()(rhs, torch.zeros_like(rhs))
    u_p = cycle(reference=True)(rhs, torch.zeros_like(rhs))
    assert float((u_k - u_p).abs().max() / u_p.abs().max()) < REL_TOL
    monkeypatch.setattr(tapi, "stream_budget", lambda device: budget)
    stream.reset_launch_counts()
    dg.solve()
    assert dg.cycle_kind == "streamed hybrid" and dg.cut == len(dg.levels) - 1
    assert dg.solve_residual < 1e-10 and stream.multi_half_sweep.launches > 0


def _rolled_close(kern, *args, **kw):
    got = kern(*args, **kw)
    ref = vcycle.PLAIN[kern](*args, **kw)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    return float((got - ref).abs().max() / ref.abs().max())


def _rolled_level(rng, B, nj, ni, device):
    return vcycle.RolledLevel(_rand(rng, nj, ni, 5, B, B, device=device),
                              _rand(rng, nj, ni, B, B, device=device),
                              torch.as_tensor(np.stack([(np.add.outer(
                                  np.arange(nj), np.arange(ni)) % 2 == c) for c in (0, 1)]
                              )[..., None], dtype=torch.float32, device=device))


# (B, Nj, Ni): the flagship's p5 / p3 / p1 levels at 8x8, its 1x1 and 2x2
# coarse levels, odd and one-wide grids, a single row, and 64x64 p5
ROLLED_SHAPES = [(36, 8, 8), (16, 8, 8), (4, 8, 8), (4, 1, 1), (4, 2, 2), (9, 2, 3),
                 (9, 3, 1), (9, 1, 4), (5, 5, 7), (36, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("B, nj, ni", ROLLED_SHAPES)
def test_rolled_half_sweep_and_stencil_kernels(cuda, B, nj, ni):
    """R1 (both colors, with and without a base) and R2 (matvec and
    residual).  Random blocks in every slot, so the wrapped i-neighbors
    count as on an O-grid; with an odd Ni the seam joins two cells of one
    color, which R1 updates from pre-update values."""
    rng = np.random.default_rng(0)
    lv = _rolled_level(rng, B, nj, ni, cuda)
    rhs, u, base = (_rand(rng, nj, ni, B, device=cuda) for _ in range(3))
    for color in (0, 1):
        assert _rolled_close(vcycle.half_sweep, lv, rhs, u, color) < REL_TOL
        assert _rolled_close(vcycle.half_sweep, lv, rhs, u, color, base) < REL_TOL
    assert _rolled_close(vcycle.stencil_apply, lv, u) < REL_TOL
    assert _rolled_close(vcycle.stencil_apply, lv, u, rhs, -1.0) < REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("B", [36, 16, 9, 4])
@pytest.mark.parametrize("nj, ni", [(3, 5), (4, 6), (5, 1), (1, 1), (2, 7)])
def test_rolled_half_sweep_bodies(cuda, B, nj, ni, aligned):
    """R1's two bodies: the bulk copy (B 36, 16, 4 with 16-byte aligned
    blocks) and the 4-byte cp.async staging (B 9, and any B whose blocks
    start off a 16-byte boundary: here one float past it), on odd Ni (the
    colors' counts differ and the seam joins two cells of one color), a
    one-wide column, a 1x1 level (color 1 has no cell) and an even grid;
    both colors with and without a base; two launches give the same bits."""
    rng = np.random.default_rng(4)
    off = 0 if aligned else 1
    flat = _rand(rng, nj * ni * 5 * B * B + off, device=cuda)
    flat_d = _rand(rng, nj * ni * B * B + off, device=cuda)
    masks = torch.as_tensor(np.stack([(np.add.outer(np.arange(nj), np.arange(ni)) % 2 == c)
                                      for c in (0, 1)])[..., None],
                            dtype=torch.float32, device=cuda)
    lv = vcycle.RolledLevel(flat[off:].view(nj, ni, 5, B, B),
                            flat_d[off:].view(nj, ni, B, B) / B, masks)
    rhs, u, base = (_rand(rng, nj, ni, B, device=cuda) for _ in range(3))
    for color in (0, 1):
        assert _rolled_close(vcycle.half_sweep, lv, rhs, u, color) < REL_TOL
        assert _rolled_close(vcycle.half_sweep, lv, rhs, u, color, base) < REL_TOL
        assert _bitwise_stable(vcycle.half_sweep, (lv, rhs, u, color, base))


@pytest.mark.cuda
def test_rolled_half_sweep_on_the_ogrid_hierarchy(cuda):
    """R1 on every level of the rolled cycle over the 4x4 O-grid p2
    hierarchy (B 9 and 4, the seam's blocks nonzero), both colors, with and
    without a base."""
    import chip_smoke
    dg = chip_smoke.hierarchy(chip_smoke.settings_for(
        "CircleInCircle_4X4_nPoly2.xyz", 2, o_grid=True, p_levels="1,2"))
    cyc = chip_smoke.rolled_cycle_of(dg)
    rng = np.random.default_rng(6)
    assert {lv.Dinv.shape[-1] for lv in cyc.levels} == {9, 4}
    for lv in cyc.levels:
        nj, ni, B = lv.Dinv.shape[:3]
        rhs, u, base = (_rand(rng, nj, ni, B, device=cuda) for _ in range(3))
        for color in (0, 1):
            assert _rolled_close(vcycle.half_sweep, lv, rhs, u, color) < REL_TOL
            assert _rolled_close(vcycle.half_sweep, lv, rhs, u, color, base) < REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("B", [36, 16, 9, 4])
@pytest.mark.parametrize("nj, ni", [(3, 5), (1, 4), (5, 1), (1, 1), (2, 7), (64, 64)])
def test_rolled_stencil_apply_bodies(cuda, B, nj, ni, aligned):
    """R2's two bodies: the bulk copy (B 36, 16, 4 with 16-byte aligned
    blocks) and the 4-byte cp.async staging (B 9, and any B whose blocks
    start off a 16-byte boundary: here one float past it), on odd Ni, a
    one-row grid, a one-wide column, a 1x1 level, an even grid and 64x64
    (4,096 CTAs); random blocks in every slot, so the wrapped i-neighbors
    count as on an O-grid.  The residual (sign -1 with base), the matvec and
    sign +1 with base; two launches give the same bits."""
    import chip_smoke
    rng = np.random.default_rng(5)
    off = 0 if aligned else 1
    flat = _rand(rng, nj * ni * 5 * B * B + off, device=cuda)
    lv = vcycle.RolledLevel(flat[off:].view(nj, ni, 5, B, B),
                            _rand(rng, nj, ni, B, B, device=cuda), None)
    x, base = (_rand(rng, nj, ni, B, device=cuda) for _ in range(2))
    for args in ((lv, x, base, -1.0), (lv, x), (lv, x, base)):
        assert _rolled_close(vcycle.stencil_apply, *args) < chip_smoke.ROLLED_REL_TOL
    assert _bitwise_stable(vcycle.stencil_apply, (lv, x, base, -1.0))


@pytest.mark.cuda
def test_rolled_stencil_apply_on_the_ogrid_hierarchy(cuda):
    """R2 as the residual and the matvec on every level of the rolled cycle
    over the 4x4 O-grid p2 hierarchy (B 9 and 4, the seam's blocks
    nonzero)."""
    import chip_smoke
    dg = chip_smoke.hierarchy(chip_smoke.settings_for(
        "CircleInCircle_4X4_nPoly2.xyz", 2, o_grid=True, p_levels="1,2"))
    cyc = chip_smoke.rolled_cycle_of(dg)
    rng = np.random.default_rng(7)
    for lv in cyc.levels:
        nj, ni, B = lv.Dinv.shape[:3]
        x, rhs = (_rand(rng, nj, ni, B, device=cuda) for _ in range(2))
        assert _rolled_close(vcycle.stencil_apply, lv, x, rhs, -1.0) \
            < chip_smoke.ROLLED_REL_TOL
        assert _rolled_close(vcycle.stencil_apply, lv, x) < chip_smoke.ROLLED_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("Bf, Bc, nj_c, ni_c", [
    (36, 16, 8, 8), (16, 4, 8, 8), (4, 4, 4, 4), (4, 4, 1, 1), (9, 9, 1, 3),
    (36, 36, 32, 32),
    # B_out > B_in and B_out < B_in on odd and 3-cell grids, the 64x64 p5
    # prolongation (4,096 cells: tiles of fewer than 32 cells), a 1x1 level
    # at p5, and a 16x16 p1 level (its restriction the largest that takes
    # the direct body on an H100, its prolongation a tile body)
    (16, 36, 3, 5), (4, 16, 5, 7), (36, 4, 1, 3), (36, 16, 64, 64), (36, 36, 1, 1),
    (4, 4, 16, 16)])
def test_rolled_transfer_kernel(cuda, Bf, Bc, nj_c, ni_c):
    """R3 per cell (polynomial R, P alone and P onto a base) and as the 2x2
    restriction and prolongation (with and without a base); two launches
    give the same bits."""
    rng = np.random.default_rng(0)
    R, P = _rand(rng, Bc, Bf, device=cuda), _rand(rng, Bf, Bc, device=cuda)
    fine = _rand(rng, nj_c, ni_c, Bf, device=cuda)
    coarse = _rand(rng, nj_c, ni_c, Bc, device=cuda)
    assert _rolled_close(vcycle.transfer, R, fine, restrict=True) < REL_TOL
    assert _rolled_close(vcycle.transfer, P, coarse) < REL_TOL
    assert _rolled_close(vcycle.transfer, P, coarse, base=fine) < REL_TOL
    R4, P4 = _rand(rng, 4, Bc, Bf, device=cuda), _rand(rng, 4, Bf, Bc, device=cuda)
    fine2 = _rand(rng, 2 * nj_c, 2 * ni_c, Bf, device=cuda)
    assert _rolled_close(vcycle.transfer, R4, fine2, restrict=True) < REL_TOL
    assert _rolled_close(vcycle.transfer, P4, coarse) < REL_TOL
    assert _rolled_close(vcycle.transfer, P4, coarse, base=fine2) < REL_TOL
    for args in ((R4, fine2, True), (P4, coarse, False, fine2), (P, coarse, False, fine)):
        assert _bitwise_stable(vcycle.transfer, args)


@pytest.mark.cuda
@pytest.mark.parametrize("B, nj, ni", [(4, 1, 1), (4, 2, 2), (9, 1, 3), (16, 4, 4),
                                      (7, 2, 2), (36, 2, 2), (32, 4, 4)])
def test_rolled_dense_apply_kernel(cuda, B, nj, ni):
    rng = np.random.default_rng(0)
    M = nj * ni * B
    assert _rolled_close(vcycle.dense_apply, _rand(rng, M, M, device=cuda),
                         _rand(rng, nj, ni, B, device=cuda)) < REL_TOL


@pytest.mark.cuda
def test_rolled_launchers_refuse_wrong_shapes(cuda):
    rng = np.random.default_rng(0)
    lv = _rolled_level(rng, 4, 2, 3, cuda)
    v = _rand(rng, 2, 3, 4, device=cuda)
    with pytest.raises(ValueError, match="inconsistent rolled shapes"):
        _kernels.rolled_half_sweep(lv.blocks, lv.Dinv, v, v[:, :2].contiguous(), 0)
    with pytest.raises(ValueError, match="no 2x2 tiles"):
        _kernels.rolled_transfer(_rand(rng, 4, 4, 4, device=cuda), v, restrict=True)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.rolled_stencil_apply(lv.blocks, v.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(TypeError, match="float32"):
        _kernels.rolled_dense_apply(torch.zeros(24, 24, device=cuda), v.double())


@pytest.mark.cuda
@pytest.mark.parametrize("cycle, coarse", [("V", "smoother"), ("W", "direct"),
                                           ("F", "smoother")])
def test_rolled_cycle_and_solve_on_the_card(cuda, tmp_path, monkeypatch, cycle, coarse):
    """The 8x8 p=5 hierarchy with factors 8,4,2 (six levels down to 1x1): one
    kernel cycle vs the plain cycle on the card, then the mixed route
    through the rolled kernels to 1e-10."""
    import dgtpu_torch.api as tapi
    from dgtpu_torch.settings import Settings, load_params
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    params = load_params()
    mg = params["solver"]["multigrid"]
    mg["geometric coarsening"]["coarsening factors"] = "8,4,2"
    mg["cycle type"], mg["coarse grid solver"] = cycle, coarse
    params["performance"]["precision"] = "mixed"
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    dg = tapi.DGFEM(device="cuda", settings=Settings(params), solve_multigrid=True)
    dims = [(l.Nj, l.Ni) for l in dg.levels]

    def make(**kw):
        return vcycle.RolledVCycle([l.op for l in dg.levels], dg.transfers,
                                   dg.transfer_types, dg.settings, dims, **kw)

    rhs = dg.levels[-1].rhs
    u_k = make()(rhs, torch.zeros_like(rhs))
    u_p = make(reference=True)(rhs, torch.zeros_like(rhs))
    assert float((u_k - u_p).abs().max() / u_p.abs().max()) < REL_TOL
    vcycle.reset_launch_counts()
    soa.reset_launch_counts()
    dg.solve()
    assert dg.cycle_kind == "rolled" and dg.solve_residual < 1e-10
    used = vcycle.KERNELS if coarse == "direct" else vcycle.KERNELS[:3]
    assert all(k.launches > 0 for k in used)
    assert not any(k.launches for k in soa.KERNELS)


def _graph_case(kind):
    """(fn, inputs) of one cycle class at 8x8 on the card: a fixed-shape
    callable the mixed route captures, and random float32 inputs."""
    import chip_smoke
    from dgtpu_torch.settings import Settings
    poisson = kind in ("soa", "hybrid", "hybrid_bf16")
    if poisson or kind.startswith("rolled"):
        factors = "8,4,2" if kind.startswith("rolled") else "2"
        dg = chip_smoke.hierarchy(chip_smoke.settings_for("Rectangle_8X8_nPoly5.xyz", 5,
                                                          factors=factors))
    else:
        dg = chip_smoke.hierarchy(Settings(chip_smoke.stokes_params(8)))
    ops, dims = [l.op for l in dg.levels], [(l.Nj, l.Ni) for l in dg.levels]
    if kind == "soa":
        fn = chip_smoke.cycle_of(dg)
    elif kind.startswith("hybrid"):
        budget = soa.SoAVCycle.device_bytes(ops[:-1], dims[:-1], dg.transfers[:-1])
        fn = chip_smoke.hybrid_of(dg, budget, "bfloat16" if kind.endswith("bf16")
                                  else "float32")
    elif kind == "rolled":
        fn = chip_smoke.rolled_cycle_of(dg)
    elif kind == "rolled_F_direct":
        st = dg.settings
        st.solver.multigrid.cycle_type, st.solver.multigrid.coarse_grid_solver = "F", "direct"
        fn = chip_smoke.rolled_cycle_of(dg, st)
    elif kind.startswith("stokes_hybrid"):
        budget = ss.SoAStokesVCycle.device_bytes(dg.levels[:2], dg.transfers[:1])
        fn = chip_smoke.stokes_hybrid_of(dg, budget)
    else:
        fn = chip_smoke.stokes_cycle_of(dg)
    if kind.endswith("matvec"):
        fn = fn.build_matvec()
    rng = np.random.default_rng(5)
    n = dg.levels[-1].rhs.numel()
    inputs = [tuple(_rand(rng, n, device="cuda") for _ in range(1 if kind.endswith("matvec")
                                                                else 2))
              for _ in range(2)]
    return fn, inputs


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["soa", "rolled", "rolled_F_direct", "stokes",
                                  "stokes_matvec", "hybrid", "hybrid_bf16",
                                  "stokes_hybrid", "stokes_hybrid_matvec"])
def test_cycle_graph_matches_eager_bit_for_bit(cuda, kind):
    """A captured cycle (or Stokes matvec) replayed against the same eager
    call: the same kernels in the same order with no atomics, so the results
    are equal bit for bit.  Each call returns its own tensor, and after n
    replays every launch counter is n times the eager call's count."""
    import chip_smoke
    from dgtpu_torch.ops.graphs import CycleGraph
    fn, inputs = _graph_case(kind)
    g = CycleGraph(fn)
    first = g(*inputs[0])
    assert torch.equal(first, fn(*inputs[0]))
    kept = first.clone()
    assert torch.equal(g(*inputs[1]), fn(*inputs[1]))
    assert torch.equal(first, kept)
    chip_smoke.reset_counts()
    fn(*inputs[0])
    per_call = chip_smoke.counts()
    assert sum(per_call.values()) > 0
    chip_smoke.reset_counts()
    for _ in range(3):
        g(*inputs[1])
    torch.cuda.synchronize()
    assert chip_smoke.counts() == {k: 3 * v for k, v in per_call.items()}
    assert (CycleGraph.replays, CycleGraph.captures) == (3, 0)
    assert g.capture_seconds > 0
    with pytest.raises(ValueError, match="differ from the captured call"):
        g(*(x[:-1] for x in inputs[0]))


# -- the float64 programs dgtpu compiles, as CUDA graphs ---------------------

def _full_route(kind):
    """The assembled 4x4 hierarchy of one full-precision ``-m`` route on the
    card: Poisson p2 ('poisson_<strategy>_<cycle>[_chebyshev]') or Stokes
    p_u=2/p_p=1 ('stokes_<splitting>')."""
    import chip_smoke
    from dgtpu_torch.settings import Settings
    if kind.startswith("stokes"):
        params = chip_smoke.stokes_params(4)
        params["performance"]["precision"] = "full"
        params["performance"]["dgs_splitting"] = kind.split("_", 1)[1]
        return chip_smoke.hierarchy(Settings(params))
    s = chip_smoke.settings_for("Rectangle_4X4_nPoly2.xyz", 2, p_levels="1,2")
    _, strategy, cycle, *smoother = kind.split("_")
    s.performance.precision = "full"
    s.performance.smoother_parallelization = strategy
    s.solver.multigrid.cycle_type = cycle
    for node in (s.solver.multigrid.polynomial_coarsening,
                 s.solver.multigrid.geometric_coarsening):
        for side in (node.pre_smoother, node.post_smoother):
            if smoother:
                side.smoother, side.iterations = smoother[0], 3
    return chip_smoke.hierarchy(s)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["poisson_sequential_V", "poisson_redblack_F",
                                  "poisson_redblack_W_chebyshev", "stokes_lsq",
                                  "stokes_lsq_dense", "stokes_classical_exact"])
def test_multigrid_step_graph_matches_eager(cuda, kind):
    """``MultigridSolver.step`` captured against its eager call on two
    inputs, and the graphed ``solve()`` against the same loop run eagerly:
    the same history, cycle count and solution, bit for bit."""
    from dgtpu_torch.ops.graphs import CycleGraph
    from dgtpu_torch.utils.norms import lp_norm
    dg = _full_route(kind)
    mg = dg._multigrid_solver()
    rhs = dg.levels[-1].rhs
    g = CycleGraph(mg.step, "mg.capture")
    u1 = torch.as_tensor(np.random.default_rng(6).standard_normal(rhs.shape), device="cuda")
    for u in (torch.zeros_like(rhs), u1):
        got, ref = g(rhs, u), mg.step(rhs, u)
        assert isinstance(got, tuple) and all(torch.equal(a, b) for a, b in zip(got, ref))
    u, res, n, hist = mg.solve(rhs)
    assert isinstance(mg.graph, CycleGraph) and mg.graph.capture_seconds > 0
    res0 = float(lp_norm(rhs, 2))
    ue, eager = torch.zeros_like(rhs), [1.0]
    while len(eager) <= n:
        ue, r = mg.step(rhs, ue)
        eager.append(float(r) / res0)
    assert hist == eager and torch.equal(u, ue) and res == hist[-1]


@pytest.mark.cuda
@pytest.mark.parametrize("problem", ["Poisson", "Stokes"])
def test_krylov_preconditioner_graph_matches_eager(cuda, problem):
    """The Krylov multigrid preconditioner runs inside the Krylov step's
    CUDA graph on the card (``graphs.LoopGraph``, ``krylov.capture``): the
    route hands the zero-guess cycle over as a function, the graphed solve
    equals the same masked loop run eagerly bit for bit (iterate and
    restarts), and the route counts the capture."""
    from unittest import mock

    import chip_smoke
    from dgtpu_torch.api import DGFEM
    from dgtpu_torch.ops import graphs
    from dgtpu_torch.settings import Settings
    from dgtpu_torch.solvers.krylov import solve_krylov
    if problem == "Stokes":
        params = chip_smoke.stokes_params(4)
        params["performance"]["precision"] = "full"
        s = Settings(params)
    else:
        s = chip_smoke.settings_for("Rectangle_4X4_nPoly2.xyz", 2, p_levels="1,2")
    s.solver.krylov.preconditioner = "multigrid"
    s.solver.krylov.tolerance, s.solver.krylov.absolute_tolerance = 1e-10, 0.0
    dg = DGFEM(device="cuda", settings=s, solve_krylov=True)
    cycle = dg._krylov_mg_cycle()
    assert not isinstance(cycle, graphs.CycleGraph)
    r = dg.levels[-1].rhs
    assert torch.equal(cycle(r), dg.mg.v_cycle(len(dg.mg.ops), r, torch.zeros_like(r)))
    with graphs.collect() as loops:
        u, k = solve_krylov(dg.levels[-1], dg.settings, mg_cycle=cycle)
    assert len(loops) == 1 and loops[0].name == "krylov.capture"
    assert loops[0].capture_seconds > 0
    with mock.patch.object(graphs, "while_loop", graphs.MaskedLoop):
        ue, ke = solve_krylov(dg.levels[-1], dg.settings, mg_cycle=cycle)
    assert k == ke > 0 and torch.equal(u, ue)
    dg.solve()
    assert dg.graphed and dg.graph_seconds > 0 and dg.krylov_iterations == k


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["cg", "gmres", "smoother", "dgs", "amg"])
def test_loop_graph_matches_eager(cuda, loop):
    """Each of dgtpu's compiled loops as a ``LoopGraph`` (its iteration
    captured once, replayed in runs) on a 4x4 level of the card, against the
    same masked loop run eagerly: iterate, count and history bit for bit,
    one capture, a replay per iteration at least."""
    from unittest import mock

    import chip_smoke
    from dgtpu_torch.models.stokes import distributive_gauss_seidel_solve
    from dgtpu_torch.ops import graphs
    from dgtpu_torch.settings import Settings
    from dgtpu_torch.solvers import amg, krylov
    from dgtpu_torch.solvers.relaxation_driver import residual_tracked_smoother
    if loop == "dgs":
        params = chip_smoke.stokes_params(4)
        params["performance"]["precision"] = "full"
        fin = chip_smoke.hierarchy(Settings(params)).levels[-1]
    else:
        fin = chip_smoke.hierarchy(chip_smoke.settings_for(
            "Rectangle_4X4_nPoly2.xyz", 2, p_levels="1,2")).levels[-1]
    op, rhs = fin.op, fin.rhs
    runs = {"cg": lambda: krylov.cg(op.matvec, rhs, tol=1e-12),
            "gmres": lambda: krylov.gmres(op.matvec, rhs, tol=1e-8, restart=20,
                                          maxiter=50),
            "smoother": lambda: residual_tracked_smoother(op, rhs, max_iterations=300),
            "dgs": lambda: distributive_gauss_seidel_solve(fin, rhs, max_iterations=300),
            "amg": lambda: amg.solve_amg(op, rhs)}
    before = graphs.CycleGraph.replays
    with graphs.collect() as loops:
        got = runs[loop]()
    assert len(loops) == 1 and loops[0].capture_seconds > 0
    with mock.patch.object(graphs, "while_loop", graphs.MaskedLoop):
        ref = runs[loop]()

    def flat(x):
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in flat(x[k])]
        if isinstance(x, tuple):
            return [v for y in x for v in flat(y)]
        if isinstance(x, torch.Tensor):
            x = x.cpu()
        return [torch.as_tensor(np.asarray(x, dtype=np.float64)).view(torch.int64)]

    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(ref)))
    count = got[1]["cycles"] if loop == "amg" else got[1] if loop in ("cg", "gmres") \
        else got[2]
    assert count > 0 and graphs.CycleGraph.replays - before >= count


@pytest.mark.cuda
@pytest.mark.parametrize("way", ["staged", "one"])
def test_gmres_step_graph_matches_eager(cuda, way):
    """The GMRES(16) correction step over the 4x4 Stokes SoA W-cycle and
    matvec, against its eager call on two inputs bit for bit: as the mixed
    route runs it ('staged': the cycle, the matvec and each of the 18
    arithmetic stages a graph of its own) and captured whole ('one'); after
    3 calls every launch counter is 3 x the eager step's."""
    import chip_smoke
    from dgtpu_torch.ops.graphs import CycleGraph
    from dgtpu_torch.settings import Settings
    from dgtpu_torch.solvers.refinement import gmres_step
    dg = chip_smoke.hierarchy(Settings(chip_smoke.stokes_params(4)))
    cycle = chip_smoke.stokes_cycle_of(dg)
    matvec = cycle.build_matvec()
    eager = gmres_step(matvec, cycle, 16)
    graphs = []

    def graph(fn, name="refine.capture"):
        graphs.append(CycleGraph(fn, name))
        return graphs[-1]

    if way == "staged":
        step = gmres_step(graph(matvec), graph(cycle), 16, graph=graph)
    else:
        step = graph(gmres_step(matvec, cycle, 16))
    rng = np.random.default_rng(8)
    inputs = [_rand(rng, dg.levels[-1].rhs.numel(), device="cuda") for _ in range(2)]
    for r in inputs:
        assert torch.equal(step(r), eager(r))
    assert len(graphs) == (20 if way == "staged" else 1)
    chip_smoke.reset_counts()
    eager(inputs[0])
    per_call = chip_smoke.counts()
    assert sum(per_call.values()) > 0
    chip_smoke.reset_counts()
    for _ in range(3):
        step(inputs[1])
    torch.cuda.synchronize()
    assert chip_smoke.counts() == {k: 3 * v for k, v in per_call.items()}
    assert all(g.warmup_seconds > 0 and g.instantiate_seconds > 0 for g in graphs)
