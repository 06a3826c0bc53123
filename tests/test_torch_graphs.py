"""The mixed route's cycles replayed as CUDA graphs (``ops/graphs.py``): what
the CPU can check.

A capture refuses a host-to-device copy, so the cycles' layout conversions
(``to_soa`` / ``from_soa`` of the SoA and Stokes cycles, inherited by the
streamed hybrids) build their row-parity mask once, with the cycle; here
they are held bit for bit to the per-call construction they replaced, on
even and odd row counts and on the 4x4 O-grid, and a single-level SoA cycle
on an odd row count to dgtpu's ``build_xla``.  K3's plain version is held to
``x @ W`` (+ base) at the shapes of both kernel bodies.  ``CycleGraph``
refuses CPU tensors, and the CPU route runs its cycle unwrapped with the
errors it had.  Graph against eager on the card: ``tests/test_torch_kernels.py``.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgtpu.api import DGFEM as JDGFEM
from dgtpu.ops.pallas_soa import SoAVCycle as JSoAVCycle
from dgtpu.ops.stencil import StencilOperator as JStencilOperator
from dgtpu.settings import Settings as JSettings
from dgtpu.settings import load_params as jload_params

import dgtpu_torch.api as tapi
from dgtpu_torch.convert import StokesLevel
from dgtpu_torch.ops import rolled, soa
from dgtpu_torch.ops.graphs import CycleGraph
from dgtpu_torch.ops.soa import SoAVCycle
from dgtpu_torch.ops.stencil import StencilOperator
from dgtpu_torch.ops.stokes_soa import SoAStokesVCycle
from dgtpu_torch.settings import Settings, load_params

torch.set_num_threads(1)
TOL = 1e-11


def _stencil_arrays(rng, nj, ni, Br, Bc, periodic=False, dominant=True):
    """blocks (N, 5, Br, Bc), nbr, mask of a 5-point stencil on an (nj, ni)
    lattice, slots [self, iL, iR, jL, jR]; zero blocks where no neighbor."""
    n = nj * ni
    j, i = np.divmod(np.arange(n), ni)
    nbr = np.tile(np.arange(n)[:, None], (1, 5))
    mask = np.ones((n, 5), bool)
    for s, (dj, di) in enumerate(((0, -1), (0, 1), (-1, 0), (1, 0)), start=1):
        jj, ii = j + dj, i + di
        if periodic:
            ii = ii % ni
        ok = (jj >= 0) & (jj < nj) & (ii >= 0) & (ii < ni)
        nbr[ok, s] = jj[ok] * ni + ii[ok]
        mask[:, s] = ok
    blocks = rng.standard_normal((n, 5, Br, Bc)) * mask[:, :, None, None]
    if dominant:
        blocks[:, 0] += 4 * max(Br, Bc) * np.eye(Br, Bc)
    return blocks, nbr, mask


def _op(arrays):
    b, nbr, mask = arrays
    return StencilOperator(torch.as_tensor(b), torch.as_tensor(nbr),
                           torch.as_tensor(mask))


def _old_to_soa(v, nj, ni):
    """The per-call packing the hoisted mask replaced."""
    B = v.numel() // (nj * ni)
    v = v.reshape(nj, ni, B)
    u0, u1 = rolled.pack_colors(v, rolled.parity_mask(nj, v.dtype, v.device))
    return torch.stack([u0.reshape(-1, B).T, u1.reshape(-1, B).T]).contiguous()


def _old_from_soa(u, nj, ni):
    B = u.shape[1]
    ev = rolled.parity_mask(nj, u.dtype, u.device)
    return rolled.unpack_colors(u[0].T.reshape(nj, ni // 2, B),
                                u[1].T.reshape(nj, ni // 2, B), ev).reshape(-1)


def _no_parity_masks(monkeypatch):
    """From here on, building a parity mask fails: the layout conversions
    must use the one their cycle built."""
    def refuse(*args, **kwargs):
        raise AssertionError("a parity mask was built per call")
    monkeypatch.setattr(rolled, "parity_mask", refuse)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nj, ni, periodic", [(3, 4, False), (4, 4, False),
                                              (5, 2, False), (4, 4, True)])
def test_soa_layout_uses_the_hoisted_mask(monkeypatch, nj, ni, periodic, dtype):
    rng = np.random.default_rng(0)
    cyc = SoAVCycle([_op(_stencil_arrays(rng, nj, ni, 4, 4, periodic))], [], [],
                    Settings(load_params()), [(nj, ni)], dtype=dtype)
    assert cyc.periodic == [periodic and ni > 2]
    v = torch.as_tensor(rng.standard_normal(nj * ni * 4), dtype=dtype)
    old = _old_to_soa(v, nj, ni)
    old_back = _old_from_soa(old, nj, ni)
    _no_parity_masks(monkeypatch)
    new = cyc.to_soa(v)
    assert torch.equal(new, old)
    assert torch.equal(cyc.from_soa(new), old_back)
    assert torch.equal(cyc.from_soa(new), v)


def _stokes_hierarchy(rng, nj, ni, p_u=1, p_p=0):
    nu, npd = (p_u + 1) ** 2, (p_p + 1) ** 2
    A = _op(_stencil_arrays(rng, nj, ni, 2 * nu, 2 * nu))
    D = _op(_stencil_arrays(rng, nj, ni, npd, 2 * nu, dominant=False))
    G = _op(_stencil_arrays(rng, nj, ni, 2 * nu, npd, dominant=False))
    return StokesLevel(nj, ni, p_u, p_p, A, D, G)


@pytest.mark.parametrize("nj, ni", [(3, 4), (4, 4), (1, 2)])
def test_stokes_layout_uses_the_hoisted_mask(monkeypatch, nj, ni):
    rng = np.random.default_rng(1)
    lvl = _stokes_hierarchy(rng, nj, ni)
    cyc = SoAStokesVCycle([lvl], [], [], Settings(load_params()),
                          dtype=torch.float64)
    n, nu, npd = nj * ni, 4, 1
    x = torch.as_tensor(rng.standard_normal(n * (2 * nu + npd)))
    uv_e = torch.cat([x[:n * nu].reshape(n, nu), x[n * nu:2 * n * nu].reshape(n, nu)],
                     dim=1).reshape(-1)
    old_uv, old_p = _old_to_soa(uv_e, nj, ni), _old_to_soa(x[2 * n * nu:], nj, ni)
    _no_parity_masks(monkeypatch)
    uv, p = cyc.to_soa(x)
    assert torch.equal(uv, old_uv) and torch.equal(p, old_p)
    assert torch.equal(cyc.from_soa(uv, p), x)


def test_ogrid_route_layout_uses_the_hoisted_mask(tmp_path, monkeypatch):
    """The 4x4 O-grid hierarchy the port assembles (CircleInCircle_4X4_nPoly2)."""
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    params = load_params()
    params["grid"]["filename"] = "CircleInCircle_4X4_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["grid"]["O grid"] = params["grid"]["circular"] = True
    params["solution"]["u"]["polynomial degree"] = 2
    params["problem"]["SIP penalty parameter multiplier"] = 2
    params["solver"]["multigrid"]["polynomial coarsening"]["levels"]["u"] = "1,2"
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    dg = tapi.DGFEM(device="cpu", settings=Settings(params), solve_multigrid=True)
    dims = [(l.Nj, l.Ni) for l in dg.levels]
    cyc = SoAVCycle([l.op for l in dg.levels], dg.transfers, dg.transfer_types,
                    dg.settings, dims, dtype=torch.float64)
    assert all(cyc.periodic)
    v = dg.levels[-1].rhs
    nj, ni = dims[-1]
    old = _old_to_soa(v, nj, ni)
    _no_parity_masks(monkeypatch)
    assert torch.equal(cyc.to_soa(v), old)
    assert torch.equal(cyc.from_soa(old), v)


@pytest.mark.parametrize("coarse", ["smoother", "direct"])
def test_odd_row_soa_cycle_matches_build_xla(coarse):
    """A one-level SoA cycle on a 3x4 lattice (an odd row count, so the
    parity mask is not symmetric) against dgtpu's on the same operator."""
    rng = np.random.default_rng(2)
    arrays = _stencil_arrays(rng, 3, 4, 4, 4)
    jparams = jload_params()
    jparams["solver"]["multigrid"]["coarse grid solver"] = coarse
    js = JSettings(jparams)
    ts = Settings(load_params())
    ts.solver.multigrid.coarse_grid_solver = coarse
    jop = JStencilOperator(*(jnp.asarray(a) for a in arrays))
    j = JSoAVCycle([jop], [], [], js, [(3, 4)], dtype=jnp.float64, interpret=True)
    t = SoAVCycle([_op(arrays)], [], [], ts, [(3, 4)], dtype=torch.float64)
    rhs = rng.standard_normal(48)
    ref, got = jnp.zeros(48), torch.zeros(48, dtype=torch.float64)
    cycle = j.build_xla()
    for _ in range(2):
        ref = cycle(jnp.asarray(rhs), ref)
        got = t(torch.as_tensor(rhs), got)
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < TOL


@pytest.mark.parametrize("M, K, N, batch, base", [
    (16, 36, 32, 2, False), (36, 16, 32, 2, True), (4, 16, 2048, 2, True),
    (12, 6, 8, 2, True), (64, 64, 1, 1, False), (28, 28, 1, 1, True),
    (63, 63, 1, 2, False)])
def test_small_gemm_plain_is_x_at_w(M, K, N, batch, base):
    """K3's plain version: out[z] = (base[z] +) W x[z], at the shapes of its
    tile body (N > 1, the transfers) and its dense body (N = 1, the coarse
    inverse)."""
    rng = np.random.default_rng(3)
    W, x = rng.standard_normal((M, K)), rng.standard_normal((batch, K, N))
    b = rng.standard_normal((batch, M, N)) if base else None
    ref = np.einsum("mk,zkn->zmn", W, x) + (b if base else 0)
    got = soa.small_gemm(torch.as_tensor(W), torch.as_tensor(x),
                         None if b is None else torch.as_tensor(b))
    assert np.abs(got.numpy() - ref).max() < 1e-12 * np.abs(ref).max()


def test_cycle_graph_refuses_cpu_tensors():
    rng = np.random.default_rng(4)
    cyc = SoAVCycle([_op(_stencil_arrays(rng, 2, 4, 4, 4))], [], [],
                    Settings(load_params()), [(2, 4)])
    g = CycleGraph(cyc)
    v = torch.zeros(32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        g(v, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        CycleGraph(lambda x: x)(np.zeros(3))
    assert g.graph is None and CycleGraph.captures == 0


def _params(factors):
    params = load_params()
    params["grid"]["filename"] = "Rectangle_4X4_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["solution"]["u"]["polynomial degree"] = 2
    mg = params["solver"]["multigrid"]
    mg["polynomial coarsening"]["levels"]["u"] = "1,2"
    mg["geometric coarsening"]["coarsening factors"] = factors
    params["performance"]["precision"] = "mixed"
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    return params


@pytest.mark.parametrize("factors, kind", [("2", "SoA"), ("4,2", "rolled")])
def test_cpu_route_runs_its_cycle_unwrapped(tmp_path, monkeypatch, factors, kind):
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    built = []
    monkeypatch.setattr(tapi, "CycleGraph", lambda fn: built.append(fn) or fn)
    dg = tapi.DGFEM(device="cpu", settings=Settings(copy.deepcopy(_params(factors))),
                    solve_multigrid=True)
    dg.solve()
    assert dg.cycle_kind == kind and not built
    assert dg.graphed is False and dg.graph_seconds == 0.0
    assert dg.solve_residual < 1e-10
    ref = JDGFEM(settings=JSettings(_params(factors)), solve_multigrid=True)
    ref.solve()
    assert dg.L1_error_u == pytest.approx(ref.L1_error_u, rel=1e-8)
    assert dg.L2_error_u == pytest.approx(ref.L2_error_u, rel=1e-8)
