"""dgtpu_torch's streamed level and hybrid Poisson cycle (``ops/stream.py``,
plain torch path) against dgtpu's ``StreamedLevel`` / ``StreamedVCycle``
(Pallas in interpret mode on the CPU) on the same operators, and the
Poisson route's choice of the hybrid.

Hierarchy: dgtpu's own fixture of tests/test_pallas_stream.py (8x8 p=2,
p 2->1 plus one geometric level), carried across with
``convert.from_dgtpu_arrays``; the O-grid case is the CircleInCircle 4x4 p=2
grid of the same file.  Bars (float64 unless stated): StreamedLevel's
methods < 1e-13 relative to max|dgtpu|; bfloat16 storage in float32 < 1e-5
relative (both upconvert the same bfloat16 values, only the summation
order differs); hybrid cycles and FMG at the same cut < 1e-12.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from dgtpu.api import DGFEM as JDGFEM
from dgtpu.ops.pallas_soa import SoAVCycle as JSoAVCycle
from dgtpu.ops.pallas_stream import StreamedLevel as JStreamedLevel
from dgtpu.ops.pallas_stream import StreamedVCycle as JStreamedVCycle
from dgtpu.settings import Settings as JSettings
from dgtpu.settings import load_params as j_load_params

import dgtpu_torch.api as tapi
from dgtpu_torch.convert import from_dgtpu_arrays
from dgtpu_torch.ops import soa, stream
from dgtpu_torch.ops.soa import SoAVCycle
from dgtpu_torch.ops.stream import StreamedLevel, StreamedVCycle
from dgtpu_torch.settings import Settings, load_params

torch.set_num_threads(1)
LEVEL_TOL = 1e-13
BF16_TOL = 1e-5
CYCLE_TOL = 1e-12
DGTPU_L2_8X8_P5 = 5.109734421089843e-06   # chip_smoke.py: dgtpu's mixed route


def _carry(dg):
    dims = [(l.Nj, l.Ni) for l in dg.levels]
    ops, trs = from_dgtpu_arrays(
        [dict(blocks=np.asarray(l.op.blocks), nbr=np.asarray(l.op.nbr),
              mask=np.asarray(l.op.mask)) for l in dg.levels],
        [dict(kind=t.kind, R=np.asarray(t.R), P=np.asarray(t.P))
         for t in dg.transfers], dg.transfer_types, dims)
    return dg, ops, trs, dims


@pytest.fixture(scope="module")
def flagship():
    return _carry(__graft_entry__._flagship(n=8, p_grid=2, p_sol=2))


@pytest.fixture(scope="module")
def ogrid():
    params = j_load_params()
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
    return _carry(JDGFEM(settings=s, solve_multigrid=True))


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _levels(fix, k=-1, dtype=jnp.float64, tdtype=torch.float64, **kw):
    """(dgtpu StreamedLevel, port StreamedLevel) of level k; ``kw`` are
    dgtpu's chunking options plus the shared storage options."""
    dg, ops, _, dims = fix
    nj, ni = dims[k]
    storage = {n: kw[n] for n in ("block_storage", "res_storage") if n in kw}
    j = JStreamedLevel(dg.levels[k].op, nj, ni, dtype=dtype, interpret=True, **kw)
    return j, StreamedLevel(ops[k], nj, ni, dtype=tdtype, **storage)


def _inputs(st, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    B, C = st.B_src, st.C
    return [rng.standard_normal((2, B, C)).astype(dtype) for _ in range(2)]


def _check_level(j, t, r, u, tol, n_half=(4, 8)):
    tt = lambda a: torch.as_tensor(a)            # noqa: E731
    for n in n_half:
        assert _rel(t.half_sweeps(n)(tt(r), tt(u)), j.half_sweeps(n)(r, u)) < tol, n
    assert _rel(t.residual()(tt(r), tt(u)), j.residual()(r, u)) < tol
    assert _rel(t.matvec()(tt(u)), j.matvec()(u)) < tol
    for c in (0, 1):
        assert _rel(t.matvec_color(c)(tt(u)), j.matvec_color(c)(u)) < tol, c


@pytest.mark.parametrize("chunks", [{}, dict(chunk_lanes=8, align=4)],
                         ids=["single-chunk", "multi-chunk"])
def test_streamed_level_matches_dgtpu(flagship, chunks):
    j, t = _levels(flagship, **chunks)
    assert (j.n_chunks > 1) == bool(chunks)
    _check_level(j, t, *_inputs(t, 0), LEVEL_TOL)


def test_streamed_level_ogrid_matches_dgtpu(ogrid):
    j, t = _levels(ogrid, chunk_lanes=4, align=2, resident_budget=0)
    assert t.periodic and j.periodic and j.n_chunks > 1
    _check_level(j, t, *_inputs(t, 1), LEVEL_TOL, n_half=(4,))


def test_streamed_level_bf16_matches_dgtpu(flagship):
    """bfloat16 sweep and residual blocks in a float32 level."""
    j, t = _levels(flagship, dtype=jnp.float32, tdtype=torch.float32,
                   block_storage="bfloat16", res_storage="bfloat16")
    assert j.A_sweep.dtype == jnp.bfloat16 and j.A_res.dtype == jnp.bfloat16
    assert t.sweep[0].dtype == t.res.dtype == torch.bfloat16
    assert t.sweep[1].data_ptr() == t.sweep[0].data_ptr()   # Dinv is slot 0
    r, u = _inputs(t, 2, np.float32)
    _check_level(j, t, r, u, BF16_TOL, n_half=(4,))


def test_multi_half_sweep_is_repeated_half_sweeps(flagship):
    """K7's plain version = n of K1's in float32 storage (both colors
    alternate from u), and a zero start equals starting from zeros."""
    _, t = _levels(flagship)
    r, u = (torch.as_tensor(a) for a in _inputs(t, 3))
    ref = u
    lv = soa.SoALevel(t.res, t.lv.Dinv, t.lv.masks, t.lv.nj, t.lv.ni, t.periodic)
    for h in range(6):
        ref = soa.half_sweep_plain(lv, r, ref, h % 2)
    assert torch.equal(t.half_sweeps(6)(r, u), ref)
    zero = t.half_sweeps(4)(r, torch.zeros_like(u))
    assert torch.equal(t.half_sweeps(4)(r, None), zero)
    assert torch.equal(t.half_sweeps(4)(r, None, base=u), u + zero)


def _budgets(fix, cut, coarse):
    """(dgtpu vmem_budget, port budget) that cut both hybrids at ``cut``."""
    dg, ops, trs, dims = fix
    j = JSoAVCycle.estimated_vmem_bytes([l.op for l in dg.levels[:cut]], dims[:cut],
                                        dg.transfers[:cut - 1], dtype=jnp.float64,
                                        with_coarse=True)
    t = SoAVCycle.device_bytes(ops[:cut], dims[:cut], trs[:cut - 1], torch.float64,
                               with_coarse=coarse)
    return j, t


def _hybrids(fix, cycle, storage, cut):
    dg, ops, trs, dims = fix
    s = copy.deepcopy(dg.settings)
    s.solver.multigrid.cycle_type = cycle
    jb, tb = _budgets(fix, cut, s.solver.multigrid.coarse_grid_solver != "smoother")
    j = JStreamedVCycle([l.op for l in dg.levels], dg.transfers, dg.transfer_types, s,
                        dims, dtype=jnp.float64, interpret=True, vmem_budget=jb,
                        chunk_lanes=8, block_storage=storage)
    t = StreamedVCycle(ops, trs, dg.transfer_types, Settings(s.to_dict()), dims, tb,
                       dtype=torch.float64, block_storage=storage)
    assert t.cut == j.cut == cut < t.n_lev
    return j, t


@pytest.mark.parametrize("cycle, storage, cut", [
    ("V", "float32", 2), ("W", "float32", 1), ("V", "bfloat16", 1),
    ("W", "bfloat16", 2)])
def test_hybrid_cycle_matches_dgtpu(flagship, cycle, storage, cut):
    """Three cycles from zero; W at cut 1 revisits a streamed level, W at
    cut 2 re-runs the SoA subtree; bfloat16 storage runs the defect-form
    smoother (float64 here, so no narrowing)."""
    j, t = _hybrids(flagship, cycle, storage, cut)
    rhs = np.array(flagship[0].levels[-1].rhs)
    fj, uj, ut = j.build(), jnp.zeros_like(rhs), torch.zeros(rhs.shape, dtype=torch.float64)
    for _ in range(3):
        uj = fj(jnp.asarray(rhs), uj)
        ut = t(torch.as_tensor(rhs), ut)
    assert _rel(ut, uj) < CYCLE_TOL


def test_hybrid_fmg_matches_dgtpu(flagship):
    j, t = _hybrids(flagship, "V", "float32", 1)
    j.build()
    rhs = np.array(flagship[0].levels[-1].rhs)
    ref = j.build_fmg()(jnp.asarray(rhs))
    assert _rel(t.build_fmg(finest_cycle=t)(torch.as_tensor(rhs)), ref) < CYCLE_TOL


def test_hybrid_rejects_what_dgtpu_rejects(flagship):
    dg, ops, trs, dims = flagship
    s = Settings(dg.settings.to_dict())
    s.solver.multigrid.cycle_type = "F"
    with pytest.raises(NotImplementedError, match="V and W"):
        StreamedVCycle(ops, trs, dg.transfer_types, s, dims, 1 << 40)
    s.solver.multigrid.cycle_type = "V"
    with pytest.raises(ValueError, match="coarsest"):
        StreamedVCycle(ops, trs, dg.transfer_types, s, dims, 1000)


@pytest.mark.parametrize("coarse", ["smoother", "direct"])
def test_device_bytes_counts_the_built_cycle(flagship, coarse):
    dg, ops, trs, dims = flagship
    s = Settings(dg.settings.to_dict())
    s.solver.multigrid.coarse_grid_solver = coarse
    cyc = SoAVCycle(ops, trs, dg.transfer_types, s, dims)
    held = [x for lv in cyc.levels for x in (lv.blocks, lv.Dinv, lv.masks)]
    held += [x for x in cyc.R + cyc.P + [cyc.coarse_W] if x is not None]
    assert SoAVCycle.device_bytes(ops, dims, trs, with_coarse=coarse == "direct") \
        == sum(x.nbytes for x in held)


def test_bytes_per_cycle_counts_the_operands(flagship):
    """A V-cycle cut at 2 of 3 levels (smoother coarse solve): the streamed
    finest level's K7 half-sweeps (one color's off-diagonal slots and Dinv
    each; the finest level starts from u, so none skips the slots), its K5
    residual and transfer, then the SoA subtree's K1 half-sweeps, residual,
    transfer and the 40 coarse half-sweeps."""
    _, t = _hybrids(flagship, "V", "float32", 2)
    nb = lambda x: x.numel() * x.element_size()     # noqa: E731

    def level(blocks, Dinv, res, n_half, k):
        return n_half * (nb(blocks[0, 1:]) + nb(Dinv[0])) + nb(res) \
            + nb(t.R[k - 1]) + nb(t.P[k - 1])

    pre, post = t._cfg[t.types[1]]
    s = t.streams[2]
    top = level(*s.sweep, s.res, 4 * (pre + post), 2)
    lv, lv0 = t.sub.levels[1], t.sub.levels[0]
    pre1, post1 = t.sub._cfg[t.sub.types[0]]
    sub = level(lv.blocks, lv.Dinv, lv.blocks, 4 * (pre1 + post1), 1) \
        + 40 * (nb(lv0.blocks[0, 1:]) + nb(lv0.Dinv[0]))
    assert t.bytes_per_cycle() == top + sub


def test_cpu_tensors_take_the_plain_path(flagship):
    dg, ops, trs, dims = flagship
    budget = _budgets(flagship, 1, False)[1]
    s = Settings(dg.settings.to_dict())
    t, ref = (StreamedVCycle(ops, trs, dg.transfer_types, s, dims, budget,
                             dtype=torch.float64, block_storage="bfloat16",
                             reference=r) for r in (False, True))
    soa.reset_launch_counts()
    stream.reset_launch_counts()
    rhs = torch.as_tensor(np.array(dg.levels[-1].rhs))
    assert torch.equal(t(rhs, rhs * 0), ref(rhs, rhs * 0))
    assert [k.launches for k in soa.KERNELS + stream.KERNELS] == [0] * 5


# -- the route ---------------------------------------------------------------

def _route_params(storage):
    params = load_params()
    params["performance"]["precision"] = "mixed"
    params["performance"]["block storage"] = storage
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    return params


@pytest.fixture(scope="module")
def route(tmp_path_factory):
    """The 8x8 p=5 route (input/paramfile.yml) with the budget set to the
    SoA bytes of every level but the finest; float32 and bfloat16 storage."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "OUTPUT_ROOT", str(tmp_path_factory.mktemp("out")))
        for storage in ("float32", "bfloat16"):
            dg = tapi.DGFEM(device="cpu", settings=Settings(_route_params(storage)),
                            solve_multigrid=True)
            ops, dims = [l.op for l in dg.levels], [(l.Nj, l.Ni) for l in dg.levels]
            budget = SoAVCycle.device_bytes(ops[:-1], dims[:-1], dg.transfers[:-1],
                                            with_coarse=False)
            mp.setattr(tapi, "stream_budget", lambda device, b=budget: b)
            dg.solve()
            out[storage] = dg
    return out


def test_route_runs_the_streamed_hybrid(route):
    dg = route["float32"]
    assert dg.cycle_kind == "streamed hybrid" and dg.cut == len(dg.levels) - 1
    assert dg.solve_residual < 1e-10
    assert dg.L2_error_u == pytest.approx(DGTPU_L2_8X8_P5, rel=1e-6)


def test_route_bf16_storage_reaches_1e10(route):
    dg = route["bfloat16"]
    assert dg.cycle_kind == "streamed hybrid" and dg.solve_residual < 1e-10
    assert dg.L2_error_u == pytest.approx(DGTPU_L2_8X8_P5, rel=1e-6)


def test_route_stays_soa_without_a_budget(tmp_path, monkeypatch):
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    assert tapi.stream_budget(torch.device("cpu")) is None
    params = _route_params("float32")
    params["grid"]["filename"] = "Rectangle_4X4_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["solution"]["u"]["polynomial degree"] = 2
    params["solver"]["multigrid"]["polynomial coarsening"]["levels"]["u"] = "1,2"
    dg = tapi.DGFEM(device="cpu", settings=Settings(params), solve_multigrid=True)
    dg.solve()
    assert dg.cycle_kind == "SoA" and dg.cut is None and dg.solve_residual < 1e-10
    # an F-cycle past the budget: dgtpu falls back to its rolled cycle there,
    # and so does the port
    monkeypatch.setattr(tapi, "stream_budget", lambda device: 1)
    dg.settings.solver.multigrid.cycle_type = "F"
    l2 = dg.L2_error_u
    dg.solve()
    assert dg.cycle_kind == "rolled" and dg.cut is None and dg.solve_residual < 1e-10
    assert dg.L2_error_u == pytest.approx(l2, rel=1e-8)
