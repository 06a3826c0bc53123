"""dgtpu_torch's streamed Stokes hybrid (``ops/stokes_stream.py``, plain
torch path, float64) against dgtpu, and the Stokes route's choice of it.

Hierarchy: the 4x4 p_u=2/p_p=1 Stokes flagship settings
(``bench._stokes_settings(4)``, the hierarchy of tests/test_stokes_stream.py
and test_torch_stokes_soa.py: levels (2,2) p1/p0, (4,4) p1/p0, (4,4) p2/p1),
carried across from dgtpu.  dgtpu's streamed Stokes cycle runs only in its
slow lane, so the hybrid is held to dgtpu's ``SoAStokesVCycle.build_xla()``:
dgtpu's docstring gives both the same update math
(pallas_stokes_stream.py:20-22).  Bars: the rectangular G/D (and A)
StreamedLevels against dgtpu's < 1e-13; the hybrid's V/W cycles
< 1e-11 (dgtpu's own bar between its Stokes builds); build_matvec against
dgtpu's finest operator < 1e-12; the route's errors within 1e-6 of dgtpu's
direct solve.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgtpu.ops.pallas_stream import StreamedLevel as JStreamedLevel

import dgtpu_torch.api as tapi
from dgtpu_torch.ops.stokes_soa import SoAStokesVCycle
from dgtpu_torch.ops.stokes_stream import StreamedStokesVCycle
from dgtpu_torch.ops.stream import StreamedLevel
from dgtpu_torch.settings import Settings
from test_torch_stokes_assembly import port_settings
from test_torch_stokes_slice import ERRORS, ERR_TOL, direct  # noqa: F401
from test_torch_stokes_soa import _cycles, _pair, _rel, hier  # noqa: F401

torch.set_num_threads(1)
CYCLE_TOL = 1e-11


def _settings(dg, cycle, coarse="direct"):
    s = copy.deepcopy(dg.settings)
    s.solver.multigrid.cycle_type = cycle
    s.solver.multigrid.coarse_grid_solver = coarse
    return Settings(s.to_dict())


def _hybrid(hier, cycle, cut=1, **kw):  # noqa: F811
    dg, (levels, transfers) = hier
    s = _settings(dg, cycle)
    budget = SoAStokesVCycle.device_bytes(levels[:cut], transfers[:cut - 1],
                                          torch.float64)
    h = StreamedStokesVCycle(levels, transfers, dg.transfer_types, s, budget,
                             dtype=torch.float64, **kw)
    assert h.cut == cut < h.n_lev
    return h


@pytest.mark.parametrize("comp", ["A", "G", "D"])
def test_component_streamed_levels_match_dgtpu(hier, comp):  # noqa: F811
    """Square A and rectangular G (p -> momentum rows) and D (uv ->
    continuity rows) streamed levels, multi-chunk on dgtpu's side."""
    dg, (levels, _) = hier
    jl, tl = dg.levels[-1], levels[-1]
    j = JStreamedLevel(getattr(jl, f"block_{comp}"), jl.Nj, jl.Ni, dtype=jnp.float64,
                       interpret=True, chunk_lanes=4, align=2)
    t = StreamedLevel(getattr(tl, f"block_{comp}"), tl.Nj, tl.Ni, dtype=torch.float64)
    assert (j.B_src, j.B_dst) == (t.B_src, t.B_dst) and j.n_chunks > 1
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, t.B_src, t.C))
    r = rng.standard_normal((2, t.B_dst, t.C))
    tx, tr = torch.as_tensor(x), torch.as_tensor(r)
    assert _rel(t.matvec()(tx), j.matvec()(x)) < 1e-13
    assert _rel(t.residual()(tr, tx), j.residual()(r, x)) < 1e-13
    for c in (0, 1):
        assert _rel(t.matvec_color(c)(tx), j.matvec_color(c)(x)) < 1e-13, c
    if comp == "A":
        assert _rel(t.half_sweeps(4)(tr, tx), j.half_sweeps(4)(r, x)) < 1e-13


@pytest.mark.parametrize("cycle", ["V", "W"])
def test_hybrid_matches_build_xla(hier, cycle):  # noqa: F811
    """Cut at 1 of 3 levels: two streamed levels, and the W-cycle revisits
    the streamed middle level."""
    j, _ = _pair(hier, cycle=cycle)
    h = _hybrid(hier, cycle)
    rhs = np.array(hier[0].levels[-1].rhs)
    ref = _cycles(j.build_xla(), jnp.asarray(rhs))
    assert _rel(_cycles(h, torch.as_tensor(rhs)), ref) < CYCLE_TOL


def test_hybrid_fmg_matches_the_soa_fmg(hier):  # noqa: F811
    """The hybrid's FMG (the subtree's FMG, then one cycle per streamed
    level) against the SoA cycle's, which test_torch_stokes_fmg.py holds to
    dgtpu's build_fmg (dgtpu's FMG graph is too slow to compile twice in
    this lane)."""
    _, t = _pair(hier, cycle="W")
    rhs = torch.as_tensor(np.array(hier[0].levels[-1].rhs))
    ref = t.build_fmg(finest_cycle=t)(rhs)
    for cut in (1, 2):
        h = _hybrid(hier, "W", cut=cut)
        assert _rel(h.build_fmg(finest_cycle=h)(rhs), ref) < CYCLE_TOL, cut


def test_hybrid_matvec_matches(hier):  # noqa: F811
    dg = hier[0]
    x = np.random.default_rng(7).standard_normal(dg.levels[-1].rhs.shape[0])
    y_ref = np.asarray(dg.levels[-1].op.matvec(jnp.asarray(x)))
    assert _rel(_hybrid(hier, "W").build_matvec()(torch.as_tensor(x)), y_ref) < 1e-12


def test_hybrid_validation(hier):  # noqa: F811
    dg, (levels, transfers) = hier
    with pytest.raises(NotImplementedError, match="V and W"):
        StreamedStokesVCycle(levels, transfers, dg.transfer_types,
                             _settings(dg, "F"), 1 << 40)
    s = _settings(dg, "W")
    s.solver.multigrid.geometric_coarsening.post_smoother.smoother = "jacobi"
    with pytest.raises(ValueError, match="distributive"):
        StreamedStokesVCycle(levels, transfers, dg.transfer_types, s, 1 << 40)
    with pytest.raises(ValueError, match="coarsest"):
        StreamedStokesVCycle(levels, transfers, dg.transfer_types,
                             _settings(dg, "W"), 1000)


@pytest.mark.parametrize("coarse", ["smoother", "direct"])
def test_device_bytes_counts_the_built_cycle(hier, coarse):  # noqa: F811
    dg, (levels, transfers) = hier
    cyc = SoAStokesVCycle(levels, transfers, dg.transfer_types,
                          _settings(dg, "W", coarse))
    held = [getattr(lv, n) for lv in cyc.levels
            for n in ("A", "G", "D", "A_Dinv", "DG_diag", "DG_Dinv", "masks")]
    held += [x for pair in cyc.R + cyc.P if pair is not None for x in pair]
    held += [cyc.coarse_W] if cyc.coarse_W is not None else []
    assert SoAStokesVCycle.device_bytes(levels, transfers,
                                        with_coarse=coarse == "direct") \
        == sum(x.nbytes for x in held)


@pytest.fixture(scope="module")
def route(tmp_path_factory):
    """The 4x4 Stokes route with the budget set to the SoA bytes of the
    coarsest level: two streamed levels; float32 and bfloat16 storage."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "OUTPUT_ROOT", str(tmp_path_factory.mktemp("out")))
        for storage in ("float32", "bfloat16"):
            dg = tapi.DGFEM(device="cpu", solve_multigrid=True, settings=port_settings(
                4, **{"performance.block_storage": storage}))
            budget = SoAStokesVCycle.device_bytes(dg.levels[:1], [])
            mp.setattr(tapi, "stream_budget", lambda device, b=budget: b)
            dg.solve()
            out[storage] = dg
    return out


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_route_runs_the_streamed_stokes_hybrid(route, direct, storage):  # noqa: F811
    dg = route[storage]
    assert dg.cycle_kind == "streamed Stokes hybrid" and dg.cut == 1
    assert dg.solve_residual < 1e-10
    for name in ERRORS:
        assert getattr(dg, name) == pytest.approx(getattr(direct, name),
                                                  rel=ERR_TOL), name
