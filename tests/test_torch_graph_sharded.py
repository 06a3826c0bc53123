"""The sharded solves as dgtpu compiles them (``parallel/halo.py``,
``parallel/stokes_halo.py``): on one card CUDA graphs, on the CPU the same
code run eagerly with masked loops, across cards host loops.

On the CPU (every shard on ``cpu``):
- the full-precision Poisson and Stokes solves over 1, 2 and 4 shards
  (``halo.solve_cycles`` as a ``MaskedLoop``) and the refined solves
  (``inner='cycles'``; Stokes also ``inner='gmres'``) equal, bit for bit in
  solution, history and count, ``_host_loop_solve`` / ``_host_loop_refined``
  below: the host loops the sharded solves ran before they were restructured,
  written out here on the solvers' own cycles, halo matvecs and psums;
- they match dgtpu's ``ShardedMultigrid`` / ``ShardedStokesMultigrid`` on the
  same numpy-seeded right-hand sides: dgtpu's cycle count and L2(u) within
  SHARD_L2_REL_TOL (dgtpu on its virtual CPU devices, the refined solves
  against its ``defect='f64'``; on Stokes u is the velocity);
- a mesh whose shards span two cards takes the host loops by layout and no
  capture is attempted; a CPU mesh builds no ``CycleGraph`` and no
  ``LoopGraph``;
- the counters stay truthful under replay: through a stand-in for the CUDA
  graph API whose replay runs nothing, a graph's halo exchanges and kernel
  launches come back per replay, and ``graph.replays`` and the capture spans
  cover the new graphs.

On the card (``cuda``-marked, skipped here; ``python -m pytest
tests/test_torch_graph_sharded.py --noconftest -q -m cuda``): each graphed
sharded solve equals its eager run (``eager=True``) bit for bit.
"""

import contextlib
import math
import os

import numpy as np
import pytest
import torch

from dgtpu_torch.ops import graphs
from dgtpu_torch.ops.graphs import CycleGraph, LoopGraph, MaskedLoop
from dgtpu_torch.parallel import halo as T
from dgtpu_torch.parallel import stokes_halo as TS
from dgtpu_torch.solvers.refinement import gmres_correction
from dgtpu_torch.utils import trace

torch.set_num_threads(1)
INPUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "input")
SHARD_L2_REL_TOL = 1e-12       # chip_smoke.SHARD_L2_REL_TOL
SHARDS = [1, 2, 4]


def _bits(*values):
    """Solutions, histories and counts as int64 views (NaN and -0.0 count)."""
    out = []
    for v in values:
        if isinstance(v, (list, tuple)):
            out += _bits(*v)
        elif isinstance(v, torch.Tensor):
            out.append(v.detach().cpu().to(torch.float64).view(torch.int64).tolist())
        else:
            out.append(torch.tensor(float(v), dtype=torch.float64).view(torch.int64).item())
    return out


# -- the host loops the sharded solves ran before (the reference) -------------

def _host_loop_solve(mg, rhs_global):
    """The full-precision solve as a host loop with one residual read a cycle
    (no FMG: the cases below leave it off)."""
    if isinstance(mg, TS.ShardedStokesMultigrid):
        ops, top = mg._operands(), mg.data[-1]
        f_mom, f_cont = mg._split_fields(rhs_global)
        uv, p = T._zeros_like(f_mom), T._zeros_like(f_cont)

        def norm(uv, p):
            return TS._pnorm_pair(*TS._saddle_residual(top, f_mom, f_cont, uv, p))

        def cycle(uv, p):
            return mg._v_cycle(len(mg.levels) - 1, ops, f_mom, f_cont, uv, p)

        fields = (uv, p)
    else:
        blocks = mg.data.blocks[-1]
        rhs = mg._bands(rhs_global)

        def norm(u):
            return T._pnorm2(T._sub(rhs, T._matvec_with_halo(blocks, u)))

        def cycle(u):
            return (mg._v_cycle(len(mg.levels) - 1, mg.data, rhs, u),)

        fields = (T._zeros_like(rhs),)
    res0 = float(norm(*fields))
    res = float(norm(*fields)) / res0
    hist, n = [], 0
    while n < mg.max_cycles and res >= mg.tol and np.isfinite(res):
        hist.append(res)
        fields = cycle(*fields)
        res = float(norm(*fields)) / res0
        n += 1
    if isinstance(mg, TS.ShardedStokesMultigrid):
        return mg._join_fields(*fields), res, n, hist + [res]
    return T.grid_to_vec(mg.mesh.join(fields[0])), res, n, hist + [res]


def _host_loop_refined(mg, rhs_global, tol, n_inner, inner="cycles"):
    """The float64-defect refinement as it ran before: the float32 cycles
    and the defect eager, ``float(norm) / res0`` read after every round."""
    f32 = torch.float32
    n_lev = len(mg.levels)
    if not isinstance(mg, TS.ShardedStokesMultigrid):
        b64, data = mg.data.blocks[-1], mg.data32()
        rhs = mg._bands(rhs_global, torch.float64)
        u = T._zeros_like(rhs)

        def inner_solve(r32):
            e = T._zeros_like(r32)
            for _ in range(n_inner):
                e = mg._v_cycle(n_lev - 1, data, r32, e)
            return e

        r = T._sub(rhs, T._matvec_with_halo(b64, u))
        res0 = float(T._pnorm2(r))
        if mg.full_multigrid:
            u = T._add(u, T._cast(mg._fmg(data, T._cast(r, f32)), rhs[0].dtype))
            r = T._sub(rhs, T._matvec_with_halo(b64, u))
        res, hist, n = 1.0, [], 0
        while n < 20 and res >= tol and np.isfinite(res):
            hist.append(res)
            u = T._add(u, T._cast(inner_solve(T._cast(r, f32)), rhs[0].dtype))
            r = T._sub(rhs, T._matvec_with_halo(b64, u))
            res = float(T._pnorm2(r)) / res0
            n += 1
        return T.grid_to_vec(mg.mesh.join(u)), res, n, hist + [res]
    top64 = mg.data[-1]
    ops = mg._operands(f32)
    f_mom, f_cont = mg._split_fields(rhs_global.to(torch.float64))
    uv, p = T._zeros_like(f_mom), T._zeros_like(f_cont)

    def inner_cycles(rm32, rc32):
        ep = (T._zeros_like(rm32), T._zeros_like(rc32))
        for _ in range(n_inner):
            ep = mg._v_cycle(n_lev - 1, ops, rm32, rc32, *ep)
        return ep

    def inner_gmres(rm32, rc32):
        top = ops[0][-1]
        shp_m = [x.shape for x in rm32]
        shp_c = [x.shape for x in rc32]

        def flat(am, ac):
            return TS.ShardVector([torch.cat([m.reshape(-1), c.reshape(-1)])
                                   for m, c in zip(am, ac)])

        def unflat(x):
            ms = [v[:sm.numel()].reshape(sm) for v, sm in zip(x.parts, shp_m)]
            cs = [v[sm.numel():].reshape(sc) for v, sm, sc in zip(x.parts, shp_m, shp_c)]
            return ms, cs

        def M(x):
            em, ec = unflat(x)
            duv, dp = mg._v_cycle(n_lev - 1, ops, em, ec, T._zeros_like(em),
                                  T._zeros_like(ec))
            return flat(duv, dp)

        def AM(x):
            uv, p = unflat(M(x))
            am, ac = TS._saddle_residual(top, T._zeros_like(uv), T._zeros_like(p), uv, p)
            return flat([-m for m in am], [-c for c in ac])

        return unflat(gmres_correction(AM, M, flat(rm32, rc32), n_inner,
                                       dot=TS._dot, norm=TS._norm))

    inner_solve = inner_gmres if inner == "gmres" else inner_cycles
    dt = f_mom[0].dtype
    rm, rc = TS._saddle_residual(top64, f_mom, f_cont, uv, p)
    res0 = float(TS._pnorm_pair(rm, rc))
    if mg.full_multigrid:
        duv, dp = mg._fmg(ops, T._cast(rm, f32), T._cast(rc, f32))
        uv, p = T._add(uv, T._cast(duv, dt)), T._add(p, T._cast(dp, dt))
        rm, rc = TS._saddle_residual(top64, f_mom, f_cont, uv, p)
    res, hist, n = 1.0, [], 0
    while n < 20 and res >= tol and np.isfinite(res):
        hist.append(res)
        duv, dp = inner_solve(T._cast(rm, f32), T._cast(rc, f32))
        uv, p = T._add(uv, T._cast(duv, dt)), T._add(p, T._cast(dp, dt))
        rm, rc = TS._saddle_residual(top64, f_mom, f_cont, uv, p)
        res = float(TS._pnorm_pair(rm, rc)) / res0
        n += 1
    return mg._join_fields(uv, p), res, n, hist + [res]


# -- the problems: dgtpu's levels, numpy copies for the port ------------------

def _need_dgtpu():
    """Skip unless the JAX package runs on its 8 virtual CPU devices
    (``tests/conftest.py`` sets them up; a card's run skips it)."""
    jax = pytest.importorskip("jax")
    if len(jax.devices()) < 8 or jax.devices()[0].platform != "cpu":
        pytest.skip("needs dgtpu on 8 virtual CPU devices (tests/conftest.py)")


@pytest.fixture(scope="module")
def poisson8():
    """dgtpu's sharded-test hierarchy (8x8 p=2 over p=1, sigma 4) with a
    numpy-seeded right-hand side; the port's levels are numpy copies."""
    _need_dgtpu()
    from dgtpu.geometry import Geometry
    from dgtpu.level import GridLevel
    from dgtpu.models.poisson import assemble_poisson
    from dgtpu.ops.transfer import make_transfer
    from dgtpu.settings import Settings, load_params
    from test_torch_parallel import _port_levels
    s = Settings(load_params())
    for key, value in (("visualization.export", False), ("caching.enabled", False),
                       ("logging.loglevel", "WARNING"), ("grid.polynomial_degree", 1)):
        s.update_setting(key, value)
    geom = Geometry(os.path.join(INPUT_DIR, "Rectangle_8X8_nPoly1.xyz"), s)
    fine = GridLevel(geom, s, ["u"], {"u": 2})
    fine.op, _, _ = assemble_poisson(fine)
    coarse = GridLevel(geom, s, ["u"], {"u": 1}, sigma=4.0)
    coarse.op, _, _ = assemble_poisson(coarse)
    levels, transfers = [coarse, fine], [make_transfer("polynomial", p_fine=2, p_coarse=1)]
    tl, tt = _port_levels(levels, transfers)
    rhs = np.random.default_rng(17).standard_normal(fine.N * fine.N_DOF_sol_tot)
    return s, levels, transfers, tl, tt, rhs


@pytest.fixture(scope="module")
def stokes8():
    """dgtpu's sharded Stokes route hierarchy (8x8 p_u=2/p_p=1 over 1/0,
    global order) with a numpy-seeded consistent right-hand side A x."""
    _need_dgtpu()
    from dgtpu.api import DGFEM as JDGFEM
    from dgtpu.settings import Settings
    from dgtpu_torch.convert import from_dgtpu_stokes_arrays
    from test_torch_stokes_parallel import _route_params
    dg = JDGFEM(settings=Settings(_route_params()), solve_multigrid=True)

    def fields(op):
        return dict(blocks=np.asarray(op.blocks), nbr=np.asarray(op.nbr),
                    mask=np.asarray(op.mask))
    port, _ = from_dgtpu_stokes_arrays(
        [dict(p_u=l.P_sol["u"], p_p=l.P_sol["p"], A=fields(l.block_A),
              D=fields(l.block_D), G=fields(l.block_G)) for l in dg.levels],
        [dict(kind="penalty")], [(l.Nj, l.Ni) for l in dg.levels])
    x = np.random.default_rng(23).standard_normal(np.asarray(dg.levels[-1].rhs).size)
    rhs = port[-1].op.matvec(torch.as_tensor(x)).numpy()
    return dg, port, rhs


def _poisson(poisson8, shards, **settings):
    import copy
    s, _, _, tl, tt, rhs = poisson8
    s = copy.deepcopy(s)
    for key, value in settings.items():
        s.update_setting(key, value)
    return T.ShardedMultigrid(tl, tt, s, mesh=T.make_mesh(shards, "cpu")), s, \
        torch.as_tensor(rhs)


def _stokes(stokes8, shards, **settings):
    import copy
    dg, port, rhs = stokes8
    s = copy.deepcopy(dg.settings)
    for key, value in settings.items():
        s.update_setting(key, value)
    return TS.ShardedStokesMultigrid(port, s, mesh=T.make_mesh(shards, "cpu")), s, \
        torch.as_tensor(rhs)


def _dgtpu_solver(problem, fixture, s, shards):
    from dgtpu.parallel import halo as J
    from dgtpu.parallel.stokes_halo import ShardedStokesMultigrid
    if problem == "Stokes":
        return ShardedStokesMultigrid(fixture[0].levels, s, mesh=J.make_mesh(shards))
    return J.ShardedMultigrid(fixture[1], fixture[2], s, mesh=J.make_mesh(shards))


def _l2_rel(mg, got, ref):
    """|L2(u) - dgtpu's| / dgtpu's; on Stokes u is the velocity (the
    pressure carries a free constant)."""
    if isinstance(mg, TS.ShardedStokesMultigrid):
        fine = mg.levels[-1]
        got, ref = (x[:2 * fine.N * fine.N_DOF_sol["u"]] for x in (got, ref))
    return abs(float(np.linalg.norm(got)) - float(np.linalg.norm(ref))) / float(
        np.linalg.norm(ref))


@pytest.mark.parametrize("problem", ["Poisson", "Stokes"])
@pytest.mark.parametrize("shards", SHARDS)
def test_full_solve_matches_host_loop_and_dgtpu(poisson8, stokes8, problem, shards):
    """The full-precision solve as a masked loop equals the host loop bit
    for bit (solution, history, count), so does ``eager=True``; dgtpu's
    solve on the same rhs takes as many cycles, L2(u) within 1e-12."""
    import jax.numpy as jnp
    fixture = stokes8 if problem == "Stokes" else poisson8
    mg, s, rhs = (_stokes if problem == "Stokes" else _poisson)(fixture, shards)
    assert mg.layout == "masked"
    u, res, n = mg.solve(rhs)
    got = (u, res, n, mg.history)
    assert _bits(*got) == _bits(*_host_loop_solve(mg, rhs))
    ue, rese, ne = mg.solve(rhs, eager=True)
    assert _bits(*got) == _bits(ue, rese, ne, mg.history)
    assert res < mg.tol and n > 1 and len(got[3]) == n + 1
    jm = _dgtpu_solver(problem, fixture, s, shards)
    ju, jres, jn = jm.solve(jnp.asarray(rhs.numpy()))
    assert jn == n
    assert _l2_rel(mg, u.numpy(), np.asarray(ju)) <= SHARD_L2_REL_TOL


REFINED = {"Poisson, cycles": ("Poisson", "cycles", 6),
           "Stokes, cycles": ("Stokes", "cycles", 6),
           "Stokes, gmres": ("Stokes", "gmres", 2)}


@pytest.mark.parametrize("case", list(REFINED))
def test_refined_solve_matches_host_loop_and_dgtpu(poisson8, stokes8, case):
    """``solve_refined`` (FMG seed, 1e-10) over 1, 2 and 4 shards equals the
    host loop it replaced bit for bit (solution, history, rounds), so does
    ``eager=True``; over 4 shards against dgtpu's ``defect='f64'``: the same
    rounds, L2(u) within 1e-12."""
    import jax.numpy as jnp
    problem, inner, n_inner = REFINED[case]
    fixture = stokes8 if problem == "Stokes" else poisson8
    make = _stokes if problem == "Stokes" else _poisson
    kw = {"inner": inner} if problem == "Stokes" else {}
    for shards in SHARDS:
        mg, s, rhs = make(fixture, shards, **{"solver.multigrid.full_multigrid": True})
        u, res, n = mg.solve_refined(rhs, tol=1e-10, n_inner=n_inner, **kw)
        got = (u, res, n, mg.history)
        assert _bits(*got) == _bits(*_host_loop_refined(mg, rhs, 1e-10, n_inner, inner))
        ue, rese, ne = mg.solve_refined(rhs, tol=1e-10, n_inner=n_inner, eager=True, **kw)
        assert _bits(*got) == _bits(ue, rese, ne, mg.history)
        assert res < 1e-10 and n >= 1
    jm = _dgtpu_solver(problem, fixture, s, 4)
    ju, jres, jn = jm.solve_refined(jnp.asarray(rhs.numpy()), tol=1e-10, n_inner=n_inner,
                                    defect="f64", **kw)
    assert jres < 1e-10 and jn == n
    assert _l2_rel(mg, u.numpy(), np.asarray(ju)) <= SHARD_L2_REL_TOL


# -- layouts ------------------------------------------------------------------

def test_layout_follows_the_cards(monkeypatch):
    """``make_mesh`` on one card: 'graphed'; shard k on card k modulo two
    cards: 'eager'; the CPU: 'masked'."""
    assert T.layout(T.make_mesh(4, "cpu")) == "masked"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert T.layout(T.make_mesh(4, "cuda")) == "graphed"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = T.make_mesh(4, "cuda")
    assert [str(d) for d in mesh.devices] == ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    assert T.layout(mesh) == "eager"


class _TwoCards(T.ShardMesh):
    """A CPU mesh that reports its shards on two cards (so the solver
    chooses by layout; the bands stay where the CPU can compute them)."""

    @property
    def cards(self):
        return [torch.device("cuda", 0), torch.device("cuda", 1)]


@contextlib.contextmanager
def _no_graphs(monkeypatch):
    """Any ``CycleGraph``, ``LoopGraph`` or ``MaskedLoop`` made raises."""
    def refuse(self, *a, **kw):
        raise AssertionError(f"{type(self).__name__} built")
    for cls in (CycleGraph, LoopGraph, MaskedLoop):
        monkeypatch.setattr(cls, "__init__", refuse)
    yield


def _solves(mg, rhs, stokes):
    """Every sharded solve of ``mg``: full precision, refined with cycles
    and, on Stokes, with GMRES(2)."""
    out = [mg.solve(rhs), mg.solve_refined(rhs, tol=1e-10, n_inner=2)]
    if stokes:
        out.append(mg.solve_refined(rhs, tol=1e-10, n_inner=2, inner="gmres"))
    return out


@pytest.mark.parametrize("problem", ["Poisson", "Stokes"])
def test_two_card_mesh_takes_host_loops(poisson8, stokes8, problem, monkeypatch):
    """A mesh over two cards runs the host loops by layout, before any
    capture: with every tensor reporting CUDA (so a graph would be built)
    no graph or masked loop is made, and the results equal the CPU mesh's
    bit for bit."""
    fixture = stokes8 if problem == "Stokes" else poisson8
    mg, _, rhs = (_stokes if problem == "Stokes" else _poisson)(fixture, 4)
    ref = _solves(mg, rhs, problem == "Stokes")
    mg.mesh = _TwoCards(mg.mesh.devices)
    assert mg.layout == "eager"
    with _no_graphs(monkeypatch):
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        got = _solves(mg, rhs, problem == "Stokes")
    assert _bits(got) == _bits(ref) and mg.graphs == []


@pytest.mark.parametrize("problem", ["Poisson", "Stokes"])
def test_cpu_mesh_builds_no_graph(poisson8, stokes8, problem, monkeypatch, tmp_path):
    """On the CPU no ``CycleGraph`` and no ``LoopGraph`` is built, by the
    solvers or the route (``DGFEM.graphed`` false)."""
    import copy

    import dgtpu_torch.api as tapi
    from dgtpu_torch.settings import Settings as TSettings
    fixture = stokes8 if problem == "Stokes" else poisson8
    mg, _, rhs = (_stokes if problem == "Stokes" else _poisson)(fixture, 4)
    for cls in (CycleGraph, LoopGraph):
        monkeypatch.setattr(cls, "__init__", lambda self, *a, **kw: (_ for _ in ()).throw(
            AssertionError(f"{type(self).__name__} built")))
    _solves(mg, rhs, problem == "Stokes")
    assert mg.graphs == []
    if problem == "Stokes":
        from test_torch_stokes_parallel import _route_params
        params = _route_params()
    else:
        from test_torch_parallel import _api_params
        params = _api_params(4)
        params["performance"]["precision"] = "mixed"
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    dg = tapi.DGFEM(device="cpu", settings=TSettings(copy.deepcopy(params)),
                    solve_multigrid=True)
    dg.solve()
    assert dg.cycle_kind == "sharded mixed" and dg.mesh.size == 4
    assert dg.graphed is False and dg.graph_seconds == 0.0


# -- counters under replay ------------------------------------------------------

class _Graph:
    """A stand-in for ``torch.cuda.CUDAGraph``: its replay runs nothing, as a
    replay on the card bumps no host counter (the outputs stay those of the
    recording, which on the CPU ran)."""

    def replay(self):
        pass


@pytest.fixture
def fake_graph_api(monkeypatch):
    """The CUDA graph API replaced by stand-ins that run on the CPU, with
    every tensor reporting CUDA: ``graphs._record`` itself runs."""
    monkeypatch.setattr(CycleGraph, "captures", 0)
    monkeypatch.setattr(CycleGraph, "replays", 0)
    monkeypatch.setattr(CycleGraph, "_warmup_streams", {})
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    stream = type("S", (), {"wait_stream": lambda self, other: None})
    for name, value in (("synchronize", lambda *a: None), ("current_device", lambda: 0),
                        ("Stream", stream), ("current_stream", stream),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("CUDAGraph", _Graph),
                        ("graph", lambda g, **kw: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, value)


class _OneCard(T.ShardMesh):
    """A CPU mesh that reports its shards on one card (layout 'graphed')."""

    @property
    def cards(self):
        return [torch.device("cuda", 0)]


def test_counts_after_replays_equal_the_eager_runs(poisson8, stokes8, fake_graph_api):
    """Over 4 shards, Poisson and Stokes: the float32 cycle's and the float64
    defect's graphs of ``build_refined`` each hold their capture's halo
    exchanges; after k replays the exchanges are k x the eager call's,
    ``graph.replays`` counts the k replays and each capture has its
    ``solve.capture`` span.  A loop graph adds its iteration's exchanges per
    replay and has its ``loop.capture`` span."""
    k = 3
    for make, fixture in ((_poisson, poisson8), (_stokes, stokes8)):
        mg, _, rhs = make(fixture, 4)
        if isinstance(mg, TS.ShardedStokesMultigrid):
            bands64 = [*sum(mg._split_fields(rhs), [])] * 2    # (f_mom, f_cont) x 2
        else:
            bands64 = mg._bands(rhs) * 2                        # (rhs, u)
        bands32 = [b.float() for b in bands64]
        mg.mesh = _OneCard(mg.mesh.devices)
        mg.build_refined()
        cycle, defect = mg.graphs
        mg.build_refined()
        assert mg.graphs == [cycle, defect] and mg._cycle32("graphed") is cycle
        for graph, inputs in ((cycle, bands32), (defect, bands64)):
            T.EXCHANGES.clear()
            graph.fn(*inputs)                         # the eager call
            per_call = dict(T.EXCHANGES)
            assert per_call["cpu"] > 0
            with trace.recording() as rec:
                graph(*inputs)                        # capture, first replay
                T.EXCHANGES.clear()
                before = CycleGraph.replays
                for _ in range(k):
                    graph(*inputs)
            assert graph.exchanges == per_call
            assert dict(T.EXCHANGES) == {key: k * v for key, v in per_call.items()}
            assert CycleGraph.replays - before == k
            assert rec.counters["graph.replays"] == k + 1
            assert [rec.spans[i].name for i in rec.roots("solve.capture")] == \
                ["solve.capture"]
    mg, _, rhs = _poisson(poisson8, 4)
    blocks = mg.data.blocks[-1]
    bands = mg._bands(rhs)
    T.EXCHANGES.clear()
    T._matvec_with_halo(blocks, bands)
    per_iteration = dict(T.EXCHANGES)

    def body(state):
        return (state[0] + 1, *T._matvec_with_halo(blocks, list(state[1:])))

    with trace.recording() as rec:
        loop = graphs.while_loop(lambda s: s[0] < 100, body,
                                 (torch.zeros((), dtype=torch.int64), *bands))
        assert isinstance(loop, LoopGraph)
        T.EXCHANGES.clear()
        loop.run(k, chunk=1)
    assert loop.exchanges == per_iteration
    # the capture's warm-up ran one iteration eagerly; each replay adds one
    assert dict(T.EXCHANGES) == {key: (k + 1) * v for key, v in per_iteration.items()}
    assert rec.counters["graph.replays"] == k
    assert [rec.spans[i].name for i in rec.roots("loop.capture")] == ["loop.capture"]


class _Rerun:
    """A stand-in for a captured graph: a replay reruns the recorded call."""

    def __init__(self, record):
        self.replay = record


@pytest.fixture
def rerun_graphs(monkeypatch):
    """Every tensor reports CUDA; a capture runs its warm-up under
    ``no_host_sync`` (it raises on anything a capture refuses: a read back
    to the host, a copy from it, a data-dependent shape) and its replay
    reruns the recorded call (``CycleGraph`` keeps its function for that)."""
    from test_torch_graph_programs import no_host_sync

    def record(warm, rec):
        with no_host_sync():
            warm()
        return _Rerun(rec), {}, {}, (0.25, 0.5, 0.125)

    capture = CycleGraph._capture

    def keep_fn(self, inputs):
        fn = self.fn
        capture(self, inputs)
        self.fn = fn

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(graphs, "_record", record)
    monkeypatch.setattr(CycleGraph, "_capture", keep_fn)


@pytest.mark.parametrize("problem", ["Poisson", "Stokes"])
def test_graphed_solves_rehearsed_on_the_cpu(poisson8, stokes8, problem, rerun_graphs):
    """The 'graphed' layout's solves over 2 shards through the stand-in: the
    captured pieces (the loop's iteration, the cycle, the defect, the GMRES
    matvec and stages) read nothing back to the host, and each solve equals
    its eager run bit for bit, with its graphs: a loop graph for the full
    solve; the cycle and the defect for the refined ones, shared by the FMG
    seed and the later solves, and on Stokes the GMRES retry's matvec and
    its 2 + n_inner stages."""
    fixture = stokes8 if problem == "Stokes" else poisson8
    mg, _, rhs = (_stokes if problem == "Stokes" else _poisson)(
        fixture, 2, **{"solver.multigrid.full_multigrid": True})
    mg.mesh = _OneCard(mg.mesh.devices)
    assert mg.layout == "graphed"
    with graphs.collect() as loops:
        got = mg.solve(rhs), list(mg.history)
    assert len(loops) == 1 and mg.graphs == []
    assert _bits(got) == _bits(mg.solve(rhs, eager=True), mg.history)
    got = mg.solve_refined(rhs, tol=1e-10, n_inner=3), list(mg.history)
    assert [g.name for g in mg.graphs] == ["solve.capture"] * 2
    assert _bits(got) == _bits(mg.solve_refined(rhs, tol=1e-10, n_inner=3, eager=True),
                               mg.history)
    if problem == "Stokes":
        got = mg.solve_refined(rhs, tol=1e-10, n_inner=3, inner="gmres"), list(mg.history)
        assert [g.name for g in mg.graphs] == ["solve.capture"] * 3 + \
            ["refine.capture"] * 5
        assert _bits(got) == _bits(mg.solve_refined(rhs, tol=1e-10, n_inner=3,
                                                    inner="gmres", eager=True), mg.history)


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sharded solves replay CUDA graphs there")
    return torch.device("cuda")


def _card_bits(*values):
    return _bits(*[v.cpu() if isinstance(v, torch.Tensor) else v for v in values])


@pytest.mark.cuda
@pytest.mark.parametrize("problem", ["Poisson", "Stokes"])
@pytest.mark.parametrize("shards", SHARDS)
def test_graphed_sharded_solves_match_eager(cuda, problem, shards):
    """On one card every sharded solve (full precision, refined with cycles
    and, on Stokes, with GMRES(16)) replays CUDA graphs and equals its eager
    run (``eager=True``) bit for bit in solution, history and count."""
    import chip_smoke
    from dgtpu_torch.settings import Settings
    if problem == "Stokes":
        params = chip_smoke.stokes_params(8)
        params["solver"]["multigrid"]["geometric coarsening"]["coarsening factors"] = "2"
        dg = chip_smoke.hierarchy(Settings(params))
        mg = TS.ShardedStokesMultigrid(dg.levels, dg.settings, mesh=T.make_mesh(shards),
                                       transfers=dg.transfers,
                                       transfer_types=dg.transfer_types)
    else:
        dg = chip_smoke.hierarchy(chip_smoke.settings_for("Rectangle_8X8_nPoly5.xyz", 5))
        mg = T.ShardedMultigrid(dg.levels, dg.transfers, dg.settings,
                                mesh=T.make_mesh(shards))
    assert mg.layout == "graphed"
    rhs = dg.levels[-1].rhs
    runs = [("full", lambda e: mg.solve(rhs, eager=e)),
            ("cycles", lambda e: mg.solve_refined(rhs, eager=e))]
    if problem == "Stokes":
        runs.append(("gmres", lambda e: mg.solve_refined(rhs, n_inner=16, inner="gmres",
                                                         eager=e)))
    for name, run in runs:
        with graphs.collect() as loops:
            got = run(False)
        hist = list(mg.history)
        made = len(mg.graphs) + len(loops)
        want = run(True)
        assert _card_bits(*got, hist) == _card_bits(*want, mg.history), name
        assert made > 0 and math.isfinite(got[1]), name
        assert (len(loops) == 1) == (name == "full"), name
