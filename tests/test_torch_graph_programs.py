"""The float64 programs that dgtpu compiles and the port captures as CUDA
graphs on the card, checked on the CPU at 4x4 (and 8x8):

* ``MultigridSolver.step`` (one cycle and its residual norm; ``-m`` in full
  precision, Poisson and Stokes, and the mixed -> full fallback), the Krylov
  multigrid preconditioner's zero-guess cycle (``DGFEM._krylov_mg_cycle``)
  and the GMRES(16) correction step of the refinement
  (``solvers/refinement.gmres_step``) run under ``no_host_sync``, which
  raises on every operation that would make the host wait for the card or
  copy host data to it: ``Tensor.item``, ``__float__``, ``__int__``,
  ``__bool__``, ``tolist``, ``cpu``, ``numpy``, ``nonzero`` (and the aten
  ops behind them: ``_local_scalar_dense``, ``nonzero``, boolean-mask
  indexing) and tensors made from host data (``torch.tensor``,
  ``torch.as_tensor`` of a list or array).  Such an operation inside a
  capture fails it on the card; here the guard finds it without a card.
* ``step`` looped to tolerance gives dgtpu's ``MultigridSolver.solve``
  history within 1e-11 relative to its scale (the first entry), with the
  same cycle count.
* The CPU routes run these steps unwrapped: no ``CycleGraph`` is built.
  On the card the GMRES step is no graph of its own: its cycle and matvec
  are the mixed route's graphs and each arithmetic stage is one.
* ``CycleGraph`` refuses CPU tensors and hands back tuple outputs as fresh
  clones (through stand-ins for the CUDA graph calls).

The graphs against their eager runs, bit for bit, are CUDA tests in
``tests/test_torch_kernels.py``.
"""

import contextlib
import copy
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

import __graft_entry__
import chip_smoke
import dgtpu_torch.api as tapi
from dgtpu.ops.smoothers import element_colors as jcolors
from dgtpu.solvers.multigrid import MultigridSolver as JMultigridSolver
from dgtpu_torch.convert import from_dgtpu_arrays
from dgtpu_torch.ops.graphs import CycleGraph
from dgtpu_torch.ops.smoothers import element_colors
from dgtpu_torch.ops.stokes_soa import SoAStokesVCycle
from dgtpu_torch.settings import Settings, load_params
from dgtpu_torch.solvers import multigrid
from dgtpu_torch.solvers.multigrid import MultigridSolver
from dgtpu_torch.solvers.refinement import gmres_step
from dgtpu_torch.utils.norms import lp_norm

torch.set_num_threads(1)
HISTORY_TOL = 1e-11


class HostSync(AssertionError):
    """An operation inside a step that would wait for the card or copy host
    data to it."""


_METHODS = {torch.Tensor.item, torch.Tensor.__float__, torch.Tensor.__int__,
            torch.Tensor.__bool__, torch.Tensor.tolist, torch.Tensor.cpu,
            torch.Tensor.numpy, torch.Tensor.nonzero, torch.nonzero, torch.tensor}
_ATEN = {"aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
         "aten.lift_fresh"}


class _FunctionGuard(TorchFunctionMode):
    paused = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.paused:
            return func(*args, **kwargs)
        if func in _METHODS or (func is torch.as_tensor
                                and not isinstance(args[0], torch.Tensor)):
            raise HostSync(f"{getattr(func, '__qualname__', func)} inside a step")
        return func(*args, **kwargs)


class _DispatchGuard(TorchDispatchMode):
    paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.paused:
            return func(*args, **kwargs)
        name = str(func.overloadpacket)
        indices = args[1] if name in ("aten.index", "aten.index_put",
                                      "aten.index_put_") else ()
        if name in _ATEN or any(isinstance(i, torch.Tensor)
                                and i.dtype in (torch.bool, torch.uint8)
                                for i in indices):
            raise HostSync(f"{name} inside a step")
        return func(*args, **kwargs)


class no_host_sync:
    """``with no_host_sync(): step(...)`` raises ``HostSync`` on any
    operation a CUDA graph capture refuses (a device-to-host read, a
    host-to-device copy, a data-dependent shape)."""

    def __enter__(self):
        self.modes = [_FunctionGuard(), _DispatchGuard()]
        for m in self.modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self.modes):
            m.__exit__(*exc)
        return False

    def around(self, fn):
        """``fn`` with the guard paused while it runs."""
        def call(*args):
            for m in self.modes:
                m.paused = True
            try:
                return fn(*args)
            finally:
                for m in self.modes:
                    m.paused = False
        return call


# -- the guard itself --------------------------------------------------------

_V = torch.arange(1.0, 4.0, dtype=torch.float64)
SYNCS = {
    "item": lambda: _V.sum().item(),
    "float": lambda: float(_V.sum()),
    "int": lambda: int(_V.sum()),
    "bool": lambda: bool(_V.sum() > 0),
    "if": lambda: 1 if _V.sum() > 0 else 0,
    "tolist": lambda: _V.tolist(),
    "cpu": lambda: _V.cpu(),
    "numpy": lambda: _V.numpy(),
    "nonzero": lambda: _V.nonzero(),
    "torch.nonzero": lambda: torch.nonzero(_V),
    "where of one argument": lambda: torch.where(_V > 1),
    "boolean mask": lambda: _V[_V > 1],
    "boolean mask store": lambda: _V.clone().__setitem__(_V > 1, 0.0),
    "masked_select": lambda: torch.masked_select(_V, _V > 1),
    "tensor from a float": lambda: torch.tensor(1e-35),
    "as_tensor from a list": lambda: torch.as_tensor([1.0, 2.0]),
}


@pytest.mark.parametrize("what", sorted(SYNCS))
def test_guard_raises_on_host_syncs(what):
    with pytest.raises(HostSync), no_host_sync():
        SYNCS[what]()


def test_guard_lets_device_work_through():
    """What the steps do: arithmetic with Python scalars, integer-index
    gathers and stores, fills, in-place stores of 0-d tensors, reductions,
    products, ``torch.where`` of three arguments."""
    idx = torch.tensor([2, 0])
    with no_host_sync():
        x = torch.as_tensor(_V) * 0.5 + 1
        x[idx] = x[idx] * 2
        H = torch.zeros((3, 3), dtype=torch.float64)
        H[1, 2] = torch.dot(x, x)
        t = torch.full((), 1e-300, dtype=torch.float64)
        y = torch.where(H.abs() > t, H / torch.maximum(H, t), torch.zeros_like(H))
        z = H @ x + lp_norm(x) + y.sum()
    assert z.shape == (3,)


# -- MultigridSolver.step: Poisson, held to dgtpu ----------------------------

@pytest.fixture(scope="module")
def rect():
    return __graft_entry__._flagship(n=4, p_grid=2, p_sol=2)


def _pair(dg, strategy="sequential", cycle="V", coarse="smoother", smoother=None):
    """dgtpu's and the port's MultigridSolver on dgtpu's assembled operators."""
    s = copy.deepcopy(dg.settings)
    s.performance.smoother_parallelization = strategy
    mg = s.solver.multigrid
    mg.cycle_type, mg.coarse_grid_solver = cycle, coarse
    if smoother:
        for node in (mg.polynomial_coarsening, mg.geometric_coarsening):
            node.pre_smoother.smoother = node.post_smoother.smoother = smoother
    dims = [(l.Nj, l.Ni) for l in dg.levels]
    ops, trs = from_dgtpu_arrays(
        [dict(blocks=np.asarray(l.op.blocks), nbr=np.asarray(l.op.nbr),
              mask=np.asarray(l.op.mask)) for l in dg.levels],
        [dict(kind=t.kind, R=np.asarray(t.R), P=np.asarray(t.P))
         for t in dg.transfers], dg.transfer_types, dims)
    j = JMultigridSolver([l.op for l in dg.levels], dg.transfers, dg.transfer_types, s,
                         colors=[jcolors(l.Ni, l.Nj) for l in dg.levels])
    t = MultigridSolver(ops, trs, dg.transfer_types, s,
                        colors=[element_colors(l.Ni, l.Nj) for l in dg.levels])
    if smoother == "chebyshev":
        # each package power-iterates from its own start vector
        t.eig_max = list(j.eig_max)
    return j, t


def _step_loop(mg, rhs, tol, max_cycles):
    """The loop ``MultigridSolver.solve`` runs on the card, around ``step``
    called directly: one scalar read per cycle."""
    u = torch.zeros_like(rhs)
    res0 = float(lp_norm(rhs, 2))
    res = float(lp_norm(rhs - mg.ops[-1].matvec(u), 2)) / res0
    history = []
    while len(history) < max_cycles and res >= tol and math.isfinite(res):
        history.append(res)
        u, r = mg.step(rhs, u)
        res = float(r) / res0
    return u, history + [res]


POISSON_CASES = [("sequential", "V", "smoother", None), ("sequential", "W", "direct", None),
                 ("sequential", "F", "smoother", None), ("redblack", "V", "direct", None),
                 ("redblack", "W", "smoother", None), ("redblack", "F", "direct", None),
                 ("redblack", "W", "smoother", "chebyshev"),
                 ("sequential", "V", "direct", "jacobi")]


@pytest.mark.parametrize("strategy, cycle, coarse, smoother", POISSON_CASES)
def test_poisson_step_reads_nothing_back(rect, strategy, cycle, coarse, smoother):
    _, t = _pair(rect, strategy, cycle, coarse, smoother)
    rhs = torch.as_tensor(np.array(rect.levels[-1].rhs))
    u0 = torch.as_tensor(np.random.default_rng(1).standard_normal(rhs.shape))
    with no_host_sync():
        u, res = t.step(rhs, u0)
    assert u.shape == rhs.shape and res.shape == () and res.dtype == torch.float64
    assert torch.equal(u, t.v_cycle(len(t.ops), rhs, u0))


# (the Jacobi case above diverges in both packages, so it has no history to
# hold)
@pytest.mark.parametrize("strategy, cycle, coarse, smoother", POISSON_CASES[:-1])
def test_step_loop_gives_dgtpus_history(rect, strategy, cycle, coarse, smoother):
    j, t = _pair(rect, strategy, cycle, coarse, smoother)
    rhs = np.array(rect.levels[-1].rhs)
    tol = float(rect.settings.solver.multigrid.tolerance)
    max_cycles = int(rect.settings.solver.multigrid.max_cycles)
    _, _, jn, jhist = j.solve(jnp.asarray(rhs))
    ref = [float(r) for r in np.asarray(jhist) if np.isfinite(r)]
    u, hist = _step_loop(t, torch.as_tensor(rhs), tol, max_cycles)
    assert len(hist) - 1 == int(jn) == len(ref) - 1
    # relative to the history's scale (its first entry, 1 from a zero
    # guess): an entry r carries the residual's cancellation, ~eps / r of
    # itself (1.5e-9 at 1e-7), in both packages
    assert np.abs(np.array(hist) - np.array(ref)).max() < HISTORY_TOL * ref[0]
    # the port's own solve() is this loop (the step unwrapped on the CPU)
    tu, tres, tn, thist = t.solve(torch.as_tensor(rhs))
    assert (thist, tn) == (hist, len(hist) - 1) and torch.equal(tu, u)
    assert t.graph is None


# -- MultigridSolver.step: Stokes distributive GS ----------------------------

def _stokes(n=4, precision="full", splitting="lsq", **over):
    params = chip_smoke.stokes_params(n)
    params["performance"]["precision"] = precision
    params["performance"]["dgs_splitting"] = splitting
    params["logging"]["loglevel"] = "ERROR"
    for path, value in over.items():
        node = params
        *keys, leaf = path.split(".")
        for k in keys:
            node = node[k]
        node[leaf] = value
    return params


def _dgfem(params, tmp, **method):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "OUTPUT_ROOT", str(tmp))
        return tapi.DGFEM(device="cpu", settings=Settings(params),
                          **(method or {"solve_multigrid": True}))


@pytest.mark.parametrize("splitting", ["lsq", "lsq_dense", "classical_exact"])
def test_stokes_step_reads_nothing_back(tmp_path, splitting):
    dg = _dgfem(_stokes(splitting=splitting), tmp_path)
    mg = dg._multigrid_solver()
    rhs = dg.levels[-1].rhs
    with no_host_sync():
        u, res = mg.step(rhs, torch.zeros_like(rhs))
    assert torch.isfinite(u).all() and 0 < float(res) < float(lp_norm(rhs, 2))
    # the solve's first cycle is this step
    _, _, _, hist = mg.solve(rhs, max_cycles=1)
    assert hist[-1] == float(res) / float(lp_norm(rhs, 2))


# -- the Krylov multigrid preconditioner's cycle ------------------------------

@pytest.mark.parametrize("problem", ["Poisson", "Stokes"])
def test_krylov_preconditioner_cycle_reads_nothing_back(tmp_path, problem):
    over = {"solver.krylov.preconditioner": "multigrid"}
    if problem == "Stokes":
        params = _stokes(**over)
    else:
        params = load_params()
        params["grid"]["filename"] = "Rectangle_4X4_nPoly2.xyz"
        params["grid"]["polynomial degree"] = 2
        params["solution"]["u"]["polynomial degree"] = 2
        params["solver"]["multigrid"]["polynomial coarsening"]["levels"]["u"] = "1,2"
        params["solver"]["krylov"]["preconditioner"] = "multigrid"
        params["visualization"]["export"] = False
        params["logging"]["loglevel"] = "ERROR"
    dg = _dgfem(params, tmp_path, solve_krylov=True)
    cycle = dg._krylov_mg_cycle()
    assert not isinstance(cycle, CycleGraph)    # the CPU route runs it itself
    r = dg.levels[-1].rhs
    with no_host_sync():
        z = cycle(r)
    assert torch.equal(z, dg.mg.v_cycle(len(dg.mg.ops), r, torch.zeros_like(r)))


# -- the GMRES(16) correction step over the Stokes cycle ----------------------

def test_gmres_step_reads_nothing_back(tmp_path):
    """The step over a 4x4 Stokes SoA W-cycle and matvec (their plain
    versions on the CPU), as the mixed route's GMRES retry captures it.  The
    guard watches the step's own arithmetic (Arnoldi, Givens, the
    back-substitution) and pauses inside the cycle and the matvec: on the
    card their kernels run, which the mixed route has captured since the
    float32 cycles were graphed, while on the CPU their plain versions
    build index tables from host arrays (K4's ``geo_transfer_plain``)."""
    dg = _dgfem(_stokes(precision="mixed"), tmp_path)
    cycle = SoAStokesVCycle(dg.levels, dg.transfers, dg.transfer_types, dg.settings,
                            dtype=torch.float32, device="cpu")
    matvec = cycle.build_matvec()
    r = dg.levels[-1].rhs.to(torch.float32)
    with no_host_sync() as guard:
        e = gmres_step(guard.around(matvec), guard.around(cycle), 16)(r)
    assert e.dtype == torch.float32 and torch.isfinite(e).all()
    # the correction cuts the float32 defect
    res = r - matvec(e)
    assert float(torch.linalg.norm(res)) < 1e-3 * float(torch.linalg.norm(r))


# -- the CPU routes run their steps unwrapped --------------------------------

@pytest.fixture
def no_graphs(monkeypatch, tmp_path):
    """Every CycleGraph built, recorded (none may be, on the CPU)."""
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    built = []

    def record(fn, name="solve.capture"):
        built.append(name)
        return fn

    monkeypatch.setattr(tapi, "CycleGraph", record)
    monkeypatch.setattr(multigrid, "CycleGraph", record)
    return built


def test_cpu_full_route_runs_its_step_unwrapped(no_graphs):
    params = load_params()
    params["grid"]["filename"] = "Rectangle_4X4_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["solution"]["u"]["polynomial degree"] = 2
    params["solver"]["multigrid"]["polynomial coarsening"]["levels"]["u"] = "1,2"
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    dg = tapi.DGFEM(device="cpu", settings=Settings(params), solve_multigrid=True)
    dg.solve()
    assert dg.cycle_kind == "full precision" and dg.cycles > 0
    assert not no_graphs and dg.mg.graph is None
    assert dg.graphed is False and dg.graph_seconds == 0.0


def test_cpu_fallback_and_krylov_run_their_steps_unwrapped(no_graphs):
    fallback = _stokes(n=8, precision="mixed", **{
        "solver.multigrid.geometric coarsening.coarsening factors": "8,4,2"})
    dg = tapi.DGFEM(device="cpu", settings=Settings(fallback), solve_multigrid=True)
    dg.solve()
    assert dg.cycle_kind == "full precision" and dg.mg.graph is None
    krylov = _stokes(**{"solver.krylov.preconditioner": "multigrid",
                        "solver.krylov.tolerance": 1e-10,
                        "solver.krylov.absolute tolerance": 0.0})
    dg = tapi.DGFEM(device="cpu", settings=Settings(krylov), solve_krylov=True)
    dg.solve()
    assert dg.krylov_iterations > 0
    assert not no_graphs and dg.graphed is False and dg.graph_seconds == 0.0


def test_cpu_gmres_retry_runs_its_step_unwrapped(no_graphs, monkeypatch):
    """One plain round, so that the 4x4 Stokes refinement stalls and retries
    with the GMRES(16) step; the hook that makes each of its 18 arithmetic
    stages a graph on the card hands each back as it is."""
    refined = tapi.make_refined_solver
    hooked = []

    def one_round(*args, **kwargs):
        if kwargs.get("inner", "cycles") == "cycles":
            kwargs["max_outer"] = 1
        else:
            hook = kwargs["graph"]

            def spy(step):
                hooked.append(hook(step) is step)
                return step
            kwargs["graph"] = spy
        return refined(*args, **kwargs)

    monkeypatch.setattr(tapi, "make_refined_solver", one_round)
    dg = tapi.DGFEM(device="cpu", settings=Settings(_stokes(precision="mixed")),
                    solve_multigrid=True)
    dg.solve()
    assert dg.inner == "gmres" and dg.rounds["gmres"] > 0 and hooked == [True] * 18
    assert dg.solve_residual < 1e-10
    assert not no_graphs and dg.graphed is False


# -- CycleGraph: CPU tensors, tuple outputs ----------------------------------

def test_cycle_graph_refuses_cpu_tensors_of_a_step(rect):
    _, t = _pair(rect)
    rhs = torch.as_tensor(np.array(rect.levels[-1].rhs))
    g = CycleGraph(t.step, "mg.capture")
    with pytest.raises(ValueError, match="CUDA tensors"):
        g(rhs, torch.zeros_like(rhs))
    assert g.graph is None and g.name == "mg.capture"


class _FakeGraph:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU: its replay reruns
    ``fn`` on the owner's static inputs into its static outputs."""

    owner = fn = None

    def replay(self):
        g = _FakeGraph.owner
        for s, o in zip(g.static_out, _FakeGraph.fn(*g.static_in)):
            s.copy_(o)


def test_cycle_graph_returns_tuple_outputs(rect, monkeypatch):
    """Through stand-ins for the CUDA calls (the capture runs the step once
    eagerly, a replay reruns it): every call hands back a fresh tuple of
    tensors equal to the step's, and a later replay leaves it alone."""
    monkeypatch.setattr(CycleGraph, "captures", 0)      # restored afterwards
    monkeypatch.setattr(CycleGraph, "replays", 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(CycleGraph, "_warmup_streams", {})
    monkeypatch.setattr(torch.cuda, "Stream", lambda: type(
        "S", (), {"wait_stream": lambda self, other: None})())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type(
        "S", (), {"wait_stream": lambda self, other: None})())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    _, t = _pair(rect)
    rhs = torch.as_tensor(np.array(rect.levels[-1].rhs))
    g = CycleGraph(t.step, "mg.capture")
    _FakeGraph.owner, _FakeGraph.fn = g, t.step
    u0 = torch.zeros_like(rhs)
    first = g(rhs, u0)
    assert isinstance(first, tuple) and len(first) == 2
    ref = t.step(rhs, u0)
    assert all(torch.equal(a, b) for a, b in zip(first, ref))
    assert all(a is not s for a, s in zip(first, g.static_out))
    kept = tuple(x.clone() for x in first)
    second = g(rhs, first[0])
    ref2 = t.step(rhs, kept[0])
    assert all(torch.equal(a, b) for a, b in zip(second, ref2))
    assert all(torch.equal(a, b) for a, b in zip(first, kept))
    assert float(second[1]) < float(first[1])
    assert g.capture_seconds >= g.warmup_seconds + g.record_seconds >= 0
    assert g.launches == {} and (CycleGraph.captures, CycleGraph.replays) == (1, 2)
    assert g.fn is None         # dropped once captured: no cycle through t
