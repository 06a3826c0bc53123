"""dgtpu's compiled solve loops as the port runs them (``ops/graphs.py``:
``MaskedLoop`` on the CPU, ``LoopGraph`` on the card), checked on the CPU at
4x4 and smaller:

* For CG, GMRES (its Arnoldi steps and its restarts), the tracked smoother,
  the distributive-GS solve and the AMG cycle loop, every iteration runs
  under ``no_host_sync`` (``tests/test_torch_graph_programs.py``): nothing
  in it reads the device or copies host data to it, so it captures.
* The masked loop run in runs of 1, 3, more than the step count, and the
  size it picks itself gives the same history, count and iterate, bit for
  bit (NaN included): the frozen iterations after the stop change nothing.
* The results equal dgtpu's as ``test_torch_krylov.py``,
  ``test_torch_amg.py`` and ``test_torch_dgs.py`` state them, with their
  tolerances: JAX's CG and GMRES iterates and counts, a GMRES basis that
  breaks down, a restart whose Cholesky fails (NaN, with the warning),
  ``solve_krylov`` on dgtpu's 4x4 p=2 operator, the smoothers' sweeps,
  statuses and histories, and the AMG cycles.
* Edge cases: a smoother that diverges to NaN (status 2, history and
  iterate frozen at the NaN sweep), ``maxiter`` reached inside a run.
* ``LoopGraph`` refuses CPU tensors; through a stand-in for the capture
  (its replay reruns the recorded iteration) it gives the masked loop's
  bits and counts its capture and replays, and a capture that fails raises
  out of the solver instead of falling back to the eager loop.

The graphs against their eager runs on the card, bit for bit, are
``chip_smoke.py`` phase 26's cases.
"""

import contextlib
import copy
import gc
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgtpu_torch.api as tapi
from dgtpu.models import stokes as jstokes
from dgtpu.solvers import amg as jamg
from dgtpu.solvers import krylov as jkrylov
from dgtpu.solvers.relaxation_driver import residual_tracked_smoother as jtracked
from dgtpu_torch.convert import from_dgtpu_arrays
from dgtpu_torch.models import stokes as tstokes
from dgtpu_torch.ops import graphs
from dgtpu_torch.ops.graphs import CycleGraph, LoopGraph, MaskedLoop
from dgtpu_torch.settings import Settings
from dgtpu_torch.solvers import amg as tamg
from dgtpu_torch.solvers import krylov as tkrylov
from dgtpu_torch.solvers.multigrid import MultigridSolver
from dgtpu_torch.solvers.relaxation_driver import residual_tracked_smoother
from test_torch_amg import ops  # noqa: F401  (fixture)
from test_torch_dgs import dgs_ref, levels  # noqa: F401  (fixtures)
from test_torch_graph_programs import no_host_sync
from test_torch_krylov import (TOL, _Level, _jacobi, _nonsymmetric, _poisson_params,
                               _rel, _spd, poisson_mg)  # noqa: F401  (fixture)

torch.set_num_threads(1)


# -- running a solver's loops masked, guarded, at a given run size -------------

def _guarded(forced, made, base=MaskedLoop):
    """A stand-in for ``graphs.while_loop``: a ``base`` loop whose
    iterations run under ``no_host_sync`` and whose runs are ``forced``
    long (``None``: the loop's own choice); each loop made is appended to
    ``made``, with its iterations counted."""

    class Guarded(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.iterations = 0
            made.append(self)

        def step(self, state, flag):
            with no_host_sync():
                super().step(state, flag)
            self.iterations += 1

        def run(self, max_steps, chunk=None):
            return super().run(max_steps, forced)

    return Guarded


def _masked(fn, chunk, base=MaskedLoop):
    """``(fn(), the loops it ran)`` with every loop of ``fn`` guarded and
    run in runs of ``chunk``."""
    made = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "while_loop", _guarded(chunk, made, base))
        return fn(), made


def _bits(x):
    """``x`` (tensors, arrays, floats, ints in tuples, lists and dicts) as
    something ``==`` compares bit for bit, NaN included."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    if isinstance(x, float):
        x = np.float64(x)
    if isinstance(x, (np.ndarray, np.floating)) and x.dtype == np.float64:
        return ("f64", np.shape(x), np.asarray(x).view(np.int64).tobytes())
    if isinstance(x, dict):
        return {k: _bits(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [_bits(v) for v in x]
    return x


def _runs_agree(fn, count):
    """Run ``fn`` at runs of 1, 3, more than ``count(result)`` steps and the
    loop's own choice: the same result bit for bit; returns the run-1
    result, the steps it took and its loops."""
    first, loops = _masked(fn, 1)
    steps = count(first)
    for chunk in (3, steps + 7, None):
        again, loops_again = _masked(fn, chunk)
        assert _bits(again) == _bits(first), f"chunk {chunk}"
        assert len(loops_again) == len(loops)
    return first, steps, loops


# -- CG and GMRES against JAX's ------------------------------------------------

def _port_jacobi(A):
    """``test_torch_krylov``'s Jacobi preconditioner with its diagonal made
    once (theirs makes it from host data on every call)."""
    d = torch.as_tensor(1.0 / np.diag(A))
    return lambda x: d * x


def _jax_and_port(solver, A, b, precondition, **kw):
    Mj = _jacobi(A)[0] if precondition else None
    Mt = _port_jacobi(A) if precondition else None
    At = torch.as_tensor(A)
    jsolve = getattr(jax.scipy.sparse.linalg, solver)
    if solver == "gmres":
        kw_j = dict(kw, solve_method="batched")
    else:
        kw_j = kw
    xj, _ = jsolve(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), M=Mj, **kw_j)

    def port():
        return getattr(tkrylov, solver)(lambda v: At @ v, torch.as_tensor(b), M=Mt, **kw)
    return np.asarray(xj), port


@pytest.mark.parametrize("precondition", [False, True])
def test_cg_runs_agree_and_match_jax(precondition):
    """CG to convergence: the first residual and each step (its Jacobi
    preconditioner included) are one masked iteration each; JAX's iterate,
    and the fewest ``maxiter`` with which JAX reaches it is the port's
    count; ``maxiter`` reached inside a run of 3 stops there."""
    A, b = _spd()
    kw = dict(tol=1e-9, atol=1e-12)
    xj, port = _jax_and_port("cg", A, b, precondition, **kw)
    (xt, k), steps, loops = _runs_agree(port, lambda r: r[1])
    assert len(loops) == 1 and loops[0].name == "krylov.capture"
    assert loops[0].iterations == k + 1
    assert _rel(xt, xj) < TOL
    Mj = _jacobi(A)[0] if precondition else None
    capped = [np.asarray(jax.scipy.sparse.linalg.cg(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(b), M=Mj, maxiter=m, **kw)[0])
        for m in (k - 1, k)]
    assert np.array_equal(capped[1], xj) and not np.array_equal(capped[0], xj)
    # maxiter inside a run: 3 + 3 + 2 iterations (the first residual and 7
    # steps), the last run cut to 8
    At, Mt = torch.as_tensor(A), _port_jacobi(A) if precondition else None

    def seven():
        return tkrylov.cg(lambda v: At @ v, torch.as_tensor(b), M=Mt, maxiter=7, **kw)

    (x7, k7), loops7 = _masked(seven, 3)
    assert k7 == 7 < k and loops7[0].iterations == 8
    assert _bits(x7) == _bits(_masked(seven, 1)[0][0])


GMRES_SYSTEMS = {
    # restarts of 4 to convergence
    "converged": lambda: (*_nonsymmetric(), dict(tol=1e-9, atol=1e-12, restart=4)),
    # two distinct eigenvalues and b = 1: the basis breaks down exactly (a
    # zero vector) after two vectors of a restart of six
    "breakdown": lambda: (np.diag([1.0] * 3 + [4.0] * 3), np.ones(6),
                          dict(tol=1e-12, restart=6, maxiter=1)),
    # test_gmres_breakdown_matches_jax's system: three distinct eigenvalues,
    # so the basis breaks down after three vectors in exact arithmetic (in
    # rounding it goes on with vectors of norm ~1e-15, in both packages)
    "three eigenvalues": lambda: (*_three_eigenvalues(),
                                  dict(tol=1e-12, restart=8, maxiter=1)),
    # A maps the first Arnoldi vector to zero: the Cholesky stops at pivot 1
    "cholesky": lambda: (np.diag([1.0, 0.0]), np.array([0.0, 1.0]),
                         dict(tol=1e-12, restart=2, maxiter=1)),
}


def _three_eigenvalues():
    rng = np.random.default_rng(2)
    Q, _ = np.linalg.qr(rng.standard_normal((10, 10)))
    return (Q * np.repeat([1.0, 2.0, 5.0], [3, 3, 4])) @ Q.T, rng.standard_normal(10)


@pytest.mark.parametrize("system", sorted(GMRES_SYSTEMS))
def test_gmres_runs_agree_and_match_jax(system, caplog, monkeypatch):
    """The steps of every restart are one masked loop (one loop for the
    solve, reset in place per restart): each restart's residual step, then
    its Arnoldi steps.  In runs of 1 and 3 steps, of more than the restart
    and of the loop's own choice, the same iterate and restarts, bit for
    bit; JAX's iterate, its restart count, its early breakdown (the frozen
    steps after it store nothing) and its NaN after a failed Cholesky, with
    the warning once per restart."""
    A, b, kw = GMRES_SYSTEMS[system]()
    xj, port = _jax_and_port("gmres", A, b, False, **kw)
    bases = []          # (V, H) of each restart's least-squares problem
    restart = tkrylov._gmres_batched

    def spy(arnoldi, m):
        out = restart(arnoldi, m)
        bases.append([t.clone() for t in arnoldi.state[1:3]])
        return out

    monkeypatch.setattr(tkrylov, "_gmres_batched", spy)
    with caplog.at_level(logging.WARNING, logger="dgtpu_torch.solvers.krylov"):
        (xt, k), steps, loops = _runs_agree(port, lambda r: kw["restart"])
    assert len(loops) == 1 and loops[0].name == "krylov.capture"
    if system == "cholesky":
        assert k == 1 and np.isnan(xj).all() and np.isnan(xt.numpy()).all()
        # one warning for each of the four runs
        assert caplog.text.count("Cholesky stops at pivot 1") == 4
        return
    assert _rel(xt, xj) < TOL
    if system == "breakdown":
        V, H = bases[0]
        # the residual step, then steps 0 and 1, of which step 1 broke down
        # (it stored a zero vector and norm) and stopped the run of 1 (the
        # frozen steps 2-5 of the longer runs stored nothing), then the
        # final residual step
        assert loops[0].iterations == 4
        assert (V[:, 2:] == 0).all() and (V[:, :2] != 0).any(dim=0).all()
        assert (H[:2, :2] != 0).all() and (H[:2, 2:] == 0).all()
        assert torch.equal(H[2:], torch.eye(6, 7, dtype=H.dtype)[2:])
        assert all(torch.equal(a, b) for base in bases for a, b in zip(base, bases[0]))
    if system in ("breakdown", "three eigenvalues"):
        assert k == 1 and np.linalg.norm(b - A @ xt.numpy()) < 1e-10 * np.linalg.norm(b)
        return
    capped = [np.asarray(jax.scipy.sparse.linalg.gmres(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(b), maxiter=m, solve_method="batched",
        **kw)[0]) for m in (k - 1, k)]
    assert np.array_equal(capped[1], xj) and not np.array_equal(capped[0], xj)


@pytest.mark.parametrize("method, precond", [
    ("cg", "multigrid"), ("gmres", "block_diagonal"), ("gmres", "amg"),
    ("gmres", "multigrid")])
def test_solve_krylov_runs_agree_and_match_dgtpu(poisson_mg, method, precond):
    """``solve_krylov`` on dgtpu's 4x4 p=2 operator: with the multigrid
    preconditioner the cycle runs inside each masked step (on the card
    inside the step's graph); the same bits at every run size, dgtpu's
    solution to 1e-8."""
    ref = poisson_mg
    s = copy.deepcopy(ref.settings)
    s.solver.krylov.method, s.solver.krylov.preconditioner = method, precond
    dims = [(l.Nj, l.Ni) for l in ref.levels]
    ops_, trs = from_dgtpu_arrays(
        [dict(blocks=np.asarray(l.op.blocks), nbr=np.asarray(l.op.nbr),
              mask=np.asarray(l.op.mask)) for l in ref.levels],
        [dict(kind=t.kind, R=np.asarray(t.R), P=np.asarray(t.P)) for t in ref.transfers],
        ref.transfer_types, dims)
    j_cycle = t_cycle = None
    if precond == "multigrid":
        j_cycle = ref._krylov_mg_cycle()
        mg = MultigridSolver(ops_, trs, ref.transfer_types, s)
        t_cycle = lambda r: mg.v_cycle(len(ops_), r, torch.zeros_like(r))  # noqa: E731
    finest = ref.levels[-1]
    u_ref = jkrylov.solve_krylov(finest, s, mg_cycle=j_cycle)
    level = _Level(ops_[-1], torch.as_tensor(np.array(finest.rhs)))
    (u, k), steps, loops = _runs_agree(
        lambda: tkrylov.solve_krylov(level, s, mg_cycle=t_cycle),
        lambda r: r[1] if method == "cg" else int(s.solver.krylov.restart))
    assert k >= 1 and len(loops) == 1
    assert _rel(u, u_ref) < 1e-8


# -- the tracked smoothers -----------------------------------------------------

def test_tracked_smoother_runs_agree_and_match_dgtpu(ops):  # noqa: F811
    """``-s`` block GS (sequential wavefronts, symmetric) on dgtpu's 4x4 p=2
    operator: one sweep, its residual and the history store are one masked
    iteration; dgtpu's sweeps and status, its history to 1e-7 and its
    iterate to 1e-8."""
    lvl, op, rhs = ops
    u_ref, h_ref, n_ref, s_ref = jtracked(lvl.op, lvl.rhs, name="block_gauss_seidel",
                                          max_iterations=1000)
    (u, hist, n, status), steps, loops = _runs_agree(
        lambda: residual_tracked_smoother(op, rhs, name="block_gauss_seidel",
                                          max_iterations=1000), lambda r: r[2])
    assert loops[0].name == "smoother.capture" and loops[0].iterations == n
    assert (n, status) == (int(n_ref), int(s_ref)) == (n, 0)
    h_ref = np.asarray(h_ref)
    assert len(hist) == n and np.isnan(h_ref[n:]).all()
    assert np.allclose(hist, h_ref[:n], rtol=1e-7, atol=0)
    assert _rel(u, u_ref) < 1e-8


def test_smoother_diverging_to_nan_freezes(ops):  # noqa: F811
    """A right-hand side with a NaN: the first sweep's residual is NaN, so
    the loop stops there with status 2; the history holds that one NaN and
    the iterate is the first sweep's, whatever the runs replay after it;
    ``max_iterations`` reached inside a run stops there (status 1)."""
    _, op, rhs = ops
    bad = rhs.clone()
    bad[3] = math.nan
    (u, hist, n, status), steps, loops = _runs_agree(
        lambda: residual_tracked_smoother(op, bad, name="block_gauss_seidel",
                                          max_iterations=50), lambda r: r[2])
    assert (n, status) == (1, 2) and len(hist) == 1 and math.isnan(hist[0])
    (u1, h1, n1, s1), _ = _masked(lambda: residual_tracked_smoother(
        op, bad, name="block_gauss_seidel", max_iterations=1), 1)
    assert _bits(u) == _bits(u1) and (n1, s1) == (1, 2)
    (u7, h7, n7, s7), loops7 = _masked(lambda: residual_tracked_smoother(
        op, rhs, name="block_gauss_seidel", max_iterations=7), 3)
    assert (n7, s7, len(h7)) == (7, 1, 7) and loops7[0].iterations == 7
    (u7_1, h7_1, _, _), _ = _masked(lambda: residual_tracked_smoother(
        op, rhs, name="block_gauss_seidel", max_iterations=7), 1)
    assert _bits((u7, h7)) == _bits((u7_1, h7_1))


@pytest.mark.parametrize("splitting, max_iterations, status", [
    ("lsq", 1000, 0), ("classical", 500, 2)])
def test_dgs_solve_runs_agree_and_match_dgtpu(levels, splitting,  # noqa: F811
                                              max_iterations, status):
    """The distributive-GS solve on dgtpu's 4x4 global-order Stokes level:
    one sweep, its residual and the history store are one masked iteration;
    dgtpu's sweeps and status (``classical`` diverges past 1e10, and the
    frozen runs after it store nothing), its history to 1e-7 (to 1e-6 over
    the first half while diverging) and its iterate to 1e-8."""
    j, t = levels
    u_ref, h_ref, n_ref, s_ref = jstokes.distributive_gauss_seidel_solve(
        j, j.rhs, splitting=splitting, max_iterations=max_iterations)
    (u, hist, n, s), steps, loops = _runs_agree(
        lambda: tstokes.distributive_gauss_seidel_solve(
            t, t.rhs, splitting=splitting, max_iterations=max_iterations),
        lambda r: r[2])
    assert loops[0].name == "smoother.capture"
    assert (n, s) == (int(n_ref), int(s_ref)) and s == status
    h_ref = np.asarray(h_ref)
    assert hist.shape == h_ref.shape and np.isnan(hist[n:]).all()
    if status == 0:
        assert np.allclose(hist[:n], h_ref[:n], rtol=1e-7, atol=0)
        assert _rel(u, u_ref) < 1e-8
    else:
        assert hist[n - 1] > 1e10
        assert np.allclose(hist[:n // 2], h_ref[:n // 2], rtol=1e-6, atol=0)


# -- the AMG cycle loop --------------------------------------------------------

@pytest.mark.parametrize("variant", ["sa", "rs"])
def test_amg_runs_agree_and_match_dgtpu(ops, variant):  # noqa: F811
    """``solve_amg``: one cycle, its residual and the history store are one
    masked iteration; dgtpu's cycles and history (1e-8) and iterate (1e-8);
    ``maxiter`` reached inside a run of 3 stops there, with info 1."""
    lvl, op, rhs = ops
    u_ref, info_ref = jamg.solve_amg(lvl.op, lvl.rhs, variant=variant)
    (u, info), steps, loops = _runs_agree(
        lambda: tamg.solve_amg(op, rhs, variant=variant), lambda r: r[1]["cycles"])
    assert loops[0].name == "amg.capture" and loops[0].iterations == info["cycles"]
    assert info["cycles"] == len(info["residuals"]) == len(info_ref["residuals"])
    assert info["info"] == info_ref["info"] == 0
    assert np.allclose(info["residuals"], info_ref["residuals"], rtol=1e-8, atol=0)
    assert _rel(u, u_ref) < 1e-8
    short = [_masked(lambda: tamg.solve_amg(op, rhs, maxiter=4, variant=variant), c)[0]
             for c in (3, 1)]
    assert short[0][1]["cycles"] == 4 and short[0][1]["info"] == 1
    assert _bits(short[0]) == _bits(short[1])
    assert _bits(short[0][1]["residuals"]) == _bits(info["residuals"][:4])


@pytest.mark.parametrize("loop", ["amg", "cg", "gmres", "smoother"])
def test_loops_leave_no_tensor_to_the_garbage_collector(ops, loop):  # noqa: F811
    """A solve's device tensors (the AMG levels' dense matrices, a loop's
    state and graph) are freed when it returns, not when the garbage
    collector runs: no reference cycle holds a tensor (phase 26 checks on
    the card that the memory held after a solve does not grow)."""
    _, op, rhs = ops
    runs = {"amg": lambda: tamg.solve_amg(op, rhs, variant="sa"),
            "cg": lambda: tkrylov.cg(op.matvec, rhs, tol=1e-8),
            "gmres": lambda: tkrylov.gmres(op.matvec, rhs, tol=1e-8, restart=10,
                                           maxiter=5),
            "smoother": lambda: residual_tracked_smoother(op, rhs, max_iterations=20)}
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        runs[loop]()
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.garbage.clear()
        gc.set_debug(0)
        gc.enable()
    assert held == []


# -- LoopGraph -----------------------------------------------------------------

def test_loop_graph_refuses_cpu_tensors(ops):  # noqa: F811
    _, op, rhs = ops
    state = (torch.zeros((), dtype=torch.int64), rhs.clone())
    with pytest.raises(ValueError, match="CUDA tensors"):
        LoopGraph(lambda s: s[0] < 3, lambda s: (s[0] + 1, s[1]), state, "amg.capture")
    assert isinstance(graphs.while_loop(lambda s: s[0] < 3, lambda s: s, state),
                      MaskedLoop)


class _Replay:
    """A stand-in for a captured CUDA graph: a replay reruns what the
    capture recorded (on the CPU the recording cannot be kept without
    running it, so the stand-in runs the warm-up only, as a capture runs
    nothing)."""

    def __init__(self, record):
        self.replay = record


def _fake_record(warm, record):
    warm()
    return _Replay(record), {}, {}, (0.25, 0.5, 0.125)


@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor reports CUDA, so the solvers build ``LoopGraph``s, whose
    captures go through ``_fake_record``."""
    monkeypatch.setattr(CycleGraph, "captures", 0)      # restored afterwards
    monkeypatch.setattr(CycleGraph, "replays", 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(graphs, "_record", _fake_record)


def test_loop_graph_replays_the_masked_loop(ops, fake_card):  # noqa: F811
    """Through the stand-in: the AMG solve, CG and GMRES as ``LoopGraph``s
    give the masked loop's bits; one capture each (GMRES: one for all its
    restarts) with its split, a replay per iteration in the counters, and
    ``collect()`` lists them.  (Runs of 1, so that both count the same
    iterations; the capture's warm-up is one more step, on clones.)"""
    _, op, rhs = ops
    A, b = _nonsymmetric()
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    S, c = _spd()
    St, ct = torch.as_tensor(S), torch.as_tensor(c)
    runs = {"amg": lambda: tamg.solve_amg(op, rhs, variant="sa"),
            "cg": lambda: tkrylov.cg(lambda v: St @ v, ct, tol=1e-9, atol=1e-12),
            "gmres": lambda: tkrylov.gmres(lambda v: At @ v, bt, tol=1e-9, atol=1e-12,
                                           restart=4)}
    for name, run in runs.items():
        before = CycleGraph.replays
        with graphs.collect() as got:
            graphed, made = _masked(run, 1, LoopGraph)
        assert got == made and len(got) == 1
        g = got[0]
        assert g.name == ("amg.capture" if name == "amg" else "krylov.capture")
        assert g.capture_seconds == 0.875 and g.record_seconds == 0.5
        masked, loops = _masked(run, 1)
        assert _bits(graphed) == _bits(masked), name
        assert CycleGraph.replays - before == loops[0].iterations == g.iterations - 1


def test_route_counts_its_loop_captures(tmp_path, monkeypatch):
    """``DGFEM.solve`` adds its loops' capture seconds to ``graph_seconds``
    (``-amg`` on 4x4 p=2: one capture, through the stand-in)."""
    params = _poisson_params()
    params["solver"]["amg"]["variant"] = "sa"
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    dg = tapi.DGFEM(device="cpu", settings=Settings(params), solve_pyamg=True)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(graphs, "_record", _fake_record)
    monkeypatch.setattr(tapi, "synchronize", lambda u: None)
    dg.solve()
    assert dg.graphed and dg.graph_seconds == 0.875 and dg.amg_info["info"] == 0


def test_failed_capture_raises(ops, monkeypatch):
    """A capture that fails (here ``torch.cuda.graph`` refuses) raises out of
    the solver: no loop falls back to its eager run."""
    _, op, rhs = ops
    monkeypatch.setattr(CycleGraph, "captures", 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(CycleGraph, "_warmup_streams", {})
    stream = type("S", (), {"wait_stream": lambda self, other: None})
    monkeypatch.setattr(torch.cuda, "Stream", stream)
    monkeypatch.setattr(torch.cuda, "current_stream", stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: None)

    def refuse(graph):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(torch.cuda, "graph", refuse)
    A, b = _spd()
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    for run in (lambda: tamg.solve_amg(op, rhs, variant="sa"),
                lambda: tkrylov.cg(lambda v: At @ v, bt, tol=1e-9),
                lambda: tkrylov.gmres(lambda v: At @ v, bt, tol=1e-9, restart=4),
                lambda: residual_tracked_smoother(op, rhs, max_iterations=5)):
        with pytest.raises(RuntimeError, match="capturing"):
            run()
    assert CycleGraph.captures == 0
