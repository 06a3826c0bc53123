"""dgtpu_torch's Krylov solvers against dgtpu's, on the CPU in float64.

* ``cg`` and ``gmres`` against ``jax.scipy.sparse.linalg``'s (the solvers
  dgtpu calls) on one small SPD and one nonsymmetric matrix from a numpy
  seed: the iterates after 1-2 CG steps or GMRES restarts, and the
  converged ones, agree to 1e-10 relative; the steps or restarts the port
  counts are the fewest with which JAX's iterate reaches its converged one;
  a GMRES basis that breaks down early agrees too, and so does a restart
  whose normal equations are singular (NaN in both).
* ``solve_krylov`` for each Poisson preconditioner (block-diagonal, SA-AMG,
  multigrid, with GMRES and CG) on dgtpu's 4x4 p=2 operator carried across
  by ``convert.py``, against dgtpu's ``solve_krylov``, to 1e-8.
* The ``-k`` routes end to end through ``DGFEM(device="cpu")``: Poisson
  with GMRES and CG, global-order Stokes (p_u=2/p_p=1) with the Schur
  block-diagonal and the multigrid (distributive GS) preconditioner, and
  local-order Stokes (to 1e-12: the saddle operator is singular, and the
  iterate stopped at the shipped tolerances depends on rounding): L1/L2
  within 1e-8 of dgtpu's route.
* dgtpu's three Krylov errors: CG on Stokes, CG with a non-symmetric cycle,
  a multigrid preconditioner without a hierarchy.
"""

import copy
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dgtpu.api import DGFEM as JDGFEM
from dgtpu.settings import Settings as JSettings
from dgtpu.solvers import krylov as jkrylov

import dgtpu_torch.api as tapi
from dgtpu_torch.convert import from_dgtpu_arrays
from dgtpu_torch.settings import Settings, load_params
from dgtpu_torch.solvers import krylov as tkrylov
from dgtpu_torch.solvers.multigrid import MultigridSolver

torch.set_num_threads(1)
TOL = 1e-10


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _spd(n=40, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (Q * np.linspace(1.0, 30.0, n)) @ Q.T, rng.standard_normal(n)


def _nonsymmetric(n=40, seed=1):
    rng = np.random.default_rng(seed)
    return 3.0 * np.eye(n) + rng.standard_normal((n, n)) / np.sqrt(n), \
        rng.standard_normal(n)


def _jacobi(A):
    d = 1.0 / np.diag(A)
    return (lambda x: jnp.asarray(d) * x), (lambda x: torch.as_tensor(d) * x)


def _both(A, b, jsolve, tsolve, precondition, **kw):
    """(JAX's x, the port's x, the port's count) for one set of arguments."""
    Mj, Mt = _jacobi(A) if precondition else (None, None)
    At = torch.as_tensor(A)
    xj, _ = jsolve(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), M=Mj, **kw)
    kw.pop("solve_method", None)         # the port's gmres is JAX's 'batched'
    xt, k = tsolve(lambda v: At @ v, torch.as_tensor(b), M=Mt, **kw)
    return np.asarray(xj), xt.numpy(), k


@pytest.mark.parametrize("precondition", [False, True])
@pytest.mark.parametrize("maxiter", [1, 2])
def test_cg_iterates_match_jax(maxiter, precondition):
    A, b = _spd()
    xj, xt, k = _both(A, b, jax.scipy.sparse.linalg.cg, tkrylov.cg, precondition,
                      tol=1e-12, maxiter=maxiter)
    assert k == maxiter
    assert _rel(xt, xj) < TOL


@pytest.mark.parametrize("precondition", [False, True])
@pytest.mark.parametrize("maxiter", [1, 2])
def test_gmres_iterates_match_jax(maxiter, precondition):
    A, b = _nonsymmetric()
    xj, xt, k = _both(A, b, jax.scipy.sparse.linalg.gmres, tkrylov.gmres, precondition,
                      tol=1e-12, restart=5, maxiter=maxiter, solve_method="batched")
    assert k == maxiter
    assert _rel(xt, xj) < TOL


@pytest.mark.parametrize("solver", ["cg", "gmres"])
def test_converged_iterates_and_counts_match_jax(solver):
    """Run to convergence: the same iterate, and the port's count of steps
    (CG) or restarts (GMRES) is the fewest with which JAX reaches it; the
    stopping test is JAX's (r.r for CG, the preconditioned residual for
    GMRES, against max(tol ||b||, atol))."""
    if solver == "cg":
        (A, b), jsolve, tsolve = _spd(), jax.scipy.sparse.linalg.cg, tkrylov.cg
        kw = dict(tol=1e-9, atol=1e-12)
    else:
        (A, b), jsolve, tsolve = (_nonsymmetric(), jax.scipy.sparse.linalg.gmres,
                                  tkrylov.gmres)
        kw = dict(tol=1e-9, atol=1e-12, restart=4, solve_method="batched")
    xj, xt, k = _both(A, b, jsolve, tsolve, True, **kw)
    assert _rel(xt, xj) < TOL
    capped = [_both(A, b, jsolve, tsolve, True, maxiter=m, **kw)[0]
              for m in (k - 1, k)]
    assert np.array_equal(capped[1], xj) and not np.array_equal(capped[0], xj)


def test_gmres_breakdown_matches_jax():
    """A matrix with three distinct eigenvalues: the Arnoldi basis breaks
    down after three vectors of a restart of eight (JAX keeps the identity
    rows of H past it)."""
    rng = np.random.default_rng(2)
    Q, _ = np.linalg.qr(rng.standard_normal((10, 10)))
    A = (Q * np.repeat([1.0, 2.0, 5.0], [3, 3, 4])) @ Q.T
    b = rng.standard_normal(10)
    xj, xt, k = _both(A, b, jax.scipy.sparse.linalg.gmres, tkrylov.gmres, False,
                      tol=1e-12, restart=8, maxiter=1, solve_method="batched")
    assert k == 1 and _rel(xt, xj) < TOL
    assert np.linalg.norm(b - A @ xt) < 1e-10 * np.linalg.norm(b)


def test_gmres_cholesky_breakdown_gives_nan_as_jax(caplog):
    """A singular system whose first Arnoldi vector A maps to zero: the
    restart's normal equations H H^T have a zero first pivot, so JAX's
    batched GMRES returns NaN, and the port's does too, with a warning that
    names the pivot."""
    A, b = np.diag([1.0, 0.0]), np.array([0.0, 1.0])
    with caplog.at_level(logging.WARNING, logger="dgtpu_torch.solvers.krylov"):
        xj, xt, k = _both(A, b, jax.scipy.sparse.linalg.gmres, tkrylov.gmres, False,
                          tol=1e-12, restart=2, maxiter=1, solve_method="batched")
    assert k == 1 and np.isnan(xj).all() and np.isnan(xt).all()
    assert "Cholesky stops at pivot 1" in caplog.text


# --------------------------------------------------------------------------
# solve_krylov on dgtpu's Poisson operator
# --------------------------------------------------------------------------

def _poisson_params(method="gmres", precond="block_diagonal", post=1):
    params = load_params()
    params["grid"]["filename"] = "Rectangle_4X4_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["solution"]["u"]["polynomial degree"] = 2
    mg = params["solver"]["multigrid"]
    mg["polynomial coarsening"]["levels"]["u"] = "1,2"
    for node in ("polynomial coarsening", "geometric coarsening"):
        mg[node]["post smoother"]["iterations"] = post
    params["solver"]["krylov"]["method"] = method
    params["solver"]["krylov"]["preconditioner"] = precond
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    return params


class _Level:
    def __init__(self, op, rhs):
        self.op, self.rhs, self.block_A = op, rhs, None


@pytest.fixture(scope="module")
def poisson_mg():
    """dgtpu's 4x4 p=2 Poisson hierarchy for ``-k`` with the multigrid
    preconditioner (symmetric 2/2 block-GS sweeps, so CG may use it)."""
    return JDGFEM(settings=JSettings(_poisson_params("cg", "multigrid", post=2)),
                  solve_krylov=True)


@pytest.mark.parametrize("method, precond", [
    ("gmres", "block_diagonal"), ("cg", "block_diagonal"), ("gmres", "amg"),
    ("cg", "amg"), ("gmres", "multigrid"), ("cg", "multigrid")])
def test_solve_krylov_matches_dgtpu(poisson_mg, method, precond):
    ref = poisson_mg
    s = copy.deepcopy(ref.settings)
    s.solver.krylov.method, s.solver.krylov.preconditioner = method, precond
    dims = [(l.Nj, l.Ni) for l in ref.levels]
    ops, trs = from_dgtpu_arrays(
        [dict(blocks=np.asarray(l.op.blocks), nbr=np.asarray(l.op.nbr),
              mask=np.asarray(l.op.mask)) for l in ref.levels],
        [dict(kind=t.kind, R=np.asarray(t.R), P=np.asarray(t.P)) for t in ref.transfers],
        ref.transfer_types, dims)
    j_cycle = t_cycle = None
    if precond == "multigrid":
        j_cycle = ref._krylov_mg_cycle()
        mg = MultigridSolver(ops, trs, ref.transfer_types, s)
        t_cycle = lambda r: mg.v_cycle(len(ops), r, torch.zeros_like(r))  # noqa: E731
    finest = ref.levels[-1]
    u_ref = jkrylov.solve_krylov(finest, s, mg_cycle=j_cycle)
    level = _Level(ops[-1], torch.as_tensor(np.array(finest.rhs)))
    u, k = tkrylov.solve_krylov(level, s, mg_cycle=t_cycle)
    assert k >= 1
    assert _rel(u, u_ref) < 1e-8


# --------------------------------------------------------------------------
# the -k routes
# --------------------------------------------------------------------------

def _stokes_params(ordering="global", precond="block_diagonal"):
    """4x4 p_u=2/p_p=1 Stokes; with the multigrid preconditioner a
    two-level p-hierarchy (u 2 -> 1) of distributive-GS (lsq) V-cycles with
    the dense coarse solve."""
    params = chip_smoke.stokes_params(4)
    params["solution"]["ordering"] = ordering
    params["performance"]["precision"] = "full"
    params["solver"]["krylov"]["preconditioner"] = precond
    mg = params["solver"]["multigrid"]
    mg["geometric coarsening"]["enabled"] = False
    mg["cycle type"] = "V"
    return params


def _route(tmp, params, ref_params=None):
    """(dgtpu DGFEM, port DGFEM), both solved by ``-k``."""
    ref = JDGFEM(settings=JSettings(copy.deepcopy(ref_params or params)),
                 solve_krylov=True)
    ref.solve()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "OUTPUT_ROOT", str(tmp))
        port = tapi.DGFEM(device="cpu", settings=Settings(copy.deepcopy(params)),
                          solve_krylov=True)
        port.solve()
    return ref, port


def _errors(dg, vars_):
    return np.array([getattr(dg, f"{n}_error_{v}") for v in vars_ for n in ("L1", "L2")])


@pytest.mark.parametrize("case", ["poisson gmres", "poisson cg amg",
                                  "stokes schur", "stokes multigrid"])
def test_krylov_routes_match_dgtpu(tmp_path, case):
    if case.startswith("poisson"):
        params = (_poisson_params() if case == "poisson gmres"
                  else _poisson_params("cg", "amg"))
        vars_ = "u"
    else:
        params = _stokes_params(precond="multigrid" if "multigrid" in case
                                else "block_diagonal")
        vars_ = "uvp"
    ref, port = _route(tmp_path, params)
    assert port.krylov_iterations >= 1
    assert (len(port.levels) > 1) == ("multigrid" in case)
    assert _rel(_errors(port, vars_), _errors(ref, vars_)) < 1e-8


def test_local_order_stokes_krylov_matches_dgtpu(tmp_path):
    """The local-order saddle operator is singular (its pressure constant is
    free).  At the shipped tolerances (1e-8, absolute 1e-5) GMRES stops
    after one restart far from convergence, and that iterate depends on
    rounding through the Cholesky of the normal equations: dgtpu's own L2
    errors move by ~2e-8 under 1e-15 relative perturbations of the
    right-hand side.  Run to 1e-12 (absolute 0) the route is determined to
    ~2e-14 in dgtpu, and the port is held to it at 1e-8."""
    params = _stokes_params("local")
    params["solver"]["krylov"]["tolerance"] = 1e-12
    params["solver"]["krylov"]["absolute tolerance"] = 0.0
    ref, port = _route(tmp_path, params)
    assert port.levels[-1].block_A is None and port.krylov_iterations >= 1
    assert _rel(_errors(port, "uvp"), _errors(ref, "uvp")) < 1e-8


def test_dgtpus_krylov_errors(tmp_path, monkeypatch):
    """CG on the Stokes saddle system, CG with a non-symmetric cycle (the
    paramfile's 2 pre / 1 post sweeps) and the multigrid preconditioner
    without a hierarchy raise dgtpu's ValueErrors in both packages."""
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    stokes = _stokes_params()
    stokes["solver"]["krylov"]["method"] = "cg"
    nonsym = _poisson_params("cg", "multigrid", post=1)
    for params, match in ((stokes, "requires an SPD operator"),
                          (nonsym, "needs a symmetric cycle")):
        with pytest.raises(ValueError, match=match):
            JDGFEM(settings=JSettings(copy.deepcopy(params)), solve_krylov=True).solve()
        with pytest.raises(ValueError, match=match):
            tapi.DGFEM(device="cpu", settings=Settings(copy.deepcopy(params)),
                       solve_krylov=True).solve()
    port = tapi.DGFEM(device="cpu", settings=Settings(_poisson_params()), solve_krylov=True)
    s = copy.deepcopy(port.settings)
    s.solver.krylov.preconditioner = "multigrid"
    match = "requires the assembled hierarchy"
    with pytest.raises(ValueError, match=match):
        jkrylov.solve_krylov(port.levels[-1], s)
    with pytest.raises(ValueError, match=match):
        tkrylov.solve_krylov(port.levels[-1], s)
