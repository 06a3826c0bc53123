"""dgtpu_torch's full-precision solvers against dgtpu's on the same
operators (4x4 p=2: p 2->1 plus one geometric level), float64:
``MultigridSolver`` (one cycle and the FMG guess < 1e-12 relative; the solve's
cycle count equal and its residual history < 1e-8 relative), the direct
solve, and the tracked and fixed-count smoother solves with their status codes.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from dgtpu.ops.smoothers import element_colors as jcolors
from dgtpu.solvers import direct as jdirect
from dgtpu.solvers import relaxation_driver as jrelax
from dgtpu.solvers.multigrid import MultigridSolver as JMultigridSolver

from dgtpu_torch.convert import from_dgtpu_arrays
from dgtpu_torch.ops.smoothers import element_colors
from dgtpu_torch.solvers import direct, relaxation_driver
from dgtpu_torch.solvers.multigrid import MultigridSolver, SmootherConfig

torch.set_num_threads(1)
TOL = 1e-12


@pytest.fixture(scope="module")
def rect():
    return __graft_entry__._flagship(n=4, p_grid=2, p_sol=2)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _pair(dg, strategy="sequential", cycle="V", coarse="smoother", fmg=False,
          smoother=None, port_only=False):
    s = copy.deepcopy(dg.settings)
    s.performance.smoother_parallelization = strategy
    mg = s.solver.multigrid
    mg.cycle_type, mg.coarse_grid_solver, mg.full_multigrid = cycle, coarse, fmg
    if smoother:
        for node in (mg.polynomial_coarsening, mg.geometric_coarsening):
            node.pre_smoother.smoother = node.post_smoother.smoother = smoother
    dims = [(l.Nj, l.Ni) for l in dg.levels]
    ops, trs = from_dgtpu_arrays(
        [dict(blocks=np.asarray(l.op.blocks), nbr=np.asarray(l.op.nbr),
              mask=np.asarray(l.op.mask)) for l in dg.levels],
        [dict(kind=t.kind, R=np.asarray(t.R), P=np.asarray(t.P))
         for t in dg.transfers], dg.transfer_types, dims)
    j = None if port_only else JMultigridSolver(
        [l.op for l in dg.levels], dg.transfers, dg.transfer_types, s,
        colors=[jcolors(l.Ni, l.Nj) for l in dg.levels])
    t = MultigridSolver(ops, trs, dg.transfer_types, s,
                        colors=[element_colors(l.Ni, l.Nj) for l in dg.levels])
    return j, t


def test_transfers_act_on_flat_vectors(rect):
    """TransferOp.restrict / prolong, the generic multigrid's transfers."""
    _, t = _pair(rect)
    rng = np.random.default_rng(0)
    for jt, tt, fine, coarse in zip(rect.transfers, t.transfers, rect.levels[1:],
                                    rect.levels[:-1]):
        r = rng.standard_normal(fine.op.shape[0])
        e = rng.standard_normal(coarse.op.shape[0])
        assert _rel(tt.restrict(torch.as_tensor(r)), jt.restrict(jnp.asarray(r))) < 1e-14
        assert _rel(tt.prolong(torch.as_tensor(e)), jt.prolong(jnp.asarray(e))) < 1e-14


@pytest.mark.parametrize("strategy, cycle, coarse", [
    ("sequential", "V", "smoother"), ("sequential", "W", "direct"),
    ("redblack", "V", "smoother"), ("redblack", "F", "direct"),
    ("redblack", "W", "smoother")])
def test_v_cycle_matches(rect, strategy, cycle, coarse):
    j, t = _pair(rect, strategy, cycle, coarse)
    rhs = np.array(rect.levels[-1].rhs)
    u0 = np.random.default_rng(1).standard_normal(rhs.shape)
    n = len(rect.levels)
    ref = j.v_cycle(n, jnp.asarray(rhs), jnp.asarray(u0))
    assert _rel(t.v_cycle(n, torch.as_tensor(rhs), torch.as_tensor(u0)), ref) < TOL


@pytest.mark.parametrize("smoother", ["chebyshev", "jacobi"])
def test_v_cycle_with_other_smoothers(rect, smoother):
    """Chebyshev takes its interval from each solver's own power iteration
    (different start vectors): the port is handed dgtpu's."""
    j, t = _pair(rect, "redblack", smoother=smoother)
    if smoother == "chebyshev":
        assert [e is None for e in t.eig_max] == [e is None for e in j.eig_max]
        assert all(a == pytest.approx(b, rel=0.05) for a, b in zip(t.eig_max, j.eig_max))
        t.eig_max = list(j.eig_max)
    rhs = np.array(rect.levels[-1].rhs)
    n = len(rect.levels)
    ref = j.v_cycle(n, jnp.asarray(rhs), jnp.zeros(rhs.shape))
    got = t.v_cycle(n, torch.as_tensor(rhs), torch.zeros(rhs.shape, dtype=torch.float64))
    assert _rel(got, ref) < TOL


@pytest.mark.parametrize("strategy", ["sequential", "redblack"])
def test_fmg_guess_matches(rect, strategy):
    j, t = _pair(rect, strategy)
    rhs = np.array(rect.levels[-1].rhs)
    assert _rel(t.fmg_guess(torch.as_tensor(rhs)), j.fmg_guess(jnp.asarray(rhs))) < TOL


@pytest.mark.parametrize("strategy, fmg", [("sequential", False), ("redblack", False),
                                           ("redblack", True)])
def test_solve_history_matches(rect, strategy, fmg):
    j, t = _pair(rect, strategy, fmg=fmg)
    rhs = np.array(rect.levels[-1].rhs)
    ju, jres, jn, jhist = j.solve(jnp.asarray(rhs))
    u, res, n, hist = t.solve(torch.as_tensor(rhs))
    assert n == int(jn)
    ref = [float(r) for r in np.asarray(jhist) if np.isfinite(r)]
    assert len(hist) == len(ref) == n + 1
    assert np.allclose(hist, ref, rtol=1e-8, atol=0)
    assert res == hist[-1] < float(rect.settings.solver.multigrid.tolerance)
    if not fmg:
        assert hist[0] == 1.0
    assert _rel(u, ju) < 1e-10


def test_solve_stops_at_max_cycles_and_on_divergence(rect):
    _, t = _pair(rect)
    rhs = torch.as_tensor(np.array(rect.levels[-1].rhs))
    _, res, n, hist = t.solve(rhs, tol=1e-30, max_cycles=2)
    assert n == 2 and len(hist) == 3 and res == hist[-1]
    # a smoother that blows up: the loop ends on the non-finite residual
    for pair in t._smoother_cfg.values():
        for cfg in pair:
            cfg.name, cfg.omega = "jacobi", float("inf")
    _, res, n, hist = t.solve(rhs, max_cycles=5)
    assert n == 1 and not np.isfinite(res)


def test_distributive_gs_names_its_roadmap_item(rect):
    """Distributive GS smooths from the Stokes GridLevels' own state: without
    ``levels`` dgtpu's MultigridSolver and the port's raise the same
    ValueError (the test keeps the name it had while the port raised
    NotImplementedError here).  The cycle type is validated."""
    for port_only in (False, True):     # dgtpu's constructor first, then the port's
        with pytest.raises(ValueError, match="distributive GS smoothing needs GridLevels"):
            _pair(rect, smoother="distributive_Gauss_Seidel", port_only=port_only)
    s = copy.deepcopy(rect.settings)
    s.solver.multigrid.cycle_type = "X"
    j, t = _pair(rect)
    with pytest.raises(ValueError, match="V, W or F"):
        MultigridSolver(t.ops, t.transfers, t.types, s)


def test_smoother_config_from_settings(rect):
    node = rect.settings.solver.multigrid.polynomial_coarsening.pre_smoother
    cfg = SmootherConfig.from_settings(node)
    assert (cfg.name, cfg.direction, cfg.iterations, cfg.omega, cfg.eig_ratio) == \
        (str(node.smoother).lower(), node.direction, int(node.iterations),
         float(node.relaxation_factor), None)


def test_direct_solve_and_lu(rect):
    _, t = _pair(rect)
    lvl = rect.levels[-1]
    rhs = np.array(lvl.rhs)
    ref = jdirect.solve_direct(lvl.op, jnp.asarray(rhs))
    got = direct.solve_direct(t.ops[-1], torch.as_tensor(rhs))
    assert _rel(got, ref) < 1e-11
    lu = direct.lu_factor_dense(t.ops[-1])
    assert _rel(direct.lu_solve(lu, torch.as_tensor(rhs)), ref) < 1e-11


@pytest.mark.parametrize("name, strategy", [
    ("block_gauss_seidel", "sequential"), ("block_gauss_seidel", "redblack"),
    ("block_jacobi", "sequential")])
def test_residual_tracked_smoother_matches(rect, name, strategy):
    _, t = _pair(rect)
    lvl = rect.levels[-1]
    rhs = np.array(lvl.rhs)
    kw = dict(name=name, direction="symmetric", max_iterations=400, omega=0.9,
              strategy=strategy)
    ju, jhist, jn, jstatus = jrelax.residual_tracked_smoother(
        lvl.op, jnp.asarray(rhs), colors=jcolors(lvl.Ni, lvl.Nj), **kw)
    u, hist, n, status = relaxation_driver.residual_tracked_smoother(
        t.ops[-1], torch.as_tensor(rhs), colors=element_colors(lvl.Ni, lvl.Nj), **kw)
    assert (n, status) == (int(jn), int(jstatus)) == (n, 0)
    ref = [float(r) for r in np.asarray(jhist) if np.isfinite(r)]
    assert np.allclose(hist, ref, rtol=1e-8, atol=0)
    assert _rel(u, ju) < 1e-10


def test_relaxation_status_codes(rect):
    _, t = _pair(rect)
    op = t.ops[-1]
    rhs = torch.as_tensor(np.array(rect.levels[-1].rhs))
    _, hist, n, status = relaxation_driver.residual_tracked_smoother(
        op, rhs, max_iterations=3)
    assert (n, status, len(hist)) == (3, 1, 3)
    # over-relaxed Jacobi diverges: past 1e10, then status 2
    _, hist, n, status = relaxation_driver.residual_tracked_smoother(
        op, rhs, name="jacobi", omega=50.0, max_iterations=100)
    assert status == 2 and n < 100 and hist[-1] > 1e10
    _, hist, n, status = relaxation_driver.residual_tracked_smoother(
        op, rhs, name="jacobi", omega=float("nan"), max_iterations=100)
    assert (n, status) == (1, 2)


@pytest.mark.parametrize("name", ["block_gauss_seidel", "chebyshev"])
def test_fixed_sweeps_smoother(rect, name):
    _, t = _pair(rect)
    lvl = rect.levels[-1]
    rhs = np.array(lvl.rhs)
    ref = jrelax.fixed_sweeps_smoother(lvl.op, jnp.asarray(rhs), name=name, iterations=3)
    got = relaxation_driver.fixed_sweeps_smoother(t.ops[-1], torch.as_tensor(rhs),
                                                  name=name, iterations=3)
    # Chebyshev: the two power iterations start from different vectors
    assert _rel(got, ref) < (TOL if name != "chebyshev" else 0.05)
