"""The port's opt-in operator checks (``problem.check ...``) against dgtpu's,
on the CPU: the settings of dgtpu's ``test_diagnostics_flags``, all six
switches on Poisson, the global-order Stokes checks (continuity
consistency, its rank test on a nonzero Epsilon), the CLI switches, and
the host helpers ``residual_norm`` and ``compute_row_echelon``.

Bars: the same keys; floats within 1e-8 relative (Epsilon, a roundoff
number on a divergence-free solution, within 1e-13 absolute); booleans and
ranks equal.
"""

import logging

import numpy as np
import pytest
import torch
import yaml

from dgtpu.api import DGFEM as JDGFEM
from dgtpu.diagnostics import run_diagnostics as j_run_diagnostics
from dgtpu.settings import Settings as JSettings
from dgtpu.utils.norms import compute_row_echelon as j_row_echelon
from dgtpu.utils.norms import residual_norm as j_residual_norm

import chip_smoke
import dgtpu_torch.api as tapi
from dgtpu_torch.__main__ import main
from dgtpu_torch.diagnostics import run_diagnostics
from dgtpu_torch.settings import Settings, load_params
from dgtpu_torch.utils.norms import compute_row_echelon, residual_norm

torch.set_num_threads(1)
ALL = ("check eigenvalues", "check condition number", "check characteristics",
       "check orthonormality", "check iteration matrix", "check consistency")


def _poisson(flags, **over):
    """dgtpu's make_settings (tests/test_aux_subsystems.py): 4x4 p_grid 1,
    p_sol 2, direct."""
    params = load_params()
    params["grid"]["filename"] = "Rectangle_4X4_nPoly1.xyz"
    params["grid"]["polynomial degree"] = 1
    params["solution"]["u"]["polynomial degree"] = 2
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    for f in flags:
        params["problem"][f] = True
    params["problem"].update(over)
    return params


def _stokes(flags, ordering):
    params = chip_smoke.stokes_params(4)
    params["performance"]["precision"] = "full"
    params["solution"]["ordering"] = ordering
    for f in flags:
        params["problem"][f] = True
    return params


def _both(tmp, params):
    ref = JDGFEM(settings=JSettings(yaml.safe_load(yaml.safe_dump(params))),
                 solve_direct=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "OUTPUT_ROOT", str(tmp))
        port = tapi.DGFEM(device="cpu", settings=Settings(params), solve_direct=True)
    return ref, port


def _same(port, ref):
    assert port.keys() == ref.keys() != set()
    for key, value in ref.items():
        if isinstance(value, (bool, int, np.bool_)):
            assert port[key] == value, key
        elif key == "Epsilon":
            assert abs(port[key] - value) < 1e-13
        else:
            assert port[key] == pytest.approx(value, rel=1e-8), key


@pytest.mark.parametrize("params", [
    # dgtpu's test_diagnostics_flags
    _poisson(ALL[:3] + ALL[4:5], **{"multiply inverse mass matrix": False}),
    _poisson(ALL),
], ids=["dgtpu_case", "poisson_all"])
def test_diagnostics_match_dgtpu(tmp_path, params):
    ref, port = _both(tmp_path, params)
    _same(port.diagnostics, ref.diagnostics)
    assert port.diagnostics["spd"] is True
    assert 0 < port.diagnostics["rho_gs"] < 1   # GS converges on the SPD operator
    assert np.real(port.diagnostics["min_eig"]) > 0


def test_stokes_consistency_and_ranks(tmp_path):
    """Global-order Stokes with the consistency check: dgtpu's numbers; then
    the rank test of the continuity system, which runs where Epsilon is not
    zero: set on both levels, the ranks of D A^-1 G and of its augmented
    matrix are dgtpu's.  (Stokes in local order with the iteration matrix:
    ``chip_smoke.py`` phase 23.)"""
    ref, port = _both(tmp_path, _stokes(ALL[:3] + ALL[5:], "global"))
    _same(port.diagnostics, ref.diagnostics)
    for dg, run in ((ref, j_run_diagnostics), (port, run_diagnostics)):
        dg.levels[-1].Epsilon = 1e-3
        run(dg, dg.levels[-1])
    assert {"rank", "rank_aug"} <= port.diagnostics.keys()
    _same(port.diagnostics, ref.diagnostics)


def test_cli_check_switches(tmp_path, monkeypatch):
    """dgtpu's CLI case: ``-d --check-eigenvalues --check-condition-number``."""
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    dg = main(["-d", "-f", "Rectangle_4X4_nPoly1.xyz", "--p-grid", "1", "--p-solution",
               "1", "--check-eigenvalues", "--check-condition-number", "--silent",
               "--device", "cpu"])
    assert {"cond", "min_eig", "max_eig"} == dg.diagnostics.keys()
    assert dg.L2_error_u < 1.0


def test_no_switch_no_diagnostics(tmp_path, monkeypatch):
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    dg = tapi.DGFEM(device="cpu", settings=Settings(_poisson(())), solve_direct=True)
    assert not hasattr(dg, "diagnostics")
    logger = logging.getLogger("unused")
    assert run_diagnostics(type("D", (), {"settings": dg.settings, "logger": logger})(),
                           dg.levels[-1]) == {}


def test_row_echelon_and_residual_norm():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((6, 9))
    A[3] = A[1] + 2 * A[2]             # rank 5
    A[:, 4] = 0.0
    assert np.abs(compute_row_echelon(A) - np.asarray(j_row_echelon(A))).max() < 1e-12

    class Dense:
        def __init__(self, M):
            self.M = M

        def matvec(self, u):
            return self.M @ u

    M, u, b = rng.standard_normal((5, 5)), rng.standard_normal(5), rng.standard_normal(5)
    port = float(residual_norm(Dense(torch.as_tensor(M)), torch.as_tensor(u),
                               torch.as_tensor(b)))
    assert port == pytest.approx(float(j_residual_norm(Dense(M), u, b)), rel=1e-14)
