"""The port's smoother amplification analysis (``-amp``) against dgtpu's, on
the CPU: the amplitudes A1-A4 after one symmetric block-GS sweep over the
Fourier modes, for the DG discretization (4x4 p=2, modes sampled at the
solution nodes) and the FVM one (8x8 p_grid 1, p_solution 0), and the CLI
cases of dgtpu's tests (``-amp --fvm-discretization`` with the analysis
file and its plots; ``-amp --dg-discretization`` at p=6, the reference's
setting).

Bars: A1-A4 within 1e-12 of dgtpu's on the same level.
"""

import os

import numpy as np
import pytest
import torch

from dgtpu.geometry import Geometry as JGeometry
from dgtpu.geometry import generate_rectangle_grid, write_plot3d
from dgtpu.level import GridLevel as JGridLevel
from dgtpu.mms import ManufacturedSolution as JMMS
from dgtpu.models.fvm import assemble_poisson_fvm as j_assemble_fvm
from dgtpu.models.poisson import assemble_poisson as j_assemble_poisson
from dgtpu.settings import Settings as JSettings
from dgtpu.solvers.amplification import calculate_amplification as j_amplification

import chip_smoke
import dgtpu_torch.api as tapi
from dgtpu_torch.__main__ import main
from dgtpu_torch.geometry import Geometry
from dgtpu_torch.level import GridLevel
from dgtpu_torch.mms import ManufacturedSolution
from dgtpu_torch.models.fvm import assemble_poisson_fvm
from dgtpu_torch.models.poisson import assemble_poisson
from dgtpu_torch.settings import Settings, load_params
from dgtpu_torch.solvers.amplification import calculate_amplification
from tests.conftest import INPUT_DIR

torch.set_num_threads(1)
U = "sin(pi*x)*sin(pi*y)"


def _levels(grid, p_grid, p_sol, discretization):
    """(dgtpu level, port level) on ``grid``, assembled."""
    params = load_params()
    params["grid"]["polynomial degree"] = p_grid
    params["logging"]["loglevel"] = "ERROR"
    js, ts = JSettings(params), Settings(params)
    path = os.path.join(INPUT_DIR, grid)
    jl = JGridLevel(JGeometry(path, js), js, ["u"], {"u": p_sol},
                    discretization=discretization)
    tl = GridLevel(Geometry(path, ts), ts, ["u"], {"u": p_sol},
                   discretization=discretization)
    jm, tm = JMMS({"u": U}, "Poisson", 1.0), ManufacturedSolution({"u": U}, "Poisson", 1.0)
    if discretization == "fvm":
        jl.op, jl.rhs = j_assemble_fvm(jl, jm)
        tl.op, tl.rhs = assemble_poisson_fvm(tl, tm)
    else:
        jl.op, jl.rhs, _ = j_assemble_poisson(jl, jm)
        tl.op, tl.rhs, _ = assemble_poisson(tl, tm)
    return jl, tl


@pytest.mark.parametrize("grid, p_grid, p_sol, discretization", [
    ("Rectangle_4X4_nPoly2.xyz", 2, 2, "dg"),
    ("Rectangle_4X4_nPoly1.xyz", 1, 2, "dg"),     # P_sol != P_grid: nodes interpolated
    ("Rectangle_8X8_nPoly1.xyz", 1, 0, "fvm")])
def test_amplification_matches_dgtpu(grid, p_grid, p_sol, discretization):
    jl, tl = _levels(grid, p_grid, p_sol, discretization)
    ref = j_amplification(jl, "unused", n_theta=11, export=False)
    out = calculate_amplification(tl, "unused", n_theta=11, export=False)
    assert np.array_equal(out["theta"], ref["theta"])
    for q in range(1, 5):
        A = out[f"A{q}"]
        assert A.shape == (11, 11)
        assert np.abs(A - ref[f"A{q}"]).max() < 1e-12
        # GS contracts the SPD operators
        assert 0.0 <= A.min() and A.max() <= 1.05


def test_fvm_amplification_cli(tmp_path, monkeypatch):
    """dgtpu's case ``-amp --fvm-discretization`` on 8x8 p_grid 1 with
    p_solution 0, through the port's CLI: the 101x101 analysis file beside
    the summary, the min and max of A1-A4 within 1e-12 of dgtpu's CLI run
    (``chip_smoke.DGTPU_AMP``, with the command that computed them), and
    the plots."""
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    dg = main(["-amp", "--fvm-discretization", "-f", "Rectangle_8X8_nPoly1.xyz",
               "--p-grid", "1", "--p-solution", "0", "--silent", "--device", "cpu"])
    assert dg.results_dir.startswith(str(tmp_path))
    out = np.load(os.path.join(dg.results_dir, "amplification.npz"))
    for q in range(1, 5):
        A = out[f"A{q}"]
        assert A.shape == (101, 101)
        assert 0.0 <= A.min() and A.max() <= 1.0  # GS contracts the FVM stencil
        ref_min, ref_max = chip_smoke.DGTPU_AMP["fvm"][q]
        assert abs(A.min() - ref_min) < 1e-12 and abs(A.max() - ref_max) < 1e-12
    pytest.importorskip("matplotlib")
    for name in ("amplification_0.png", "amplification_quadrants.png"):
        assert os.path.exists(os.path.join(dg.results_dir, name))


def test_dg_amplification_cli(tmp_path, monkeypatch):
    """``-amp --dg-discretization`` at P_grid = P_sol = 6, the reference's
    setting (settings.py:24-29), runs through the port's CLI (the plots,
    drawn as in the FVM case above, are left out)."""
    import dgtpu_torch.visualization as vis
    path = os.path.join(INPUT_DIR, "Rectangle_4X4_nPoly6.xyz")
    if not os.path.exists(path):
        write_plot3d(path, *generate_rectangle_grid(4, 4, 6))
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    for name in ("plot_amplification_factor", "plot_amplification_quadrants"):
        monkeypatch.setattr(vis, name, lambda *a, **k: None)
    dg = main(["-amp", "--dg-discretization", "-f", "Rectangle_4X4_nPoly6.xyz",
               "--p-grid", "6", "--p-solution", "6", "--silent", "--device", "cpu"])
    out = np.load(os.path.join(dg.results_dir, "amplification.npz"))
    for q in range(1, 5):
        assert out[f"A{q}"].shape == (101, 101)
        assert 0.0 <= out[f"A{q}"].min() and out[f"A{q}"].max() <= 1.05
