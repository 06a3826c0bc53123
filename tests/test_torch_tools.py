"""dgtpu_torch's plots, studies and ``--profile`` against dgtpu's.

Each plot function of ``dgtpu_torch/visualization.py`` and its dgtpu
counterpart draw the same inputs: the same file name in the same ``outdir``,
and the same plotted numbers (every line's x and y data, every surface's
vertices) within 1e-12 relative.  The three studies against dgtpu's on the
same sweeps: results within 1e-10 relative (spectral radii 1e-8), the same
files.  ``--profile DIR`` writes a ``torch.profiler`` Chrome trace on the
CPU.
"""

import json
import os

import matplotlib
import numpy as np
import pytest
import torch

from dgtpu import studies as jstudies
from dgtpu import visualization as jviz

import dgtpu_torch.api as tapi
from dgtpu_torch import studies as tstudies
from dgtpu_torch import visualization as tviz
from dgtpu_torch.__main__ import main
from dgtpu_torch.convert import stencil_from_arrays

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

torch.set_num_threads(1)

PLOT_REL_TOL = 1e-12


def _numbers(fig):
    """The plotted numbers of a figure: per axes, each line's x and y data
    and each collection's 2D offsets or 3D vertices."""
    out = []
    for ax in fig.axes:
        for line in ax.get_lines():
            out.append(np.asarray(line.get_xdata(), dtype=float))
            out.append(np.asarray(line.get_ydata(), dtype=float))
        for coll in ax.collections:
            vec = getattr(coll, "_vec", None)
            out.append(np.asarray(vec if vec is not None else coll.get_offsets(),
                                  dtype=float))
    return out


@pytest.fixture
def drawn(monkeypatch):
    """The figures closed by the plot functions, in order."""
    figures = []
    close = plt.close

    def keep(fig=None):
        figures.append(fig)
        close(fig)
    monkeypatch.setattr(plt, "close", keep)
    return figures


def _operators():
    """dgtpu's 2x2 p=1 Poisson operator and the port's copy of it."""
    from dgtpu.geometry import Geometry
    from dgtpu.level import GridLevel
    from dgtpu.models.poisson import assemble_poisson
    from dgtpu.settings import Settings, load_params
    from tests.conftest import INPUT_DIR
    s = Settings(load_params())
    s.update_setting("grid.polynomial_degree", 1)
    lvl = GridLevel(Geometry(os.path.join(INPUT_DIR, "Rectangle_2X2_nPoly1.xyz"), s), s,
                    ["u"], {"u": 1})
    op, _, _ = assemble_poisson(lvl)
    return op, stencil_from_arrays(dict(blocks=np.asarray(op.blocks),
                                        nbr=np.asarray(op.nbr), mask=np.asarray(op.mask)))


RESULTS = {1: [(2, 0.4), (4, 0.13), (8, 0.027)], 2: [(2, 0.05), (4, 0.006), (8, 0.0008)]}
PLOTS = {
    "plot_sparsity_pattern": None,              # the operators, built in the test
    "draw_loglog_slope": None,                  # on an axes, drawn in the test
    "plot_grid_convergence": ((RESULTS,), {"name": "convergence"}),
    "plot_residual_history": (([np.logspace(0, -8, 9), np.logspace(0, -10, 6)],),
                              {"labels": ["a", "b"]}),
    "plot_standard_element": ((3,), {}),
    "plot_lebesgue": ((5,), {}),
    "plot_runge": ((8,), {}),
    "plot_basis_1d": ((4,), {}),
    "plot_basis_nodal_1d": ((4,), {}),
    "plot_basis_2d": ((1,), {}),
    "plot_lebesgue_constant": ((7,), {}),
    "plot_spectral_radius": ((RESULTS,), {}),
}


@pytest.mark.parametrize("name", list(PLOTS))
def test_plot_matches_dgtpu(tmp_path, drawn, name):
    """The port's plot draws dgtpu's numbers into dgtpu's file name."""
    if name == "draw_loglog_slope":
        figs = []
        for viz in (jviz, tviz):
            fig, ax = plt.subplots()
            viz.draw_loglog_slope(ax, (8.0, 0.02), 1.6, -3.0)
            viz.draw_loglog_slope(ax, (4.0, 0.1), 2.0, -2.0, inverted=True, color="r")
            figs.append(fig)
            plt.close(fig)
        files = [None, None]
    else:
        if name == "plot_sparsity_pattern":
            j_op, t_op = _operators()
            args = ((j_op,), (t_op,))
            kw = {}
        else:
            args, kw = (PLOTS[name][0],) * 2, PLOTS[name][1]
        files = [getattr(viz, name)(*a, outdir=str(tmp_path / pkg), **kw)
                 for viz, a, pkg in ((jviz, args[0], "dgtpu"), (tviz, args[1], "port"))]
        figs = drawn[-2:]
        assert [os.path.relpath(f, tmp_path / pkg) for f, pkg in
                zip(files, ("dgtpu", "port"))] == [os.path.basename(files[0])] * 2
        assert all(os.path.getsize(f) > 0 for f in files)
    got, ref = _numbers(figs[1]), _numbers(figs[0])
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= PLOT_REL_TOL * max(np.abs(r).max(), 1e-300)
    assert [a.get_title() for a in figs[1].axes] == [a.get_title() for a in figs[0].axes]


def test_convergence_study_matches_dgtpu(tmp_path):
    """dgtpu's own study case (grids 2/4/8, p 1/2): the same L2 errors and
    rates within 1e-10 relative, the rates above dgtpu's bar p + 1 - 0.4,
    the same files."""
    kw = dict(grid_sizes=(2, 4, 8), degrees=(1, 2), p_grid=1,
              exact={"u": "sin(pi*x)*sin(pi*y)", "tag": "MMS"})
    ref, ref_rates = jstudies.run_convergence_study(outdir=str(tmp_path / "dgtpu"), **kw)
    got, rates = tstudies.run_convergence_study(outdir=str(tmp_path / "port"),
                                                device="cpu", **kw)
    for p in (1, 2):
        assert [n for n, _ in got[p]] == [n for n, _ in ref[p]]
        assert np.allclose([e for _, e in got[p]], [e for _, e in ref[p]],
                           rtol=1e-10, atol=0)
        assert np.allclose(rates[p], ref_rates[p], rtol=1e-10, atol=0)
        assert rates[p][-1] > p + 1 - 0.4
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "dgtpu"))
    data = json.load(open(tmp_path / "port" / "Poisson_convergence.json"))
    assert len(data["details"]) == 6


def test_spectral_radius_study_matches_dgtpu(tmp_path):
    """rho(B) over grids 2/4 and p 1/2: within 1e-8 of dgtpu's, the same
    files."""
    kw = dict(grid_sizes=(2, 4), degrees=(1, 2))
    ref = jstudies.run_spectral_radius_study(outdir=str(tmp_path / "dgtpu"), **kw)
    got = tstudies.run_spectral_radius_study(outdir=str(tmp_path / "port"), device="cpu",
                                             **kw)
    for p in (1, 2):
        assert [n for n, _ in got[p]] == [n for n, _ in ref[p]]
        assert np.allclose([r for _, r in got[p]], [r for _, r in ref[p]],
                           rtol=1e-8, atol=0)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "dgtpu"))


def test_figure_suite_matches_dgtpu(tmp_path, drawn):
    """The seven figures: dgtpu's file names, the same plotted numbers."""
    ref = jstudies.run_figure_suite(p=2, outdir=str(tmp_path / "dgtpu"))
    n = len(drawn)
    got = tstudies.run_figure_suite(p=2, outdir=str(tmp_path / "port"))
    assert [os.path.basename(f) for f in got] == [os.path.basename(f) for f in ref]
    assert len(got) == 7 and all(os.path.getsize(f) > 0 for f in got)
    for fj, ft in zip(drawn[:n], drawn[n:]):
        for g, r in zip(_numbers(ft), _numbers(fj)):
            assert np.abs(g - r).max() <= PLOT_REL_TOL * max(np.abs(r).max(), 1e-300)


def test_profile_writes_trace(tmp_path, monkeypatch):
    """``--profile DIR`` on the CPU writes a Chrome trace of the solve."""
    monkeypatch.setattr(tapi, "OUTPUT_ROOT", str(tmp_path))
    out = tmp_path / "profile"
    dg = main(["-m", "--precision", "mixed", "--device", "cpu", "--silent",
               "-f", "Rectangle_2X2_nPoly1.xyz", "--p-grid", "1", "--p-solution", "1",
               "--profile", str(out)])
    assert dg.solve_residual < 1e-10
    trace = json.load(open(out / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)
