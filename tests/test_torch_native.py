"""The port's host C++ relaxation kernels (``dgtpu_torch/native``) against
dgtpu, on the CPU: dgtpu's three ``test_native.py`` cases (matvec, two
symmetric block-GS sweeps, three damped block-Jacobi sweeps) on dgtpu's
assembled 4x4 system, carried across with ``convert.stencil_from_arrays``.
The port's ``NativeStencil`` is held against dgtpu's own ``NativeStencil``,
against dgtpu's jnp matvec / block GS / block Jacobi, and against the port's
plain torch ops, so a fault of the loader (argument order, dtypes, the
inverse diagonal it passes, the direction flag) shows against the
reference.  The GS case also runs one forward and one damped backward
sweep.  Last, the build's placement and its failure message.

Bars: dgtpu's (1e-12 relative for the matvec, 1e-11 for the sweeps).
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgtpu import native as jnative
from dgtpu.geometry import Geometry as JGeometry
from dgtpu.level import GridLevel as JGridLevel
from dgtpu.mms import ManufacturedSolution as JMMS
from dgtpu.models.poisson import assemble_poisson as j_assemble_poisson
from dgtpu.ops import smoothers as jsmoothers
from dgtpu.settings import Settings as JSettings
from dgtpu.settings import load_params as j_load_params

from dgtpu_torch import native
from dgtpu_torch.convert import stencil_from_arrays
from dgtpu_torch.ops import smoothers
from dgtpu_torch.ops._kernels import BUILD_DIR
from tests.conftest import INPUT_DIR

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ not found: the native kernels are host C++")
torch.set_num_threads(1)
REFS = ("dgtpu_native", "dgtpu_jnp", "torch")


@pytest.fixture(scope="module")
def system():
    """dgtpu's operator and rhs (jax) and the port's copy of the operator."""
    s = JSettings(j_load_params())
    s.update_setting("logging.loglevel", "WARNING")
    s.update_setting("grid.polynomial_degree", 1)
    geom = JGeometry(os.path.join(INPUT_DIR, "Rectangle_4X4_nPoly1.xyz"), s)
    lvl = JGridLevel(geom, s, ["u"], {"u": 2})
    mms = JMMS({"u": "sin(pi*x)*sin(pi*y)"}, "Poisson", 1.0)
    jop, jrhs, _ = j_assemble_poisson(lvl, mms)
    op = stencil_from_arrays(dict(blocks=np.asarray(jop.blocks), nbr=np.asarray(jop.nbr),
                                  mask=np.asarray(jop.mask)))
    return jop, jrhs, op, np.array(jrhs)


def _dgtpu_native(jop):
    if jnative.load() is None:
        pytest.skip("dgtpu's native library did not build")
    return jnative.NativeStencil(jop)


def _matvec_ref(ref, system, x):
    jop, _, op, _ = system
    if ref == "dgtpu_native":
        return _dgtpu_native(jop).matvec(x)
    if ref == "dgtpu_jnp":
        return np.asarray(jop.matvec(jnp.asarray(x)))
    return op.matvec(torch.as_tensor(x)).numpy()


def _gs_ref(ref, system, x0, direction, iterations, omega):
    jop, jrhs, op, rhs = system
    if ref == "dgtpu_native":
        return _dgtpu_native(jop).gauss_seidel(rhs, x0, direction, iterations=iterations,
                                               omega=omega)
    if ref == "dgtpu_jnp":
        return np.asarray(jsmoothers.block_gauss_seidel(
            jop, jrhs, jnp.asarray(x0), direction=direction, omega=omega,
            iterations=iterations))
    return smoothers.block_gauss_seidel(op, torch.as_tensor(rhs), torch.as_tensor(x0),
                                        direction=direction, omega=omega,
                                        iterations=iterations).numpy()


def _jacobi_ref(ref, system, x0, iterations, omega):
    jop, jrhs, op, rhs = system
    if ref == "dgtpu_native":
        return _dgtpu_native(jop).jacobi(rhs, x0, iterations=iterations, omega=omega)
    if ref == "dgtpu_jnp":
        return np.asarray(jsmoothers.block_jacobi(jop, jrhs, jnp.asarray(x0), omega=omega,
                                                  iterations=iterations))
    return smoothers.block_jacobi(op, torch.as_tensor(rhs), torch.as_tensor(x0),
                                  omega=omega, iterations=iterations).numpy()


@pytest.mark.parametrize("ref", REFS)
def test_native_matvec(system, ref):
    op = system[2]
    x = np.random.default_rng(0).standard_normal(op.shape[1])
    expect = _matvec_ref(ref, system, x)
    got = native.NativeStencil(op).matvec(x)
    assert np.abs(got - expect).max() < 1e-12 * np.abs(expect).max()


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("direction, iterations, omega",
                         [("symmetric", 2, 1.0), ("forward", 1, 1.0),
                          ("backward", 1, 0.9)])
def test_native_gs_matches_scan(system, ref, direction, iterations, omega):
    op, rhs = system[2], system[3]
    x0 = np.random.default_rng(1).standard_normal(op.shape[1])
    expect = _gs_ref(ref, system, x0, direction, iterations, omega)
    got = native.NativeStencil(op).gauss_seidel(rhs, x0, direction, iterations=iterations,
                                                omega=omega)
    assert np.abs(got - expect).max() < 1e-11


@pytest.mark.parametrize("ref", REFS)
def test_native_jacobi_matches_batched(system, ref):
    op, rhs = system[2], system[3]
    x0 = np.zeros(op.shape[1])
    expect = _jacobi_ref(ref, system, x0, 3, 0.8)
    got = native.NativeStencil(op).jacobi(rhs, x0, iterations=3, omega=0.8)
    assert np.abs(got - expect).max() < 1e-11


def test_build_lands_in_the_build_directory(monkeypatch, tmp_path):
    """The library is built into ``build/dgtpu_torch/`` (not beside the
    source), and a failed compile raises with g++'s message."""
    assert os.path.dirname(native.build()) == BUILD_DIR
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed \(1\):\n.*error: "):
        native.build()
