"""ctypes loader for the host C++ relaxation kernels of ``relaxation.cpp``
(port of ``dgtpu/native/__init__.py``).

The source is compiled with ``g++`` at first use (never at import) into
``build/dgtpu_torch/``, cached by the hash of the source and the flags, as
``ops/_kernels.py`` caches the CUDA kernels.  A failed build raises with
g++'s stderr (dgtpu's ``load()`` returns None instead).  ``NativeStencil``
runs the matvec and the block Gauss-Seidel and Jacobi sweeps on the host,
in float64, over a ``StencilOperator`` moved there.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

from dgtpu_torch.ops._kernels import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "relaxation.cpp")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def build():
    """Compile ``relaxation.cpp`` unless it is built already; returns the
    shared library's path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(" ".join(FLAGS).encode() + f.read()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"librelax_{digest}.so")
    if os.path.exists(lib):
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native relaxation kernels need a "
                           "host C++ compiler")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *FLAGS, SOURCE, "-o", tmp], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load():
    """The loaded library (built on first call)."""
    lib = ctypes.CDLL(build())
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int32)
    up = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    lib.stencil_matvec.argtypes = [dp, ip, up, i64, i64, dp, dp]
    lib.block_gauss_seidel_sweep.argtypes = [dp, ip, up, dp, i64, i64, dp, dp,
                                             ctypes.c_int, ctypes.c_double]
    lib.block_jacobi_sweep.argtypes = [dp, ip, up, dp, i64, i64, dp, dp,
                                       ctypes.c_double]
    for fn in (lib.stencil_matvec, lib.block_gauss_seidel_sweep, lib.block_jacobi_sweep):
        fn.restype = None
    return lib


def _host(arr, dtype):
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return np.ascontiguousarray(arr, dtype=dtype)


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativeStencil:
    """Host kernels over a StencilOperator's arrays (copied to the host in
    float64 / int32 / uint8).  Vectors in and out are host numpy arrays;
    torch tensors are accepted and copied to the host."""

    def __init__(self, op):
        self.lib = load()
        self.blocks = _host(op.blocks, np.float64)
        self.nbr = _host(op.nbr, np.int32)
        self.mask = _host(op.mask, np.uint8)
        self.n, _, self.b, _ = self.blocks.shape
        self.dinv = np.ascontiguousarray(np.linalg.inv(self.blocks[:, 0]))

    def _stencil(self):
        return (_ptr(self.blocks, ctypes.c_double), _ptr(self.nbr, ctypes.c_int32),
                _ptr(self.mask, ctypes.c_uint8))

    def matvec(self, x):
        x = _host(x, np.float64)
        y = np.empty_like(x)
        self.lib.stencil_matvec(*self._stencil(), self.n, self.b,
                                _ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double))
        return y

    def gauss_seidel(self, rhs, x, direction="symmetric", iterations=1, omega=1.0):
        rhs = _host(rhs, np.float64)
        x = _host(x, np.float64).copy()
        passes = {"forward": (0,), "backward": (1,), "symmetric": (0, 1)}[direction]
        for _ in range(int(iterations)):
            for backward in passes:
                self.lib.block_gauss_seidel_sweep(
                    *self._stencil(), _ptr(self.dinv, ctypes.c_double), self.n, self.b,
                    _ptr(rhs, ctypes.c_double), _ptr(x, ctypes.c_double), backward,
                    omega)
        return x

    def jacobi(self, rhs, x, iterations=1, omega=1.0):
        rhs = _host(rhs, np.float64)
        x = _host(x, np.float64).copy()
        for _ in range(int(iterations)):
            self.lib.block_jacobi_sweep(
                *self._stencil(), _ptr(self.dinv, ctypes.c_double), self.n, self.b,
                _ptr(rhs, ctypes.c_double), _ptr(x, ctypes.c_double), omega)
        return x
