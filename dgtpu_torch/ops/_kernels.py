"""Build, load and launch the CUDA kernels of ``csrc/soa_kernels.cu``: K1
half-sweep, K3 small GEMM, K4 geometric transfer and K5 stencil apply of
both cycles, and K6, the Stokes pressure half-sweep.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (never at import: the CPU tests import
every module), cached under ``build/dgtpu_torch/`` by the source's hash, and
loaded with ``ctypes``.  Each launcher checks device, dtype, shape and
contiguity, allocates its output with ``torch.empty``, launches on
PyTorch's current stream and raises if the launch reports a CUDA error.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "soa_kernels.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "dgtpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point -> argument types (the last one is the stream)
_SIGNATURES = {
    "soa_half_sweep": [_P] * 6 + [_I] * 6 + [_P],
    "soa_small_gemm": [_P] * 4 + [_I] * 5 + [_P],
    "soa_geo_transfer": [_P] * 4 + [_I] * 6 + [_P],
    "soa_stencil_apply": [_P] * 4 + [_I] * 5 + [_F, _I, _P],
    "soa_dg_half_sweep": [_P] * 8 + [_I] * 7 + [_P],
}
# K1/K5 stage 5*B*TC floats of shared memory per CTA (TC = 32 cells), K6
# (5*Bu + Np)*TC; the launches stay under the 48 KB a kernel gets without an
# opt-in attribute.
_TC = 32
_SMEM_FLOATS = 48 * 1024 // 4
_MAX_SMEM_B = _SMEM_FLOATS // (5 * _TC)


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build():
    """Compile the kernel source unless it is built already; returns the
    shared library's path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"libsoa_kernels_{digest}.so")
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.soa_error_string.argtypes = [ctypes.c_int]
    lib.soa_error_string.restype = ctypes.c_char_p
    return lib


def _check(*tensors):
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError("SoA kernels take CUDA tensors on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"SoA kernels are float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("SoA kernels take contiguous tensors")


def _launch(name, *args):
    lib = library()
    code = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {code} "
                           f"({lib.soa_error_string(code).decode()})")


def _base_ptr(base):
    return None if base is None else base.data_ptr()


def half_sweep(blocks, Dinv, rhs, u, color, nh, periodic, base=None):
    """K1; see ``ops.soa.half_sweep``."""
    _check(blocks, Dinv, rhs, u, *(() if base is None else (base,)))
    _, _, B, _, C = blocks.shape
    if blocks.shape != (2, 5, B, B, C) or Dinv.shape != (2, B, B, C) \
            or rhs.shape != (2, B, C) or u.shape != (2, B, C) \
            or (base is not None and base.shape != u.shape):
        raise ValueError("half_sweep: inconsistent SoA shapes")
    if B > _MAX_SMEM_B:
        raise ValueError(f"half_sweep: B={B} exceeds the kernel's shared-memory "
                         f"tile (B <= {_MAX_SMEM_B})")
    out = torch.empty_like(u)
    _launch("soa_half_sweep", blocks[color].data_ptr(), Dinv[color].data_ptr(),
            rhs[color].data_ptr(), u.data_ptr(), _base_ptr(base), out.data_ptr(),
            int(color), B, C, int(nh), int(periodic), int(base is not None))
    return out


def small_gemm(W, x, base=None):
    """K3; see ``ops.soa.small_gemm``."""
    _check(W, x, *(() if base is None else (base,)))
    M, K = W.shape
    if x.dim() != 3 or x.shape[1] != K:
        raise ValueError(f"small_gemm: W {tuple(W.shape)} vs x {tuple(x.shape)}")
    batch, _, N = x.shape
    if base is not None and base.shape != (batch, M, N):
        raise ValueError("small_gemm: base shape mismatch")
    out = torch.empty((batch, M, N), dtype=x.dtype, device=x.device)
    _launch("soa_small_gemm", W.data_ptr(), x.data_ptr(), _base_ptr(base),
            out.data_ptr(), M, K, N, batch, int(base is not None))
    return out


def geo_transfer(T4, x, dims_c, restrict, base=None):
    """K4; see ``ops.soa.geo_transfer``."""
    _check(T4, x, *(() if base is None else (base,)))
    njc, nic = dims_c
    _, Bout, Bin = T4.shape
    Cc, Cf = njc * (nic // 2), 4 * njc * (nic // 2)
    C_in, C_out = (Cf, Cc) if restrict else (Cc, Cf)
    if T4.shape[0] != 4 or x.shape != (2, Bin, C_in) or nic % 2:
        raise ValueError(f"geo_transfer: T4 {tuple(T4.shape)}, x {tuple(x.shape)}, "
                         f"coarse dims {dims_c}")
    if base is not None and (restrict or base.shape != (2, Bout, C_out)):
        raise ValueError("geo_transfer: base is the fine-level addend of a prolongation")
    out = torch.empty((2, Bout, C_out), dtype=x.dtype, device=x.device)
    _launch("soa_geo_transfer", T4.data_ptr(), x.data_ptr(), _base_ptr(base),
            out.data_ptr(), Bout, Bin, njc, nic, int(restrict), int(base is not None))
    return out


def stencil_apply(blocks, x, nh, periodic, base=None, sign=1.0):
    """K5; see ``ops.soa.stencil_apply``."""
    _check(blocks, x, *(() if base is None else (base,)))
    _, _, Bs, Bd, C = blocks.shape
    if blocks.shape != (2, 5, Bs, Bd, C) or x.shape != (2, Bs, C):
        raise ValueError(f"stencil_apply: blocks {tuple(blocks.shape)} vs x "
                         f"{tuple(x.shape)}")
    if base is not None and base.shape != (2, Bd, C):
        raise ValueError("stencil_apply: base shape mismatch")
    if Bs > _MAX_SMEM_B:
        raise ValueError(f"stencil_apply: B_src={Bs} exceeds the kernel's "
                         f"shared-memory tile (B_src <= {_MAX_SMEM_B})")
    out = torch.empty((2, Bd, C), dtype=x.dtype, device=x.device)
    _launch("soa_stencil_apply", blocks.data_ptr(), x.data_ptr(), _base_ptr(base),
            out.data_ptr(), Bs, Bd, C, int(nh), int(periodic), float(sign),
            int(base is not None))
    return out


def dg_half_sweep(D, DG_diag, DG_Dinv, rhs, p, g, color, nh, periodic, base=None):
    """K6; see ``ops.stokes_soa.dg_half_sweep``."""
    _check(D, DG_diag, DG_Dinv, rhs, p, g, *(() if base is None else (base,)))
    _, _, Bu, Np, C = D.shape
    if D.shape != (2, 5, Bu, Np, C) or DG_diag.shape != (2, Np, Np, C) \
            or DG_Dinv.shape != (2, Np, Np, C) or rhs.shape != (2, Np, C) \
            or p.shape != (2, Np, C) or g.shape != (2, Bu, C) \
            or (base is not None and base.shape != p.shape):
        raise ValueError("dg_half_sweep: inconsistent SoA shapes")
    if (5 * Bu + Np) * _TC > _SMEM_FLOATS:
        raise ValueError(f"dg_half_sweep: Bu={Bu}, Np={Np} exceed the kernel's "
                         "shared-memory tile")
    out = torch.empty_like(p)
    _launch("soa_dg_half_sweep", D[color].data_ptr(), DG_diag[color].data_ptr(),
            DG_Dinv[color].data_ptr(), rhs[color].data_ptr(), g.data_ptr(),
            p.data_ptr(), _base_ptr(base), out.data_ptr(), int(color), Bu, Np, C,
            int(nh), int(periodic), int(base is not None))
    return out
