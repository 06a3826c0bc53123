"""Build, load and launch the CUDA kernels of ``csrc/soa_kernels.cu``.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (never at import: the CPU tests import
every module), cached under ``build/dgtpu_torch/`` by the source's hash, and
loaded with ``ctypes``.  Each launcher checks device, dtype, shape and
contiguity, allocates its output with ``torch.empty``, launches on PyTorch's
current stream and raises if the launch reports a CUDA error.
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

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "soa_half_sweep": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "soa_residual": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "soa_small_gemm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "soa_geo_transfer": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}
# K1/K2 stage 5*B*TC floats of shared memory per CTA (TC = 32 cells); the
# launches stay under the 48 KB a kernel gets without an opt-in attribute.
_MAX_SMEM_B = 48 * 1024 // (5 * 32 * 4)


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
    """Compile the kernels (if this source is not built yet); returns the
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
    stream = torch.cuda.current_stream().cuda_stream
    code = getattr(lib, name)(*args, stream)
    if code != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {code} "
                           f"({lib.soa_error_string(code).decode()})")


def half_sweep(blocks, Dinv, rhs, u, color, nh, periodic):
    """K1; see ``ops.soa.half_sweep``."""
    _check(blocks, Dinv, rhs, u)
    _, _, B, _, C = blocks.shape
    if blocks.shape != (2, 5, B, B, C) or Dinv.shape != (2, B, B, C) \
            or rhs.shape != (2, B, C) or u.shape != (2, B, C):
        raise ValueError("half_sweep: inconsistent SoA shapes")
    if B > _MAX_SMEM_B:
        raise ValueError(f"half_sweep: B={B} exceeds the kernel's shared-memory "
                         f"tile (B <= {_MAX_SMEM_B})")
    out = torch.empty_like(u)
    _launch("soa_half_sweep", blocks[color].data_ptr(), Dinv[color].data_ptr(),
            rhs[color].data_ptr(), u.data_ptr(), out.data_ptr(), int(color),
            B, C, int(nh), int(periodic))
    return out


def residual(blocks, rhs, u, nh, periodic):
    """K2; see ``ops.soa.residual``."""
    _check(blocks, rhs, u)
    _, _, B, _, C = blocks.shape
    if blocks.shape != (2, 5, B, B, C) or rhs.shape != (2, B, C) \
            or u.shape != (2, B, C):
        raise ValueError("residual: inconsistent SoA shapes")
    if B > _MAX_SMEM_B:
        raise ValueError(f"residual: B={B} exceeds the kernel's shared-memory "
                         f"tile (B <= {_MAX_SMEM_B})")
    out = torch.empty_like(u)
    _launch("soa_residual", blocks.data_ptr(), rhs.data_ptr(), u.data_ptr(),
            out.data_ptr(), B, C, int(nh), int(periodic))
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
    _launch("soa_small_gemm", W.data_ptr(), x.data_ptr(),
            None if base is None else base.data_ptr(), out.data_ptr(),
            M, K, N, batch, int(base is not None))
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
    _launch("soa_geo_transfer", T4.data_ptr(), x.data_ptr(),
            None if base is None else base.data_ptr(), out.data_ptr(),
            Bout, Bin, njc, nic, int(restrict), int(base is not None))
    return out
