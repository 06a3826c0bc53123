"""Build, load and launch the CUDA kernels of ``csrc/soa_kernels.cu`` (K1
half-sweep, K3 small GEMM, K4 geometric transfer and K5 stencil apply of
both SoA cycles, K6, the Stokes pressure half-sweep, and K7, the streamed
hybrids' multi-half-sweep) and of ``csrc/rolled_kernels.cu``
(R1 half-sweep, R2 stencil apply, R3 transfer and R4 dense apply of the
rolled cycle).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (never at import: the CPU tests import
every module), cached under ``build/dgtpu_torch/`` by the hash of the source
and of the headers beside it (``csrc/*.cuh``), and loaded with ``ctypes``.
Each launcher checks device, dtype, shape and
contiguity, allocates its output with ``torch.empty``, launches on
PyTorch's current stream and raises if the launch reports a CUDA error.
"""

import ctypes
import functools
from concurrent.futures import ThreadPoolExecutor
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "soa_kernels.cu")
ROLLED_SOURCE = os.path.join(_PKG, "csrc", "rolled_kernels.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "dgtpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# entry point -> argument types (a launcher's last one is the stream)
_SIGNATURES = {
    "soa_half_sweep": [_P] * 6 + [_I] * 6 + [_P],
    "soa_half_sweep_grid": [_I, _I, ctypes.POINTER(_I)],
    "soa_multi_half_sweep": [_P] * 2 + [_L] * 2 + [_P] * 4 + [_I] * 7 + [_P],
    "soa_multi_half_sweep_grid": [_I, _I, _I, ctypes.POINTER(_I)],
    "soa_multi_half_sweep_clusters": [_I, _I, _I, ctypes.POINTER(_I)],
    "soa_small_gemm": [_P] * 4 + [_I] * 5 + [_P],
    "soa_geo_transfer": [_P] * 4 + [_I] * 6 + [_P],
    "soa_geo_transfer_grid": [_I, _I, ctypes.POINTER(_I)],
    "soa_empty": [_P],
    "soa_stencil_apply": [_P] * 4 + [_I] * 5 + [_F, _I, _I, _P],
    "soa_stencil_apply_grid": [_I, _I, ctypes.POINTER(_I)],
    "soa_dg_half_sweep": [_P] * 8 + [_I] * 7 + [_P],
    "soa_dg_half_sweep_grid": [_I, _I, _I, ctypes.POINTER(_I)],
}
_ROLLED_SIGNATURES = {
    "rolled_half_sweep": [_P] * 6 + [_I] * 5 + [_P],
    "rolled_stencil_apply": [_P] * 4 + [_I] * 3 + [_F, _I, _P],
    "rolled_transfer": [_P] * 4 + [_I] * 6 + [_P],
    "rolled_dense_apply": [_P] * 3 + [_I, _P],
}
# Shared memory per CTA (TC = 32 cells): K5 stages 5*B*TC floats; K1 and K7
# 4*B*TC of neighbor fields and B*TC of t = rhs - off, which the cluster's
# CTAs complete in place, so 5*B*TC too; K6 (5*Bu + Np)*TC.  The launches
# stay under the 48 KB a kernel gets without an opt-in attribute.
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


def build(source=SOURCE):
    """Compile one kernel source unless it is built already; returns the
    shared library's path."""
    folder = os.path.dirname(source)
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in [os.path.basename(source)] + sorted(
            f for f in os.listdir(folder) if f.endswith(".cuh")):
        with open(os.path.join(folder, name), "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    lib = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # one name per thread: build_all may build two copies of one source
        # (an earlier tree's unchanged file) into the same library at once
        tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def build_all(sources=(SOURCE, ROLLED_SOURCE)):
    """Compile the sources (by default both of this package), one nvcc each,
    started together."""
    with ThreadPoolExecutor(len(sources)) as pool:
        return list(pool.map(build, sources))


def _load(source, signatures, prefix):
    """The library built from ``source`` with its entry points bound (those
    of ``signatures`` that it exports)."""
    lib = ctypes.CDLL(build(source))
    for name, argtypes in signatures.items():
        if not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    error_string = getattr(lib, f"{prefix}_error_string")
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def library():
    """The loaded library of the SoA kernels (built on first call)."""
    return _load(SOURCE, _SIGNATURES, "soa")


@functools.lru_cache(maxsize=None)
def rolled_library():
    """The loaded library of the rolled kernels (built on first call)."""
    return _load(ROLLED_SOURCE, _ROLLED_SIGNATURES, "rolled")


def libraries_from(csrc):
    """The (SoA, rolled) libraries built from ``soa_kernels.cu`` and
    ``rolled_kernels.cu`` in the directory ``csrc``: another tree's kernels,
    to time beside this package's."""
    return (_load(os.path.join(csrc, os.path.basename(SOURCE)), _SIGNATURES, "soa"),
            _load(os.path.join(csrc, os.path.basename(ROLLED_SOURCE)),
                  _ROLLED_SIGNATURES, "rolled"))


def _check(*tensors, blocks=()):
    """Vectors float32, operator ``blocks`` float32 or bfloat16; all CUDA
    tensors on one device, contiguous.  Returns whether the blocks are
    bfloat16."""
    every = tensors + tuple(blocks)
    dev = every[0].device
    for t in every:
        if not t.is_cuda or t.device != dev:
            raise ValueError("the kernels take CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the kernels' vectors are float32, got {t.dtype}")
    kinds = {t.dtype for t in blocks}
    if not kinds <= {torch.float32, torch.bfloat16} or len(kinds) > 1:
        raise TypeError(f"SoA kernels' blocks are float32 or bfloat16, got {kinds}")
    return kinds == {torch.bfloat16}


def _launch(name, *args):
    prefix = name.split("_")[0]
    lib = rolled_library() if prefix == "rolled" else library()
    code = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        message = getattr(lib, f"{prefix}_error_string")(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({message})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _opt(*tensors):
    return tuple(t for t in tensors if t is not None)


def half_sweep(blocks, Dinv, rhs, u, color, nh, periodic, base=None):
    """K1; see ``ops.soa.half_sweep``."""
    _check(blocks, Dinv, rhs, u, *_opt(base))
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
            rhs[color].data_ptr(), u.data_ptr(), _ptr(base), out.data_ptr(),
            int(color), B, C, int(nh), int(periodic), int(base is not None))
    return out


def small_gemm(W, x, base=None):
    """K3; see ``ops.soa.small_gemm``."""
    _check(W, x, *_opt(base))
    M, K = W.shape
    if x.dim() != 3 or x.shape[1] != K:
        raise ValueError(f"small_gemm: W {tuple(W.shape)} vs x {tuple(x.shape)}")
    batch, _, N = x.shape
    if base is not None and base.shape != (batch, M, N):
        raise ValueError("small_gemm: base shape mismatch")
    # N = 1 stages x (K floats), N > 1 8 rows of W and a (K, 32) tile of x
    if (K if N == 1 else (8 + _TC) * K) > _SMEM_FLOATS:
        raise ValueError(f"small_gemm: W {tuple(W.shape)} with N={N} exceeds the "
                         "kernel's shared-memory tile")
    out = torch.empty((batch, M, N), dtype=x.dtype, device=x.device)
    _launch("soa_small_gemm", W.data_ptr(), x.data_ptr(), _ptr(base),
            out.data_ptr(), M, K, N, batch, int(base is not None))
    return out


def geo_transfer(T4, x, dims_c, restrict, base=None):
    """K4; see ``ops.soa.geo_transfer``."""
    _check(T4, x, *_opt(base))
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
    _launch("soa_geo_transfer", T4.data_ptr(), x.data_ptr(), _ptr(base),
            out.data_ptr(), Bout, Bin, njc, nic, int(restrict), int(base is not None))
    return out


def stencil_apply(blocks, x, nh, periodic, base=None, sign=1.0):
    """K5; see ``ops.soa.stencil_apply``.  ``blocks`` float32 or bfloat16."""
    bf16 = _check(x, *_opt(base), blocks=(blocks,))
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
    _launch("soa_stencil_apply", blocks.data_ptr(), x.data_ptr(), _ptr(base),
            out.data_ptr(), Bs, Bd, C, int(nh), int(periodic), float(sign),
            int(base is not None), int(bf16))
    return out


def _grid(name, *shape):
    dims = (ctypes.c_int * 4)()
    code = getattr(library(), name)(*(int(n) for n in shape), dims)
    if code != 0:
        raise RuntimeError(f"{name} failed: CUDA error {code} "
                           f"({library().soa_error_string(code).decode()})")
    return tuple(dims)


def geo_transfer_grid(Bout, C_out):
    """K4's launch geometry for Bout output modes over C_out output cells per
    color: (grid x, grid y, grid z, threads per CTA), as the launcher picks it
    on this card (K5's rule)."""
    return _grid("soa_geo_transfer_grid", Bout, C_out)


def empty():
    """One launch of an empty kernel: the card's launch floor."""
    _launch("soa_empty")


def stencil_apply_grid(Bd, C):
    """K5's launch geometry for Bd output modes over C cells per color:
    (grid x, grid y, grid z, threads per CTA), as the launcher picks it on
    this card."""
    return _grid("soa_stencil_apply_grid", Bd, C)


def half_sweep_grid(B, C):
    """K1's launch geometry for B output modes over C cells per color:
    (cell tiles, CTAs per cluster, output modes per CTA, threads per CTA),
    as the launcher picks it on this card (the rule in soa_kernels.cu)."""
    return _grid("soa_half_sweep_grid", B, C)


def dg_half_sweep_grid(Np, C, Bu=18):
    """K6's launch geometry for Np output modes over C cells per color with
    Bu velocity modes staged, as ``half_sweep_grid``'s."""
    return _grid("soa_dg_half_sweep_grid", Bu, Np, C)


def dg_half_sweep(D, DG_diag, DG_Dinv, rhs, p, g, color, nh, periodic, base=None):
    """K6; see ``ops.stokes_soa.dg_half_sweep``."""
    _check(D, DG_diag, DG_Dinv, rhs, p, g, *_opt(base))
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
            p.data_ptr(), _ptr(base), out.data_ptr(), int(color), Bu, Np, C,
            int(nh), int(periodic), int(base is not None))
    return out


def multi_half_sweep_grid(B, C, bf16=False):
    """K7's default launch geometry for B output modes over C cells per
    color with float32 or bfloat16 blocks: (clusters, CTAs per cluster,
    output modes per CTA, threads per CTA), K1's rule with one cluster per
    cell tile, at most as many as the card holds at once."""
    return _grid("soa_multi_half_sweep_grid", B, C, int(bf16))


def resident_clusters(B, C, bf16=False):
    """How many of K7's clusters for (B, C) the card holds at once: the
    largest grid its launcher takes."""
    n = ctypes.c_int()
    code = library().soa_multi_half_sweep_clusters(int(B), int(C), int(bf16),
                                                   ctypes.byref(n))
    if code != 0:
        raise RuntimeError(f"soa_multi_half_sweep_clusters failed: CUDA error {code} "
                           f"({library().soa_error_string(code).decode()})")
    return n.value


def multi_half_sweep(blocks, Dinv, rhs, u, n_half, nh, periodic, base=None,
                     clusters=None):
    """K7; see ``ops.stream.multi_half_sweep``.  ``blocks`` (2, 5, B, B, C)
    (slots 1..4 read) and ``Dinv`` (2, B, B, C) are float32 or bfloat16 and
    may be strided per color (``Dinv`` may be slot 0 of ``blocks``); ``u``
    None is a zero start.  ``clusters``: the grid in clusters of
    ``multi_half_sweep_grid``'s size (default: one per 32-cell tile, at most
    the resident count); a grid the card cannot hold at once raises."""
    _check(rhs, *_opt(u, base))
    _, _, B, _, C = blocks.shape
    for name, t, inner in (("blocks", blocks, (B * B * C, B * C, C, 1)),
                           ("Dinv", Dinv, (B * C, C, 1))):
        if not t.is_cuda or t.device != rhs.device or t.stride()[1:] != inner:
            raise ValueError(f"multi_half_sweep: {name} must be CUDA tensors on the "
                             "vectors' device, contiguous within a color")
    if Dinv.dtype != blocks.dtype or blocks.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("multi_half_sweep: blocks and Dinv are both float32 or "
                        f"both bfloat16, got {blocks.dtype}, {Dinv.dtype}")
    if blocks.shape != (2, 5, B, B, C) or Dinv.shape != (2, B, B, C) \
            or rhs.shape != (2, B, C) or (u is not None and u.shape != rhs.shape) \
            or (base is not None and base.shape != rhs.shape):
        raise ValueError("multi_half_sweep: inconsistent SoA shapes")
    if n_half < 2 or n_half % 2:
        raise ValueError(f"multi_half_sweep: half-sweeps come in red/black pairs, "
                         f"got {n_half}")
    if B > _MAX_SMEM_B:
        raise ValueError(f"multi_half_sweep: B={B} exceeds the kernel's "
                         f"shared-memory tile (B <= {_MAX_SMEM_B})")
    if clusters is not None and clusters < 1:
        raise ValueError(f"multi_half_sweep: a grid of {clusters} clusters")
    out = torch.empty_like(rhs)
    _launch("soa_multi_half_sweep", blocks.data_ptr(), Dinv.data_ptr(),
            blocks.stride(0), Dinv.stride(0), rhs.data_ptr(), _ptr(u), _ptr(base),
            out.data_ptr(), int(n_half), B, C, int(nh), int(periodic),
            int(blocks.dtype == torch.bfloat16), int(clusters or 0))
    return out


# R1 and R2 copy a cell into shared memory: R1 its blocks and Dinv, fields,
# rhs, base and t (5 B^2 + 7 B floats and an mbarrier), R2 its five blocks,
# fields and base (5 B^2 + 6 B floats and an mbarrier), past 48 KB with the
# kernel's opt-in, up to the 227 KB a CTA can have: B <= 107 (p <= 9)
_CTA_SMEM_BYTES = 232448
_MAX_ROLLED_B = max(B for B in range(1, 256)
                    if 16 + (5 * B * B + 7 * B) * 4 <= _CTA_SMEM_BYTES)
# R3: a CTA takes at most XFER_THREADS * XFER_OUTS outputs (rolled_kernels.cu)
_XFER_OUTPUTS = 256 * 8


def _rolled_level(name, blocks, *vectors):
    """(Nj, Ni, B) of a rolled level's blocks (Nj, Ni, 5, B, B), checked
    against its (Nj, Ni, B) vectors."""
    nj, ni, _, B, _ = blocks.shape
    if blocks.shape != (nj, ni, 5, B, B) or any(v.shape != (nj, ni, B) for v in vectors):
        raise ValueError(f"{name}: inconsistent rolled shapes")
    return nj, ni, B


def rolled_half_sweep(blocks, Dinv, rhs, u, color, base=None):
    """R1; see ``ops.vcycle.half_sweep``."""
    _check(blocks, Dinv, rhs, u, *_opt(base))
    nj, ni, B = _rolled_level("rolled_half_sweep", blocks, rhs, u, *_opt(base))
    if Dinv.shape != (nj, ni, B, B):
        raise ValueError("rolled_half_sweep: inconsistent rolled shapes")
    if B > _MAX_ROLLED_B:
        raise ValueError(f"rolled_half_sweep: B={B} exceeds the kernel's shared-memory "
                         f"copy of a cell's blocks (B <= {_MAX_ROLLED_B})")
    out = torch.empty_like(u)
    _launch("rolled_half_sweep", blocks.data_ptr(), Dinv.data_ptr(), rhs.data_ptr(),
            u.data_ptr(), _ptr(base), out.data_ptr(), int(color), nj, ni, B,
            int(base is not None))
    return out


def rolled_stencil_apply(blocks, x, base=None, sign=1.0):
    """R2; see ``ops.vcycle.stencil_apply``."""
    _check(blocks, x, *_opt(base))
    nj, ni, B = _rolled_level("rolled_stencil_apply", blocks, x, *_opt(base))
    if B > _MAX_ROLLED_B:
        raise ValueError(f"rolled_stencil_apply: B={B} exceeds the kernel's "
                         f"shared-memory copy of a cell's blocks (B <= {_MAX_ROLLED_B})")
    out = torch.empty_like(x)
    _launch("rolled_stencil_apply", blocks.data_ptr(), x.data_ptr(), _ptr(base),
            out.data_ptr(), nj, ni, B, float(sign), int(base is not None))
    return out


def rolled_transfer(T, x, restrict=False, base=None):
    """R3; see ``ops.vcycle.transfer``.  T (Bout, Bin) acts per cell; T
    (4, Bout, Bin) is a 2x2 restriction when ``restrict``, else a 2x2
    prolongation."""
    _check(T, x, *_opt(base))
    nj, ni, Bin = x.shape
    Bout = T.shape[-2]
    if T.shape[-1] != Bin or T.shape[:-2] not in ((), (4,)):
        raise ValueError(f"rolled_transfer: T {tuple(T.shape)} vs x {tuple(x.shape)}")
    if T.dim() == 2:
        mode, njo, nio = 0, nj, ni
    elif restrict:
        if nj % 2 or ni % 2:
            raise ValueError(f"rolled_transfer: a {nj}x{ni} grid has no 2x2 tiles")
        mode, njo, nio = 1, nj // 2, ni // 2
    else:
        mode, njo, nio = 2, 2 * nj, 2 * ni
    if base is not None and (mode == 1 or base.shape != (njo, nio, Bout)):
        raise ValueError("rolled_transfer: base is the output-grid addend of a "
                         "per-cell transfer or a prolongation")
    # a CTA stages T (four matrices in modes 1 and 2) and the inputs of its
    # output cells, each at an odd stride; the launcher shrinks its tile of
    # cells to fit, down to one cell
    k = (4 if mode == 1 else 1) * Bin
    if (1 if mode == 0 else 4) * Bout * (Bin | 1) + (k | 1) > _SMEM_FLOATS \
            or Bout > _XFER_OUTPUTS:
        raise ValueError(f"rolled_transfer: T {tuple(T.shape)} exceeds the kernel's "
                         "shared-memory tile")
    out = torch.empty((njo, nio, Bout), dtype=x.dtype, device=x.device)
    _launch("rolled_transfer", T.data_ptr(), x.data_ptr(), _ptr(base), out.data_ptr(),
            Bout, Bin, njo, nio, mode, int(base is not None))
    return out


def rolled_dense_apply(W, x):
    """R4; see ``ops.vcycle.dense_apply``."""
    _check(W, x)
    M = x.numel()
    if W.shape != (M, M):
        raise ValueError(f"rolled_dense_apply: W {tuple(W.shape)} vs {M} unknowns")
    if M > _SMEM_FLOATS:
        raise ValueError(f"rolled_dense_apply: {M} unknowns exceed the kernel's "
                         "shared-memory copy of x")
    out = torch.empty_like(x)
    _launch("rolled_dense_apply", W.data_ptr(), x.data_ptr(), out.data_ptr(), M)
    return out
