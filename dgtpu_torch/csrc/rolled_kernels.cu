// Hopper kernels for the rolled (cell-major) multigrid cycle.
//
// They replace the Pallas TPU kernel of dgtpu's rolled-layout fused cycle,
// PallasVCycle.build (dgtpu/ops/pallas_vcycle.py:288-359, pallas_call at
// :326), which keeps the whole hierarchy in VMEM and runs one cycle in one
// launch.  One H100 SM has 227 KB of shared memory and even the 8x8 p=5
// hierarchy is ~2 MB, so here, as for the SoA cycles (soa_kernels.cu), the
// cycle is split into phase kernels that read their operands from device
// memory; the host-side recursion in dgtpu_torch/ops/vcycle.py
// (RolledVCycle._cycle) launches them in order on PyTorch's current stream:
//
//   R1 half_sweep     one color of the masked red-black block-GS sweep
//                     (rolled.rb_gs_sweeps_masked body, rolled.py:131-140)
//   R2 stencil_apply  base + sign A x over all cells (rolled.matvec; the
//                     residual is base = rhs, sign = -1)
//   R3 transfer       per-cell T x (polynomial R/P) and the 2x2 geometric
//                     restriction / prolongation with the child interleave
//                     (_tile_restrict / _tile_prolong, pallas_vcycle.py:35-67)
//   R4 dense_apply    the dense coarse inverse times the coarse rhs
//                     (_coarse_solve, pallas_vcycle.py:195-203)
//
// Layout (the TPU kernel's): vectors (Nj, Ni, B) with a cell's B modes
// contiguous, operator blocks (Nj, Ni, 5, B, B) in slot order [self, iL, iR,
// jL, jR], each block row-major (b_dst, b_src), diagonal inverses
// (Nj, Ni, B, B).  i-neighbors wrap around the row like jnp.roll (the
// wrapped blocks are zero unless the grid is an O-grid), j-neighbors outside
// the grid are zero halos.  This file shares no device code with
// soa_kernels.cu: there the cells lie in the contiguous axis and a thread
// owns a cell, here a block row is contiguous, so in R1 and R2 a CTA owns a
// cell, a warp an output row, and the lanes run along the row and reduce by
// shuffles; every block element is read once, coalesced.  R3's operands are
// a few KB, so a CTA owns a tile of cells and a thread an output (below).
//
// What bounds them on the card: the finest half-sweep reads half the cells'
// four off-diagonal blocks and diagonal inverse (0.83 MB at 8x8 p=5, 53 MB
// at 64x64 p=5), so device-memory bytes bound R1 and R2 on large grids; at
// 8x8 a launch is 64 CTAs and the host's launch rate bounds the cycle.  The
// TPU's color-split packing (use_split) halves the block traffic of a color
// pass there; a per-cell CTA reads only the active color's blocks to begin
// with, so one kernel serves every (Nj, Ni), odd Ni included.
//
// Every entry point is extern "C" (bound with ctypes), takes raw device
// pointers the caller allocated, launches on the given stream without
// synchronising, and returns cudaGetLastError() as an int.  ``accumulate``
// selects ``out = base + result`` (base may be null otherwise).  No output
// may alias an input.

#include <algorithm>

#include <cuda_runtime.h>

#include "device_common.cuh"

namespace {

constexpr int WARPS = 4;            // warps per CTA: output rows in flight
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// sum_{g < groups} sum_{b < n} M[(g * rows + a) * n + b] * f[g * n + b]: output
// row a of ``groups`` row-major (rows, n) matrices stacked at M, against the
// ``groups`` vectors of n floats at f (shared memory).  The lanes of the
// calling warp split the groups * n products; every lane returns the sum.
__device__ __forceinline__ float rows_dot(const float* __restrict__ M, const float* f,
                                          int groups, int rows, int n, int a, int lane) {
    float acc = 0.f;
    for (int t = lane; t < groups * n; t += 32) {
        const int g = t / n;
        acc = fmaf(__ldg(M + ((size_t)g * rows + a) * n + (t - g * n)), f[t], acc);
    }
    return warp_sum(acc);
}

// Stage the fields slots s0..4 of cell (j, i) read into fld ((5 - s0), B):
// slot 0 the cell's own vector, 1 / 2 its i-neighbors (circular), 3 / 4 its
// j-neighbors (zero outside the grid) -- rolled.neighbor_fields.
__device__ __forceinline__ void stage_fields(float* fld, const float* __restrict__ x,
                                             int j, int i, int Nj, int Ni, int B, int s0) {
    const int il = (i == 0) ? Ni - 1 : i - 1;
    const int ir = (i == Ni - 1) ? 0 : i + 1;
    for (int t = threadIdx.x; t < (5 - s0) * B; t += blockDim.x) {
        const int s = s0 + t / B;
        const int b = t - (s - s0) * B;
        int jj = j, ii = i;
        if (s == 1) ii = il;
        else if (s == 2) ii = ir;
        else if (s == 3) jj = j - 1;
        else if (s == 4) jj = j + 1;
        fld[t] = (jj < 0 || jj >= Nj) ? 0.f : x[((size_t)jj * Ni + ii) * B + b];
    }
}

// R1: one color of the masked red-black sweep, out of place:
//   out[j, i] = (base[j, i] +) Dinv[j, i] (rhs[j, i] - sum_{s=1..4} A[j, i, s] nbr_s(u))
// for the cells with (i + j) % 2 == color, and (base +) u elsewhere.  Every
// neighbor is read from the pre-update u, as the masked sweep does: with an
// odd Ni the two cells across the row's wrap have one color and read each
// other, so an in-place update would race.  One CTA per cell; an inactive
// cell's CTA only copies, so the blocks and inverses of the other color are
// never read.
__global__ void half_sweep_kernel(const float* __restrict__ blocks,
                                  const float* __restrict__ dinv,
                                  const float* __restrict__ rhs,
                                  const float* __restrict__ u,
                                  const float* __restrict__ base,
                                  float* __restrict__ out,
                                  int color, int Nj, int Ni, int B, int accumulate) {
    extern __shared__ float sm[];
    float* fld = sm;            // (4, B): the neighbor fields
    float* t = sm + 4 * B;      // (B): rhs - off
    const int cell = blockIdx.x;
    const int j = cell / Ni, i = cell - j * Ni;
    const size_t v0 = (size_t)cell * B;
    if (((i + j) & 1) != color) {
        for (int b = threadIdx.x; b < B; b += blockDim.x)
            out[v0 + b] = accumulate ? base[v0 + b] + u[v0 + b] : u[v0 + b];
        return;
    }
    stage_fields(fld, u, j, i, Nj, Ni, B, 1);
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* off = blocks + ((size_t)cell * 5 + 1) * B * B;
    for (int a = warp; a < B; a += WARPS) {
        const float acc = rows_dot(off, fld, 4, B, B, a, lane);
        if (lane == 0) t[a] = rhs[v0 + a] - acc;
    }
    __syncthreads();
    const float* dv = dinv + (size_t)cell * B * B;
    for (int a = warp; a < B; a += WARPS) {
        const float acc = rows_dot(dv, t, 1, B, B, a, lane);
        if (lane == 0) out[v0 + a] = accumulate ? base[v0 + a] + acc : acc;
    }
}

// R2: out[j, i] = (base[j, i] +) sign * sum_{s=0..4} A[j, i, s] nbr_s(x) over
// all cells (slot 0 is the cell itself).
__global__ void stencil_apply_kernel(const float* __restrict__ blocks,
                                     const float* __restrict__ x,
                                     const float* __restrict__ base,
                                     float* __restrict__ out,
                                     int Nj, int Ni, int B, float sign, int accumulate) {
    extern __shared__ float fld[];   // (5, B)
    const int cell = blockIdx.x;
    const int j = cell / Ni, i = cell - j * Ni;
    stage_fields(fld, x, j, i, Nj, Ni, B, 0);
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* blk = blocks + (size_t)cell * 5 * B * B;
    const size_t v0 = (size_t)cell * B;
    for (int a = warp; a < B; a += WARPS) {
        const float y = sign * rows_dot(blk, fld, 5, B, B, a, lane);
        if (lane == 0) out[v0 + a] = accumulate ? base[v0 + a] + y : y;
    }
}

// R3: the inter-level transfers over the (njo, nio) output grid,
//   mode 0, per cell:  out[c] = (base[c] +) T x[c]            T (Bout, Bin)
//   mode 1, restrict:  out[jc, ic] = sum_k T[k] x[2jc + b, 2ic + a], k = 2b + a
//                      (x on the (2 njo, 2 nio) grid)          T (4, Bout, Bin)
//   mode 2, prolong:   out[jf, if] = (base +) T[k] x[jf / 2, if / 2] with
//                      k = 2 (jf % 2) + (if % 2) (x on (njo / 2, nio / 2))
// Mode 0 is one (cells, Bin) x (Bin, Bout) product: 4,096 x 16 x 36 at the
// 64x64 p5 prolongation, a few KB of operands, and the 2x2 transfers of the
// geometric levels are smaller still (16 to 1,024 cells of 4 modes).  A CTA
// per output cell (the first version) paid for 4,096 CTAs and their
// barriers, a warp per output row with half its lanes idle at Bin = 16 and a
// shuffle reduction, and lost to one torch.addmm.  The work is bound by
// latency (a load's round trip, a barrier, a chain of multiply-adds), not by
// bytes, so the body keeps each of those to one and the per-thread work
// short:
//   - a CTA owns ``tile`` consecutive output cells and all their Bout modes;
//     its threads take the tile's outputs with the mode index fastest
//     (XFER_OUTS at most each), so the loads of base and the stores of out
//     are coalesced.  The launcher takes the largest tile (at most
//     XFER_TILE cells) that still gives a CTA per SM where the level has the
//     cells, down to one cell per CTA on the small levels, and gives the CTA
//     at least XFER_MIN_THREADS threads, so that T's staging stays short;
//   - each thread fetches its base elements, then all of the CTA's threads
//     issue asynchronous copies (cp.async) of T (the four per-child matrices
//     in modes 1 and 2) and of the tile's inputs (K = Bin floats per output
//     cell; mode 1: 4 Bin, the children of a coarse cell are two runs of two
//     consecutive fine cells) into shared memory, wait once and meet one
//     barrier: every staging load is in flight together;
//   - T's rows and the cells' inputs lie at odd strides, so a warp's reads
//     hit distinct banks or broadcast; each output is one chain of K
//     multiply-adds from shared memory in the order k = 0..3, b =
//     0..Bin-1: no shuffles, no atomics.
// The mode is a template argument: each of the three bodies is compiled
// without the others' branches (on the small levels a launch is a few
// hundred cycles of one thread's instructions).
// Where the tile shrinks to one cell in modes 1 and 2 (the geometric
// levels with fewer output cells than SMs: 1 to 256 cells of 4 modes) the
// staging, its wait and the barrier are most of the launch, so those
// launches take a direct body instead (transfer_direct_kernel): a thread
// per output reads its row of T and its inputs through the read-only path,
// every load issued before the chain, in the same order of sums.
constexpr int XFER_TILE = 32;         // output cells per CTA at most
constexpr int XFER_THREADS = 256;      // threads per CTA at most
constexpr int XFER_MIN_THREADS = 128;  // threads per CTA at least (staging)
constexpr int XFER_OUTS = 8;           // outputs per thread at most
constexpr int XFER_DIRECT_THREADS = 64;  // threads per CTA of the direct body

// Element w of the K inputs of output cell c (modes as above).
__device__ __forceinline__ size_t transfer_src(int mode, int c, int w, int Bin,
                                               int nio) {
    if (mode == 0) return (size_t)c * Bin + w;
    const int j = c / nio, i = c - j * nio;
    if (mode == 1) {   // w = r * 2 Bin + (a Bin + b): child row r, column a
        const int r = w >= 2 * Bin;
        return ((size_t)(2 * j + r) * (2 * nio) + 2 * i) * Bin + (w - r * 2 * Bin);
    }
    return ((size_t)(j >> 1) * (nio >> 1) + (i >> 1)) * Bin + w;
}

template <int mode>
__global__ void __launch_bounds__(XFER_THREADS)
transfer_kernel(const float* __restrict__ T, const float* __restrict__ x,
                const float* __restrict__ base, float* __restrict__ out, int Bout,
                int Bin, int njo, int nio, int accumulate, int tile) {
    extern __shared__ float sm[];
    constexpr int nT = mode == 0 ? 1 : 4;
    const int K = (mode == 1 ? 4 : 1) * Bin;
    const int ldT = Bin | 1, ldx = K | 1;   // odd strides
    float* Ts = sm;                         // (nT, Bout, ldT)
    float* xs = sm + nT * Bout * ldT;       // (tile, ldx)
    const int tid = threadIdx.x, nt = blockDim.x;
    const int c0 = blockIdx.x * tile;
    const int nc = min(tile, njo * nio - c0);
    const int n_out = nc * Bout;
    const size_t o0 = (size_t)c0 * Bout;
    float bv[XFER_OUTS];
#pragma unroll
    for (int r = 0; r < XFER_OUTS; ++r) {
        const int t = tid + r * nt;
        bv[r] = (accumulate && t < n_out) ? base[o0 + t] : 0.f;
    }
    for (int i = tid; i < nT * Bout * Bin; i += nt) {
        const int row = i / Bin;
        cp_async4(Ts + row * ldT + (i - row * Bin), T + i);
    }
    for (int i = tid; i < nc * K; i += nt) {
        const int cl = i / K, w = i - cl * K;
        cp_async4(xs + cl * ldx + w, x + transfer_src(mode, c0 + cl, w, Bin, nio));
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int r = 0; r < XFER_OUTS; ++r) {
        const int t = tid + r * nt;
        if (t < n_out) {
            const int cl = t / Bout, a = t - cl * Bout;
            const float* xv = xs + cl * ldx;
            float acc = 0.f;
            if constexpr (mode == 1) {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const float* Tr = Ts + (k * Bout + a) * ldT;
#pragma unroll 4
                    for (int b = 0; b < Bin; ++b) acc = fmaf(Tr[b], xv[k * Bin + b], acc);
                }
            } else {
                int k0 = 0;
                if (mode == 2) {
                    const int c = c0 + cl, j = c / nio;
                    k0 = 2 * (j & 1) + ((c - j * nio) & 1);
                }
                const float* Tr = Ts + (k0 * Bout + a) * ldT;
#pragma unroll 4
                for (int b = 0; b < Bin; ++b) acc = fmaf(Tr[b], xv[b], acc);
            }
            out[o0 + t] = accumulate ? bv[r] + acc : acc;
        }
    }
}

// R3's direct body (modes 1 and 2 on the small levels, above): one output
// per thread, K multiply-adds whose operands come straight from L1/L2.
// kBin > 0: Bin known at compile time (the p1 levels' 4; every load issued
// before the first multiply-add), 0: any Bin.
template <int mode, int kBin>
__global__ void __launch_bounds__(XFER_DIRECT_THREADS)
transfer_direct_kernel(const float* __restrict__ T, const float* __restrict__ x,
                       const float* __restrict__ base, float* __restrict__ out,
                       int Bout, int Bin_any, int njo, int nio, int accumulate) {
    const int Bin = kBin > 0 ? kBin : Bin_any;
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= njo * nio * Bout) return;
    const int c = t / Bout, a = t - c * Bout;
    const int j = c / nio, i = c - j * nio;
    const float b0 = accumulate ? base[t] : 0.f;
    float acc = 0.f;
    if constexpr (mode == 1) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const float* Tr = T + (size_t)(k * Bout + a) * Bin;
            const float* xv =
                x + ((size_t)(2 * j + (k >> 1)) * (2 * nio) + 2 * i + (k & 1)) * Bin;
#pragma unroll 4
            for (int b = 0; b < Bin; ++b) acc = fmaf(__ldg(Tr + b), __ldg(xv + b), acc);
        }
    } else {
        const float* Tr = T + (size_t)((2 * (j & 1) + (i & 1)) * Bout + a) * Bin;
        const float* xv = x + ((size_t)(j >> 1) * (nio >> 1) + (i >> 1)) * Bin;
#pragma unroll 4
        for (int b = 0; b < Bin; ++b) acc = fmaf(__ldg(Tr + b), __ldg(xv + b), acc);
    }
    out[t] = accumulate ? b0 + acc : acc;
}

template <int mode>
void launch_transfer_direct(const float* T, const float* x, const float* base,
                            float* out, int Bout, int Bin, int njo, int nio,
                            int accumulate, cudaStream_t stream) {
    const int n_out = njo * nio * Bout;
    const int threads = std::min(XFER_DIRECT_THREADS, (n_out + 31) / 32 * 32);
    const dim3 grid((n_out + threads - 1) / threads);
    if (Bin == 4)
        transfer_direct_kernel<mode, 4><<<grid, threads, 0, stream>>>(
            T, x, base, out, Bout, Bin, njo, nio, accumulate);
    else
        transfer_direct_kernel<mode, 0><<<grid, threads, 0, stream>>>(
            T, x, base, out, Bout, Bin, njo, nio, accumulate);
}

// R4: out = W x for a row-major dense W (M, M): the coarse level's inverse
// against its flattened rhs.  One warp per output row, lanes along the row
// (coalesced), x staged once per CTA in shared memory.  Its device work is
// ~1 us: launched eagerly the host's launch path bounds it, replayed in the
// captured rolled cycle (dgtpu_torch/ops/graphs.py) the launch latency.
__global__ void dense_apply_kernel(const float* __restrict__ W,
                                   const float* __restrict__ x,
                                   float* __restrict__ out, int M) {
    extern __shared__ float xs[];    // (M)
    for (int k = threadIdx.x; k < M; k += blockDim.x) xs[k] = x[k];
    __syncthreads();
    const int m = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (m >= M) return;
    float acc = 0.f;
    for (int k = lane; k < M; k += 32)
        acc = fmaf(__ldg(W + (size_t)m * M + k), xs[k], acc);
    acc = warp_sum(acc);
    if (lane == 0) out[m] = acc;
}

}  // namespace

extern "C" {

int rolled_half_sweep(const float* blocks, const float* dinv, const float* rhs,
                      const float* u, const float* base, float* out, int color,
                      int Nj, int Ni, int B, int accumulate, cudaStream_t stream) {
    half_sweep_kernel<<<Nj * Ni, THREADS, (size_t)5 * B * sizeof(float), stream>>>(
        blocks, dinv, rhs, u, base, out, color, Nj, Ni, B, accumulate);
    return (int)cudaGetLastError();
}

int rolled_stencil_apply(const float* blocks, const float* x, const float* base,
                         float* out, int Nj, int Ni, int B, float sign, int accumulate,
                         cudaStream_t stream) {
    stencil_apply_kernel<<<Nj * Ni, THREADS, (size_t)5 * B * sizeof(float), stream>>>(
        blocks, x, base, out, Nj, Ni, B, sign, accumulate);
    return (int)cudaGetLastError();
}

int rolled_transfer(const float* T, const float* x, const float* base, float* out,
                    int Bout, int Bin, int njo, int nio, int mode, int accumulate,
                    cudaStream_t stream) {
    const int sms = sm_count();
    if (sms == 0) return (int)cudaErrorNoDevice;
    const int cells = njo * nio;
    const int nT = mode == 0 ? 1 : 4, K = (mode == 1 ? 4 : 1) * Bin;
    const auto smem = [&](int tile) {
        return (size_t)(nT * Bout * (Bin | 1) + tile * (K | 1)) * sizeof(float);
    };
    // the largest tile that still gives a CTA per SM, within the CTA's
    // outputs and the 48 KB of shared memory a launch gets by default
    int tile = XFER_TILE;
    while (tile > 1 && (cells + tile - 1) / tile < sms) tile /= 2;
    while (tile > 1 && (tile * Bout > XFER_THREADS * XFER_OUTS || smem(tile) > 48 * 1024))
        tile /= 2;
    if (tile * Bout > XFER_THREADS * XFER_OUTS || smem(tile) > 48 * 1024)
        return (int)cudaErrorInvalidValue;
    if (tile == 1 && mode != 0) {
        if (mode == 1)
            launch_transfer_direct<1>(T, x, base, out, Bout, Bin, njo, nio, accumulate,
                                      stream);
        else
            launch_transfer_direct<2>(T, x, base, out, Bout, Bin, njo, nio, accumulate,
                                      stream);
        return (int)cudaGetLastError();
    }
    const int threads =
        std::max(XFER_MIN_THREADS, std::min(XFER_THREADS, (tile * Bout + 31) / 32 * 32));
    const dim3 grid((cells + tile - 1) / tile);
    if (mode == 0)
        transfer_kernel<0><<<grid, threads, smem(tile), stream>>>(
            T, x, base, out, Bout, Bin, njo, nio, accumulate, tile);
    else if (mode == 1)
        transfer_kernel<1><<<grid, threads, smem(tile), stream>>>(
            T, x, base, out, Bout, Bin, njo, nio, accumulate, tile);
    else
        transfer_kernel<2><<<grid, threads, smem(tile), stream>>>(
            T, x, base, out, Bout, Bin, njo, nio, accumulate, tile);
    return (int)cudaGetLastError();
}

int rolled_dense_apply(const float* W, const float* x, float* out, int M,
                       cudaStream_t stream) {
    dense_apply_kernel<<<(M + WARPS - 1) / WARPS, THREADS, (size_t)M * sizeof(float),
                         stream>>>(W, x, out, M);
    return (int)cudaGetLastError();
}

const char* rolled_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
