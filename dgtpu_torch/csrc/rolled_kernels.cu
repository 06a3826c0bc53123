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
// owns a cell, here a block row is contiguous, so a CTA owns a cell, a warp
// an output row, and the lanes run along the row and reduce by shuffles.
// Every block element is read once, coalesced.
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

#include <cuda_runtime.h>

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

// R3: the inter-level transfers; one CTA per output cell of the (njo, nio)
// output grid.
//   mode 0, per cell:  out[c] = (base[c] +) T x[c]            T (Bout, Bin)
//   mode 1, restrict:  out[jc, ic] = sum_k T[k] x[2jc + b, 2ic + a], k = 2b + a
//                      (x on the (2 njo, 2 nio) grid)          T (4, Bout, Bin)
//   mode 2, prolong:   out[jf, if] = (base +) T[k] x[jf / 2, if / 2] with
//                      k = 2 (jf % 2) + (if % 2) (x on (njo / 2, nio / 2))
__global__ void transfer_kernel(const float* __restrict__ T,
                                const float* __restrict__ x,
                                const float* __restrict__ base,
                                float* __restrict__ out,
                                int Bout, int Bin, int njo, int nio, int mode,
                                int accumulate) {
    extern __shared__ float xin[];   // (groups, Bin)
    const int cell = blockIdx.x;
    const int j = cell / nio, i = cell - j * nio;
    const int groups = (mode == 1) ? 4 : 1;
    int k0 = 0;
    for (int t = threadIdx.x; t < groups * Bin; t += blockDim.x) {
        const int g = t / Bin;
        size_t src;
        if (mode == 0) src = cell;
        else if (mode == 1) src = (size_t)(2 * j + (g >> 1)) * (2 * nio) + 2 * i + (g & 1);
        else src = (size_t)(j / 2) * (nio / 2) + i / 2;
        xin[t] = x[src * Bin + (t - g * Bin)];
    }
    if (mode == 2) k0 = 2 * (j & 1) + (i & 1);
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* Tk = T + (size_t)k0 * Bout * Bin;
    const size_t v0 = (size_t)cell * Bout;
    for (int a = warp; a < Bout; a += WARPS) {
        const float acc = rows_dot(Tk, xin, groups, Bout, Bin, a, lane);
        if (lane == 0) out[v0 + a] = accumulate ? base[v0 + a] + acc : acc;
    }
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
    const size_t smem = (size_t)(mode == 1 ? 4 : 1) * Bin * sizeof(float);
    transfer_kernel<<<njo * nio, THREADS, smem, stream>>>(T, x, base, out, Bout, Bin,
                                                         njo, nio, mode, accumulate);
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
