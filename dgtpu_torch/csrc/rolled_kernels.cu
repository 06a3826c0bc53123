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
// owns a cell, here a cell's blocks are contiguous, so in R1 and R2 a CTA
// owns a cell, a warp an output row, and the lanes run along the row and
// reduce by shuffles; every block element is read once, coalesced (R1
// stages the cell's blocks in shared memory by bulk copies first).  R3's
// operands are a few KB, so a CTA owns a tile of cells and a thread an
// output (below).
//
// What bounds them on the card: the finest half-sweep reads half the cells'
// four off-diagonal blocks and diagonal inverse (0.83 MB at 8x8 p=5, 53 MB
// at 64x64 p=5), so device-memory bytes bound R1 and R2 on large grids; at
// 8x8 a launch is 32 to 64 CTAs and latency bounds it.  The TPU's
// color-split packing (use_split) halves the block traffic of a color pass
// there; R1's CTAs take the active color's cells only, so one kernel serves
// every (Nj, Ni), odd Ni included.
//
// Every entry point is extern "C" (bound with ctypes), takes raw device
// pointers the caller allocated, launches on the given stream without
// synchronising, and returns cudaGetLastError() as an int.  ``accumulate``
// selects ``out = base + result`` (base may be null otherwise).  No output
// may alias an input.

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include <cuda_runtime.h>

#include "device_common.cuh"

namespace {

constexpr int WARPS = 4;            // warps per CTA of R4: output rows in flight
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// sum_{g < groups} sum_{b < B} M[(g * B + a) * B + b] * f[g * B + b]: output
// row a of ``groups`` row-major (B, B) matrices stacked at M, against the
// ``groups`` vectors of B floats at f, both in shared memory.  The lanes of
// the calling warp split the groups * B products (lane l takes t = l, l +
// 32, ...; one fmaf chain each), then warp_sum; every lane returns the sum.
// The first R1 and R2 read M through __ldg in the same order, so their
// results are kept bit for bit.  kB > 0: B known at compile time (the loop
// unrolled, the division by B a multiply); 0: any B.
template <int kB>
__device__ __forceinline__ float smem_rows_dot(const float* M, const float* f, int groups,
                                               int a, int B_any, int lane) {
    const int n = kB > 0 ? kB : B_any;
    float acc = 0.f;
#pragma unroll
    for (int t = lane; t < groups * n; t += 32) {
        const int g = t / n;
        acc = fmaf(M[(g * n + a) * n + (t - g * n)], f[t], acc);
    }
    return warp_sum(acc);
}

// Stage the fields slots 0..4 of cell (j, i) read into fld (5, B): slot 0
// the cell's own vector, 1 / 2 its i-neighbors (circular), 3 / 4 its
// j-neighbors (zero outside the grid) -- rolled.neighbor_fields; with a
// ``base``, the cell's B elements of it after them (fld + 5 B).  One element
// per thread where B allows, so every load is in flight at once.
__device__ __forceinline__ void stage_fields(float* fld, const float* __restrict__ x,
                                             const float* __restrict__ base, int j, int i,
                                             int Nj, int Ni, int B) {
    const int il = (i == 0) ? Ni - 1 : i - 1;
    const int ir = (i == Ni - 1) ? 0 : i + 1;
    const size_t v0 = ((size_t)j * Ni + i) * B;
    for (int t = threadIdx.x; t < (base ? 6 : 5) * B; t += blockDim.x) {
        const int s = t / B;
        const int b = t - s * B;
        int jj = j, ii = i;
        if (s == 1) ii = il;
        else if (s == 2) ii = ir;
        else if (s == 3) jj = j - 1;
        else if (s == 4) jj = j + 1;
        fld[t] = s == 5 ? base[v0 + b]
               : (jj < 0 || jj >= Nj) ? 0.f : x[((size_t)jj * Ni + ii) * B + b];
    }
}

// R1: one color of the masked red-black sweep, out of place:
//   out[j, i] = (base[j, i] +) Dinv[j, i] (rhs[j, i] - sum_{s=1..4} A[j, i, s] nbr_s(u))
// for the cells with (i + j) % 2 == color, and (base +) u elsewhere.  Every
// neighbor is read from the pre-update u, as the masked sweep does: with an
// odd Ni the two cells across the row's wrap have one color and read each
// other, so an in-place update would race.
//
// What bounds it: a half-sweep reads the active cells' four off-diagonal
// blocks and Dinv, 5 B^2 floats a cell (53 MB at 64x64 p5, bound 16.3 us).
// The first R1 ran a CTA per cell of either color (half of them only
// copied) and each warp walked its output rows with at most 5 loads a lane
// in flight, 27% of the bound at 64x64.  Here:
//   - the grid is the active color's cells only, CTA k its k-th cell in row
//     order (cell_of); CTA k also copies the other color's cells k, k +
//     grid, ... (odd Ni gives the colors unequal counts; a 1x1 level has no
//     cell of color 1, and its one CTA only copies);
//   - in a cell's rolled blocks slots 1..4 are one contiguous run of 4 B^2
//     floats and Dinv another of B^2, so one thread stages both in shared
//     memory by two bulk copies (cp.async.bulk, the TMA's 1-D form) that
//     complete on an mbarrier, every byte of the cell in flight at once,
//     while the other threads stage the four neighbor fields, rhs and base,
//     and copy the other color's cells;
//   - then each warp takes output rows a = warp, warp + warps, ... and
//     reduces them from shared memory (smem_rows_dot).  A CTA has 8
//     warps where the card holds every CTA of the launch at once that way,
//     else 4, else 2, else whichever holds the most (cell_warps): on the small
//     grids more warps shorten each CTA's row loop, on the large grids of
//     small cells (B 4 and 16 at 64x64: 2,048 CTAs) smaller CTAs let the
//     whole launch be resident in one wave.  (B 36 cells are bounded by
//     their 27 KB of shared memory, 8 CTAs an SM, whatever the warps.)
// A bulk copy needs 16-byte addresses and sizes: B^2 % 4 == 0 and 16-byte
// aligned blocks and Dinv (B 36, 16 and 4, the p5/p3/p1 levels).  Other B (B
// 9, the p2 levels: a 324-byte Dinv) stage the same shared memory by 4-byte
// cp.async copies instead; the launcher picks the body by that shape rule.
// (Staging B 36 and 16 by cp.async as well ran 15% and 20% slower on an
// H100, in a graph at 64x64, so the bulk copies stay where they can.)
// The sums are smem_rows_dot's, in the first R1's order, so the results are the
// same bit for bit.
constexpr int R1_WARPS = 8;   // warps per CTA at most

// (j, i) of the k-th cell of ``color`` in row order: each pair of rows
// (2p, 2p + 1) holds Ni cells of each color, ceil((Ni - color) / 2) of them
// in row 2p.
__device__ __forceinline__ void cell_of(int k, int color, int Ni, int* j, int* i) {
    const int p = k / Ni, r = k - p * Ni;
    const int n0 = (Ni - color + 1) >> 1;
    if (r < n0) {
        *j = 2 * p;
        *i = color + 2 * r;
    } else {
        *j = 2 * p + 1;
        *i = 1 - color + 2 * (r - n0);
    }
}

// How many cells of ``color`` an (Nj, Ni) grid has.
inline int cells_of(int color, int Nj, int Ni) {
    return (Nj / 2) * Ni + (Nj % 2) * ((Ni - color + 1) / 2);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One bulk copy of ``bytes`` (a multiple of 16, both addresses 16-byte
// aligned) from device memory to this CTA's shared memory, completing on
// the mbarrier ``bar``.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
        "r"(smem_addr(bar))
        : "memory");
}

// An mbarrier in shared memory for one arrival a phase (one thread calls
// it; the CTA's barrier before any wait makes it visible).
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The arrival of the current phase of ``bar``, which completes once
// ``bytes`` have landed by the bulk copies issued after it.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of ``bar`` with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    unsigned done = 0;
    while (!done)
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// kB > 0: B known at compile time; kW > 0: the CTA's warps, else blockDim.
template <int kB, bool kBulk, int kW>
__global__ void __launch_bounds__(32 * (kW > 0 ? kW : R1_WARPS))
half_sweep_kernel(const float* __restrict__ blocks, const float* __restrict__ dinv,
                  const float* __restrict__ rhs, const float* __restrict__ u,
                  const float* __restrict__ base, float* __restrict__ out, int color,
                  int Nj, int Ni, int B_any, int accumulate, int n_active, int n_other) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int B = kB > 0 ? kB : B_any;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);          // 16 bytes
    float* blk = reinterpret_cast<float*>(smem + 16);          // (4, B, B): slots 1..4
    float* dv = blk + 4 * B * B;                               // (B, B)
    float* fld = dv + B * B;                                   // (4, B): the fields
    float* r = fld + 4 * B;                                    // (B): rhs
    float* bs = r + B;                                         // (B): base
    float* t = bs + B;                                         // (B): rhs - off
    const int tid = threadIdx.x, nt = blockDim.x;
    const bool active = blockIdx.x < n_active;
    int j = 0, i = 0;
    size_t v0 = 0;
    if (active) {
        cell_of(blockIdx.x, color, Ni, &j, &i);
        const size_t cell = (size_t)j * Ni + i;
        v0 = cell * B;
        const float* src = blocks + (cell * 5 + 1) * B * B;
        const float* src_d = dinv + cell * B * B;
        if constexpr (kBulk) {
            if (tid == 0) {
                mbar_init(bar);
                mbar_expect(bar, 5u * B * B * sizeof(float));
                bulk_copy(blk, src, 4u * B * B * sizeof(float), bar);
                bulk_copy(dv, src_d, (unsigned)(B * B * sizeof(float)), bar);
            }
        } else {
            for (int e = tid; e < 4 * B * B; e += nt) cp_async4(blk + e, src + e);
            for (int e = tid; e < B * B; e += nt) cp_async4(dv + e, src_d + e);
        }
        // the fields (rolled.neighbor_fields: i circular, j zero outside),
        // rhs and base, one element per thread where B allows
        const int il = (i == 0) ? Ni - 1 : i - 1;
        const int ir = (i == Ni - 1) ? 0 : i + 1;
        for (int e = tid; e < (accumulate ? 6 : 5) * B; e += nt) {
            float v;
            if (e < 4 * B) {
                const int s = e / B, b = e - s * B;
                int jj = j, ii = i;
                if (s == 0) ii = il;
                else if (s == 1) ii = ir;
                else if (s == 2) jj = j - 1;
                else jj = j + 1;
                v = (jj < 0 || jj >= Nj) ? 0.f : u[((size_t)jj * Ni + ii) * B + b];
            } else {
                v = (e < 5 * B ? rhs : base)[v0 + (e - 4 * B) % B];
            }
            fld[e] = v;   // fld, r and bs are consecutive
        }
    }
    // the other color's cells: out = (base +) u
    for (int k = blockIdx.x; k < n_other; k += gridDim.x) {
        int jo, io;
        cell_of(k, 1 - color, Ni, &jo, &io);
        const size_t w0 = ((size_t)jo * Ni + io) * B;
        for (int b = tid; b < B; b += nt)
            out[w0 + b] = accumulate ? base[w0 + b] + u[w0 + b] : u[w0 + b];
    }
    if (!active) return;
    if constexpr (!kBulk) cp_async_wait_all();
    __syncthreads();
    if constexpr (kBulk) mbar_wait(bar, 0);
    const int warp = tid >> 5, lane = tid & 31, warps = kW > 0 ? kW : nt >> 5;
    for (int a = warp; a < B; a += warps) {
        const float acc = smem_rows_dot<kB>(blk, fld, 4, a, B, lane);
        if (lane == 0) t[a] = r[a] - acc;
    }
    __syncthreads();
    for (int a = warp; a < B; a += warps) {
        const float acc = smem_rows_dot<kB>(dv, t, 1, a, B, lane);
        if (lane == 0) out[v0 + a] = accumulate ? bs[a] + acc : acc;
    }
}

using R1Body = decltype(&half_sweep_kernel<0, true, 0>);

// R1's body with ``warps`` warps: the bulk copy or the 4-byte staging, B
// and the warps compiled in for the port's levels (p5, p3, p2, p1).
template <int kB, bool kBulk>
R1Body r1_body_of(int warps) {
    if constexpr (kB == 0) return &half_sweep_kernel<0, kBulk, 0>;
    else
        return warps == 8 ? &half_sweep_kernel<kB, kBulk, 8>
             : warps == 4 ? &half_sweep_kernel<kB, kBulk, 4>
                          : &half_sweep_kernel<kB, kBulk, 2>;
}

// R1's bodies for B, by warps.
R1Body (*r1_bodies(int B, bool bulk))(int) {
    if (bulk) {
        if (B == 36) return &r1_body_of<36, true>;
        if (B == 16) return &r1_body_of<16, true>;
        if (B == 4) return &r1_body_of<4, true>;
        return &r1_body_of<0, true>;
    }
    if (B == 9) return &r1_body_of<9, false>;
    return &r1_body_of<0, false>;
}

// The warps per CTA of R1 and R2 for ``n`` CTAs of ``smem`` bytes, a cell
// each (R1's note): the most of 8, 4 and 2 with which the card holds every
// CTA of the launch at once, else whichever holds the most CTAs.
// ``body_of(w)`` is the kernel with w warps.  Found once per (kernel, n,
// smem) and kept, so only a first launch asks the card.  Past 48 KB the body
// opts in to its shared memory first.
template <typename Body>
cudaError_t cell_warps(Body (*body_of)(int), size_t smem, int n, int* warps) {
    static std::mutex mu;
    static std::map<std::tuple<const void*, int, size_t>, int> found;
    const std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple((const void*)body_of(R1_WARPS), n, smem);
    const auto it = found.find(key);
    if (it != found.end()) {
        *warps = it->second;
        return cudaSuccess;
    }
    const int sms = sm_count();
    if (sms == 0) return cudaErrorNoDevice;
    int best = 0, best_ctas = -1;
    for (int w = R1_WARPS; w >= 2; w /= 2) {
        const Body body = body_of(w);
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                (const void*)body, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return e;
        }
        int per_sm = 0;
        const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, (const void*)body, 32 * w, smem);
        if (e != cudaSuccess) return e;
        if (per_sm * sms >= n) {     // every CTA resident at once
            best = w;
            break;
        }
        if (per_sm * sms > best_ctas) {
            best = w;
            best_ctas = per_sm * sms;
        }
    }
    if (best == 0) return cudaErrorInvalidConfiguration;
    found.emplace(key, best);
    *warps = best;
    return cudaSuccess;
}

// R2: out[j, i] = (base[j, i] +) sign * sum_{s=0..4} A[j, i, s] nbr_s(x) over
// all cells (slot 0 is the cell itself): rolled.matvec, and the residual
// with base = rhs, sign = -1 (PallasVCycle._residual, pallas_vcycle.py:180-187).
//
// What bounds it: a call reads every cell's five blocks, 5 B^2 floats a cell
// in one contiguous run at (cell * 5) B^2 (106 MB at 64x64 p5, bound 32.2
// us).  The first R2 was the first R1's body: a CTA per cell of 4 warps that
// staged only the fields, each warp reducing 9 of the 36 rows with its block
// elements loaded through __ldg inside the chain, ~6 loads a lane in flight
// (36% of the bound at 64x64).  Here it takes R1's cell (R1's note):
//   - a CTA per cell; one thread bulk-copies the cell's five blocks, the one
//     run of 5 B^2 floats, into shared memory (cp.async.bulk on an
//     mbarrier), every byte of the cell in flight at once, while the other
//     threads stage the five fields (i circular, j zero outside) and base;
//   - then each warp reduces its output rows a = warp, warp + warps, ...
//     from shared memory (smem_rows_dot: the first R2's lane split and
//     order of sums, then sign *, then base +), so the results are the same
//     bit for bit;
//   - R1's shape rule and warps: the bulk copy where B^2 % 4 == 0 and the
//     blocks are 16-byte aligned (B 36, 16 and 4), 4-byte cp.async
//     otherwise (B 9: a 1,620-byte cell); 8, 4 or 2 warps, the most with
//     which the whole launch is resident (cell_warps).
// A persistent grid instead (each resident CTA walking cells k, k + grid, ...
// with two shared buffers, the next cell's bulk copy issued before the
// current one's rows) measured slower on an H100 in a graph: 41.5 against
// 40.0 us at 64x64 p5 B 36, 9.5 against 7.6 at B 16 (PERF.md), so it is not
// kept.

// kB > 0: B known at compile time; kW > 0: the CTA's warps, else blockDim.
template <int kB, bool kBulk, int kW>
__global__ void __launch_bounds__(32 * (kW > 0 ? kW : R1_WARPS))
stencil_apply_kernel(const float* __restrict__ blocks, const float* __restrict__ x,
                     const float* __restrict__ base, float* __restrict__ out, int Nj,
                     int Ni, int B_any, float sign, int accumulate) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int B = kB > 0 ? kB : B_any;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);          // 16 bytes
    float* blk = reinterpret_cast<float*>(smem + 16);          // (5, B, B)
    float* fld = blk + 5 * B * B;                              // (5, B) and base (B)
    const int tid = threadIdx.x, nt = blockDim.x;
    const int cell = blockIdx.x;
    const int j = cell / Ni, i = cell - j * Ni;
    const float* src = blocks + (size_t)cell * 5 * B * B;
    if constexpr (kBulk) {
        if (tid == 0) {
            mbar_init(bar);
            mbar_expect(bar, 5u * B * B * sizeof(float));
            bulk_copy(blk, src, 5u * B * B * sizeof(float), bar);
        }
    } else {
        for (int e = tid; e < 5 * B * B; e += nt) cp_async4(blk + e, src + e);
    }
    stage_fields(fld, x, accumulate ? base : nullptr, j, i, Nj, Ni, B);
    if constexpr (!kBulk) cp_async_wait_all();
    __syncthreads();
    if constexpr (kBulk) mbar_wait(bar, 0);
    const int warp = tid >> 5, lane = tid & 31, warps = kW > 0 ? kW : nt >> 5;
    const size_t v0 = (size_t)cell * B;
    for (int a = warp; a < B; a += warps) {
        const float y = sign * smem_rows_dot<kB>(blk, fld, 5, a, B, lane);
        if (lane == 0) out[v0 + a] = accumulate ? fld[5 * B + a] + y : y;
    }
}

using R2Body = decltype(&stencil_apply_kernel<0, true, 0>);

// R2's body with ``warps`` warps, as R1's (r1_body_of).
template <int kB, bool kBulk>
R2Body r2_body_of(int warps) {
    if constexpr (kB == 0) return &stencil_apply_kernel<0, kBulk, 0>;
    else
        return warps == 8 ? &stencil_apply_kernel<kB, kBulk, 8>
             : warps == 4 ? &stencil_apply_kernel<kB, kBulk, 4>
                          : &stencil_apply_kernel<kB, kBulk, 2>;
}

// R2's bodies for B, by warps (R1's shape rule).
R2Body (*r2_bodies(int B, bool bulk))(int) {
    if (bulk) {
        if (B == 36) return &r2_body_of<36, true>;
        if (B == 16) return &r2_body_of<16, true>;
        if (B == 4) return &r2_body_of<4, true>;
        return &r2_body_of<0, true>;
    }
    if (B == 9) return &r2_body_of<9, false>;
    return &r2_body_of<0, false>;
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
    const int n_active = cells_of(color, Nj, Ni), n_other = cells_of(1 - color, Nj, Ni);
    const size_t smem = 16 + (size_t)(5 * B * B + 7 * B) * sizeof(float);
    const bool bulk = (B * B) % 4 == 0 && reinterpret_cast<uintptr_t>(blocks) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(dinv) % 16 == 0;
    const auto body_of = r1_bodies(B, bulk);
    int warps = 0;
    const cudaError_t e = cell_warps(body_of, smem, std::max(n_active, 1), &warps);
    if (e != cudaSuccess) return (int)e;
    const R1Body kernel = body_of(warps);
    kernel<<<std::max(n_active, 1), 32 * warps, smem, stream>>>(
        blocks, dinv, rhs, u, base, out, color, Nj, Ni, B, accumulate, n_active, n_other);
    return (int)cudaGetLastError();
}

int rolled_stencil_apply(const float* blocks, const float* x, const float* base,
                         float* out, int Nj, int Ni, int B, float sign, int accumulate,
                         cudaStream_t stream) {
    const int n = Nj * Ni;
    const bool bulk = (B * B) % 4 == 0 && reinterpret_cast<uintptr_t>(blocks) % 16 == 0;
    const size_t smem = 16 + (size_t)(5 * B * B + 6 * B) * sizeof(float);
    const auto body_of = r2_bodies(B, bulk);
    int warps = 0;
    const cudaError_t e = cell_warps(body_of, smem, n, &warps);
    if (e != cudaSuccess) return (int)e;
    const R2Body kernel = body_of(warps);
    kernel<<<n, 32 * warps, smem, stream>>>(
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
