// Hopper kernels for the SoA (cells-in-lanes) multigrid cycles.
//
// They replace the Pallas TPU kernels of dgtpu's mixed-precision routes:
// SoAVCycle.build (Poisson; dgtpu/ops/pallas_soa.py:556-592, pallas_call at
// :574), SoAStokesVCycle.build (Stokes distributive GS;
// dgtpu/ops/pallas_stokes.py:716-759, pallas_call at :739) and the four
// methods of StreamedLevel, the streamed hybrids' per-level kernels
// (dgtpu/ops/pallas_stream.py: half_sweeps :315, residual :376, matvec :435,
// matvec_color :496).  Each fused TPU kernel keeps the whole hierarchy in
// VMEM and runs a cycle in one launch.  One H100 SM has 227 KB of shared
// memory and even the 8x8 p=5 hierarchy is ~2 MB, so here a cycle is split
// into phase kernels that read their operands from device memory; the
// host-side recursions in dgtpu_torch/ops/soa.py (SoAVCycle._cycle),
// ops/stokes_soa.py (SoAStokesVCycle._cycle), ops/stream.py
// (StreamedVCycle._cycle) and ops/stokes_stream.py
// (StreamedStokesVCycle._cycle) launch them in order on PyTorch's current
// stream:
//
//   K1 half_sweep       one red-black block-GS half-sweep (_soa_smooth body;
//                       the Stokes _bgs_A on the momentum blocks)
//   K3 small_gemm       polynomial R/P, u += P e, the dense coarse inverse
//   K4 geo_transfer     2x2 geometric agglomeration R/P
//   K5 stencil_apply    base + sign (blk_c[0] x_c + sum_s blk_c[s] nbr_s(x_{1-c}))
//                       with rectangular float32 or bfloat16 blocks: the
//                       Poisson residual (_soa_residual and
//                       StreamedLevel.residual, base = rhs, sign = -1), every
//                       stencil matvec of the DGS sweep, the saddle residual,
//                       StreamedLevel.matvec and both build_matvec
//   K6 dg_half_sweep    one color of the Stokes pressure pass (_bgs_dg,
//                       pallas_stokes.py:382-390) given g = G p from K5; in
//                       the streamed hybrid it is the whole composition
//                       matvec_color(D) + the two DG-diagonal MACs
//                       (pallas_stokes_stream.py:109-113)
//   K7 multi_half_sweep all n half-sweeps of one smoother application
//                       (StreamedLevel.half_sweeps) in one cooperative launch,
//                       float32 or bfloat16 blocks
//
// Layout (the TPU kernels'): a color-pair vector is (2, B, C) with C =
// Nj * Ni/2 cells per color in the contiguous axis; operator blocks per color
// are (5, B_src, B_dst, C), diagonal matrices (B_src, B_dst, C).  Cells on the
// fast axis make every block read coalesced: for fixed (slot, b_src, b_dst) a
// warp reads 32 consecutive cells.
//
// What bounds them on the card: at 8x8 (C = 32 on the finest level) a kernel
// is one or two CTAs (K5 spreads its output modes over up to Bd CTAs per
// color, below) and a cycle is ~90 (Poisson p5) to ~800 (Stokes
// W-cycle) launches, so launched eagerly the host's launch rate bounds the
// cycle; the mixed route therefore replays each cycle as one captured CUDA
// graph (dgtpu_torch/ops/graphs.py), where launch latency does; at 64x64 p5
// (C = 2048) K1, K5 and K7 stream the finest level's blocks (53 MB per
// float32 half-sweep, 26.5 MB in bfloat16), so device-memory bytes bound
// them.  K7 exists for the second case: it runs a whole smoother
// application in one launch, and with bfloat16 blocks it halves the bytes.
//
// Every entry point is extern "C" (bound with ctypes), takes raw device
// pointers the caller allocated, launches on the given stream without
// synchronising, and returns cudaGetLastError() (or the launch's own error)
// as an int.  ``accumulate`` selects ``out = base + result`` (base may be
// null otherwise).

#include <algorithm>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TC = 32;  // cells per tile: one warp spans 32 consecutive cells

// Block elements are stored as float or bfloat16 and upconverted per MAC,
// as dgtpu's _mac does; state and accumulators are float.
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// The same through the read-only data path (ld.global.nc).
__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const __nv_bfloat16* p) {
    return __bfloat162float(
        __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ int wrap(int x, int C) {
    x %= C;
    return x < 0 ? x + C : x;
}

// Lane of the opposite color's lattice that neighbor ``slot`` (0 iL, 1 iR,
// 2 jL, 3 jR) of cell q (of ``color``) reads: the index form of
// SoAVCycle._nbr_fields (pallas_soa.py:312-331) and
// SoAStokesVCycle._nbr_fields (pallas_stokes.py:326-341).  i-neighbors are
// -/+1 lanes selected by the row parity, j-neighbors -/+nh lanes; every
// index wraps mod C like jnp.roll, and wrapped reads land on zero boundary
// blocks.  On an O-grid the row-start / row-end cells take the two-roll
// blend instead.
__device__ __forceinline__ int nbr_lane(int q, int slot, int color, int C,
                                        int nh, int periodic) {
    const int j = q / nh;
    const int ip = q - j * nh;
    const bool even = (j % 2) == 0;
    if (slot == 2) return wrap(q - nh, C);
    if (slot == 3) return wrap(q + nh, C);
    const int rp = (periodic && ip == 0) ? q + nh - 1 : q - 1;
    const int rm = (periodic && ip == nh - 1) ? q - nh + 1 : q + 1;
    int lane;
    if (color == 0)
        lane = (slot == 0) ? (even ? rp : q) : (even ? q : rm);
    else
        lane = (slot == 0) ? (even ? q : rp) : (even ? rm : q);
    return wrap(lane, C);
}

// (color, packed lane) of cell (j, i) under the color split with nh cells
// per packed row: _packed_pos (pallas_soa.py:49-53).
__device__ __forceinline__ void packed_pos(int j, int i, int nh, int* c, int* q) {
    const int cc = (i + j) % 2;
    const int ip = (cc == 0) ? (i - (j % 2)) / 2 : (i - 1 + (j % 2)) / 2;
    *c = cc;
    *q = j * nh + ip;
}

// Stage the five fields a stencil row of ``color`` reads into shared memory:
// slot 0 the color's own lattice at lane q, slots 1..4 the opposite lattice
// at the neighbor lanes.  fld is (5, B, TC).
__device__ __forceinline__ void stage_fields(float* fld, const float* x, int color,
                                             int B, int C, int q, int tx, int ty,
                                             int ny, int nh, int periodic) {
    const size_t BC = (size_t)B * C;
    const float* own = x + (size_t)color * BC;
    const float* o = x + (size_t)(1 - color) * BC;
    for (int b = ty; b < B; b += ny)
        fld[b * TC + tx] = own[(size_t)b * C + q];
    for (int s = 0; s < 4; ++s) {
        const int lane = nbr_lane(q, s, color, C, nh, periodic);
        for (int b = ty; b < B; b += ny)
            fld[((s + 1) * B + b) * TC + tx] = o[(size_t)b * C + lane];
    }
}

// sum_{s >= s0} sum_b blk[s][b][a] * fld[s][b] for cell q: one output mode
// of the stencil row.  blk is one color's (5, Bs, Bd, C) of storage type T,
// read through the read-only path when kLdg.
template <bool kLdg = false, typename T>
__device__ __forceinline__ float stencil_row(const T* __restrict__ blk,
                                             const float* fld, int s0, int a, int Bs,
                                             int Bd, int C, int q, int tx) {
    const size_t slot = (size_t)Bs * Bd * C;
    float acc = 0.f;
    for (int s = s0; s < 5; ++s) {
        const T* A = blk + (size_t)s * slot;
        const float* f = fld + s * Bs * TC + tx;
        for (int b = 0; b < Bs; ++b) {
            const T* e = A + ((size_t)b * Bd + a) * C + q;
            acc = fmaf(kLdg ? ldg_f(e) : to_f(*e), f[b * TC], acc);
        }
    }
    return acc;
}

// The red-black half-sweep on one tile of TC cells, shared by K1 and K7:
//   out_c[:, q] = (base_c +) Dinv_c (rhs_c - sum_{s=1..4} blk_c[s] nbr_s(o))
// for the cells q of tile ``tile`` of ``color`` (_soa_smooth body,
// pallas_soa.py:341-353; StreamedLevel.half_sweeps, pallas_stream.py:283-300).
// o (B, C) is the opposite color's lattice, null for a zero one (then t =
// rhs and the blocks are not read); blk_c (5, B, B, C, slot 0 not read) and
// dinv_c (B, B, C) are one color's, of storage type T.  The CTA stages the
// neighbor fields of its cells in shared memory fld (5, B, TC), then t = rhs
// - off in place of slot 0, then applies Dinv, so each cell's B modes are
// gathered once and every block element is read once.  kShared: o is
// written by other CTAs of the same (cooperative) launch between calls, so
// it is read through L2 (__ldcg), and the blocks by plain loads; otherwise
// o by plain loads and the blocks through the read-only path.  Each caller
// runs faster with its own choice than with the other's on the H100
// (PERF.md).  Every thread of the CTA calls it; it ends with the tile's
// shared memory free again.
template <typename T, bool kShared>
__device__ __forceinline__ void half_sweep_tile(
        const T* __restrict__ blk_c, const T* __restrict__ dinv_c,
        const float* __restrict__ rhs_c, const float* o, const float* base_c,
        float* out_c, float* fld, int tile, int color, int B, int C, int nh,
        int periodic) {
    const int tx = threadIdx.x, ty = threadIdx.y, ny = blockDim.y;
    const int q = tile * TC + tx;
    const bool valid = q < C;
    if (valid && o) {
        for (int s = 0; s < 4; ++s) {
            const int lane = nbr_lane(q, s, color, C, nh, periodic);
            for (int b = ty; b < B; b += ny) {
                const float* p = o + (size_t)b * C + lane;
                fld[((s + 1) * B + b) * TC + tx] = kShared ? __ldcg(p) : *p;
            }
        }
    }
    __syncthreads();
    if (valid)
        for (int a = ty; a < B; a += ny)
            fld[a * TC + tx] = rhs_c[(size_t)a * C + q]
                             - (o ? stencil_row<!kShared>(blk_c, fld, 1, a, B, B, C, q, tx)
                                  : 0.f);
    __syncthreads();
    if (valid)
        for (int a = ty; a < B; a += ny) {
            float acc = 0.f;
            for (int b = 0; b < B; ++b) {
                const T* e = dinv_c + ((size_t)b * B + a) * C + q;
                acc = fmaf(kShared ? to_f(*e) : ldg_f(e), fld[b * TC + tx], acc);
            }
            const size_t i = (size_t)a * C + q;
            out_c[i] = base_c ? base_c[i] + acc : acc;
        }
    __syncthreads();
}

// K1: one red-black half-sweep, float32 blocks:
//   out[color]   = (base[color] +)   Dinv_c . (rhs_c - sum_{s=1..4} A_c[s] . nbr_s(u[1-color]))
//   out[1-color] = (base[1-color] +) u[1-color]
// One CTA per tile of TC cells x blockDim.y output-mode lanes.  ``base``
// folds the Stokes sweep's uv + du_s into the last half-sweep.
__global__ void half_sweep_kernel(const float* __restrict__ blocks,
                                  const float* __restrict__ dinv,
                                  const float* __restrict__ rhs,
                                  const float* __restrict__ u,
                                  const float* __restrict__ base,
                                  float* __restrict__ out,
                                  int color, int B, int C, int nh, int periodic,
                                  int accumulate) {
    extern __shared__ float fld[];   // (5, B, TC)
    const size_t BC = (size_t)B * C;
    const size_t oc = (size_t)(1 - color) * BC;
    half_sweep_tile<float, false>(blocks, dinv, rhs, u + oc,
                           accumulate ? base + (size_t)color * BC : nullptr,
                           out + (size_t)color * BC, fld, blockIdx.x, color, B, C,
                           nh, periodic);
    const int q = blockIdx.x * TC + threadIdx.x;
    if (q >= C) return;
    for (int a = threadIdx.y; a < B; a += blockDim.y) {
        const size_t i = oc + (size_t)a * C + q;
        out[i] = accumulate ? base[i] + u[i] : u[i];
    }
}

// K7: n_half red-black half-sweeps (colors 0, 1, 0, 1, ...) in one
// cooperative launch, the whole of StreamedLevel.half_sweeps(n_half)
// (pallas_stream.py:234-345):
//   h even: out[0] = Dinv_0 (rhs_0 - off_0(state[1]));  h odd: out[1] likewise
// with state[1] = u[1] (zero when u is null) before the first half-sweep, and
// out (+ base) at the end.  blocks / dinv are per-color operands of storage
// type T with color strides blk_cs / dinv_cs elements (the float32 SoA
// packing, or one bfloat16 [Dinv, iL, iR, jL, jR] tensor).  A persistent grid
// of at most the co-resident CTA count strides over the tiles;
// half-sweep h reads only the color h-1 wrote, so one grid-wide barrier per
// half-sweep is the whole dependency.  With a base, color 0 takes its base
// after one more barrier (the last half-sweep reads it); color 1 in the last
// half-sweep.  Each CTA owns the same tiles in every half-sweep.
template <typename T>
__global__ void multi_half_sweep_kernel(const T* __restrict__ blocks,
                                        const T* __restrict__ dinv,
                                        long long blk_cs, long long dinv_cs,
                                        const float* __restrict__ rhs,
                                        const float* __restrict__ u,
                                        const float* __restrict__ base,
                                        float* out, int n_half, int B, int C, int nh,
                                        int periodic) {
    extern __shared__ float fld[];   // (5, B, TC)
    cg::grid_group grid = cg::this_grid();
    const size_t BC = (size_t)B * C;
    const int n_tiles = (C + TC - 1) / TC;
    for (int h = 0; h < n_half; ++h) {
        const int color = h & 1;
        const size_t oc = (size_t)(1 - color) * BC;
        const float* o = h > 0 ? out + oc : (u ? u + oc : nullptr);
        const float* b = (base && h == n_half - 1) ? base + (size_t)color * BC : nullptr;
        for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
            half_sweep_tile<T, true>(blocks + color * blk_cs, dinv + color * dinv_cs,
                               rhs + (size_t)color * BC, o, b, out + (size_t)color * BC,
                               fld, tile, color, B, C, nh, periodic);
        if (h + 1 < n_half || base) grid.sync();
    }
    if (!base) return;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int q = tile * TC + threadIdx.x;
        if (q < C)
            for (int a = threadIdx.y; a < B; a += blockDim.y)
                out[(size_t)a * C + q] += base[(size_t)a * C + q];
    }
}

// K3: out[z] = (base[z] +) W(M,K) . x[z](K,N) for z < batch, the small
// dense products of both SoA cycles: the polynomial restriction and
// prolongation (pallas_soa.py:364-372, :382-390; pallas_stokes.py:436-486,
// per component; W = R (B_c, B) or P (B, B_c), N = C, batch = the two
// colors, M, K <= 36), the u += P.e update (accumulate), and the dense
// coarse inverse (pallas_soa.py:400-410, pallas_stokes.py:490-505; M = K =
// the coarse unknowns, N = 1).  Its work is a few KB: launched eagerly, the
// host's launch path bounds it; replayed in a CUDA graph (ops/graphs.py),
// the launch latency does.  So each shape gets the body that reads every
// byte once, coalesced, in as few CTAs and passes as it can:
//
//   small_gemm_tile_kernel (N > 1)  one CTA per 32-column tile of x, batch
//       entry and block of 8 output rows, one output per thread: the CTA's
//       rows of W and the (K, 32) tile of x are staged in shared memory by
//       coalesced loads while each thread fetches its base element, so the
//       kernel waits on device memory once; then each thread reduces its
//       output from shared memory (W as a broadcast) and folds base into the
//       store.  One output per thread keeps the chain of dependent
//       multiply-adds K long (a thread of 8 rows per CTA took M / 8 of them
//       at M = 36).  Sums run k = 0..K-1, the plain version's order.
//   dense_rows_kernel (N = 1)  one warp per output row: the lanes read the
//       row of W coalesced, in 16-byte loads when K % 4 == 0 and W is
//       16-byte aligned, against x staged once per CTA in shared memory,
//       and reduce by shuffles.
constexpr int GEMM_ROWS = 8;     // thread rows of a tile CTA
constexpr int DENSE_WARPS = 8;   // output rows of a dense CTA

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__global__ void small_gemm_tile_kernel(const float* __restrict__ W,
                                       const float* __restrict__ x,
                                       const float* __restrict__ base,
                                       float* __restrict__ out,
                                       int M, int K, int N, int accumulate) {
    extern __shared__ float sm[];
    float* w = sm;                       // (GEMM_ROWS, K): this CTA's rows of W
    float* xt = sm + GEMM_ROWS * K;      // (K, TC)
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int n = blockIdx.x * TC + tx;
    const int z = blockIdx.y;
    const int m0 = blockIdx.z * GEMM_ROWS, m = m0 + ty;
    const bool valid = n < N && m < M;
    const size_t o = (size_t)z * M * N + (size_t)m * N + n;
    const float b = (valid && accumulate) ? base[o] : 0.f;
    const float* xz = x + (size_t)z * K * N;
    const int rows = min(GEMM_ROWS, M - m0);
    for (int i = ty * TC + tx; i < rows * K; i += TC * GEMM_ROWS)
        w[i] = W[(size_t)m0 * K + i];
    if (n < N)
        for (int k = ty; k < K; k += GEMM_ROWS) xt[k * TC + tx] = xz[(size_t)k * N + n];
    __syncthreads();
    if (!valid) return;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(w[ty * K + k], xt[k * TC + tx], acc);
    out[o] = accumulate ? b + acc : acc;
}

__global__ void dense_rows_kernel(const float* __restrict__ W,
                                  const float* __restrict__ x,
                                  const float* __restrict__ base,
                                  float* __restrict__ out,
                                  int M, int K, int accumulate, int vec4) {
    extern __shared__ float xs[];    // (K)
    const int z = blockIdx.y;
    const float* xz = x + (size_t)z * K;
    for (int k = threadIdx.x; k < K; k += blockDim.x) xs[k] = xz[k];
    __syncthreads();
    const int m = blockIdx.x * DENSE_WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (m >= M) return;
    const float* row = W + (size_t)m * K;
    float acc = 0.f;
    if (vec4) {
        const float4* r4 = reinterpret_cast<const float4*>(row);
        const float4* x4 = reinterpret_cast<const float4*>(xs);
        for (int k = lane; k < K / 4; k += 32) {
            const float4 a = __ldg(r4 + k), b = x4[k];
            acc = fmaf(a.x, b.x, acc);
            acc = fmaf(a.y, b.y, acc);
            acc = fmaf(a.z, b.z, acc);
            acc = fmaf(a.w, b.w, acc);
        }
    } else {
        for (int k = lane; k < K; k += 32) acc = fmaf(__ldg(row + k), xs[k], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
        const size_t o = (size_t)z * M + m;
        out[o] = accumulate ? base[o] + acc : acc;
    }
}

// K4: the 2x2 geometric agglomeration between a fine level (2 njc, 2 nic)
// and its coarse level (njc, nic), straight from the per-child matrices
// T4 (4, B_out, B_in) (pallas_vcycle.py:132-140) and _packed_pos.  dgtpu
// spells it as dense cross-lane tensors (_geo_tensors, pallas_soa.py:256-284),
// quadratic in the cell count and nearly all zero; here restriction gathers
// each coarse cell's four children and prolongation reads each fine cell's
// one parent.  blockIdx.y is the output color.
//   restrict: out (2, B_c, Cc) = sum_k R4[k] . x_fine[child k]
//   prolong:  out (2, B, Cf)   = (base +) P4[k(p)] . x_coarse[parent(p)]
__global__ void geo_transfer_kernel(const float* __restrict__ T4,
                                    const float* __restrict__ x,
                                    const float* __restrict__ base,
                                    float* __restrict__ out,
                                    int Bout, int Bin, int njc, int nic,
                                    int restrict_, int accumulate) {
    const int tx = threadIdx.x, ty = threadIdx.y, ny = blockDim.y;
    const int oc = blockIdx.y;
    const int nhc = nic / 2, nhf = nic;
    const int Cc = njc * nhc, Cf = 2 * njc * nhf;
    const int q = blockIdx.x * TC + tx;
    if (restrict_) {
        if (q >= Cc) return;
        const int jc = q / nhc, ipc = q - jc * nhc;
        const int ic = (oc == 0) ? 2 * ipc + (jc % 2) : 2 * ipc + 1 - (jc % 2);
        int fc[4], fq[4];
        for (int k = 0; k < 4; ++k)
            packed_pos(2 * jc + (k >> 1), 2 * ic + (k & 1), nhf, &fc[k], &fq[k]);
        for (int a = ty; a < Bout; a += ny) {
            float acc = 0.f;
            for (int k = 0; k < 4; ++k) {
                const float* xf = x + (size_t)fc[k] * Bin * Cf + fq[k];
                const float* Tk = T4 + ((size_t)k * Bout + a) * Bin;
                for (int b = 0; b < Bin; ++b)
                    acc = fmaf(Tk[b], xf[(size_t)b * Cf], acc);
            }
            out[(size_t)oc * Bout * Cc + (size_t)a * Cc + q] = acc;
        }
    } else {
        if (q >= Cf) return;
        const int jf = q / nhf, ipf = q - jf * nhf;
        const int i_f = (oc == 0) ? 2 * ipf + (jf % 2) : 2 * ipf + 1 - (jf % 2);
        const int k = (jf % 2) * 2 + (i_f % 2);
        int pc, pq;
        packed_pos(jf / 2, i_f / 2, nhc, &pc, &pq);
        const float* xc = x + (size_t)pc * Bin * Cc + pq;
        for (int a = ty; a < Bout; a += ny) {
            const float* Tk = T4 + ((size_t)k * Bout + a) * Bin;
            float acc = 0.f;
            for (int b = 0; b < Bin; ++b)
                acc = fmaf(Tk[b], xc[(size_t)b * Cc], acc);
            const size_t o = (size_t)oc * Bout * Cf + (size_t)a * Cf + q;
            out[o] = accumulate ? base[o] + acc : acc;
        }
    }
}

// K5: out_c = (base_c +) sign * (blk_c[0] x_c + sum_s blk_c[s] nbr_s(x_{1-c}))
// for both colors, rectangular blocks (5, Bs, Bd, C) per color of storage
// type T.  Its callers range from C = 2 (a Stokes 2x2 level) to C = 2048
// (64x64 p5) and from Bd = 1 to 36, so one CTA per 32-cell tile (the old
// grid) left the card almost empty: 2 CTAs at 8x8, 128 at 64x64 p5, each
// thread walking ceil(Bd / 8) output modes one after another.  Each output
// is a chain of 5 Bs dependent multiply-adds whose block elements come from
// device memory (or L2), so the kernel is bound by loads in flight, not by
// arithmetic; the grid spreads the output modes over the card:
//
//   grid (cell tiles, 2 colors, output-mode groups), one output per thread:
//   thread (tx, ty) of group g takes cell tile * 32 + tx and output mode
//   a = g * rows + ty.  The warp stays along C, so every block read is one
//   coalesced 128-byte (float32) or 64-byte (bfloat16) load.
//   Rule (stencil_grid): with need = ceil(SMs / (2 tiles)) groups for one
//   CTA per SM, a group takes rows = min(K5_MAX_ROWS, max(1, Bd / need))
//   output modes (rounded down), groups = ceil(Bd / rows), and then the
//   modes are spread evenly, rows = ceil(Bd / groups).  So the grid has at
//   least one CTA per SM wherever Bd >= need (else one CTA per mode and
//   tile), and a CTA at most K5_MAX_ROWS thread rows.  The 8x8 Stokes
//   finest A.uv (Bd 18, C 32) runs 36 CTAs, the 64x64 p5 residual (Bd 36,
//   C 2048) 384 CTAs of 12 rows.
//   A CTA has at least K5_MIN_WARPS warps: all of them stage the fields,
//   the first ``rows`` compute.
//
// Each CTA stages the five fields of its 32 cells (5 Bs TC floats) by
// asynchronous copies (cp.async), all in flight together; each thread
// fetches its base element before the barrier.  The block elements go
// through the read-only path, and for the Bs of the port's levels the b
// loop is unrolled and the slot loop double-buffered: a thread issues slot
// s + 1's Bs loads before slot s's multiply-adds, so about 2 Bs loads are in
// flight and the five slots cost about one round trip (any other Bs takes a
// body unrolled by 8).  The sums keep the old kernel's order (slot 0..4, b
// 0..Bs-1, one fmaf chain per output), so the results are the same bit for
// bit; the slot sum is not split across threads.
constexpr int K5_MAX_ROWS = 16;   // output modes (thread rows) per CTA at most
constexpr int K5_MIN_WARPS = 4;   // warps that stage the fields at least

// ``stage_fields`` by asynchronous copies: the (slot, mode) rows spread over
// the CTA's ny thread rows, one wait at the end.
__device__ __forceinline__ void stage_fields_async(float* fld, const float* __restrict__ x,
                                                   int color, int B, int C, int q, int tx,
                                                   int ty, int ny, int nh, int periodic) {
    const size_t BC = (size_t)B * C;
    const float* own = x + (size_t)color * BC + q;
    const float* o = x + (size_t)(1 - color) * BC;
    for (int b = ty; b < B; b += ny) cp_async4(fld + b * TC + tx, own + (size_t)b * C);
    for (int s = 0; s < 4; ++s) {
        const float* src = o + nbr_lane(q, s, color, C, nh, periodic);
        for (int b = ty; b < B; b += ny)
            cp_async4(fld + ((s + 1) * B + b) * TC + tx, src + (size_t)b * C);
    }
    cp_async_wait_all();
}

// kBs > 0: Bs known at compile time (the b loop fully unrolled, the slots
// double-buffered); 0: any Bs.
template <typename T, int kBs>
__global__ void __launch_bounds__(TC * K5_MAX_ROWS)
stencil_apply_kernel(const T* __restrict__ blocks, const float* __restrict__ x,
                     const float* __restrict__ base, float* __restrict__ out,
                     int Bs_any, int Bd, int C, int nh, int periodic, float sign,
                     int accumulate, int rows) {
    extern __shared__ float fld[];   // (5, Bs, TC)
    const int Bs = kBs > 0 ? kBs : Bs_any;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int color = blockIdx.y;
    const int q = blockIdx.x * TC + tx;
    const int a = blockIdx.z * rows + ty;
    const bool valid = q < C;
    const bool active = valid && ty < rows && a < Bd;
    const size_t o = (size_t)color * Bd * C + (size_t)a * C + q;
    const float b0 = (active && accumulate) ? base[o] : 0.f;
    if (valid)
        stage_fields_async(fld, x, color, Bs, C, q, tx, ty, blockDim.y, nh, periodic);
    __syncthreads();
    if (!active) return;
    const size_t step = (size_t)Bd * C;     // from mode b to b + 1 of one slot
    const T* blk = blocks + (size_t)color * 5 * Bs * step + (size_t)a * C + q;
    float acc = 0.f;
    if constexpr (kBs > 0) {
        float v[kBs], w[kBs];
#pragma unroll
        for (int b = 0; b < kBs; ++b) v[b] = ldg_f(blk + b * step);
#pragma unroll
        for (int s = 0; s < 5; ++s) {
            if (s < 4) {
                const T* A = blk + (size_t)(s + 1) * kBs * step;
#pragma unroll
                for (int b = 0; b < kBs; ++b) w[b] = ldg_f(A + b * step);
            }
            const float* f = fld + s * kBs * TC + tx;
#pragma unroll
            for (int b = 0; b < kBs; ++b) acc = fmaf(v[b], f[b * TC], acc);
            if (s < 4) {
#pragma unroll
                for (int b = 0; b < kBs; ++b) v[b] = w[b];
            }
        }
    } else {
#pragma unroll 1
        for (int s = 0; s < 5; ++s) {
            const T* A = blk + (size_t)s * Bs * step;
            const float* f = fld + s * Bs * TC + tx;
            int b = 0;
            for (; b + 8 <= Bs; b += 8) {
                float v[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) v[u] = ldg_f(A + (b + u) * step);
#pragma unroll
                for (int u = 0; u < 8; ++u) acc = fmaf(v[u], f[(b + u) * TC], acc);
            }
            for (; b < Bs; ++b) acc = fmaf(ldg_f(A + b * step), f[b * TC], acc);
        }
    }
    const float y = sign * acc;
    out[o] = accumulate ? b0 + y : y;
}

// K5's launch geometry for Bd output modes over C cells per color (the rule
// in the note above): grid (tiles, 2, groups), CTA (TC, warps), ``rows``
// output modes per CTA.
struct StencilGrid {
    int tiles, groups, rows, warps;
};

cudaError_t stencil_grid(int Bd, int C, StencilGrid* g) {
    const int sms = sm_count();
    if (sms == 0) return cudaErrorNoDevice;
    if (Bd < 1 || C < 1) return cudaErrorInvalidValue;
    const int tiles = (C + TC - 1) / TC;
    const int need = (sms + 2 * tiles - 1) / (2 * tiles);
    const int rows = std::min(K5_MAX_ROWS, std::max(1, Bd / need));
    const int groups = (Bd + rows - 1) / rows;
    g->tiles = tiles;
    g->rows = (Bd + groups - 1) / groups;
    g->groups = (Bd + g->rows - 1) / g->rows;
    g->warps = std::max(g->rows, K5_MIN_WARPS);
    return cudaSuccess;
}

template <typename T>
int launch_stencil_apply(const void* blocks, const float* x, const float* base,
                         float* out, int Bs, int Bd, int C, int nh, int periodic,
                         float sign, int accumulate, cudaStream_t stream) {
    StencilGrid g;
    cudaError_t e = stencil_grid(Bd, C, &g);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(g.tiles, 2, g.groups), block(TC, g.warps);
    const size_t smem = (size_t)5 * Bs * TC * sizeof(float);
    const T* b = static_cast<const T*>(blocks);
#define K5_LAUNCH(n)                                                                 \
    stencil_apply_kernel<T, n><<<grid, block, smem, stream>>>(                       \
        b, x, base, out, Bs, Bd, C, nh, periodic, sign, accumulate, g.rows)
    switch (Bs) {   // the Bs of the port's levels: p5/p3/p2/p1 Poisson, Stokes
        case 36: K5_LAUNCH(36); break;
        case 18: K5_LAUNCH(18); break;
        case 16: K5_LAUNCH(16); break;
        case 9: K5_LAUNCH(9); break;
        case 8: K5_LAUNCH(8); break;
        case 4: K5_LAUNCH(4); break;
        case 1: K5_LAUNCH(1); break;
        default: K5_LAUNCH(0); break;
    }
#undef K5_LAUNCH
    return (int)cudaGetLastError();
}

// K6: one color of the pressure DG half-pass,
//   out[color]   = (base[color] +)   DG_Dinv_c (rhs_c - (D_c[0] g_c
//                      + sum_s D_c[s] nbr_s(g_{1-c}) - DG_diag_c p_c))
//   out[1-color] = (base[1-color] +) p[1-color]
// D_c is (5, Bu, Np, C); dgd / dgi are (Np, Np, C) in the M^T layout;
// g = G p (2, Bu, C) comes from K5.  The CTA stages g's five fields
// (5 Bu TC floats), then t = rhs - off (Np TC floats), then applies DG_Dinv.
// ``base`` folds the sweep's p + dp into the last half-pass.
__global__ void dg_half_sweep_kernel(const float* __restrict__ D,
                                     const float* __restrict__ dgd,
                                     const float* __restrict__ dgi,
                                     const float* __restrict__ rhs,
                                     const float* __restrict__ g,
                                     const float* __restrict__ p,
                                     const float* __restrict__ base,
                                     float* __restrict__ out,
                                     int color, int Bu, int Np, int C, int nh,
                                     int periodic, int accumulate) {
    extern __shared__ float sm[];
    float* fld = sm;                 // (5, Bu, TC)
    float* t = sm + 5 * Bu * TC;     // (Np, TC)
    const int tx = threadIdx.x, ty = threadIdx.y, ny = blockDim.y;
    const int q = blockIdx.x * TC + tx;
    const bool valid = q < C;
    const size_t PC = (size_t)Np * C;
    const float* pc = p + (size_t)color * PC;
    const float* po = p + (size_t)(1 - color) * PC;
    if (valid)
        stage_fields(fld, g, color, Bu, C, q, tx, ty, ny, nh, periodic);
    __syncthreads();
    if (valid) {
        for (int a = ty; a < Np; a += ny) {
            const float dg = stencil_row(D, fld, 0, a, Bu, Np, C, q, tx);
            float diag = 0.f;
            for (int b = 0; b < Np; ++b)
                diag = fmaf(dgd[((size_t)b * Np + a) * C + q], pc[(size_t)b * C + q], diag);
            t[a * TC + tx] = rhs[(size_t)a * C + q] - (dg - diag);
        }
    }
    __syncthreads();
    if (!valid) return;
    for (int a = ty; a < Np; a += ny) {
        float acc = 0.f;
        for (int b = 0; b < Np; ++b)
            acc = fmaf(dgi[((size_t)b * Np + a) * C + q], t[b * TC + tx], acc);
        const size_t oc = (size_t)color * PC + (size_t)a * C + q;
        const size_t oo = (size_t)(1 - color) * PC + (size_t)a * C + q;
        const float keep = po[(size_t)a * C + q];
        out[oc] = accumulate ? base[oc] + acc : acc;
        out[oo] = accumulate ? base[oo] + keep : keep;
    }
}

inline int mode_lanes(int B) { return B < 8 ? B : 8; }

// CTAs of K7 that can be resident on the card at once for block size B.
template <typename T>
cudaError_t coresident_ctas(int B, int* n) {
    int dev, coop, sms, per_sm;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, multi_half_sweep_kernel<T>, TC * mode_lanes(B),
            (size_t)5 * B * TC * sizeof(float));
    if (e == cudaSuccess) *n = per_sm * sms;
    return e;
}

template <typename T>
int launch_multi_half_sweep(const void* blocks, const void* dinv, long long blk_cs,
                            long long dinv_cs, const float* rhs, const float* u,
                            const float* base, float* out, int n_half, int B, int C,
                            int nh, int periodic, int ctas, cudaStream_t stream) {
    int most = 0;
    cudaError_t e = coresident_ctas<T>(B, &most);
    if (e != cudaSuccess) return (int)e;
    // a grid that cannot be co-resident would deadlock at grid.sync(): refuse
    if (ctas < 1 || ctas > most) return (int)cudaErrorCooperativeLaunchTooLarge;
    const T* b = static_cast<const T*>(blocks);
    const T* d = static_cast<const T*>(dinv);
    void* args[] = {&b, &d, &blk_cs, &dinv_cs, &rhs, &u, &base, &out, &n_half, &B,
                    &C, &nh, &periodic};
    e = cudaLaunchCooperativeKernel((const void*)multi_half_sweep_kernel<T>, dim3(ctas),
                                    dim3(TC, mode_lanes(B)), args,
                                    (size_t)5 * B * TC * sizeof(float), stream);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" {

int soa_half_sweep(const float* blocks_c, const float* dinv_c, const float* rhs_c,
                   const float* u, const float* base, float* out, int color, int B,
                   int C, int nh, int periodic, int accumulate, cudaStream_t stream) {
    dim3 block(TC, mode_lanes(B));
    dim3 grid((C + TC - 1) / TC);
    size_t smem = (size_t)5 * B * TC * sizeof(float);
    half_sweep_kernel<<<grid, block, smem, stream>>>(blocks_c, dinv_c, rhs_c, u, base,
                                                     out, color, B, C, nh, periodic,
                                                     accumulate);
    return (int)cudaGetLastError();
}

int soa_multi_half_sweep(const void* blocks, const void* dinv, long long blk_cs,
                         long long dinv_cs, const float* rhs, const float* u,
                         const float* base, float* out, int n_half, int B, int C, int nh,
                         int periodic, int block_bf16, int ctas, cudaStream_t stream) {
    if (block_bf16)
        return launch_multi_half_sweep<__nv_bfloat16>(blocks, dinv, blk_cs, dinv_cs, rhs,
                                                      u, base, out, n_half, B, C, nh,
                                                      periodic, ctas, stream);
    return launch_multi_half_sweep<float>(blocks, dinv, blk_cs, dinv_cs, rhs, u, base,
                                          out, n_half, B, C, nh, periodic, ctas, stream);
}

int soa_multi_half_sweep_ctas(int B, int block_bf16, int* n) {
    return (int)(block_bf16 ? coresident_ctas<__nv_bfloat16>(B, n)
                            : coresident_ctas<float>(B, n));
}

int soa_small_gemm(const float* W, const float* x, const float* base, float* out,
                   int M, int K, int N, int batch, int accumulate,
                   cudaStream_t stream) {
    if (N == 1) {
        const int vec4 = K % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
        dense_rows_kernel<<<dim3((M + DENSE_WARPS - 1) / DENSE_WARPS, batch),
                            32 * DENSE_WARPS, (size_t)K * sizeof(float), stream>>>(
            W, x, base, out, M, K, accumulate, vec4);
    } else {
        small_gemm_tile_kernel<<<dim3((N + TC - 1) / TC, batch,
                                      (M + GEMM_ROWS - 1) / GEMM_ROWS),
                                 dim3(TC, GEMM_ROWS),
                                 (size_t)(GEMM_ROWS + TC) * K * sizeof(float), stream>>>(
            W, x, base, out, M, K, N, accumulate);
    }
    return (int)cudaGetLastError();
}

int soa_geo_transfer(const float* T4, const float* x, const float* base, float* out,
                     int Bout, int Bin, int njc, int nic, int restrict_,
                     int accumulate, cudaStream_t stream) {
    const int n_out = restrict_ ? njc * (nic / 2) : 2 * njc * nic;
    dim3 block(TC, mode_lanes(Bout));
    dim3 grid((n_out + TC - 1) / TC, 2);
    geo_transfer_kernel<<<grid, block, 0, stream>>>(T4, x, base, out, Bout, Bin,
                                                    njc, nic, restrict_, accumulate);
    return (int)cudaGetLastError();
}

int soa_stencil_apply(const void* blocks, const float* x, const float* base,
                      float* out, int Bs, int Bd, int C, int nh, int periodic,
                      float sign, int accumulate, int block_bf16, cudaStream_t stream) {
    if (block_bf16)
        return launch_stencil_apply<__nv_bfloat16>(blocks, x, base, out, Bs, Bd, C, nh,
                                                   periodic, sign, accumulate, stream);
    return launch_stencil_apply<float>(blocks, x, base, out, Bs, Bd, C, nh, periodic,
                                       sign, accumulate, stream);
}

// K5's launch geometry for Bd output modes over C cells per color:
// dims = {grid x, grid y, grid z, threads per CTA}.
int soa_stencil_apply_grid(int Bd, int C, int* dims) {
    StencilGrid g;
    const cudaError_t e = stencil_grid(Bd, C, &g);
    if (e == cudaSuccess) {
        dims[0] = g.tiles;
        dims[1] = 2;
        dims[2] = g.groups;
        dims[3] = TC * g.warps;
    }
    return (int)e;
}

int soa_dg_half_sweep(const float* D_c, const float* dgd_c, const float* dgi_c,
                      const float* rhs_c, const float* g, const float* p,
                      const float* base, float* out, int color, int Bu, int Np, int C,
                      int nh, int periodic, int accumulate, cudaStream_t stream) {
    dim3 block(TC, mode_lanes(Np));
    dim3 grid((C + TC - 1) / TC);
    size_t smem = (size_t)(5 * Bu + Np) * TC * sizeof(float);
    dg_half_sweep_kernel<<<grid, block, smem, stream>>>(D_c, dgd_c, dgi_c, rhs_c, g, p,
                                                        base, out, color, Bu, Np, C, nh,
                                                        periodic, accumulate);
    return (int)cudaGetLastError();
}

const char* soa_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
