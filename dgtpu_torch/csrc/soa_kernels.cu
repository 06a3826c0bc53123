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
//                       (StreamedLevel.half_sweeps) in one launch: K1's
//                       cluster body, a cooperative launch with a grid
//                       barrier between half-sweeps, float32 or bfloat16
//                       blocks
//
// Layout (the TPU kernels'): a color-pair vector is (2, B, C) with C =
// Nj * Ni/2 cells per color in the contiguous axis; operator blocks per color
// are (5, B_src, B_dst, C), diagonal matrices (B_src, B_dst, C).  Cells on the
// fast axis make every block read coalesced: for fixed (slot, b_src, b_dst) a
// warp reads 32 consecutive cells.
//
// What bounds them on the card: at 8x8 (C = 32 on the finest level) one CTA
// per 32-cell tile would be one CTA per launch, so K5 spreads its output
// modes over up to Bd CTAs per color and K1, K6 and K7 over the CTAs of a
// thread-block cluster (below), and a cycle is ~90 (Poisson p5) to ~800 (Stokes
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
// null otherwise).  K1, K6 and K7 launch as clusters: sm_90 and a CUDA 12
// runtime.

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TC = 32;  // cells per tile: one warp spans 32 consecutive cells
constexpr int K5_MAX_ROWS = 16;   // K4's and K5's output modes (thread rows) per CTA at most
constexpr int K5_MIN_WARPS = 4;   // warps that stage K5's fields at least

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

// The stored element itself through the read-only path, upconverted later
// (to_f at the multiply-add), so a chain's registers hold loads in flight.
__device__ __forceinline__ float ldg_raw(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 ldg_raw(const __nv_bfloat16* p) {
    return __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p)));
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
// spells it as dense cross-lane tensors (_geo_tensors, pallas_soa.py:256-284,
// pallas_stokes.py:254), quadratic in the cell count and nearly all zero;
// here restriction gathers each coarse cell's four children and
// prolongation reads each fine cell's one parent:
//   restrict: out (2, B_c, Cc) = sum_k R4[k] . x_fine[child k]
//   prolong:  out (2, B, Cf)   = (base +) P4[k(p)] . x_coarse[parent(p)]
// Its callers are the geometric levels of both SoA cycles: Poisson B 4 (p1)
// from 8 to 2,048 output cells per color, the Stokes velocity (B 8, the
// block-diagonal of the two p1 components) and pressure (B 1) on 2 to 512
// cells, most launches on the W-cycles' smallest levels.  The work is a few
// KB (bound 1 ns), so a launch is bound by latency: the launch itself, then
// one chain of 4 B_in (restriction) or B_in multiply-adds whose operands come
// from L2.  The first K4 ran one CTA per 32-cell tile and color, each thread
// walking the output modes a = ty, ty + 8, ... and loading T4 and x inside
// each chain.  Here, as K5 does:
//   - grid (cell tiles, 2 colors, output-mode groups), one output (cell,
//     mode) per thread: thread (tx, ty) of group g takes cell tile * 32 + tx
//     and mode g * rows + ty, by K5's rule (mode_grid: at least one CTA per
//     SM wherever the modes allow);
//   - each thread does its cell arithmetic (packed_pos) once and, for the
//     B_in of the port's levels (8, 4, 1: compiled in), issues every load
//     of its chain (4 B_in or B_in inputs, coalesced across the 32 lanes of
//     a tile, and as many elements of T4) ahead of its multiply-adds (any
//     other B_in loads by eights);
//   - T4's rows are read through the read-only path as a warp-uniform
//     broadcast (restriction: row (k, a) is the same for every lane;
//     prolongation: k follows the fine row's parity, one or two rows a
//     warp).  So no launch has staging or a barrier, and the small levels
//     get the direct shape.
// The sums keep the first K4's order (k = 0..3 outer, b = 0..B_in-1 inner,
// one fmaf chain from 0, then base +), so the results are the same bit for
// bit.  Measured against this body on an H100 in a graph (PERF.md):
// T4's rows staged in shared memory behind a barrier, within 1% at the B 8
// restriction and ~0.25 us slower elsewhere; the restriction's inputs
// staged by cp.async, ~0.6 us slower; T4's rows read as float4, ~0.1 us
// slower at the B 8 restriction; its lines prefetched into L1 first, ~0.25
// us slower.  The B 8 restriction (64 loads a thread)
// still takes ~0.6 us more than the prolongation (16): ptxas gives it 34
// registers (-Xptxas -v), too few to hold its 64 loads in flight at once.
// kBin > 0: B_in known at compile time; 0: any B_in.
template <bool kRestrict, int kBin>
__global__ void __launch_bounds__(TC * K5_MAX_ROWS)
geo_transfer_kernel(const float* __restrict__ T4, const float* __restrict__ x,
                    const float* __restrict__ base, float* __restrict__ out, int Bout,
                    int Bin_any, int njc, int nic, int accumulate, int rows) {
    constexpr int nk = kRestrict ? 4 : 1;
    const int Bin = kBin > 0 ? kBin : Bin_any;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int oc = blockIdx.y;
    const int a = blockIdx.z * rows + ty;
    const int nhc = nic / 2, nhf = nic;
    const int Cc = njc * nhc, Cf = 2 * njc * nhf;
    const int q = blockIdx.x * TC + tx;
    const int C_in = kRestrict ? Cf : Cc, C_out = kRestrict ? Cc : Cf;
    if (q >= C_out || a >= Bout) return;
    const float* xk[nk];   // input lane of child k (restriction) or the parent
    const float* Tk[nk];   // row a of the matrix that multiplies it
    if constexpr (kRestrict) {
        const int jc = q / nhc, ipc = q - jc * nhc;
        const int ic = (oc == 0) ? 2 * ipc + (jc % 2) : 2 * ipc + 1 - (jc % 2);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            int fc, fq;
            packed_pos(2 * jc + (k >> 1), 2 * ic + (k & 1), nhf, &fc, &fq);
            xk[k] = x + (size_t)fc * Bin * C_in + fq;
            Tk[k] = T4 + ((size_t)k * Bout + a) * Bin;
        }
    } else {
        const int jf = q / nhf, ipf = q - jf * nhf;
        const int i_f = (oc == 0) ? 2 * ipf + (jf % 2) : 2 * ipf + 1 - (jf % 2);
        int pc, pq;
        packed_pos(jf / 2, i_f / 2, nhc, &pc, &pq);
        xk[0] = x + (size_t)pc * Bin * C_in + pq;
        Tk[0] = T4 + ((size_t)((jf % 2) * 2 + (i_f % 2)) * Bout + a) * Bin;
    }
    const size_t o = (size_t)oc * Bout * C_out + (size_t)a * C_out + q;
    const float b0 = accumulate ? base[o] : 0.f;
    float acc = 0.f;
    if constexpr (kBin > 0) {
        float t[nk][kBin], v[nk][kBin];
#pragma unroll
        for (int k = 0; k < nk; ++k)
#pragma unroll
            for (int b = 0; b < kBin; ++b) {
                t[k][b] = __ldg(Tk[k] + b);
                v[k][b] = __ldg(xk[k] + (size_t)b * C_in);
            }
#pragma unroll
        for (int k = 0; k < nk; ++k)
#pragma unroll
            for (int b = 0; b < kBin; ++b) acc = fmaf(t[k][b], v[k][b], acc);
    } else {
#pragma unroll 1
        for (int k = 0; k < nk; ++k) {
            int b = 0;
            for (; b + 8 <= Bin; b += 8) {
                float t[8], v[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    t[u] = __ldg(Tk[k] + b + u);
                    v[u] = __ldg(xk[k] + (size_t)(b + u) * C_in);
                }
#pragma unroll
                for (int u = 0; u < 8; ++u) acc = fmaf(t[u], v[u], acc);
            }
            for (; b < Bin; ++b)
                acc = fmaf(__ldg(Tk[k] + b), __ldg(xk[k] + (size_t)b * C_in), acc);
        }
    }
    out[o] = accumulate ? b0 + acc : acc;
}

__global__ void empty_kernel() {}

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
//   Rule (mode_grid): with need = ceil(SMs / (2 tiles)) groups for one
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

// Stage the fields a stencil row of ``color`` reads into shared memory fld
// (5, B, TC) by asynchronous copies: slot 0 the color's own lattice at lane q
// (unless ``own`` is false: K1 keeps t there), slots 1..4 the opposite
// lattice at the neighbor lanes.  The (slot, mode) rows spread over the
// CTA's ny thread rows, one wait at the end (unless ``wait`` is false: the
// caller issues more loads first and then calls cp_async_wait_all).
__device__ __forceinline__ void stage_fields_async(float* fld, const float* __restrict__ x,
                                                   int color, int B, int C, int q, int tx,
                                                   int ty, int ny, int nh, int periodic,
                                                   bool own = true, bool wait = true) {
    const size_t BC = (size_t)B * C;
    const float* mine = x + (size_t)color * BC + q;
    const float* o = x + (size_t)(1 - color) * BC;
    if (own)
        for (int b = ty; b < B; b += ny) cp_async4(fld + b * TC + tx, mine + (size_t)b * C);
    for (int s = 0; s < 4; ++s) {
        const float* src = o + nbr_lane(q, s, color, C, nh, periodic);
        for (int b = ty; b < B; b += ny)
            cp_async4(fld + ((s + 1) * B + b) * TC + tx, src + (size_t)b * C);
    }
    if (wait) cp_async_wait_all();
}

// K7's staging of the four neighbor fields (slots 1..4 of fld) of cell q
// from the opposite lattice o, which other CTAs of the same launch wrote:
// through L2 (__ldcg), so no SM reads a line its L1 kept from an earlier
// half-sweep.  The (slot, mode) rows spread over the CTA's thread rows, in
// chunks of K7_STAGE loads issued together before their stores.
constexpr int K7_STAGE = 12;

template <int kB>
__device__ __forceinline__ void stage_fields_l2(float* fld, const float* o, int color,
                                                int B_any, int C, int q, int nh,
                                                int periodic) {
    const int B = kB > 0 ? kB : B_any;
    const int tx = threadIdx.x, ty = threadIdx.y, ny = blockDim.y;
    const int l0 = nbr_lane(q, 0, color, C, nh, periodic);
    const int l1 = nbr_lane(q, 1, color, C, nh, periodic);
    const int l2 = nbr_lane(q, 2, color, C, nh, periodic);
    const int l3 = nbr_lane(q, 3, color, C, nh, periodic);
    for (int r0 = ty; r0 < 4 * B; r0 += K7_STAGE * ny) {
        float v[K7_STAGE];
#pragma unroll
        for (int k = 0; k < K7_STAGE; ++k) {
            const int r = r0 + k * ny;
            if (r < 4 * B) {
                const int s = r / B, b = r - s * B;
                const int lane = s == 0 ? l0 : s == 1 ? l1 : s == 2 ? l2 : l3;
                v[k] = __ldcg(o + (size_t)b * C + lane);
            }
        }
#pragma unroll
        for (int k = 0; k < K7_STAGE; ++k) {
            const int r = r0 + k * ny;
            if (r < 4 * B) fld[(B + r) * TC + tx] = v[k];
        }
    }
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

// The launch geometry of K4 and K5 for ``modes`` output modes over C
// output cells per color (the rule in K5's note): grid (tiles, 2, groups),
// CTA (TC, warps), ``rows`` output modes per CTA, at least ``min_warps``
// warps.
struct ModeGrid {
    int tiles, groups, rows, warps;
};

cudaError_t mode_grid(int modes, int C, int min_warps, ModeGrid* g) {
    const int sms = sm_count();
    if (sms == 0) return cudaErrorNoDevice;
    if (modes < 1 || C < 1) return cudaErrorInvalidValue;
    const int tiles = (C + TC - 1) / TC;
    const int need = (sms + 2 * tiles - 1) / (2 * tiles);
    const int rows = std::min(K5_MAX_ROWS, std::max(1, modes / need));
    const int groups = (modes + rows - 1) / rows;
    g->tiles = tiles;
    g->rows = (modes + groups - 1) / groups;
    g->groups = (modes + g->rows - 1) / g->rows;
    g->warps = std::max(g->rows, min_warps);
    return cudaSuccess;
}

template <typename T>
int launch_stencil_apply(const void* blocks, const float* x, const float* base,
                         float* out, int Bs, int Bd, int C, int nh, int periodic,
                         float sign, int accumulate, cudaStream_t stream) {
    ModeGrid g;
    cudaError_t e = mode_grid(Bd, C, K5_MIN_WARPS, &g);
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

// K1 and K6: one red-black half-sweep of one color c,
//   K1 (_soa_smooth, pallas_soa.py:341-353; the Stokes _bgs_A):
//     t       = rhs_c - sum_{s=1..4} A_c[s] nbr_s(u[1-c])
//     out[c]  = (base[c] +) Dinv_c t,        out[1-c] = (base[1-c] +) u[1-c]
//   K6 (_bgs_dg's half, pallas_stokes.py:382-390; in the streamed hybrid the
//   whole of matvec_color(D) + the two DG-diagonal MACs,
//   pallas_stokes_stream.py:109-113), with g = G p from K5:
//     t       = rhs_c - (D_c[0] g_c + sum_s D_c[s] nbr_s(g_{1-c}) - DG_diag_c p_c)
//     out[c]  = (base[c] +) DG_Dinv_c t,     out[1-c] = (base[1-c] +) p[1-c]
// ``base`` folds the Stokes sweep's uv + du (K1) and p + dp (K6) into the
// last half-sweep.  Blocks are float32, (5, B_src, B_dst, C) per color.
//
// What bounds them: each output is a chain of 4 B (K1) or 5 Bu (K6)
// dependent multiply-adds whose block elements come from device memory or
// L2, then a chain of B (Np) for the inverse; at 8x8 (C = 32) the bytes are
// under 1 MB, so latency and loads in flight bound them, and at 64x64 p5
// (C = 2048, 26 MB per K1 call) the bytes.  One CTA per 32-cell tile (the
// first cut) ran one CTA at 8x8 with each thread walking several outputs.
// The second stage needs every mode of t, so the output modes cannot simply
// go to separate CTAs as in K5; they go to the CTAs of a thread-block
// cluster, which share t through distributed shared memory:
//
//   grid (G, cell tiles), a cluster of G CTAs along x: CTA g of a tile's
//   cluster owns output modes [g rows, (g + 1) rows), one per thread row,
//   one output per thread; the warp stays along the 32 cells, so every
//   block read is one coalesced 128-byte load.
//   Stage 1: the CTA stages the neighbor fields of its 32 cells by cp.async
//   (K1: slots 1..4, 4 B TC floats; K6: g's five fields, 5 Bu TC) with all
//   its warps (at least K5_MIN_WARPS); before waiting on them each thread
//   issues its chain's block loads through the read-only path (SlotChain:
//   every slot at once where they fit in 96 registers; at B 36 one slot
//   ahead inside the chain instead), fetches its rhs and base elements (K6
//   also its DG_Dinv row and its DG_diag row times p_c, one chain) and
//   copies its mode of the other color.  After the barrier it runs its
//   chain, unrolled for the B of the port's levels, and writes t_a into its
//   CTA's t (K1: in place of slot 0; K6: after the fields).
//   Exchange (exchange_t): K1's thread issues its Dinv row's loads,
//   cluster.sync(), then each CTA copies the other CTAs' rows of t into the
//   same rows of its own t, arrives on the cluster barrier and syncs its
//   CTA; it waits on that barrier again just before it exits, so no CTA
//   leaves while a peer still reads its shared memory.
//   Stage 2: each thread sums its inverse row against t and stores.
//   Rule (sweep_rule, for ``modes`` = B or Np output modes): tiles =
//   ceil(C / 32), need = ceil(SMs / tiles) CTAs per tile for one CTA per
//   SM; rows = max(ceil(modes / most), min(16, max(1, floor(modes /
//   need)))), G = ceil(modes / rows), then the modes spread evenly, rows =
//   ceil(modes / G) and G = ceil(modes / rows), so no CTA is empty, a CTA
//   has at most SWEEP_MAX_ROWS thread rows and G >= need wherever modes >=
//   need and the cluster limit allow it.  ``most`` is 16 (a non-portable
//   cluster size, allowed per kernel before its first launch) and is lowered
//   while cudaOccupancyMaxActiveClusters finds no room for the shape (8 if
//   the card refuses non-portable sizes).  8x8 p5 finest (B 36, C 32): one
//   cluster of 12 CTAs of 3 rows; 64x64 p5 (C 2048): 64 clusters of 3 CTAs
//   of 12 rows; 8x8 Stokes A (B 18): 9 CTAs of 2 rows; K6 at Np 4: clusters
//   of 4 CTAs of one row; at Np 1 one CTA and no peer to read.
//
// The sums keep the first cut's order: stage 1 one fmaf chain from 0 over
// the slots (K1 1..4, K6 0..4) and b, then rhs - acc (K6: the diagonal chain
// over b, then rhs - (dg - diag)); stage 2 one chain over b, then base +
// acc.  So every result is the same bit for bit.
constexpr int SWEEP_MAX_ROWS = 16;      // output modes (thread rows) per CTA at most
constexpr int SWEEP_MAX_CLUSTER = 16;   // CTAs per cluster at most (8 is portable)

// One output's chain over slots s = kS0..4 and modes b = 0..Bs-1:
// sum_s sum_b blk[s][b] * fld[s][b], with ``blk`` at the output's element of
// slot 0, mode 0, ``step`` elements from mode b to b + 1 and Bs step from
// slot s to s + 1; the blocks are of storage type T (K7: float32 or
// bfloat16), held as loaded and upconverted at the multiply-add.  The block
// loads need no staged field, so a kernel calls issue() before its staging
// barrier and sum() after it.  kBs > 0: Bs known at compile time and b
// unrolled; where every slot's loads fit in 96 registers (kEarly) issue()
// puts them all in flight, else sum() keeps one slot ahead, issuing slot s +
// 1's loads before slot s's multiply-adds (K5's body: at B 36 the early
// loads would take 100 registers a thread and halve the CTAs an SM holds at
// 64x64).  kBs == 0: any Bs, the loads in sum(), unrolled by 8.
template <int kS0, int kBs, typename T = float>
struct SlotChain {
    static constexpr int kSlots = 5 - kS0;
    static constexpr bool kEarly = kBs > 0 && kBs * kSlots <= 96;
    T v[kEarly ? kSlots : 1][kBs > 0 ? kBs : 1];
    const T* blk;
    size_t step;
    int Bs;

    __device__ __forceinline__ const T* slot(int s) const {
        return blk + (size_t)s * Bs * step;
    }

    __device__ __forceinline__ void issue(const T* __restrict__ b, size_t st, int Bs_any) {
        blk = b;
        step = st;
        Bs = kBs > 0 ? kBs : Bs_any;
        if constexpr (kEarly) {
#pragma unroll
            for (int k = 0; k < kSlots; ++k)
#pragma unroll
                for (int m = 0; m < kBs; ++m) v[k][m] = ldg_raw(slot(kS0 + k) + m * step);
        }
    }

    __device__ __forceinline__ float sum(const float* fld, int tx) {
        float acc = 0.f;
        if constexpr (kEarly) {
#pragma unroll
            for (int k = 0; k < kSlots; ++k) {
                const float* f = fld + (kS0 + k) * kBs * TC + tx;
#pragma unroll
                for (int m = 0; m < kBs; ++m) acc = fmaf(to_f(v[k][m]), f[m * TC], acc);
            }
        } else if constexpr (kBs > 0) {
            T cur[kBs], next[kBs];
#pragma unroll
            for (int m = 0; m < kBs; ++m) cur[m] = ldg_raw(slot(kS0) + m * step);
#pragma unroll
            for (int s = kS0; s < 5; ++s) {
                if (s < 4) {
#pragma unroll
                    for (int m = 0; m < kBs; ++m) next[m] = ldg_raw(slot(s + 1) + m * step);
                }
                const float* f = fld + s * kBs * TC + tx;
#pragma unroll
                for (int m = 0; m < kBs; ++m) acc = fmaf(to_f(cur[m]), f[m * TC], acc);
                if (s < 4) {
#pragma unroll
                    for (int m = 0; m < kBs; ++m) cur[m] = next[m];
                }
            }
        } else {
#pragma unroll 1
            for (int s = kS0; s < 5; ++s) {
                const T* A = slot(s);
                const float* f = fld + s * Bs * TC + tx;
                int b = 0;
                for (; b + 8 <= Bs; b += 8) {
                    T w[8];
#pragma unroll
                    for (int u = 0; u < 8; ++u) w[u] = ldg_raw(A + (b + u) * step);
#pragma unroll
                    for (int u = 0; u < 8; ++u) acc = fmaf(to_f(w[u]), f[(b + u) * TC], acc);
                }
                for (; b < Bs; ++b) acc = fmaf(ldg_f(A + b * step), f[b * TC], acc);
            }
        }
        return acc;
    }
};

// The exchange of the note: t (modes, TC) in shared memory holds this CTA's
// rows; after it, every row.  Every thread of every CTA of the cluster calls
// it, and cluster_wait() once after each call: before it writes its rows of
// t again (K7) or just before it exits, so no peer still reads them.
__device__ __forceinline__ void exchange_t(float* t, int modes, int rows) {
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned rank = cluster.block_rank();
    cluster.sync();
    for (int i = threadIdx.y; i < modes; i += blockDim.y) {
        const unsigned owner = i / rows;
        if (owner != rank)
            t[i * TC + threadIdx.x] =
                cluster.map_shared_rank(t, owner)[i * TC + threadIdx.x];
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    __syncthreads();
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// K1 (the note above).  kB > 0: B known at compile time; 0: any B.
template <int kB>
__global__ void __launch_bounds__(TC * SWEEP_MAX_ROWS)
half_sweep_kernel(const float* __restrict__ blocks_c, const float* __restrict__ dinv_c,
                  const float* __restrict__ rhs_c, const float* __restrict__ u,
                  const float* __restrict__ base, float* __restrict__ out, int color,
                  int B_any, int C, int nh, int periodic, int accumulate, int rows) {
    extern __shared__ float fld[];   // (5, B, TC): slots 1..4 the fields, slot 0 t
    const int B = kB > 0 ? kB : B_any;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int q = blockIdx.y * TC + tx;
    const int a = blockIdx.x * rows + ty;
    const bool valid = q < C;
    const bool active = valid && ty < rows && a < B;
    const size_t BC = (size_t)B * C;
    const size_t i = (size_t)a * C + q;
    const size_t oc = (size_t)(1 - color) * BC + i, cc = (size_t)color * BC + i;
    float r0 = 0.f, b0 = 0.f;
    if (active) {
        out[oc] = accumulate ? base[oc] + u[oc] : u[oc];
        r0 = rhs_c[i];
        if (accumulate) b0 = base[cc];
    }
    if (valid)
        stage_fields_async(fld, u, color, B, C, q, tx, ty, blockDim.y, nh, periodic, false,
                           false);
    SlotChain<1, kB> chain;
    if (active) chain.issue(blocks_c + i, BC, B);
    cp_async_wait_all();
    __syncthreads();
    if (active) fld[a * TC + tx] = r0 - chain.sum(fld, tx);
    float d[kB > 0 ? kB : 1];
    if constexpr (kB > 0) {
        if (active) {
#pragma unroll
            for (int b = 0; b < kB; ++b) d[b] = __ldg(dinv_c + (size_t)b * BC + i);
        }
    }
    exchange_t(fld, B, rows);
    if (active) {
        float acc = 0.f;
        if constexpr (kB > 0) {
#pragma unroll
            for (int b = 0; b < kB; ++b) acc = fmaf(d[b], fld[b * TC + tx], acc);
        } else {
            for (int b = 0; b < B; ++b)
                acc = fmaf(__ldg(dinv_c + (size_t)b * BC + i), fld[b * TC + tx], acc);
        }
        out[cc] = accumulate ? b0 + acc : acc;
    }
    cluster_wait();
}

// K6 (the note above).  D_c is (5, Bu, Np, C); dgd / dgi are (Np, Np, C) in
// the M^T layout.  kBu, kNp > 0: known at compile time; 0: any.
template <int kBu, int kNp>
__global__ void __launch_bounds__(TC * SWEEP_MAX_ROWS)
dg_half_sweep_kernel(const float* __restrict__ D_c, const float* __restrict__ dgd_c,
                     const float* __restrict__ dgi_c, const float* __restrict__ rhs_c,
                     const float* __restrict__ g, const float* __restrict__ p,
                     const float* __restrict__ base, float* __restrict__ out, int color,
                     int Bu_any, int Np_any, int C, int nh, int periodic, int accumulate,
                     int rows) {
    extern __shared__ float sm[];
    const int Bu = kBu > 0 ? kBu : Bu_any;
    const int Np = kNp > 0 ? kNp : Np_any;
    float* fld = sm;                 // (5, Bu, TC)
    float* t = sm + 5 * Bu * TC;     // (Np, TC)
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int q = blockIdx.y * TC + tx;
    const int a = blockIdx.x * rows + ty;
    const bool valid = q < C;
    const bool active = valid && ty < rows && a < Np;
    const size_t PC = (size_t)Np * C;
    const size_t i = (size_t)a * C + q;
    const size_t oc = (size_t)(1 - color) * PC + i, cc = (size_t)color * PC + i;
    const float* pc = p + (size_t)color * PC;
    if (valid)
        stage_fields_async(fld, g, color, Bu, C, q, tx, ty, blockDim.y, nh, periodic, true,
                           false);
    SlotChain<0, kBu> chain;
    float d[kNp > 0 ? kNp : 1];
    float r0 = 0.f, b0 = 0.f, diag = 0.f;
    if (active) {
        chain.issue(D_c + i, PC, Bu);
        if constexpr (kNp > 0) {
#pragma unroll
            for (int b = 0; b < kNp; ++b) d[b] = __ldg(dgi_c + (size_t)b * PC + i);
        }
        out[oc] = accumulate ? base[oc] + p[oc] : p[oc];
        r0 = rhs_c[i];
        if (accumulate) b0 = base[cc];
        for (int b = 0; b < Np; ++b)
            diag = fmaf(dgd_c[(size_t)b * PC + i], pc[(size_t)b * C + q], diag);
    }
    cp_async_wait_all();
    __syncthreads();
    if (active) t[a * TC + tx] = r0 - (chain.sum(fld, tx) - diag);
    exchange_t(t, Np, rows);
    if (active) {
        float acc = 0.f;
        if constexpr (kNp > 0) {
#pragma unroll
            for (int b = 0; b < kNp; ++b) acc = fmaf(d[b], t[b * TC + tx], acc);
        } else {
            for (int b = 0; b < Np; ++b)
                acc = fmaf(__ldg(dgi_c + (size_t)b * PC + i), t[b * TC + tx], acc);
        }
        out[cc] = accumulate ? b0 + acc : acc;
    }
    cluster_wait();
}

// K7: n_half red-black half-sweeps (colors 0, 1, 0, 1, ...) in one launch,
// the whole of StreamedLevel.half_sweeps(n_half) (pallas_stream.py:234-345):
//   h even: out[0] = Dinv_0 (rhs_0 - off_0(state[1]));  h odd: out[1] likewise
// with state[1] = u[1] (zero when u is null: t = rhs, no block is read)
// before the first half-sweep, and out (+ base) at the end.  blocks / dinv
// are per-color operands of storage type T (float32 or bfloat16), with color
// strides blk_cs / dinv_cs elements (the float32 SoA packing, or one
// bfloat16 [Dinv, iL, iR, jL, jR] tensor).
//
// What bounds it: at 64x64 p5 a half-sweep streams one color's blocks, 53 MB
// in float32 (26.5 MB in bfloat16); both colors' 106 MB pass the 50 MB L2,
// so a launch of n half-sweeps moves n times that.  The first K7 ran one CTA
// per 32-cell tile (64 at 64x64 on 132 SMs), each thread walking ceil(B / 8)
// output modes, each a 144-deep chain of loads with one in flight: 84 us a
// half-sweep against K1's 24 in a launch of its own.  So each half-sweep
// here is K1's body on K1's grid:
//
//   grid (G, clusters) in clusters of G CTAs along x, G and the rows per CTA
//   from sweep_rule over the B modes (64x64 p5: 64 clusters of 3 CTAs of 12
//   rows; the 32x32 Stokes finest A, B 18: 16 clusters of 9 CTAs of 2 rows);
//   one output mode per thread; the block loads through the read-only path
//   (SlotChain, one slot ahead at B 36), t = rhs - off shared over the
//   cluster through distributed shared memory (exchange_t), then the Dinv
//   row.  Where the card cannot hold one cluster per cell tile at once, the
//   clusters stride over the tiles (each cluster owns the same tiles in
//   every half-sweep).
//   The fields of the opposite color were written by other CTAs of this
//   launch, and an SM's L1 may still hold their lines from two half-sweeps
//   ago, so they are staged through L2 (__ldcg), in chunks of loads issued
//   together; K1 stages by cp.async.ca, which caches in L1.
//   A CTA reuses its shared memory from one tile and half-sweep to the next,
//   while its peers may still read its rows of t: it arrives on the cluster
//   barrier after copying its peers' rows and waits on it just before it
//   writes its rows of t again (and before it exits), so arrive and wait
//   alternate once per tile.
//   Half-sweep h reads only the color h - 1 wrote, so one grid-wide barrier
//   per half-sweep is the whole dependency: a cooperative launch with the
//   cluster dimension (both attributes through cudaLaunchKernelEx) and
//   grid.sync().  The runtime refuses a cooperative grid the card cannot
//   hold at once, and each launch has its own barrier state, so a grid that
//   does not fit fails instead of hanging.  (A barrier of K7's own on a
//   plain cluster launch, one counter in device memory, ran within 2% of
//   it, but would hang there and serves one K7 in flight at a time.)
//   With a base, color 1 takes it in the last half-sweep and color 0 after
//   one more barrier (the last half-sweep reads color 0).
//
// The sums keep the first K7's order (K1's): one fmaf chain from 0 over
// slots 1..4 and b, then rhs - acc; one chain over Dinv's b, then base + acc
// (color 0: acc + base).  So the results are the same bit for bit.
// K7's largest CTA for B modes: the rule's rows are ceil(B / G) with G >=
// ceil(B / SWEEP_MAX_ROWS) (12 at B 36, 9 at B 18), at least K5_MIN_WARPS
// warps.  At B 36 two CTAs of 384 threads an SM hold the 64x64 p5 grid (64
// clusters of 3) at once, so its registers are capped for that.
constexpr int k7_rows(int kB) {
    return kB == 0 ? SWEEP_MAX_ROWS
                   : (kB + (kB + SWEEP_MAX_ROWS - 1) / SWEEP_MAX_ROWS - 1) /
                         ((kB + SWEEP_MAX_ROWS - 1) / SWEEP_MAX_ROWS);
}
constexpr int k7_threads(int kB) {
    return TC * (k7_rows(kB) > K5_MIN_WARPS ? k7_rows(kB) : K5_MIN_WARPS);
}

template <typename T, int kB>
__global__ void __launch_bounds__(k7_threads(kB), kB == 36 ? 2 : 1)
multi_half_sweep_kernel(const T* __restrict__ blocks, const T* __restrict__ dinv,
                        long long blk_cs, long long dinv_cs,
                        const float* __restrict__ rhs, const float* __restrict__ u,
                        const float* __restrict__ base, float* out, int n_half, int B_any,
                        int C, int nh, int periodic, int rows) {
    extern __shared__ float fld[];   // (5, B, TC): slots 1..4 the fields, slot 0 t
    const int B = kB > 0 ? kB : B_any;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int a = blockIdx.x * rows + ty;
    const bool owns = ty < rows && a < B;   // this thread's output mode a
    const size_t BC = (size_t)B * C;
    const int n_tiles = (C + TC - 1) / TC;
    bool arrived = false;   // on the cluster barrier, not yet waited on
    cg::grid_group grid = cg::this_grid();
    for (int h = 0; h < n_half; ++h) {
        const int color = h & 1;
        const float* o = h > 0 ? out + (size_t)(1 - color) * BC
                               : (u ? u + (size_t)(1 - color) * BC : nullptr);
        const bool last = base && h == n_half - 1;
        const T* blk_c = blocks + color * blk_cs;
        const T* dinv_c = dinv + color * dinv_cs;
        for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
            const int q = tile * TC + tx;
            const bool valid = q < C;
            const bool active = valid && owns;
            const size_t i = (size_t)a * C + q, ci = (size_t)color * BC + i;
            float r0 = 0.f, b0 = 0.f;
            SlotChain<1, kB, T> chain;
            if (active) {
                r0 = rhs[ci];
                if (last) b0 = base[ci];
                if (o) chain.issue(blk_c + i, BC, B);
            }
            if (valid && o) stage_fields_l2<kB>(fld, o, color, B, C, q, nh, periodic);
            __syncthreads();
            const float t = (active && o) ? r0 - chain.sum(fld, tx) : r0;
            T d[kB > 0 ? kB : 1];
            if constexpr (kB > 0) {
                if (active) {
#pragma unroll
                    for (int b = 0; b < kB; ++b) d[b] = ldg_raw(dinv_c + (size_t)b * BC + i);
                }
            }
            if (arrived) cluster_wait();
            if (active) fld[a * TC + tx] = t;
            exchange_t(fld, B, rows);
            arrived = true;
            if (active) {
                float acc = 0.f;
                if constexpr (kB > 0) {
#pragma unroll
                    for (int b = 0; b < kB; ++b) acc = fmaf(to_f(d[b]), fld[b * TC + tx], acc);
                } else {
                    for (int b = 0; b < B; ++b)
                        acc = fmaf(ldg_f(dinv_c + (size_t)b * BC + i), fld[b * TC + tx], acc);
                }
                out[ci] = last ? b0 + acc : acc;
            }
        }
        if (h + 1 < n_half || base) grid.sync();
    }
    if (base && owns)
        for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
            const int q = tile * TC + tx;
            if (q < C) {
                const size_t i = (size_t)a * C + q;
                out[i] = __ldcg(out + i) + base[i];
            }
        }
    if (arrived) cluster_wait();
}

// The bodies of the port's levels: K1 at B 36/16/9/4 (Poisson p5/p3/p2/p1)
// and 18/8 (Stokes momentum), K6 at (Bu, Np) = (18, 4) and (8, 1).
using HalfSweepBody = decltype(&half_sweep_kernel<0>);
using DgHalfSweepBody = decltype(&dg_half_sweep_kernel<0, 0>);

HalfSweepBody half_sweep_body(int B) {
    switch (B) {
        case 36: return half_sweep_kernel<36>;
        case 18: return half_sweep_kernel<18>;
        case 16: return half_sweep_kernel<16>;
        case 9: return half_sweep_kernel<9>;
        case 8: return half_sweep_kernel<8>;
        case 4: return half_sweep_kernel<4>;
        default: return half_sweep_kernel<0>;
    }
}

DgHalfSweepBody dg_half_sweep_body(int Bu, int Np) {
    if (Bu == 18 && Np == 4) return dg_half_sweep_kernel<18, 4>;
    if (Bu == 8 && Np == 1) return dg_half_sweep_kernel<8, 1>;
    return dg_half_sweep_kernel<0, 0>;
}

// The launch geometry of the note: grid (size, tiles), clusters of ``size``
// CTAs of (TC, warps) threads, ``rows`` output modes per CTA.
struct SweepGrid {
    int tiles, size, rows, warps;
};

SweepGrid sweep_rule(int modes, int C, int sms, int most) {
    SweepGrid g;
    g.tiles = (C + TC - 1) / TC;
    const int need = (sms + g.tiles - 1) / g.tiles;
    const int rows = std::max((modes + most - 1) / most,
                              std::min(SWEEP_MAX_ROWS, std::max(1, modes / need)));
    const int size = (modes + rows - 1) / rows;
    g.rows = (modes + size - 1) / size;
    g.size = (modes + g.rows - 1) / g.rows;
    g.warps = std::max(g.rows, K5_MIN_WARPS);
    return g;
}

// A cluster launch of one grid; holds the attribute the configuration
// points at.
struct ClusterLaunch {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[2] = {};
    ClusterLaunch(const SweepGrid& g, size_t smem, cudaStream_t stream,
                  bool cooperative = false) {
        cfg.gridDim = dim3(g.size, g.tiles);
        cfg.blockDim = dim3(TC, g.warps);
        cfg.dynamicSmemBytes = smem;
        cfg.stream = stream;
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = g.size;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        attr[1].id = cudaLaunchAttributeCooperative;
        attr[1].val.cooperative = 1;
        cfg.attrs = attr;
        cfg.numAttrs = cooperative ? 2 : 1;
    }
    ClusterLaunch(const ClusterLaunch&) = delete;
};

// The grid of ``kernel`` for ``modes`` output modes over C cells with
// ``smem`` bytes of shared memory per CTA: the rule with the largest cluster
// the card can hold.  Found once per (kernel, modes, C, smem) and kept for
// the process, so only a first launch queries the card (the routes make it
// eagerly, before any CUDA graph capture).
template <typename Kernel>
cudaError_t sweep_grid(Kernel kernel, int modes, int C, size_t smem, SweepGrid* out) {
    static std::mutex mu;
    static std::map<std::tuple<const void*, int, int, size_t>, SweepGrid> found;
    const std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple((const void*)kernel, modes, C, smem);
    const auto it = found.find(key);
    if (it != found.end()) {
        *out = it->second;
        return cudaSuccess;
    }
    const int sms = sm_count();
    if (sms == 0) return cudaErrorNoDevice;
    if (modes < 1 || C < 1) return cudaErrorInvalidValue;
    int most = SWEEP_MAX_CLUSTER;
    if (cudaFuncSetAttribute((const void*)kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) != cudaSuccess) {
        cudaGetLastError();
        most = 8;
    }
    cudaError_t refused = cudaErrorInvalidConfiguration;
    for (;;) {
        const SweepGrid g = sweep_rule(modes, C, sms, most);
        const ClusterLaunch l(g, smem, nullptr);
        int clusters = 0;
        const cudaError_t e =
            cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &l.cfg);
        if (e == cudaSuccess && clusters > 0) {
            found.emplace(key, g);
            *out = g;
            return cudaSuccess;
        }
        if (e != cudaSuccess) {   // a cluster size the card refuses: try a smaller one
            cudaGetLastError();
            refused = e;
        }
        most = g.size - 1;
        if (most < 1 || (modes + most - 1) / most > SWEEP_MAX_ROWS)
            return refused;       // no smaller cluster to take
    }
}

template <typename Kernel, typename... Args>
int launch_sweep(Kernel kernel, int modes, int C, size_t smem, cudaStream_t stream,
                 Args... args) {
    SweepGrid g;
    cudaError_t e = sweep_grid(kernel, modes, C, smem, &g);
    if (e != cudaSuccess) return (int)e;
    const ClusterLaunch l(g, smem, stream);
    e = cudaLaunchKernelEx(&l.cfg, kernel, args..., g.rows);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

size_t half_sweep_smem(int B) { return (size_t)5 * B * TC * sizeof(float); }
size_t dg_half_sweep_smem(int Bu, int Np) {
    return (size_t)(5 * Bu + Np) * TC * sizeof(float);
}

// {cell tiles, cluster size, rows per CTA, threads per CTA} of a grid
int grid_dims(cudaError_t e, const SweepGrid& g, int* dims) {
    if (e == cudaSuccess) {
        dims[0] = g.tiles;
        dims[1] = g.size;
        dims[2] = g.rows;
        dims[3] = TC * g.warps;
    }
    return (int)e;
}

// K7's bodies: float32 or bfloat16 blocks, at the B of the streamed levels
// (Poisson p5/p3/p2/p1, the Stokes momentum blocks) or any B.
template <typename T>
using MultiSweepBody = decltype(&multi_half_sweep_kernel<T, 0>);

template <typename T>
MultiSweepBody<T> multi_half_sweep_body(int B) {
    switch (B) {
        case 36: return multi_half_sweep_kernel<T, 36>;
        case 18: return multi_half_sweep_kernel<T, 18>;
        case 16: return multi_half_sweep_kernel<T, 16>;
        case 9: return multi_half_sweep_kernel<T, 9>;
        case 8: return multi_half_sweep_kernel<T, 8>;
        case 4: return multi_half_sweep_kernel<T, 4>;
        default: return multi_half_sweep_kernel<T, 0>;
    }
}

// K7's geometry: K1's rule for B modes over C cells (sweep_grid, with K7's
// body and shared memory), and how many of its clusters the card holds at
// once (cudaOccupancyMaxActiveClusters), kept per shape as sweep_grid keeps
// the rule, so only a first launch queries the card.
template <typename T>
cudaError_t multi_sweep_grid(int B, int C, SweepGrid* g, int* resident) {
    const auto kernel = multi_half_sweep_body<T>(B);
    const size_t smem = half_sweep_smem(B);
    cudaError_t e = sweep_grid(kernel, B, C, smem, g);
    if (e != cudaSuccess) return e;
    static std::mutex mu;
    static std::map<std::tuple<const void*, int, int>, int> found;
    const std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple((const void*)kernel, B, C);
    const auto it = found.find(key);
    if (it != found.end()) {
        *resident = it->second;
        return cudaSuccess;
    }
    const ClusterLaunch l(*g, smem, nullptr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &l.cfg);
    if (e != cudaSuccess) return e;
    found.emplace(key, n);
    *resident = n;
    return cudaSuccess;
}

// ``clusters``: the grid in clusters, 0 for the default (one per cell tile,
// at most the resident count).  A grid the card cannot hold at once would
// never pass its first grid barrier: refused before the launch (and by the
// runtime, which checks a cooperative launch).
template <typename T>
int launch_multi_half_sweep(const void* blocks, const void* dinv, long long blk_cs,
                            long long dinv_cs, const float* rhs, const float* u,
                            const float* base, float* out, int n_half, int B, int C,
                            int nh, int periodic, int clusters, cudaStream_t stream) {
    SweepGrid g;
    int resident = 0;
    cudaError_t e = multi_sweep_grid<T>(B, C, &g, &resident);
    if (e != cudaSuccess) return (int)e;
    if (clusters == 0) clusters = std::min(g.tiles, resident);
    if (clusters < 1 || clusters > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
    g.tiles = clusters;
    const ClusterLaunch l(g, half_sweep_smem(B), stream, true);
    e = cudaLaunchKernelEx(&l.cfg, multi_half_sweep_body<T>(B), static_cast<const T*>(blocks),
                           static_cast<const T*>(dinv), blk_cs, dinv_cs, rhs, u, base, out,
                           n_half, B, C, nh, periodic, g.rows);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" {

int soa_half_sweep(const float* blocks_c, const float* dinv_c, const float* rhs_c,
                   const float* u, const float* base, float* out, int color, int B,
                   int C, int nh, int periodic, int accumulate, cudaStream_t stream) {
    return launch_sweep(half_sweep_body(B), B, C, half_sweep_smem(B), stream, blocks_c,
                        dinv_c, rhs_c, u, base, out, color, B, C, nh, periodic, accumulate);
}

// K1's launch geometry for B output modes over C cells per color: dims =
// {cell tiles, cluster size, rows per CTA, threads per CTA}.
int soa_half_sweep_grid(int B, int C, int* dims) {
    SweepGrid g;
    return grid_dims(sweep_grid(half_sweep_body(B), B, C, half_sweep_smem(B), &g), g, dims);
}

int soa_multi_half_sweep(const void* blocks, const void* dinv, long long blk_cs,
                         long long dinv_cs, const float* rhs, const float* u,
                         const float* base, float* out, int n_half, int B, int C, int nh,
                         int periodic, int block_bf16, int clusters, cudaStream_t stream) {
    if (block_bf16)
        return launch_multi_half_sweep<__nv_bfloat16>(blocks, dinv, blk_cs, dinv_cs, rhs,
                                                      u, base, out, n_half, B, C, nh,
                                                      periodic, clusters, stream);
    return launch_multi_half_sweep<float>(blocks, dinv, blk_cs, dinv_cs, rhs, u, base,
                                          out, n_half, B, C, nh, periodic, clusters, stream);
}

// K7's default launch geometry for B output modes over C cells per color:
// dims = {clusters, cluster size, rows per CTA, threads per CTA}.
int soa_multi_half_sweep_grid(int B, int C, int block_bf16, int* dims) {
    SweepGrid g;
    int resident = 0;
    const cudaError_t e = block_bf16 ? multi_sweep_grid<__nv_bfloat16>(B, C, &g, &resident)
                                     : multi_sweep_grid<float>(B, C, &g, &resident);
    if (e == cudaSuccess) g.tiles = std::min(g.tiles, resident);
    return grid_dims(e, g, dims);
}

// How many of K7's clusters for (B, C) the card holds at once: the largest
// grid it launches.
int soa_multi_half_sweep_clusters(int B, int C, int block_bf16, int* n) {
    SweepGrid g;
    return (int)(block_bf16 ? multi_sweep_grid<__nv_bfloat16>(B, C, &g, n)
                            : multi_sweep_grid<float>(B, C, &g, n));
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
    ModeGrid g;
    const cudaError_t e =
        mode_grid(Bout, restrict_ ? njc * (nic / 2) : 2 * njc * nic, 1, &g);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(g.tiles, 2, g.groups), block(TC, g.warps);
#define K4_LAUNCH(r, n)                                                     \
    geo_transfer_kernel<r, n><<<grid, block, 0, stream>>>(                  \
        T4, x, base, out, Bout, Bin, njc, nic, accumulate, g.rows)
#define K4_LAUNCH_BIN(r)                                                    \
    switch (Bin) {  /* the Poisson p1, Stokes velocity and pressure levels */ \
        case 8: K4_LAUNCH(r, 8); break;                                     \
        case 4: K4_LAUNCH(r, 4); break;                                     \
        case 1: K4_LAUNCH(r, 1); break;                                     \
        default: K4_LAUNCH(r, 0); break;                                    \
    }
    if (restrict_) {
        K4_LAUNCH_BIN(true)
    } else {
        K4_LAUNCH_BIN(false)
    }
#undef K4_LAUNCH_BIN
#undef K4_LAUNCH
    return (int)cudaGetLastError();
}

// K4's launch geometry for Bout output modes over C_out output cells per
// color: dims = {grid x, grid y, grid z, threads per CTA}.
int soa_geo_transfer_grid(int Bout, int C_out, int* dims) {
    ModeGrid g;
    const cudaError_t e = mode_grid(Bout, C_out, 1, &g);
    if (e == cudaSuccess) {
        dims[0] = g.tiles;
        dims[1] = 2;
        dims[2] = g.groups;
        dims[3] = TC * g.warps;
    }
    return (int)e;
}

// An empty kernel: one launch of it is the card's launch floor, the least
// time any launch of the cycles takes (chip_smoke.py times it eagerly and in
// a graph).
int soa_empty(cudaStream_t stream) {
    empty_kernel<<<1, TC, 0, stream>>>();
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
    ModeGrid g;
    const cudaError_t e = mode_grid(Bd, C, K5_MIN_WARPS, &g);
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
    return launch_sweep(dg_half_sweep_body(Bu, Np), Np, C, dg_half_sweep_smem(Bu, Np),
                        stream, D_c, dgd_c, dgi_c, rhs_c, g, p, base, out, color, Bu, Np,
                        C, nh, periodic, accumulate);
}

// K6's launch geometry for Np output modes (Bu staged) over C cells per
// color: dims as soa_half_sweep_grid's.
int soa_dg_half_sweep_grid(int Bu, int Np, int C, int* dims) {
    SweepGrid g;
    return grid_dims(sweep_grid(dg_half_sweep_body(Bu, Np), Np, C,
                                dg_half_sweep_smem(Bu, Np), &g),
                     g, dims);
}

const char* soa_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
