// Hopper kernels for the SoA (cells-in-lanes) multigrid cycles.
//
// They replace the two Pallas TPU kernels of dgtpu's mixed-precision routes:
// SoAVCycle.build (Poisson; dgtpu/ops/pallas_soa.py:556-592, pallas_call at
// :574) and SoAStokesVCycle.build (Stokes distributive GS;
// dgtpu/ops/pallas_stokes.py:716-759, pallas_call at :739).  Each TPU kernel
// keeps the whole hierarchy in VMEM and runs a cycle in one launch.  One H100
// SM has 227 KB of shared memory and even the 8x8 p=5 hierarchy is ~2 MB, so
// here a cycle is split into phase kernels that read their operands from
// device memory; the host-side recursions in dgtpu_torch/ops/soa.py
// (SoAVCycle._cycle) and dgtpu_torch/ops/stokes_soa.py
// (SoAStokesVCycle._cycle) launch them in order on PyTorch's current stream:
//
//   K1 half_sweep     one red-black block-GS half-sweep (_soa_smooth body;
//                     the Stokes _bgs_A on the momentum blocks)
//   K3 small_gemm     polynomial R/P, u += P e, the dense coarse inverse
//   K4 geo_transfer   2x2 geometric agglomeration R/P
//   K5 stencil_apply  base + sign (blk_c[0] x_c + sum_s blk_c[s] nbr_s(x_{1-c}))
//                     with rectangular blocks: the Poisson residual
//                     (_soa_residual, base = rhs, sign = -1), every stencil
//                     matvec of the DGS sweep, the saddle residual, and
//                     SoAStokesVCycle.build_matvec
//   K6 dg_half_sweep  one color of the Stokes pressure pass (_bgs_dg,
//                     pallas_stokes.py:382-390) given g = G p from K5
//
// Layout (the TPU kernels'): a color-pair vector is (2, B, C) with C =
// Nj * Ni/2 cells per color in the contiguous axis; operator blocks per color
// are (5, B_src, B_dst, C), diagonal matrices (B_src, B_dst, C).  Cells on the
// fast axis make every block read coalesced: for fixed (slot, b_src, b_dst) a
// warp reads 32 consecutive cells.
//
// What bounds them on the card: at 8x8 (C = 32 on the finest level) a kernel
// is one or two CTAs and a cycle is ~90 (Poisson p5) to ~800 (Stokes
// W-cycle) launches, so the host's launch rate bounds the cycle; at 64x64 p5
// (C = 2048) K1 and K5 stream the finest level's blocks (~42 MB per
// half-sweep), so device-memory bytes bound them.  Fusing phases, CUDA graphs
// over the launch sequence and a persistent cycle kernel are later work.
//
// Every entry point is extern "C" (bound with ctypes), takes raw device
// pointers the caller allocated, launches on the given stream without
// synchronising, and returns cudaGetLastError() as an int.  ``accumulate``
// selects ``out = base + result`` (base may be null otherwise).

#include <cuda_runtime.h>

namespace {

constexpr int TC = 32;  // cells per CTA: one warp spans 32 consecutive cells

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
// of the stencil row.  blk is one color's (5, Bs, Bd, C).
__device__ __forceinline__ float stencil_row(const float* __restrict__ blk,
                                             const float* fld, int s0, int a, int Bs,
                                             int Bd, int C, int q, int tx) {
    const size_t slot = (size_t)Bs * Bd * C;
    float acc = 0.f;
    for (int s = s0; s < 5; ++s) {
        const float* A = blk + (size_t)s * slot;
        const float* f = fld + s * Bs * TC + tx;
        for (int b = 0; b < Bs; ++b)
            acc = fmaf(A[((size_t)b * Bd + a) * C + q], f[b * TC], acc);
    }
    return acc;
}

// K1: one red-black half-sweep, the body of _soa_smooth (pallas_soa.py:341-353):
//   out[color]   = (base[color] +)   Dinv_c . (rhs_c - sum_{s=1..4} A_c[s] . nbr_s(u[1-color]))
//   out[1-color] = (base[1-color] +) u[1-color]
// CTA = TC cells x blockDim.y output-mode lanes.  The CTA stages the fields
// of its cells in shared memory (5*B*TC floats; slot 0 is unused here), then
// t = rhs - off in place of slot 0, then applies Dinv, so each cell's B
// modes are gathered once and every block element is read once.  ``base``
// folds the Stokes sweep's uv + du_s into the last half-sweep.
__global__ void half_sweep_kernel(const float* __restrict__ blocks,
                                  const float* __restrict__ dinv,
                                  const float* __restrict__ rhs,
                                  const float* __restrict__ u,
                                  const float* __restrict__ base,
                                  float* __restrict__ out,
                                  int color, int B, int C, int nh, int periodic,
                                  int accumulate) {
    extern __shared__ float fld[];   // (5, B, TC): t, then the four neighbor fields
    const int tx = threadIdx.x, ty = threadIdx.y, ny = blockDim.y;
    const int q = blockIdx.x * TC + tx;
    const bool valid = q < C;
    const size_t BC = (size_t)B * C;
    const float* o = u + (size_t)(1 - color) * BC;
    if (valid) {
        for (int s = 0; s < 4; ++s) {
            const int lane = nbr_lane(q, s, color, C, nh, periodic);
            for (int b = ty; b < B; b += ny)
                fld[((s + 1) * B + b) * TC + tx] = o[(size_t)b * C + lane];
        }
    }
    __syncthreads();
    if (valid)
        for (int a = ty; a < B; a += ny)
            fld[a * TC + tx] = rhs[(size_t)a * C + q]
                             - stencil_row(blocks, fld, 1, a, B, B, C, q, tx);
    __syncthreads();
    if (!valid) return;
    for (int a = ty; a < B; a += ny) {
        float acc = 0.f;
        for (int b = 0; b < B; ++b)
            acc = fmaf(dinv[((size_t)b * B + a) * C + q], fld[b * TC + tx], acc);
        const size_t oc = (size_t)color * BC + (size_t)a * C + q;
        const size_t oo = (size_t)(1 - color) * BC + (size_t)a * C + q;
        const float keep = o[(size_t)a * C + q];
        out[oc] = accumulate ? base[oc] + acc : acc;
        out[oo] = accumulate ? base[oo] + keep : keep;
    }
}

// K3: out[z] = (base[z] +) W(M,K) . x[z](K,N) for z < batch.  Covers the
// polynomial restriction / prolongation (pallas_soa.py:364-372, :382-390;
// W = R (B_c,B) or P (B,B_c), N = C, batch = the two colors), the u += P.e
// update (accumulate), and the dense coarse inverse (:400-410; M = K =
// 2 B0 C0, N = 1).  One thread per output; threads along N read x
// coalesced and W as a broadcast.  K <= 2 B0 C0 is small on every level.
__global__ void small_gemm_kernel(const float* __restrict__ W,
                                  const float* __restrict__ x,
                                  const float* __restrict__ base,
                                  float* __restrict__ out,
                                  int M, int K, int N, int accumulate) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    const int m = blockIdx.y * blockDim.y + threadIdx.y;
    const int z = blockIdx.z;
    if (n >= N || m >= M) return;
    const float* xz = x + (size_t)z * K * N;
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
        acc = fmaf(W[(size_t)m * K + k], xz[(size_t)k * N + n], acc);
    const size_t o = (size_t)z * M * N + (size_t)m * N + n;
    out[o] = accumulate ? base[o] + acc : acc;
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
// for both colors (blockIdx.y), rectangular blocks (5, Bs, Bd, C) per color.
// The CTA stages the five fields of Bs modes for its 32 cells (5*Bs*TC
// floats), then each thread row reduces output modes a = ty, ty+ny, ....
__global__ void stencil_apply_kernel(const float* __restrict__ blocks,
                                     const float* __restrict__ x,
                                     const float* __restrict__ base,
                                     float* __restrict__ out,
                                     int Bs, int Bd, int C, int nh, int periodic,
                                     float sign, int accumulate) {
    extern __shared__ float fld[];   // (5, Bs, TC)
    const int tx = threadIdx.x, ty = threadIdx.y, ny = blockDim.y;
    const int color = blockIdx.y;
    const int q = blockIdx.x * TC + tx;
    const bool valid = q < C;
    if (valid)
        stage_fields(fld, x, color, Bs, C, q, tx, ty, ny, nh, periodic);
    __syncthreads();
    if (!valid) return;
    const float* blk = blocks + (size_t)color * 5 * Bs * Bd * C;
    for (int a = ty; a < Bd; a += ny) {
        const float y = sign * stencil_row(blk, fld, 0, a, Bs, Bd, C, q, tx);
        const size_t o = (size_t)color * Bd * C + (size_t)a * C + q;
        out[o] = accumulate ? base[o] + y : y;
    }
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

int soa_small_gemm(const float* W, const float* x, const float* base, float* out,
                   int M, int K, int N, int batch, int accumulate,
                   cudaStream_t stream) {
    dim3 block(32, 8);
    dim3 grid((N + 31) / 32, (M + 7) / 8, batch);
    small_gemm_kernel<<<grid, block, 0, stream>>>(W, x, base, out, M, K, N,
                                                  accumulate);
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

int soa_stencil_apply(const float* blocks, const float* x, const float* base,
                      float* out, int Bs, int Bd, int C, int nh, int periodic,
                      float sign, int accumulate, cudaStream_t stream) {
    dim3 block(TC, mode_lanes(Bd));
    dim3 grid((C + TC - 1) / TC, 2);
    size_t smem = (size_t)5 * Bs * TC * sizeof(float);
    stencil_apply_kernel<<<grid, block, smem, stream>>>(blocks, x, base, out, Bs, Bd,
                                                        C, nh, periodic, sign,
                                                        accumulate);
    return (int)cudaGetLastError();
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
