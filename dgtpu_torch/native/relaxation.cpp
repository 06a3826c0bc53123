// Native block-relaxation kernels on the 5-point stencil layout (host C++,
// a copy of dgtpu's dgtpu/native/relaxation.cpp for the port).
//
// The analog of the reference's native-code surface: the pyamg.amg_core C++
// smoother kernels (bsr_jacobi / bsr_gauss_seidel / block_gauss_seidel) on
// the reference's hot path (dgfem/pyamg_relaxation.py:168-173, :253-255).
// They run float64 sweeps on the host with the exact pyamg sweep order, an
// independent check of the port's plain torch smoothers.
//
// Stencil layout (see dgtpu_torch/ops/stencil.py):
//   blocks : (N, 5, B, B) row-major, slot order [self, iL, iR, jL, jR]
//   nbr    : (N, 5) int32 neighbor element indices (self where masked)
//   mask   : (N, 5) uint8
//   dinv   : (N, B, B) inverses of the diagonal blocks
//
// Build: g++ -O3 -shared -fPIC -std=c++17 relaxation.cpp -o librelax.so
// (dgtpu_torch/native/__init__.py builds it into build/dgtpu_torch/).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// y = A @ x
void stencil_matvec(const double* blocks, const int32_t* nbr,
                    const uint8_t* mask, int64_t n, int64_t b,
                    const double* x, double* y) {
    const int64_t bb = b * b;
    for (int64_t e = 0; e < n; ++e) {
        double* ye = y + e * b;
        std::memset(ye, 0, sizeof(double) * b);
        for (int s = 0; s < 5; ++s) {
            if (!mask[e * 5 + s]) continue;
            const double* blk = blocks + (e * 5 + s) * bb;
            const double* xn = x + (int64_t)nbr[e * 5 + s] * b;
            for (int64_t i = 0; i < b; ++i) {
                double acc = 0.0;
                const double* row = blk + i * b;
                for (int64_t j = 0; j < b; ++j) acc += row[j] * xn[j];
                ye[i] += acc;
            }
        }
    }
}

// one lexicographic block Gauss-Seidel sweep (pyamg semantics):
//   x_e <- omega * Dinv_e (b_e - sum_{s>0} A_es x_nbr) + (1-omega) x_e
void block_gauss_seidel_sweep(const double* blocks, const int32_t* nbr,
                              const uint8_t* mask, const double* dinv,
                              int64_t n, int64_t b, const double* rhs,
                              double* x, int backward, double omega) {
    const int64_t bb = b * b;
    std::vector<double> r(b), xe_new(b);
    for (int64_t k = 0; k < n; ++k) {
        const int64_t e = backward ? (n - 1 - k) : k;
        // r = rhs_e - offdiag contributions
        std::memcpy(r.data(), rhs + e * b, sizeof(double) * b);
        for (int s = 1; s < 5; ++s) {
            if (!mask[e * 5 + s]) continue;
            const double* blk = blocks + (e * 5 + s) * bb;
            const double* xn = x + (int64_t)nbr[e * 5 + s] * b;
            for (int64_t i = 0; i < b; ++i) {
                double acc = 0.0;
                const double* row = blk + i * b;
                for (int64_t j = 0; j < b; ++j) acc += row[j] * xn[j];
                r[i] -= acc;
            }
        }
        const double* di = dinv + e * bb;
        double* xe = x + e * b;
        for (int64_t i = 0; i < b; ++i) {
            double acc = 0.0;
            const double* row = di + i * b;
            for (int64_t j = 0; j < b; ++j) acc += row[j] * r[j];
            xe_new[i] = omega * acc + (1.0 - omega) * xe[i];
        }
        std::memcpy(xe, xe_new.data(), sizeof(double) * b);
    }
}

// damped block Jacobi sweep
void block_jacobi_sweep(const double* blocks, const int32_t* nbr,
                        const uint8_t* mask, const double* dinv,
                        int64_t n, int64_t b, const double* rhs,
                        double* x, double omega) {
    const int64_t bb = b * b;
    std::vector<double> xnew((size_t)(n * b));
    for (int64_t e = 0; e < n; ++e) {
        std::vector<double> r(rhs + e * b, rhs + (e + 1) * b);
        for (int s = 1; s < 5; ++s) {
            if (!mask[e * 5 + s]) continue;
            const double* blk = blocks + (e * 5 + s) * bb;
            const double* xn = x + (int64_t)nbr[e * 5 + s] * b;
            for (int64_t i = 0; i < b; ++i) {
                double acc = 0.0;
                const double* row = blk + i * b;
                for (int64_t j = 0; j < b; ++j) acc += row[j] * xn[j];
                r[i] -= acc;
            }
        }
        const double* di = dinv + e * bb;
        for (int64_t i = 0; i < b; ++i) {
            double acc = 0.0;
            const double* row = di + i * b;
            for (int64_t j = 0; j < b; ++j) acc += row[j] * r[j];
            xnew[e * b + i] = omega * acc + (1.0 - omega) * x[e * b + i];
        }
    }
    std::memcpy(x, xnew.data(), sizeof(double) * (size_t)(n * b));
}

}  // extern "C"
