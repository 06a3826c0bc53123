// Helpers shared by soa_kernels.cu and rolled_kernels.cu.  Each source is
// built into a library of its own (dgtpu_torch/ops/_kernels.py hashes this
// header with it), so each library holds its own copy.

#pragma once

#include <cuda_runtime.h>

namespace {

// The current device's SM count, queried at the first launch and kept for
// the life of the process (the port drives one card, or cards of one kind),
// so a launch's grid costs no host call; 0 if the query failed.
inline int sm_count() {
    static const int n = [] {
        int dev = 0, sms = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                cudaSuccess)
            return 0;
        return sms;
    }();
    return n;
}

// A 4-byte asynchronous copy from device memory to shared memory (sm_80 and
// later); the copies a thread issued are complete after cp_async_wait_all.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace
