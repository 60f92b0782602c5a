// Shared helpers for the pybader_tpu_torch kernels.
//
// Every entry point has a plain C interface (loaded with ctypes): device
// pointers and the CUDA stream arrive as void*, sizes as int / long long.
// An entry returns cudaGetLastError() after its launches (0 on success);
// the Python wrapper raises on anything else.
#pragma once

#include <cuda_runtime.h>

#define PB_EXPORT extern "C" __attribute__((visibility("default")))

namespace pb {

constexpr int kThreads = 256;

// Grid for a grid-stride loop over n items: enough blocks to fill every SM
// several times over, never more than the items need.
inline int blocks_for(long long n, int device) {
    int sms = 132;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    long long want = (n + kThreads - 1) / kThreads;
    long long cap = static_cast<long long>(sms) * 16;
    if (want > cap) want = cap;
    return want < 1 ? 1 : static_cast<int>(want);
}

// Blocks of `threads` threads that `kernel` can keep resident on every SM
// of the device at once, with `smem` bytes of dynamic shared memory each:
// the grid of a persistent launch.
template <class Kernel>
inline int resident_blocks(Kernel kernel, int threads, size_t smem,
                           int device) {
    int sms = 132, per_sm = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  smem);
    return (per_sm < 1 ? 1 : per_sm) * sms;
}

inline cudaStream_t as_stream(void* s) {
    return reinterpret_cast<cudaStream_t>(s);
}

// v mod n for any v (halo coordinates of axes shorter than the halo wrap
// more than once).
__device__ __forceinline__ int mod_n(int v, int n) {
    v %= n;
    return v < 0 ? v + n : v;
}

// One bit per byte of a 16-byte vector: byte k -> bit k.  EQ: byte == -2;
// else byte != 0.
template <bool EQ>
__device__ __forceinline__ unsigned byte_mask16(uint4 v) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    unsigned m = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const unsigned e = EQ ? __vcmpeq4(w[k], 0xFEFEFEFEu)
                              : __vcmpne4(w[k], 0u);
        m |= ((e & 0x01u) | ((e >> 7) & 0x02u) | ((e >> 14) & 0x04u) |
              ((e >> 21) & 0x08u)) << (4 * k);
    }
    return m;
}

// n / d for 0 <= n < 2**31 and 2 <= d < 2**31, with magic = ceil(2**64 / d):
// exact, since n * (magic * d - 2**64) < 2**64 (no integer division).
__device__ __forceinline__ int div_magic(int n, unsigned long long magic) {
    return static_cast<int>(
        __umul64hi(static_cast<unsigned long long>(n), magic));
}

// Division of 0 <= n < 2**31 by a divisor fixed on the host: a 64-bit high
// multiply in place of the integer division's dozens of instructions.
struct Divisor {
    int d;
    unsigned long long magic;

    static Divisor of(int d) {
        return Divisor{d, d < 2 ? 0ull : ~0ull / d + 1};
    }
    __device__ __forceinline__ int div(int n) const {
        return d == 1 ? n : div_magic(n, magic);
    }
};

// Flat voxel index -> (x, y, z) of an x-major (nx, ny, nz) grid.
__device__ __forceinline__ void unflatten(long long i, int ny, int nz,
                                          int& x, int& y, int& z) {
    z = static_cast<int>(i % nz);
    long long t = i / nz;
    y = static_cast<int>(t % ny);
    x = static_cast<int>(t / ny);
}

}  // namespace pb
