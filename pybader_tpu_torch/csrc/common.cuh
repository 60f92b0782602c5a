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

// Flat voxel index -> (x, y, z) of an x-major (nx, ny, nz) grid.
__device__ __forceinline__ void unflatten(long long i, int ny, int nz,
                                          int& x, int& y, int& z) {
    z = static_cast<int>(i % nz);
    long long t = i / nz;
    y = static_cast<int>(t % ny);
    x = static_cast<int>(t / ny);
}

}  // namespace pb
