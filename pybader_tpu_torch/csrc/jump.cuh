// In-place pointer jumping to the fixed point, shared by the roots
// (flood.cu) and the chase (chase.cu).
//
// A pass sets root[i] = root[root[i]] wherever that moves it.  Updating in
// place lets a pass read pointers that other threads already advanced, so
// chains shrink at least as fast as in synchronous doubling: about
// log2(longest chain) passes.  The fixed points are the voxels that point
// at themselves; an acyclic pointer graph (strict ascent) has no others.
//
// Bound: device memory and gather latency.  A pass reads root[i]
// (coalesced) and root[root[i]] (a gather) and writes back changed entries:
// about 12 bytes a voxel.  The host reads one flag word per pass, which a
// warp vote sets once per warp that moved a pointer.
#pragma once

#include "common.cuh"

namespace pb {
namespace {

__global__ void jump_kernel(int* __restrict__ root, long long n,
                            int* __restrict__ changed) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    bool moved = false;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         i < n; i += stride) {
        const int r = root[i];
        const int rr = root[r];
        if (rr != r) {
            root[i] = rr;
            moved = true;
        }
    }
    if (__any_sync(0xffffffffu, moved) && (threadIdx.x & 31) == 0) {
        *changed = 1;
    }
}

// Error code for a pointer graph that did not converge in max_passes
// (never a valid cudaError_t).
constexpr int kNotConverged = -1;

// Jump root[0, n) to its fixed point on stream s, at most max_passes passes;
// flag is one int of device scratch.  Returns 0, a cudaError_t, or
// kNotConverged.  (In the unnamed namespace with its kernel: each source
// that includes this header launches its own copy.)
int jump_to_fixed_point(int* root, long long n, int* flag, int max_passes,
                        int device, cudaStream_t s) {
    const int blocks = blocks_for(n, device);
    for (int pass = 0; pass < max_passes; ++pass) {
        cudaMemsetAsync(flag, 0, sizeof(int), s);
        jump_kernel<<<blocks, kThreads, 0, s>>>(root, n, flag);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        int changed = 0;
        cudaMemcpyAsync(&changed, flag, sizeof(int), cudaMemcpyDeviceToHost,
                        s);
        err = cudaStreamSynchronize(s);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (!changed) return static_cast<int>(cudaGetLastError());
    }
    return kNotConverged;
}

}  // namespace
}  // namespace pb
