// In-place pointer jumping to the fixed point, shared by the roots
// (flood.cu, after its tile pass) and the chase (chase.cu).
//
// A pass sets root[i] = root[root[i]] wherever that moves it.  Updating in
// place lets a pass read pointers that other threads already advanced, so
// chains shrink at least as fast as in synchronous doubling: about
// log2(longest chain) passes.  The fixed points are the voxels that point
// at themselves; an acyclic pointer graph (strict ascent) has no others.
//
// A thread takes four voxels in one 16-byte vector, so it has four gathers
// in flight.  Passes are launched kGroup at a time, each with its own flag
// word, which a warp vote sets once per warp that moved a pointer; the host
// reads the group's flags once and stops after the first pass that moved
// nothing.  A pass on a converged graph writes nothing, so the rest of its
// group is harmless.
//
// Bound: device memory and gather latency.  A pass reads root[i]
// (coalesced) and root[root[i]] (a gather, mostly roots, hot in L2) and
// writes back changed entries.
#pragma once

#include "common.cuh"

namespace pb {
namespace {

// Passes launched between two host reads of their flags (the blob field's
// parents take 6 after the roots' tile pass, white noise's 4).
constexpr int kGroup = 2;

// Error code for a pointer graph that did not converge in max_passes
// (never a valid cudaError_t).
constexpr int kNotConverged = -1;

// root[i] = root[root[i]] in place; root is 16-byte aligned.
__global__ void jump_kernel(int* __restrict__ root, long long n,
                            int* __restrict__ changed) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                            threadIdx.x;
    int4* r4 = reinterpret_cast<int4*>(root);
    bool moved = false;
    for (long long i = first; i < n / 4; i += stride) {
        const int4 r = r4[i];
        const int4 rr = make_int4(root[r.x], root[r.y], root[r.z], root[r.w]);
        if (rr.x != r.x || rr.y != r.y || rr.z != r.z || rr.w != r.w) {
            r4[i] = rr;
            moved = true;
        }
    }
    for (long long i = n / 4 * 4 + first; i < n; i += stride) {
        const int r = root[i], rr = root[r];
        if (rr != r) {
            root[i] = rr;
            moved = true;
        }
    }
    if (__any_sync(0xffffffffu, moved) && (threadIdx.x & 31) == 0)
        *changed = 1;
}

// Jump root[0, n) (16-byte aligned) to its fixed point on stream s, at most
// max_passes passes; flags is kGroup ints of device scratch.  *passes
// receives the passes run, the last of them the one that moved nothing.
// Returns 0, a cudaError_t, or kNotConverged.  (In the unnamed namespace
// with its kernel: each source that includes this header launches its own
// copy.)
int jump_to_fixed_point(int* root, long long n, int* flags, int max_passes,
                        int* passes, int device, cudaStream_t s) {
    *passes = 0;
    const int blocks = blocks_for((n + 3) / 4, device);
    for (int done = 0; done < max_passes;) {
        const int k = kGroup < max_passes - done ? kGroup : max_passes - done;
        cudaMemsetAsync(flags, 0, k * sizeof(int), s);
        for (int i = 0; i < k; ++i)
            jump_kernel<<<blocks, kThreads, 0, s>>>(root, n, flags + i);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        int moved[kGroup];
        cudaMemcpyAsync(moved, flags, k * sizeof(int), cudaMemcpyDeviceToHost,
                        s);
        err = cudaStreamSynchronize(s);
        if (err != cudaSuccess) return static_cast<int>(err);
        for (int i = 0; i < k; ++i) {
            if (!moved[i]) {
                *passes = done + i + 1;
                return 0;
            }
        }
        done += k;
    }
    *passes = max_passes;
    return kNotConverged;
}

}  // namespace
}  // namespace pb
