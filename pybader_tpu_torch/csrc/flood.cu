// Ascent-pointer root resolution by pointer jumping.
//
// Replaces the TPU kernel pybader_tpu/ops/pallas_flood.py:_scan_call, the
// directional Gauss-Seidel plane scan that scanflood.flood_rounds repeats
// until every voxel carries its root maximum's label.  The scans exist
// because XLA gathers are slow on the TPU; Hopper gathers fast, so this
// computes the same result -- every voxel's root, the maximum its ascent
// chain ends in -- the way pybader_tpu/ops/pointer.py:resolve_roots does:
//     root[i] = root[root[i]]
// repeated until a pass changes nothing.  Maxima and vacuum voxels point
// at themselves and are the only fixed points (ascent is strictly uphill,
// so the pointer graph has no cycles).  Turning roots into labels (rank of
// the root among the maxima) is plain torch in ops/pointer.py, as the XLA
// ops around the TPU kernel were.
//
// Bound: device memory and gather latency.  A pass reads root[i] (coalesced)
// and root[root[i]] (a gather) and writes back changed entries: about 12
// bytes a voxel.  Updating in place lets a pass read pointers that other
// threads already advanced, so chains shrink at least as fast as in
// synchronous doubling: about log2(longest chain) passes.  The convergence
// flag is one warp vote per warp, so the single flag word is not a hot spot.

#include "common.cuh"

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

}  // namespace

// Error code for a pointer graph that did not converge in max_passes
// (never a valid cudaError_t).
constexpr int kNotConverged = -1;

PB_EXPORT int pb_resolve_roots(void* root, long long n, void* flag,
                               int max_passes, int device, void* stream) {
    cudaSetDevice(device);
    cudaStream_t s = pb::as_stream(stream);
    int* flag_d = static_cast<int*>(flag);
    const int blocks = pb::blocks_for(n, device);
    for (int pass = 0; pass < max_passes; ++pass) {
        cudaMemsetAsync(flag_d, 0, sizeof(int), s);
        jump_kernel<<<blocks, pb::kThreads, 0, s>>>(static_cast<int*>(root),
                                                   n, flag_d);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        int changed = 0;
        cudaMemcpyAsync(&changed, flag_d, sizeof(int), cudaMemcpyDeviceToHost,
                        s);
        err = cudaStreamSynchronize(s);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (!changed) return static_cast<int>(cudaGetLastError());
    }
    return kNotConverged;
}
