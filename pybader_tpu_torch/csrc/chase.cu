// The value chase along ascent step codes: each voxel's root, then one
// gather of the values at the roots.
//
// Replaces the TPU kernel pybader_tpu/ops/pallas_chase.py (the pl.pallas_call
// at :293 in _chase_sweep_impl, driven by _run_chase, :246-436), which
// resolve_roots_pallas and labels_oneshot call and parallel/chase.py lifts
// to the device mesh.  It returns the fixed point of
//     out[i] = values[i + OFFSETS[codes[i]]]
// on the array it is given, with periodic wrap; code 13 is the self step.
// Every chain of an acyclic code graph ends on a code-13 voxel, so the fixed
// point is out[i] = values[root(i)].
//
// The TPU kernel composes values by 27-way roll-select passes over VMEM
// block+halo tiles, with per-block early exits, skip flags and in-place
// aliasing: all of that works around slow TPU gathers.  Hopper gathers fast,
// so the chase splits in two:
//   1. pb_chase_roots: each voxel's root from the 1-byte codes -- the tile
//      pass of tile.cuh (CodeSource: the in-tile successor straight from the
//      code, no flat index and no division), then jump.cuh's global jump
//      passes, both shared with flood.cu's roots;
//   2. pb_chase_gather: out[i] = values[root[i]] over the interior of the
//      block (all of it, or without the one-voxel ring the mesh pads a shard
//      with, so the crop is fused), counting the voxels whose value changed.
// The codes do not change between the rounds of the mesh chase (the ring is
// frozen, code 13), only the halo values do, so the mesh resolves each
// shard's roots once a call and runs one gather a round; the round's fixed
// point is values[root(i)], what JAX's _local_fixed_point reaches.
//
// Bound: device memory.  The roots read 1 byte of code and write 4 of root
// a voxel (the jump passes' reads are the kernel's own traffic); a gather
// reads the root and the old value and writes the new one, 12 bytes a
// voxel, plus the value at the root, a gather into a few basins' roots that
// stays in L2.

#include "common.cuh"
#include "jump.cuh"
#include "tile.cuh"

namespace {

constexpr int kGatherThreads = 256;

// The values at the four roots of one 16-byte vector of roots.
__device__ __forceinline__ int4 gather4(const int* __restrict__ values,
                                        int4 r) {
    return make_int4(__ldg(&values[r.x]), __ldg(&values[r.y]),
                     __ldg(&values[r.z]), __ldg(&values[r.w]));
}

// out (lx, ly, nz) = values[root[i]] for voxel i = (x + px, y + py, z) of
// the padded (lx + 2 px, ly + 2 py, nz) block; count += the voxels whose
// value changed, one warp-reduced atomic a warp.  A warp takes one z-row of
// the output at a time; kVec: 16-byte vectors (nz % 4 == 0).
template <bool kVec>
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const int* __restrict__ values, const int* __restrict__ root,
              int* __restrict__ out, int lx, int ly, int nz, int px, int py,
              unsigned int* __restrict__ count) {
    const int lane = threadIdx.x & 31;
    const int warps = gridDim.x * (kGatherThreads / 32);
    const int ny = ly + 2 * py;
    const long long rows = static_cast<long long>(lx) * ly;
    unsigned int changed = 0;
    for (long long r = static_cast<long long>(blockIdx.x) *
                           (kGatherThreads / 32) + threadIdx.x / 32;
         r < rows; r += warps) {
        const int x = static_cast<int>(r / ly), y = static_cast<int>(r % ly);
        const long long src = (static_cast<long long>(x + px) * ny + y + py) *
                              nz;
        const long long dst = r * nz;
        if (kVec) {
            const int4* root4 = reinterpret_cast<const int4*>(root + src);
            const int4* old4 = reinterpret_cast<const int4*>(values + src);
            int4* out4 = reinterpret_cast<int4*>(out + dst);
            for (int v = lane; v < nz / 4; v += 32) {
                const int4 o = __ldg(&old4[v]);
                const int4 n = gather4(values, __ldg(&root4[v]));
                out4[v] = n;
                changed += (n.x != o.x) + (n.y != o.y) + (n.z != o.z) +
                           (n.w != o.w);
            }
        } else {
            for (int z = lane; z < nz; z += 32) {
                const int n = __ldg(&values[__ldg(&root[src + z])]);
                out[dst + z] = n;
                changed += n != __ldg(&values[src + z]) ? 1u : 0u;
            }
        }
    }
    changed = __reduce_add_sync(0xffffffffu, changed);
    if (lane == 0 && changed) atomicAdd(count, changed);
}

}  // namespace

// codes, root: nx * ny * nz (root 16-byte aligned).  flags: pb::kGroup
// ints of device scratch.  *passes receives the global jump passes run
// after the tile pass, the last of them the one that moved nothing.
// Returns 0, a cudaError_t, or kNotConverged after max_passes passes that
// all moved.
PB_EXPORT int pb_chase_roots(void* codes, void* root, int nx, int ny, int nz,
                             void* flags, int max_passes, int* passes,
                             int device, void* stream) {
    cudaSetDevice(device);
    cudaStream_t s = pb::as_stream(stream);
    *passes = 0;
    const long long n = static_cast<long long>(nx) * ny * nz;
    if (n == 0) return 0;
    int* r = static_cast<int*>(root);
    const cudaError_t err = pb::tile_roots(
        pb::CodeSource{static_cast<const unsigned char*>(codes)}, r, nx, ny,
        nz, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return pb::jump_to_fixed_point(r, n, static_cast<int*>(flags), max_passes,
                                   passes, device, s);
}

// values, root: the padded (lx + 2 px, ly + 2 py, nz) block; out: the
// (lx, ly, nz) interior, all three 16-byte aligned.  count: one int of
// device scratch, zeroed here, then the voxels whose value changed.
PB_EXPORT int pb_chase_gather(void* values, void* root, void* out,
                              void* count, int lx, int ly, int nz, int px,
                              int py, int device, void* stream) {
    cudaSetDevice(device);
    cudaStream_t s = pb::as_stream(stream);
    cudaMemsetAsync(count, 0, sizeof(int), s);
    const long long rows = static_cast<long long>(lx) * ly;
    if (rows == 0 || nz == 0) return static_cast<int>(cudaGetLastError());
    const long long want = (rows + kGatherThreads / 32 - 1) /
                           (kGatherThreads / 32);
    const int blocks = pb::blocks_for(want * kGatherThreads, device);
    const auto kernel = nz % 4 == 0 ? gather_kernel<true>
                                    : gather_kernel<false>;
    kernel<<<blocks, kGatherThreads, 0, s>>>(
        static_cast<const int*>(values), static_cast<const int*>(root),
        static_cast<int*>(out), lx, ly, nz, px, py,
        static_cast<unsigned int*>(count));
    return static_cast<int>(cudaGetLastError());
}
