// The value chase along ascent step codes.
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
// The TPU kernel composes pointers without gathers: 27-way roll-select
// passes over VMEM block+halo tiles, a per-block early exit, sweep-level
// skip flags, in-place aliasing and a ladder of tile configs.  All of that
// works around slow TPU gathers.  Hopper gathers fast, so this kernel:
//   1. derives each voxel's pointer from its code (pointer_kernel),
//   2. jumps the pointers in place to their roots (jump.cuh's
//      jump_to_fixed_point, shared with flood.cu),
//   3. gathers the values at the roots and counts the voxels whose value
//      changed (gather_kernel); the mesh chase reads that count as its
//      round's change flag.
//
// Bound: device memory.  The function reads 1 byte of code and 4 of value a
// voxel and writes 4 of output: 9 bytes.  The int32 pointer scratch adds 4
// bytes written once and about 12 a jump pass, over about log2(longest
// chain) passes; the value gather is random but mostly within a basin.

#include "common.cuh"
#include "grad.cuh"
#include "jump.cuh"

namespace {

__global__ void pointer_kernel(const unsigned char* __restrict__ codes,
                               int* __restrict__ ptr, int nx, int ny,
                               int nz) {
    const long long n = static_cast<long long>(nx) * ny * nz;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         i < n; i += stride) {
        int x, y, z;
        pb::unflatten(i, ny, nz, x, y, z);
        const int code = codes[i];
        ptr[i] = (pb::wrap(x + code / 9 - 1, nx) * ny +
                  pb::wrap(y + (code / 3) % 3 - 1, ny)) * nz +
                 pb::wrap(z + code % 3 - 1, nz);
    }
}

// out[i] = values[root[i]]; count += the voxels whose value changed, one
// warp-reduced atomic a warp.
__global__ void gather_kernel(const int* __restrict__ values,
                              const int* __restrict__ root,
                              int* __restrict__ out, long long n,
                              unsigned int* __restrict__ count) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    unsigned int changed = 0;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         i < n; i += stride) {
        const int v = values[root[i]];
        out[i] = v;
        changed += v != values[i] ? 1u : 0u;
    }
    changed = __reduce_add_sync(0xffffffffu, changed);
    if ((threadIdx.x & 31) == 0 && changed) atomicAdd(count, changed);
}

}  // namespace

// flag: pb::kGroup + 1 ints of device scratch, the jump passes' flags and
// then the changed count (read by the wrapper); ptr: n ints of scratch,
// 16-byte aligned.
PB_EXPORT int pb_chase(void* values, void* codes, void* out, void* ptr,
                       void* flag, int nx, int ny, int nz, int max_passes,
                       int device, void* stream) {
    cudaSetDevice(device);
    cudaStream_t s = pb::as_stream(stream);
    const long long n = static_cast<long long>(nx) * ny * nz;
    int* flag_d = static_cast<int*>(flag);
    int* ptr_d = static_cast<int*>(ptr);
    unsigned int* count = reinterpret_cast<unsigned int*>(flag_d + pb::kGroup);
    cudaMemsetAsync(count, 0, sizeof(int), s);
    const int blocks = pb::blocks_for(n, device);
    pointer_kernel<<<blocks, pb::kThreads, 0, s>>>(
        static_cast<const unsigned char*>(codes), ptr_d, nx, ny, nz);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    int passes;
    const int jumped = pb::jump_to_fixed_point(ptr_d, n, flag_d, max_passes,
                                               &passes, device, s);
    if (jumped != 0) return jumped;
    gather_kernel<<<blocks, pb::kThreads, 0, s>>>(
        static_cast<const int*>(values), ptr_d, static_cast<int*>(out), n,
        count);
    return static_cast<int>(cudaGetLastError());
}
