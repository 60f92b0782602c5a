// Edge classification: the ``known`` grid of neargrid refinement.
//
// Replace the TPU kernels of pybader_tpu/ops/pallas_edges.py (_call, :178):
// edge_find (check=False, :191) and edge_check (check=True, :199), whose
// semantics are the XLA stencils _edge_find_xla / _edge_check_xla of
// pybader_tpu/ops/edges.py.  known: -2 edge, -1 near an edge, 2 interior or
// local maximum, 0 vacuum away from edges.  A voxel is an edge when it is
// not vacuum, not a local maximum (is_max, the stencil's self step) and some
// non-vacuum voxel of its periodic 26-neighbourhood carries another label;
// vacuum voxels are never edge candidates.
//
// The TPU kernel keeps a 2-plane halo of label planes in VMEM because the
// near-edge test needs a 5x5x5 cone.  Here each kernel is two plain passes:
// the first writes one flag byte a voxel (edge, or new edge), the second
// dilates those flags over the 27-neighbourhood into the final known.
//
// Bound: device memory.  edge_find reads labels and is_max and writes known
// (6 bytes a voxel); edge_check also reads the old known (7 bytes a voxel).
// The flag scratch adds 2 bytes a voxel of traffic, and the 26 neighbour
// reads of each pass are L1/L2 hits shared by neighbouring threads (one
// thread per voxel, z fastest across a warp).  A shared-memory tile with a
// halo would cut the L2 traffic; that is later work.

#include "common.cuh"

namespace {

struct Box {
    int idx[27];  // the 27-neighbourhood, self included, periodic
};

__device__ __forceinline__ void box_of(long long i, int nx, int ny, int nz,
                                       Box& b) {
    int x, y, z;
    pb::unflatten(i, ny, nz, x, y, z);
    int xs[3], ys[3], zs[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        xs[d] = (x + d - 1 + nx) % nx;
        ys[d] = (y + d - 1 + ny) % ny;
        zs[d] = (z + d - 1 + nz) % nz;
    }
    int k = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
            for (int e = 0; e < 3; ++e)
                b.idx[k++] = (xs[a] * ny + ys[c]) * nz + zs[e];
}

// Some non-vacuum voxel of the box carries a label other than ``own``.
__device__ __forceinline__ bool differs(const int* __restrict__ labels,
                                        const Box& b, int own) {
    bool e = false;
#pragma unroll
    for (int k = 0; k < 27; ++k) {
        const int l = labels[b.idx[k]];
        e |= (l != -1) & (l != own);
    }
    return e;
}

__device__ __forceinline__ bool any_flag(const unsigned char* __restrict__ f,
                                         const Box& b) {
    bool any = false;
#pragma unroll
    for (int k = 0; k < 27; ++k) any |= f[b.idx[k]] != 0;
    return any;
}

#define PB_GRID_LOOP(i, n)                                                   \
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +     \
                       threadIdx.x;                                          \
         i < (n); i += static_cast<long long>(gridDim.x) * blockDim.x)

// edge_find pass 1: edge flag per voxel.
__global__ void find_flags_kernel(const int* __restrict__ labels,
                                  const unsigned char* __restrict__ is_max,
                                  unsigned char* __restrict__ edge, int nx,
                                  int ny, int nz) {
    const long long n = static_cast<long long>(nx) * ny * nz;
    PB_GRID_LOOP(i, n) {
        const int own = labels[i];
        bool e = false;
        if (own != -1 && !is_max[i]) {
            Box b;
            box_of(i, nx, ny, nz, b);
            e = differs(labels, b, own);
        }
        edge[i] = e ? 1 : 0;
    }
}

// edge_find pass 2: -2 edge, -1 beside an edge, 2 other non-vacuum, 0.
__global__ void find_known_kernel(const int* __restrict__ labels,
                                  const unsigned char* __restrict__ edge,
                                  signed char* __restrict__ known, int nx,
                                  int ny, int nz) {
    const long long n = static_cast<long long>(nx) * ny * nz;
    PB_GRID_LOOP(i, n) {
        signed char out;
        if (edge[i]) {
            out = -2;
        } else {
            Box b;
            box_of(i, nx, ny, nz, b);
            out = any_flag(edge, b) ? -1 : (labels[i] != -1 ? 2 : 0);
        }
        known[i] = out;
    }
}

// edge_check pass 1, in the order of _edge_check_xla: candidates are the
// non-vacuum voxels of a changed edge's 27-neighbourhood (known == -2); a
// candidate that is no edge becomes -1, one that is a new edge (and no
// maximum) -2 and is flagged.
__global__ void check_flags_kernel(const signed char* __restrict__ known,
                                   const int* __restrict__ labels,
                                   const unsigned char* __restrict__ is_max,
                                   unsigned char* __restrict__ new_edge,
                                   signed char* __restrict__ out, int nx,
                                   int ny, int nz) {
    const long long n = static_cast<long long>(nx) * ny * nz;
    PB_GRID_LOOP(i, n) {
        const int own = labels[i];
        signed char o = known[i];
        bool ne = false;
        if (own != -1) {
            Box b;
            box_of(i, nx, ny, nz, b);
            bool cand = false;
#pragma unroll
            for (int k = 0; k < 27; ++k) cand |= known[b.idx[k]] == -2;
            if (cand) {
                if (!differs(labels, b, own)) {
                    o = -1;
                } else if (!is_max[i]) {
                    o = -2;
                    ne = true;
                }
            }
        }
        out[i] = o;
        new_edge[i] = ne ? 1 : 0;
    }
}

// edge_check pass 2: voxels still >= 0 beside a new edge become -1.
__global__ void check_near_kernel(const unsigned char* __restrict__ new_edge,
                                  signed char* __restrict__ out, int nx,
                                  int ny, int nz) {
    const long long n = static_cast<long long>(nx) * ny * nz;
    PB_GRID_LOOP(i, n) {
        if (out[i] >= 0) {
            Box b;
            box_of(i, nx, ny, nz, b);
            if (any_flag(new_edge, b)) out[i] = -1;
        }
    }
}

}  // namespace

PB_EXPORT int pb_edge_find(void* labels, void* is_max, void* scratch,
                           void* known, int nx, int ny, int nz, int device,
                           void* stream) {
    cudaSetDevice(device);
    const long long n = static_cast<long long>(nx) * ny * nz;
    const int blocks = pb::blocks_for(n, device);
    cudaStream_t s = pb::as_stream(stream);
    find_flags_kernel<<<blocks, pb::kThreads, 0, s>>>(
        static_cast<const int*>(labels),
        static_cast<const unsigned char*>(is_max),
        static_cast<unsigned char*>(scratch), nx, ny, nz);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    find_known_kernel<<<blocks, pb::kThreads, 0, s>>>(
        static_cast<const int*>(labels),
        static_cast<const unsigned char*>(scratch),
        static_cast<signed char*>(known), nx, ny, nz);
    return static_cast<int>(cudaGetLastError());
}

PB_EXPORT int pb_edge_check(void* known, void* labels, void* is_max,
                            void* scratch, void* out, int nx, int ny, int nz,
                            int device, void* stream) {
    cudaSetDevice(device);
    const long long n = static_cast<long long>(nx) * ny * nz;
    const int blocks = pb::blocks_for(n, device);
    cudaStream_t s = pb::as_stream(stream);
    check_flags_kernel<<<blocks, pb::kThreads, 0, s>>>(
        static_cast<const signed char*>(known),
        static_cast<const int*>(labels),
        static_cast<const unsigned char*>(is_max),
        static_cast<unsigned char*>(scratch), static_cast<signed char*>(out),
        nx, ny, nz);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    check_near_kernel<<<blocks, pb::kThreads, 0, s>>>(
        static_cast<const unsigned char*>(scratch),
        static_cast<signed char*>(out), nx, ny, nz);
    return static_cast<int>(cudaGetLastError());
}
