// Ascent-pointer root resolution: a tile pass in shared memory, then
// pointer jumping over the compressed graph.
//
// Replaces the TPU kernel pybader_tpu/ops/pallas_flood.py:_scan_call, the
// directional Gauss-Seidel plane scan that scanflood.flood_rounds repeats
// until every voxel carries its root maximum's label.  The scans exist
// because XLA gathers are slow on the TPU; Hopper gathers fast, so this
// computes the same result -- every voxel's root, the maximum its ascent
// chain ends in -- the way pybader_tpu/ops/pointer.py:resolve_roots does.
// Maxima and vacuum voxels point at themselves and are the only fixed points
// (ascent is strictly uphill, so the pointer graph has no cycles).  Turning
// roots into labels (rank of the root among the maxima) is plain torch in
// ops/pointer.py, as the XLA ops around the TPU kernel were.
//
// 1. the tile pass (tile.cuh, shared with the chase): a block loads the
//    pointers of one tile (16x16x32 of a 3-D grid, 8192 voxels of a flat
//    one) into shared memory and jumps them there until each points at a
//    fixed point or at the first voxel of its chain outside the tile; it
//    writes each result once.  Ascent pointers step to a 26-neighbour, so
//    most of a chain's hops stay in its tile.
// 2. jump_to_fixed_point (jump.cuh, shared with the chase): pointer
//    jumping over the whole grid, passes launched in groups with one host
//    read a group, until a pass moves nothing.
//
// Bound: device memory.  The function reads the parents and writes the
// roots, 8 bytes a voxel; each global pass reads 4 bytes a voxel and
// gathers the pointers' targets (mostly roots, hot in L2).

#include "common.cuh"
#include "jump.cuh"
#include "tile.cuh"

// parent, root: nx * ny * nz int32 (a flat array is 1 x 1 x n; root
// 16-byte aligned).  flags: pb::kGroup ints of device scratch.  *passes
// receives the global passes run after the tile pass, the last of them the
// one that moved nothing.  Returns 0, a cudaError_t, or kNotConverged after
// max_passes passes that all moved.
PB_EXPORT int pb_resolve_roots(void* parent, void* root, int nx, int ny,
                               int nz, void* flags, int max_passes,
                               int* passes, int device, void* stream) {
    cudaSetDevice(device);
    cudaStream_t s = pb::as_stream(stream);
    *passes = 0;
    const long long n = static_cast<long long>(nx) * ny * nz;
    if (n == 0) return 0;
    int* r = static_cast<int*>(root);
    const int* p = static_cast<const int*>(parent);
    const cudaError_t err = pb::tile_roots(
        pb::ParentSource{p, pb::Divisor::of(ny), pb::Divisor::of(nz)}, r,
        nx, ny, nz, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return pb::jump_to_fixed_point(r, n, static_cast<int*>(flags), max_passes,
                                   passes, device, s);
}
