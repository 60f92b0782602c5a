// Ascent-pointer root resolution by pointer jumping.
//
// Replaces the TPU kernel pybader_tpu/ops/pallas_flood.py:_scan_call, the
// directional Gauss-Seidel plane scan that scanflood.flood_rounds repeats
// until every voxel carries its root maximum's label.  The scans exist
// because XLA gathers are slow on the TPU; Hopper gathers fast, so this
// computes the same result -- every voxel's root, the maximum its ascent
// chain ends in -- the way pybader_tpu/ops/pointer.py:resolve_roots does:
//     root[i] = root[root[i]]
// repeated until a pass changes nothing (jump.cuh, shared with the chase).
// Maxima and vacuum voxels point at themselves and are the only fixed points
// (ascent is strictly uphill, so the pointer graph has no cycles).  Turning
// roots into labels (rank of the root among the maxima) is plain torch in
// ops/pointer.py, as the XLA ops around the TPU kernel were.
//
// Bound: device memory and gather latency, about 12 bytes a voxel a pass
// and about log2(longest chain) passes (jump.cuh).

#include "common.cuh"
#include "jump.cuh"

PB_EXPORT int pb_resolve_roots(void* root, long long n, void* flag,
                               int max_passes, int device, void* stream) {
    cudaSetDevice(device);
    return pb::jump_to_fixed_point(static_cast<int*>(root), n,
                                   static_cast<int*>(flag), max_passes,
                                   device, pb::as_stream(stream));
}
