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
// 1. tile_roots_kernel: a block loads the pointers of one tile (16x16x32
//    of a 3-D grid, 8192 voxels of a flat one) into shared memory and jumps
//    them there until each points at a fixed point or at the first voxel
//    of its chain outside the tile; it writes each result once.  Ascent
//    pointers step to a 26-neighbour, so most of a chain's hops stay in its
//    tile.
// 2. jump_to_fixed_point (jump.cuh, shared with the chase): pointer
//    jumping over the whole grid, passes launched in groups with one host
//    read a group, until a pass moves nothing.
//
// Bound: device memory.  The function reads the parents and writes the
// roots, 8 bytes a voxel; each global pass reads 4 bytes a voxel and
// gathers the pointers' targets (mostly roots, hot in L2).

#include "common.cuh"
#include "jump.cuh"

namespace {

constexpr int kTileThreads = 256;

// n / d for 0 <= n < 2**31 and 2 <= d < 2**31, with magic = ceil(2**64 / d):
// exact, since n * (magic * d - 2**64) < 2**64 (no integer division).
__device__ __forceinline__ int div_magic(int n, unsigned long long magic) {
    return static_cast<int>(
        __umul64hi(static_cast<unsigned long long>(n), magic));
}

// A TX x TY x TZ tile (z fastest) of the pointers: 8192 voxels, 48 KB of
// shared memory.  16 x 16 x 32 for a 3-D grid, 1 x 1 x 8192 for a flat one.
template <int TX, int TY, int TZ>
__global__ void __launch_bounds__(kTileThreads)
tile_roots_kernel(const int* __restrict__ parent, int* __restrict__ root,
                  int nx, int ny, int nz, unsigned long long magic_y,
                  unsigned long long magic_z) {
    constexpr int kSize = TX * TY * TZ;
    __shared__ int target[kSize];   // each voxel's parent (flat index)
    __shared__ short next[kSize];   // in-tile successor, or itself
    const int tiles_z = (nz + TZ - 1) / TZ;
    const int tiles_y = (ny + TY - 1) / TY;
    const int x0 = blockIdx.x / tiles_z / tiles_y * TX;
    const int y0 = blockIdx.x / tiles_z % tiles_y * TY;
    const int z0 = blockIdx.x % tiles_z * TZ;
    // unrolled so that each thread has several loads in flight
#pragma unroll 8
    for (int k = 0; k < kSize / kTileThreads; ++k) {
        const int j = threadIdx.x + k * kTileThreads;
        const int x = x0 + j / (TY * TZ), y = y0 + j / TZ % TY,
                  z = z0 + j % TZ;
        int step = j;  // off the grid, or a chain that leaves the tile
        if (x < nx && y < ny && z < nz) {
            const int p = parent[(x * ny + y) * nz + z];
            target[j] = p;
            const int pyz = nz == 1 ? p : div_magic(p, magic_z);
            const int px = ny == 1 ? pyz : div_magic(pyz, magic_y);
            const unsigned dx = px - x0, dy = pyz - px * ny - y0,
                           dz = p - pyz * nz - z0;
            if (dx < TX && dy < TY && dz < TZ) step = (dx * TY + dy) * TZ + dz;
        }
        next[j] = static_cast<short>(step);
    }
    __syncthreads();
    // pointer doubling in shared memory; the tile's forest is acyclic, and
    // a stale read within a round only delays a step to the next round
    bool moved;
    do {
        moved = false;
#pragma unroll 4
        for (int j = threadIdx.x; j < kSize; j += kTileThreads) {
            const int a = next[j];
            const int b = next[a];
            if (a != b) {
                next[j] = static_cast<short>(b);
                moved = true;
            }
        }
    } while (__syncthreads_or(moved));
    // the chain's last voxel in the tile: a fixed point (its target is
    // itself) or the voxel whose target leaves the tile
#pragma unroll 8
    for (int k = 0; k < kSize / kTileThreads; ++k) {
        const int j = threadIdx.x + k * kTileThreads;
        const int x = x0 + j / (TY * TZ), y = y0 + j / TZ % TY,
                  z = z0 + j % TZ;
        if (x < nx && y < ny && z < nz)
            root[(x * ny + y) * nz + z] = target[next[j]];
    }
}

template <int TX, int TY, int TZ>
cudaError_t tile_pass(const int* parent, int* root, int nx, int ny, int nz,
                      cudaStream_t s) {
    auto magic = [](int d) { return d < 2 ? 0ull : ~0ull / d + 1; };
    const long long tiles = static_cast<long long>((nx + TX - 1) / TX) *
                            ((ny + TY - 1) / TY) * ((nz + TZ - 1) / TZ);
    auto kernel = tile_roots_kernel<TX, TY, TZ>;
    kernel<<<static_cast<unsigned>(tiles), kTileThreads, 0, s>>>(
        parent, root, nx, ny, nz, magic(ny), magic(nz));
    return cudaGetLastError();
}

}  // namespace

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
    const cudaError_t err = nx == 1 && ny == 1
                                ? tile_pass<1, 1, 8192>(p, r, nx, ny, nz, s)
                                : tile_pass<16, 16, 32>(p, r, nx, ny, nz, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return pb::jump_to_fixed_point(r, n, static_cast<int*>(flags), max_passes,
                                   passes, device, s);
}
