// The roots' tile pass in shared memory, shared by the roots of one-step
// parents (flood.cu) and of step codes (chase.cu).
//
// A block loads the one-step pointers of one tile (16x16x32 of a 3-D grid,
// 8192 voxels of a flat one) into shared memory and jumps them there until
// each points at a fixed point or at the first voxel of its chain outside
// the tile; it writes each result once.  Ascent pointers step to a
// 26-neighbour, so most of a chain's hops stay in its tile, and the global
// jump passes (jump.cuh) that follow have short chains left.
//
// A source says where a voxel's pointer goes: ParentSource reads the flat
// int32 parent and finds its coordinates by multiplication (common.cuh's
// Divisor, no integer division); CodeSource reads the 1-byte step code
// and adds its offset to the voxel's own coordinates, wrapping
// periodically, so neither a flat index nor a division is needed to place
// the target in the tile.
#pragma once

#include "common.cuh"

namespace pb {
namespace {

constexpr int kTileThreads = 256;

// Flat int32 one-step parents.
struct ParentSource {
    const int* __restrict__ parent;
    Divisor by_y, by_z;  // ny, nz

    // The flat target of voxel i = (x, y, z) and its coordinates.
    __device__ __forceinline__ int target(int i, int x, int y, int z, int nx,
                                          int ny, int nz, int& px, int& py,
                                          int& pz) const {
        const int p = __ldg(&parent[i]);
        const int pyz = by_z.div(p);
        px = by_y.div(pyz);
        py = pyz - px * ny;
        pz = p - pyz * nz;
        return p;
    }
};

// uint8 step codes in OFFSETS order (code = 9 (dx + 1) + 3 (dy + 1) +
// dz + 1; 13 the self step), with periodic wrap.
struct CodeSource {
    const unsigned char* __restrict__ codes;

    __device__ __forceinline__ int target(int i, int x, int y, int z, int nx,
                                          int ny, int nz, int& px, int& py,
                                          int& pz) const {
        const int c = __ldg(&codes[i]);
        px = x + c / 9 - 1;
        py = y + c / 3 % 3 - 1;
        pz = z + c % 3 - 1;
        px = px < 0 ? px + nx : (px >= nx ? px - nx : px);
        py = py < 0 ? py + ny : (py >= ny ? py - ny : py);
        pz = pz < 0 ? pz + nz : (pz >= nz ? pz - nz : pz);
        return (px * ny + py) * nz + pz;
    }
};

// A TX x TY x TZ tile (z fastest) of the pointers: 8192 voxels, 48 KB of
// shared memory.
template <int TX, int TY, int TZ, class Source>
__global__ void __launch_bounds__(kTileThreads)
tile_roots_kernel(Source src, int* __restrict__ root, int nx, int ny,
                  int nz) {
    constexpr int kSize = TX * TY * TZ;
    __shared__ int target[kSize];   // each voxel's pointer (flat index)
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
            int px, py, pz;
            target[j] = src.target((x * ny + y) * nz + z, x, y, z, nx, ny,
                                   nz, px, py, pz);
            const unsigned dx = px - x0, dy = py - y0, dz = pz - z0;
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

template <int TX, int TY, int TZ, class Source>
cudaError_t tile_pass(Source src, int* root, int nx, int ny, int nz,
                      cudaStream_t s) {
    const long long tiles = static_cast<long long>((nx + TX - 1) / TX) *
                            ((ny + TY - 1) / TY) * ((nz + TZ - 1) / TZ);
    tile_roots_kernel<TX, TY, TZ, Source>
        <<<static_cast<unsigned>(tiles), kTileThreads, 0, s>>>(src, root, nx,
                                                               ny, nz);
    return cudaGetLastError();
}

// The tile pass over an (nx, ny, nz) grid: 16x16x32 tiles, or 8192-voxel
// rows of a flat (1 x 1 x n) one.
template <class Source>
cudaError_t tile_roots(Source src, int* root, int nx, int ny, int nz,
                       cudaStream_t s) {
    return nx == 1 && ny == 1
               ? tile_pass<1, 1, 8192>(src, root, nx, ny, nz, s)
               : tile_pass<16, 16, 32>(src, root, nx, ny, nz, s);
}

}  // namespace
}  // namespace pb
