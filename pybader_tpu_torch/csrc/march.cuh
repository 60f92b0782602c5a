// The 2.5-D march over a density grid, shared by ongrid_step_codes
// (stencil.cu) and the exact walk rows (neargrid.cu).
//
// A block owns an SY x SZ column of (y, z) and marches up to SX planes
// along x.  Each plane of the column and its periodic 1-voxel halo,
// (SY + 2) x (SZ + 2) doubles, is staged into a ring of BUFS buffers in
// shared memory with cp.async, BUFS - 1 planes ahead of the plane being
// read.  The wrap of every halo cell is resolved once a block (each thread
// keeps the in-plane offsets of the cells it stages; pb::mod_n covers axes
// shorter than the halo) and the planes' x wraps by a compare, so staging a
// plane costs one multiply of address arithmetic.  A thread owns one
// (y, z) and keeps what it needs of three planes in registers; a kernel
// unrolls its march by 3 so that the three register planes rotate without
// moves:
//
//     m.start();                      // planes 0-2 have landed
//     load(m.corner(0), a); load(m.corner(1), c); load(m.corner(2), e);
//     m.prime();                      // planes 3 .. BUFS + 1 in flight
//     step(a, c, e); m.advance(3, load into a);
//     step(c, e, a); m.advance(4, load into c); ...
//
// Plane j is x = x0 - 1 + j (wrapped).  Coordinates are 32-bit (the
// wrappers keep grids below 2^31 voxels).
#pragma once

#include "common.cuh"

namespace pb {

__device__ __forceinline__ void cp_async8(double* smem, const double* gmem) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's newest copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int SY, int SZ, int SX, int BUFS>
struct March {
    static constexpr int kRow = SZ + 2;              // doubles a staged row
    static constexpr int kPlane = (SY + 2) * kRow;   // doubles a staged plane
    static constexpr int kThreads = SY * SZ;         // one thread a (y, z)
    static constexpr int kStage = (kPlane + kThreads - 1) / kThreads;

    // One block a column and a run of SX planes.
    static int blocks(int nx, int ny, int nz) {
        return ((nz + SZ - 1) / SZ) * ((ny + SY - 1) / SY) *
               ((nx + SX - 1) / SX);
    }

    const double* rho;
    double (*ring)[kPlane];
    int off[kStage];  // in-plane offsets of the halo cells this thread
                      // stages (-1: none)
    int x0, y0, z0;   // the block's first voxel
    int vx, nx, plane;
    int sx;  // the x of the next plane to stage, wrapped

    // This block's column and planes (from blockIdx.x) over ring.
    __device__ __forceinline__ void init(const double* r,
                                         double (*buffers)[kPlane], int nx_,
                                         int ny, int nz) {
        const int tiles_z = (nz + SZ - 1) / SZ;
        const int tiles_y = (ny + SY - 1) / SY;
        int b = blockIdx.x;
        z0 = b % tiles_z * SZ;
        b /= tiles_z;
        y0 = b % tiles_y * SY;
        x0 = b / tiles_y * SX;
        rho = r;
        ring = buffers;
        nx = nx_;
        vx = min(SX, nx - x0);
        plane = ny * nz;
        sx = mod_n(x0 - 1, nx);
#pragma unroll
        for (int s = 0; s < kStage; ++s) {
            const int e = threadIdx.x + s * kThreads;
            off[s] = e < kPlane ? mod_n(y0 + e / kRow - 1, ny) * nz +
                                      mod_n(z0 + e % kRow - 1, nz)
                                : -1;
        }
    }

    // Stage plane j into ring[j % BUFS]: one copy group, empty past the
    // last plane the march reads.  Planes are staged in order, j = 0, 1,
    // 2, ..., so x wraps by a compare.
    __device__ __forceinline__ void stage(int j) {
        if (j <= vx + 1) {
            const double* src = rho + sx * plane;
            double* dst = ring[j % BUFS];
#pragma unroll
            for (int s = 0; s < kStage; ++s)
                if (off[s] >= 0)
                    cp_async8(dst + threadIdx.x + s * kThreads, src + off[s]);
            sx = sx + 1 == nx ? 0 : sx + 1;
        }
        cp_async_commit();
    }

    // This thread's (y, z) corner of staged plane j: its 3x3 neighbourhood
    // in the plane is corner[dy * kRow + dz], dy, dz in 0..2.
    __device__ __forceinline__ const double* corner(int j) const {
        return ring[j % BUFS] + (threadIdx.x / SZ) * kRow + threadIdx.x % SZ;
    }

    // Stage planes 0-2 and wait until they have landed.
    __device__ __forceinline__ void start() {
        stage(0);
        stage(1);
        stage(2);
        cp_async_wait<0>();
        __syncthreads();
    }

    // Planes 0-2 read: their buffers take the next ones.
    __device__ __forceinline__ void prime() {
        __syncthreads();
        for (int j = 3; j < 2 + BUFS; ++j) stage(j);
    }

    // Plane j into registers (load(corner(j))) once it has landed; then
    // stage the plane BUFS - 1 ahead into the buffer of plane j - 1, which
    // every thread has read before the barrier.
    template <class Load>
    __device__ __forceinline__ void advance(int j, Load&& load) {
        cp_async_wait<BUFS - 2>();
        __syncthreads();
        load(corner(j));
        stage(j + BUFS - 1);
    }

    // No copy outlives the block.
    __device__ __forceinline__ void finish() { cp_async_wait<0>(); }
};

}  // namespace pb
