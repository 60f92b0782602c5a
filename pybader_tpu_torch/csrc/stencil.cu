// Ongrid ascent step codes.
//
// Replaces the TPU kernel pybader_tpu/ops/pallas_stencil.py:_stencil_call
// (driven by ongrid_step_codes_dd), whose result is the exact-f64 XLA
// stencil pybader_tpu/ops/stencil.py:ongrid_step_codes.
//
// For every voxel p: the code k (OFFSETS order, ix, iy, iz in -1..1 with z
// fastest) of the first periodic neighbour n whose
//     (rho[n] - rho[p]) * w[k] + rho[p]
// is strictly greater than every earlier candidate and rho[p] itself; 13
// (the self step) when none is.  The TPU kernel splits f64 into an f32
// hi/lo pair because Mosaic has no f64; Hopper has native f64, so this is
// the exact arithmetic.  Each product and sum is rounded on its own
// (__dmul_rn / __dadd_rn, and the library is built with -fmad=false): a
// fused multiply-add rounds once and flips near-ties against the CPU paths.
//
// Bound: device memory.  A voxel reads 27 doubles and writes one byte; the
// 26 neighbour reads hit L1/L2 because neighbouring threads share them, so
// the grid is read from HBM about once (8 + 1 bytes a voxel).  The design
// keeps one thread per voxel with z fastest across a warp, so every
// neighbour plane is a coalesced row read.

#include "common.cuh"

namespace {

__global__ void ongrid_step_codes_kernel(const double* __restrict__ rho,
                                         const double* __restrict__ weights,
                                         unsigned char* __restrict__ codes,
                                         int nx, int ny, int nz) {
    __shared__ double w[27];
    if (threadIdx.x < 27) w[threadIdx.x] = weights[threadIdx.x];
    __syncthreads();
    const long long n = static_cast<long long>(nx) * ny * nz;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         i < n; i += stride) {
        int x, y, z;
        pb::unflatten(i, ny, nz, x, y, z);
        const double rp = rho[i];
        double best = rp;
        int best_k = 13;
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
            int xx = x + dx;
            xx = xx < 0 ? xx + nx : (xx >= nx ? xx - nx : xx);
#pragma unroll
            for (int dy = -1; dy <= 1; ++dy) {
                int yy = y + dy;
                yy = yy < 0 ? yy + ny : (yy >= ny ? yy - ny : yy);
#pragma unroll
                for (int dz = -1; dz <= 1; ++dz) {
                    const int k = (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1);
                    if (k == 13) continue;
                    int zz = z + dz;
                    zz = zz < 0 ? zz + nz : (zz >= nz ? zz - nz : zz);
                    const long long j =
                        (static_cast<long long>(xx) * ny + yy) * nz + zz;
                    const double val = __dadd_rn(
                        __dmul_rn(__dsub_rn(rho[j], rp), w[k]), rp);
                    if (val > best) {
                        best = val;
                        best_k = k;
                    }
                }
            }
        }
        codes[i] = static_cast<unsigned char>(best_k);
    }
}

}  // namespace

PB_EXPORT int pb_ongrid_step_codes(void* rho, void* weights, void* codes,
                                   int nx, int ny, int nz, int device,
                                   void* stream) {
    cudaSetDevice(device);
    const long long n = static_cast<long long>(nx) * ny * nz;
    ongrid_step_codes_kernel<<<pb::blocks_for(n, device), pb::kThreads, 0,
                               pb::as_stream(stream)>>>(
        static_cast<const double*>(rho), static_cast<const double*>(weights),
        static_cast<unsigned char*>(codes), nx, ny, nz);
    return static_cast<int>(cudaGetLastError());
}
