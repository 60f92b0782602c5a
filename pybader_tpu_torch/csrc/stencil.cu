// Ongrid ascent step codes, and the nginit codes of the hybrid's init.
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
#include "grad.cuh"

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

// The first step a neargrid trajectory at rest takes, kept where it strictly
// ascends (pybader_tpu/ops/stencil.py:neargrid_init_codes, :108-170, an XLA
// stencil in the JAX package).  Per axis i of the inf-normalised gradient
// g_i: step_i = round_away(g_i) + round_away(g_i - round_away(g_i)), in f64,
// rounded op by op; the code (step_x+1)*9 + (step_y+1)*3 + (step_z+1) stands
// where max|gd| >= 1e-14 and rho at its target exceeds rho here, the ongrid
// code bk elsewhere.
//
// Bound: device memory.  A voxel reads its density, six axis neighbours and
// one step target (L1/L2 hits shared with neighbouring threads) and its
// ongrid code, and writes one byte: 8 + 1 + 1 bytes a voxel from HBM.
__device__ __forceinline__ double round_away(double v) {
    return trunc(v > 0.0 ? __dadd_rn(v, 0.5) : __dsub_rn(v, 0.5));
}

__global__ void nginit_codes_kernel(const double* __restrict__ rho,
                                    const unsigned char* __restrict__ bk,
                                    const double* __restrict__ t_grad,
                                    unsigned char* __restrict__ codes, int nx,
                                    int ny, int nz) {
    __shared__ double t[9];
    if (threadIdx.x < 9) t[threadIdx.x] = t_grad[threadIdx.x];
    __syncthreads();
    const long long n = static_cast<long long>(nx) * ny * nz;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         i < n; i += stride) {
        int x, y, z;
        pb::unflatten(i, ny, nz, x, y, z);
        double gd[3];
        const double mg = pb::transformed_gradient(rho, i, x, y, z, nx, ny,
                                                   nz, t, false, gd);
        const double denom = mg > 0.0 ? mg : 1.0;
        int step[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            const double g = __ddiv_rn(gd[r], denom);
            const double ig = round_away(g);
            step[r] = static_cast<int>(ig + round_away(__dsub_rn(g, ig)));
        }
        const long long target =
            (static_cast<long long>(pb::wrap(x + step[0], nx)) * ny +
             pb::wrap(y + step[1], ny)) * nz + pb::wrap(z + step[2], nz);
        const bool keep = !(mg < 1e-14) && rho[target] > rho[i];
        codes[i] = keep ? static_cast<unsigned char>(
                              (step[0] + 1) * 9 + (step[1] + 1) * 3 +
                              step[2] + 1)
                        : bk[i];
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

PB_EXPORT int pb_nginit_codes(void* rho, void* bk, void* t_grad, void* codes,
                              int nx, int ny, int nz, int device,
                              void* stream) {
    cudaSetDevice(device);
    const long long n = static_cast<long long>(nx) * ny * nz;
    nginit_codes_kernel<<<pb::blocks_for(n, device), pb::kThreads, 0,
                          pb::as_stream(stream)>>>(
        static_cast<const double*>(rho), static_cast<const unsigned char*>(bk),
        static_cast<const double*>(t_grad),
        static_cast<unsigned char*>(codes), nx, ny, nz);
    return static_cast<int>(cudaGetLastError());
}
