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
// Bound: the FP64 pipe.  The library builds with -fmad=false, so each of
// the 26 candidates is a subtraction, a product and a sum of its own (78
// FP64 instructions a voxel, 0.26 ms at 384^3 on 132 SMs x 64 lanes x
// 1.98 GHz) beside 9 bytes a voxel of device memory (0.15 ms); the 26
// compares with the running best take the same pipe.  So the integer
// work of addressing must stay small beside it.
//
// Design (2.5-D blocking, march.cuh): a block owns a kSY x kSZ column of
// (y, z) and marches kSX planes along x through a ring of kSBufs staged
// planes.  A thread keeps the 3x3 neighbourhood of three planes in
// registers: a step reads the 9 cells of the newest plane from shared
// memory (a warp reads a row of 32 consecutive doubles, free of bank
// conflicts).  The weights travel by value as a kernel parameter, which
// the multiply reads from the constant bank.  A thread's codes run along
// x, ny * nz apart, so each leaves as a byte; a warp's 32 codes are one
// 32-byte sector.
//
// No candidate is skipped.  One with rho[n] <= rho[p] can never win (w > 0
// and monotone rounding put its value at or below rho[p] <= best; a NaN
// fails every test), but skipping it
// needs a branch: a warp vote and a branch a candidate, or one a plane of
// 9, cost more than the FP64 work they save, since about half the
// candidates of a smooth field lose and the branches stop the scheduler
// from overlapping the candidates (PERF.md, kernel findings).

#include "common.cuh"
#include "grad.cuh"
#include "march.cuh"

namespace {

constexpr int kSY = 8, kSZ = 32;  // a block's (y, z) column
constexpr int kSX = 64;           // planes a block marches
constexpr int kSBufs = 8;         // the ring: 7 planes in flight
using SMarch = pb::March<kSY, kSZ, kSX, kSBufs>;
constexpr int kSThreads = SMarch::kThreads;

// This thread's 3x3 (y, z) neighbourhood of a staged plane.
__device__ __forceinline__ void load9(const double* s, double* p) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dz = 0; dz < 3; ++dz)
            p[dy * 3 + dz] = s[dy * SMarch::kRow + dz];
}

// The 27 weights, passed by value: a kernel parameter sits in the constant
// bank, which an FP64 instruction reads as its operand (no register, no
// load).
struct Weights {
    double w[27];
};

// The code of the voxel whose planes x - 1, x, x + 1 are lo, mid, hi:
// the candidates in OFFSETS order, strict > against the running best.
__device__ __forceinline__ int step_code(const double* lo, const double* mid,
                                         const double* hi, const Weights& w) {
    const double rp = mid[4];
    double best = rp;
    int best_k = 13;
#pragma unroll
    for (int k = 0; k < 27; ++k) {
        if (k == 13) continue;
        const double* p = k < 9 ? lo : (k < 18 ? mid : hi);
        const double val =
            __dadd_rn(__dmul_rn(__dsub_rn(p[k % 9], rp), w.w[k]), rp);
        if (val > best) {
            best = val;
            best_k = k;
        }
    }
    return best_k;
}

// 3 blocks an SM: 80 registers a thread, 22 KB of ring a block
__global__ void __launch_bounds__(kSThreads, 3)
    ongrid_step_codes_kernel(const double* __restrict__ rho, const Weights w,
                             unsigned char* __restrict__ codes, int nx,
                             int ny, int nz) {
    __shared__ __align__(16) double ring[kSBufs][SMarch::kPlane];
    const int tid = threadIdx.x;
    SMarch m;
    m.init(rho, ring, nx, ny, nz);
    double a[9], c[9], e[9];
    m.start();
    load9(m.corner(0), a);
    load9(m.corner(1), c);
    load9(m.corner(2), e);
    m.prime();
    const int ty = tid / kSZ, tz = tid % kSZ;
    const bool out = ty < min(kSY, ny - m.y0) && tz < min(kSZ, nz - m.z0);
    unsigned char* dst =
        codes + (out ? (m.x0 * ny + m.y0 + ty) * nz + m.z0 + tz : 0);
    // the planes rotate through a, c, e: unrolled by 3, no register moves
    for (int s = 0; s < m.vx; s += 3) {
        int code = step_code(a, c, e, w);
        if (out) dst[s * m.plane] = static_cast<unsigned char>(code);
        if (s + 1 >= m.vx) break;
        m.advance(s + 3, [&](const double* p) { load9(p, a); });
        code = step_code(c, e, a, w);
        if (out) dst[(s + 1) * m.plane] = static_cast<unsigned char>(code);
        if (s + 2 >= m.vx) break;
        m.advance(s + 4, [&](const double* p) { load9(p, c); });
        code = step_code(e, a, c, w);
        if (out) dst[(s + 2) * m.plane] = static_cast<unsigned char>(code);
        if (s + 3 >= m.vx) break;
        m.advance(s + 5, [&](const double* p) { load9(p, e); });
    }
    m.finish();
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

// weights: the 27 weights in host memory, OFFSETS order.
PB_EXPORT int pb_ongrid_step_codes(void* rho, void* weights, void* codes,
                                   int nx, int ny, int nz, int device,
                                   void* stream) {
    cudaSetDevice(device);
    Weights w;
    for (int k = 0; k < 27; ++k)
        w.w[k] = static_cast<const double*>(weights)[k];
    // nx * ny * nz < 2^31
    const int blocks = SMarch::blocks(nx, ny, nz);
    ongrid_step_codes_kernel<<<blocks, kSThreads, 0,
                               pb::as_stream(stream)>>>(
        static_cast<const double*>(rho), w,
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
