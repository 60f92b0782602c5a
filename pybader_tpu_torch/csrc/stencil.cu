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
// Design (2.5-D blocking): a block owns a kSY x kSZ column of (y, z) and
// marches kSX planes along x.  Each plane of the column and its periodic
// 1-voxel halo, (kSY + 2) x (kSZ + 2) doubles, is staged into a ring of
// kSBufs buffers in shared memory with cp.async, kSBufs - 1 planes ahead
// of the plane being read.  The wrap of every halo cell is resolved once a
// block (each thread keeps the in-plane offsets of the cells it stages)
// and the planes' x wraps by a compare, so staging a plane costs one
// multiply of address arithmetic.  A thread owns one (y, z) and keeps the
// 3x3 neighbourhood of three planes in registers: a step reads the 9
// cells of the newest plane from shared memory (a warp reads a row of 32
// consecutive doubles, free of bank conflicts) and rotates the three
// register planes by unrolling the march by 3.  The weights travel by
// value as a kernel parameter, which the multiply reads from the constant
// bank.  Coordinates are 32-bit (the wrapper keeps grids below 2^31
// voxels).  A thread's codes run along x, ny * nz apart, so each leaves
// as a byte; a warp's 32 codes are one 32-byte sector.
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

namespace {

constexpr int kSY = 8, kSZ = 32;              // a block's (y, z) column
constexpr int kSX = 64;                       // planes a block marches
constexpr int kSRow = kSZ + 2;                // doubles a staged row
constexpr int kSPlane = (kSY + 2) * kSRow;    // doubles a staged plane
constexpr int kSBufs = 8;                     // the ring: 7 planes in flight
constexpr int kSThreads = kSY * kSZ;          // one thread a (y, z)
constexpr int kSStage = (kSPlane + kSThreads - 1) / kSThreads;

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

// The block's march: its column, its planes and the ring.
struct March {
    const double* rho;
    double (*ring)[kSPlane];
    int off[kSStage];  // in-plane offsets of the halo cells this thread
                       // stages (-1: none)
    int x0, vx, nx, plane;
    int sx;  // the x of the next plane to stage, wrapped
};

// Stage plane j (x = x0 - 1 + j, wrapped) into ring[j % kSBufs]: one copy
// group, empty past the last plane the march reads.  Planes are staged in
// order, j = 0, 1, 2, ..., so x wraps by a compare.
__device__ __forceinline__ void stage(March& m, int j) {
    if (j <= m.vx + 1) {
        const double* src = m.rho + m.sx * m.plane;
        double* dst = m.ring[j % kSBufs];
#pragma unroll
        for (int s = 0; s < kSStage; ++s)
            if (m.off[s] >= 0)
                cp_async8(dst + threadIdx.x + s * kSThreads, src + m.off[s]);
        m.sx = m.sx + 1 == m.nx ? 0 : m.sx + 1;
    }
    cp_async_commit();
}

// This thread's 3x3 (y, z) neighbourhood of plane j, from the ring.
__device__ __forceinline__ void load(const March& m, int j, double* p) {
    const double* s = m.ring[j % kSBufs] + (threadIdx.x / kSZ) * kSRow +
                      threadIdx.x % kSZ;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) p[dy * 3 + dz] = s[dy * kSRow + dz];
}

// Plane j into p once it has landed; then stage the plane kSBufs - 1
// ahead into the buffer of plane j - 1, which every thread has read
// before the barrier.
__device__ __forceinline__ void advance(March& m, int j, double* p) {
    cp_async_wait<kSBufs - 2>();
    __syncthreads();
    load(m, j, p);
    stage(m, j + kSBufs - 1);
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
    __shared__ __align__(16) double ring[kSBufs][kSPlane];
    const int tid = threadIdx.x;
    const int tiles_z = (nz + kSZ - 1) / kSZ;
    const int tiles_y = (ny + kSY - 1) / kSY;
    int b = blockIdx.x;
    const int z0 = b % tiles_z * kSZ;
    b /= tiles_z;
    const int y0 = b % tiles_y * kSY;
    March m;
    m.rho = rho;
    m.ring = ring;
    m.x0 = b / tiles_y * kSX;
    m.vx = min(kSX, nx - m.x0);
    m.nx = nx;
    m.plane = ny * nz;
    m.sx = pb::mod_n(m.x0 - 1, nx);
#pragma unroll
    for (int s = 0; s < kSStage; ++s) {
        const int e = tid + s * kSThreads;
        m.off[s] = e < kSPlane ? pb::mod_n(y0 + e / kSRow - 1, ny) * nz +
                                     pb::mod_n(z0 + e % kSRow - 1, nz)
                               : -1;
    }
    stage(m, 0);
    stage(m, 1);
    stage(m, 2);
    cp_async_wait<0>();
    __syncthreads();
    double a[9], c[9], e[9];
    load(m, 0, a);
    load(m, 1, c);
    load(m, 2, e);
    __syncthreads();  // planes 0-2 read: their buffers take the next ones
    for (int j = 3; j < 2 + kSBufs; ++j) stage(m, j);
    const int ty = tid / kSZ, tz = tid % kSZ;
    const bool out = ty < min(kSY, ny - y0) && tz < min(kSZ, nz - z0);
    unsigned char* dst =
        codes + (out ? (m.x0 * ny + y0 + ty) * nz + z0 + tz : 0);
    // the planes rotate through a, c, e: unrolled by 3, no register moves
    for (int s = 0; s < m.vx; s += 3) {
        int code = step_code(a, c, e, w);
        if (out) dst[s * m.plane] = static_cast<unsigned char>(code);
        if (s + 1 >= m.vx) break;
        advance(m, s + 3, a);
        code = step_code(c, e, a, w);
        if (out) dst[(s + 1) * m.plane] = static_cast<unsigned char>(code);
        if (s + 2 >= m.vx) break;
        advance(m, s + 4, c);
        code = step_code(e, a, c, w);
        if (out) dst[(s + 2) * m.plane] = static_cast<unsigned char>(code);
        if (s + 3 >= m.vx) break;
        advance(m, s + 5, e);
    }
    cp_async_wait<0>();  // no copy outlives the block
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
    // one block a column and a run of kSX planes (nx * ny * nz < 2^31)
    const int blocks = ((nz + kSZ - 1) / kSZ) * ((ny + kSY - 1) / kSY) *
                       ((nx + kSX - 1) / kSX);
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
