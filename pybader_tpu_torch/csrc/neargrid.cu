// Neargrid walk rows and the trajectory walkers.
//
// Replace the XLA walk of pybader_tpu/ops/neargrid.py: the row builds
// precompute_rows (:484, with _gd_components :64, _denom_flags :82 and
// _pack_parent :523) and precompute_qrows (:194, with _quantize_col :214 and
// _pack_qwords :220), the exact-row walk _walk_segment_packed (:647) as
// driven by walk (:907), and the quantised-row walks _walk_segment_q (:238)
// and _walk_segment_qs (:337).  The JAX drain loop's segments and compaction
// schedule the walks for the TPU without changing their results; here one
// thread walks a lane to its end in one launch.  The shard walker replaces
// the mesh walker of pybader_tpu/parallel/walk.py:68 (walk_sharded).
//
// Exact row layout, 32 bytes, one per voxel, so a walker step reads one
// sector:
//     double g[3]   inf-normalised transformed gradient
//     int32 parent  flat index of the ongrid ascent target
//     uint8 flags   kOngrid (|gd| < 1e-14) | kMax (parent == self)
//     3 bytes zero
// The parent is a full int32 column (the JAX packed word kept 28 bits).
// Quantised rows are JAX's two int32 words (qwalk.cuh), 8 bytes a voxel.
//
// Arithmetic: every sum and product is rounded on its own (__dadd_rn,
// __dmul_rn, __fadd_rn, and the library builds with -fmad=false), so the
// rows and walks equal the plain PyTorch versions bit for bit.  XLA's CPU
// backend fuses some of the gradient multiply-adds, so the JAX exact rows
// differ from these by a few ulp; the walkers are exact on whatever rows
// they are given.

#include "common.cuh"
#include "grad.cuh"
#include "qwalk.cuh"
#include "walk.cuh"

namespace {

using pb::kMax;
using pb::kOngrid;
using pb::wrap;

// ----------------------------------------------------------------- rows
// Bound: device memory.  A voxel reads its density, six axis neighbours
// (L1/L2 hits shared with the neighbouring threads) and its step code, and
// writes a 32-byte row: 8 + 1 + 32 bytes a voxel from HBM.  One thread per
// voxel, z fastest across a warp, so the loads and the row stores coalesce.
__global__ void rows_kernel(const double* __restrict__ rho,
                            const unsigned char* __restrict__ codes,
                            const double* __restrict__ t_grad,
                            double2* __restrict__ rows, int nx, int ny, int nz,
                            int strict) {
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
                                                   nz, t, strict != 0, gd);
        const double denom = mg > 0.0 ? mg : 1.0;
        const int code = codes[i];
        const int px = wrap(x + code / 9 - 1, nx);
        const int py = wrap(y + (code / 3) % 3 - 1, ny);
        const int pz = wrap(z + code % 3 - 1, nz);
        const long long parent =
            (static_cast<long long>(px) * ny + py) * nz + pz;
        const long long flags =
            (mg < 1e-14 ? kOngrid : 0) | (parent == i ? kMax : 0);
        const long long word =
            static_cast<long long>(static_cast<unsigned int>(parent)) |
            (flags << 32);
        rows[2 * i] = make_double2(__ddiv_rn(gd[0], denom),
                                   __ddiv_rn(gd[1], denom));
        rows[2 * i + 1] = make_double2(__ddiv_rn(gd[2], denom),
                                       __longlong_as_double(word));
    }
}

// ---------------------------------------------------------------- q-rows
// Bound: device memory, as rows_kernel: 8 + 1 bytes read and 8 written a
// voxel.  q_i = round(g_i * 262143) rounds half to even, as jnp.round.
__global__ void qrows_kernel(const double* __restrict__ rho,
                             const unsigned char* __restrict__ codes,
                             const double* __restrict__ t_grad,
                             int2* __restrict__ qrows, int nx, int ny, int nz,
                             int strict) {
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
                                                   nz, t, strict != 0, gd);
        const double denom = mg > 0.0 ? mg : 1.0;
        unsigned int q[3];
#pragma unroll
        for (int r = 0; r < 3; ++r)
            q[r] = static_cast<unsigned int>(__double2int_rn(
                       __dmul_rn(__ddiv_rn(gd[r], denom), 262143.0))) &
                   0x7FFFFu;
        const unsigned int code = codes[i];
        const unsigned int w0 = q[0] | ((q[1] & 0x1FFFu) << 19);
        const unsigned int w1 = (q[1] >> 13) | (q[2] << 6) | (code << 25) |
                                (mg < 1e-14 ? 1u << 30 : 0u);
        qrows[i] = make_int2(static_cast<int>(w0), static_cast<int>(w1));
    }
}

// ----------------------------------------------------------------- walk
// One thread per lane walks its trajectory to termination or the cap, with
// pos, prev, the 3-entry history and dr in registers; no host round trip
// per step.  Per step: fetch the row at pos (stop there if it is a maximum
// or, when known is given, a known == 2 voxel), then walk.cuh's step.
// After max_steps steps one more fetch decides done.
//
// Bound: the latency of the dependent row gathers.  Each step's address
// comes from the previous step's row, so a lane reads one 32-byte sector
// (plus one byte of known) per step and waits for it; throughput comes
// only from the number of lanes in flight, so the launch gives every lane
// its own thread.  Lanes of a warp diverge in position and length: the
// gathers do not coalesce and a warp runs as long as its longest lane.
__global__ void walk_kernel(const double2* __restrict__ rows,
                            const int* __restrict__ starts,
                            const signed char* __restrict__ known,
                            int* __restrict__ pos_out,
                            unsigned char* __restrict__ done_out,
                            long long k, int nx, int ny, int nz,
                            int max_steps) {
    const long long lane =
        static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (lane >= k) return;
    const int nyz = ny * nz;
    pb::Lane s{starts[lane], -1, -1, -1, -1, 0.0, 0.0, 0.0};
    if (s.pos < 0) {  // a padding lane, born done at voxel 0
        pos_out[lane] = 0;
        done_out[lane] = 1;
        return;
    }
    bool done = false;
    for (int step = 0;; ++step) {
        const pb::Row r = pb::load_row(rows, s.pos);
        if ((r.flags & kMax) || (known != nullptr && known[s.pos] == 2)) {
            done = true;
            break;
        }
        if (step == max_steps) break;
        const int x = s.pos / nyz;
        const int rem = s.pos - x * nyz;
        const int y = rem / nz;
        pb::advance(r, x, y, rem - y * nz, s, nx, ny, nz);
    }
    pos_out[lane] = s.pos;
    done_out[lane] = done ? 1 : 0;
}

// The walk of one shard of a mesh, resumable: the owner-computes hand-off
// of parallel/walk.py.  The shard is the box [ox, ox + lx) x [oy, oy + ly)
// x [0, nz) of the (nx, ny, nz) grid; its rows (lx * ly * nz of them, in
// the shard's C order) carry global parents.  Positions are global flat
// indices, and each step wraps on the global grid.  A lane resumes from its
// state (pos, prev, hist, dr, steps taken) and walks while it stays in the
// shard; it ends with status 1 on a maximum or a stop voxel, 2 at the cap
// (steps == max_steps, not done), or 0 when its position has left the
// shard, for the owner of that position to resume.  The steps and fetches
// are walk_kernel's, so a lane handed from shard to shard ends where the
// single-device walk ends it.
//
// Bound: the latency of the dependent row gathers, as walk_kernel; the
// state (48 bytes) is read and written once a launch.
__global__ void walk_shard_kernel(const double2* __restrict__ rows,
                                  const unsigned char* __restrict__ stop,
                                  int* __restrict__ pos, int* __restrict__ prev,
                                  int* __restrict__ hist,
                                  double* __restrict__ dr,
                                  int* __restrict__ steps,
                                  unsigned char* __restrict__ status,
                                  long long k, int lx, int ly, int ox, int oy,
                                  int nx, int ny, int nz, int max_steps) {
    const long long lane =
        static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (lane >= k) return;
    const int nyz = ny * nz;
    pb::Lane s{pos[lane],        prev[lane],       hist[3 * lane],
               hist[3 * lane + 1], hist[3 * lane + 2], dr[3 * lane],
               dr[3 * lane + 1], dr[3 * lane + 2]};
    int taken = steps[lane];
    unsigned char end;
    for (;;) {
        const int x = s.pos / nyz;
        const int rem = s.pos - x * nyz;
        const int y = rem / nz;
        const int z = rem - y * nz;
        if (x < ox || x >= ox + lx || y < oy || y >= oy + ly) {
            end = 0;
            break;
        }
        const long long li =
            (static_cast<long long>(x - ox) * ly + (y - oy)) * nz + z;
        const pb::Row r = pb::load_row(rows, li);
        if ((r.flags & kMax) || (stop != nullptr && stop[li])) {
            end = 1;
            break;
        }
        if (taken == max_steps) {
            end = 2;
            break;
        }
        pb::advance(r, x, y, z, s, nx, ny, nz);
        ++taken;
    }
    pos[lane] = s.pos;
    prev[lane] = s.prev;
    hist[3 * lane] = s.h0;
    hist[3 * lane + 1] = s.h1;
    hist[3 * lane + 2] = s.h2;
    dr[3 * lane] = s.d0;
    dr[3 * lane + 1] = s.d1;
    dr[3 * lane + 2] = s.d2;
    steps[lane] = taken;
    status[lane] = end;
}

// Resume quantised-row walks (state in place) for up to max_steps steps:
// the exact walker's loop on 8-byte q-rows, f32 dr, the stop set read from
// known == 2; for the screened walk also the error bound and risky flag.
// Bound: the latency of the dependent 8-byte row gathers, as walk_kernel.
template <bool kScreened>
__global__ void walk_q_kernel(const int2* __restrict__ qrows,
                              const signed char* __restrict__ known,
                              int* __restrict__ pos, int* __restrict__ prev,
                              int* __restrict__ hist, float* __restrict__ dr,
                              unsigned char* __restrict__ done,
                              float* __restrict__ err,
                              unsigned char* __restrict__ risky, long long k,
                              int nx, int ny, int nz, int max_steps) {
    const long long lane =
        static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (lane >= k || done[lane]) return;
    pb::QLane s = pb::load_lane<kScreened>(lane, pos, prev, hist, dr, err,
                                           risky);
    for (int step = 0;; ++step) {
        const int2 w = __ldg(&qrows[s.pos]);
        if (pb::q_stops(w.y, known, s.pos)) {
            done[lane] = 1;
            break;
        }
        if (step == max_steps) break;
        pb::q_advance<kScreened>(w.x, w.y, s, nx, ny, nz);
    }
    pb::store_lane<kScreened>(lane, s, pos, prev, hist, dr, err, risky);
}

template <bool kScreened>
void launch_walk_q(unsigned int blocks, void* stream, void* qrows,
                   void* known, void* pos, void* prev, void* hist, void* dr,
                   void* done, void* err, void* risky, long long k, int nx,
                   int ny, int nz, int max_steps) {
    walk_q_kernel<kScreened><<<blocks, pb::kThreads, 0,
                               pb::as_stream(stream)>>>(
        static_cast<const int2*>(qrows),
        static_cast<const signed char*>(known), static_cast<int*>(pos),
        static_cast<int*>(prev), static_cast<int*>(hist),
        static_cast<float*>(dr), static_cast<unsigned char*>(done),
        static_cast<float*>(err), static_cast<unsigned char*>(risky), k, nx,
        ny, nz, max_steps);
}

}  // namespace

PB_EXPORT int pb_neargrid_rows(void* rho, void* codes, void* t_grad,
                               void* rows, int nx, int ny, int nz, int strict,
                               int device, void* stream) {
    cudaSetDevice(device);
    const long long n = static_cast<long long>(nx) * ny * nz;
    rows_kernel<<<pb::blocks_for(n, device), pb::kThreads, 0,
                  pb::as_stream(stream)>>>(
        static_cast<const double*>(rho),
        static_cast<const unsigned char*>(codes),
        static_cast<const double*>(t_grad), static_cast<double2*>(rows), nx,
        ny, nz, strict);
    return static_cast<int>(cudaGetLastError());
}

PB_EXPORT int pb_neargrid_qrows(void* rho, void* codes, void* t_grad,
                                void* qrows, int nx, int ny, int nz,
                                int strict, int device, void* stream) {
    cudaSetDevice(device);
    const long long n = static_cast<long long>(nx) * ny * nz;
    qrows_kernel<<<pb::blocks_for(n, device), pb::kThreads, 0,
                   pb::as_stream(stream)>>>(
        static_cast<const double*>(rho),
        static_cast<const unsigned char*>(codes),
        static_cast<const double*>(t_grad), static_cast<int2*>(qrows), nx, ny,
        nz, strict);
    return static_cast<int>(cudaGetLastError());
}

PB_EXPORT int pb_neargrid_walk(void* rows, void* starts, void* known,
                               void* pos_out, void* done_out, long long k,
                               int nx, int ny, int nz, int max_steps,
                               int device, void* stream) {
    cudaSetDevice(device);
    if (k <= 0) return static_cast<int>(cudaGetLastError());
    const long long blocks = (k + pb::kThreads - 1) / pb::kThreads;
    walk_kernel<<<static_cast<unsigned int>(blocks), pb::kThreads, 0,
                  pb::as_stream(stream)>>>(
        static_cast<const double2*>(rows), static_cast<const int*>(starts),
        static_cast<const signed char*>(known), static_cast<int*>(pos_out),
        static_cast<unsigned char*>(done_out), k, nx, ny, nz, max_steps);
    return static_cast<int>(cudaGetLastError());
}

// err and risky are null for the unscreened walk.
PB_EXPORT int pb_neargrid_walk_q(void* qrows, void* known, void* pos,
                                 void* prev, void* hist, void* dr, void* done,
                                 void* err, void* risky, long long k, int nx,
                                 int ny, int nz, int max_steps, int device,
                                 void* stream) {
    cudaSetDevice(device);
    if (k <= 0) return static_cast<int>(cudaGetLastError());
    const unsigned int blocks =
        static_cast<unsigned int>((k + pb::kThreads - 1) / pb::kThreads);
    if (err != nullptr)
        launch_walk_q<true>(blocks, stream, qrows, known, pos, prev, hist, dr,
                            done, err, risky, k, nx, ny, nz, max_steps);
    else
        launch_walk_q<false>(blocks, stream, qrows, known, pos, prev, hist,
                             dr, done, err, risky, k, nx, ny, nz, max_steps);
    return static_cast<int>(cudaGetLastError());
}

// The state arrays (pos, prev, hist (k, 3), dr (k, 3), steps) are updated
// in place; status is written.  stop may be null.
PB_EXPORT int pb_neargrid_walk_shard(void* rows, void* stop, void* pos,
                                     void* prev, void* hist, void* dr,
                                     void* steps, void* status, long long k,
                                     int lx, int ly, int ox, int oy, int nx,
                                     int ny, int nz, int max_steps,
                                     int device, void* stream) {
    cudaSetDevice(device);
    if (k <= 0) return static_cast<int>(cudaGetLastError());
    const long long blocks = (k + pb::kThreads - 1) / pb::kThreads;
    walk_shard_kernel<<<static_cast<unsigned int>(blocks), pb::kThreads, 0,
                        pb::as_stream(stream)>>>(
        static_cast<const double2*>(rows),
        static_cast<const unsigned char*>(stop), static_cast<int*>(pos),
        static_cast<int*>(prev), static_cast<int*>(hist),
        static_cast<double*>(dr), static_cast<int*>(steps),
        static_cast<unsigned char*>(status), k, lx, ly, ox, oy, nx, ny, nz,
        max_steps);
    return static_cast<int>(cudaGetLastError());
}
