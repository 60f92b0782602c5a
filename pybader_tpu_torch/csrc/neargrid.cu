// Neargrid walk rows and the trajectory walkers.
//
// Replace the XLA walk of pybader_tpu/ops/neargrid.py: the row builds
// precompute_rows (:484, with _gd_components :64, _denom_flags :82 and
// _pack_parent :523) and precompute_qrows (:194, with _quantize_col :214 and
// _pack_qwords :220), the exact-row walk _walk_segment_packed (:647) as
// driven by walk (:907), and the quantised-row walks _walk_segment_q (:238)
// and _walk_segment_qs (:337).  The JAX drain loop's segments and compaction
// schedule the walks for the TPU without changing their results; here a
// thread walks a lane to its end in one launch and then takes the next
// lane (walk.cuh's walk_lanes, for every walker).  The shard walker
// replaces the mesh walker of pybader_tpu/parallel/walk.py:68
// (walk_sharded).
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
#include "march.cuh"
#include "qwalk.cuh"
#include "walk.cuh"

namespace {

using pb::kMax;
using pb::kOngrid;

// ----------------------------------------------------------------- rows
// Bound: device memory.  A voxel reads its density and its step code and
// writes a 32-byte row: 8 + 1 + 32 bytes a voxel from HBM, 0.693 ms at
// 384^3 on 3.35 TB/s, of which the rows' stores alone are 0.54 ms.  The
// FP64 work, 35 operations a voxel and three __ddiv_rn (each a reciprocal
// seed and 8 FP64 instructions on its fast path, tools/sass_count.py
// --ddiv), takes 0.200 ms at the card's FP64 rate.
//
// Design: the 2.5-D march of march.cuh over 4 x 32 columns of 32 planes,
// so the density comes from HBM about once and a voxel's addressing is a
// few 32-bit instructions.  Blocks of 128 threads, 8 an SM, and marches of
// 32 planes keep many blocks independent and the last wave of them short
// (2-3 % each against 8 x 32 columns and 64 planes, PERF.md).  A thread
// keeps the centre and the four (y, z) axis neighbours of three planes in
// registers (the x neighbours are the centres of the planes before and
// after); the ongrid parent comes from a 27-entry table of steps and
// compare wraps (no division or remainder a voxel).  A warp owns 32
// consecutive voxels of a z-row, so its rows are 1 KB of consecutive
// memory: each lane puts its row into the warp's slot of shared memory
// (16-byte vectors, swizzled so that neither side has a bank conflict)
// and the warp stores the 64 vectors with consecutive lanes on
// consecutive vectors, streaming (evict-first): the rows (1.8 GB at
// 384^3) never fit in the 50 MB L2, and stores with the default policy
// took 6 % longer.  Two 16-byte stores a thread straight from registers
// half-fill 32 sectors a warp instruction and took 45 % longer
// (PERF.md).  The transform travels by value as a kernel parameter.
constexpr int kRY = 4, kRZ = 32;  // a block's (y, z) column: a warp a y
constexpr int kRX = 32;           // planes a block marches
constexpr int kRBufs = 8;         // the ring: 7 planes in flight
using RMarch = pb::March<kRY, kRZ, kRX, kRBufs>;
constexpr int kRThreads = RMarch::kThreads;
constexpr int kRWarps = kRThreads / 32;

// The 3x3 gradient transform, row-major, passed by value.
struct Grad {
    double t[9];
};

// The density of a voxel and of its four (y, z) axis neighbours in one
// plane.
struct Cross {
    double c, ym, yp, zm, zp;
};

__device__ __forceinline__ void load_cross(const double* s, Cross& p) {
    constexpr int R = RMarch::kRow;
    p.ym = s[1];
    p.zm = s[R];
    p.c = s[R + 1];
    p.zp = s[R + 2];
    p.yp = s[2 * R + 1];
}

// 16-byte vector v of a warp's 64 in its shared slot: lanes 8k .. 8k + 7
// of a quarter-warp then meet 8 distinct banks both when lane l writes
// vectors 2l and 2l + 1 and when it reads vectors l and l + 32.
__device__ __forceinline__ int swizzle(int v) { return v ^ ((v >> 3) & 1); }

// One plane of the march: the row of voxel i = (x, y, z), whose planes
// x - 1, x, x + 1 are lo, mid, hi, into this warp's shared slot; then the
// warp stores its first nvec vectors at row (its first row of plane x).
template <bool kStrict>
__device__ __forceinline__ void rows_step(
        const Cross& lo, const Cross& mid, const Cross& hi, const Grad& g,
        int code, const int* steps, int i, int x, int y, int z, int nx,
        int ny, int nz, double2* slot, double2* row, int nvec) {
    const int lane = threadIdx.x & 31;
    const double ru[3] = {hi.c, mid.yp, mid.zp};
    const double rd[3] = {lo.c, mid.ym, mid.zm};
    double gd[3];
    const double mg = pb::gradient_of(mid.c, ru, rd, g.t, kStrict, gd);
    const double denom = mg > 0.0 ? mg : 1.0;
    const int d = steps[code & 31];
    int px = x + (d & 3) - 1;
    int py = y + ((d >> 2) & 3) - 1;
    int pz = z + (d >> 4) - 1;
    px = px < 0 ? px + nx : (px >= nx ? px - nx : px);
    py = py < 0 ? py + ny : (py >= ny ? py - ny : py);
    pz = pz < 0 ? pz + nz : (pz >= nz ? pz - nz : pz);
    const int parent = (px * ny + py) * nz + pz;
    const long long flags =
        (mg < 1e-14 ? kOngrid : 0) | (parent == i ? kMax : 0);
    const long long word =
        static_cast<long long>(static_cast<unsigned int>(parent)) |
        (flags << 32);
    slot[swizzle(2 * lane)] =
        make_double2(__ddiv_rn(gd[0], denom), __ddiv_rn(gd[1], denom));
    slot[swizzle(2 * lane + 1)] = make_double2(__ddiv_rn(gd[2], denom),
                                               __longlong_as_double(word));
    __syncwarp();
#pragma unroll
    for (int v = lane; v < 64; v += 32)
        if (v < nvec) __stcs(row + v, slot[swizzle(v)]);
}

// codes: ongrid step codes, 0..26 (a code is read as code & 31, so no
// byte reads outside the table of steps).
template <bool kStrict>
__global__ void __launch_bounds__(kRThreads, 8)
    rows_march_kernel(const double* __restrict__ rho,
                      const unsigned char* __restrict__ codes, const Grad g,
                      double2* __restrict__ rows, int nx, int ny, int nz) {
    __shared__ __align__(16) double ring[kRBufs][RMarch::kPlane];
    __shared__ __align__(16) double2 slots[kRWarps][64];
    // code -> (dx + 1) | (dy + 1) << 2 | (dz + 1) << 4
    __shared__ int steps[32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid < 32)
        steps[tid] = tid < 27 ? tid / 9 | (tid / 3 % 3) << 2 | (tid % 3) << 4
                              : 1 | 1 << 2 | 1 << 4;
    RMarch m;
    m.init(rho, ring, nx, ny, nz);
    Cross a, c, e;
    m.start();  // its barrier also publishes steps
    load_cross(m.corner(0), a);
    load_cross(m.corner(1), c);
    load_cross(m.corner(2), e);
    m.prime();
    const int y = m.y0 + warp, z = m.z0 + lane;
    const bool row_in = warp < min(kRY, ny - m.y0);
    const int vz = min(kRZ, nz - m.z0);
    const bool out = row_in && lane < vz;
    // a warp outside the grid stores nothing; one inside stores its vz rows
    const int nvec = row_in ? 2 * vz : 0;
    int i = out ? (m.x0 * ny + y) * nz + z : 0;
    double2* row =
        rows + (row_in ? 2LL * ((m.x0 * ny + y) * nz + m.z0) : 0);
    const unsigned char* cp = codes + i;
    const long long step = 2LL * m.plane;
    double2* slot = slots[warp];
    int code = out ? __ldcs(cp) : 13;
    int x = m.x0;
    // the planes rotate through a, c, e: unrolled by 3, no register moves;
    // each step fetches the next plane's code before its own arithmetic
    for (int s = 0; s < m.vx; s += 3) {
        int next = out && s + 1 < m.vx ? __ldcs(cp + m.plane) : 13;
        rows_step<kStrict>(a, c, e, g, code, steps, i, x, y, z, nx, ny, nz,
                           slot, row, nvec);
        if (s + 1 >= m.vx) break;
        cp += m.plane, i += m.plane, row += step, ++x, code = next;
        m.advance(s + 3, [&](const double* p) { load_cross(p, a); });
        next = out && s + 2 < m.vx ? __ldcs(cp + m.plane) : 13;
        rows_step<kStrict>(c, e, a, g, code, steps, i, x, y, z, nx, ny, nz,
                           slot, row, nvec);
        if (s + 2 >= m.vx) break;
        cp += m.plane, i += m.plane, row += step, ++x, code = next;
        m.advance(s + 4, [&](const double* p) { load_cross(p, c); });
        next = out && s + 3 < m.vx ? __ldcs(cp + m.plane) : 13;
        rows_step<kStrict>(e, a, c, g, code, steps, i, x, y, z, nx, ny, nz,
                           slot, row, nvec);
        if (s + 3 >= m.vx) break;
        cp += m.plane, i += m.plane, row += step, ++x, code = next;
        m.advance(s + 5, [&](const double* p) { load_cross(p, e); });
    }
    m.finish();
}

// ---------------------------------------------------------------- q-rows
// Bound: device memory, as the exact rows: 8 + 1 bytes read and 8 written
// a voxel.  q_i = round(g_i * 262143) rounds half to even, as jnp.round.
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
// The exact-row walk: from each start, walk.cuh's step until a maximum (row
// flag), a stop voxel (known == 2), or the cap; after max_steps steps one
// more fetch decides done.
//
// Bound: device memory, by sector.  A step's address comes from the step
// before, so a step reads one scattered 32-byte row sector of the 1.8 GB
// row array (at 384^3) and nothing can be prefetched; the lanes in flight
// and the card's rate of random sectors set the pace.  The least work is
// each distinct row read once (0.146 ms for iteration 1 at 384^3: 12.9 M
// rows, 148.8 M lane-steps).  The design does two things about it:
//   - persistent lanes with refill (walk.cuh's walk_lanes): the grid is
//     only what fits on the card at once, and a thread whose lane ends
//     takes the next lane from a counter in device memory, so a warp no
//     longer idles while its longest lane (up to the cap, against a mean
//     of 20-60 steps) walks: on iteration 1 a one-thread-a-lane launch
//     keeps 36 % of its lane-slots stepping.  A warp claims kWalkBatch
//     lanes with one atomicAdd and hands them to its idle threads by
//     ballot.  Results go to each lane's own index;
//   - the stop set is a 1-bit-a-voxel bitmap (stop_bitmap_kernel, built
//     before each walk: 7.1 MB at 384^3, which stays in the 50 MB L2), not
//     the int8 known grid (57 MB): one sector fewer a step to compete for
//     L2 once refill keeps every thread walking.  This is JAX's
//     update_stop (pybader_tpu/ops/neargrid.py:531) for the H100: it bakes
//     the stop set into the rows, which here would rewrite every sector of
//     the row array each iteration.
// Once refill fills the warps, steps run at the card's rate of random
// row reads, so launches whose warps were already busy gain little
// (PERF.md).
constexpr int kWalkThreads = 256;
constexpr long long kWalkBatch = 32;

// Bit j of the 4 bytes of v set where byte j equals that byte of `value`
// (the stop value in every byte; byte 0 lowest).
__device__ __forceinline__ unsigned eq4(int v, unsigned value) {
    const unsigned m = __vcmpeq4(static_cast<unsigned>(v), value);
    return ((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) |
           ((m >> 28) & 8u);
}

// bits[w] bit b = (known[32 w + b] == value): 2 for the known grid, 1 for
// a bool stop set.  A thread reads a word's 32 bytes as two 16-byte loads
// (known 16-byte aligned); one thread packs the ragged last word.
__global__ void stop_bitmap_kernel(const signed char* __restrict__ known,
                                   unsigned* __restrict__ bits, long long n,
                                   int value) {
    const unsigned v4 = static_cast<unsigned>(value & 0xff) * 0x01010101u;
    const long long full = n >> 5;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         w < full; w += stride) {
        const int4* p = reinterpret_cast<const int4*>(known + (w << 5));
        const int4 a = __ldg(p), b = __ldg(p + 1);
        bits[w] = eq4(a.x, v4) | eq4(a.y, v4) << 4 | eq4(a.z, v4) << 8 |
                  eq4(a.w, v4) << 12 | eq4(b.x, v4) << 16 |
                  eq4(b.y, v4) << 20 | eq4(b.z, v4) << 24 |
                  eq4(b.w, v4) << 28;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0 && (n & 31)) {
        unsigned word = 0;
        for (long long i = full << 5; i < n; ++i)
            word |= (known[i] == value ? 1u : 0u) << (i & 31);
        bits[full] = word;
    }
}

// One thread's lane of the single-device walk (walk_lanes' Walk).
struct GridWalk {
    const double2* __restrict__ rows;
    const int* __restrict__ starts;
    const unsigned* __restrict__ stop;
    int* __restrict__ pos_out;
    unsigned char* __restrict__ done_out;
    int nx, ny, nz, nyz, max_steps;
    pb::Lane s;
    int taken;

    __device__ __forceinline__ bool start(long long lane) {
        s = pb::Lane{starts[lane], -1, -1, -1, -1, 0.0, 0.0, 0.0};
        taken = 0;
        if (s.pos >= 0) return true;
        pos_out[lane] = 0;  // a padding lane, born done at voxel 0
        done_out[lane] = 1;
        return false;
    }

    __device__ __forceinline__ bool step(long long lane) {
        // the stop word is read beside the row, so both are in flight
        const unsigned word = stop != nullptr ? __ldg(&stop[s.pos >> 5]) : 0u;
        const pb::Row r = pb::load_row(rows, s.pos);
        const bool stopped =
            (r.flags & kMax) || ((word >> (s.pos & 31)) & 1u);
        if (stopped || taken == max_steps) {
            pos_out[lane] = s.pos;
            done_out[lane] = stopped ? 1 : 0;
            return true;
        }
        const int x = s.pos / nyz;
        const int rem = s.pos - x * nyz;
        const int y = rem / nz;
        pb::advance(r, x, y, rem - y * nz, s, nx, ny, nz);
        ++taken;
        return false;
    }
};

__global__ void __launch_bounds__(kWalkThreads)
walk_kernel(const double2* __restrict__ rows, const int* __restrict__ starts,
            const unsigned* __restrict__ stop, int* __restrict__ pos_out,
            unsigned char* __restrict__ done_out,
            unsigned long long* __restrict__ next, long long k, int nx,
            int ny, int nz, int max_steps) {
    GridWalk w{rows, starts, stop, pos_out, done_out, nx, ny, nz, ny * nz,
               max_steps, pb::Lane{0, -1, -1, -1, -1, 0.0, 0.0, 0.0}, 0};
    pb::walk_lanes(w, next, k, kWalkBatch);
}

// The walk of one shard of a mesh, resumable: the owner-computes hand-off
// of parallel/walk.py.  The shard is the box [ox, ox + lx) x [oy, oy + ly)
// x [0, nz) of the (nx, ny, nz) grid; its rows (lx * ly * nz of them, in
// the shard's C order) carry global parents, and its stop set is a bitmap
// of the same order.  Positions are global flat indices, and each step
// wraps on the global grid.  A lane resumes from its state (pos, prev,
// hist, dr, steps taken, read from the *_in arrays) and walks while it
// stays in the shard; it ends with status 1 on a maximum or a stop voxel,
// 2 at the cap (steps == max_steps, not done), or 0 when its position has
// left the shard (or lies off the grid), for the owner of that position to
// resume; its new state goes to the output arrays.  The steps and fetches
// are walk_kernel's, so a lane handed from shard to shard ends where the
// single-device walk ends it.
//
// Bound: the dependent row gathers, as walk_kernel; the state (48 bytes)
// is read once and written once a lane.  The design is walk_kernel's:
// persistent lanes with refill (a hand-off round's longest lane walks up
// to the cap while most end in a few steps) and the stop set as a bitmap
// read beside the row, built once a walk_sharded call.  The position's
// coordinates give the row's address here (the shard's own order), so
// they divide by a 64-bit multiply (Divisor) on the step's critical path;
// walk_kernel divides after its row load is issued, where the integer
// division measured faster (PERF.md).
struct ShardWalk {
    const double2* __restrict__ rows;
    const unsigned* __restrict__ stop;
    const int* __restrict__ pos_in;
    const int* __restrict__ prev_in;
    const int* __restrict__ hist_in;
    const double* __restrict__ dr_in;
    const int* __restrict__ steps_in;
    int* __restrict__ pos;
    int* __restrict__ prev;
    int* __restrict__ hist;
    double* __restrict__ dr;
    int* __restrict__ steps;
    unsigned char* __restrict__ status;
    int lx, ly, ox, oy, nx, ny, nz, max_steps;
    unsigned n;               // nx * ny * nz
    pb::Divisor by_yz, by_z;  // ny * nz, nz
    pb::Lane s;
    int taken;

    __device__ __forceinline__ bool start(long long lane) {
        s = pb::Lane{pos_in[lane],          prev_in[lane],
                     hist_in[3 * lane],     hist_in[3 * lane + 1],
                     hist_in[3 * lane + 2], dr_in[3 * lane],
                     dr_in[3 * lane + 1],   dr_in[3 * lane + 2]};
        taken = steps_in[lane];
        return true;
    }

    __device__ __forceinline__ bool step(long long lane) {
        unsigned char end = 0;  // off the shard
        if (static_cast<unsigned>(s.pos) < n) {
            const int x = by_yz.div(s.pos);
            const int rem = s.pos - x * by_yz.d;
            const int y = by_z.div(rem);
            const int z = rem - y * nz;
            if (static_cast<unsigned>(x - ox) < static_cast<unsigned>(lx) &&
                static_cast<unsigned>(y - oy) < static_cast<unsigned>(ly)) {
                const int li = ((x - ox) * ly + (y - oy)) * nz + z;
                const unsigned word =
                    stop != nullptr ? __ldg(&stop[li >> 5]) : 0u;
                const pb::Row r = pb::load_row(rows, li);
                if ((r.flags & kMax) || ((word >> (li & 31)) & 1u)) {
                    end = 1;
                } else if (taken == max_steps) {
                    end = 2;
                } else {
                    pb::advance(r, x, y, z, s, nx, ny, nz);
                    ++taken;
                    return false;
                }
            }
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
        return true;
    }
};

__global__ void __launch_bounds__(kWalkThreads)
walk_shard_kernel(ShardWalk w, unsigned long long* __restrict__ next,
                  long long k) {
    pb::walk_lanes(w, next, k, kWalkBatch);
}

// Resume quantised-row walks (state in place) for up to max_steps steps:
// qwalk.cuh's step on 8-byte q-rows, f32 dr, the stop set from the bitmap
// of stop_bitmap_kernel; for the screened walk also the error bound and
// the risky flag.  A lane stops on code 13 or a stop bit; after max_steps
// steps one more fetch decides done, and a lane that is not done keeps its
// state for the caller.
//
// Bound: the dependent 8-byte row gathers, as walk_kernel.  The lanes the
// hybrid's variants hand this walker have mostly ended in the block phase
// (0.1-1.0 M of 0.8-7.3 M lanes still walk at 384^3), and the rest walk up
// to the cap.  So the design is walk_kernel's: persistent lanes with refill
// (walk.cuh's walk_lanes), where a done lane (padding, or retired in the
// block phase) takes no thread (start() is false) and a warp does not wait
// on its longest lane.  The host passes the lanes up to the last one not
// done and sizes a warp's claim to the share of them that walks, about a
// warp's worth a claim; walk_q hands the lanes on in the block rounds'
// last order, where those still walking come first.  The stop bitmap is
// read beside the row and built once a walk (ops/neargrid.py walk_q) for
// the block rounds and this walker.
template <bool kScreened>
struct QGridWalk {
    const int2* __restrict__ qrows;
    const unsigned* __restrict__ stop;
    const int* steps;  // the block's table of q steps (shared memory)
    pb::QState st;
    int nx, ny, nz, nyz, max_steps;
    pb::QLane s;
    int taken;
    int x, y, z;  // the coordinates of s.pos

    __device__ __forceinline__ bool start(long long lane) {
        if (st.done[lane]) return false;
        s = st.load<kScreened>(lane);
        pb::q_coords(s.pos, nyz, nz, x, y, z);
        taken = 0;
        return true;
    }

    __device__ __forceinline__ bool step(long long lane) {
        int2 w;
        const bool stopped = pb::q_fetch(qrows, stop, s.pos, w);
        if (stopped || taken == max_steps) {
            if (stopped) st.done[lane] = 1;
            st.store<kScreened>(lane, s, taken);
            return true;
        }
        pb::q_advance<kScreened>(w, steps, x, y, z, s, nx, ny, nz);
        ++taken;
        return false;
    }
};

template <bool kScreened>
__global__ void __launch_bounds__(kWalkThreads)
walk_q_kernel(QGridWalk<kScreened> w, unsigned long long* __restrict__ next,
              long long k, long long batch) {
    __shared__ int steps[32];
    pb::fill_q_steps(steps);
    w.steps = steps;
    pb::walk_lanes(w, next, k, batch);
}

template <bool kScreened>
void launch_walk_q(const QGridWalk<kScreened>& w, void* next, long long k,
                   long long batch, int device, void* stream) {
    const long long want = (k + kWalkThreads - 1) / kWalkThreads;
    const int cap = pb::resident_blocks(walk_q_kernel<kScreened>,
                                        kWalkThreads, 0, device);
    walk_q_kernel<kScreened><<<static_cast<unsigned int>(want < cap ? want
                                                                    : cap),
                               kWalkThreads, 0, pb::as_stream(stream)>>>(
        w, static_cast<unsigned long long*>(next), k, batch);
}

}  // namespace

// t_grad: the nine doubles of the 3x3 transform in host memory, row-major.
PB_EXPORT int pb_neargrid_rows(void* rho, void* codes, void* t_grad,
                               void* rows, int nx, int ny, int nz, int strict,
                               int device, void* stream) {
    cudaSetDevice(device);
    Grad g;
    for (int k = 0; k < 9; ++k)
        g.t[k] = static_cast<const double*>(t_grad)[k];
    // nx * ny * nz < 2^31
    const int blocks = RMarch::blocks(nx, ny, nz);
    if (blocks < 1) return static_cast<int>(cudaGetLastError());
    const auto kernel = strict ? rows_march_kernel<true>
                               : rows_march_kernel<false>;
    kernel<<<blocks, kRThreads, 0, pb::as_stream(stream)>>>(
        static_cast<const double*>(rho),
        static_cast<const unsigned char*>(codes), g,
        static_cast<double2*>(rows), nx, ny, nz);
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

// stop: the bitmap of pb_stop_bitmap, or null.  next: a zeroed 64-bit
// counter, the walk's claim of lanes.
PB_EXPORT int pb_neargrid_walk(void* rows, void* starts, void* stop,
                               void* pos_out, void* done_out, void* next,
                               long long k, int nx, int ny, int nz,
                               int max_steps, int device, void* stream) {
    cudaSetDevice(device);
    if (k <= 0) return static_cast<int>(cudaGetLastError());
    const long long want = (k + kWalkThreads - 1) / kWalkThreads;
    const int cap =
        pb::resident_blocks(walk_kernel, kWalkThreads, 0, device);
    walk_kernel<<<static_cast<unsigned int>(want < cap ? want : cap),
                  kWalkThreads, 0, pb::as_stream(stream)>>>(
        static_cast<const double2*>(rows), static_cast<const int*>(starts),
        static_cast<const unsigned*>(stop), static_cast<int*>(pos_out),
        static_cast<unsigned char*>(done_out),
        static_cast<unsigned long long*>(next), k, nx, ny, nz, max_steps);
    return static_cast<int>(cudaGetLastError());
}

// bits: (n + 31) / 32 words; known must be 16-byte aligned
// (cudaErrorInvalidValue if not).
PB_EXPORT int pb_stop_bitmap(void* known, void* bits, long long n, int value,
                             int device, void* stream) {
    cudaSetDevice(device);
    if (reinterpret_cast<unsigned long long>(known) & 15ull)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n <= 0) return static_cast<int>(cudaGetLastError());
    stop_bitmap_kernel<<<pb::blocks_for((n >> 5) + 1, device), pb::kThreads,
                         0, pb::as_stream(stream)>>>(
        static_cast<const signed char*>(known), static_cast<unsigned*>(bits),
        n, value);
    return static_cast<int>(cudaGetLastError());
}

// What a walk launch gets (shard: the shard walker's, else the
// single-device walker's), into the host array out[5]: resident blocks per
// SM, threads a block, SMs, registers a thread, local (spill) bytes.
template <class Kernel>
int walk_occupancy(Kernel kernel, int device, int* o) {
    cudaFuncAttributes a;
    cudaFuncGetAttributes(&a, kernel);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[0], kernel, kWalkThreads,
                                                  0);
    o[1] = kWalkThreads;
    cudaDeviceGetAttribute(&o[2], cudaDevAttrMultiProcessorCount, device);
    o[3] = a.numRegs;
    o[4] = static_cast<int>(a.localSizeBytes);
    return static_cast<int>(cudaGetLastError());
}

PB_EXPORT int pb_neargrid_walk_occupancy(int shard, int device, void* out) {
    cudaSetDevice(device);
    int* o = static_cast<int*>(out);
    return shard ? walk_occupancy(walk_shard_kernel, device, o)
                 : walk_occupancy(walk_kernel, device, o);
}

// The state (pos, prev, hist (k, 3), dr (k, 3), done, err, risky) is
// updated in place; err and risky are null for the unscreened walk.  stop:
// the bitmap of pb_stop_bitmap, or null.  next: a zeroed 64-bit counter,
// the walk's claim of lanes, batch lanes a warp's claim (a multiple of 32).
PB_EXPORT int pb_neargrid_walk_q(void* qrows, void* stop, void* pos,
                                 void* prev, void* hist, void* dr, void* done,
                                 void* err, void* risky, void* next,
                                 long long k, long long batch, int nx, int ny,
                                 int nz, int max_steps, int device,
                                 void* stream) {
    cudaSetDevice(device);
    if (k <= 0) return static_cast<int>(cudaGetLastError());
    const pb::QState st{static_cast<int*>(pos),
                        static_cast<int*>(prev),
                        static_cast<int*>(hist),
                        static_cast<float*>(dr),
                        static_cast<unsigned char*>(done),
                        static_cast<float*>(err),
                        static_cast<unsigned char*>(risky)};
    const pb::QLane s0{0, -1, -1, -1, -1, 0.0f, 0.0f, 0.0f, 0.0f, false};
    const auto* q = static_cast<const int2*>(qrows);
    const auto* bits = static_cast<const unsigned*>(stop);
    if (err != nullptr)
        launch_walk_q(QGridWalk<true>{q, bits, nullptr, st, nx, ny, nz,
                                      ny * nz, max_steps, s0},
                      next, k, batch, device, stream);
    else
        launch_walk_q(QGridWalk<false>{q, bits, nullptr, st, nx, ny, nz,
                                       ny * nz, max_steps, s0},
                      next, k, batch, device, stream);
    return static_cast<int>(cudaGetLastError());
}

// The input state (pos, prev, hist (k, 3), dr (k, 3), steps) is read, the
// new state written to the output arrays and status written.  stop: the
// shard's bitmap of pb_stop_bitmap, or null.  next: a zeroed 64-bit
// counter, the walk's claim of lanes.
PB_EXPORT int pb_neargrid_walk_shard(
        void* rows, void* stop, void* pos_in, void* prev_in, void* hist_in,
        void* dr_in, void* steps_in, void* pos, void* prev, void* hist,
        void* dr, void* steps, void* status, void* next, long long k, int lx,
        int ly, int ox, int oy, int nx, int ny, int nz, int max_steps,
        int device, void* stream) {
    cudaSetDevice(device);
    if (k <= 0) return static_cast<int>(cudaGetLastError());
    const ShardWalk w{
        static_cast<const double2*>(rows), static_cast<const unsigned*>(stop),
        static_cast<const int*>(pos_in), static_cast<const int*>(prev_in),
        static_cast<const int*>(hist_in), static_cast<const double*>(dr_in),
        static_cast<const int*>(steps_in), static_cast<int*>(pos),
        static_cast<int*>(prev), static_cast<int*>(hist),
        static_cast<double*>(dr), static_cast<int*>(steps),
        static_cast<unsigned char*>(status), lx, ly, ox, oy, nx, ny, nz,
        max_steps, static_cast<unsigned>(nx) * ny * nz,
        pb::Divisor::of(ny * nz), pb::Divisor::of(nz),
        pb::Lane{0, -1, -1, -1, -1, 0.0, 0.0, 0.0}, 0};
    const long long want = (k + kWalkThreads - 1) / kWalkThreads;
    const int cap =
        pb::resident_blocks(walk_shard_kernel, kWalkThreads, 0, device);
    walk_shard_kernel<<<static_cast<unsigned int>(want < cap ? want : cap),
                        kWalkThreads, 0, pb::as_stream(stream)>>>(
        w, static_cast<unsigned long long*>(next), k);
    return static_cast<int>(cudaGetLastError());
}
