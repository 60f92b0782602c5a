// The quantised-row walk: a lane's step, shared by the q walker
// (neargrid.cu) and the block walker (block_walk.cu), whose lanes run on
// walk.cuh's persistent lanes with refill.
//
// The arithmetic of JAX's _walk_segment_q / _walk_segment_qs
// (pybader_tpu/ops/neargrid.py:238, :337) and of the block kernel
// (pybader_tpu/ops/block_walk.py:177-263), which are op for op the same.
// Row words (neargrid.py:147-154): word0 = q0[0:19) | q1_lo[19:32), word1 =
// q1_hi[0:6) | q2[6:25) | code[25:30) | ONGRID[30]; q_i are signed 19-bit
// fixed point, g_i = float(q_i) * float(1/262143).  Everything is f32, each
// sum and product rounded on its own (__fadd_rn, __fmul_rn, -fmad=false),
// so the kernels equal the plain PyTorch versions bit for bit.
//
// Bound: a step's address comes from the step before, so both walks wait
// on dependent 8-byte row gathers; the integer work of a step sits on that
// chain.  So a step
//   - reads its stop bit from the 1-bit-a-voxel bitmap of neargrid.cu's
//     stop_bitmap_kernel (7.1 MB at 384^3, which stays in the 50 MB L2),
//     issued beside the row, not the int8 known grid (57 MB);
//   - keeps the lane's coordinates beside its position and steps them
//     with it, so no division sits on the chain (one at a lane's start);
//     the block test and the advance share them.  Dividing afresh each
//     step, after the row's load is issued, took 5-9 % longer (PERF.md);
//   - takes the ongrid target from a table of steps in shared memory and
//     walk.cuh's wrap_near (a compare and an add an axis), where the first
//     design took code / 9, (code / 3) % 3, code % 3 and six modulo wraps.
//     |g| <= 1 for rows normalised to max |g_i| = 1, so a step moves a
//     coordinate by at most 2 and wrap_near's premise holds.
#pragma once

#include "common.cuh"
#include "grad.cuh"
#include "walk.cuh"

namespace pb {

constexpr float kInvQScale = static_cast<float>(1.0 / 262143.0);
constexpr float kQsEps = static_cast<float>(3e-6);  // JAX _QS_EPS

// A lane of the walk: position, the revisit window, the f32 remainder dr
// and, for the screened walk, the error bound and the risky flag.
struct QLane {
    int pos, prev, h0, h1, h2;
    float d0, d1, d2;
    float err;
    bool risky;
};

__device__ __forceinline__ int sext19(int v) {
    return ((v & 0x7FFFF) ^ 0x40000) - 0x40000;
}

// round half away from zero, trunc(v +- 0.5), in f32
__device__ __forceinline__ float round_away_f(float v) {
    return truncf(v > 0.0f ? __fadd_rn(v, 0.5f) : __fsub_rn(v, 0.5f));
}

__device__ __forceinline__ float dist_half(float v) {
    return fabsf(__fsub_rn(fabsf(v), 0.5f));
}

// The table of ongrid steps, code -> (code / 9) | (code / 3 % 3) << 2 |
// (code % 3) << 4 (each axis' step plus one), for all 32 five-bit codes:
// the rows hold 0..26, and 27..31 keep the arithmetic of JAX's decode.
// Filled by the first warp of a block before its walk.
__device__ __forceinline__ void fill_q_steps(int* steps) {
    if (threadIdx.x < 32)
        steps[threadIdx.x] = threadIdx.x / 9 | (threadIdx.x / 3 % 3) << 2 |
                             (threadIdx.x % 3) << 4;
    __syncthreads();
}

// The row words of voxel pos into w and whether the walk stops there: a
// maximum (step code 13) or a bit of the stop bitmap (null: no stop set).
// Both loads are issued before either is used.
__device__ __forceinline__ bool q_fetch(const int2* __restrict__ qrows,
                                        const unsigned* __restrict__ stop,
                                        int pos, int2& w) {
    const unsigned word = stop != nullptr ? __ldg(&stop[pos >> 5]) : 0u;
    w = __ldg(&qrows[pos]);
    return ((w.y >> 25) & 31) == 13 || ((word >> (pos & 31)) & 1u);
}

// (x, y, z) of the flat index pos of an (nx, ny, nz) grid, nyz = ny * nz.
__device__ __forceinline__ void q_coords(int pos, int nyz, int nz, int& x,
                                         int& y, int& z) {
    x = pos / nyz;
    const int rem = pos - x * nyz;
    y = rem / nz;
    z = rem - y * nz;
}

// Step a lane that did not stop at s.pos = (x, y, z), whose row words are
// w; steps: the table of fill_q_steps.  (x, y, z) become the coordinates
// of the next position.
template <bool kScreened>
__device__ __forceinline__ void q_advance(int2 w, const int* steps, int& x,
                                          int& y, int& z, QLane& s, int nx,
                                          int ny, int nz) {
    const int code = (w.y >> 25) & 31;
    const bool ongrid = (w.y & (1 << 30)) != 0;
    const int q1 = ((w.x >> 19) & 0x1FFF) | ((w.y & 0x3F) << 13);
    const float g0 = __fmul_rn(static_cast<float>(sext19(w.x)), kInvQScale);
    const float g1 = __fmul_rn(static_cast<float>(sext19(q1)), kInvQScale);
    const float g2 = __fmul_rn(static_cast<float>(sext19(w.y >> 6)),
                               kInvQScale);
    const int d = steps[code];
    const int ax = wrap_near(x + (d & 3) - 1, nx);
    const int ay = wrap_near(y + ((d >> 2) & 3) - 1, ny);
    const int az = wrap_near(z + (d >> 4) - 1, nz);
    const int og = (ax * ny + ay) * nz + az;
    const float i0 = round_away_f(g0), i1 = round_away_f(g1),
                i2 = round_away_f(g2);
    const float e0 = __fsub_rn(__fadd_rn(s.d0, g0), i0);
    const float e1 = __fsub_rn(__fadd_rn(s.d1, g1), i1);
    const float e2 = __fsub_rn(__fadd_rn(s.d2, g2), i2);
    const float c0 = round_away_f(e0), c1 = round_away_f(e1),
                c2 = round_away_f(e2);
    const int tx = wrap_near(
        x + static_cast<int>(i0) + static_cast<int>(c0), nx);
    const int ty = wrap_near(
        y + static_cast<int>(i1) + static_cast<int>(c1), ny);
    const int tz = wrap_near(
        z + static_cast<int>(i2) + static_cast<int>(c2), nz);
    int nxt = (tx * ny + ty) * nz + tz;
    if (ongrid) nxt = og;
    const bool revisit = nxt == s.pos || nxt == s.prev || nxt == s.h0 ||
                         nxt == s.h1 || nxt == s.h2;
    const bool reset = ongrid || revisit;
    if (reset) nxt = og;
    x = reset ? ax : tx;
    y = reset ? ay : ty;
    z = reset ? az : tz;
    if (kScreened) {
        // round_away is discontinuous only at |v| = 0.5: a decision within
        // the error bound of it may differ from the exact-row walk's
        const float dg = fminf(fminf(dist_half(g0), dist_half(g1)),
                               dist_half(g2));
        const float dd = fminf(fminf(dist_half(e0), dist_half(e1)),
                               dist_half(e2));
        if (!ongrid && (dg < kQsEps || dd < __fadd_rn(s.err, kQsEps)))
            s.risky = true;
        s.err = reset ? 0.0f : __fadd_rn(s.err, kQsEps);
    }
    s.d0 = reset ? 0.0f : __fsub_rn(e0, c0);
    s.d1 = reset ? 0.0f : __fsub_rn(e1, c1);
    s.d2 = reset ? 0.0f : __fsub_rn(e2, c2);
    s.h2 = s.h1;
    s.h1 = s.h0;
    s.h0 = s.prev;
    s.prev = s.pos;
    s.pos = nxt;
}

// The state arrays of a q walk (hist and dr are (K, 3); err and risky
// null for the unscreened walk), updated in place.
struct QState {
    int* __restrict__ pos;
    int* __restrict__ prev;
    int* __restrict__ hist;
    float* __restrict__ dr;
    unsigned char* __restrict__ done;
    float* __restrict__ err;
    unsigned char* __restrict__ risky;

    template <bool kScreened>
    __device__ __forceinline__ QLane load(long long lane) const {
        QLane s;
        s.pos = pos[lane];
        s.prev = prev[lane];
        s.h0 = hist[3 * lane];
        s.h1 = hist[3 * lane + 1];
        s.h2 = hist[3 * lane + 2];
        s.d0 = dr[3 * lane];
        s.d1 = dr[3 * lane + 1];
        s.d2 = dr[3 * lane + 2];
        s.err = kScreened ? err[lane] : 0.0f;
        s.risky = kScreened ? risky[lane] != 0 : false;
        return s;
    }

    // A lane's state changes only when it steps: one that took no step
    // stores nothing (the arrays already hold it).
    template <bool kScreened>
    __device__ __forceinline__ void store(long long lane, const QLane& s,
                                          int taken) const {
        if (taken == 0) return;
        pos[lane] = s.pos;
        prev[lane] = s.prev;
        hist[3 * lane] = s.h0;
        hist[3 * lane + 1] = s.h1;
        hist[3 * lane + 2] = s.h2;
        dr[3 * lane] = s.d0;
        dr[3 * lane + 1] = s.d1;
        dr[3 * lane + 2] = s.d2;
        if (kScreened) {
            err[lane] = s.err;
            risky[lane] = s.risky ? 1 : 0;
        }
    }
};

}  // namespace pb
