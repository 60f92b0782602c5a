// One step of the quantised-row walk, shared by the q walker (neargrid.cu)
// and the block walker (block_walk.cu).
//
// The arithmetic of JAX's _walk_segment_q / _walk_segment_qs
// (pybader_tpu/ops/neargrid.py:238, :337) and of the block kernel
// (pybader_tpu/ops/block_walk.py:177-263), which are op for op the same.
// Row words (neargrid.py:147-154): word0 = q0[0:19) | q1_lo[19:32), word1 =
// q1_hi[0:6) | q2[6:25) | code[25:30) | ONGRID[30]; q_i are signed 19-bit
// fixed point, g_i = float(q_i) * float(1/262143).  Everything is f32, each
// sum and product rounded on its own (__fadd_rn, __fmul_rn, -fmad=false),
// so the kernels equal the plain PyTorch versions bit for bit.
#pragma once

#include "common.cuh"
#include "grad.cuh"

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

// A walk ends on a maximum (step code 13) or a known == 2 voxel.
__device__ __forceinline__ bool q_stops(int w1, const signed char* known,
                                        int pos) {
    return ((w1 >> 25) & 31) == 13 || (known != nullptr && known[pos] == 2);
}

__device__ __forceinline__ float dist_half(float v) {
    return fabsf(__fsub_rn(fabsf(v), 0.5f));
}

// Step a lane that did not stop at s.pos, whose row words are (w0, w1).
template <bool kScreened>
__device__ __forceinline__ void q_advance(int w0, int w1, QLane& s, int nx,
                                          int ny, int nz) {
    const int code = (w1 >> 25) & 31;
    const bool ongrid = (w1 & (1 << 30)) != 0;
    const int q1 = ((w0 >> 19) & 0x1FFF) | ((w1 & 0x3F) << 13);
    const float g0 = __fmul_rn(static_cast<float>(sext19(w0)), kInvQScale);
    const float g1 = __fmul_rn(static_cast<float>(sext19(q1)), kInvQScale);
    const float g2 = __fmul_rn(static_cast<float>(sext19(w1 >> 6)),
                               kInvQScale);
    const int nyz = ny * nz;
    const int x = s.pos / nyz;
    const int rem = s.pos - x * nyz;
    const int y = rem / nz;
    const int z = rem - y * nz;
    const int og = (wrap(x + code / 9 - 1, nx) * ny +
                    wrap(y + (code / 3) % 3 - 1, ny)) * nz +
                   wrap(z + code % 3 - 1, nz);
    const float i0 = round_away_f(g0), i1 = round_away_f(g1),
                i2 = round_away_f(g2);
    const float e0 = __fsub_rn(__fadd_rn(s.d0, g0), i0);
    const float e1 = __fsub_rn(__fadd_rn(s.d1, g1), i1);
    const float e2 = __fsub_rn(__fadd_rn(s.d2, g2), i2);
    const float c0 = round_away_f(e0), c1 = round_away_f(e1),
                c2 = round_away_f(e2);
    const int sx = static_cast<int>(i0) + static_cast<int>(c0);
    const int sy = static_cast<int>(i1) + static_cast<int>(c1);
    const int sz = static_cast<int>(i2) + static_cast<int>(c2);
    int nxt =
        (wrap(x + sx, nx) * ny + wrap(y + sy, ny)) * nz + wrap(z + sz, nz);
    if (ongrid) nxt = og;
    const bool revisit = nxt == s.pos || nxt == s.prev || nxt == s.h0 ||
                         nxt == s.h1 || nxt == s.h2;
    if (revisit) nxt = og;
    const bool reset = ongrid || revisit;
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

// Load and store a lane of the state arrays (hist and dr are (K, 3)).
template <bool kScreened>
__device__ __forceinline__ QLane load_lane(long long lane, const int* pos,
                                           const int* prev, const int* hist,
                                           const float* dr, const float* err,
                                           const unsigned char* risky) {
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

template <bool kScreened>
__device__ __forceinline__ void store_lane(long long lane, const QLane& s,
                                           int* pos, int* prev, int* hist,
                                           float* dr, float* err,
                                           unsigned char* risky) {
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

}  // namespace pb
