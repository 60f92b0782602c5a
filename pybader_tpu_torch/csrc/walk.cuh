// One step of the exact-row neargrid walk, and the persistent lanes with
// refill that run it, shared by the single-device walker and the shard
// walker of the mesh (neargrid.cu).
//
// The arithmetic of JAX's _walk_segment_packed (pybader_tpu/ops/neargrid.py
// :647) and of the mesh walker's step (pybader_tpu/parallel/walk.py:112-162):
// step by round_away(g) plus the rounded sub-voxel remainder dr; an ongrid
// flag, or a revisit of pos, prev or the 3-entry history, steps to the
// ongrid parent instead and resets dr.  Every sum is rounded on its own
// (__dadd_rn, and the library builds with -fmad=false), so the walkers
// equal the plain PyTorch versions bit for bit.
#pragma once

#include "common.cuh"
#include "grad.cuh"

namespace pb {

constexpr int kOngrid = 1;  // row flag: gradient ~ 0, step to the parent
constexpr int kMax = 2;     // row flag: the parent is the voxel itself

// A lane of the walk: flat position, the revisit window and dr.
struct Lane {
    int pos, prev, h0, h1, h2;
    double d0, d1, d2;
};

// An exact row (32 bytes): the gradient, the flat index of the ongrid
// parent and the flags.
struct Row {
    double g0, g1, g2;
    int parent, flags;
};

__device__ __forceinline__ Row load_row(const double2* __restrict__ rows,
                                        long long i) {
    const double2 a = __ldg(&rows[2 * i]);
    const double2 b = __ldg(&rows[2 * i + 1]);
    const long long word = __double_as_longlong(b.y);
    return Row{a.x, a.y, b.x, static_cast<int>(word & 0xffffffffLL),
               static_cast<int>((word >> 32) & 0xff)};
}

// v mod n where v is mostly in [-n, 2 n): a step moves a coordinate by
// round_away(g) + round_away(dr + g - round_away(g)), at most 2 either way
// for rows normalised to |g| <= 1, so a compare and an add wrap it; the
// remainder (dozens of dependent instructions on a walk's critical path)
// runs only for a coordinate still outside [0, n).
__device__ __forceinline__ int wrap_near(int v, int n) {
    if (static_cast<unsigned>(v) >= static_cast<unsigned>(n)) {
        v += v < 0 ? n : -n;
        if (static_cast<unsigned>(v) >= static_cast<unsigned>(n))
            v = wrap(v, n);
    }
    return v;
}

__device__ __forceinline__ int round_away(double v) {
    return static_cast<int>(trunc(__dadd_rn(v, v > 0.0 ? 0.5 : -0.5)));
}

// Step a lane that did not stop at s.pos = (x, y, z) of an (nx, ny, nz)
// grid, whose row is r.
__device__ __forceinline__ void advance(const Row& r, int x, int y, int z,
                                        Lane& s, int nx, int ny, int nz) {
    const int i0 = round_away(r.g0), i1 = round_away(r.g1),
              i2 = round_away(r.g2);
    const double e0 = __dsub_rn(__dadd_rn(s.d0, r.g0), i0);
    const double e1 = __dsub_rn(__dadd_rn(s.d1, r.g1), i1);
    const double e2 = __dsub_rn(__dadd_rn(s.d2, r.g2), i2);
    const int c0 = round_away(e0), c1 = round_away(e1), c2 = round_away(e2);
    int nxt = (wrap_near(x + i0 + c0, nx) * ny +
               wrap_near(y + i1 + c1, ny)) * nz +
              wrap_near(z + i2 + c2, nz);
    const bool ongrid = (r.flags & kOngrid) != 0;
    if (ongrid) nxt = r.parent;
    const bool revisit = nxt == s.pos || nxt == s.prev || nxt == s.h0 ||
                         nxt == s.h1 || nxt == s.h2;
    if (revisit) nxt = r.parent;
    if (ongrid || revisit) {
        s.d0 = s.d1 = s.d2 = 0.0;
    } else {
        s.d0 = __dsub_rn(e0, c0);
        s.d1 = __dsub_rn(e1, c1);
        s.d2 = __dsub_rn(e2, c2);
    }
    s.h2 = s.h1;
    s.h1 = s.h0;
    s.h0 = s.prev;
    s.prev = s.pos;
    s.pos = nxt;
}

// Persistent lanes with refill.  A walk launches only the blocks that fit
// on the card at once, and a thread whose lane ended takes the next one, so
// a warp does not idle while its longest lane walks: a warp claims `batch`
// lanes of [0, k) from the counter *next with one atomicAdd and hands them
// to its idle threads by ballot.  Walk holds one thread's lane and provides
//     bool start(long long lane): take up the lane; false if it is born
//         done (its result already stored);
//     bool step(long long lane): one step; true once the lane ended and
//         its result is stored.
template <class Walk>
__device__ __forceinline__ void walk_lanes(Walk& w,
                                           unsigned long long* next,
                                           long long k, long long batch) {
    constexpr unsigned kFull = 0xffffffffu;
    const int me = threadIdx.x & 31;
    const unsigned below = (1u << me) - 1u;
    long long lane = -1;  // this thread's lane, -1 while it has none
    // the warp's claimed lanes not yet handed out, [claim, claim_end);
    // uniform across the warp, as is more (the counter may hold lanes)
    long long claim = 0, claim_end = 0;
    bool more = true;
    for (;;) {
        unsigned idle = __ballot_sync(kFull, lane < 0);
        while (idle != 0 && more) {
            if (claim == claim_end) {
                unsigned long long b = 0;
                if (me == 0)
                    b = atomicAdd(next, static_cast<unsigned long long>(batch));
                b = __shfl_sync(kFull, b, 0);
                if (b >= static_cast<unsigned long long>(k)) {
                    more = false;
                    break;
                }
                claim = static_cast<long long>(b);
                claim_end = claim + batch < k ? claim + batch : k;
            }
            const long long avail = claim_end - claim;
            const int rank = __popc(idle & below);
            if (lane < 0 && rank < avail) {
                lane = claim + rank;
                if (!w.start(lane)) lane = -1;
            }
            const long long took = __popc(idle);
            claim += took < avail ? took : avail;
            idle = __ballot_sync(kFull, lane < 0);
        }
        if (idle == kFull) break;  // nothing left to claim or walk
        if (lane >= 0 && w.step(lane)) lane = -1;
    }
}

}  // namespace pb
