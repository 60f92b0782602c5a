// One step of the exact-row neargrid walk, shared by the single-device
// walker and the shard walker of the mesh (neargrid.cu).
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
    int nxt = (wrap(x + i0 + c0, nx) * ny + wrap(y + i1 + c1, ny)) * nz +
              wrap(z + i2 + c2, nz);
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

}  // namespace pb
