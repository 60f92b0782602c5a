// Edge classification: the ``known`` grid of neargrid refinement.
//
// Replace the TPU kernels of pybader_tpu/ops/pallas_edges.py (_call, :178):
// edge_find (check=False, :191) and edge_check (check=True, :199), whose
// semantics are the XLA stencils _edge_find_xla / _edge_check_xla of
// pybader_tpu/ops/edges.py.  known: -2 edge, -1 near an edge, 2 interior or
// local maximum, 0 vacuum away from edges.  A voxel is an edge when it is
// not vacuum, not a local maximum (is_max, the stencil's self step) and some
// non-vacuum voxel of its periodic 26-neighbourhood carries another label;
// vacuum voxels are never edge candidates.
//
// Both are one launch over 8x8x32 tiles (z fastest), as the TPU kernel
// is one fused pass over plane groups with a halo; they share the tile
// machinery below (Tile, halo_row, stage_labels, stage_bits, differs_s,
// the row words).  Flags become one 64-bit word per z-row of a tile grown
// by 1 or 2 (bit zr + 2 for z offset zr in [-2, 34)), so every 3x3x3
// box-OR is three shifts and nine word ORs.  Rows move in 16-byte vectors
// where nz and the pointers allow, scalars elsewhere.
//
// edge_find: a voxel's output depends on the edge flags within 1 of it,
// and an edge flag on the labels within 1 of its voxel, so each block
// stages labels for its tile and a 2-voxel periodic halo.  Most of a
// basin boundary's tiles are crossed by it in a few rows only, so the
// test goes by z-rows: a row of tile + 1 can hold an edge only where its
// 3x3 neighbour rows hold two non-vacuum labels.  The block finds each
// row's least and greatest non-vacuum label, lists the rows of tile + 1
// that may hold an edge, and tests their voxels only, four a thread: the
// least and greatest label of the 3x3 neighbour rows at each z (two
// vector reads of shared memory a row), then 3-wide along z.  A tile with
// no such row (at most one non-vacuum label near any row) writes 2 or 0
// from its labels and never reads is_max; another stages the is_max bits
// (tile + 1) and ORs the edge words into the near mask of its interior.
// Bound: device memory.  The function reads labels everywhere, is_max at
// the non-vacuum voxels whose box holds another label, and writes known:
// 5 bytes a voxel and a little; the halo re-reads (2.5x the tile for
// labels) hit L2.
//
// edge_check: a voxel's output depends on known == -2 at most 2 voxels
// away (a candidate lies within 1 of a -2; a new edge within 1 of the
// voxel needs a -2 within 1 of itself), so each block stages known for its
// tile and a 2-voxel halo, the -2 flags as row words.  A tile with no -2
// in its halo region copies known and never reads labels or is_max; an
// active tile stages labels (tile + 2) and the is_max bits (tile + 1),
// tests only the candidates for an edge, and ORs the new-edge words into
// near_new for its interior.
// Bound: device memory.  An active tile reads known, labels and is_max and
// writes known: 7 bytes a voxel; a skipped tile reads and writes known: 2.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kTX = 8, kTY = 8, kTZ = 32;      // tile interior
constexpr int kRowsIn = kTX * kTY;             // interior rows
constexpr int kH2Y = kTY + 4, kRows2 = (kTX + 4) * kH2Y;  // rows, tile + 2
constexpr int kH1Y = kTY + 2, kRows1 = (kTX + 2) * kH1Y;  // rows, tile + 1
constexpr int kRowLen = kTZ + 2;     // voxels a row of tile + 1
constexpr int kLabStride = kTZ + 8;  // z offsets -2..33 at 2..37; 16 B rows
constexpr int kCheckThreads = 256;
typedef unsigned long long u64;

// v mod n for any v (halo coordinates of axes shorter than the halo wrap
// more than once).
__device__ __forceinline__ int mod_n(int v, int n) {
    v %= n;
    return v < 0 ? v + n : v;
}

// One bit per byte of a 16-byte vector: byte k -> bit k.  EQ: byte == -2;
// else byte != 0.
template <bool EQ>
__device__ __forceinline__ unsigned byte_mask16(uint4 v) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    unsigned m = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const unsigned e = EQ ? __vcmpeq4(w[k], 0xFEFEFEFEu)
                              : __vcmpne4(w[k], 0u);
        m |= ((e & 0x01u) | ((e >> 7) & 0x02u) | ((e >> 14) & 0x04u) |
              ((e >> 21) & 0x08u)) << (4 * k);
    }
    return m;
}

// The 3-wide OR along z of a row word.
__device__ __forceinline__ u64 zbox(u64 w) { return w | (w << 1) | (w >> 1); }

// A block's tile: origin, extent inside the grid, and the periodic
// coordinates of its halo, each wrapped once: gx[hx + 2] for hx in
// [-2, kTX + 2), gy likewise, gz[k] for the z offsets -2, -1, vz, vz + 1.
struct Tile {
    int x0, y0, z0, vx, vy, vz;
    int gx[kTX + 4], gy[kTY + 4], gz[4];
};

// Fill the block's tile from blockIdx (block-collective).  The halo
// coordinates are visible after the caller's next barrier.
__device__ void init_tile(Tile& t, int nx, int ny, int nz) {
    const int tid = threadIdx.x;
    if (tid == 0) {
        const int tiles_z = (nz + kTZ - 1) / kTZ;
        const int tiles_y = (ny + kTY - 1) / kTY;
        const int rest = blockIdx.x / tiles_z;
        t.x0 = rest / tiles_y * kTX;
        t.y0 = rest % tiles_y * kTY;
        t.z0 = blockIdx.x % tiles_z * kTZ;
        t.vx = min(kTX, nx - t.x0);
        t.vy = min(kTY, ny - t.y0);
        t.vz = min(kTZ, nz - t.z0);
    }
    __syncthreads();
    if (tid < kTX + 4) t.gx[tid] = mod_n(t.x0 + tid - 2, nx);
    else if (tid < kTX + kTY + 8) t.gy[tid - kTX - 4] =
        mod_n(t.y0 + tid - kTX - 6, ny);
    else if (tid < kTX + kTY + 12) {
        const int slot = tid - kTX - kTY - 8;
        t.gz[slot] = mod_n(t.z0 + (slot < 2 ? slot - 2 : t.vz + slot - 2),
                           nz);
    }
}

// Row r of the tile grown by H: its offsets, whether it maps to voxels of
// the grid, and the flat index of its z = 0 voxel.
template <int H>
__device__ __forceinline__ bool halo_row(const Tile& t, int r, int ny, int nz,
                                         int& hx, int& hy, int& base) {
    hx = r / (kTY + 2 * H) - H;
    hy = r % (kTY + 2 * H) - H;
    base = (t.gx[hx + 2] * ny + t.gy[hy + 2]) * nz;
    return hx < t.vx + H && hy < t.vy + H;
}

// Stage a byte grid's rows of the tile grown by H as row words (bit zr + 2
// set where the byte matches: == -2 if EQ, else != 0); with keep, the
// interior rows' bytes also go to keep.  Returns whether this thread set a
// bit.  words must be zero.
template <int H, bool EQ>
__device__ bool stage_bits(const signed char* __restrict__ g, const Tile& t,
                           bool vec, int ny, int nz, u64* words,
                           signed char* keep) {
    constexpr int kRows = (kTX + 2 * H) * (kTY + 2 * H);
    bool any = false;
#pragma unroll
    for (int k = 0; k < (kRows * 2 + kCheckThreads - 1) / kCheckThreads;
         ++k) {
        const int i = threadIdx.x + k * kCheckThreads;
        if (i >= kRows * 2) break;
        const int r = i >> 1, c = i & 1;
        int hx, hy, base;
        if (!halo_row<H>(t, r, ny, nz, hx, hy, base)) continue;
        signed char* kr = nullptr;
        if (keep != nullptr && hx >= 0 && hx < kTX && hy >= 0 && hy < kTY)
            kr = keep + (hx * kTY + hy) * kTZ + 16 * c;
        const signed char* src = g + base + t.z0 + 16 * c;
        unsigned m = 0;
        if (vec && 16 * c + 16 <= t.vz) {
            const uint4 v = *reinterpret_cast<const uint4*>(src);
            m = byte_mask16<EQ>(v);
            if (kr != nullptr) *reinterpret_cast<uint4*>(kr) = v;
        } else {
            for (int j = 0; j < 16 && 16 * c + j < t.vz; ++j) {
                const signed char b = src[j];
                m |= static_cast<unsigned>(EQ ? b == -2 : b != 0) << j;
                if (kr != nullptr) kr[j] = b;
            }
        }
        if (m) {
            atomicOr(&words[r], static_cast<u64>(m) << (2 + 16 * c));
            any = true;
        }
    }
#pragma unroll
    for (int k = 0; k < (kRows * 2 * H + kCheckThreads - 1) / kCheckThreads;
         ++k) {
        const int i = threadIdx.x + k * kCheckThreads;
        if (i >= kRows * 2 * H) break;
        const int r = i / (2 * H), slot = i % (2 * H) + 2 - H;
        int hx, hy, base;
        if (!halo_row<H>(t, r, ny, nz, hx, hy, base)) continue;
        const signed char b = g[base + t.gz[slot]];
        if (EQ ? b == -2 : b != 0) {
            const int zr = slot < 2 ? slot - 2 : t.vz + slot - 2;
            atomicOr(&words[r], 1ull << (zr + 2));
            any = true;
        }
    }
    return any;
}

// Stage labels for the tile grown by 2: lab[r * kLabStride + 4 + zr].
__device__ void stage_labels(const int* __restrict__ labels, const Tile& t,
                             bool vec, int ny, int nz, int* __restrict__ lab) {
    constexpr int kItems = kRows2 * (kTZ / 4);
#pragma unroll
    for (int k = 0; k < (kItems + kCheckThreads - 1) / kCheckThreads; ++k) {
        const int i = threadIdx.x + k * kCheckThreads;
        if (i >= kItems) break;
        const int r = i / (kTZ / 4), c = i % (kTZ / 4);
        int hx, hy, base;
        if (!halo_row<2>(t, r, ny, nz, hx, hy, base)) continue;
        const int* src = labels + base + t.z0 + 4 * c;
        int* dst = lab + r * kLabStride + 4 + 4 * c;
        if (vec && 4 * c + 4 <= t.vz) {
            *reinterpret_cast<int4*>(dst) =
                *reinterpret_cast<const int4*>(src);
        } else {
            for (int j = 0; j < 4 && 4 * c + j < t.vz; ++j) dst[j] = src[j];
        }
    }
#pragma unroll
    for (int k = 0; k < (kRows2 * 4 + kCheckThreads - 1) / kCheckThreads;
         ++k) {
        const int i = threadIdx.x + k * kCheckThreads;
        if (i >= kRows2 * 4) break;
        const int r = i >> 2, slot = i & 3;
        int hx, hy, base;
        if (!halo_row<2>(t, r, ny, nz, hx, hy, base)) continue;
        const int zr = slot < 2 ? slot - 2 : t.vz + slot - 2;
        lab[r * kLabStride + 4 + zr] = labels[base + t.gz[slot]];
    }
}

// Some non-vacuum voxel of the 27-box around (hx, hy, zr), whose own label
// is not vacuum, carries another label: the box's least non-vacuum label
// (vacuum, -1, is the greatest as unsigned) differs from its greatest
// (vacuum the least as signed).
__device__ __forceinline__ bool differs_s(const int* __restrict__ lab, int hx,
                                          int hy, int zr) {
    unsigned lo = UINT_MAX;
    int hi = -1;
#pragma unroll
    for (int dx = 1; dx <= 3; ++dx)
#pragma unroll
        for (int dy = 1; dy <= 3; ++dy) {
            const int* row =
                lab + ((hx + dx) * kH2Y + hy + dy) * kLabStride + 3 + zr;
#pragma unroll
            for (int dz = 0; dz < 3; ++dz) {
                const int l = row[dz];
                lo = min(lo, static_cast<unsigned>(l));
                hi = max(hi, l);
            }
        }
    return static_cast<int>(lo) != hi;
}

// The 3x3x3 box-OR of tile + 1 row words at interior row (ix, iy).
__device__ __forceinline__ u64 box_word(const u64* words, int ix, int iy) {
    u64 w = 0;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
            w |= zbox(words[(ix + dx) * kH1Y + iy + dy]);
    return w;
}

// Store half c of an interior row: 16 bytes, or the first t.vz - 16 c.
__device__ __forceinline__ void store_half(signed char* dst, const uint4& v,
                                           bool vec, int c, const Tile& t) {
    if (vec && 16 * c + 16 <= t.vz) {
        *reinterpret_cast<uint4*>(dst) = v;
    } else {
        const signed char* b = reinterpret_cast<const signed char*>(&v);
        for (int j = 0; j < 16 && 16 * c + j < t.vz; ++j) dst[j] = b[j];
    }
}

// edge_find's test of one row of tile + 1 (r, offsets + 1) for voxels
// z0 .. z0 + 3, z0 = 4 c - 1: the 3x3 neighbour rows' least (unsigned:
// vacuum above all) and greatest (vacuum below all) label at z0 - 1 ..
// z0 + 4, two vector loads a row, then 3-wide along z.  An edge: not
// vacuum, no maximum, the box's least and greatest differ.
constexpr int kFindChunks = (kRowLen + 3) / 4;

__device__ __forceinline__ void find_chunk(const int* __restrict__ lab,
                                           const u64* mx, u64* ed, int r,
                                           int c, int vz) {
    const int hx = r / kH1Y, hy = r % kH1Y;
    const int z0 = 4 * c - 1;
    unsigned lo[6];
    int hi[6], own[4];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        lo[k] = UINT_MAX;
        hi[k] = -1;
    }
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
            const int* row = lab + ((hx + dx) * kH2Y + hy + dy) *
                                       kLabStride + 4 * c + 2;
            const int2 a = *reinterpret_cast<const int2*>(row);
            const int4 b = *reinterpret_cast<const int4*>(row + 2);
            const int v[6] = {a.x, a.y, b.x, b.y, b.z, b.w};
#pragma unroll
            for (int k = 0; k < 6; ++k) {
                lo[k] = min(lo[k], static_cast<unsigned>(v[k]));
                hi[k] = max(hi[k], v[k]);
            }
            if (dx == 1 && dy == 1) {
#pragma unroll
                for (int j = 0; j < 4; ++j) own[j] = v[j + 1];
            }
        }
    const unsigned peaks = static_cast<unsigned>(mx[r] >> (z0 + 2));
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const unsigned l = min(min(lo[j], lo[j + 1]), lo[j + 2]);
        const int h = max(max(hi[j], hi[j + 1]), hi[j + 2]);
        if (z0 + j <= vz && own[j] != -1 && !((peaks >> j) & 1u) &&
            static_cast<int>(l) != h)
            bits |= 1u << j;
    }
    if (bits) atomicOr(&ed[r], static_cast<u64>(bits) << (z0 + 2));
}

// In the order of _edge_find_xla: an edge is a non-vacuum voxel, no
// maximum, with another non-vacuum label in its box (-2); a voxel beside
// an edge is -1; the rest 2, or 0 if vacuum.  Only the rows of tile + 1
// whose 3x3 neighbour rows (over z in [-2, vz + 2)) hold two non-vacuum
// labels can hold an edge; they are listed, and a tile with none skips
// is_max and the test.
__global__ void __launch_bounds__(kCheckThreads)
edge_find_kernel(const int* __restrict__ labels,
                 const signed char* __restrict__ is_max,
                 signed char* __restrict__ out, int nx, int ny, int nz,
                 int vec_bytes, int vec_labels) {
    __shared__ __align__(16) int lab[kRows2 * kLabStride];
    __shared__ u64 mx[kRows1];  // is_max, tile + 1
    __shared__ u64 ed[kRows1];  // edges, tile + 1
    __shared__ int lo[kRows2], hi[kRows2];  // a row's non-vacuum labels
    __shared__ int mixed[kRows1 + 1];       // rows of tile + 1 to test
    __shared__ int n_mixed;
    __shared__ Tile t;

    const int tid = threadIdx.x;
    init_tile(t, nx, ny, nz);
    for (int i = tid; i < kRows1; i += kCheckThreads) {
        mx[i] = 0;
        ed[i] = 0;
    }
    if (tid == 0) n_mixed = 0;
    __syncthreads();
    const bool vb = vec_bytes != 0;
    stage_labels(labels, t, vec_labels != 0, ny, nz, lab);
    __syncthreads();
    if (tid < kRows2) {
        // the least and greatest non-vacuum label of the row's z offsets
        // -2 .. vz + 1, at lab indices 2 .. vz + 5
        int l0 = INT_MAX, h0 = -1;
        const int4* row = reinterpret_cast<const int4*>(lab + tid * kLabStride);
#pragma unroll
        for (int q = 0; q < kLabStride / 4; ++q) {
            const int4 v = row[q];
            const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int i = 4 * q + j;
                if (i >= 2 && i <= t.vz + 5 && e[j] != -1) {
                    l0 = min(l0, e[j]);
                    h0 = max(h0, e[j]);
                }
            }
        }
        lo[tid] = l0;
        hi[tid] = h0;
    }
    __syncthreads();
    if (tid < kRows1) {
        const int hx = tid / kH1Y, hy = tid % kH1Y;  // offsets + 1
        int l9 = INT_MAX, h9 = -1;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
                l9 = min(l9, lo[(hx + dx) * kH2Y + hy + dy]);
                h9 = max(h9, hi[(hx + dx) * kH2Y + hy + dy]);
            }
        if (hx < t.vx + 2 && hy < t.vy + 2 && l9 < h9)
            mixed[atomicAdd(&n_mixed, 1)] = tid;
    }
    __syncthreads();
    const int n_test = n_mixed * kFindChunks;
    if (n_test > 0) {
        stage_bits<1, false>(is_max, t, vb, ny, nz, mx, nullptr);
        __syncthreads();
        for (int i = tid; i < n_test; i += kCheckThreads)
            find_chunk(lab, mx, ed, mixed[i / kFindChunks],
                       i % kFindChunks, t.vz);
        __syncthreads();
    }
    // interior rows in 16-byte halves
    if (tid < kRowsIn * 2) {
        const int r = tid >> 1, c = tid & 1;
        const int ix = r / kTY, iy = r % kTY;
        if (ix < t.vx && iy < t.vy) {
            unsigned near = 0, self = 0;
            if (n_test > 0) {
                near = static_cast<unsigned>(box_word(ed, ix, iy) >>
                                             (2 + 16 * c));
                self = static_cast<unsigned>(
                    ed[(ix + 1) * kH1Y + iy + 1] >> (2 + 16 * c));
            }
            const int* own =
                lab + ((ix + 2) * kH2Y + iy + 2) * kLabStride + 4 + 16 * c;
            union {
                uint4 v;
                signed char b[16];
            } u;
#pragma unroll
            for (int j = 0; j < 16; ++j)
                u.b[j] = (self >> j) & 1u   ? -2
                         : (near >> j) & 1u ? -1
                         : own[j] != -1     ? 2
                                            : 0;
            store_half(
                out + ((t.x0 + ix) * ny + t.y0 + iy) * nz + t.z0 + 16 * c,
                u.v, vb, c, t);
        }
    }
}

// In the order of _edge_check_xla: candidates are the non-vacuum voxels of
// a changed edge's 27-neighbourhood (known == -2); a candidate that is no
// edge becomes -1, one that is an edge and no maximum -2 (a new edge); then
// every voxel still >= 0 beside a new edge becomes -1.
__global__ void __launch_bounds__(kCheckThreads)
edge_check_kernel(const signed char* __restrict__ known,
                  const int* __restrict__ labels,
                  const signed char* __restrict__ is_max,
                  signed char* __restrict__ out, int nx, int ny, int nz,
                  int vec_bytes, int vec_labels) {
    __shared__ __align__(16) int lab[kRows2 * kLabStride];
    __shared__ __align__(16) signed char o[kRowsIn * kTZ];
    __shared__ u64 k2[kRows2];     // known == -2, tile + 2
    __shared__ u64 cand[kRows1];   // candidates (before the vacuum test)
    __shared__ u64 mx[kRows1];     // is_max, tile + 1
    __shared__ u64 ne[kRows1];     // new edges, tile + 1
    __shared__ Tile t;

    const int tid = threadIdx.x;
    init_tile(t, nx, ny, nz);
    for (int i = tid; i < kRows2; i += kCheckThreads) k2[i] = 0;
    for (int i = tid; i < kRows1; i += kCheckThreads) {
        mx[i] = 0;
        ne[i] = 0;
    }
    __syncthreads();
    const bool vb = vec_bytes != 0;
    const bool active = __syncthreads_or(
        stage_bits<2, true>(known, t, vb, ny, nz, k2, o));
    if (active) {
        stage_labels(labels, t, vec_labels != 0, ny, nz, lab);
        stage_bits<1, false>(is_max, t, vb, ny, nz, mx, nullptr);
        if (tid < kRows1) {
            const int hx = tid / kH1Y, hy = tid % kH1Y;  // offsets + 1
            u64 c = 0;
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
#pragma unroll
                for (int dy = 0; dy < 3; ++dy)
                    c |= zbox(k2[(hx + dx) * kH2Y + hy + dy]);
            cand[tid] = c;
        }
        __syncthreads();
        // the tile grown by 1, 34 voxels a row, flattened over the warps:
        // a warp's 32 voxels span at most two rows
        for (int f0 = tid & ~31; f0 < kRows1 * kRowLen; f0 += kCheckThreads) {
            const int f = f0 + (tid & 31);
            const int r = f / kRowLen, zr = f % kRowLen - 1;
            const int hx = r / kH1Y - 1, hy = r % kH1Y - 1;
            bool new_edge = false;
            if (r < kRows1 && hx < t.vx + 1 && hy < t.vy + 1 &&
                zr < t.vz + 1 && ((cand[r] >> (zr + 2)) & 1)) {
                const int own =
                    lab[((hx + 2) * kH2Y + hy + 2) * kLabStride + 4 + zr];
                if (own != -1) {
                    const bool edge = differs_s(lab, hx, hy, zr);
                    const bool peak = (mx[r] >> (zr + 2)) & 1;
                    new_edge = edge && !peak;
                    if (hx >= 0 && hx < t.vx && hy >= 0 && hy < t.vy &&
                        zr >= 0 && zr < t.vz) {
                        signed char& v = o[(hx * kTY + hy) * kTZ + zr];
                        if (!edge) v = -1;
                        else if (!peak) v = -2;
                    }
                }
            }
            const unsigned b = __ballot_sync(0xffffffffu, new_edge);
            if ((tid & 31) == 0 && b) {
                // split the warp's bits between its first row and the next
                const int r0 = f0 / kRowLen, p0 = f0 % kRowLen + 1;
                const int first = kRowLen - (p0 - 1);  // lanes in row r0
                const u64 lo = first >= 32 ? b : b & ((1u << first) - 1u);
                atomicOr(&ne[r0], lo << p0);
                if (first < 32 && (b >> first))
                    atomicOr(&ne[r0 + 1], static_cast<u64>(b >> first) << 1);
            }
        }
        __syncthreads();
    }
    // interior rows in 16-byte halves: near_new, then the store
    if (tid < kRowsIn * 2) {
        const int r = tid >> 1, c = tid & 1;
        const int ix = r / kTY, iy = r % kTY;
        if (ix < t.vx && iy < t.vy) {
            const unsigned bits =
                active ? static_cast<unsigned>(box_word(ne, ix, iy) >>
                                               (2 + 16 * c))
                       : 0u;
            union {
                uint4 v;
                signed char b[16];
            } u;
            u.v = *reinterpret_cast<const uint4*>(o + r * kTZ + 16 * c);
#pragma unroll
            for (int j = 0; j < 16; ++j)
                if (((bits >> j) & 1u) && u.b[j] >= 0) u.b[j] = -1;
            store_half(
                out + ((t.x0 + ix) * ny + t.y0 + iy) * nz + t.z0 + 16 * c,
                u.v, vb, c, t);
        }
    }
}

long long tile_count(int nx, int ny, int nz) {
    return static_cast<long long>((nx + kTX - 1) / kTX) *
           ((ny + kTY - 1) / kTY) * ((nz + kTZ - 1) / kTZ);
}

bool aligned16(const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace

PB_EXPORT int pb_edge_find(void* labels, void* is_max, void* known, int nx,
                           int ny, int nz, int device, void* stream) {
    cudaSetDevice(device);
    const long long tiles = tile_count(nx, ny, nz);
    if (tiles == 0) return 0;
    // 16-byte rows: every row of the grid starts at a multiple of 16 bytes
    const int vec_bytes = nz % 16 == 0 && aligned16(is_max) &&
                          aligned16(known);
    const int vec_labels = nz % 4 == 0 && aligned16(labels);
    edge_find_kernel<<<static_cast<unsigned>(tiles), kCheckThreads, 0,
                       pb::as_stream(stream)>>>(
        static_cast<const int*>(labels),
        static_cast<const signed char*>(is_max),
        static_cast<signed char*>(known), nx, ny, nz, vec_bytes, vec_labels);
    return static_cast<int>(cudaGetLastError());
}

PB_EXPORT int pb_edge_check(void* known, void* labels, void* is_max,
                            void* out, int nx, int ny, int nz, int device,
                            void* stream) {
    cudaSetDevice(device);
    const long long tiles = tile_count(nx, ny, nz);
    if (tiles == 0) return 0;
    const int vec_bytes = nz % 16 == 0 && aligned16(known) &&
                          aligned16(is_max) && aligned16(out);
    const int vec_labels = nz % 4 == 0 && aligned16(labels);
    edge_check_kernel<<<static_cast<unsigned>(tiles), kCheckThreads, 0,
                        pb::as_stream(stream)>>>(
        static_cast<const signed char*>(known),
        static_cast<const int*>(labels),
        static_cast<const signed char*>(is_max),
        static_cast<signed char*>(out), nx, ny, nz, vec_bytes, vec_labels);
    return static_cast<int>(cudaGetLastError());
}
