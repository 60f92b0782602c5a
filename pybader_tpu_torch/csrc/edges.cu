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
// edge_find is two plain passes: the first writes one flag byte a voxel,
// the second dilates those flags over the 27-neighbourhood into known.
// Bound: device memory, 6 bytes a voxel (labels and is_max read, known
// written) plus 2 of flag scratch; the neighbour reads are L1/L2 hits.
//
// edge_check is one launch over 8x8x32 tiles (z fastest), as the TPU kernel
// is one fused pass over plane groups with a 2-plane halo.  A voxel's output
// depends on known == -2 at most 2 voxels away (a candidate lies within 1 of
// a -2; a new edge within 1 of the voxel needs a -2 within 1 of itself), so
// each block stages known for its tile and a 2-voxel periodic halo, with
// the wrap resolved once per halo row.  The -2 flags become one 64-bit word
// per z-row (bit zr + 2 for z offset zr in [-2, 34)), so every 3x3x3 box-OR
// is three shifts and nine word ORs.  A tile with no -2 in its halo region
// copies known and never reads labels or is_max; an active tile stages
// labels (tile + 2) and the is_max bits (tile + 1), tests only the
// candidates for an edge (27 label reads from shared memory), and ORs the
// new-edge words into near_new for its interior.  Rows move in 16-byte
// vectors where nz and the pointers allow, scalars elsewhere.
//
// Bound: device memory.  An active tile reads known, labels and is_max and
// writes known: 7 bytes a voxel; a skipped tile reads and writes known: 2.
// The halo re-reads (2.5x the tile for labels) hit L2.
#include "common.cuh"

namespace {

struct Box {
    int idx[27];  // the 27-neighbourhood, self included, periodic
};

__device__ __forceinline__ void box_of(long long i, int nx, int ny, int nz,
                                       Box& b) {
    int x, y, z;
    pb::unflatten(i, ny, nz, x, y, z);
    int xs[3], ys[3], zs[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        xs[d] = (x + d - 1 + nx) % nx;
        ys[d] = (y + d - 1 + ny) % ny;
        zs[d] = (z + d - 1 + nz) % nz;
    }
    int k = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
            for (int e = 0; e < 3; ++e)
                b.idx[k++] = (xs[a] * ny + ys[c]) * nz + zs[e];
}

// Some non-vacuum voxel of the box carries a label other than ``own``.
__device__ __forceinline__ bool differs(const int* __restrict__ labels,
                                        const Box& b, int own) {
    bool e = false;
#pragma unroll
    for (int k = 0; k < 27; ++k) {
        const int l = labels[b.idx[k]];
        e |= (l != -1) & (l != own);
    }
    return e;
}

__device__ __forceinline__ bool any_flag(const unsigned char* __restrict__ f,
                                         const Box& b) {
    bool any = false;
#pragma unroll
    for (int k = 0; k < 27; ++k) any |= f[b.idx[k]] != 0;
    return any;
}

#define PB_GRID_LOOP(i, n)                                                   \
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +     \
                       threadIdx.x;                                          \
         i < (n); i += static_cast<long long>(gridDim.x) * blockDim.x)

// edge_find pass 1: edge flag per voxel.
__global__ void find_flags_kernel(const int* __restrict__ labels,
                                  const unsigned char* __restrict__ is_max,
                                  unsigned char* __restrict__ edge, int nx,
                                  int ny, int nz) {
    const long long n = static_cast<long long>(nx) * ny * nz;
    PB_GRID_LOOP(i, n) {
        const int own = labels[i];
        bool e = false;
        if (own != -1 && !is_max[i]) {
            Box b;
            box_of(i, nx, ny, nz, b);
            e = differs(labels, b, own);
        }
        edge[i] = e ? 1 : 0;
    }
}

// edge_find pass 2: -2 edge, -1 beside an edge, 2 other non-vacuum, 0.
__global__ void find_known_kernel(const int* __restrict__ labels,
                                  const unsigned char* __restrict__ edge,
                                  signed char* __restrict__ known, int nx,
                                  int ny, int nz) {
    const long long n = static_cast<long long>(nx) * ny * nz;
    PB_GRID_LOOP(i, n) {
        signed char out;
        if (edge[i]) {
            out = -2;
        } else {
            Box b;
            box_of(i, nx, ny, nz, b);
            out = any_flag(edge, b) ? -1 : (labels[i] != -1 ? 2 : 0);
        }
        known[i] = out;
    }
}

// ---------------------------------------------------------------- check

constexpr int kTX = 8, kTY = 8, kTZ = 32;      // tile interior
constexpr int kRowsIn = kTX * kTY;             // interior rows
constexpr int kH2Y = kTY + 4, kRows2 = (kTX + 4) * kH2Y;  // rows, tile + 2
constexpr int kH1Y = kTY + 2, kRows1 = (kTX + 2) * kH1Y;  // rows, tile + 1
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

// Some non-vacuum voxel of the 27-box around (hx, hy, zr) carries a label
// other than own.
__device__ __forceinline__ bool differs_s(const int* __restrict__ lab, int hx,
                                          int hy, int zr, int own) {
    bool e = false;
#pragma unroll
    for (int dx = 1; dx <= 3; ++dx)
#pragma unroll
        for (int dy = 1; dy <= 3; ++dy) {
            const int* row =
                lab + ((hx + dx) * kH2Y + hy + dy) * kLabStride + 3 + zr;
#pragma unroll
            for (int dz = 0; dz < 3; ++dz) {
                const int l = row[dz];
                e |= (l != -1) & (l != own);
            }
        }
    return e;
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
        constexpr int kRowLen = kTZ + 2;
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
                    const bool edge = differs_s(lab, hx, hy, zr, own);
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
            u64 near = 0;
            if (active) {
#pragma unroll
                for (int dx = 0; dx < 3; ++dx)
#pragma unroll
                    for (int dy = 0; dy < 3; ++dy)
                        near |= zbox(ne[(ix + dx) * kH1Y + iy + dy]);
            }
            const unsigned bits = static_cast<unsigned>(near >> (2 + 16 * c));
            union {
                uint4 v;
                signed char b[16];
            } u;
            u.v = *reinterpret_cast<const uint4*>(o + r * kTZ + 16 * c);
#pragma unroll
            for (int j = 0; j < 16; ++j)
                if (((bits >> j) & 1u) && u.b[j] >= 0) u.b[j] = -1;
            signed char* dst =
                out + ((t.x0 + ix) * ny + t.y0 + iy) * nz + t.z0 + 16 * c;
            if (vb && 16 * c + 16 <= t.vz) {
                *reinterpret_cast<uint4*>(dst) = u.v;
            } else {
                for (int j = 0; j < 16 && 16 * c + j < t.vz; ++j)
                    dst[j] = u.b[j];
            }
        }
    }
}

}  // namespace

PB_EXPORT int pb_edge_find(void* labels, void* is_max, void* scratch,
                           void* known, int nx, int ny, int nz, int device,
                           void* stream) {
    cudaSetDevice(device);
    const long long n = static_cast<long long>(nx) * ny * nz;
    const int blocks = pb::blocks_for(n, device);
    cudaStream_t s = pb::as_stream(stream);
    find_flags_kernel<<<blocks, pb::kThreads, 0, s>>>(
        static_cast<const int*>(labels),
        static_cast<const unsigned char*>(is_max),
        static_cast<unsigned char*>(scratch), nx, ny, nz);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    find_known_kernel<<<blocks, pb::kThreads, 0, s>>>(
        static_cast<const int*>(labels),
        static_cast<const unsigned char*>(scratch),
        static_cast<signed char*>(known), nx, ny, nz);
    return static_cast<int>(cudaGetLastError());
}

PB_EXPORT int pb_edge_check(void* known, void* labels, void* is_max,
                            void* out, int nx, int ny, int nz, int device,
                            void* stream) {
    cudaSetDevice(device);
    const long long tiles = static_cast<long long>((nx + kTX - 1) / kTX) *
                            ((ny + kTY - 1) / kTY) * ((nz + kTZ - 1) / kTZ);
    if (tiles == 0) return 0;
    auto aligned = [](const void* p) {
        return reinterpret_cast<unsigned long long>(p) % 16 == 0;
    };
    // 16-byte rows: every row of the grid starts at a multiple of 16 bytes
    const int vec_bytes =
        nz % 16 == 0 && aligned(known) && aligned(is_max) && aligned(out);
    const int vec_labels = nz % 4 == 0 && aligned(labels);
    edge_check_kernel<<<static_cast<unsigned>(tiles), kCheckThreads, 0,
                        pb::as_stream(stream)>>>(
        static_cast<const signed char*>(known),
        static_cast<const int*>(labels),
        static_cast<const signed char*>(is_max),
        static_cast<signed char*>(out), nx, ny, nz, vec_bytes, vec_labels);
    return static_cast<int>(cudaGetLastError());
}
