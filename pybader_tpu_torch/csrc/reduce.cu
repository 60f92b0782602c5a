// Per-label reductions, label remap and the atom surface distance.
//
// Each kernel here replaces one Pallas kernel of
// pybader_tpu/ops/pallas_reduce.py.  The TPU kernels loop over every label
// inside each VMEM tile (no scatters on the TPU), which caps them at 256
// labels; on Hopper a voxel (or a run of voxels of one label) goes to its
// label's slot, so these take any label count.  All four are bound by
// device memory: each reads the grid once (remap also writes it).

#include <climits>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------- min pair
// Replaces pallas_reduce.py:min_pair (_minpair_kernel), the renumber
// stage's per-label (min flat index, min flat index where mask).
// Bound: 5 bytes read a voxel, plus atomics.  Contention is the risk: a
// basin holds up to millions of voxels, all aiming at one slot.  Lanes of
// a warp with the same label elect their lowest lane (which holds the
// lowest index) with __match_any_sync, and a lane skips the atomic when the
// slot already holds a smaller index, so few atomics reach L2.
__global__ void min_pair_kernel(const int* __restrict__ labels,
                                const unsigned char* __restrict__ mask,
                                int* __restrict__ mn, int* __restrict__ mm,
                                long long n, int k) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    const int lane = threadIdx.x & 31;
    // the loop bound is uniform across the warp so every lane reaches the
    // warp intrinsics together
    for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
         base < n; base += stride) {
        const long long i = base + threadIdx.x;
        const bool in = i < n;
        const int l = in ? labels[i] : -1;
        const bool valid = in && l >= 0 && l < k;
        const bool m = valid && mask[i] != 0;
        const unsigned group = __match_any_sync(kFull, l);
        const unsigned masked = __ballot_sync(kFull, m) & group;
        if (valid && lane == __ffs(group) - 1) {
            const int idx = static_cast<int>(i);
            if (idx < mn[l]) atomicMin(&mn[l], idx);
            if (masked) {
                const int j = idx - lane + (__ffs(masked) - 1);
                if (j < mm[l]) atomicMin(&mm[l], j);
            }
        }
    }
}

__global__ void fill_int_kernel(int* __restrict__ a, int n, int value) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x)
        a[i] = value;
}

// ---------------------------------------------------------------- remap
// Replaces pallas_reduce.py:remap (_remap_kernel): labels -> table[labels],
// negatives kept, labels >= k -> 0 (the XLA remap_sweep contract).
// Bound: 8 bytes a voxel moved, 0.135 ms at 384^3 on 3.35 TB/s.  A pure
// stream, so what counts is the bytes in flight: by Little's law HBM at
// ~600 ns needs about 15 KB of loads in flight per SM, and one 4-byte load
// a thread (2,048 resident threads) keeps only 8 KB.  So a thread moves
// 16-byte vectors, kRemapUnroll loads in flight before it uses any, with
// streaming (evict-first) loads and stores; a scalar head and tail cover
// a base that is not 16-byte aligned and a ragged count.  The output has
// the input's offset within 16 bytes (the wrapper allocates it so).  A
// table of at most kRemapShared entries is staged in shared memory (the
// blob field has 62); a larger one (~2 M labels on white noise, 8 MB) is
// read through __ldg and stays in L2.  The grid is what the occupancy API
// says fits on the card at once.  A device copy of the same bytes is the
// practical floor (PERF.md).
constexpr int kRemapUnroll = 4;
constexpr int kRemapShared = 12288;  // int32 entries: 48 KB

template <bool kShared>
__device__ __forceinline__ int remap_one(int l, const int* tab,
                                         const int* __restrict__ table,
                                         int k) {
    if (l < 0) return l;
    if (l >= k) return 0;
    return kShared ? tab[l] : __ldg(&table[l]);
}

template <bool kShared>
__global__ void remap_kernel(const int* __restrict__ labels,
                             const int* __restrict__ table,
                             int* __restrict__ out, long long n, int k,
                             int head) {
    extern __shared__ int tab[];
    if (kShared) {
        for (int i = threadIdx.x; i < k; i += blockDim.x)
            tab[i] = table[i];
        __syncthreads();
    }
    const long long nvec = (n - head) >> 2;
    const int4* lv = reinterpret_cast<const int4*>(labels + head);
    int4* ov = reinterpret_cast<int4*>(out + head);
    const long long tile = static_cast<long long>(blockDim.x) * kRemapUnroll;
    for (long long t0 = blockIdx.x * tile; t0 < nvec;
         t0 += static_cast<long long>(gridDim.x) * tile) {
        int4 v[kRemapUnroll];
#pragma unroll
        for (int j = 0; j < kRemapUnroll; ++j) {
            const long long i = t0 + j * blockDim.x + threadIdx.x;
            if (i < nvec) v[j] = __ldcs(lv + i);
        }
#pragma unroll
        for (int j = 0; j < kRemapUnroll; ++j) {
            const long long i = t0 + j * blockDim.x + threadIdx.x;
            if (i < nvec)
                __stcs(ov + i,
                       make_int4(remap_one<kShared>(v[j].x, tab, table, k),
                                 remap_one<kShared>(v[j].y, tab, table, k),
                                 remap_one<kShared>(v[j].z, tab, table, k),
                                 remap_one<kShared>(v[j].w, tab, table, k)));
        }
    }
    // the head [0, head) and the tail [head + 4 nvec, n): under 8 voxels
    if (blockIdx.x == 0 && threadIdx.x < 8) {
        const int t = threadIdx.x;
        const long long i = t < head ? t : head + 4 * nvec + (t - head);
        if (i < n)
            out[i] = remap_one<kShared>(labels[i], tab, table, k);
    }
}

// -------------------------------------------------------- charge volume
// Replaces pallas_reduce.py:charge_volume (_sums_kernel): per label, the
// f64 density sum and the exact voxel count (labels < 0 or >= k skipped).
// The TPU kernel sums split hi/lo f32 halves; this sums in f64.
// Bound: 12 bytes read a voxel.  Each warp sums a contiguous span of the
// grid in chunks of 128 voxels: a lane reads 4 contiguous voxels as one
// 16-byte label vector and two 16-byte density vectors, kSumUnroll chunks
// of loads in flight before it adds any.  A run of one label then lasts a
// basin's extent along z, and the warp carries it from chunk to chunk:
// while all 128 voxels of a chunk carry the run's label (__all_sync) each
// lane adds its 4 to its own partial and nothing else happens.  A chunk
// where the label changes takes the slow path: each lane splits its 4
// voxels into runs, a segmented scan with shuffles sums the runs that
// cross lanes, and each finished run is added once, by one lane.
// Small k (the main path: 62 basins, 60 atoms): each warp owns a row of
// bins in shared memory (f64 sums, 32-bit counts), written without
// atomics (lanes of one label take turns, in lane order); each block
// writes its rows' sums to a scratch row and charge_volume_blocks_kernel
// sums the rows in block order, so the sums are the same from run to run
// (global atomics on 62 slots serialise in L2: 4x slower, PERF.md).
// Large k (a white-noise field: ~2.1 M labels): runs go straight to the
// global slots with atomics.  Two chunks in flight: more cost registers
// and resident warps, and were slower.  A scalar head aligns the labels to 16 bytes
// and a scalar tail ends them; a density whose phase differs from the
// labels' is read as scalars.
constexpr int kSumWarps = 8;
constexpr int kSumThreads = kSumWarps * 32;
constexpr int kSumUnroll = 2;     // chunks of 128 voxels in flight a warp
constexpr int kPrivateK = 512;    // 8 warp rows of 12-byte bins: 48 KB

// Where finished runs go.  add() is warp-collective: every lane calls it,
// with want set on the lanes that hold a run (label l, sum s, count c).
template <bool kPrivate>
struct Bins;

template <>
struct Bins<true> {  // this warp's row in shared memory
    double* sum;
    unsigned* cnt;
    int k;
    __device__ __forceinline__ void add(bool want, int l, double s,
                                        unsigned c) const {
        const int lane = threadIdx.x & 31;
        want = want && static_cast<unsigned>(l) < static_cast<unsigned>(k);
        unsigned pend = __ballot_sync(kFull, want);
        while (pend) {
            // the lowest pending lane of each label writes, then the next
            const bool mine = (pend >> lane) & 1u;
            const unsigned grp = __match_any_sync(kFull, mine ? l : -1 - lane);
            const bool lead = mine && __ffs(grp) - 1 == lane;
            if (lead) {
                sum[l] += s;
                cnt[l] += c;
            }
            __syncwarp();
            pend &= ~__ballot_sync(kFull, lead);
        }
    }
};

template <>
struct Bins<false> {  // the global slots
    double* sum;
    unsigned long long* cnt;
    int k;
    __device__ __forceinline__ void add(bool want, int l, double s,
                                        unsigned c) const {
        if (want && static_cast<unsigned>(l) < static_cast<unsigned>(k)) {
            atomicAdd(&sum[l], s);
            atomicAdd(&cnt[l], static_cast<unsigned long long>(c));
        }
    }
};

// One chunk of 128 voxels (this lane's 4: labels lv, densities r) into
// the warp's run (label cur, count n, sum spread over the lanes' acc).
template <class B>
__device__ __forceinline__ void sum_chunk(const int4 lv, const double (&r)[4],
                                          int& cur, double& acc,
                                          unsigned& n, const B& bins) {
    const int lane = threadIdx.x & 31;
    const int l[4] = {lv.x, lv.y, lv.z, lv.w};
    if (__all_sync(kFull, l[0] == cur && l[1] == cur && l[2] == cur &&
                              l[3] == cur)) {
        acc += (r[0] + r[1]) + (r[2] + r[3]);
        n += 128;
        return;
    }
    // this lane's runs: the tail (its last), the head (its first, if it
    // holds more than one) and up to two between them
    int tl = l[0];
    double ts = r[0];
    unsigned tc = 1;
    bool split = false;
    int hl = 0;
    double hs = 0.0;
    unsigned hc = 0;
    bool iw[2] = {false, false};
    int il[2] = {0, 0};
    double is[2] = {0.0, 0.0};
    unsigned ic[2] = {0, 0};
#pragma unroll
    for (int j = 1; j < 4; ++j) {
        if (l[j] != tl) {
            if (!split) {
                hl = tl;
                hs = ts;
                hc = tc;
                split = true;
            } else {
                iw[j - 2] = true;
                il[j - 2] = tl;
                is[j - 2] = ts;
                ic[j - 2] = tc;
            }
            tl = l[j];
            ts = r[j];
            tc = 1;
        } else {
            ts += r[j];
            ++tc;
        }
    }
    // the run before this lane's first voxel: the previous lane's tail,
    // for lane 0 the warp's run
    int prev = __shfl_up_sync(kFull, tl, 1);
    if (lane == 0) prev = cur;
    // a head that continues the previous lane's tail is added to it
    const bool join = split && hl == prev;
    const double down_s = __shfl_down_sync(kFull, join ? hs : 0.0, 1);
    const unsigned down_c = __shfl_down_sync(kFull, join ? hc : 0u, 1);
    if (lane < 31) {
        ts += down_s;
        tc += down_c;
    }
    double cs = acc;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cs += __shfl_down_sync(kFull, cs, o);
    // lane 0: the warp's run goes on in this lane's tail, or ends here
    // (with this lane's head, if that continues it)
    const bool into_tail = lane == 0 && !split && tl == cur;
    if (into_tail) {
        ts = cs + ts;
        tc = n + tc;
    }
    const bool head_to_run = lane == 0 && join;
    bins.add(lane == 0 && !into_tail && n + (head_to_run ? hc : 0u) > 0,
             cur, head_to_run ? cs + hs : cs, n + (head_to_run ? hc : 0u));
    bins.add(split && !join, hl, hs, hc);
    bins.add(iw[0], il[0], is[0], ic[0]);
    bins.add(iw[1], il[1], is[1], ic[1]);
    // segmented inclusive scan of the tails; a segment starts where a
    // lane's tail starts inside it or its label differs from the last
    const bool start = split || tl != prev;
    bool f = start;
    double ss = ts;
    unsigned sc = tc;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const double us = __shfl_up_sync(kFull, ss, d);
        const unsigned uc = __shfl_up_sync(kFull, sc, d);
        const bool uf = __shfl_up_sync(kFull, static_cast<int>(f), d) != 0;
        if (lane >= d) {
            if (!f) {
                ss = us + ss;
                sc = uc + sc;
            }
            f = f || uf;
        }
    }
    // a segment that ends before lane 31 is a finished run; lane 31's
    // goes on as the warp's run
    const bool next = __shfl_down_sync(kFull, static_cast<int>(start), 1);
    bins.add(lane < 31 && next, tl, ss, sc);
    cur = __shfl_sync(kFull, tl, 31);
    n = __shfl_sync(kFull, sc, 31);
    acc = lane == 31 ? ss : 0.0;
}

// The warp's spans: chunks [c0, c1) of 32 label vectors, vectors from
// labels + head (16-byte aligned); vectors at or past nvec read as label
// -1 (skipped).
template <bool kPrivate, bool kRhoVec>
__global__ void __launch_bounds__(kSumThreads)
charge_volume_kernel(const double* __restrict__ rho,
                     const int* __restrict__ labels,
                     double* __restrict__ charge,
                     unsigned long long* __restrict__ count,
                     double* __restrict__ part_sum,
                     unsigned* __restrict__ part_cnt, long long n, int k,
                     int head) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    Bins<kPrivate> bins;
    bins.k = k;
    if constexpr (kPrivate) {
        double* sums = reinterpret_cast<double*>(smem);
        unsigned* cnts = reinterpret_cast<unsigned*>(sums + kSumWarps * k);
        for (int b = threadIdx.x; b < kSumWarps * k; b += kSumThreads) {
            sums[b] = 0.0;
            cnts[b] = 0u;
        }
        __syncthreads();
        bins.sum = sums + warp * k;
        bins.cnt = cnts + warp * k;
    } else {
        bins.sum = charge;
        bins.cnt = count;
    }
    const long long nvec = (n - head) >> 2;
    // the scalar head [0, head) and tail [head + 4 nvec, n), in block 0's
    // first warp, one voxel at a time
    if (blockIdx.x == 0 && warp == 0) {
        for (int j = 0; j < 8; ++j) {
            const long long i = j < head ? j : head + 4 * nvec + (j - head);
            const bool want = lane == 0 && i < n;
            bins.add(want, want ? labels[i] : -1, want ? rho[i] : 0.0, 1u);
        }
    }
    const long long chunks = (nvec + 31) >> 5;
    const long long warps = static_cast<long long>(gridDim.x) * kSumWarps;
    const long long per_warp = (chunks + warps - 1) / warps;
    const long long c0 = (static_cast<long long>(blockIdx.x) * kSumWarps +
                          warp) * per_warp;
    const long long c1 = c0 + per_warp < chunks ? c0 + per_warp : chunks;
    const int4* lv = reinterpret_cast<const int4*>(labels + head);
    const double* rh = rho + head;
    int cur = -1;
    double acc = 0.0;
    unsigned run_n = 0u;
    for (long long c = c0; c < c1; c += kSumUnroll) {
        int4 v[kSumUnroll];
        double r[kSumUnroll][4];
#pragma unroll
        for (int u = 0; u < kSumUnroll; ++u) {
            const long long i = (c + u) * 32 + lane;
            if (c + u < c1 && i < nvec) {
                v[u] = __ldcs(lv + i);
                if constexpr (kRhoVec) {
                    const double2 a = __ldcs(
                        reinterpret_cast<const double2*>(rh) + 2 * i);
                    const double2 b = __ldcs(
                        reinterpret_cast<const double2*>(rh) + 2 * i + 1);
                    r[u][0] = a.x;
                    r[u][1] = a.y;
                    r[u][2] = b.x;
                    r[u][3] = b.y;
                } else {
#pragma unroll
                    for (int j = 0; j < 4; ++j) r[u][j] = __ldcs(rh + 4 * i + j);
                }
            } else {
                v[u] = make_int4(-1, -1, -1, -1);
#pragma unroll
                for (int j = 0; j < 4; ++j) r[u][j] = 0.0;
            }
        }
#pragma unroll
        for (int u = 0; u < kSumUnroll; ++u)
            sum_chunk(v[u], r[u], cur, acc, run_n, bins);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(kFull, acc, o);
    bins.add(lane == 0 && run_n > 0, cur, acc, run_n);
    if constexpr (kPrivate) {
        __syncthreads();
        const double* sums = reinterpret_cast<const double*>(smem);
        const unsigned* cnts =
            reinterpret_cast<const unsigned*>(sums + kSumWarps * k);
        for (int b = threadIdx.x; b < k; b += kSumThreads) {
            double s = 0.0;
            unsigned c = 0u;
#pragma unroll
            for (int w = 0; w < kSumWarps; ++w) {
                s += sums[w * k + b];
                c += cnts[w * k + b];
            }
            part_sum[static_cast<long long>(blockIdx.x) * k + b] = s;
            part_cnt[static_cast<long long>(blockIdx.x) * k + b] = c;
        }
    }
}

// Small k: per label (one warp each), the blocks' partial rows summed in
// block order (lanes stride the blocks, then a fixed shuffle tree).
__global__ void charge_volume_blocks_kernel(
    const double* __restrict__ part_sum, const unsigned* __restrict__ part_cnt,
    int blocks, int k, double* __restrict__ charge,
    unsigned long long* __restrict__ count) {
    const int lane = threadIdx.x & 31;
    const int warps = gridDim.x * (blockDim.x >> 5);
    for (int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); b < k;
         b += warps) {
        double s = 0.0;
        unsigned long long c = 0ull;
        for (int i = lane; i < blocks; i += 32) {
            s += part_sum[static_cast<long long>(i) * k + b];
            c += part_cnt[static_cast<long long>(i) * k + b];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            s += __shfl_xor_sync(kFull, s, o);
            c += __shfl_xor_sync(kFull, c, o);
        }
        if (lane == 0) {
            charge[b] = s;
            count[b] = c;
        }
    }
}

__global__ void zero_sums_kernel(double* __restrict__ charge,
                                 unsigned long long* __restrict__ count,
                                 int k) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < k;
         i += gridDim.x * blockDim.x) {
        charge[i] = 0.0;
        count[i] = 0ull;
    }
}

// The launch of charge_volume_kernel for (n, k) on a device: its grid (a
// warp gets kSumUnroll chunks or more; no more blocks than fit on the card
// at once), its dynamic shared memory and its scratch bytes (small k).
struct SumsLaunch {
    int blocks;
    size_t smem;
    long long scratch;
};

inline SumsLaunch sums_launch(long long n, int k, int device) {
    const bool priv = k <= kPrivateK;
    const size_t smem = priv ? static_cast<size_t>(kSumWarps) * k * 12 : 0;
    const int cap =
        priv ? pb::resident_blocks(charge_volume_kernel<true, true>,
                                   kSumThreads, smem, device)
             : pb::resident_blocks(charge_volume_kernel<false, true>,
                                   kSumThreads, 0, device);
    const long long chunks = (n / 4 + 31) / 32;
    const long long per_block = static_cast<long long>(kSumWarps) * kSumUnroll;
    long long want = (chunks + per_block - 1) / per_block;
    if (want > cap) want = cap;
    const int blocks = static_cast<int>(want < 1 ? 1 : want);
    return {blocks, smem, priv ? static_cast<long long>(blocks) * k * 12 : 0};
}

// ------------------------------------------------------ surface distance
// Replaces pallas_reduce.py:surface_min_d2 (_surface_kernel): per atom, the
// minimum squared distance from the atom to the edge voxels of its own
// volume over the 27 periodic images; +inf where it has none.  The TPU
// kernel is f32; this is f64 in the op order of
// pybader_tpu/ops/atoms.py:surface_distance_from_edges:
//     frac = (x/nx, y/ny, z/nz); pc = frac @ lattice
//     d2 = min_s |pc - (atom + shift_s)|^2
// Bound: 5 bytes read a voxel and ~250 flops per edge voxel (a few percent
// of voxels).  The minimum is an atomicMin on the bits of a non-negative
// double (their integer order is their numeric order), skipped when the
// slot already holds a smaller value.
//
// The grid may be one shard of a mesh: (lx, ly, lz) voxels at (ox, oy, oz) of
// the (nx, ny, nz) grid, whose global position x / nx the kernel uses.
__global__ void surface_min_d2_kernel(const int* __restrict__ labels,
                                      const unsigned char* __restrict__ mask,
                                      const double* __restrict__ geo,
                                      const double* __restrict__ atoms,
                                      unsigned long long* __restrict__ d2,
                                      int lx, int ly, int lz, int ox, int oy,
                                      int oz, int nx, int ny, int nz,
                                      int num_atoms) {
    // geo: 27 image shifts (x, y, z each) then the 3x3 lattice, row-major
    __shared__ double g[90];
    if (threadIdx.x < 90) g[threadIdx.x] = geo[threadIdx.x];
    __syncthreads();
    const double* lat = g + 81;
    const long long n = static_cast<long long>(lx) * ly * lz;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         i < n; i += stride) {
        if (!mask[i]) continue;
        const int l = labels[i];
        if (l < 0 || l >= num_atoms) continue;
        int x, y, z;
        pb::unflatten(i, ly, lz, x, y, z);
        x += ox;
        y += oy;
        z += oz;
        // JAX promotes its int32 / int division to float32 and XLA
        // evaluates it as a multiply by the float32 reciprocal; then the
        // quotient widens to f64.  Match that value exactly.
        const double fx = static_cast<double>(
            __fmul_rn(static_cast<float>(x), __frcp_rn(static_cast<float>(nx))));
        const double fy = static_cast<double>(
            __fmul_rn(static_cast<float>(y), __frcp_rn(static_cast<float>(ny))));
        const double fz = static_cast<double>(
            __fmul_rn(static_cast<float>(z), __frcp_rn(static_cast<float>(nz))));
        const double px = fx * lat[0] + fy * lat[3] + fz * lat[6];
        const double py = fx * lat[1] + fy * lat[4] + fz * lat[7];
        const double pz = fx * lat[2] + fy * lat[5] + fz * lat[8];
        const double ax = atoms[3 * l];
        const double ay = atoms[3 * l + 1];
        const double az = atoms[3 * l + 2];
        double best = __longlong_as_double(0x7ff0000000000000ll);  // +inf
#pragma unroll
        for (int s = 0; s < 27; ++s) {
            const double tx = px - (ax + g[3 * s]);
            const double ty = py - (ay + g[3 * s + 1]);
            const double tz = pz - (az + g[3 * s + 2]);
            const double d = tx * tx + ty * ty + tz * tz;
            best = d < best ? d : best;
        }
        const unsigned long long bits =
            static_cast<unsigned long long>(__double_as_longlong(best));
        if (bits < d2[l]) atomicMin(&d2[l], bits);
    }
}

__global__ void fill_u64_kernel(unsigned long long* __restrict__ a, int n,
                                unsigned long long value) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x)
        a[i] = value;
}

inline int small_blocks(int k) {
    int b = (k + pb::kThreads - 1) / pb::kThreads;
    return b < 1 ? 1 : (b > 1024 ? 1024 : b);
}

}  // namespace

PB_EXPORT int pb_min_pair(void* labels, void* mask, void* mn, void* mm,
                          long long n, int k, int device, void* stream) {
    cudaSetDevice(device);
    cudaStream_t s = pb::as_stream(stream);
    fill_int_kernel<<<small_blocks(k), pb::kThreads, 0, s>>>(
        static_cast<int*>(mn), k, INT_MAX);
    fill_int_kernel<<<small_blocks(k), pb::kThreads, 0, s>>>(
        static_cast<int*>(mm), k, INT_MAX);
    min_pair_kernel<<<pb::blocks_for(n, device), pb::kThreads, 0, s>>>(
        static_cast<const int*>(labels),
        static_cast<const unsigned char*>(mask), static_cast<int*>(mn),
        static_cast<int*>(mm), n, k);
    return static_cast<int>(cudaGetLastError());
}

// out must have labels' offset within 16 bytes (cudaErrorInvalidValue if
// not): both move in 16-byte vectors after the same scalar head.
PB_EXPORT int pb_remap(void* labels, void* table, void* out, long long n,
                       int k, int device, void* stream) {
    cudaSetDevice(device);
    const auto phase = [](void* p) {
        return reinterpret_cast<unsigned long long>(p) & 15ull;
    };
    if (phase(labels) != phase(out) || phase(labels) % 4 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    long long head = static_cast<long long>((16 - phase(labels)) & 15) / 4;
    if (head > n) head = n;
    const long long per_block =
        static_cast<long long>(pb::kThreads) * kRemapUnroll;
    const long long want = ((n - head) / 4 + per_block - 1) / per_block;
    const bool shared = k <= kRemapShared;
    const size_t smem = shared ? static_cast<size_t>(k) * sizeof(int) : 0;
    const int cap = shared ? pb::resident_blocks(remap_kernel<true>,
                                                 pb::kThreads, smem, device)
                           : pb::resident_blocks(remap_kernel<false>,
                                                 pb::kThreads, 0, device);
    const int blocks =
        static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
    const int* l = static_cast<const int*>(labels);
    const int* t = static_cast<const int*>(table);
    int* o = static_cast<int*>(out);
    cudaStream_t s = pb::as_stream(stream);
    if (shared)
        remap_kernel<true><<<blocks, pb::kThreads, smem, s>>>(
            l, t, o, n, k, static_cast<int>(head));
    else
        remap_kernel<false><<<blocks, pb::kThreads, 0, s>>>(
            l, t, o, n, k, static_cast<int>(head));
    return static_cast<int>(cudaGetLastError());
}

// The scratch bytes pb_charge_volume needs for (n, k), into the host
// long long *out (0 for large k).
PB_EXPORT int pb_charge_volume_scratch(long long n, int k, int device,
                                       void* out) {
    cudaSetDevice(device);
    *static_cast<long long*>(out) = k > 0 ? sums_launch(n, k, device).scratch
                                          : 0;
    return static_cast<int>(cudaGetLastError());
}

PB_EXPORT int pb_charge_volume(void* rho, void* labels, void* charge,
                               void* count, void* scratch, long long n, int k,
                               int device, void* stream) {
    cudaSetDevice(device);
    if (k <= 0) return 0;
    cudaStream_t s = pb::as_stream(stream);
    const auto addr = [](const void* p) {
        return reinterpret_cast<unsigned long long>(p);
    };
    long long head = static_cast<long long>((16 - (addr(labels) & 15)) & 15) / 4;
    if (head > n) head = n;
    const bool rho_vec = (addr(rho) + 8 * head) % 16 == 0;
    const SumsLaunch g = sums_launch(n, k, device);
    const double* r = static_cast<const double*>(rho);
    const int* l = static_cast<const int*>(labels);
    double* c = static_cast<double*>(charge);
    unsigned long long* v = static_cast<unsigned long long*>(count);
    const int h = static_cast<int>(head);
    if (k <= kPrivateK) {
        double* ps = static_cast<double*>(scratch);
        unsigned* pc = reinterpret_cast<unsigned*>(
            ps + static_cast<long long>(g.blocks) * k);
        if (rho_vec)
            charge_volume_kernel<true, true><<<g.blocks, kSumThreads, g.smem,
                                               s>>>(r, l, c, v, ps, pc, n, k,
                                                    h);
        else
            charge_volume_kernel<true, false><<<g.blocks, kSumThreads,
                                                g.smem, s>>>(r, l, c, v, ps,
                                                             pc, n, k, h);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        charge_volume_blocks_kernel<<<(k + 7) / 8, pb::kThreads, 0, s>>>(
            ps, pc, g.blocks, k, c, v);
    } else {
        zero_sums_kernel<<<small_blocks(k), pb::kThreads, 0, s>>>(c, v, k);
        if (rho_vec)
            charge_volume_kernel<false, true><<<g.blocks, kSumThreads, 0, s>>>(
                r, l, c, v, nullptr, nullptr, n, k, h);
        else
            charge_volume_kernel<false, false><<<g.blocks, kSumThreads, 0,
                                                 s>>>(r, l, c, v, nullptr,
                                                      nullptr, n, k, h);
    }
    return static_cast<int>(cudaGetLastError());
}

PB_EXPORT int pb_surface_min_d2(void* labels, void* mask, void* geo,
                                void* atoms, void* d2, int lx, int ly, int lz,
                                int ox, int oy, int oz, int nx, int ny, int nz,
                                int num_atoms, int device, void* stream) {
    cudaSetDevice(device);
    cudaStream_t s = pb::as_stream(stream);
    unsigned long long* out = static_cast<unsigned long long*>(d2);
    fill_u64_kernel<<<small_blocks(num_atoms), pb::kThreads, 0, s>>>(
        out, num_atoms, 0x7ff0000000000000ull);
    const long long n = static_cast<long long>(lx) * ly * lz;
    surface_min_d2_kernel<<<pb::blocks_for(n, device), pb::kThreads, 0, s>>>(
        static_cast<const int*>(labels),
        static_cast<const unsigned char*>(mask),
        static_cast<const double*>(geo), static_cast<const double*>(atoms),
        out, lx, ly, lz, ox, oy, oz, nx, ny, nz, num_atoms);
    return static_cast<int>(cudaGetLastError());
}
