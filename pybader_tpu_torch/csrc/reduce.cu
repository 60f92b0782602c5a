// Per-label reductions, label remap and the atom surface distance.
//
// Each kernel here replaces one Pallas kernel of
// pybader_tpu/ops/pallas_reduce.py.  The TPU kernels loop over every label
// inside each VMEM tile (no scatters on the TPU), which caps them at 256
// labels; on Hopper a voxel (or a run of voxels of one label) goes to its
// label's slot, so these take any label count.  The first three are bound
// by device memory: each reads the grid once (remap also writes it); the
// surface distance by its FP64 work where edges are dense.

#include <climits>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------- min pair
// Replaces pallas_reduce.py:min_pair (_minpair_kernel), the renumber
// stage's per-label (min flat index, min flat index where mask).
// Bound: 5 bytes read a voxel and 8 written a label, 0.085 ms at 384^3 on
// 3.35 TB/s.  A label's first voxel starts a run of it, and its first
// masked voxel is the first masked voxel of some run, so only those fold
// into the slots.  Each warp scans a contiguous span of the labels in
// 16-byte vectors, kPairUnroll chunks of 128 voxels in flight a warp (the
// remap's Little's-law argument); a voxel whose label differs from the one
// before it (the previous lane's last label comes by shuffle), or that
// starts the span, folds its index.  The same warp then scans the mask
// over its span in 16-byte vectors, two chunks of 512 voxels in flight: a
// vector of zeros (all but 62 of the main path's 3.5 M) costs one test;
// in another, each masked voxel whose label differs from the previous
// masked voxel's in the vector folds its index (its label read back from
// L2: a skipped voxel has a smaller masked index of its label before it).
// Up to kPairShared labels the slots are a table in shared memory, folded
// into the outputs by one pre-checked atomicMin a label a block (where the
// block saw the label); above it (a white-noise field: ~2.1 M labels) the
// runs go to the outputs by pre-checked global atomics.  Labels and mask
// each have a scalar head up to 16-byte alignment and a scalar tail, so
// views at any storage offsets and ragged lengths take the vector loops.
// The grid is what the occupancy API says is resident; one fill launch sets
// both outputs to INT_MAX before it.
constexpr int kPairWarps = 8;
constexpr int kPairThreads = kPairWarps * 32;
constexpr int kPairUnroll = 4;     // label chunks of 128 voxels in flight
constexpr int kPairShared = 4096;  // labels: two 16 KB tables a block

template <bool kShared>
__global__ void __launch_bounds__(kPairThreads)
    min_pair_runs_kernel(const int* __restrict__ labels,
                         const unsigned char* __restrict__ mask,
                         int* __restrict__ mn, int* __restrict__ mm, int n,
                         int k, int lhead, int mhead) {
    extern __shared__ int table[];  // kShared: mn slots, then mm slots
    const int lane = threadIdx.x & 31;
    int* smn = kShared ? table : mn;
    int* smm = kShared ? table + k : mm;
    if (kShared) {
        for (int b = threadIdx.x; b < 2 * k; b += kPairThreads)
            table[b] = INT_MAX;
        __syncthreads();
    }
    const auto fold = [k](int* slots, int l, int idx) {
        if (static_cast<unsigned>(l) >= static_cast<unsigned>(k)) return;
        if (kShared)
            atomicMin(slots + l, idx);
        else if (idx < __ldcg(slots + l))
            atomicMin(slots + l, idx);
    };
    const int warps = gridDim.x * kPairWarps;
    const int gw = blockIdx.x * kPairWarps + (threadIdx.x >> 5);
    const int lvec = (n - lhead) >> 2;
    const int mvec = (n - mhead) >> 4;
    if (gw == 0) {
        // the scalar heads and tails: labels [0, lhead) and
        // [lhead + 4 lvec, n), under 8 voxels, each folded; mask [0, mhead)
        // and [mhead + 16 mvec, n), under 32 voxels
        int i = lane < lhead ? lane : lhead + 4 * lvec + (lane - lhead);
        if (lane < 8 && i < n) fold(smn, labels[i], i);
        i = lane < mhead ? lane : mhead + 16 * mvec + (lane - mhead);
        if (i < n && mask[i]) fold(smm, labels[i], i);
    }
    // labels: chunks [c0, c1) of 32 vectors from labels + lhead; a vector
    // past the end reads as label -1 (skipped)
    const int4* lv = reinterpret_cast<const int4*>(labels + lhead);
    const int chunks = (lvec + 31) >> 5;
    const int per_warp = (chunks + warps - 1) / warps;
    const int c0 = gw * per_warp;
    const int c1 = min(c0 + per_warp, chunks);
    int cur = 0;  // the label before the chunk, once past the span's start
    for (int c = c0; c < c1; c += kPairUnroll) {
        int4 v[kPairUnroll];
#pragma unroll
        for (int u = 0; u < kPairUnroll; ++u) {
            const int i = (c + u) * 32 + lane;
            v[u] = c + u < c1 && i < lvec ? __ldcs(lv + i)
                                          : make_int4(-1, -1, -1, -1);
        }
#pragma unroll
        for (int u = 0; u < kPairUnroll; ++u) {
            if (c + u >= c1) break;
            const int4 x = v[u];
            int prev = __shfl_up_sync(kFull, x.w, 1);
            if (lane == 0) prev = cur;
            const int i = lhead + 4 * ((c + u) * 32 + lane);
            if (x.x != prev || (lane == 0 && c + u == c0)) fold(smn, x.x, i);
            if (x.y != x.x) fold(smn, x.y, i + 1);
            if (x.z != x.y) fold(smn, x.z, i + 2);
            if (x.w != x.z) fold(smn, x.w, i + 3);
            cur = __shfl_sync(kFull, x.w, 31);
        }
    }
    // mask: chunks [m0, m1) of 32 vectors from mask + mhead
    const uint4* mv = reinterpret_cast<const uint4*>(mask + mhead);
    const int mchunks = (mvec + 31) >> 5;
    const int per_warp_m = (mchunks + warps - 1) / warps;
    const int m0 = gw * per_warp_m;
    const int m1 = min(m0 + per_warp_m, mchunks);
    for (int c = m0; c < m1; c += 2) {
        uint4 w[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int i = (c + u) * 32 + lane;
            w[u] = c + u < m1 && i < mvec ? __ldcs(mv + i)
                                          : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            if ((w[u].x | w[u].y | w[u].z | w[u].w) == 0u) continue;
            unsigned bits = pb::byte_mask16<false>(w[u]);
            const int j0 = mhead + 16 * ((c + u) * 32 + lane);
            int last = 0;
            bool any = false;
            while (bits) {
                const int j = j0 + __ffs(bits) - 1;
                bits &= bits - 1;
                const int l = __ldg(labels + j);
                if (!any || l != last) fold(smm, l, j);
                last = l;
                any = true;
            }
        }
    }
    if (kShared) {
        __syncthreads();
        for (int b = threadIdx.x; b < k; b += kPairThreads) {
            const int a = smn[b], m = smm[b];
            if (a < __ldcg(mn + b)) atomicMin(mn + b, a);
            if (m < __ldcg(mm + b)) atomicMin(mm + b, m);
        }
    }
}

__global__ void fill_pair_kernel(int* __restrict__ mn, int* __restrict__ mm,
                                 int k) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < k;
         i += gridDim.x * blockDim.x) {
        mn[i] = INT_MAX;
        mm[i] = INT_MAX;
    }
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
// The grid may be one shard of a mesh: (lx, ly, lz) voxels at (ox, oy, oz)
// of the (nx, ny, nz) grid, whose global position x / nx the kernel uses.
//
// Bound: the function reads one mask byte a voxel and the label sectors
// that hold an edge voxel, and does 15 + 27 x 8 FP64 operations an edge
// voxel (its position, then 3 differences, 3 squares and 2 sums an image):
// 12.5 % of the voxels of the surface stage's input at 384^3, nearly all
// on white noise.  Edge voxels come in runs that cross nearly every warp,
// so a warp gathers them before it does their FP64 work with all lanes.
//
// Design: every warp works on its own, with no block barrier until the
// end.  A persistent block's warps stride over spans of kWarpSpan voxels;
// a lane reads 16 mask bytes as one 16-byte vector (the next span's
// vector in flight while it scans the current one), issues its label
// loads under the mask before it uses any, and a warp with no mask byte
// set goes on.  The edge voxels whose label l is in [0, num_atoms) go to
// the warp's queue in shared memory (offsets from a shuffle scan of the
// lanes' counts).  Whenever the queue holds 32 voxels, the warp evaluates
// 32 at once, all lanes live: 32-bit coordinates, the label read again
// (an L1 or L2 hit), and the images atom + shift_s added in registers
// (the plain version's single addition, so the same values).  So the FP64
// work of some warps overlaps the loads of others.  Each lane folds its
// minimum into the block's minimum of its atom in shared memory by a
// 64-bit atomicMin, skipped when the slot already holds a smaller value
// (once an atom's minimum has settled, nearly always), and the block adds
// one global atomicMin an atom.  Minima go through the bits of the
// non-negative doubles, whose integer order is their numeric order.
constexpr int kSurfThreads = 512;
constexpr int kSurfWarps = kSurfThreads / 32;
constexpr int kWarpSpan = 32 * 16;                 // voxels a warp-step
constexpr int kWarpQueue = 32 + kWarpSpan;         // never overflows
constexpr int kMinSlots = 2048;   // atoms with a block minimum in shared
                                  // memory; the rest go to global atomics
constexpr unsigned long long kInfBits = 0x7ff0000000000000ull;

// The 27 image shifts (x, y, z each) then the 3x3 lattice, row-major,
// passed by value: a kernel parameter sits in the constant bank, which an
// FP64 instruction reads as its operand.
struct Geometry {
    double g[90];
};

inline size_t surface_smem(int num_atoms) {
    const int slots = num_atoms < kMinSlots ? num_atoms : kMinSlots;
    return static_cast<size_t>(slots) * 8 +
           static_cast<size_t>(kSurfWarps) * kWarpQueue * 4;
}

__global__ void __launch_bounds__(kSurfThreads)
    surface_min_d2_kernel(const int* __restrict__ labels,
                          const unsigned char* __restrict__ mask,
                          const Geometry geo,
                          const double* __restrict__ atoms,
                          unsigned long long* __restrict__ d2, int lx, int ly,
                          int lz, int ox, int oy, int oz, int nx, int ny,
                          int nz, int num_atoms) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int slots = min(num_atoms, kMinSlots);
    unsigned long long* bmin = reinterpret_cast<unsigned long long*>(smem);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int* queue = reinterpret_cast<int*>(bmin + slots) + warp * kWarpQueue;
    for (int a = tid; a < slots; a += kSurfThreads) bmin[a] = kInfBits;
    __syncthreads();
    const float rx = __frcp_rn(static_cast<float>(nx));
    const float ry = __frcp_rn(static_cast<float>(ny));
    const float rz = __frcp_rn(static_cast<float>(nz));
    const int plane = ly * lz;

    // Evaluate the warp's queue entries [base, base + live_count), fold
    // the minima.
    const auto evaluate = [&](int base, int live_count) {
        const bool live = lane < live_count;
        int l = -1;
        double best = __longlong_as_double(kInfBits);
        if (live) {
            const int i = queue[base + lane];
            l = __ldg(labels + i);
            const int x = i / plane, r = i - x * plane;
            const int y = r / lz, z = r - y * lz;
            // JAX promotes its int32 / int division to float32 and XLA
            // evaluates it as a multiply by the float32 reciprocal; then
            // the quotient widens to f64.  Match that value.
            const double fx = static_cast<double>(
                __fmul_rn(static_cast<float>(x + ox), rx));
            const double fy = static_cast<double>(
                __fmul_rn(static_cast<float>(y + oy), ry));
            const double fz = static_cast<double>(
                __fmul_rn(static_cast<float>(z + oz), rz));
            const double px = fx * geo.g[81] + fy * geo.g[84] +
                              fz * geo.g[87];
            const double py = fx * geo.g[82] + fy * geo.g[85] +
                              fz * geo.g[88];
            const double pz = fx * geo.g[83] + fy * geo.g[86] +
                              fz * geo.g[89];
            const double ax = atoms[3 * l];
            const double ay = atoms[3 * l + 1];
            const double az = atoms[3 * l + 2];
#pragma unroll
            for (int s = 0; s < 27; ++s) {
                const double tx = px - (ax + geo.g[3 * s]);
                const double ty = py - (ay + geo.g[3 * s + 1]);
                const double tz = pz - (az + geo.g[3 * s + 2]);
                const double d = tx * tx + ty * ty + tz * tz;
                best = d < best ? d : best;
            }
        }
        __syncwarp();  // the entries are read: the queue may take more
        if (live) {
            const unsigned long long v =
                static_cast<unsigned long long>(__double_as_longlong(best));
            unsigned long long* slot = l < slots ? bmin + l : d2 + l;
            if (v < *slot) atomicMin(slot, v);
        }
    };

    // voxel offsets are 32-bit: the wrapper keeps grids below 2^31 voxels
    const long long n = static_cast<long long>(lx) * ly * lz;
    const bool vec = (reinterpret_cast<unsigned long long>(mask) & 15) == 0;
    const long long spans = (n + kWarpSpan - 1) / kWarpSpan;
    const long long stride = static_cast<long long>(gridDim.x) * kSurfWarps;
    // this lane's first voxel in a span, and whether its 16 mask bytes
    // come as one vector
    const auto first_of = [&](long long span) {
        return span * kWarpSpan + lane * 16;
    };
    const auto whole = [&](long long first) {
        return vec && first + 16 <= n;
    };
    long long span = static_cast<long long>(blockIdx.x) * kSurfWarps + warp;
    uint4 next = make_uint4(0u, 0u, 0u, 0u);
    if (span < spans && whole(first_of(span)))
        next = __ldcs(reinterpret_cast<const uint4*>(mask + first_of(span)));
    int queued = 0;  // the warp's queue length (the same in every lane)
    for (; span < spans; span += stride) {
        const long long first = first_of(span);
        const int i0 = static_cast<int>(first < n ? first : 0);
        const uint4 cur = next;
        const long long ahead = first_of(span + stride);
        if (span + stride < spans && whole(ahead))
            next = __ldcs(reinterpret_cast<const uint4*>(mask + ahead));
        unsigned m = 0;
        if (whole(first)) {
            m = pb::byte_mask16<false>(cur);
        } else {
            for (int j = 0; j < 16 && first + j < n; ++j)
                m |= static_cast<unsigned>(mask[i0 + j] != 0) << j;
        }
        if (!__any_sync(kFull, m != 0)) continue;
        int lab[16];  // all loads issued before any is used
#pragma unroll
        for (int j = 0; j < 16; ++j)
            lab[j] = (m >> j) & 1u ? __ldg(labels + i0 + j) : -1;
        unsigned valid = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j)
            valid |= static_cast<unsigned>(lab[j] >= 0 && lab[j] < num_atoms)
                     << j;
        const int count = __popc(valid);
        int incl = count;  // inclusive scan of the lanes' counts
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += t;
        }
        int pos = queued + incl - count;
#pragma unroll
        for (int j = 0; j < 16; ++j)
            if ((valid >> j) & 1u) queue[pos++] = i0 + j;
        queued += __shfl_sync(kFull, incl, 31);
        __syncwarp();
        for (; queued >= 32; queued -= 32) evaluate(queued - 32, 32);
    }
    if (queued > 0) evaluate(0, queued);
    __syncthreads();
    for (int a = tid; a < slots; a += kSurfThreads) {
        const unsigned long long v = bmin[a];
        if (v < d2[a]) atomicMin(&d2[a], v);
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

// labels must be 4-byte aligned (cudaErrorInvalidValue if not); n < 2^31.
PB_EXPORT int pb_min_pair(void* labels, void* mask, void* mn, void* mm,
                          long long n, int k, int device, void* stream) {
    cudaSetDevice(device);
    if (k <= 0) return 0;
    const auto addr = [](const void* p) {
        return reinterpret_cast<unsigned long long>(p);
    };
    if (addr(labels) & 3ull) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = pb::as_stream(stream);
    int* a = static_cast<int*>(mn);
    int* b = static_cast<int*>(mm);
    fill_pair_kernel<<<small_blocks(k), pb::kThreads, 0, s>>>(a, b, k);
    if (n <= 0) return static_cast<int>(cudaGetLastError());
    const int nn = static_cast<int>(n);
    int lhead = static_cast<int>((16 - (addr(labels) & 15)) & 15) / 4;
    int mhead = static_cast<int>((16 - (addr(mask) & 15)) & 15);
    if (lhead > nn) lhead = nn;
    if (mhead > nn) mhead = nn;
    const long long lchunks = ((n - lhead) / 4 + 31) / 32;
    const long long mchunks = ((n - mhead) / 16 + 31) / 32;
    const long long chunks = lchunks > mchunks ? lchunks : mchunks;
    const long long want = (chunks + kPairWarps - 1) / kPairWarps;
    const bool shared = k <= kPairShared;
    const size_t smem = shared ? 2 * static_cast<size_t>(k) * sizeof(int) : 0;
    const auto kernel = shared ? min_pair_runs_kernel<true>
                               : min_pair_runs_kernel<false>;
    const int cap = pb::resident_blocks(kernel, kPairThreads, smem, device);
    const int blocks =
        static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
    kernel<<<blocks, kPairThreads, smem, s>>>(
        static_cast<const int*>(labels),
        static_cast<const unsigned char*>(mask), a, b, nn, k, lhead, mhead);
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

// geo: the 90 doubles of Geometry in host memory.
PB_EXPORT int pb_surface_min_d2(void* labels, void* mask, void* geo,
                                void* atoms, void* d2, int lx, int ly, int lz,
                                int ox, int oy, int oz, int nx, int ny, int nz,
                                int num_atoms, int device, void* stream) {
    cudaSetDevice(device);
    cudaStream_t s = pb::as_stream(stream);
    unsigned long long* out = static_cast<unsigned long long*>(d2);
    if (num_atoms <= 0) return 0;
    Geometry g;
    for (int k = 0; k < 90; ++k) g.g[k] = static_cast<const double*>(geo)[k];
    fill_u64_kernel<<<small_blocks(num_atoms), pb::kThreads, 0, s>>>(
        out, num_atoms, kInfBits);
    const long long n = static_cast<long long>(lx) * ly * lz;
    const size_t smem = surface_smem(num_atoms);
    const auto kernel = surface_min_d2_kernel;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    const long long warps = (n + kWarpSpan - 1) / kWarpSpan;
    const long long want = (warps + kSurfWarps - 1) / kSurfWarps;
    const int cap = pb::resident_blocks(kernel, kSurfThreads, smem, device);
    const int blocks = static_cast<int>(want < cap ? want : cap);
    if (blocks < 1) return static_cast<int>(cudaGetLastError());
    kernel<<<blocks, kSurfThreads, smem, s>>>(
        static_cast<const int*>(labels),
        static_cast<const unsigned char*>(mask),
        g, static_cast<const double*>(atoms),
        out, lx, ly, lz, ox, oy, oz, nx, ny, nz, num_atoms);
    return static_cast<int>(cudaGetLastError());
}
