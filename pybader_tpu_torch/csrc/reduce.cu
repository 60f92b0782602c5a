// Per-label reductions, label remap and the atom surface distance.
//
// Each kernel here replaces one Pallas kernel of
// pybader_tpu/ops/pallas_reduce.py.  The TPU kernels loop over every label
// inside each VMEM tile (no scatters on the TPU), which caps them at 256
// labels; on Hopper a voxel goes straight to its label's slot with an
// atomic, so these take any label count.  All four are grid-stride loops,
// bound by device memory: each reads the grid once (remap also writes it).

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
// Bound: 12 bytes read a voxel.  A block walks tiles of kItems * 256
// voxels with coalesced loads; a thread's successive voxels are 256 apart,
// almost always in the same basin, so it keeps a running (label, sum,
// count) in registers and issues one atomic per run, not per voxel.  Runs
// land in per-block shared-memory bins when k fits (one global atomic per
// bin per block at the end), else straight in the global slots.
constexpr int kItems = 16;

template <bool kShared>
__global__ void charge_volume_kernel(const double* __restrict__ rho,
                                     const int* __restrict__ labels,
                                     double* __restrict__ charge,
                                     unsigned long long* __restrict__ count,
                                     long long n, int k) {
    extern __shared__ unsigned char smem[];
    double* sum_bins = charge;
    unsigned long long* cnt_bins = count;
    if (kShared) {
        sum_bins = reinterpret_cast<double*>(smem);
        cnt_bins = reinterpret_cast<unsigned long long*>(sum_bins + k);
        for (int b = threadIdx.x; b < k; b += blockDim.x) {
            sum_bins[b] = 0.0;
            cnt_bins[b] = 0ull;
        }
        __syncthreads();
    }
    const long long tile = static_cast<long long>(blockDim.x) * kItems;
    int cur = -1;
    double acc = 0.0;
    unsigned long long cnt = 0ull;
    for (long long t0 = blockIdx.x * tile; t0 < n;
         t0 += static_cast<long long>(gridDim.x) * tile) {
        for (int j = 0; j < kItems; ++j) {
            const long long i = t0 + static_cast<long long>(j) * blockDim.x +
                                threadIdx.x;
            if (i >= n) break;
            const int l = labels[i];
            if (l != cur) {
                if (cur >= 0 && cur < k) {
                    atomicAdd(&sum_bins[cur], acc);
                    atomicAdd(&cnt_bins[cur], cnt);
                }
                cur = l;
                acc = 0.0;
                cnt = 0ull;
            }
            acc += rho[i];
            cnt += 1ull;
        }
    }
    if (cur >= 0 && cur < k) {
        atomicAdd(&sum_bins[cur], acc);
        atomicAdd(&cnt_bins[cur], cnt);
    }
    if (kShared) {
        __syncthreads();
        for (int b = threadIdx.x; b < k; b += blockDim.x) {
            if (cnt_bins[b]) {
                atomicAdd(&charge[b], sum_bins[b]);
                atomicAdd(&count[b], cnt_bins[b]);
            }
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

PB_EXPORT int pb_charge_volume(void* rho, void* labels, void* charge,
                               void* count, long long n, int k, int device,
                               void* stream) {
    cudaSetDevice(device);
    cudaStream_t s = pb::as_stream(stream);
    double* c = static_cast<double*>(charge);
    unsigned long long* v = static_cast<unsigned long long*>(count);
    zero_sums_kernel<<<small_blocks(k), pb::kThreads, 0, s>>>(c, v, k);
    const long long per_block = static_cast<long long>(pb::kThreads) * kItems;
    long long want = (n + per_block - 1) / per_block;
    const long long cap = pb::blocks_for(n, device);
    const int blocks = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
    const size_t shared = static_cast<size_t>(k) * 16;
    if (shared <= 48 * 1024) {
        charge_volume_kernel<true><<<blocks, pb::kThreads, shared, s>>>(
            static_cast<const double*>(rho), static_cast<const int*>(labels),
            c, v, n, k);
    } else {
        charge_volume_kernel<false><<<blocks, pb::kThreads, 0, s>>>(
            static_cast<const double*>(rho), static_cast<const int*>(labels),
            c, v, n, k);
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
