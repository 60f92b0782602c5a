// The block round of the quantised-row walk.
//
// Replaces the TPU kernel pybader_tpu/ops/block_walk.py:_make_call (the
// pl.pallas_call at :299), driven by block_phase (:372) from walk_drain
// (pybader_tpu/ops/neargrid.py:1052).  The lanes arrive sorted by block and
// cut into 1024-lane tiles; each tile has one 16x16x128-voxel block and a
// live flag (ops/block_walk.py:prep_round).  A lane of a live tile that is
// not done and sits inside its tile's block takes up to `steps` q-walk
// steps (qwalk.cuh), and freezes for the round when it stops (code 13 or a
// stop bit) or leaves the block.  No fetch follows the last step.  The
// result is the TPU kernel's state after the round, bit for bit.
//
// Bound: the latency of the dependent 8-byte row gathers, as the q walker;
// a round's lanes walk inside one block each, so most gathers hit the 50
// MB L2.  Per lane a round reads the state of a lane it walks and writes
// the state of a lane that moved (33 bytes, 38 screened).  The first design
// ran one thread a lane, one 1024-thread block a tile: a dead tile's block
// was launched only to return, a done lane or one outside its tile's block
// idled its thread, and a tile waited on its longest lane (up to `steps`).
// Here the lanes run on walk.cuh's persistent lanes with refill: a lane
// that does not walk takes no thread (QBlockWalk::start is false), and a
// thread whose lane froze takes the next.  A warp claims consecutive lanes,
// so it stays within one tile and one block, and the lanes in flight cover
// a window of the block order whose rows stay in L2.  The host passes the
// end of the last live tile (prep_round puts the done lanes last, so the
// live tiles come first), and the claims stop there: over all lanes a
// round spends a claim on every 32 lanes of the dead tiles, which cost
// more device time than the host's trim costs the phase (PERF.md).
//
// The TPU kernel stages the block's two q-row words as (256, 128) tables in
// VMEM.  The block's rows are 256 KB, more than the 227 KB of shared
// memory one H100 block may have; staging them would take a two-block
// cluster sharing its tables through distributed shared memory, and tie a
// CTA to one tile, where refill lets a warp move on to the next tile.
// Staging only the block's 4 KB of stop bits, a CTA a tile with refill
// inside it, measured slower than refill across tiles (PERF.md).
// Here a step reads its row from device memory (the L2) beside its stop
// bit.

#include "common.cuh"
#include "qwalk.cuh"
#include "walk.cuh"

namespace {

constexpr int kTileShift = 10;  // 1024 lanes a tile
constexpr int kBX = 16, kBY = 16, kBZ = 128;
constexpr int kThreads = 256;

// One thread's lane of a block round (walk_lanes' Walk).
template <bool kScreened>
struct QBlockWalk {
    const int2* __restrict__ qrows;
    const unsigned* __restrict__ stop;
    const int* __restrict__ blocks;
    const unsigned char* __restrict__ live;
    const int* steps_of;  // the block's table of q steps (shared memory)
    pb::QState st;
    int nx, ny, nz, nyz, nby, nbz, steps;
    pb::QLane s;
    int taken, ox, oy, oz;  // steps taken; the corner of the tile's block
    int x, y, z;            // the coordinates of s.pos

    __device__ __forceinline__ bool inside() const {
        return static_cast<unsigned>(x - ox) < static_cast<unsigned>(kBX) &&
               static_cast<unsigned>(y - oy) < static_cast<unsigned>(kBY) &&
               static_cast<unsigned>(z - oz) < static_cast<unsigned>(kBZ);
    }

    // False, storing nothing, for a lane of a dead tile, a done lane or a
    // lane outside its tile's block: its state stays as it was.
    __device__ __forceinline__ bool start(long long lane) {
        const long long tile = lane >> kTileShift;
        if (!live[tile] || st.done[lane]) return false;
        const int b = blocks[tile];
        const int rest = b / nbz;
        ox = (rest / nby) * kBX;
        oy = (rest % nby) * kBY;
        oz = (b % nbz) * kBZ;
        s = st.load<kScreened>(lane);
        pb::q_coords(s.pos, nyz, nz, x, y, z);
        taken = 0;
        return inside();
    }

    // The round's loop: after `steps` steps the lane ends without a fetch;
    // it ends unmoved where it left the block (the carried coordinates are
    // wrapped, so on an axis one block wide a lane stays inside), done
    // where it stops; otherwise it steps.
    __device__ __forceinline__ bool step(long long lane) {
        if (taken == steps) {
            st.store<kScreened>(lane, s, taken);
            return true;
        }
        int2 w;
        const bool stopped = pb::q_fetch(qrows, stop, s.pos, w);
        const bool in = inside();
        if (!in || stopped) {
            if (in) st.done[lane] = 1;
            st.store<kScreened>(lane, s, taken);
            return true;
        }
        pb::q_advance<kScreened>(w, steps_of, x, y, z, s, nx, ny, nz);
        ++taken;
        return false;
    }
};

template <bool kScreened>
__global__ void __launch_bounds__(kThreads)
block_walk_kernel(QBlockWalk<kScreened> w,
                  unsigned long long* __restrict__ next, long long k,
                  long long batch) {
    __shared__ int steps[32];
    pb::fill_q_steps(steps);
    w.steps_of = steps;
    pb::walk_lanes(w, next, k, batch);
}

template <bool kScreened>
void launch(const QBlockWalk<kScreened>& w, void* next, long long k,
            long long batch, int device, void* stream) {
    const long long want = (k + kThreads - 1) / kThreads;
    const int cap = pb::resident_blocks(block_walk_kernel<kScreened>,
                                        kThreads, 0, device);
    block_walk_kernel<kScreened><<<static_cast<unsigned int>(want < cap
                                                                 ? want
                                                                 : cap),
                                   kThreads, 0, pb::as_stream(stream)>>>(
        w, static_cast<unsigned long long*>(next), k, batch);
}

}  // namespace

// One round over the lanes [0, k) of whole 1024-lane tiles (k: the end of
// the last live tile; the lanes after it are left as they are), state
// updated in place; err and risky are null for the unscreened walk.  stop:
// the bitmap of pb_stop_bitmap, or null.  next: a zeroed 64-bit counter,
// the round's claim of lanes, batch lanes a warp's claim (a multiple of
// 32).
PB_EXPORT int pb_block_walk(void* qrows, void* stop, void* blocks,
                            void* live, void* pos, void* prev, void* hist,
                            void* dr, void* done, void* err, void* risky,
                            void* next, long long k, long long batch, int nx,
                            int ny, int nz, int steps, int device,
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
    const auto* blk = static_cast<const int*>(blocks);
    const auto* lv = static_cast<const unsigned char*>(live);
    const int nby = ny / kBY, nbz = nz / kBZ;
    if (err != nullptr)
        launch(QBlockWalk<true>{q, bits, blk, lv, nullptr, st, nx, ny, nz,
                                ny * nz, nby, nbz, steps, s0},
               next, k, batch, device, stream);
    else
        launch(QBlockWalk<false>{q, bits, blk, lv, nullptr, st, nx, ny, nz,
                                 ny * nz, nby, nbz, steps, s0},
               next, k, batch, device, stream);
    return static_cast<int>(cudaGetLastError());
}
