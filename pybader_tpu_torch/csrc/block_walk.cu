// The block round of the quantised-row walk.
//
// Replaces the TPU kernel pybader_tpu/ops/block_walk.py:_make_call (the
// pl.pallas_call at :299), driven by block_phase (:372) from walk_drain
// (pybader_tpu/ops/neargrid.py:1052).  The lanes arrive sorted by block and
// cut into 1024-lane tiles; each tile has one 16x16x128-voxel block and a
// live flag (ops/block_walk.py:prep_round).  One CUDA block walks one tile,
// one thread a lane: a lane of a live tile that is not done and sits inside
// the tile's block takes up to `steps` q-walk steps (qwalk.cuh), and freezes
// for the round when it stops (code 13 or known == 2) or leaves the block.
// No fetch follows the last step.  The result is the TPU kernel's state
// after the round, bit for bit.
//
// The TPU kernel stages the block's two q-row words as (256, 128) tables in
// VMEM and composes the per-lane fetch from lane shuffles and a row fold.
// The block's rows are 256 KB, more than the 227 KB of shared memory one
// H100 block may have, so here each step reads its row from device memory;
// the tiles of one block run close together in time and its rows stay in
// the 50 MB L2.  Staging the table (a two-block cluster sharing it through
// distributed shared memory) is later work.
//
// Bound: the latency of the dependent 8-byte row gathers, as the q walker,
// now mostly L2 hits.  A lane does at most `steps` gathers a round; state is
// read and written once a round (40 bytes a lane, 45 screened).

#include "common.cuh"
#include "qwalk.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kBX = 16, kBY = 16, kBZ = 128;

template <bool kScreened>
__global__ void __launch_bounds__(kTile)
block_walk_kernel(const int2* __restrict__ qrows,
                  const signed char* __restrict__ known,
                  const int* __restrict__ blocks,
                  const unsigned char* __restrict__ live,
                  int* __restrict__ pos, int* __restrict__ prev,
                  int* __restrict__ hist, float* __restrict__ dr,
                  unsigned char* __restrict__ done, float* __restrict__ err,
                  unsigned char* __restrict__ risky, int nx, int ny, int nz,
                  int steps) {
    const int tile = blockIdx.x;
    if (!live[tile]) return;
    const long long lane = static_cast<long long>(tile) * kTile + threadIdx.x;
    if (done[lane]) return;
    const int b = blocks[tile];
    const int nby = ny / kBY, nbz = nz / kBZ;
    const int rest = b / nbz;
    const int ox = (rest / nby) * kBX;
    const int oy = (rest % nby) * kBY;
    const int oz = (b % nbz) * kBZ;
    const int nyz = ny * nz;
    pb::QLane s = pb::load_lane<kScreened>(lane, pos, prev, hist, dr, err,
                                           risky);
    for (int step = 0; step < steps; ++step) {
        const int x = s.pos / nyz;
        const int rem = s.pos - x * nyz;
        const int lx = x - ox, ly = rem / nz - oy, lz = rem % nz - oz;
        if (lx < 0 || lx >= kBX || ly < 0 || ly >= kBY || lz < 0 ||
            lz >= kBZ)
            break;
        const int2 w = qrows[s.pos];
        if (pb::q_stops(w.y, known, s.pos)) {
            done[lane] = 1;
            break;
        }
        pb::q_advance<kScreened>(w.x, w.y, s, nx, ny, nz);
    }
    pb::store_lane<kScreened>(lane, s, pos, prev, hist, dr, err, risky);
}

template <bool kScreened>
void launch(long long ntiles, void* stream, void* qrows, void* known,
            void* blocks, void* live, void* pos, void* prev, void* hist,
            void* dr, void* done, void* err, void* risky, int nx, int ny,
            int nz, int steps) {
    block_walk_kernel<kScreened><<<static_cast<unsigned int>(ntiles), kTile,
                                   0, pb::as_stream(stream)>>>(
        static_cast<const int2*>(qrows),
        static_cast<const signed char*>(known),
        static_cast<const int*>(blocks),
        static_cast<const unsigned char*>(live), static_cast<int*>(pos),
        static_cast<int*>(prev), static_cast<int*>(hist),
        static_cast<float*>(dr), static_cast<unsigned char*>(done),
        static_cast<float*>(err), static_cast<unsigned char*>(risky), nx, ny,
        nz, steps);
}

}  // namespace

// One round over ntiles tiles of 1024 lanes, state updated in place; err
// and risky are null for the unscreened walk.
PB_EXPORT int pb_block_walk(void* qrows, void* known, void* blocks,
                            void* live, void* pos, void* prev, void* hist,
                            void* dr, void* done, void* err, void* risky,
                            long long ntiles, int nx, int ny, int nz,
                            int steps, int device, void* stream) {
    cudaSetDevice(device);
    if (ntiles <= 0) return static_cast<int>(cudaGetLastError());
    if (err != nullptr)
        launch<true>(ntiles, stream, qrows, known, blocks, live, pos, prev,
                     hist, dr, done, err, risky, nx, ny, nz, steps);
    else
        launch<false>(ntiles, stream, qrows, known, blocks, live, pos, prev,
                      hist, dr, done, err, risky, nx, ny, nz, steps);
    return static_cast<int>(cudaGetLastError());
}
