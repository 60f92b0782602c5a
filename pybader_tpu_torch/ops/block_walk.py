"""The block phase of the quantised-row walk (the TPU's in-VMEM walker).

Port of :mod:`pybader_tpu.ops.block_walk`.  Lanes are binned to the
16x16x128-voxel block of their position and walked in rounds: each round
sorts the lanes by block, cuts them into 1024-lane tiles, gives each tile
one block, and steps every lane that sits inside its tile's block for at
most ``steps`` q-walk steps (``csrc/block_walk.cu``).  A lane that leaves
the block, or stops, freezes for the round.  Rounds repeat while they
retire lanes quickly enough; the caller's q walker then finishes every lane
with its full step budget.

Which lanes step in a round is decided by the bucket padding, the stable
sort by block, the 1024-lane tiles and each tile's median lane, and the
block steps do not count toward the walk's step cap.  So with the phase on,
the end points of capped lanes differ from the plain walk's.  The port
keeps all of these rules bit for bit; they are semantics, not TPU layout.
JAX stages each block's q-rows into VMEM as a (256, 128) table
(``build_tables``); 256 KB does not fit one H100 block's shared memory, so
the kernel reads the rows in place from device memory, where a tile's
block stays in L2, and walks the lanes of a round on persistent threads
that take the next lane as theirs freeze.

Whether the phase runs and its steps a round are the caller's arguments:
:func:`pybader_tpu_torch.pipeline.read_variants` reads them from
``PYBADER_TPU_BLOCK_WALK`` (off by default, as in JAX) and
``PYBADER_TPU_BLOCK_STEPS`` (:data:`STEPS` by default).
"""
from __future__ import annotations

import torch

from pybader_tpu_torch.ops import _cuda, neargrid

BX, BY, BZ = 16, 16, 128  # block of 32768 voxels
TILE = 1024               # lanes a tile
_MIN_LANES = 1 << 17      # below this JAX's global drain tail wins
STEPS = 24                # in-kernel steps a round (JAX's default)


def conforms(shape) -> bool:
    nx, ny, nz = shape
    return nx % BX == 0 and ny % BY == 0 and nz % BZ == 0


def enabled(shape, n_lanes: int, on: bool) -> bool:
    """True where JAX's ``walk_drain`` runs the block phase on q-rows:
    the phase ``on`` (``PYBADER_TPU_BLOCK_WALK=1``), whole blocks, at
    least 2^17 lanes."""
    return on and conforms(shape) and n_lanes >= _MIN_LANES


def prep_round(state, shape):
    """JAX's ``_prep_round``: sort lanes by block and pick tile blocks.

    A lane's key is the flat index of its block, ``nblocks`` once done;
    the sort is stable.  A tile takes its median lane's block, or its
    first lane's when the median is done; a tile whose first lane is done
    holds only done lanes and is not live.  returns (order, tile blocks
    int32, tile live flags)."""
    nx, ny, nz = shape
    nby, nbz = ny // BY, nz // BZ
    nblocks = (nx // BX) * nby * nbz
    pos = state[0].long()
    x = pos // (ny * nz)
    y = (pos // nz) % ny
    z = pos % nz
    key = (x // BX) * (nby * nbz) + (y // BY) * nbz + z // BZ
    key = torch.where(state[4], nblocks, key)
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    firsts = key_s[::TILE]
    blk = key_s[TILE // 2::TILE]
    blk = torch.where(blk >= nblocks, firsts, blk)
    live = firsts < nblocks
    blk = torch.where(blk >= nblocks, 0, blk)
    return order, blk.to(torch.int32), live


def block_round(qrows, state, blocks, live, shape, steps: int, known=None,
                *, stop=None):
    """One round on a block-sorted state: every lane of a live tile that
    is inside its tile's block and not done takes up to ``steps`` q-walk
    steps, freezing when it stops or leaves the block; no fetch follows
    the last step.  The state has 5 fields, or 7 for the screened walk
    (:func:`neargrid.init_state`).  Returns the new state; the input is
    kept.  ``stop``: in place of ``known``, its bitmap
    (:func:`neargrid.stop_bitmap_cuda`) built once for all rounds; only
    the kernel reads it, so it takes CUDA tensors."""
    if _cuda.on_cuda(qrows) or stop is not None:
        return block_round_cuda(qrows, state, blocks, live, shape, steps,
                                known, stop=stop)
    return block_round_plain(qrows, state, blocks, live, shape, steps, known)


def block_origin(blocks, shape):
    """(ntiles, 3) corner voxel of each tile's block."""
    _, ny, nz = shape
    nby, nbz = ny // BY, nz // BZ
    b = blocks.long()
    rest = b // nbz
    return torch.stack([(rest // nby) * BX, (rest % nby) * BY,
                        (b % nbz) * BZ], 1)


def block_round_plain(qrows, state, blocks, live, shape, steps: int,
                      known=None, stats=None):
    """Plain PyTorch :func:`block_round` (``stats`` as
    :func:`neargrid.neargrid_walk_q_plain` fills it)."""
    origin = torch.where(live[:, None], block_origin(blocks, shape), -1)
    origin = origin.repeat_interleave(TILE, 0)
    return neargrid.neargrid_walk_q_plain(qrows, state, shape, steps, known,
                                          stats, origin)


def block_round_cuda(qrows, state, blocks, live, shape, steps: int,
                     known=None, *, stop=None):
    """Launch ``pb_block_walk`` (csrc/block_walk.cu) on a copy of the
    state, with ``known`` as the bitmap of
    :func:`neargrid.stop_bitmap_cuda`.  ``stop``: in place of ``known``,
    that bitmap, built by the caller once for all rounds of a walk.
    The kernel takes the lanes up to the end of the last live tile; no
    launch when no tile is live."""
    bits = neargrid.stop_bits(shape, known, stop)
    k = state[0].numel()
    ntiles = k // TILE
    if ntiles * TILE != k:
        raise ValueError(f"state: {k} lanes is not a whole number of "
                         f"{TILE}-lane tiles")
    if not conforms(shape):
        raise ValueError(f"shape {tuple(shape)} is not made of whole "
                         f"{BX}x{BY}x{BZ} blocks")
    _cuda.check(blocks, torch.int32, "blocks", (ntiles,))
    _cuda.check(live, torch.bool, "live", (ntiles,))

    out, last = neargrid.check_q_state(
        qrows, state, shape, known, lambda s: [neargrid.last_true(live)])
    if not last or not last[0]:
        return out
    screened = len(out) == 7
    nx, ny, nz = shape
    claimed = torch.zeros((1,), dtype=torch.int64, device=qrows.device)
    _cuda.call("pb_block_walk", qrows.data_ptr(),
               None if bits is None else bits.data_ptr(),
               blocks.data_ptr(), live.data_ptr(),
               *(a.data_ptr() for a in out[:5]),
               out[5].data_ptr() if screened else None,
               out[6].data_ptr() if screened else None, claimed.data_ptr(),
               last[0] * TILE, 32, nx, ny, nz, int(steps),
               qrows.device.index or 0, _cuda.stream(qrows))
    _cuda.launches["block_walk"] += 1
    return out


def block_phase(qrows, state, shape, known=None, steps: int = STEPS,
                max_rounds: int = 12, min_alive: int = 32768, stats=None):
    """JAX's ``block_phase``: rounds of :func:`block_round` while they
    retire lanes efficiently.

    Stops after ``max_rounds`` rounds, once at most ``min_alive`` lanes
    are live, or after two successive rounds that each left more than 96 %
    of the previous live count.  Nothing happens unless the lane count is a
    whole number of tiles.  Lane order is restored at the end.
    ``stats``, if a dict, gets the live count after each round appended as
    one list to ``stats['block_rounds']``.  returns the new state.
    """
    state, order = block_rounds(qrows, state, shape, known, steps,
                                max_rounds, min_alive, stats)
    return state if order is None else unsort(state, order)


def block_rounds(qrows, state, shape, known=None, steps: int = STEPS,
                 max_rounds: int = 12, min_alive: int = 32768, stats=None,
                 *, stop=None):
    """:func:`block_phase` without the last step: returns the state in
    the last round's order (the lanes not done before it come first,
    sorted by block) and that order, the lane each position holds (None
    where no round ran).  ``stop``: as :func:`block_round` takes it."""
    k0 = state[0].numel()
    if k0 == 0 or k0 % TILE:
        return state, None
    ord_total = torch.arange(k0, device=state[0].device)
    last_alive = float(k0)
    slow = 0
    alive_log = []
    for _ in range(max_rounds):
        order, blocks, live = prep_round(state, shape)
        state = tuple(a[order] for a in state)
        ord_total = ord_total[order]
        state = block_round(qrows, state, blocks, live, shape, steps, known,
                            stop=stop)
        n_alive = int((~state[4]).sum())
        alive_log.append(n_alive)
        if n_alive <= min_alive:
            break
        if n_alive > 0.96 * last_alive:
            slow += 1
            if slow >= 2:
                break
        else:
            slow = 0
        last_alive = float(max(n_alive, 1))
    if stats is not None:
        stats.setdefault("block_rounds", []).append(alive_log)
    return state, ord_total


def unsort(state, order):
    """A state of :func:`block_rounds` back in lane order."""
    out = tuple(torch.empty_like(a) for a in state)
    for o, a in zip(out, state):
        o[order] = a
    return out
