"""Neargrid walk rows and the trajectory walkers.

Port of :mod:`pybader_tpu.ops.neargrid`: the exact rows
(``precompute_rows``, with ``_gd_components``, ``_denom_flags`` and
``_pack_parent``) and their walk (``_walk_segment_packed`` as ``walk``
drives it; the CUDA walker reads the stop set from a bitmap,
:func:`stop_bitmap_cuda`, where JAX bakes it into the rows with
``update_stop``), and the quantised 8-byte rows (``precompute_qrows``)
with their unscreened and screened walks (``_walk_segment_q``,
``_walk_segment_qs``), the drain loop ``walk_drain`` (block phase first,
then the full step budget) and ``walk_drain_screened`` (risky lanes
walked again on exact rows).  The
drain loop's segments, compaction and pipelined counts schedule the walk
for the TPU without changing its results and are not ported; its bucket
ladder is, because the padded lane count decides the block rounds
(:mod:`pybader_tpu_torch.ops.block_walk`).

Exact rows are 32 bytes, one per voxel (``csrc/neargrid.cu``): the three
inf-normalised f64 gradient components, then an int32 ongrid parent and a
flag byte, :data:`ONGRID` (``max|gd| < 1e-14``) and :data:`MAX` (the parent
is the voxel itself: maxima and vacuum).  In torch the rows are an (N, 4)
float64 tensor whose fourth column holds the parent and the flags as the
int32 pair ``rows.view(torch.int32)[:, 6:8]``.

Quantised rows are JAX's two int32 words, bit for bit (19-bit components
``q = round(g * 262143)``, the 5-bit ongrid step code, the ongrid bit), so
JAX's own q-rows feed the port's walkers in the tests.  JAX bakes the stop
set into the sign bit; the port's walkers read it from ``known == 2``
instead, as the exact walker does, and its q-rows never carry the bit.
On the card the q walker and the block rounds read it as the bitmap of
:func:`stop_bitmap_cuda`, which :func:`walk_q` builds once for all of a
walk's launches and hands them, in place of ``known``, through the
kernels' ``stop`` keyword.

The rows are built without fused multiply-adds in JAX's accumulation order,
so the kernel and the plain version agree bit for bit.  XLA's CPU backend
fuses some of those multiply-adds, so JAX's rows can differ from the port's
by a few ulp (never in the flags or parents); :func:`rows_from_jax_rows`
converts JAX rows so that the walker can be held to JAX bit for bit.  The
q walks are f32 as in JAX, each sum and product rounded on its own.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from pybader_tpu_torch.ops import _cuda
from pybader_tpu_torch.ops.stencil import (
    gradient_plain, parent_from_step_codes,
)

ONGRID = 1  # flag: gradient ~ 0, step to the ongrid parent
MAX = 2     # flag: the ongrid parent is the voxel itself

# the packed parent word of JAX rows (pybader_tpu/ops/neargrid.py:58-61)
_JAX_ONGRID_BIT = 1 << 28
_JAX_MAX_BIT = 1 << 29
_JAX_STOP_BIT = 1 << 30
_JAX_IDX_MASK = (1 << 28) - 1


def initial_cap(shape) -> int:
    """Step cap of the initial full-trajectory pass (``walk``'s default)."""
    nx, ny, nz = shape
    return 2 * (nx + ny + nz) + 64


def refine_cap(shape) -> int:
    """Step cap of a refinement walk: ridge trajectories lengthen with
    resolution, so it grows with the largest extent above 384."""
    return 192 if max(shape) <= 384 else 96 + max(shape) // 2


# ------------------------------------------------------------------ rows
def neargrid_rows(reference: torch.Tensor, codes: torch.Tensor, t_grad,
                  strict_grad: bool) -> torch.Tensor:
    """(N, 4) float64 walk rows of an f64 density.

    ``codes``: the uint8 ascent step codes (vacuum already forced to 13),
    which give each voxel's ongrid parent.  ``t_grad``: the 3x3 gradient to
    voxel-step transform (the kernel takes it from host memory: numpy or a
    CPU tensor).  ``strict_grad``: the flatness test of the
    central difference, ``<`` (refinement) or ``<=`` (initial pass).  A
    CUDA tensor runs ``csrc/neargrid.cu``; a CPU tensor the plain version.
    """
    if _cuda.on_cuda(reference):
        return neargrid_rows_cuda(reference, codes, t_grad, strict_grad)
    return neargrid_rows_plain(reference, codes, t_grad, strict_grad)


def neargrid_rows_plain(reference, codes, t_grad, strict_grad: bool):
    """Plain PyTorch rows, in the op order of the JAX build."""
    n = reference.numel()
    gd, mg = gradient_plain(reference, t_grad, strict_grad)
    denom = torch.where(mg > 0, mg, 1.0)
    rows = torch.empty((n, 4), dtype=torch.float64, device=reference.device)
    for i in range(3):
        rows[:, i] = gd[i] / denom
    parent = parent_from_step_codes(codes).reshape(-1)
    self_idx = torch.arange(n, dtype=torch.int32, device=reference.device)
    flags = torch.where(mg < 1e-14, ONGRID, 0) \
        | torch.where(parent == self_idx, MAX, 0)
    words = rows.view(torch.int32)
    words[:, 6] = parent
    words[:, 7] = flags.to(torch.int32)
    return rows


def neargrid_rows_cuda(reference, codes, t_grad, strict_grad: bool):
    """Launch ``pb_neargrid_rows`` (csrc/neargrid.cu).  ``t_grad`` stays in
    host memory (a numpy array or a CPU tensor): the entry passes it to the
    kernel by value."""
    _cuda.check(reference, torch.float64, "reference")
    if reference.dim() != 3:
        raise ValueError(f"reference: expected a 3-D grid, got "
                         f"{tuple(reference.shape)}")
    _cuda.check(codes, torch.uint8, "codes", reference.shape)
    if torch.is_tensor(t_grad) and t_grad.device.type != "cpu":
        raise ValueError(f"t_grad: expected a host array or a CPU tensor, "
                         f"got a tensor on {t_grad.device}")
    t = torch.as_tensor(t_grad, dtype=torch.float64).contiguous()
    if t.shape != (3, 3):
        raise ValueError(f"t_grad: expected (3, 3), got {tuple(t.shape)}")
    rows = torch.empty((reference.numel(), 4), dtype=torch.float64,
                       device=reference.device)
    nx, ny, nz = reference.shape
    _cuda.call("pb_neargrid_rows", reference.data_ptr(), codes.data_ptr(),
               t.data_ptr(), rows.data_ptr(), nx, ny, nz, int(strict_grad),
               reference.device.index or 0, _cuda.stream(reference))
    _cuda.launches["neargrid_rows"] += 1
    return rows


def rows_from_jax_rows(jax_rows) -> torch.Tensor:
    """Rows in this package's format from a JAX ``precompute_rows`` array.

    ``jax_rows``: (N, 4) float64 numpy, columns 0-2 the gradient and column
    3 the packed int32 word (parent in bits 0-27, ongrid bit 28, max bit
    29).  Stop bits (``update_stop``) are refused: the port's walker takes
    the stop set as the ``known`` grid instead.
    """
    a = np.asarray(jax_rows, dtype=np.float64)
    if a.ndim != 2 or a.shape[1] != 4:
        raise ValueError(f"expected (N, 4) rows, got {a.shape}")
    packed = a[:, 3].astype(np.int64)
    if (packed & _JAX_STOP_BIT).any():
        raise ValueError("rows carry stop bits; pass the known grid instead")
    rows = torch.from_numpy(a.copy())
    words = rows.view(torch.int32)
    words[:, 6] = torch.from_numpy((packed & _JAX_IDX_MASK).astype(np.int32))
    flags = np.where(packed & _JAX_ONGRID_BIT, ONGRID, 0) \
        | np.where(packed & _JAX_MAX_BIT, MAX, 0)
    words[:, 7] = torch.from_numpy(flags.astype(np.int32))
    return rows


# ------------------------------------------------------------------ walk
def neargrid_walk(rows: torch.Tensor, starts: torch.Tensor, shape,
                  max_steps: int, known: torch.Tensor | None = None):
    """Walk one neargrid trajectory from each start voxel.

    args:
        rows: (N, 4) rows from :func:`neargrid_rows`.
        starts: (K,) int32 flat start voxels; -1 marks a padding lane,
            born done at voxel 0 (JAX's ``_init_state``).
        shape: the grid shape (nx, ny, nz).
        max_steps: the step cap; a lane still walking after it reports
            done False at its last position (callers resolve it through
            its ongrid root).
        known: optional int8 known grid; arriving at a known == 2 voxel
            ends a walk, as arriving at a maximum (MAX flag) does.
    returns:
        (pos (K,) int32 final voxels, done (K,) bool)
    """
    if _cuda.on_cuda(rows):
        return neargrid_walk_cuda(rows, starts, shape, max_steps, known)
    return neargrid_walk_plain(rows, starts, shape, max_steps, known)


def _round_away(x):
    """Round half away from zero, ``trunc(x +- 0.5)`` (not half to even)."""
    return torch.trunc(x + torch.where(x > 0, 0.5, -0.5)).long()


def neargrid_walk_plain(rows, starts, shape, max_steps: int, known=None,
                        stats=None):
    """Plain PyTorch walk: every live lane steps in lockstep, and lanes
    leave the batch as they finish.  ``stats``, if a dict, receives
    ``lane_steps`` (steps taken over all lanes), ``rows_touched``
    (distinct voxels whose row was read) and ``warp_steps``: over each
    group of 32 consecutive lanes, 32 times the group's longest walk, the
    lane-slots a one-thread-a-lane launch holds (``lane_steps /
    warp_steps`` is the share of them that step)."""
    nx, ny, nz = shape
    dev = rows.device
    dims = torch.tensor([nx, ny, nz], device=dev)
    words = rows.view(torch.int32)
    grad = rows[:, :3]
    parent = words[:, 6].long()
    flags = words[:, 7]
    stop = None if known is None else known.reshape(-1) == 2
    starts = starts.reshape(-1).long()
    out_pos = starts.clamp(min=0)
    out_done = starts < 0
    lane = torch.nonzero(~out_done).reshape(-1)
    k = lane.numel()
    pos = out_pos[lane]
    prev = torch.full((k,), -1, dtype=torch.long, device=dev)
    hist = torch.full((k, 3), -1, dtype=torch.long, device=dev)
    dr = torch.zeros((k, 3), dtype=torch.float64, device=dev)
    touched = taken = None
    lane_steps = 0
    if stats is not None:
        touched = torch.zeros(rows.shape[0], dtype=torch.bool, device=dev)
        taken = torch.zeros(starts.numel(), dtype=torch.long, device=dev)
    for step in range(max_steps + 1):
        if touched is not None:
            touched[pos] = True
        term = (flags[pos] & MAX) != 0
        if stop is not None:
            term |= stop[pos]
        if bool(term.any()):
            out_pos[lane[term]] = pos[term]
            out_done[lane[term]] = True
            if taken is not None:
                taken[lane[term]] = step
            keep = ~term
            lane, pos, prev = lane[keep], pos[keep], prev[keep]
            hist, dr = hist[keep], dr[keep]
        if step == max_steps or lane.numel() == 0:
            break
        lane_steps += lane.numel()
        xyz = torch.stack([pos // (ny * nz), (pos // nz) % ny, pos % nz], 1)
        pos, prev, hist, dr = _exact_step(
            grad[pos], parent[pos], (flags[pos] & ONGRID) != 0, xyz, pos,
            prev, hist, dr, dims, shape)
    out_pos[lane] = pos  # lanes still walking at the cap
    if stats is not None:
        taken[lane] = max_steps
        groups = -(-taken.numel() // 32)
        warps = torch.zeros(groups * 32, dtype=torch.long, device=dev)
        warps[:taken.numel()] = taken
        stats["lane_steps"] = lane_steps
        stats["rows_touched"] = int(touched.sum())
        stats["warp_steps"] = 32 * int(warps.view(groups, 32).amax(1).sum())
    return out_pos.to(torch.int32), out_done


def _exact_step(g, par, ongrid, xyz, pos, prev, hist, dr, dims, shape):
    """One exact-row step of lanes that did not stop (walk.cuh's
    ``advance``): step by round_away(g) plus the rounded remainder dr,
    wrapping on the grid ``shape`` (``dims`` as a tensor); an ongrid flag
    or a revisit of pos, prev or the history steps to the ongrid parent and
    resets dr.  Positions are int64 flat indices; returns (pos, prev, hist,
    dr) after the step."""
    _, ny, nz = shape
    int_grad = _round_away(g)
    dr_new = (dr + g) - int_grad
    int_dr = _round_away(dr_new)
    dr_after = dr_new - int_dr
    t = torch.remainder(xyz + int_grad + int_dr, dims)
    nxt = (t[:, 0] * ny + t[:, 1]) * nz + t[:, 2]
    nxt = torch.where(ongrid, par, nxt)
    revisit = (nxt == pos) | (nxt == prev) | (nxt[:, None] == hist).any(1)
    nxt = torch.where(revisit, par, nxt)
    dr = torch.where((ongrid | revisit)[:, None], 0.0, dr_after)
    return nxt, pos, torch.cat([prev[:, None], hist[:, :2]], 1), dr


def neargrid_walk_cuda(rows, starts, shape, max_steps: int, known=None):
    """Launch ``pb_neargrid_walk`` (csrc/neargrid.cu), with ``known`` as
    the bitmap of :func:`stop_bitmap_cuda` and a zeroed lane counter."""
    nx, ny, nz = shape
    n = nx * ny * nz
    _cuda.check(rows, torch.float64, "rows", (n, 4), per_voxel=4)
    _cuda.check(starts, torch.int32, "starts")
    if known is not None:
        _cuda.check(known, torch.int8, "known", shape)
    if starts.numel():
        lo, hi = torch.aminmax(starts)
        if int(lo) < -1 or int(hi) >= n:
            raise ValueError(f"starts: flat indices must lie in [-1, {n})")
    stop = None if known is None else stop_bitmap_cuda(known)
    pos = torch.empty(starts.shape, dtype=torch.int32, device=rows.device)
    done = torch.empty(starts.shape, dtype=torch.bool, device=rows.device)
    claimed = torch.zeros((1,), dtype=torch.int64, device=rows.device)
    _cuda.call("pb_neargrid_walk", rows.data_ptr(), starts.data_ptr(),
               None if stop is None else stop.data_ptr(), pos.data_ptr(),
               done.data_ptr(), claimed.data_ptr(), starts.numel(), nx, ny,
               nz, int(max_steps), rows.device.index or 0,
               _cuda.stream(rows))
    _cuda.launches["neargrid_walk"] += 1
    return pos, done


def walk_occupancy(device, shard: bool = False) -> dict:
    """What a ``pb_neargrid_walk`` launch (``shard``: a
    ``pb_neargrid_walk_shard`` launch) gets on a CUDA ``device``: resident
    blocks per SM, threads a block, SMs, registers a thread and local
    (spill) bytes a thread."""
    out = (ctypes.c_int * 5)()
    _cuda.call("pb_neargrid_walk_occupancy", int(shard),
               torch.device(device).index or 0, ctypes.addressof(out))
    return dict(zip(("blocks_per_sm", "threads", "sms", "registers",
                     "spill_bytes"), out))


# ----------------------------------------------------------- stop bitmap
def stop_bitmap(known: torch.Tensor, value: int = 2) -> torch.Tensor:
    """The stop set ``known == value`` as a bitmap: 2 for the int8 known
    grid, 1 (True) for a bool stop set.  A CUDA tensor runs
    ``csrc/neargrid.cu``."""
    if _cuda.on_cuda(known):
        return stop_bitmap_cuda(known, value)
    return stop_bitmap_plain(known, value)


def stop_bitmap_plain(known, value: int = 2):
    """The stop set ``known == value`` of the exact walk as a bitmap
    (JAX's ``update_stop`` for the CUDA walker): int32 words holding the
    bits of uint32, bit ``b`` of word ``w`` set where flat voxel ``32 w +
    b`` is ``value``; ``ceil(N / 32)`` words, the last one padded with
    0."""
    flat = (known.reshape(-1) == value).long()
    words = -(-flat.numel() // 32)
    bits = torch.zeros(words * 32, dtype=torch.long, device=known.device)
    bits[:flat.numel()] = flat
    shift = torch.arange(32, device=known.device)
    return _i32((bits.view(words, 32) << shift).sum(1))


def stop_bitmap_cuda(known, value: int = 2):
    """Launch ``pb_stop_bitmap`` (csrc/neargrid.cu): the bitmap of
    :func:`stop_bitmap_plain`, which :func:`neargrid_walk_cuda` builds
    before each walk and ``walk_sharded`` once a call for each shard's
    bool stop set (int8 or bool)."""
    if known.dtype == torch.bool:
        known = known.view(torch.int8)
    _cuda.check(known, torch.int8, "known")
    if known.data_ptr() % 16:
        known = known.clone()  # the kernel reads 16-byte vectors
    n = known.numel()
    bits = torch.empty((-(-n // 32),), dtype=torch.int32,
                       device=known.device)
    _cuda.call("pb_stop_bitmap", known.data_ptr(), bits.data_ptr(), n,
               int(value), known.device.index or 0, _cuda.stream(known))
    _cuda.launches["stop_bitmap"] += 1
    return bits


# ------------------------------------------------------------ shard walk
def shard_state(starts: torch.Tensor):
    """The walk state of lanes starting at the flat voxels ``starts``
    (none of them -1): (pos, prev, hist (K, 3), dr (K, 3) f64, steps),
    int32 but for dr."""
    k, dev = starts.numel(), starts.device
    return (starts.to(torch.int32).clone(),
            torch.full((k,), -1, dtype=torch.int32, device=dev),
            torch.full((k, 3), -1, dtype=torch.int32, device=dev),
            torch.zeros((k, 3), dtype=torch.float64, device=dev),
            torch.zeros((k,), dtype=torch.int32, device=dev))


def neargrid_walk_shard(rows: torch.Tensor, stop: torch.Tensor | None,
                        state, origin, local_shape, shape, max_steps: int):
    """Resume exact-row walks on one shard of a mesh.

    The shard is the box ``origin + [0, local_shape)`` of the grid
    ``shape`` (z whole); ``rows`` are its (lx * ly * nz, 4) rows in its own
    C order, with global parents; ``stop`` its stop set as a bitmap of
    that order (:func:`stop_bitmap` of the bool stop set, value 1) or
    None; the plain version also takes the bool grid itself.  ``state``
    (:func:`shard_state`) holds global flat positions.  A lane walks while
    it stays in the shard, as :func:`neargrid_walk` walks it on the whole
    grid, and ends with status 1 (a maximum or stop voxel), 2 (``steps ==
    max_steps``) or 0 (its position left the shard, or lies off the grid:
    the owner of the new position resumes it).  returns (new state, status
    uint8); the input state is kept.  A CUDA tensor runs
    ``csrc/neargrid.cu``.
    """
    if _cuda.on_cuda(rows):
        return neargrid_walk_shard_cuda(rows, stop, state, origin,
                                        local_shape, shape, max_steps)
    return neargrid_walk_shard_plain(rows, stop, state, origin, local_shape,
                                     shape, max_steps)


def neargrid_walk_shard_plain(rows, stop, state, origin, local_shape, shape,
                              max_steps: int, stats=None):
    """Plain PyTorch shard walk: live lanes step in lockstep (the step of
    :func:`neargrid_walk_plain`) and leave the batch as they end.
    ``stats``, if a dict, receives ``lane_steps``, ``rows_touched`` (the
    shard's distinct rows read), ``longest`` (the most steps a lane took)
    and ``warp_steps`` (as :func:`neargrid_walk_plain` counts it)."""
    nx, ny, nz = shape
    lx, ly, _ = local_shape
    ox, oy = origin
    dev = rows.device
    dims = torch.tensor([nx, ny, nz], device=dev)
    words = rows.view(torch.int32)
    grad, parent, flags = rows[:, :3], words[:, 6].long(), words[:, 7]
    if stop is not None and stop.dtype != torch.bool:  # the bitmap
        bit = torch.arange(rows.shape[0], device=dev)
        stop = ((stop.long()[bit >> 5] >> (bit & 31)) & 1).bool()
    stop = None if stop is None else stop.reshape(-1)
    out = [a.clone() for a in state]
    status = torch.zeros(out[0].shape, dtype=torch.uint8, device=dev)
    lane = torch.arange(out[0].numel(), device=dev)
    pos, prev, hist = (out[0].long(), out[1].long(), out[2].long())
    dr, steps = out[3], out[4]
    touched = torch.zeros(rows.shape[0], dtype=torch.bool, device=dev)
    lane_steps = 0

    def retire(mask, code):
        nonlocal lane, pos, prev, hist, dr, steps
        idx = lane[mask]
        for slot, a in enumerate((pos, prev, hist, dr, steps)):
            out[slot][idx] = a[mask].to(out[slot].dtype)
        status[idx] = code[mask].to(torch.uint8)
        keep = ~mask
        lane, pos, prev, hist = lane[keep], pos[keep], prev[keep], hist[keep]
        dr, steps = dr[keep], steps[keep]

    while lane.numel():
        xyz = torch.stack([pos // (ny * nz), (pos // nz) % ny, pos % nz], 1)
        x, y = xyz[:, 0] - ox, xyz[:, 1] - oy
        outside = (x < 0) | (x >= lx) | (y < 0) | (y >= ly)
        li = ((x * ly + y) * nz + xyz[:, 2]).clamp(0, rows.shape[0] - 1)
        touched[li[~outside]] = True
        end = (flags[li] & MAX) != 0
        if stop is not None:
            end |= stop[li]
        end &= ~outside
        capped = ~outside & ~end & (steps == max_steps)
        fin = outside | end | capped
        if bool(fin.any()):
            retire(fin, torch.where(outside, 0, torch.where(end, 1, 2)))
            xyz, li = xyz[~fin], li[~fin]
        if lane.numel() == 0:
            break
        pos, prev, hist, dr = _exact_step(
            grad[li], parent[li], (flags[li] & ONGRID) != 0, xyz, pos, prev,
            hist, dr, dims, shape)
        steps = steps + 1
        lane_steps += lane.numel()
    if stats is not None:
        taken = (out[4] - state[4]).long()
        groups = -(-taken.numel() // 32)
        warps = torch.zeros(groups * 32, dtype=torch.long, device=dev)
        warps[:taken.numel()] = taken
        stats["lane_steps"] = lane_steps
        stats["rows_touched"] = int(touched.sum())
        stats["longest"] = int(taken.max()) if taken.numel() else 0
        stats["warp_steps"] = 32 * int(warps.view(groups, 32).amax(1).sum())
    return tuple(out), status


def neargrid_walk_shard_cuda(rows, stop, state, origin, local_shape, shape,
                             max_steps: int):
    """Launch ``pb_neargrid_walk_shard`` (csrc/neargrid.cu): it reads the
    state and writes a new one, with a zeroed lane counter."""
    nx, ny, nz = shape
    lx, ly, lz = local_shape
    if lz != nz:
        raise ValueError(f"local_shape: z must be whole ({nz}), got {lz}")
    _cuda.check(rows, torch.float64, "rows", (lx * ly * lz, 4), per_voxel=4)
    if stop is not None:
        _cuda.check(stop, torch.int32, "stop (a bitmap)",
                    (-(-lx * ly * lz // 32),))
    k = state[0].numel()
    kinds = ((torch.int32, (k,)), (torch.int32, (k,)), (torch.int32, (k, 3)),
             (torch.float64, (k, 3)), (torch.int32, (k,)))
    for a, (dtype, shp), name in zip(state, kinds,
                                     ("pos", "prev", "hist", "dr", "steps")):
        _cuda.check(a, dtype, name, shp)
    out = tuple(torch.empty_like(a) for a in state)
    status = torch.empty((k,), dtype=torch.uint8, device=rows.device)
    claimed = torch.zeros((1,), dtype=torch.int64, device=rows.device)
    _cuda.call("pb_neargrid_walk_shard", rows.data_ptr(),
               None if stop is None else stop.data_ptr(),
               *(a.data_ptr() for a in state), *(a.data_ptr() for a in out),
               status.data_ptr(), claimed.data_ptr(), k, lx, ly,
               int(origin[0]), int(origin[1]), nx, ny, nz, int(max_steps),
               rows.device.index or 0, _cuda.stream(rows))
    _cuda.launches["neargrid_walk_shard"] += 1
    return out, status


# ------------------------------------------------------------------ q-rows
Q_SCALE = 262143.0  # 2^18 - 1: |q| <= Q_SCALE fits 19 signed bits
Q_CODE_SHIFT = 25
Q_ONGRID_BIT = 1 << 30
# the screened walk's per-decision error bound (JAX's _QS_EPS), an f32 value
QS_EPS = float(np.float32(3e-6))
_INV_SCALE = float(np.float32(1.0 / Q_SCALE))  # f32(1/262143), as in JAX


def neargrid_qrows(reference: torch.Tensor, codes: torch.Tensor, t_grad,
                   strict_grad: bool) -> torch.Tensor:
    """(N, 2) int32 quantised walk rows, JAX's ``precompute_qrows`` layout:

        word0 = q0[0:19) | q1_lo[19:32)
        word1 = q1_hi[0:6) | q2[6:25) | code[25:30) | ONGRID[30]

    with ``q_i = round(g_i * 262143)`` (half to even, as ``jnp.round``) of
    the inf-normalised gradient and ``code`` the ongrid step code (13 for
    maxima and vacuum).  Bit 31 (JAX's stop bit) stays clear.  A CUDA
    tensor runs ``csrc/neargrid.cu``; a CPU tensor the plain version.
    """
    if _cuda.on_cuda(reference):
        return neargrid_qrows_cuda(reference, codes, t_grad, strict_grad)
    return neargrid_qrows_plain(reference, codes, t_grad, strict_grad)


def _i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values holding 32-bit patterns -> int32 with those bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def neargrid_qrows_plain(reference, codes, t_grad, strict_grad: bool):
    """Plain PyTorch q-rows, in the op order of the JAX build."""
    gd, mg = gradient_plain(reference, t_grad, strict_grad)
    denom = torch.where(mg > 0, mg, 1.0)
    q = [torch.round(gd[i] / denom * Q_SCALE).long() & 0x7FFFF
         for i in range(3)]
    code = codes.reshape(-1).long()
    w0 = q[0] | ((q[1] & 0x1FFF) << 19)
    w1 = (q[1] >> 13) | (q[2] << 6) | (code << Q_CODE_SHIFT) \
        | torch.where(mg < 1e-14, Q_ONGRID_BIT, 0)
    return torch.stack([_i32(w0), w1.to(torch.int32)], 1)


def neargrid_qrows_cuda(reference, codes, t_grad, strict_grad: bool):
    """Launch ``pb_neargrid_qrows`` (csrc/neargrid.cu)."""
    _cuda.check(reference, torch.float64, "reference")
    if reference.dim() != 3:
        raise ValueError(f"reference: expected a 3-D grid, got "
                         f"{tuple(reference.shape)}")
    _cuda.check(codes, torch.uint8, "codes", reference.shape)
    t = torch.as_tensor(t_grad, dtype=torch.float64).to(
        reference.device).contiguous()
    if t.shape != (3, 3):
        raise ValueError(f"t_grad: expected (3, 3), got {tuple(t.shape)}")
    qrows = torch.empty((reference.numel(), 2), dtype=torch.int32,
                        device=reference.device)
    nx, ny, nz = reference.shape
    _cuda.call("pb_neargrid_qrows", reference.data_ptr(), codes.data_ptr(),
               t.data_ptr(), qrows.data_ptr(), nx, ny, nz, int(strict_grad),
               reference.device.index or 0, _cuda.stream(reference))
    _cuda.launches["neargrid_qrows"] += 1
    return qrows


def _sext19(v):
    return ((v & 0x7FFFF) ^ 0x40000) - 0x40000


def _q_decode(w0, w1):
    """The three signed 19-bit components of int64 q-row words."""
    return (_sext19(w0),
            _sext19(((w0 >> 19) & 0x1FFF) | ((w1 & 0x3F) << 13)),
            _sext19(w1 >> 6))


# ------------------------------------------------------------------ q walk
def init_state(starts: torch.Tensor, screened: bool = False):
    """JAX's ``_init_state`` for q walks: (pos, prev, hist (K, 3), dr
    (K, 3) f32, done), plus (err f32, risky) when ``screened``.  A -1
    start is a padding lane, born done at voxel 0."""
    starts = starts.reshape(-1)
    k, dev = starts.numel(), starts.device
    state = (starts.clamp(min=0).to(torch.int32),
             torch.full((k,), -1, dtype=torch.int32, device=dev),
             torch.full((k, 3), -1, dtype=torch.int32, device=dev),
             torch.zeros((k, 3), dtype=torch.float32, device=dev),
             starts < 0)
    if screened:
        state += (torch.zeros(k, dtype=torch.float32, device=dev),
                  torch.zeros(k, dtype=torch.bool, device=dev))
    return state


def neargrid_walk_q(qrows: torch.Tensor, state, shape, max_steps: int,
                    known: torch.Tensor | None = None, *, stop=None):
    """Resume quantised-row walks for up to ``max_steps`` steps.

    JAX's ``_walk_segment_q`` for a 5-field ``state`` (:func:`init_state`)
    and the screened ``_walk_segment_qs`` for a 7-field one: a lane stops
    on a maximum (code 13) or a ``known == 2`` voxel; otherwise it steps
    by the rounded dequantised gradient plus the rounded f32 remainder
    ``dr``, and an ongrid flag or a revisit of pos, prev or the history
    steps by the ongrid code instead and resets ``dr``.  The screened walk
    also carries ``err``, a bound on ``|dr_q - dr_exact|`` that grows by
    :data:`QS_EPS` a step, and sets ``risky`` once a rounding decision
    comes within it of its 0.5 threshold.  After the last step one more
    fetch decides ``done``.  Returns the new state; the input is kept.

    ``stop``: in place of ``known``, its bitmap (:func:`stop_bitmap_cuda`)
    that the caller built once for several walks; only the kernel reads
    it, so it takes CUDA tensors.
    """
    if _cuda.on_cuda(qrows) or stop is not None:
        return neargrid_walk_q_cuda(qrows, state, shape, max_steps, known,
                                    stop=stop)
    return neargrid_walk_q_plain(qrows, state, shape, max_steps, known)


def _round_away32(x):
    """round_away in the operand's precision: trunc(x +- 0.5)."""
    return torch.trunc(torch.where(x > 0, x + 0.5, x - 0.5))


def _q_fetch(qrows, known, pos):
    """(w0, w1 as int64, stop) of the q-rows at flat positions ``pos``."""
    w = qrows[pos].long()
    w0, w1 = w[:, 0], w[:, 1]
    stop = ((w1 >> Q_CODE_SHIFT) & 31) == 13
    if known is not None:
        stop |= known.reshape(-1)[pos] == 2
    return w0, w1, stop


def _q_step(w0, w1, pos, prev, hist, dr, shape):
    """One q-walk step of lanes that did not stop at ``pos`` (int64).

    returns (next position, dr after the step, reset, ongrid, dr_new
    before its rounding, g) -- the last three for the screen.  f32
    arithmetic, each op rounded on its own, in JAX's order."""
    nx, ny, nz = shape
    code = (w1 >> Q_CODE_SHIFT) & 31
    ongrid = (w1 & Q_ONGRID_BIT) != 0
    g = torch.stack(_q_decode(w0, w1), 1).to(torch.float32) * _INV_SCALE
    dims = torch.tensor([nx, ny, nz], device=pos.device)
    xyz = torch.stack([pos // (ny * nz), (pos // nz) % ny, pos % nz], 1)
    off = torch.stack([code // 9 - 1, (code // 3) % 3 - 1, code % 3 - 1], 1)
    t = torch.remainder(xyz + off, dims)
    og_next = (t[:, 0] * ny + t[:, 1]) * nz + t[:, 2]
    ig = _round_away32(g)
    dr_new = (dr + g) - ig
    idr = _round_away32(dr_new)
    dr_after = dr_new - idr
    t = torch.remainder(xyz + ig.long() + idr.long(), dims)
    nxt = (t[:, 0] * ny + t[:, 1]) * nz + t[:, 2]
    nxt = torch.where(ongrid, og_next, nxt)
    revisit = (nxt == pos) | (nxt == prev) | (nxt[:, None] == hist).any(1)
    nxt = torch.where(revisit, og_next, nxt)
    reset = ongrid | revisit
    dr_after = torch.where(reset[:, None], 0.0, dr_after)
    return nxt, dr_after, reset, ongrid, dr_new, g


def neargrid_walk_q_plain(qrows, state, shape, max_steps: int, known=None,
                          stats=None, origin=None):
    """Plain PyTorch :func:`neargrid_walk_q`: live lanes step in lockstep
    and leave the batch as they finish.  ``stats``, if a dict, receives
    ``lane_steps``, ``rows_touched`` and ``warp_steps`` as
    :func:`neargrid_walk_plain` counts them, ``longest`` (the most steps
    a lane took) and ``stepped`` (the lanes that took a step).

    ``origin``: optional (K, 3) int64 corner of the 16x16x128 block each
    lane may walk in, with -1 rows for lanes that must not move (the block
    round of :mod:`pybader_tpu_torch.ops.block_walk`).  A lane then stops
    for the round once it is outside its block, and no fetch follows the
    last step."""
    from pybader_tpu_torch.ops.block_walk import BX, BY, BZ

    nx, ny, nz = shape
    out = [a.clone() for a in state]
    screened = len(out) == 7
    done = out[4]
    lane = torch.nonzero(~done).reshape(-1)
    cur = [out[0][lane].long(), out[1][lane].long(), out[2][lane].long(),
           out[3][lane]]
    if screened:
        cur += [out[5][lane], out[6][lane]]
    org = None if origin is None else origin[lane]
    touched = taken = None
    if stats is not None:
        touched = torch.zeros(qrows.shape[0], dtype=torch.bool,
                              device=qrows.device)
        taken = torch.zeros(done.numel(), dtype=torch.long,
                            device=done.device)
    lane_steps = 0

    def retire(mask):
        nonlocal lane, cur, org
        idx = lane[mask]
        for j, slot in enumerate((0, 1, 2, 3, 5, 6)[:len(cur)]):
            out[slot][idx] = cur[j][mask].to(out[slot].dtype)
        keep = ~mask
        lane, cur = lane[keep], [c[keep] for c in cur]
        if org is not None:
            org = org[keep]

    for step in range(max_steps + 1):
        if org is not None:
            p = cur[0]
            loc = torch.stack([p // (ny * nz), (p // nz) % ny, p % nz],
                              1) - org
            lim = torch.tensor([BX, BY, BZ], device=p.device)
            inside = ((org[:, 0] >= 0) & (loc >= 0).all(1)
                      & (loc < lim).all(1))
            retire(~inside)
            if step == max_steps:
                break
        if touched is not None:
            touched[cur[0]] = True
        w0, w1, stop = _q_fetch(qrows, known, cur[0])
        done[lane[stop]] = True
        retire(stop)
        w0, w1 = w0[~stop], w1[~stop]
        if step == max_steps or lane.numel() == 0:
            break
        lane_steps += lane.numel()
        if taken is not None:
            taken[lane] += 1
        pos, prev, hist, dr = cur[:4]
        nxt, dr_after, reset, ongrid, dr_new, g = _q_step(
            w0, w1, pos, prev, hist, dr, shape)
        cur[:4] = [nxt, pos, torch.cat([prev[:, None], hist[:, :2]], 1),
                   dr_after]
        if screened:
            err = cur[4]
            d_g = (g.abs() - 0.5).abs().amin(1)
            d_dr = (dr_new.abs() - 0.5).abs().amin(1)
            risky_step = (d_g < QS_EPS) | (d_dr < err + QS_EPS)
            cur[5] = cur[5] | (risky_step & ~ongrid)
            cur[4] = torch.where(reset, 0.0, err + QS_EPS)
    retire(torch.ones(lane.numel(), dtype=torch.bool, device=lane.device))
    if stats is not None:
        groups = -(-taken.numel() // 32)
        warps = torch.zeros(groups * 32, dtype=torch.long,
                            device=taken.device)
        warps[:taken.numel()] = taken
        stats["lane_steps"] = lane_steps
        stats["rows_touched"] = int(touched.sum())
        stats["warp_steps"] = 32 * int(warps.view(groups, 32).amax(1).sum())
        stats["longest"] = int(taken.max()) if taken.numel() else 0
        stats["stepped"] = int((taken > 0).sum())
    return tuple(out)


def check_q_state(qrows, state, shape, known, counts=None):
    """Validate q-rows, a walk state and the optional known grid for a
    kernel.  ``counts``: a function of the state giving device scalars
    (the lanes that walk, ...), read in the one sync that checks pos's
    range.  returns the copied state, which the kernel updates in place,
    and the counts' values."""
    n = int(np.prod(shape))
    _cuda.check(qrows, torch.int32, "qrows", (n, 2), per_voxel=2)
    if len(state) not in (5, 7):
        raise ValueError(f"state: expected 5 or 7 arrays, got {len(state)}")
    k = state[0].numel()
    kinds = [(torch.int32, (k,)), (torch.int32, (k,)), (torch.int32, (k, 3)),
             (torch.float32, (k, 3)), (torch.bool, (k,)),
             (torch.float32, (k,)), (torch.bool, (k,))]
    names = ("pos", "prev", "hist", "dr", "done", "err", "risky")
    for a, (dtype, shp), name in zip(state, kinds, names):
        _cuda.check(a, dtype, name, shp)
    if known is not None:
        _cuda.check(known, torch.int8, "known", shape)
    values = []
    if k:
        lo, hi = torch.aminmax(state[0])
        lo, hi, *values = torch.stack(
            [lo.long(), hi.long(),
             *(c.long() for c in (counts(state) if counts else ()))]).tolist()
        if lo < 0 or hi >= n:
            raise ValueError(f"pos: flat indices must lie in [0, {n})")
    return tuple(a.clone() for a in state), values


def stop_bits(shape, known, stop):
    """The stop bitmap a q-walk kernel reads: ``stop`` as given (a
    bitmap of :func:`stop_bitmap_cuda`, which the caller builds afresh
    after any write to the known grid), else built from ``known``; None
    without a stop set.  One of the two, not both: the kernel would read
    only the bitmap."""
    if stop is not None:
        if known is not None:
            raise ValueError("pass known or its stop bitmap, not both")
        _cuda.check(stop, torch.int32, "stop (a bitmap)",
                    (-(-int(np.prod(shape)) // 32),))
        return stop
    if known is None:
        return None
    _cuda.check(known, torch.int8, "known", shape)
    return stop_bitmap_cuda(known)


def last_true(mask: torch.Tensor) -> torch.Tensor:
    """1 + the index of ``mask``'s last True element (0 for none), on the
    device."""
    n = mask.numel()
    if n == 0:
        return torch.zeros((), dtype=torch.long, device=mask.device)
    flip = mask.flip(0).to(torch.int32)
    return torch.where(flip.any(), n - torch.argmax(flip), 0)


def claim_batch(lanes: int, walking: int) -> int:
    """Lanes a warp of a persistent q walk claims at once: about a warp's
    worth of the lanes that walk among ``lanes``, ``32 * lanes /
    walking`` rounded down to a multiple of 32 from 32 to 1024, for lanes
    that walk spread evenly (a claim of 32 would spend an atomic on about
    one of them).  Where they crowd into a prefix, as in the block
    phase's hand-off, ``lanes`` must end at the last of them: a claim
    sized by the mean density would hand a few warps hundreds of lanes
    (PERF.md)."""
    return 32 * min(32, max(1, lanes // max(walking, 1)))


def neargrid_walk_q_cuda(qrows, state, shape, max_steps: int, known=None,
                         *, stop=None):
    """Launch ``pb_neargrid_walk_q`` (csrc/neargrid.cu) on a copy of the
    state, with ``known`` as the bitmap of :func:`stop_bitmap_cuda`.
    ``stop``: in place of ``known``, that bitmap, built by the caller once
    for several walks.  The kernel takes the lanes up to the
    last one not done; no launch when every lane is done."""
    bits = stop_bits(shape, known, stop)
    out, span = check_q_state(qrows, state, shape, known,
                              lambda s: [(~s[4]).sum(), last_true(~s[4])])
    if not span or not span[0]:
        return out
    walking, k = span
    screened = len(out) == 7
    nx, ny, nz = shape
    claimed = torch.zeros((1,), dtype=torch.int64, device=qrows.device)
    _cuda.call("pb_neargrid_walk_q", qrows.data_ptr(),
               None if bits is None else bits.data_ptr(),
               *(a.data_ptr() for a in out[:5]),
               out[5].data_ptr() if screened else None,
               out[6].data_ptr() if screened else None, claimed.data_ptr(),
               k, claim_batch(k, walking), nx, ny, nz, int(max_steps),
               qrows.device.index or 0, _cuda.stream(qrows))
    _cuda.launches["neargrid_walk_q"] += 1
    return out


# ------------------------------------------------------------ walk loops
_FINE_BUCKET_FLOOR = 1 << 22


def bucket_size(n: int, min_batch: int = 4096,
                fine_buckets: bool = True) -> int:
    """JAX's ``_bucket_size`` ladder: the smallest of 2^k and 3*2^k (and,
    from 2^22 lanes with ``fine_buckets``, which
    ``PYBADER_TPU_FINE_BUCKETS=0`` turns off, 5*2^k and 7*2^k) that holds
    ``max(n, min_batch)``.  Padded lane counts decide the block rounds, so
    the port keeps the ladder."""
    n = max(int(n), min_batch)
    bl = (n - 1).bit_length()
    p2 = 1 << bl
    cands = [p2, 3 << max(bl - 2, 0)]
    if fine_buckets and n >= _FINE_BUCKET_FLOOR:
        cands += [5 << max(bl - 3, 0), 7 << max(bl - 3, 0)]
    return min(c for c in cands if n <= c)


def pad_to(starts: torch.Tensor, size: int) -> torch.Tensor:
    """``starts`` followed by -1 padding lanes up to ``size``."""
    out = torch.full((size,), -1, dtype=torch.int32, device=starts.device)
    out[:starts.numel()] = starts
    return out


def padded_size(n: int, min_size: int = 4096) -> int:
    """The length JAX's ``pad_starts`` gives ``n`` starts: the next power
    of two, at least ``min_size``."""
    return max(min_size, 1 << (max(n, 1) - 1).bit_length())


def pad_starts(starts: torch.Tensor, min_size: int = 4096) -> torch.Tensor:
    """JAX's ``pad_starts``: -1 padding up to :func:`padded_size`."""
    return pad_to(starts, padded_size(starts.numel(), min_size))


def walk_q(qrows, starts, shape, max_steps: int, known=None,
           screened: bool = False, stats=None,
           block_steps: int | None = None):
    """JAX's ``walk_drain`` on quantised rows.

    With ``block_steps`` (None: no block phase) the block phase of that
    many steps a round runs first where :func:`block_walk.enabled` says
    so; its steps do not count, and the q walker then finishes every lane
    with the full ``max_steps`` budget.  ``starts`` is the padded start list
    (-1 lanes are born done); its length decides the block rounds.
    ``stats``, if a dict, collects the block rounds (``block_rounds``: one
    list of live-lane counts a round per walk).  returns (pos, done), and
    risky when ``screened``.
    """
    from pybader_tpu_torch.ops import block_walk

    state = init_state(starts, screened)
    stop = order = None
    if known is not None and _cuda.on_cuda(qrows):
        # the kernels' stop set, a bitmap built once for the block rounds
        # and the q walker
        known, stop = None, stop_bitmap_cuda(known)
    if block_walk.enabled(shape, starts.numel(), block_steps is not None):
        state, order = block_walk.block_rounds(qrows, state, shape, known,
                                               block_steps, stats=stats,
                                               stop=stop)
    # the lanes in the rounds' last order: those still walking come first,
    # by block (each lane walks on its own, so the order changes nothing)
    state = neargrid_walk_q(qrows, state, shape, max_steps, known, stop=stop)
    if order is not None:
        state = block_walk.unsort(state, order)
    return (state[0], state[4], state[6]) if screened else \
        (state[0], state[4])


def walk_screened(qrows, exact_rows, starts, shape, max_steps: int,
                  known=None, stats=None, block_steps: int | None = None,
                  fine_buckets: bool = True):
    """JAX's ``walk_drain_screened``: the screened q walk, then the lanes
    it could not prove exact walked again from their start on the exact
    rows with a fresh cap.

    The re-walk takes the first ``bucket_size(n_risky, 4096)`` lanes of a
    stable sort that puts the risky ones first, so some unflagged lanes are
    walked again too, as in JAX (with the block phase on, that can change a
    capped lane's end point).  ``exact_rows``: a callable giving the exact
    rows, built only when a lane is risky.  ``stats['risky']`` receives the
    risky count.  ``block_steps`` goes to :func:`walk_q`,
    ``fine_buckets`` to :func:`bucket_size`.  returns (pos, done).
    """
    pos, done, risky = walk_q(qrows, starts, shape, max_steps, known,
                              screened=True, stats=stats,
                              block_steps=block_steps)
    n_risky = int(risky.sum())
    if stats is not None:
        stats["risky"] = n_risky
    if n_risky == 0:
        return pos, done
    size = bucket_size(n_risky, 4096, fine_buckets)
    sel = torch.argsort((~risky).to(torch.int8), stable=True)[:size]
    rpos, rdone = neargrid_walk(exact_rows(), starts[sel].contiguous(),
                                shape, max_steps, known)
    pos[sel] = rpos
    done[sel] = rdone
    return pos, done
