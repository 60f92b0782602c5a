"""Neargrid walk rows and the trajectory walker.

Port of the exact-row walk of :mod:`pybader_tpu.ops.neargrid`:
``precompute_rows`` (with ``_gd_components``, ``_denom_flags`` and
``_pack_parent``) and ``_walk_segment_packed`` as ``walk`` drives it.  The
JAX package's drain loop, bucket ladder, chunking and quantised rows with
their exactness screen schedule the walk for the TPU and give the same
results as the exact-row walk; none of them is ported.

A row is 32 bytes, one per voxel (``csrc/neargrid.cu``): the three
inf-normalised f64 gradient components, then an int32 ongrid parent and a
flag byte, :data:`ONGRID` (``max|gd| < 1e-14``) and :data:`MAX` (the parent
is the voxel itself: maxima and vacuum).  In torch the rows are an (N, 4)
float64 tensor whose fourth column holds the parent and the flags as the
int32 pair ``rows.view(torch.int32)[:, 6:8]``.

The rows are built without fused multiply-adds in JAX's accumulation order,
so the kernel and the plain version agree bit for bit.  XLA's CPU backend
fuses some of those multiply-adds, so JAX's rows can differ from the port's
by a few ulp (never in the flags or parents); :func:`rows_from_jax_rows`
converts JAX rows so that the walker can be held to JAX bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from pybader_tpu_torch.ops import _cuda
from pybader_tpu_torch.ops.stencil import parent_from_step_codes

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
    voxel-step transform.  ``strict_grad``: the flatness test of the
    central difference, ``<`` (refinement) or ``<=`` (initial pass).  A
    CUDA tensor runs ``csrc/neargrid.cu``; a CPU tensor the plain version.
    """
    if _cuda.on_cuda(reference):
        return neargrid_rows_cuda(reference, codes, t_grad, strict_grad)
    return neargrid_rows_plain(reference, codes, t_grad, strict_grad)


def neargrid_rows_plain(reference, codes, t_grad, strict_grad: bool):
    """Plain PyTorch rows, in the op order of the JAX build."""
    t = [[float(v) for v in r] for r in np.asarray(
        torch.as_tensor(t_grad, dtype=torch.float64).cpu())]
    n = reference.numel()
    gd = [torch.zeros(n, dtype=torch.float64, device=reference.device)
          for _ in range(3)]
    for j in range(3):
        up = torch.roll(reference, -1, j)
        dn = torch.roll(reference, 1, j)
        if strict_grad:
            flat = (up < reference) & (dn < reference)
        else:
            flat = (up <= reference) & (dn <= reference)
        grad_j = torch.where(flat, 0.0, (up - dn) * 0.5).reshape(-1)
        for i in range(3):
            gd[i] = gd[i] + t[i][j] * grad_j
    mg = torch.maximum(torch.maximum(gd[0].abs(), gd[1].abs()), gd[2].abs())
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
    """Launch ``pb_neargrid_rows`` (csrc/neargrid.cu)."""
    _cuda.check(reference, torch.float64, "reference")
    if reference.dim() != 3:
        raise ValueError(f"reference: expected a 3-D grid, got "
                         f"{tuple(reference.shape)}")
    _cuda.check(codes, torch.uint8, "codes", reference.shape)
    t = torch.as_tensor(t_grad, dtype=torch.float64).to(
        reference.device).contiguous()
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
        starts: (K,) int32 flat start voxels.
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
    ``lane_steps`` (steps taken over all lanes) and ``rows_touched``
    (distinct voxels whose row was read)."""
    nx, ny, nz = shape
    dev = rows.device
    dims = torch.tensor([nx, ny, nz], device=dev)
    words = rows.view(torch.int32)
    grad = rows[:, :3]
    parent = words[:, 6].long()
    flags = words[:, 7]
    stop = None if known is None else known.reshape(-1) == 2
    k = starts.numel()
    lane = torch.arange(k, device=dev)
    pos = starts.reshape(-1).long()
    prev = torch.full((k,), -1, dtype=torch.long, device=dev)
    hist = torch.full((k, 3), -1, dtype=torch.long, device=dev)
    dr = torch.zeros((k, 3), dtype=torch.float64, device=dev)
    out_pos = pos.clone()
    out_done = torch.zeros(k, dtype=torch.bool, device=dev)
    touched = None
    lane_steps = 0
    if stats is not None:
        touched = torch.zeros(rows.shape[0], dtype=torch.bool, device=dev)
    for step in range(max_steps + 1):
        if touched is not None:
            touched[pos] = True
        term = (flags[pos] & MAX) != 0
        if stop is not None:
            term |= stop[pos]
        if bool(term.any()):
            out_pos[lane[term]] = pos[term]
            out_done[lane[term]] = True
            keep = ~term
            lane, pos, prev = lane[keep], pos[keep], prev[keep]
            hist, dr = hist[keep], dr[keep]
        if step == max_steps or lane.numel() == 0:
            break
        lane_steps += lane.numel()
        g = grad[pos]
        par = parent[pos]
        ongrid = (flags[pos] & ONGRID) != 0
        xyz = torch.stack([pos // (ny * nz), (pos // nz) % ny, pos % nz], 1)
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
        hist = torch.cat([prev[:, None], hist[:, :2]], 1)
        prev = pos
        pos = nxt
    out_pos[lane] = pos  # lanes still walking at the cap
    if stats is not None:
        stats["lane_steps"] = lane_steps
        stats["rows_touched"] = int(touched.sum())
    return out_pos.to(torch.int32), out_done


def neargrid_walk_cuda(rows, starts, shape, max_steps: int, known=None):
    """Launch ``pb_neargrid_walk`` (csrc/neargrid.cu)."""
    nx, ny, nz = shape
    n = nx * ny * nz
    _cuda.check(rows, torch.float64, "rows", (n, 4), per_voxel=4)
    _cuda.check(starts, torch.int32, "starts")
    if known is not None:
        _cuda.check(known, torch.int8, "known", shape)
    if starts.numel():
        lo, hi = torch.aminmax(starts)
        if int(lo) < 0 or int(hi) >= n:
            raise ValueError(f"starts: flat indices must lie in [0, {n})")
    pos = torch.empty(starts.shape, dtype=torch.int32, device=rows.device)
    done = torch.empty(starts.shape, dtype=torch.bool, device=rows.device)
    _cuda.call("pb_neargrid_walk", rows.data_ptr(), starts.data_ptr(),
               None if known is None else known.data_ptr(), pos.data_ptr(),
               done.data_ptr(), starts.numel(), nx, ny, nz, int(max_steps),
               rows.device.index or 0, _cuda.stream(rows))
    _cuda.launches["neargrid_walk"] += 1
    return pos, done
