"""Partitioning pipelines.

Port of :mod:`pybader_tpu.pipeline`: the ongrid and neargrid partitions and
neargrid edge refinement, each stage on the device of the input.  The JAX
package's TPU scheduling (the walker's drain loop, chunks and quantised
rows, the candidate-list switch, the roots compaction above 4096 maxima)
gives the same labels as the exact formulation ported here.

Not ported (ROADMAP Queue 1): the neargrid-first-step hybrid init
(``PYBADER_TPU_HYBRID_INIT=nginit``), the unscreened quantised-row modes
(``PYBADER_TPU_QROWS``), ``PYBADER_TPU_INTERNAL_CAP``,
``PYBADER_TPU_F32_ROWS`` and ``PYBADER_TPU_BLOCK_WALK``.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from pybader_tpu_torch.ops import neargrid, reductions
from pybader_tpu_torch.ops.edges import edge_check, edge_find
from pybader_tpu_torch.ops.pointer import labels_flood, resolve_roots
from pybader_tpu_torch.ops.stencil import (
    ongrid_step_codes, parent_from_step_codes,
)

METHODS = ["ongrid", "neargrid"]
REFINEMENT_METHODS = ["neargrid"]

# Above this voxel count method='neargrid' runs the hybrid: the ongrid
# partition, then internal neargrid edge refinement (the JAX package's
# threshold, chosen for TPU gather rates; ROADMAP Queue 1 item 9).
_NEARGRID_HYBRID_THRESHOLD = 1 << 24
# Internal refinement iterations of the hybrid per 128 voxels of extent.
_HYBRID_ITERS_PER_128 = 3


def step_codes(reference: torch.Tensor, vacuum: torch.Tensor | None,
               weights) -> torch.Tensor:
    """Ascent step codes with vacuum voxels forced to the self step (13),
    so they never move."""
    bk = ongrid_step_codes(reference, weights)
    if vacuum is not None:
        bk = torch.where(vacuum, torch.tensor(13, dtype=torch.uint8,
                                              device=bk.device), bk)
    return bk


def renumber_discovery(labels_mo: torch.Tensor, is_max: torch.Tensor,
                       n_max: int):
    """Renumber ascending-maximum labels to discovery order.

    Discovery order = ascending first (minimum flat-index) member per
    basin, the order a serial threads=1 scan discovers maxima.  Any label
    count takes this path: the JAX package switches to a roots compaction
    above 4096 maxima because its masked sweeps cost O(K*N) on the TPU,
    while the min_pair and remap kernels take any K; both give the same
    labels (tests/test_torch_pipeline.py).  returns (labels int32 grid,
    maxima (M, 3) int64 numpy voxel coordinates).
    """
    _, ny, nz = labels_mo.shape
    first_member, max_pos = reductions.min_pair(labels_mo, is_max, n_max)
    first_h = first_member.cpu().numpy()
    order = np.argsort(first_h, kind="stable").astype(np.int32)
    rank = np.argsort(order, kind="stable").astype(np.int32)
    labels = reductions.remap_labels(
        labels_mo, torch.as_tensor(rank, device=labels_mo.device), n_max)
    max_flat = max_pos.cpu().numpy()[order].astype(np.int64)
    maxima = np.stack(
        [max_flat // (ny * nz), (max_flat // nz) % ny, max_flat % nz],
        axis=1).astype(np.int64)
    return labels, maxima


def partition_ongrid(reference: torch.Tensor, vacuum: torch.Tensor | None,
                     weights, progress=None):
    """Ongrid partition: step codes, roots, discovery-order labels.

    args:
        reference: (nx, ny, nz) f64 density tensor; its device decides
            where every stage runs.
        vacuum: bool mask on the same device, or None.
        weights: the 27 distance weights (OFFSETS order).
        progress: optional callback(str) for live stage ticks.
    returns:
        (labels int32 tensor [-1 vacuum, 0..M-1 basins],
         maxima (M, 3) int64 numpy voxel indices in discovery order)
    """
    bk = step_codes(reference, vacuum, weights)
    labels_mo, n_max = labels_flood(bk, vacuum)
    if progress is not None:
        progress(f"{n_max} maxima")
    n_max = max(n_max, 1)
    is_max = bk == 13
    if vacuum is not None:
        is_max &= ~vacuum
    return renumber_discovery(labels_mo, is_max, n_max)


def label_from_roots(roots: torch.Tensor, vacuum: torch.Tensor | None):
    """Labels and maxima from each voxel's end point: the contract of the
    JAX ``pointer.label_from_roots``.

    The maxima are the non-vacuum voxels that are their own end point.  A
    voxel is labelled by ``searchsorted(maxima, end point)`` -- the count of
    maxima below its end point -- and the labels are renumbered to
    discovery order.  For an end point that is a maximum that is its rank;
    a trajectory that ends on a vacuum voxel gets the next maximum above it
    (-1 past the last), as in the JAX package.  Vacuum voxels are -1.
    returns (labels int32 grid, maxima (M, 3) int64 numpy).
    """
    shape = roots.shape
    flat = roots.reshape(-1).long()
    iota = torch.arange(flat.numel(), device=flat.device)
    is_max = flat == iota
    if vacuum is not None:
        is_max &= ~vacuum.reshape(-1)
    n_max = int(is_max.sum())
    below = torch.cumsum(is_max, 0) - is_max.long()
    lab = below[flat]
    lab = torch.where(lab < n_max, lab, -1)
    if vacuum is not None:
        lab = torch.where(vacuum.reshape(-1), -1, lab)
    lab = lab.to(torch.int32).reshape(shape)
    if n_max == 0:
        return lab, np.zeros((0, 3), dtype=np.int64)
    return renumber_discovery(lab, is_max.reshape(shape), n_max)


def hybrid_internal_budget(shape):
    """The hybrid's internal refinement: ('changed', 3 per 128 voxels of
    the largest extent), so the refined band keeps a fixed physical
    width as the resolution grows."""
    return ("changed", _HYBRID_ITERS_PER_128 * max(1, -(-max(shape) // 128)))


def partition_neargrid(reference: torch.Tensor, vacuum: torch.Tensor | None,
                       weights, t_grad, full_trajectories: bool | None = None,
                       progress=None, carry_out=None, stats=None):
    """Neargrid partition.

    Every non-vacuum voxel walks its full neargrid trajectory to a maximum
    (the JAX package's order-free form of the reference method); lanes
    still walking at the step cap resolve through their ongrid root.  On
    grids above 2**24 voxels, or with ``full_trajectories=False``, the
    hybrid runs instead: the ongrid partition, then
    :func:`hybrid_internal_budget` iterations of 'changed' refinement, whose
    continuation state goes to ``carry_out`` so that a following
    ``refine_labels(..., carry_in=carry_out)`` chains on.

    ``PYBADER_TPU_FULL_TRAJECTORIES`` (0/off/false or anything else) picks
    the path when ``full_trajectories`` is None; ``PYBADER_TPU_INTERNAL_ITERS``
    overrides the hybrid's internal depth (-1: to convergence).
    ``stats``, if a dict, receives ``cap_fires`` (full trajectories) or the
    internal refinement's ``iterations`` (hybrid).

    returns (labels int32 tensor, maxima (M, 3) int64 numpy)
    """
    shape = tuple(reference.shape)
    n = reference.numel()
    if full_trajectories is None:
        env = os.environ.get("PYBADER_TPU_FULL_TRAJECTORIES")
        if env is not None:
            full_trajectories = env.lower() not in ("0", "off", "false")
        else:
            full_trajectories = n <= _NEARGRID_HYBRID_THRESHOLD
    if not full_trajectories:
        labels, maxima = partition_ongrid(reference, vacuum, weights,
                                          progress)
        internal = hybrid_internal_budget(shape)
        env_it = os.environ.get("PYBADER_TPU_INTERNAL_ITERS")
        if env_it is not None:
            internal = ("changed", int(env_it))
        # refinement moves edge voxels between the existing basins: the
        # numbering and the maxima stay those of the ongrid partition
        labels, _ = refine_labels(
            "neargrid", internal, reference, labels, weights, t_grad,
            verbose=False, progress=progress, carry_out=carry_out,
            stats=stats)
        return labels, maxima
    bk = step_codes(reference, vacuum, weights)
    rows = neargrid.neargrid_rows(reference, bk, t_grad, strict_grad=False)
    if progress is not None:
        progress(f"walking {n} trajectories")
    starts = torch.arange(n, dtype=torch.int32, device=reference.device)
    pos, done = neargrid.neargrid_walk(rows, starts, shape,
                                       neargrid.initial_cap(shape))
    del rows
    n_capped = int((~done).sum())
    if n_capped:
        roots = resolve_roots(parent_from_step_codes(bk)).reshape(-1)
        pos = torch.where(done, pos, roots[pos.long()])
    if stats is not None:
        stats["cap_fires"] = n_capped
    return label_from_roots(pos.reshape(shape), vacuum)


def refinement_runs(method: str, refine_mode) -> bool:
    """False where refine_labels returns its labels untouched: unknown
    methods are skipped silently (as in the JAX package) and zero
    iterations are a no-op."""
    return method in REFINEMENT_METHODS and tuple(refine_mode)[1] != 0


def refine_labels(method: str, refine_mode, reference, labels, weights,
                  t_grad, verbose: bool = True, progress=None, stats=None,
                  carry_in=None, carry_out=None):
    """Iterative neargrid edge refinement.

    Iteration 1 walks every edge voxel (``edge_find``); later iterations
    walk the fresh full edge set ('all') or the edges that ``edge_check``
    finds around the voxels that changed ('changed'), for ``iters``
    iterations or until nothing changes (``iters < 0``: to convergence).
    Unknown methods and ``iters == 0`` return the labels untouched.

    ``carry_in`` / ``carry_out`` chain successive 'changed' calls on the
    same labels into one sequence: a call given ``carry_out`` runs the
    ``edge_check`` after its last iteration and leaves its step codes,
    local-maximum mask, walk rows and ``known`` grid there, or
    ``converged`` when it converged; a call given that dict as
    ``carry_in`` resumes from it (and returns at once after convergence).
    Both are ignored in 'all' mode.

    ``stats``, if a dict, receives ``iterations``: one (edges walked,
    changed, step-cap fires, 0, seconds) tuple per iteration (the JAX
    package's fourth field counts quantised-row re-walks, which the port
    has none of).

    ``reference``, ``labels`` and ``t_grad`` are tensors on one device
    (``t_grad`` may also be numpy).  returns (labels, total_changed).
    """
    if not refinement_runs(method, refine_mode):
        return labels, 0
    mode, iters = tuple(refine_mode)
    max_iters = np.inf if iters < 0 else int(iters)
    if str(mode).lower() != "changed":
        carry_in = carry_out = None
    if carry_in is not None and carry_in.get("converged"):
        return labels, 0
    shape = tuple(reference.shape)
    labels = labels.to(torch.int32).clone()  # updated in place below
    if carry_in is not None and "known" in carry_in:
        bk, is_max = carry_in["bk"], carry_in["is_max"]
        rows, known = carry_in["rows"], carry_in["known"]
    else:
        vac = labels == -1
        bk = step_codes(reference, vac, weights)
        rows = neargrid.neargrid_rows(reference, bk, t_grad,
                                      strict_grad=True)
        is_max = (bk == 13) & ~vac
        known = edge_find(reference, labels, is_max)
    cap = neargrid.refine_cap(shape)
    roots = None  # resolved on the first step-cap fire
    total_changed = 0
    converged = False
    if stats is not None:
        stats["iterations"] = []
    t_iter = time.perf_counter()
    it = 0
    while it < max_iters:
        it += 1
        starts = torch.nonzero(known.reshape(-1) == -2).reshape(-1).to(
            torch.int32)
        n_edges = starts.numel()
        if n_edges == 0:
            if verbose and it == 1:
                print("  No edges found.")
            converged = True
            break
        if verbose:
            print(f"  Iteration {it}: refining {n_edges} edges")
        if progress is not None:
            progress(f"iteration {it}: walking {n_edges} edges")
        pos, done = neargrid.neargrid_walk(rows, starts, shape, cap, known)
        n_capped = int((~done).sum())
        if n_capped:
            # step-cap stragglers resolve through their ongrid root
            if verbose:
                print(f"  {n_capped} trajectories hit the step cap "
                      f"(resolved through ongrid roots)")
            if roots is None:
                roots = resolve_roots(parent_from_step_codes(bk)).reshape(-1)
            pos = torch.where(done, pos, roots[pos.long()])
        changed = _apply_walk_results(labels, known, starts, pos)
        total_changed += changed
        if stats is not None:
            now = time.perf_counter()
            stats["iterations"].append(
                (n_edges, changed, n_capped, 0, round(now - t_iter, 3)))
            t_iter = now
        if verbose:
            print(f"  {changed} points changed.")
        if changed == 0:
            converged = True
            break
        if it >= max_iters and carry_out is None:
            break
        if str(mode).lower() == "all":
            known = edge_find(reference, labels, is_max)
        else:
            known = edge_check(known, labels, is_max)
    if carry_out is not None:
        if converged:
            carry_out["converged"] = True
        else:
            carry_out.update(known=known, bk=bk, is_max=is_max, rows=rows)
    return labels, total_changed


def _apply_walk_results(labels, known, starts, pos) -> int:
    """Give each walked voxel the label of its end point, in place: gather
    every old and new label first, then scatter.  Walked voxels whose label
    changed become -2 in ``known`` (the next 'changed' iteration's seeds),
    the others -1.  returns the number of changed voxels."""
    lab = labels.view(-1)
    kn = known.view(-1)
    s = starts.long()
    new = lab[pos.long()]
    changed = new != lab[s]
    lab[s] = new
    kn[s] = torch.where(changed, -2, -1).to(torch.int8)
    return int(changed.sum())
