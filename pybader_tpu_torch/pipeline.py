"""Partitioning pipelines.

Port of :mod:`pybader_tpu.pipeline` for the on-grid method: the ascent
stencil, root resolution, and discovery-order renumbering, each on the
device of the input.  The neargrid method and neargrid refinement are not
ported yet (ROADMAP Queue 1 items 6-9) and raise ``NotImplementedError``;
they never fall back to ongrid.
"""
from __future__ import annotations

import numpy as np
import torch

from pybader_tpu_torch.ops import reductions
from pybader_tpu_torch.ops.pointer import labels_flood
from pybader_tpu_torch.ops.stencil import ongrid_step_codes

METHODS = ["ongrid", "neargrid"]
REFINEMENT_METHODS = ["neargrid"]

_NEARGRID_TODO = ("the neargrid method is not ported to pybader_tpu_torch "
                  "yet (ROADMAP Queue 1 items 6-9); use method='ongrid' "
                  "with refine_method='ongrid'")


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


def partition_neargrid(*args, **kwargs):
    """Not ported yet: raises ``NotImplementedError``."""
    raise NotImplementedError(_NEARGRID_TODO)


def refine_labels(method: str, refine_mode, reference, labels, weights,
                  t_grad, verbose: bool = True, progress=None):
    """Edge refinement.  Unknown methods are skipped silently and a zero
    iteration count is a no-op, as in the JAX package; neargrid
    refinement is not ported yet and raises ``NotImplementedError``.

    returns (labels, total_changed).
    """
    if method not in REFINEMENT_METHODS:
        return labels, 0
    _, iters = tuple(refine_mode)
    if iters == 0:
        return labels, 0
    raise NotImplementedError(_NEARGRID_TODO)
