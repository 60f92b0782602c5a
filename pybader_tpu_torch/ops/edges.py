"""Edge classification (``known`` grid).

Port of :func:`pybader_tpu.ops.edges.edge_find` and ``edge_check``.  A
CUDA tensor runs the kernels of ``csrc/edges.cu``, the port of the Pallas
kernels of ``ops/pallas_edges.py``; a CPU tensor runs the plain versions,
the separable periodic 3x3x3 box reductions of the JAX XLA path.
Refinement gives ``edge_find`` its maxima (the ascent stencil's self
step); the surface-distance stage gives none, and they come from the
density with vacuum neighbours ignored (:func:`local_max`).

``known`` encoding: 2 interior or local maximum, -1 near an edge, -2 edge
voxel, 0 vacuum far from any edge.  Vacuum voxels are never edge
candidates, in both functions (the JAX package's documented deviation from
the reference's ``edge_check``).
"""
from __future__ import annotations

import numpy as np
import torch

from pybader_tpu_torch.ops import _cuda

# The voxels (x, y, z) of one block of edge_check's kernel (csrc/edges.cu
# kTX, kTY, kTZ).
CHECK_TILE = (8, 8, 32)


def _box_reduce(a: torch.Tensor, combine) -> torch.Tensor:
    """Separable periodic 3x3x3 reduction (self included)."""
    for axis in range(3):
        a = combine(combine(a, torch.roll(a, 1, axis)), torch.roll(a, -1, axis))
    return a


def _is_edge(labels: torch.Tensor) -> torch.Tensor:
    """Some non-vacuum neighbour carries another label (vacuum labels are
    sentinels, so the box max and min differ exactly then)."""
    vac = labels == -1
    big = int(np.iinfo(np.int32).max)
    lab = labels.to(torch.int32)
    lmax = _box_reduce(torch.where(vac, -big, lab), torch.maximum)
    lmin = _box_reduce(torch.where(vac, big, lab), torch.minimum)
    return lmax != lmin


def edge_find(reference: torch.Tensor, labels: torch.Tensor,
              is_max: torch.Tensor | None = None) -> torch.Tensor:
    """Full-grid edge scan -> int8 known grid.

    A non-vacuum voxel is an edge when some non-vacuum neighbour carries a
    different label and it is not a local maximum; its other neighbours
    are near-edge.  ``reference`` is read only when ``is_max`` is None.
    """
    if is_max is None:
        is_max = local_max(reference, labels)
    if _cuda.on_cuda(labels):
        return edge_find_cuda(labels, is_max)
    return edge_find_plain(labels, is_max)


def local_max(reference: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The local maxima ``edge_find`` takes from the density when it is
    given no ``is_max``: voxels no non-vacuum neighbour exceeds (the box
    max, vacuum at -inf, equals the voxel)."""
    rmax = _box_reduce(torch.where(labels == -1, float("-inf"), reference),
                       torch.maximum)
    return rmax == reference


def edge_find_plain(labels, is_max):
    nonvac = labels != -1
    edge = nonvac & _is_edge(labels) & ~is_max
    near = _box_reduce(edge, torch.logical_or) & ~edge
    known = torch.where(nonvac, 2, 0).to(torch.int8)
    known = torch.where(near, -1, known).to(torch.int8)
    return torch.where(edge, -2, known).to(torch.int8)


def edge_find_cuda(labels, is_max):
    """Launch ``pb_edge_find`` (csrc/edges.cu)."""
    _check_grids(labels, is_max)
    scratch = torch.empty(labels.shape, dtype=torch.uint8,
                          device=labels.device)
    known = torch.empty(labels.shape, dtype=torch.int8, device=labels.device)
    nx, ny, nz = labels.shape
    _cuda.call("pb_edge_find", labels.data_ptr(), is_max.data_ptr(),
               scratch.data_ptr(), known.data_ptr(), nx, ny, nz,
               labels.device.index or 0, _cuda.stream(labels))
    _cuda.launches["edge_find"] += 1
    return known


def edge_check(known: torch.Tensor, labels: torch.Tensor,
               is_max: torch.Tensor) -> torch.Tensor:
    """Re-scan the 27-neighbourhoods of changed edges (known == -2).

    In the order of the JAX ``_edge_check_xla``: candidates (non-vacuum
    voxels beside or at a changed edge) that are no edge become -1, those
    that are edges and no maximum become -2 (new edges); then every voxel
    still >= 0 beside a new edge becomes -1.  Returns the updated known
    grid; the next edge set is ``known == -2``.
    """
    if _cuda.on_cuda(labels):
        return edge_check_cuda(known, labels, is_max)
    return edge_check_plain(known, labels, is_max)


def edge_check_plain(known, labels, is_max):
    nonvac = labels != -1
    cand = _box_reduce(known == -2, torch.logical_or) & nonvac
    is_edge = _is_edge(labels)
    new_edge = cand & is_edge & ~is_max
    out = torch.where(cand & ~is_edge, -1, known).to(torch.int8)
    out = torch.where(new_edge, -2, out).to(torch.int8)
    near_new = _box_reduce(new_edge, torch.logical_or) & (out >= 0)
    return torch.where(near_new, -1, out).to(torch.int8)


def edge_check_cuda(known, labels, is_max):
    """Launch ``pb_edge_check`` (csrc/edges.cu): one pass over tiles of
    :data:`CHECK_TILE` voxels."""
    _check_grids(labels, is_max)
    _cuda.check(known, torch.int8, "known", labels.shape)
    out = torch.empty_like(known)
    nx, ny, nz = labels.shape
    _cuda.call("pb_edge_check", known.data_ptr(), labels.data_ptr(),
               is_max.data_ptr(), out.data_ptr(), nx, ny, nz,
               labels.device.index or 0, _cuda.stream(labels))
    _cuda.launches["edge_check"] += 1
    return out


def check_reads(known: torch.Tensor, labels: torch.Tensor):
    """What ``edge_check`` must read besides ``known``: labels at every
    voxel within 1 of a -2 (whether it is vacuum) and within 1 of a
    candidate (its 27-box edge test), is_max at the candidates that are
    edges.  returns (labels read, is_max read), bool grids; they set the
    kernel's bound, which its tiles do not."""
    near = _box_reduce(known == -2, torch.logical_or)
    cand = near & (labels != -1)
    return near | _box_reduce(cand, torch.logical_or), cand & _is_edge(labels)


def check_tiles_active(known: torch.Tensor) -> torch.Tensor:
    """Per tile of ``edge_check_cuda``, whether it has a -2 within 2 voxels
    (periodic) and so reads labels and is_max; the other tiles copy known.
    A (tiles x, tiles y, tiles z) bool grid."""
    near = _box_reduce(_box_reduce(known == -2, torch.logical_or),
                       torch.logical_or)
    pad = [(-s) % t for s, t in zip(near.shape, CHECK_TILE)]
    near = torch.nn.functional.pad(near.to(torch.uint8),
                                   (0, pad[2], 0, pad[1], 0, pad[0]))
    tx, ty, tz = (s // t for s, t in zip(near.shape, CHECK_TILE))
    return near.view(tx, CHECK_TILE[0], ty, CHECK_TILE[1], tz,
                     CHECK_TILE[2]).amax(dim=(1, 3, 5)).bool()


def _check_grids(labels, is_max):
    _cuda.check(labels, torch.int32, "labels")
    if labels.dim() != 3:
        raise ValueError(f"labels: expected a 3-D grid, got "
                         f"{tuple(labels.shape)}")
    _cuda.check(is_max, torch.bool, "is_max", labels.shape)
