"""Edge classification (``known`` grid).

Port of :func:`pybader_tpu.ops.edges.edge_find` in plain PyTorch: the
separable periodic 3x3x3 box reductions of its XLA path.  The ongrid
analysis path calls it without ``is_max`` (the local-maximum mask then
comes from the density, with vacuum neighbours ignored), which is the XLA
route in the JAX package too; the Pallas edge kernels and ``edge_check``
belong to refinement, not yet ported (ROADMAP Queue 2).

``known`` encoding: 2 interior or local maximum, -1 near an edge, -2 edge
voxel, 0 vacuum far from any edge.
"""
from __future__ import annotations

import numpy as np
import torch


def _box_reduce(a: torch.Tensor, combine) -> torch.Tensor:
    """Separable periodic 3x3x3 reduction (self included)."""
    for axis in range(3):
        a = combine(combine(a, torch.roll(a, 1, axis)), torch.roll(a, -1, axis))
    return a


def edge_find(reference: torch.Tensor, labels: torch.Tensor,
              is_max: torch.Tensor | None = None) -> torch.Tensor:
    """Full-grid edge scan -> int8 known grid.

    A non-vacuum voxel is an edge when some non-vacuum neighbour carries a
    different label and it is not a local maximum; its other neighbours
    are near-edge.
    """
    vac = labels == -1
    nonvac = ~vac
    big = int(np.iinfo(np.int32).max)
    lab = labels.to(torch.int32)
    lmax = _box_reduce(torch.where(vac, -big, lab), torch.maximum)
    lmin = _box_reduce(torch.where(vac, big, lab), torch.minimum)
    is_edge = lmax != lmin
    if is_max is None:
        rmax = _box_reduce(torch.where(vac, float("-inf"), reference),
                           torch.maximum)
        is_max = rmax == reference
    edge = nonvac & is_edge & ~is_max
    near = _box_reduce(edge, torch.logical_or) & ~edge
    known = torch.where(nonvac, 2, 0).to(torch.int8)
    known = torch.where(near, -1, known).to(torch.int8)
    return torch.where(edge, -2, known).to(torch.int8)
