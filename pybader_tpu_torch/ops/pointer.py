"""Ascent-pointer roots and basin labelling.

Port of :func:`pybader_tpu.ops.pointer.resolve_roots` and of the label
contract of :func:`pybader_tpu.ops.scanflood.labels_scanflood` (the
``_flood_seed`` / ``_flood_decode`` helpers of ``ops/pallas_chase.py``):
labels numbered by ascending flat index of their maximum, vacuum -1.

The TPU floods labels with directional plane scans because its gathers are
slow; on Hopper the roots come from pointer jumping (``csrc/flood.cu``),
which reaches the same fixed point.
"""
from __future__ import annotations

import torch

from pybader_tpu_torch.ops import _cuda
from pybader_tpu_torch.ops.stencil import parent_from_step_codes

# More passes than any pointer graph of < 2**31 voxels needs: in-place
# jumping at least halves every chain per pass.
_MAX_PASSES = 64


def resolve_roots(parent: torch.Tensor) -> torch.Tensor:
    """Converge ascent pointers: root[p] = the fixed point p's chain
    reaches (a maximum or a vacuum voxel).  ``parent``: int32 flat
    indices, any shape.  A CUDA tensor runs ``csrc/flood.cu``."""
    if _cuda.on_cuda(parent):
        return resolve_roots_cuda(parent)
    return resolve_roots_plain(parent)


def resolve_roots_plain(parent: torch.Tensor) -> torch.Tensor:
    """Synchronous pointer doubling, as the JAX ``resolve_roots``."""
    p = parent.reshape(-1).long()
    while True:
        p2 = p[p]
        if torch.equal(p2, p):
            break
        p = p2
    return p.to(torch.int32).reshape(parent.shape)


def resolve_roots_cuda(parent: torch.Tensor) -> torch.Tensor:
    """Launch ``pb_resolve_roots`` (csrc/flood.cu) on a copy of parent."""
    _cuda.check(parent, torch.int32, "parent")
    root = parent.clone(memory_format=torch.contiguous_format)
    flag = torch.empty((1,), dtype=torch.int32, device=parent.device)
    try:
        _cuda.call("pb_resolve_roots", root.data_ptr(), root.numel(),
                   flag.data_ptr(), _MAX_PASSES, parent.device.index or 0,
                   _cuda.stream(parent))
    except _cuda.KernelError as e:
        if e.code == -1:
            raise RuntimeError(
                f"pointer jumping did not converge in {_MAX_PASSES} passes "
                f"-- is the pointer graph acyclic?") from e
        raise
    _cuda.launches["resolve_roots"] += 1
    return root


def labels_flood(best_k: torch.Tensor, vacuum: torch.Tensor | None = None):
    """Dense basin labels from step codes: the ``labels_scanflood``
    contract.  Labels number the non-vacuum maxima (code 13) by ascending
    flat index; vacuum voxels, and any voxel whose chain ends in vacuum,
    are -1.  returns (labels int32 grid, n_maxima int)."""
    if vacuum is not None:
        best_k = torch.where(vacuum, torch.tensor(13, dtype=torch.uint8,
                                                  device=best_k.device),
                             best_k)
    roots = resolve_roots(parent_from_step_codes(best_k)).reshape(-1).long()
    is_max = (best_k == 13).reshape(-1)
    if vacuum is not None:
        is_max &= ~vacuum.reshape(-1)
    rank = torch.cumsum(is_max, 0, dtype=torch.int64) - 1
    labels = torch.where(is_max[roots], rank[roots], -1).to(torch.int32)
    return labels.reshape(best_k.shape), int(is_max.sum())
