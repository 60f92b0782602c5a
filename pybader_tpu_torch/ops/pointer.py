"""Ascent-pointer roots and basin labelling.

Port of :func:`pybader_tpu.ops.pointer.resolve_roots` and of the label
contract of :func:`pybader_tpu.ops.scanflood.labels_scanflood` (the
``_flood_seed`` / ``_flood_decode`` helpers of ``ops/pallas_chase.py``):
labels numbered by ascending flat index of their maximum, vacuum -1.

The TPU floods labels with directional plane scans because its gathers are
slow; on Hopper the roots come from pointer jumping (``csrc/flood.cu``: a
pass over tiles in shared memory, then passes over the whole grid), which
reaches the same fixed point.
"""
from __future__ import annotations

import ctypes

import torch

from pybader_tpu_torch.ops import _cuda
from pybader_tpu_torch.ops.stencil import parent_from_step_codes

# More passes than any pointer graph of < 2**31 voxels needs: in-place
# jumping at least halves every chain per pass.
_MAX_PASSES = 64
# Flag words of the jump passes' scratch: csrc/jump.cuh's kGroup, the
# passes launched between two reads of their flags by the host.
_JUMP_FLAGS = 2


def resolve_roots(parent: torch.Tensor) -> torch.Tensor:
    """Converge ascent pointers: root[p] = the fixed point p's chain
    reaches (a maximum or a vacuum voxel).  ``parent``: int32 flat
    indices, any shape.  A CUDA tensor runs ``csrc/flood.cu``."""
    if _cuda.on_cuda(parent):
        return resolve_roots_cuda(parent)
    return resolve_roots_plain(parent)


def resolve_roots_plain(parent: torch.Tensor, stats=None) -> torch.Tensor:
    """Synchronous pointer doubling, as the JAX ``resolve_roots``.
    ``stats['passes']``: the doubling passes, the last one unchanged."""
    p = parent.reshape(-1).long()
    passes = 0
    while True:
        p2 = p[p]
        passes += 1
        if torch.equal(p2, p):
            break
        p = p2
    if stats is not None:
        stats["passes"] = passes
    return p.to(torch.int32).reshape(parent.shape)


def resolve_roots_cuda(parent: torch.Tensor, stats=None) -> torch.Tensor:
    """Launch ``pb_resolve_roots`` (csrc/flood.cu).  A parent that is not
    3-D is taken as one flat row (1 x 1 x n).  ``stats['passes']``: the
    global passes after the tile pass."""
    _cuda.check(parent, torch.int32, "parent")
    shape = (tuple(parent.shape) if parent.dim() == 3
             else (1, 1, parent.numel()))
    root = torch.empty_like(parent, memory_format=torch.contiguous_format)
    flags = torch.empty((_JUMP_FLAGS,), dtype=torch.int32,
                        device=parent.device)
    passes = ctypes.c_int(0)
    try:
        _cuda.call("pb_resolve_roots", parent.data_ptr(), root.data_ptr(),
                   *shape, flags.data_ptr(), _MAX_PASSES,
                   ctypes.addressof(passes),
                   parent.device.index or 0, _cuda.stream(parent))
    except _cuda.KernelError as e:
        if e.code == -1:
            raise RuntimeError(
                f"pointer jumping did not converge in {_MAX_PASSES} passes "
                f"-- is the pointer graph acyclic?") from e
        raise
    _cuda.launches["resolve_roots"] += 1
    if stats is not None:
        stats["passes"] = passes.value
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
