"""Per-label reductions and label remaps.

Port of :mod:`pybader_tpu.ops.reductions` (``vacuum_mask``,
``charge_volume_sum``, ``min_pair_iota``, ``remap_labels``, ``relabel``)
and of the matching Pallas kernels of ``ops/pallas_reduce.py``.  The JAX
package picks between masked sweeps, Pallas kernels and segment sums by
backend and label count; those thresholds suit the TPU only.  Here a CUDA
tensor always runs the kernel of ``csrc/reduce.cu`` (any label count) and a
CPU tensor always runs the plain version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from pybader_tpu_torch import trace
from pybader_tpu_torch.ops import _cuda

_INT32_MAX = int(np.iinfo(np.int32).max)


def vacuum_mask(reference: torch.Tensor, vac_tol: float,
                density: torch.Tensor, voxel_vol: float):
    """Mask voxels with reference density <= vac_tol as vacuum.

    returns (mask bool grid, vacuum charge, vacuum volume): the charge sums
    the *density* over the mask, both scaled by the voxel volume.  The
    vacuum voxel count goes to the open span's ``voxels`` counter
    (:mod:`pybader_tpu_torch.trace`).
    """
    mask = reference <= vac_tol
    charge = float(torch.where(mask, density, 0.0).sum()) * voxel_vol
    voxels = int(mask.sum())
    trace.count("voxels", voxels)
    return mask, charge, voxels * voxel_vol


# -------------------------------------------------------------- min pair
def min_pair(labels: torch.Tensor, mask: torch.Tensor, num_segments: int):
    """Per label: (minimum flat index, minimum flat index where mask),
    int32 (K,) each; INT32_MAX where a label has no such voxel.  Labels
    outside [0, K) are skipped."""
    if _cuda.on_cuda(labels):
        return min_pair_cuda(labels, mask, num_segments)
    return min_pair_plain(labels, mask, num_segments)


def min_pair_plain(labels, mask, num_segments: int):
    lab = labels.reshape(-1).long()
    valid = (lab >= 0) & (lab < num_segments)
    iota = torch.arange(lab.shape[0], device=lab.device)
    out = []
    for keep in (valid, valid & mask.reshape(-1)):
        m = torch.full((num_segments,), _INT32_MAX, dtype=torch.int64,
                       device=lab.device)
        m.scatter_reduce_(0, lab[keep], iota[keep], "amin")
        out.append(m.to(torch.int32))
    return out[0], out[1]


def min_pair_cuda(labels, mask, num_segments: int):
    """Launch ``pb_min_pair`` (csrc/reduce.cu)."""
    _cuda.check(labels, torch.int32, "labels")
    _cuda.check(mask, torch.bool, "mask", labels.shape)
    mn = torch.empty((num_segments,), dtype=torch.int32, device=labels.device)
    mm = torch.empty_like(mn)
    _cuda.call("pb_min_pair", labels.data_ptr(), mask.data_ptr(),
               mn.data_ptr(), mm.data_ptr(), labels.numel(), num_segments,
               labels.device.index or 0, _cuda.stream(labels))
    _cuda.launches["min_pair"] += 1
    return mn, mm


# ----------------------------------------------------------------- remap
def remap_labels(labels: torch.Tensor, table: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """labels -> table[labels] (int32, same shape); negative labels kept,
    labels >= K map to 0 (the JAX ``remap_sweep`` contract)."""
    if _cuda.on_cuda(labels):
        return remap_labels_cuda(labels, table, num_segments)
    return remap_labels_plain(labels, table, num_segments)


def remap_labels_plain(labels, table, num_segments: int):
    lab = labels.long()
    looked = table.to(torch.int32)[lab.clamp(0, max(num_segments - 1, 0))]
    out = torch.where(lab < num_segments, looked, 0)
    return torch.where(lab < 0, labels.to(torch.int32), out)


def aligned_like(t: torch.Tensor) -> torch.Tensor:
    """An empty contiguous tensor shaped like ``t`` whose address has the
    same offset within 16 bytes as ``t``'s, so that a kernel can move both
    in 16-byte vectors after the same scalar head (``t`` may be a view at
    any storage offset)."""
    shift = (t.data_ptr() % 16) // t.element_size()
    if shift == 0:
        return torch.empty_like(t, memory_format=torch.contiguous_format)
    buf = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    return buf[shift:].view(t.shape)


def remap_labels_cuda(labels, table, num_segments: int):
    """Launch ``pb_remap`` (csrc/reduce.cu); ``labels`` may be any
    contiguous int32 tensor, a view at a storage offset included."""
    _cuda.check(labels, torch.int32, "labels")
    _cuda.check(table, torch.int32, "table", (num_segments,))
    out = aligned_like(labels)
    _cuda.call("pb_remap", labels.data_ptr(), table.data_ptr(),
               out.data_ptr(), labels.numel(), num_segments,
               labels.device.index or 0, _cuda.stream(labels))
    _cuda.launches["remap_labels"] += 1
    return out


def relabel(labels: torch.Tensor, swap: torch.Tensor) -> torch.Tensor:
    """Remap non-negative labels through a lookup table (vacuum kept)."""
    swap = swap.to(device=labels.device, dtype=torch.int32).contiguous()
    return remap_labels(labels.to(torch.int32).contiguous(), swap,
                        int(swap.shape[0]))


# --------------------------------------------------------- charge volume
def charge_volume(density: torch.Tensor, labels: torch.Tensor,
                  num_segments: int):
    """Per label: (f64 density sum, int64 voxel count) over labels in
    [0, K); negative labels (vacuum) are excluded."""
    if _cuda.on_cuda(labels):
        return charge_volume_cuda(density, labels, num_segments)
    return charge_volume_plain(density, labels, num_segments)


def charge_volume_plain(density, labels, num_segments: int):
    lab = labels.reshape(-1).long()
    keep = (lab >= 0) & (lab < num_segments)
    rho = density.reshape(-1)
    charge = torch.zeros((num_segments,), dtype=torch.float64,
                         device=lab.device)
    charge.index_add_(0, lab[keep], rho[keep])
    count = torch.bincount(lab[keep], minlength=num_segments)
    return charge, count


def charge_volume_cuda(density, labels, num_segments: int):
    """Launch ``pb_charge_volume`` (csrc/reduce.cu).  Up to 512 labels its
    blocks write partial sums to a scratch array (sized by
    ``pb_charge_volume_scratch``) that a second kernel adds in block
    order."""
    _cuda.check(labels, torch.int32, "labels")
    _cuda.check(density, torch.float64, "density", labels.shape)
    dev = labels.device.index or 0
    charge = torch.empty((num_segments,), dtype=torch.float64,
                         device=labels.device)
    count = torch.empty((num_segments,), dtype=torch.int64,
                        device=labels.device)
    nbytes = ctypes.c_longlong()
    _cuda.call("pb_charge_volume_scratch", labels.numel(), num_segments, dev,
               ctypes.addressof(nbytes))
    scratch = torch.empty((nbytes.value,), dtype=torch.uint8,
                          device=labels.device)
    _cuda.call("pb_charge_volume", density.data_ptr(), labels.data_ptr(),
               charge.data_ptr(), count.data_ptr(), scratch.data_ptr(),
               labels.numel(), num_segments, dev, _cuda.stream(labels))
    _cuda.launches["charge_volume"] += 1
    return charge, count


def charge_volume_sum(density: torch.Tensor, labels: torch.Tensor,
                      voxel_vol: float, num_segments: int):
    """Per-label integrated charge and volume (labels < 0 excluded):
    charge = voxel_vol * sum(density), volume = voxel_vol * count, the
    count exact in int64 and multiplied once."""
    charge, count = charge_volume(density, labels, num_segments)
    return charge * voxel_vol, count.to(torch.float64) * voxel_vol
