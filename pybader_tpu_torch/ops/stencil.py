"""Ongrid ascent step codes and parent decoding.

Port of :mod:`pybader_tpu.ops.stencil` (``ongrid_step_codes``,
``parent_from_step_codes``).  Each voxel's ascent target is a pure function
of its 26-neighbourhood: the first neighbour, in OFFSETS order, whose
``(rho_n - rho_p) * w_k + rho_p`` strictly exceeds every earlier candidate
and ``rho_p``; code 13 (the self step) marks a maximum.
"""
from __future__ import annotations

import torch

from pybader_tpu_torch.grid import OFFSETS, SELF_INDEX
from pybader_tpu_torch.ops import _cuda


def ongrid_step_codes(reference: torch.Tensor, weights) -> torch.Tensor:
    """(nx, ny, nz) uint8 step codes of an f64 density grid.

    ``weights``: the 27 inverse step lengths in OFFSETS order.  A CUDA
    tensor runs ``csrc/stencil.cu``; a CPU tensor the plain version.
    """
    if _cuda.on_cuda(reference):
        return ongrid_step_codes_cuda(reference, weights)
    return ongrid_step_codes_plain(reference, weights)


def ongrid_step_codes_plain(reference: torch.Tensor,
                            weights) -> torch.Tensor:
    """Plain PyTorch stencil, in the op order of the JAX exact-f64 path:
    one periodic roll per offset, ``(rolled - ref) * w + ref``, strict
    ``>`` against the running best."""
    best_val = reference
    best_k = torch.full(reference.shape, SELF_INDEX, dtype=torch.uint8,
                        device=reference.device)
    for k, (ox, oy, oz) in enumerate(OFFSETS):
        if k == SELF_INDEX:
            continue
        rolled = torch.roll(reference, shifts=(-ox, -oy, -oz),
                            dims=(0, 1, 2))
        val = (rolled - reference) * float(weights[k]) + reference
        upd = val > best_val
        best_val = torch.where(upd, val, best_val)
        best_k = torch.where(upd, torch.tensor(k, dtype=torch.uint8,
                                               device=reference.device),
                             best_k)
    return best_k


def ongrid_step_codes_cuda(reference: torch.Tensor,
                           weights) -> torch.Tensor:
    """Launch ``pb_ongrid_step_codes`` (csrc/stencil.cu)."""
    _cuda.check(reference, torch.float64, "reference")
    if reference.dim() != 3:
        raise ValueError(f"reference: expected a 3-D grid, got "
                         f"{tuple(reference.shape)}")
    w = torch.as_tensor([float(v) for v in weights], dtype=torch.float64,
                        device=reference.device)
    if w.numel() != len(OFFSETS):
        raise ValueError(f"weights: expected {len(OFFSETS)}, got {w.numel()}")
    codes = torch.empty(reference.shape, dtype=torch.uint8,
                        device=reference.device)
    nx, ny, nz = reference.shape
    _cuda.call("pb_ongrid_step_codes", reference.data_ptr(), w.data_ptr(),
               codes.data_ptr(), nx, ny, nz, reference.device.index or 0,
               _cuda.stream(reference))
    _cuda.launches["ongrid_step_codes"] += 1
    return codes


def parent_from_step_codes(best_k: torch.Tensor) -> torch.Tensor:
    """Decode step codes to flat int32 parent indices (periodic)."""
    nx, ny, nz = best_k.shape
    dev = best_k.device
    code = best_k.long()
    ox = code // 9 - 1
    oy = (code // 3) % 3 - 1
    oz = code % 3 - 1
    x = torch.arange(nx, device=dev).view(-1, 1, 1)
    y = torch.arange(ny, device=dev).view(1, -1, 1)
    z = torch.arange(nz, device=dev).view(1, 1, -1)
    px = torch.remainder(x + ox, nx)
    py = torch.remainder(y + oy, ny)
    pz = torch.remainder(z + oz, nz)
    return ((px * ny + py) * nz + pz).to(torch.int32)
