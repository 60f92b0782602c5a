"""Ongrid ascent step codes, parent decoding and the nginit codes.

Port of :mod:`pybader_tpu.ops.stencil` (``ongrid_step_codes``,
``parent_from_step_codes``, ``neargrid_init_codes``), and the transformed
gradient that the walk rows share with the nginit codes. Each voxel's
ascent target is a pure function of its 26-neighbourhood: the first
neighbour, in OFFSETS order, whose ``(rho_n - rho_p) * w_k + rho_p``
strictly exceeds every earlier candidate and ``rho_p``; code 13 (the self
step) marks a maximum.
"""
from __future__ import annotations

import numpy as np
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
    """Launch ``pb_ongrid_step_codes`` (csrc/stencil.cu).  The weights
    stay in host memory: the entry passes them to the kernel by value."""
    _cuda.check(reference, torch.float64, "reference")
    if reference.dim() != 3:
        raise ValueError(f"reference: expected a 3-D grid, got "
                         f"{tuple(reference.shape)}")
    w = torch.tensor([float(v) for v in weights], dtype=torch.float64)
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


def gradient_plain(reference, t_grad, strict_grad: bool):
    """The transformed central-difference gradient, in JAX's op order.

    ``gd_i = ((0 + T[i,0] g_0) + T[i,1] g_1) + T[i,2] g_2`` with
    ``g_j = (up - dn) * 0.5``, zero where the voxel is flat along axis j
    (``<`` against both neighbours when ``strict_grad``, else ``<=``).
    returns (gd: three flat f64 columns, mg = max_i |gd_i|).
    """
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
    return gd, mg


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


def neargrid_init_codes(reference: torch.Tensor, bk: torch.Tensor,
                        t_grad) -> torch.Tensor:
    """First-neargrid-step codes with the ongrid fallback (the hybrid's
    nginit init), JAX's ``stencil.neargrid_init_codes``.

    For each voxel, the first step a neargrid trajectory at rest would
    take: the non-strict central-difference gradient through ``t_grad``,
    inf-normalised, ``round_away(g)`` plus ``round_away(g - that)`` per
    axis, as an OFFSETS code.  The code is kept where the step strictly
    ascends the density and the gradient is not ~0 (``max|gd| >= 1e-14``);
    elsewhere the ongrid code ``bk`` stands.  A CUDA tensor runs
    ``csrc/stencil.cu``; a CPU tensor the plain version.
    """
    if _cuda.on_cuda(reference):
        return neargrid_init_codes_cuda(reference, bk, t_grad)
    return neargrid_init_codes_plain(reference, bk, t_grad)


def neargrid_init_codes_plain(reference, bk, t_grad) -> torch.Tensor:
    """Plain PyTorch init codes, in the op order of the JAX function."""
    gd, mg = gradient_plain(reference, t_grad, strict_grad=False)
    denom = torch.where(mg > 0, mg, 1.0)
    code = torch.zeros_like(mg, dtype=torch.long)
    for i in range(3):
        g = gd[i] / denom
        ig = torch.trunc(torch.where(g > 0, g + 0.5, g - 0.5))
        r = g - ig
        step = ig + torch.trunc(torch.where(r > 0, r + 0.5, r - 0.5))
        code = code * 3 + step.long() + 1
    code = code.reshape(reference.shape)
    target = reference  # density at the step's target voxel
    for k, (ox, oy, oz) in enumerate(OFFSETS):
        target = torch.where(code == k, torch.roll(
            reference, (-ox, -oy, -oz), (0, 1, 2)), target)
    keep = (target > reference) & (mg >= 1e-14).reshape(reference.shape)
    return torch.where(keep, code.to(torch.uint8), bk)


def neargrid_init_codes_cuda(reference, bk, t_grad) -> torch.Tensor:
    """Launch ``pb_nginit_codes`` (csrc/stencil.cu)."""
    _cuda.check(reference, torch.float64, "reference")
    if reference.dim() != 3:
        raise ValueError(f"reference: expected a 3-D grid, got "
                         f"{tuple(reference.shape)}")
    _cuda.check(bk, torch.uint8, "bk", reference.shape)
    t = torch.as_tensor(t_grad, dtype=torch.float64).to(
        reference.device).contiguous()
    if t.shape != (3, 3):
        raise ValueError(f"t_grad: expected (3, 3), got {tuple(t.shape)}")
    codes = torch.empty_like(bk)
    nx, ny, nz = reference.shape
    _cuda.call("pb_nginit_codes", reference.data_ptr(), bk.data_ptr(),
               t.data_ptr(), codes.data_ptr(), nx, ny, nz,
               reference.device.index or 0, _cuda.stream(reference))
    _cuda.launches["nginit_codes"] += 1
    return codes
