"""Maxima -> atom assignment and minimum surface distance.

Port of :mod:`pybader_tpu.ops.atoms` and of the Pallas kernel
``pallas_reduce.surface_min_d2``.  The TPU kernel computes in f32; the
truth it approximates is the f64 ``atoms.surface_distance_from_edges``,
which both the plain version and ``csrc/reduce.cu`` follow here.
"""
from __future__ import annotations

import torch

from pybader_tpu_torch.ops import _cuda

# Edge voxels handled per step by the plain surface distance (bounds its
# (chunk, 27, 3) f64 temporaries).
_EDGE_CHUNK = 1 << 21


def _image_shifts(lattice: torch.Tensor) -> torch.Tensor:
    """(27, 3) cartesian shifts over the 3x3x3 periodic images."""
    combos = torch.tensor(
        [(x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1) for z in (-1, 0, 1)],
        dtype=lattice.dtype, device=lattice.device)
    return combos @ lattice


def _frac32(i: torch.Tensor, n: int) -> torch.Tensor:
    """Fractional coordinate ``i / n`` as the JAX path computes it: JAX
    promotes int32 / int to float32, and XLA evaluates the division by a
    constant as a multiply by its float32 reciprocal."""
    return i.to(torch.float32) * (torch.tensor(1.0, dtype=torch.float32) / n)


def assign_to_atoms(maxima_cart: torch.Tensor, atoms_cart: torch.Tensor,
                    lattice: torch.Tensor):
    """Nearest atom (over 27 periodic images) for each maximum; ties go to
    the lowest atom index.  returns (atom indices int64 (M,), distances
    (M,))."""
    shifts = _image_shifts(lattice)
    delta = (maxima_cart[:, None, None, :]
             - (atoms_cart[None, :, None, :] + shifts[None, None, :, :]))
    d2 = torch.sum(delta * delta, dim=-1)
    d2_atom = torch.amin(d2, dim=-1)  # (M, A)
    atom = torch.argmin(d2_atom, dim=-1)
    dist = torch.sqrt(torch.gather(d2_atom, 1, atom[:, None])[:, 0])
    return atom, dist


def surface_min_d2(labels: torch.Tensor, edge_mask: torch.Tensor,
                   lattice: torch.Tensor, atoms_cart: torch.Tensor,
                   num_atoms: int, origin=(0, 0, 0),
                   shape=None) -> torch.Tensor:
    """(num_atoms,) f64 minimum squared distance from each atom to the edge
    voxels of its own volume over 27 periodic images; +inf where the atom
    has none.  ``labels``: int32 voxel -> atom map; ``atoms_cart`` already
    shifted by -voxel_offset; ``lattice`` on any device (the kernel reads
    it from the host).  The grid may be one shard of a mesh: its
    voxels sit at ``origin`` of the grid ``shape`` (default: the grid
    itself), whose positions x / nx place them."""
    if shape is None:
        shape = tuple(labels.shape)
    if _cuda.on_cuda(labels):
        return surface_min_d2_cuda(labels, edge_mask, lattice, atoms_cart,
                                   num_atoms, origin, shape)
    return surface_min_d2_plain(labels, edge_mask, lattice, atoms_cart,
                                num_atoms, origin, shape)


def surface_min_d2_plain(labels, edge_mask, lattice, atoms_cart,
                         num_atoms: int, origin=(0, 0, 0), shape=None):
    """Edge compaction, then the f64 op order of the JAX
    ``surface_distance_from_edges``."""
    _, ly, lz = labels.shape
    nx, ny, nz = labels.shape if shape is None else shape
    ox, oy, oz = origin
    dev = labels.device
    # the shifts from the lattice where the caller holds it: from a host
    # lattice, the same values the kernel is given
    shifts = _image_shifts(lattice).to(dev)
    lattice = lattice.to(dev)
    lab_flat = labels.reshape(-1)
    edge_idx = torch.nonzero(edge_mask.reshape(-1)).reshape(-1)
    out = torch.full((num_atoms + 1,), float("inf"), dtype=torch.float64,
                     device=dev)
    for lo in range(0, edge_idx.shape[0], _EDGE_CHUNK):
        idx = edge_idx[lo:lo + _EDGE_CHUNK]
        frac = torch.stack(
            [_frac32(idx // (ly * lz) + ox, nx),
             _frac32((idx // lz) % ly + oy, ny),
             _frac32(idx % lz + oz, nz)], dim=-1).to(lattice.dtype)
        pc = frac @ lattice
        lab = lab_flat[idx].long()
        own = atoms_cart[lab.clamp(0, num_atoms - 1)]
        delta = pc[:, None, :] - (own[:, None, :] + shifts[None, :, :])
        d2 = torch.amin(torch.sum(delta * delta, dim=-1), dim=-1)
        seg = torch.where((lab >= 0) & (lab < num_atoms), lab, num_atoms)
        out.scatter_reduce_(0, seg, d2, "amin")
    return out[:num_atoms]


def surface_min_d2_cuda(labels, edge_mask, lattice, atoms_cart,
                        num_atoms: int, origin=(0, 0, 0), shape=None):
    """Launch ``pb_surface_min_d2`` (csrc/reduce.cu).  The image shifts
    and the lattice stay in host memory: the entry passes them to the
    kernel by value."""
    _cuda.check(labels, torch.int32, "labels")
    _cuda.check(edge_mask, torch.bool, "edge_mask", labels.shape)
    if labels.dim() != 3:
        raise ValueError(f"labels: expected a 3-D grid, got "
                         f"{tuple(labels.shape)}")
    lattice = torch.as_tensor(lattice, dtype=torch.float64).cpu()
    geo = torch.cat([_image_shifts(lattice).reshape(-1),
                     lattice.reshape(-1)]).contiguous()
    atoms = atoms_cart.to(device=labels.device,
                          dtype=torch.float64).contiguous()
    if tuple(atoms.shape) != (num_atoms, 3):
        raise ValueError(f"atoms_cart: expected ({num_atoms}, 3), got "
                         f"{tuple(atoms.shape)}")
    shape = tuple(labels.shape) if shape is None else tuple(shape)
    if any(o < 0 or o + n > m
           for o, n, m in zip(origin, labels.shape, shape)):
        raise ValueError(f"a {tuple(labels.shape)} shard at {origin} does "
                         f"not fit the grid {shape}")
    d2 = torch.empty((num_atoms,), dtype=torch.float64, device=labels.device)
    _cuda.call("pb_surface_min_d2", labels.data_ptr(), edge_mask.data_ptr(),
               geo.data_ptr(), atoms.data_ptr(), d2.data_ptr(),
               *labels.shape, *(int(o) for o in origin), *shape, num_atoms,
               labels.device.index or 0, _cuda.stream(labels))
    _cuda.launches["surface_min_d2"] += 1
    return d2


def surface_distance_masked(labels: torch.Tensor, edge_mask: torch.Tensor,
                            lattice: torch.Tensor, atoms_cart: torch.Tensor,
                            num_atoms: int) -> torch.Tensor:
    """(num_atoms,) f64 distance from each atom to its own volume's
    surface; 0.0 for an atom whose volume has no edge voxel."""
    d2 = surface_min_d2(labels, edge_mask, lattice, atoms_cart, num_atoms)
    return torch.where(torch.isfinite(d2), torch.sqrt(d2), 0.0)
