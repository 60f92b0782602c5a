"""The analysis stages on a device mesh: vacuum mask, charge sums, relabel,
surface distance.

Port of :mod:`pybader_tpu.parallel.analysis`.  Each shard reduces its own
voxels with the single-device kernel, and the per-label vectors meet on the
host: an f64 sum of the charges, an exact sum of the counts, a minimum of
the squared distances.  No grid is gathered onto one device.
"""
from __future__ import annotations

import torch

from pybader_tpu_torch import trace
from pybader_tpu_torch.ops import reductions
from pybader_tpu_torch.ops.atoms import surface_min_d2
from pybader_tpu_torch.ops.edges import edge_find
from pybader_tpu_torch.parallel.mesh import (
    Layout, Mesh, Sharded, crop, halo, shard,
)


def sharded_vacuum_mask(mesh: Mesh, reference, vac_tol: float, density,
                        voxel_vol: float):
    """``vacuum_mask`` with the grids sharded over the mesh: each shard's
    mask (reference <= vac_tol) stays on its device; the shards' f64
    charge sums are added in shard order and scaled once, as
    :func:`sharded_charge_volume_sum` does.  The vacuum voxel count goes
    to the open span's ``voxels`` counter.  returns (mask
    :class:`Sharded`, vacuum charge, vacuum volume)."""
    lay = Layout(mesh, tuple(reference.shape))
    mask = shard(lay, reference, torch.float64).map(lambda b: b <= vac_tol)
    rho = shard(lay, density, torch.float64)
    charge = torch.zeros((), dtype=torch.float64)
    voxels = 0
    for m, d in zip(mask.blocks, rho.blocks):
        charge += torch.where(m, d, 0.0).sum().cpu()
        voxels += int(m.sum())
    trace.count("voxels", voxels)
    return mask, float(charge) * voxel_vol, voxels * voxel_vol


def sharded_charge_volume_sum(mesh: Mesh, density, labels, voxel_vol: float,
                              num_segments: int):
    """Per-label charge and volume with the grid sharded over the mesh:
    ``charge_volume`` per shard, then the shards' f64 sums and int64 counts
    added in shard order.  returns (charge, volume) f64 host tensors."""
    lay = Layout(mesh, tuple(density.shape))
    rho = shard(lay, density, torch.float64)
    lab = shard(lay, labels, torch.int32)
    charge = torch.zeros(num_segments, dtype=torch.float64)
    count = torch.zeros(num_segments, dtype=torch.int64)
    for d, b in zip(rho.blocks, lab.blocks):
        c, n = reductions.charge_volume(d, b, num_segments)
        charge += c.cpu()
        count += n.cpu()
    return charge * voxel_vol, count.to(torch.float64) * voxel_vol


def sharded_relabel(mesh: Mesh, labels, swap) -> Sharded:
    """``relabel`` (the ``remap`` kernel) on every shard."""
    lab = shard(Layout(mesh, tuple(labels.shape)), labels, torch.int32)
    swap = torch.as_tensor(swap)
    return lab.map(lambda b: reductions.relabel(b, swap))


def sharded_min_surface_distance(mesh: Mesh, reference, atoms_volumes,
                                 lattice, atoms_shifted, num_atoms: int):
    """Minimum atom-to-own-surface distance with the grid sharded over the
    mesh.  Per shard: the local maxima of the 2-haloed density (vacuum
    neighbours ignored), the ``edge_find`` kernel on the 2-haloed labels,
    then ``surface_min_d2`` with the shard's global origin; the minimum
    across shards.  returns (num_atoms,) f64 host tensor, 0 where an atom
    has no edge voxel."""
    lay = Layout(mesh, tuple(reference.shape))
    rho = shard(lay, reference, torch.float64)
    lab = shard(lay, atoms_volumes, torch.int32)
    d2 = torch.full((num_atoms,), float("inf"), dtype=torch.float64)
    for s, (r, b) in enumerate(zip(halo(rho, 2), halo(lab, 2))):
        known = crop(edge_find(r, b), lay, 2)
        own = lab.blocks[s]
        d2 = torch.minimum(d2, surface_min_d2(
            own, known == -2, torch.as_tensor(lattice, dtype=torch.float64),
            torch.as_tensor(atoms_shifted, dtype=torch.float64,
                            device=own.device),
            num_atoms, lay.origin(s), lay.shape).cpu())
    return torch.where(torch.isfinite(d2), torch.sqrt(d2), 0.0)
