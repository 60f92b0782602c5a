"""Lattice / voxel geometry for periodic density grids.

Pure host-side numpy: these are tiny 3x3 computations evaluated once per
density file and handed to the device stages as scalars or small tensors.

A copy of :mod:`pybader_tpu.grid` (importing that package would import
jax).  Formula parity with the reference pybader implementation:
 - distance weights:  interface.py:243-259
 - voxel lattice/volume: interface.py:261-271
 - gradient transform T_grad: interface.py:286-290
 - fractional/cartesian conversions: interface.py:307-334
"""
from __future__ import annotations

import numpy as np

# Scan order of the 26-neighbourhood used EVERYWHERE in this package.  This
# order is semantic: the reference kernels scan neighbours with nested
# ix, iy, iz in (-1, 0, 1) loops and break ties by first-strictly-greater
# (reference methods.py:87-117), so label parity requires the identical order.
OFFSETS = tuple(
    (ix, iy, iz)
    for ix in (-1, 0, 1)
    for iy in (-1, 0, 1)
    for iz in (-1, 0, 1)
)
SELF_INDEX = OFFSETS.index((0, 0, 0))  # == 13


def lattice_volume(lattice: np.ndarray) -> float:
    """Absolute volume of the periodic cell (rows are lattice vectors)."""
    return float(abs(np.dot(lattice[0], np.cross(lattice[1], lattice[2]))))


def voxel_lattice(lattice: np.ndarray, shape) -> np.ndarray:
    """Lattice describing a single voxel."""
    return np.divide(lattice, np.asarray(shape, dtype=np.float64)[:, None])


def voxel_volume(lattice: np.ndarray, shape) -> float:
    """Volume of a single voxel."""
    return lattice_volume(lattice) / float(np.prod(shape))


def distance_weights(lattice: np.ndarray, shape) -> np.ndarray:
    """Inverse step lengths for each of the 27 offsets, in OFFSETS order.

    weight(step) = 1 / |ix*a_vox + iy*b_vox + iz*c_vox| and 0 for the null
    step, matching the reference's rank-3 ``distance_matrix`` tensor
    (interface.py:243-259, indexed there with the -1 == index 2 trick).
    """
    vl = voxel_lattice(lattice, shape)
    w = np.zeros(len(OFFSETS), dtype=np.float64)
    for k, (ix, iy, iz) in enumerate(OFFSETS):
        v = ix * vl[0] + iy * vl[1] + iz * vl[2]
        n = np.sqrt(np.dot(v, v))
        w[k] = 0.0 if n == 0.0 else 1.0 / n
    return w


def distance_matrix(lattice: np.ndarray, shape) -> np.ndarray:
    """Reference-convention (3,3,3) distance tensor.

    Index i in {0,1,2} means a step of {0,+1,-1}: ``d[1,0,0]`` is a +x step
    and ``d[2,0,0]`` (also addressable as ``d[-1,0,0]``) a -x step.
    """
    d = np.zeros((3, 3, 3), dtype=np.float64)
    conv = {0: 0, 1: 1, 2: -1}
    vl = voxel_lattice(lattice, shape)
    for i in range(3):
        for j in range(3):
            for k in range(3):
                v = conv[i] * vl[0] + conv[j] * vl[1] + conv[k] * vl[2]
                n = np.sqrt(np.dot(v, v))
                d[i, j, k] = 0.0 if n == 0.0 else 1.0 / n
    return d


def t_grad(lattice: np.ndarray, shape) -> np.ndarray:
    """Transform taking a finite-difference gradient to voxel-index steps."""
    inv_l = np.linalg.inv(voxel_lattice(lattice, shape))
    return np.matmul(inv_l.T, inv_l)


def voxel_to_fractional(voxels: np.ndarray, shape, voxel_offset_frac) -> np.ndarray:
    """Voxel indices -> fractional cell coordinates (ref interface.py:318-324)."""
    out = np.add(voxels, np.asarray(voxel_offset_frac, dtype=np.float64))
    return np.divide(out, np.asarray(shape, dtype=np.float64))


def fractional_to_cartesian(frac: np.ndarray, lattice: np.ndarray) -> np.ndarray:
    return np.dot(frac, lattice)


def cartesian_to_fractional(cart: np.ndarray, lattice: np.ndarray) -> np.ndarray:
    return np.dot(cart, np.linalg.inv(lattice))
