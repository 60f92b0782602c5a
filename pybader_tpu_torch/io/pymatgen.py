"""pymatgen VolumetricData input.

A copy of :mod:`pybader_tpu.io.pymatgen`: the density values are divided
by the cell volume, as the VASP reader divides a CHGCAR's.
"""
from __future__ import annotations

from itertools import groupby

import numpy as np

from pybader_tpu_torch.io.vasp import write

__extensions__ = None  # object-only: never dispatched from a filename
__args__ = ["spin_flag"]


def read_obj(obj, spin_flag=False):
    """Convert a pymatgen VolumetricData object to Bader inputs."""
    density_dict = {}
    charge = obj.data.get("total", None)
    if charge is not None:
        density_dict["charge"] = np.asarray(charge, dtype=np.float64)
    if spin_flag:
        spin = obj.data.get("diff", None)
        if spin is not None:
            density_dict["spin"] = np.asarray(spin, dtype=np.float64)
    vol = obj.structure.lattice.volume
    for key in density_dict:
        density_dict[key] = density_dict[key] / vol
    lattice = np.array(obj.structure.lattice.matrix, dtype=np.float64)
    atoms = np.dot(np.mod(obj.structure.frac_coords, 1), lattice)
    site_types = [site.specie.symbol for site in obj.structure.sites]
    grouped = [(sym, len(list(grp))) for sym, grp in groupby(site_types)]
    atom_types = [sym for sym, _ in grouped]
    atom_nums = np.array([n for _, n in grouped], dtype=np.int64)
    file_info = {
        "filename": "",
        "prefix": "",
        "file_type": "pymatgen object",
        "write_function": write,
        "elements": atom_types,
        "element_nums": atom_nums,
        "spin_flag": spin_flag,
        "voxel_offset": np.zeros(3),
    }
    return density_dict, lattice, atoms, file_info
