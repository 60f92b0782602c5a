"""GPAW calculator / restart-file input.

A copy of :mod:`pybader_tpu.io.gpaw`.  ``read_obj`` is the primary API: it
pulls the all-electron density straight from a live GPAW/ASE calculator,
so no GPAW installation is needed unless reading .gpw restart files.
``read`` imports gpaw when it is called and raises ImportError without it.
"""
from __future__ import annotations

import os

import numpy as np

from pybader_tpu_torch.io.cube import write

try:  # pragma: no cover - gpaw not available in CI
    from gpaw import restart  # noqa: F401
    GPAW_AVAIL = True
except ImportError:
    GPAW_AVAIL = False

__extensions__ = [".gpw"]
__args__ = ["gridref", "spin_flag"]


def read_obj(calc, gridref=4, spin_flag=False, fn="", prefix=""):
    """Build Bader inputs from a GPAW/ASE calculator object.

    args:
        calc: the calculator
        gridref: grid-refinement factor for get_all_electron_density
        spin_flag: also extract the spin density (spin-polarised calcs)
        fn/prefix: provenance strings if this came from a file
    """
    atoms_obj = calc.get_atoms()
    if calc.get_spin_polarized() and spin_flag:
        spin_0 = calc.get_all_electron_density(spin=0, gridrefinement=gridref)
        spin_1 = calc.get_all_electron_density(spin=1, gridrefinement=gridref)
        density_dict = {
            "charge": spin_0 + spin_1,
            "spin": spin_0 - spin_1,
        }
    else:
        density_dict = {
            "charge": calc.get_all_electron_density(gridrefinement=gridref)
        }
    lattice = np.array(atoms_obj.cell[:], dtype=np.float64)
    atoms = np.dot(
        np.array(atoms_obj.get_scaled_positions(), dtype=np.float64), lattice
    )
    file_info = {
        "filename": fn,
        "prefix": prefix,
        "file_type": "gpaw",
        "write_function": write,
        "elements": atoms_obj.get_atomic_numbers(),
        "voxel_offset": np.zeros(3),
    }
    return density_dict, lattice, atoms, file_info


def read(fn, gridref=4, spin_flag=False):
    """Read from a GPAW restart file (requires gpaw)."""
    from gpaw import restart

    prefix, filename = os.path.split(fn)
    prefix = os.path.join(prefix, "")
    _, calc = restart(fn)
    return read_obj(calc, gridref, spin_flag, filename, prefix)
