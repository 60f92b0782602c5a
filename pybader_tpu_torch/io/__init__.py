"""I/O subpackage: density-file readers and writers.

Same contract as :mod:`pybader_tpu.io`: every module exposes
``__extensions__``, ``__args__`` and ``read(filename, **kw) -> (density_dict,
lattice, atoms, file_info)``.  VASP and cube are ported; gpaw and pymatgen
are later work (ROADMAP Queue 1).
"""
from pybader_tpu_torch.io import cube, vasp  # noqa: F401
