"""I/O subpackage: density-file readers and writers.

Same contract as :mod:`pybader_tpu.io`: every module exposes
``__extensions__`` (filename fragments to match, or None for object-only),
``__args__`` and ``read(filename, **kw) -> (density_dict, lattice, atoms,
file_info)``.  VASP, cube and gpaw files are read by name; gpaw calculators
and pymatgen VolumetricData objects through each module's ``read_obj``.
"""
from pybader_tpu_torch.io import cube, pymatgen, vasp  # noqa: F401

try:  # gpaw module is importable without gpaw; reader needs it
    from pybader_tpu_torch.io import gpaw  # noqa: F401
except ImportError:  # pragma: no cover
    pass
