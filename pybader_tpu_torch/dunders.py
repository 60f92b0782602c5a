"""Package metadata and platform-dependent config path.

Same metadata surface as :mod:`pybader_tpu.dunders`, for the PyTorch/CUDA
port.  The port keeps its own config file so the two packages never
rewrite each other's profiles.
"""
import os
from sys import platform

__pkgname__ = "pybader_tpu_torch"
__version__ = "0.1.0"
__author__ = "pybader-tpu developers"
__url__ = "https://github.com/pybader-tpu/pybader-tpu"
__desc__ = "PyTorch/CUDA grid-based Bader charge analysis."
__long_desc__ = """Grid-based Bader charge analysis based on methods presented
in W. Tang, E. Sanville, and G. Henkelman, 'A grid-based Bader analysis
algorithm without lattice bias', J. Phys.: Condens. Matter 21, 084204 (2009).
PyTorch port of pybader_tpu for NVIDIA Hopper GPUs: the ascent stencil, root
resolution, per-label reductions, edge classification and the neargrid
trajectory walker are hand-written CUDA kernels; every kernel keeps a plain
PyTorch version that CPU tensors run.
"""

if platform == "win32":  # pragma: no cover - platform specific
    __config__ = os.path.join(
        os.getenv("LOCALAPPDATA", os.path.expanduser("~")),
        "pybader_tpu_torch", "config.ini",
    )
else:
    __config__ = os.path.expanduser(
        os.path.join("~", ".config", "bader-tpu-torch", "config.ini")
    )
