"""pybader_tpu_torch — PyTorch/CUDA port of pybader_tpu.

Grid-based Bader charge partitioning (Tang, Sanville & Henkelman, J. Phys.:
Condens. Matter 21, 084204 (2009)) on NVIDIA Hopper GPUs.  The JAX package
``pybader_tpu`` is the reference; every stage here matches its exact f64
path.  Each kernel-backed op dispatches on the device of its input: a CUDA
tensor launches the hand-written kernel built from ``csrc/`` (or raises), a
CPU tensor runs the op's plain PyTorch version.

This package never imports jax.
"""
from pybader_tpu_torch.dunders import (  # noqa: F401
    __author__, __config__, __desc__, __long_desc__, __version__,
)

__doc__ = (__doc__ or "") + "\n" + __desc__ + "\n\n" + __long_desc__
