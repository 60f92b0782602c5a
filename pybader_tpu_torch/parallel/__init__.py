"""The multi-device path: the grid sharded over a mesh of devices.

Port of :mod:`pybader_tpu.parallel`.  One process drives every shard, as the
JAX package's single-controller ``shard_map`` does: a
:class:`~pybader_tpu_torch.parallel.mesh.Mesh` is a 2-D array of torch
devices, and a device may repeat, so n shards on one card (or on the CPU)
run the whole path there.  Halo slabs move between shards by slicing on one
device and by copies between devices; there is no process group.

- :mod:`.mesh`: the mesh, grid specs, sharded grids, halos;
- :mod:`.chase`: the mesh chase (halo rounds of kernel 9);
- :mod:`.sharded`: the partition, the fused step and the sharded stencils;
- :mod:`.walk`: the owner-computes trajectory walk;
- :mod:`.analysis`: charge sums, relabel and surface distance.
"""
from pybader_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from pybader_tpu_torch.parallel.sharded import (  # noqa: F401
    sharded_partition, sharded_step,
)
