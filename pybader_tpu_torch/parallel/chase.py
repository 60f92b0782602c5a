"""The mesh chase: halo rounds of the value chase on every shard.

Port of :mod:`pybader_tpu.parallel.chase` (``sharded_chase``), the lift of
the chase kernel (``ops/pallas_chase.py``) to the device mesh:

- each shard is padded with a one-slab periodic halo from its neighbours
  along the sharded axes (:func:`~pybader_tpu_torch.parallel.mesh.halo`: x
  slabs first, then y slabs of the x-padded block, so the corners ride
  along); a lone shard along an axis is its own neighbour;
- the halo carries the self step code (13), so it is frozen, and a chain
  that leaves the shard ends on the ring, on the neighbour's value;
- the codes, ring included, are the same in every round, so each padded
  block's roots are resolved once a call
  (:func:`~pybader_tpu_torch.ops.chase.chase_roots`), and a round's local
  fixed point is the halo-padded values at the roots: one gather a shard,
  cropped to the interior as it is written
  (:func:`~pybader_tpu_torch.ops.chase.chase_gather`);
- rounds of (exchange, local fixed point) repeat until no shard changed a
  value; the shards' change counts meet on the host, one read a round.

Every intermediate value is a composition of the pointer graph, and the
unique fixed point of each chain is its root's value, so stale halos only
delay convergence.  The local fixed point of a round is the one JAX's
``_local_fixed_point`` reaches, so the rounds are JAX's rounds.
"""
from __future__ import annotations

import torch

from pybader_tpu_torch.grid import SELF_INDEX
from pybader_tpu_torch.ops import chase
from pybader_tpu_torch.parallel.mesh import (
    Layout, Mesh, Sharded, halo, layout_of, shard,
)


def pin_codes(codes: Sharded):
    """Every shard's step codes padded with a frozen ring (code 13) along
    the sharded axes, as JAX's ``_pin_codes``; returns the blocks."""
    lay = codes.layout
    out = []
    for b in codes.blocks:
        for axis in lay.pads:
            ring = list(b.shape)
            ring[axis] = 1
            ring = torch.full(ring, SELF_INDEX, dtype=torch.uint8,
                              device=b.device)
            b = torch.cat([ring, b, ring], axis)
        out.append(b.contiguous())
    return out


def sharded_chase(mesh: Mesh, values, bk, spec=None,
                  max_rounds: int = 1024, stats=None) -> Sharded:
    """Converge ``values`` along the step-code graph on a device mesh.

    args:
        values: int32 (nx, ny, nz) grid, whole or :class:`Sharded`: one-step
            parents (pointer semantics) or a label seed (flood semantics).
        bk: uint8 step codes of the same grid (13 = self).
        spec: a 2-D grid spec; default :func:`grid_spec_2d`.
        stats: a dict, or None; receives ``rounds``, the rounds run (the
            last one changed nothing, or was the ``max_rounds``-th).
    returns the values converged to each voxel's root value, sharded.
    """
    lay: Layout = layout_of(mesh, values, spec)
    vals = shard(lay, values, torch.int32)
    roots = [chase.chase_roots(c)
             for c in pin_codes(shard(lay, bk, torch.uint8))]
    pads = tuple(int(a in lay.pads) for a in (0, 1))
    home = lay.devices[0]
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        blocks, counts = [], []
        for padded, root in zip(halo(vals, 1), roots):
            out, n = chase.chase_gather(padded, root, pads)
            blocks.append(out)
            counts.append(n.to(home, non_blocking=True))
        vals = Sharded(lay, blocks)
        if not int(torch.cat(counts).sum()):
            break
    if stats is not None:
        stats["rounds"] = rounds
    return vals
