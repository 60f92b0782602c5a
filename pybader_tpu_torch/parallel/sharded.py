"""The partition on a device mesh, and the stencils it shares.

Port of :mod:`pybader_tpu.parallel.sharded` (``sharded_partition``,
``sharded_step``, ``_seed_local``).  The grid is split on its two leading
axes (:func:`~pybader_tpu_torch.parallel.mesh.grid_spec_2d`) and every
stage runs on each shard, on its device:

- stencils run on shards padded with halos as wide as they reach: one voxel
  for the step codes, two for ``edge_find`` / ``edge_check``, which dilate
  the edge set; the padded result is cropped;
- the labels flood by the mesh chase from a per-shard seed;
- the discovery-order renumber takes ``min_pair`` per shard, turns each
  shard's minimum into a global flat index (one x/y box with z whole keeps
  C order), takes the minimum across shards on the host and remaps each
  shard.

No stage gathers a grid onto one device.
"""
from __future__ import annotations

import numpy as np
import torch

from pybader_tpu_torch.grid import SELF_INDEX
from pybader_tpu_torch.ops import chase, reductions
from pybader_tpu_torch.ops.edges import edge_check, edge_find
from pybader_tpu_torch.ops.stencil import ongrid_step_codes
from pybader_tpu_torch.parallel.chase import sharded_chase
from pybader_tpu_torch.parallel.mesh import (
    Layout, Mesh, Sharded, crop, halo, shard,
)

_INT32_MAX = int(np.iinfo(np.int32).max)


def step_codes(rho: Sharded, weights, vacuum: Sharded | None = None):
    """Ascent step codes of every shard (the stencil on its 1-haloed
    density), vacuum forced to the self step."""
    lay = rho.layout
    blocks = [crop(ongrid_step_codes(p, weights), lay, 1)
              for p in halo(rho, 1)]
    if vacuum is not None:
        blocks = [torch.where(v, SELF_INDEX, b).to(torch.uint8)
                  for b, v in zip(blocks, vacuum.blocks)]
    return Sharded(lay, blocks)


def edges_find(labels: Sharded, is_max: Sharded) -> Sharded:
    """``edge_find`` on every shard's 2-haloed labels and maxima."""
    lay = labels.layout
    return Sharded(lay, [
        crop(edge_find(None, lab, mx), lay, 2)
        for lab, mx in zip(halo(labels, 2), halo(is_max, 2))])


def edges_check(known: Sharded, labels: Sharded, is_max: Sharded) -> Sharded:
    """``edge_check`` on every shard's 2-haloed known, labels and maxima."""
    lay = labels.layout
    return Sharded(lay, [
        crop(edge_check(kn, lab, mx), lay, 2)
        for kn, lab, mx in zip(halo(known, 2), halo(labels, 2),
                               halo(is_max, 2))])


def _seed_local(bk: Sharded, vac: Sharded | None):
    """Flood seeds per shard (:func:`~pybader_tpu_torch.ops.chase.
    flood_seed`): maxima get a 1-based rank, with rank offsets in the
    shards' C order over the sharded axes (JAX's device-linear order), and
    vacuum the sentinel M + 1 of the whole mesh.  returns (seed, is_max,
    M)."""
    vacs = [None] * len(bk.blocks) if vac is None else vac.blocks
    is_max = Sharded(bk.layout, [chase.maxima_mask(b, v)
                                 for b, v in zip(bk.blocks, vacs)])
    counts = [int(m.sum()) for m in is_max.blocks]
    n_max = sum(counts)
    offsets = np.cumsum([0] + counts[:-1])
    seeds = [chase.flood_seed(m, v, int(o), n_max)[0]
             for m, v, o in zip(is_max.blocks, vacs, offsets)]
    return Sharded(bk.layout, seeds), is_max, n_max


def renumber_discovery(labels_mo: Sharded, is_max: Sharded, n_max: int):
    """The discovery-order renumber across shards (the single-device
    ``renumber_discovery`` on a mesh).  returns (labels, maxima (M, 3)
    int64 numpy)."""
    lay = labels_mo.layout
    _, ny, nz = lay.shape
    first = torch.full((n_max,), _INT32_MAX, dtype=torch.int64)
    max_pos = first.clone()
    for s, (lab, mx) in enumerate(zip(labels_mo.blocks, is_max.blocks)):
        for acc, local in zip((first, max_pos),
                              reductions.min_pair(lab, mx, n_max)):
            local = local.cpu()
            g = torch.where(local == _INT32_MAX, _INT32_MAX,
                            lay.to_global(local, s))
            torch.minimum(acc, g, out=acc)
    order = np.argsort(first.numpy(), kind="stable").astype(np.int32)
    rank = np.argsort(order, kind="stable").astype(np.int32)
    labels = Sharded(lay, [
        reductions.remap_labels(b, torch.as_tensor(rank, device=b.device),
                                n_max) for b in labels_mo.blocks])
    max_flat = max_pos.numpy()[order]
    maxima = np.stack(
        [max_flat // (ny * nz), (max_flat // nz) % ny, max_flat % nz],
        axis=1).astype(np.int64)
    return labels, maxima


def sharded_partition(mesh: Mesh, reference, vacuum, weights):
    """Labelled ongrid partition on a device mesh, discovery-order
    numbering: step codes per shard, per-shard flood seed, the mesh chase,
    the renumber.  Labels equal the single-device partition's.

    ``reference`` (f64) and ``vacuum`` (bool or None): whole grids (numpy
    or tensors) or :class:`Sharded`.  returns (labels :class:`Sharded`
    int32, maxima (M, 3) int64 numpy)."""
    lay = Layout(mesh, tuple(reference.shape))
    rho = shard(lay, reference, torch.float64)
    vac = None if vacuum is None else shard(lay, vacuum, torch.bool)
    bk = step_codes(rho, weights, vac)
    seed, is_max, n_dev = _seed_local(bk, vac)
    n_max = max(n_dev, 1)
    out = sharded_chase(mesh, seed, bk)
    labels_mo = out.map(lambda b: chase.flood_decode(b, n_max))
    return renumber_discovery(labels_mo, is_max, n_max)


def sharded_step(mesh: Mesh, density, weights, num_buckets: int = 128):
    """The fused partition step of JAX's ``sharded_step``: each voxel's
    root (the mesh chase with pointer semantics), the maxima count, and
    the density summed into ``root % num_buckets`` buckets (the
    ``charge_volume`` kernel per shard, summed across shards).  returns
    (roots :class:`Sharded` int32, n_maxima, charge f64 (num_buckets,) on
    the host)."""
    lay = Layout(mesh, tuple(density.shape))
    rho = shard(lay, density, torch.float64)
    bk = step_codes(rho, weights)
    parent = Sharded(lay, [lay.parent(b, s) for s, b in enumerate(bk.blocks)])
    roots = sharded_chase(mesh, parent, bk)
    n_max = sum(int((r == lay.global_index(s)).sum())
                for s, r in enumerate(roots.blocks))
    charge = torch.zeros(num_buckets, dtype=torch.float64)
    for r, d in zip(roots.blocks, rho.blocks):
        buckets = torch.remainder(r, num_buckets).to(torch.int32)
        charge += reductions.charge_volume(d, buckets, num_buckets)[0].cpu()
    return roots, n_max, charge
