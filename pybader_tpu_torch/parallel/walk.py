"""The neargrid trajectory walk on a device mesh.

Port of :mod:`pybader_tpu.parallel.walk` (``walk_sharded``): the same
``pos`` and ``done`` as the single-device walker, with the density never
gathered onto one device.  JAX gathers each step's operands with a masked
local gather and about five sums of the whole batch across the mesh; here
the owner computes instead:

- each shard builds the exact walk rows of its own voxels
  (:func:`shard_rows`: the ``neargrid_rows`` kernel on its 1-haloed density
  and codes, cropped, with global parents), equal to the whole grid's rows;
- a lane walks on the shard that owns its position, through the resumable
  shard walker (``neargrid_walk_shard``), until it is done, reaches the
  cap, or steps off the shard; the walker reads each shard's stop set as a
  bitmap, built once a call;
- its state (pos, prev, the 3-entry history, dr, steps taken) then moves,
  from the shard that walked it straight to the owner of its new position
  (:func:`hand_off`), which resumes it in the next round; each shard keeps
  its lanes on its own device, and only a lane that ends sends its pos and
  done to the result.

Rounds repeat until no lane is left.  The cap counts steps across
hand-offs, so a lane ends where the single-device walk ends it.
"""
from __future__ import annotations

import torch

from pybader_tpu_torch.ops import neargrid
from pybader_tpu_torch.parallel.mesh import Mesh, Sharded, crop, halo, \
    layout_of, shard


def shard_rows(rho: Sharded, bk: Sharded, t_grad, strict_grad: bool):
    """Every shard's exact walk rows ((lx * ly * nz, 4) f64, its own C
    order), with global parents: the rows kernel on the 1-haloed density
    and codes, cropped."""
    lay = rho.layout
    out = []
    for s, (r, c) in enumerate(zip(halo(rho, 1), halo(bk, 1))):
        rows = neargrid.neargrid_rows(r, c, t_grad, strict_grad)
        rows = crop(rows.view(*r.shape, 4), lay, 1).view(-1, 4)
        rows.view(torch.int32)[:, 6] = lay.parent(bk.blocks[s], s).view(-1)
        out.append(rows)
    return out


def hand_off(lay, lane: torch.Tensor, state, into) -> None:
    """Send lanes to the shards that own their positions: append
    ``(lane, state)`` of the lanes shard t owns to ``into[t]``, on t's
    device.  ``lane``: the lanes' numbers; ``state``:
    :func:`~pybader_tpu_torch.ops.neargrid.shard_state`'s fields.  One
    read of the per-shard counts syncs the host."""
    owner = lay.owner(state[0])
    order = torch.argsort(owner, stable=True)
    counts = torch.bincount(owner, minlength=len(lay.ids)).tolist()
    parts = zip(lane[order].split(counts),
                *(a[order].split(counts) for a in state))
    for t, (dev, (ln, *st)) in enumerate(zip(lay.devices, parts)):
        if ln.numel():
            into[t].append((ln.to(dev, non_blocking=True),
                            tuple(a.to(dev, non_blocking=True) for a in st)))


def gather(parts):
    """The lanes a shard was handed, as one (lane, state)."""
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts]),
            tuple(torch.cat(a) for a in zip(*(p[1] for p in parts))))


def walk_sharded(mesh: Mesh, starts, reference, bk, stop, t_grad,
                 strict_grad: bool = False, max_steps: int = 0, rows=None):
    """Walk one trajectory from each start with the grid sharded over the
    mesh.

    args:
        starts: (K,) int32 global flat start voxels; -1 marks a padding
            lane, born done at voxel 0.
        reference, bk, stop: the f64 density, its uint8 step codes (vacuum
            forced to 13) and the bool stop set (``known == 2``) or None,
            each whole or :class:`Sharded`.
        max_steps: the step cap; 0 means the initial pass's cap.
        rows: :func:`shard_rows` already built for these fields, or None.
    returns (pos (K,) int32, done (K,) bool) on the first shard's device.
    """
    lay = layout_of(mesh, reference)
    shape = lay.shape
    if max_steps == 0:
        max_steps = neargrid.initial_cap(shape)
    if rows is None:
        rows = shard_rows(shard(lay, reference, torch.float64),
                          shard(lay, bk, torch.uint8), t_grad, strict_grad)
    stops = [None] * len(lay.ids) if stop is None else [
        neargrid.stop_bitmap(b, 1)
        for b in shard(lay, stop, torch.bool).blocks]
    home = lay.devices[0]
    starts = torch.as_tensor(starts).to(home).reshape(-1)
    pos = starts.clamp(min=0).to(torch.int32)
    done = starts < 0
    lane = torch.nonzero(~done).reshape(-1)
    held = [[] for _ in lay.ids]
    hand_off(lay, lane, neargrid.shard_state(pos[lane]), held)
    while any(held):
        moving = [[] for _ in lay.ids]
        for s, parts in enumerate(held):
            if not parts:
                continue
            lane, state = gather(parts)
            new, status = neargrid.neargrid_walk_shard(
                rows[s], stops[s], state, lay.origin(s)[:2], lay.local_shape,
                shape, max_steps)
            end = torch.nonzero(status != 0).reshape(-1)
            go = torch.nonzero(status == 0).reshape(-1)
            ended = lane[end].to(home)
            pos[ended] = new[0][end].to(home)
            done[ended] = (status[end] == 1).to(home)
            if go.numel():
                hand_off(lay, lane[go], tuple(a[go] for a in new), moving)
        held = moving
    return pos, done
