"""Device meshes, grid specs and sharded grids.

A :class:`Mesh` is a 2-D array of torch devices with the axis names
``("x", "y")``, the shape of a ``jax.sharding.Mesh``.  A device may repeat:
n shards on one card run the whole mesh path on that card (the virtual mesh
of the tests, on the CPU, and of ``chip_smoke.py``); on a host with several
cards each shard sits on its own card.  One process drives every shard, as
the JAX package's single-controller ``shard_map`` does.

A grid is sharded on its two leading axes by :func:`grid_spec_2d`; z stays
whole.  A :class:`Sharded` grid holds one tensor a distinct shard, on the
shard's device; an axis the spec leaves unsharded is replicated in JAX and
held once here.  Stencils run on shards padded with halos from their
neighbours (:func:`halo`): slices between shards on one device, copies
between devices.
"""
from __future__ import annotations

import numpy as np
import torch

AXES = ("x", "y")


class Mesh:
    """``devices``: 2-D array of ``torch.device``; ``axis_names``: the names
    of its two axes."""

    def __init__(self, devices, axis_names=AXES):
        self.devices = np.empty(np.shape(devices), dtype=object)
        self.devices[...] = devices
        if self.devices.ndim != 2:
            raise ValueError(f"a mesh is 2-D, got shape {self.devices.shape}")
        self.axis_names = tuple(axis_names)

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.devices.shape))}, "
                f"{sorted({str(d) for d in self.devices.flat})})")


def is_multi(mesh) -> bool:
    """True for a mesh of more than one shard (a one-shard mesh takes the
    single-device path, as in JAX)."""
    return mesh is not None and mesh.devices.size > 1


def _factor2(n: int):
    """n -> (a, b), a*b == n, as square as possible."""
    a = int(np.sqrt(n))
    while n % a:
        a -= 1
    return max(a, 1), n // max(a, 1)


def make_mesh(n_devices: int | None = None, device=None,
              axis_names=AXES) -> Mesh:
    """An a x b mesh of ``n_devices`` shards, as square as possible.

    With ``device`` ("cpu", "cuda", ...) every shard sits on that one
    device (``n_devices`` defaults to 1).  Without it the shards take the
    first ``n_devices`` CUDA devices (default: all), and fewer raise.
    """
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs = [dev] * (n_devices or 1)
    else:
        have = torch.cuda.device_count()
        n = have if n_devices is None else n_devices
        if n < 1 or n > have:
            raise ValueError(f"make_mesh({n_devices}): {have} CUDA devices; "
                             f"pass device= for shards on one device")
        devs = [torch.device("cuda", i) for i in range(n)]
    a, b = _factor2(len(devs))
    return Mesh(np.asarray(devs, dtype=object).reshape(a, b), axis_names)


def choose_grid_spec(mesh: Mesh, shape):
    """JAX's ``choose_grid_spec``: the first spec of the candidates whose
    sharded dimensions divide by their mesh factors (a tuple entry shards
    over several axes); () replicates."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    x, y = mesh.axis_names

    def ok(spec):
        for dim, s in zip(shape, spec):
            if s is None:
                continue
            axes = s if isinstance(s, tuple) else (s,)
            if dim % int(np.prod([sizes[a] for a in axes])):
                return False
        return True

    candidates = [
        (x, y, None), (y, x, None),
        ((x, y), None, None), (None, (x, y), None),
        (None, None, (x, y)),
        (x, None, None), (y, None, None),
        (None, x, None), (None, y, None),
        (),
    ]
    for spec in candidates:
        if ok(spec):
            return spec
    return ()


def grid_spec_2d(mesh: Mesh, shape):
    """JAX's ``grid_spec_2d``: shard the two leading axes over the mesh
    axes, z whole; an axis whose extent the factor does not divide stays
    unsharded, and the transposed assignment is tried before giving up."""
    x, y = mesh.axis_names
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    sx = x if shape[0] % sizes[x] == 0 else None
    sy = y if shape[1] % sizes[y] == 0 else None
    if sx is None and sy is None:
        sx = y if shape[0] % sizes[y] == 0 else None
        sy = x if shape[1] % sizes[x] == 0 else None
    return (sx, sy, None)


class Layout:
    """How a grid of ``shape`` splits over ``mesh`` by a 2-D ``spec``.

    Shards are numbered in C order over their (i, j) place along the two
    leading axes -- JAX's device-linear order over the axes the spec
    shards.  ``pads``: the sharded axes, which take halos; a lone shard
    along a sharded axis is its own neighbour."""

    def __init__(self, mesh: Mesh, shape, spec=None):
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)
        self.spec = grid_spec_2d(mesh, shape) if spec is None else tuple(spec)
        if len(self.spec) != 3 or self.spec[2] is not None or any(
                isinstance(e, tuple) for e in self.spec):
            raise ValueError(f"expected a 2-D grid spec, got {self.spec}")
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        self.counts = tuple(1 if e is None else sizes[e]
                            for e in self.spec[:2])
        self.pads = tuple(a for a in (0, 1) if self.spec[a] is not None)
        nx, ny, nz = self.shape
        self.local_shape = (nx // self.counts[0], ny // self.counts[1], nz)
        self.ids = [(i, j) for i in range(self.counts[0])
                    for j in range(self.counts[1])]
        self.devices = []
        for i, j in self.ids:
            at = dict.fromkeys(mesh.axis_names, 0)
            for entry, k in zip(self.spec[:2], (i, j)):
                if entry is not None:
                    at[entry] = k
            self.devices.append(mesh.devices[tuple(
                at[a] for a in mesh.axis_names)])

    def origin(self, s: int):
        """Global (x, y, z) of shard s's first voxel."""
        i, j = self.ids[s]
        return (i * self.local_shape[0], j * self.local_shape[1], 0)

    def owner(self, flat: torch.Tensor) -> torch.Tensor:
        """The shard number of each global flat index (int64)."""
        _, ny, nz = self.shape
        f = flat.long()
        i = (f // (ny * nz)) // self.local_shape[0]
        j = ((f // nz) % ny) // self.local_shape[1]
        return i * self.counts[1] + j

    def local(self, flat: torch.Tensor, s: int) -> torch.Tensor:
        """Shard s's flat index of global flat indices it owns (int64)."""
        _, ny, nz = self.shape
        lx, ly, _ = self.local_shape
        ox, oy, _ = self.origin(s)
        f = flat.long()
        return ((f // (ny * nz) - ox) * ly + ((f // nz) % ny - oy)) * nz \
            + f % nz

    def to_global(self, local: torch.Tensor, s: int) -> torch.Tensor:
        """Global flat index (int64) of shard s's local flat indices.  One
        x/y box with z whole keeps C order, so a local minimum is the
        global minimum of the shard's voxels."""
        _, ny, nz = self.shape
        _, ly, _ = self.local_shape
        ox, oy, _ = self.origin(s)
        f = local.long()
        return ((f // (ly * nz) + ox) * ny + (f // nz) % ly + oy) * nz \
            + f % nz

    def global_index(self, s: int) -> torch.Tensor:
        """Global flat index of every voxel of shard s, int32, on its
        device."""
        _, ny, nz = self.shape
        lx, ly, _ = self.local_shape
        ox, oy, _ = self.origin(s)
        dev = self.devices[s]
        x = torch.arange(ox, ox + lx, device=dev).view(-1, 1, 1)
        y = torch.arange(oy, oy + ly, device=dev).view(1, -1, 1)
        z = torch.arange(nz, device=dev).view(1, 1, -1)
        return ((x * ny + y) * nz + z).to(torch.int32)

    def parent(self, codes: torch.Tensor, s: int) -> torch.Tensor:
        """Global flat int32 one-step pointers of shard s's step codes,
        wrapping on the whole grid (``parent_from_step_codes`` of the
        whole grid, restricted to the shard)."""
        nx, ny, nz = self.shape
        lx, ly, _ = self.local_shape
        ox, oy, _ = self.origin(s)
        dev = codes.device
        c = codes.long()
        x = torch.arange(ox, ox + lx, device=dev).view(-1, 1, 1)
        y = torch.arange(oy, oy + ly, device=dev).view(1, -1, 1)
        z = torch.arange(nz, device=dev).view(1, 1, -1)
        px = torch.remainder(x + c // 9 - 1, nx)
        py = torch.remainder(y + (c // 3) % 3 - 1, ny)
        pz = torch.remainder(z + c % 3 - 1, nz)
        return ((px * ny + py) * nz + pz).to(torch.int32)


class Sharded:
    """A grid held as one tensor a shard (``blocks``, in shard order), each
    on its shard's device."""

    def __init__(self, layout: Layout, blocks):
        self.layout = layout
        self.blocks = list(blocks)

    @property
    def shape(self):
        return self.layout.shape

    @property
    def dtype(self):
        return self.blocks[0].dtype

    def map(self, fn) -> "Sharded":
        """``fn(block)`` on every shard."""
        return Sharded(self.layout, [fn(b) for b in self.blocks])

    def join(self, device="cpu") -> torch.Tensor:
        """The whole grid on one device (default the host)."""
        lay = self.layout
        out = torch.empty(lay.shape, dtype=self.dtype, device=device)
        lx, ly, _ = lay.local_shape
        for (i, j), b in zip(lay.ids, self.blocks):
            out[i * lx:(i + 1) * lx, j * ly:(j + 1) * ly] = b.to(device)
        return out


def shard(layout: Layout, full, dtype=None) -> Sharded:
    """Split a whole grid (numpy or a tensor on any device) into fresh
    contiguous shards on their devices; a :class:`Sharded` grid of this
    layout passes through."""
    if isinstance(full, Sharded):
        if full.layout.shape != layout.shape or \
                full.layout.spec != layout.spec:
            raise ValueError("a sharded grid of another layout")
        return full if dtype is None else full.map(lambda b: b.to(dtype))
    t = torch.as_tensor(full)
    if tuple(t.shape) != layout.shape:
        raise ValueError(f"expected a {layout.shape} grid, got "
                         f"{tuple(t.shape)}")
    lx, ly, _ = layout.local_shape
    blocks = []
    for (i, j), dev in zip(layout.ids, layout.devices):
        part = t[i * lx:(i + 1) * lx, j * ly:(j + 1) * ly]
        blocks.append(torch.empty(part.shape, dtype=dtype or t.dtype,
                                  device=dev).copy_(part))
    return Sharded(layout, blocks)


def halo(grid: Sharded, width: int):
    """Every shard padded with ``width``-voxel periodic halos from its
    neighbours along the sharded axes: x slabs first, then y slabs of the
    x-padded blocks, so the corners ride along (JAX's ``_exchange``).
    returns the padded blocks, in shard order."""
    lay = grid.layout
    blocks = dict(zip(lay.ids, grid.blocks))
    for axis in lay.pads:
        if width > lay.local_shape[axis]:
            raise ValueError(f"a {width}-voxel halo needs shards at least "
                             f"that thick; axis {axis} has "
                             f"{lay.local_shape[axis]}")
        di, dj = (1, 0) if axis == 0 else (0, 1)
        ci, cj = lay.counts
        padded = {}
        for s, (i, j) in enumerate(lay.ids):
            prev = blocks[((i - di) % ci, (j - dj) % cj)]
            nxt = blocks[((i + di) % ci, (j + dj) % cj)]
            dev = lay.devices[s]
            lo = prev.narrow(axis, prev.shape[axis] - width, width)
            hi = nxt.narrow(axis, 0, width)
            padded[(i, j)] = torch.cat(
                [lo.to(dev, non_blocking=True), blocks[(i, j)],
                 hi.to(dev, non_blocking=True)], axis)
        blocks = padded
    return [blocks[ij] for ij in lay.ids]


def crop(block: torch.Tensor, layout: Layout, width: int) -> torch.Tensor:
    """The interior of a block padded by :func:`halo` (contiguous)."""
    for axis in layout.pads:
        block = block.narrow(axis, width, block.shape[axis] - 2 * width)
    return block.contiguous()


def layout_of(mesh: Mesh, grid, spec=None) -> Layout:
    """The layout of a :class:`Sharded` grid, or :func:`grid_spec_2d`'s
    (or ``spec``'s) for a whole one."""
    if isinstance(grid, Sharded):
        return grid.layout
    return Layout(mesh, tuple(grid.shape), spec)


def take(grid: Sharded, flat: torch.Tensor) -> torch.Tensor:
    """The grid's values at global flat indices, on ``flat``'s device: each
    shard gathers the indices it owns."""
    lay = grid.layout
    owner = lay.owner(flat)
    out = torch.empty(flat.shape, dtype=grid.dtype, device=flat.device)
    for s, block in enumerate(grid.blocks):
        m = owner == s
        if bool(m.any()):
            li = lay.local(flat[m], s).to(block.device)
            out[m] = block.reshape(-1)[li].to(flat.device)
    return out


def put(grid: Sharded, flat: torch.Tensor, values: torch.Tensor) -> None:
    """Write ``values`` at distinct global flat indices, in place: each
    shard scatters the indices it owns."""
    lay = grid.layout
    owner = lay.owner(flat)
    for s, block in enumerate(grid.blocks):
        m = owner == s
        if bool(m.any()):
            li = lay.local(flat[m], s).to(block.device)
            block.view(-1)[li] = values[m].to(block.device, block.dtype)
