"""The value chase along ascent step codes (Pallas kernel 9).

Port of :mod:`pybader_tpu.ops.pallas_chase`: the chase the Pallas kernel
runs (``_run_chase`` / ``_chase_sweep_impl``) and its two callers,
``resolve_roots_pallas`` (pointer semantics: values are one-step parents,
the fixed point is each voxel's root) and ``labels_oneshot`` (label
flooding: maxima seeded with their 1-based rank, the fixed point is each
voxel's root's label), with ``step_code_from_parent`` and the
``_flood_seed`` / ``_flood_decode`` contract.

The TPU kernel composes values by roll-select passes over VMEM tiles;
``csrc/chase.cu`` finds each voxel's root from the codes instead
(:func:`chase_roots`) and gathers the values there (:func:`chase_gather`),
which reaches the same fixed point on any acyclic code graph.  The mesh
chase (:mod:`pybader_tpu_torch.parallel.chase`) resolves each haloed
shard's roots once a call and runs one gather a round.
"""
from __future__ import annotations

import ctypes

import torch

from pybader_tpu_torch.grid import OFFSETS, SELF_INDEX
from pybader_tpu_torch.ops import _cuda
from pybader_tpu_torch.ops.pointer import _JUMP_FLAGS, _MAX_PASSES, \
    resolve_roots_plain
from pybader_tpu_torch.ops.stencil import parent_from_step_codes


def chase(values: torch.Tensor, best_k: torch.Tensor):
    """Fixed point of ``out[i] = values[i + OFFSETS[best_k[i]]]`` on the
    array given, with periodic wrap (code 13, the self step, freezes a
    voxel).  ``values``: int32 grid; ``best_k``: uint8 step codes of the
    same shape.  returns (out int32 grid, the number of voxels whose value
    changed).  A CUDA tensor runs ``csrc/chase.cu``: :func:`chase_roots`,
    then :func:`chase_gather`."""
    if _cuda.on_cuda(values):
        return chase_cuda(values, best_k)
    return chase_plain(values, best_k)


def _one_pass(vals, best_k):
    """One composition step, JAX's ``parallel.chase._one_pass``: the
    neighbour value each code selects, by 27-way roll-select."""
    out = vals
    for k, (ox, oy, oz) in enumerate(OFFSETS):
        if k == SELF_INDEX:
            continue
        out = torch.where(best_k == k, torch.roll(
            vals, (-ox, -oy, -oz), (0, 1, 2)), out)
    return out


def chase_plain(values, best_k):
    """Roll-select passes until nothing changes, as JAX's
    ``parallel.chase._local_fixed_point``."""
    v = values
    while True:
        nv = _one_pass(v, best_k)
        if torch.equal(nv, v):
            break
        v = nv
    return v.to(torch.int32), int((v != values).sum())


def chase_cuda(values, best_k):
    """The chase on the card: the roots of ``best_k``, then one gather of
    ``values`` (two launches, counted by their wrappers)."""
    _cuda.check(values, torch.int32, "values")
    if values.dim() != 3:
        raise ValueError(f"values: expected a 3-D grid, got "
                         f"{tuple(values.shape)}")
    _cuda.check(best_k, torch.uint8, "best_k", values.shape)
    out, changed = chase_gather_cuda(values, chase_roots_cuda(best_k))
    return out, int(changed)


def chase_roots(best_k: torch.Tensor) -> torch.Tensor:
    """Each voxel's root along the step codes, with periodic wrap: the
    flat index (int32, ``best_k``'s shape) of the code-13 voxel its chain
    ends on, so that the chase's fixed point is ``values[root]``.  A CUDA
    tensor runs ``csrc/chase.cu``."""
    if _cuda.on_cuda(best_k):
        return chase_roots_cuda(best_k)
    return chase_roots_plain(best_k)


def chase_roots_plain(best_k):
    """Pointer doubling on the codes' one-step parents."""
    return resolve_roots_plain(parent_from_step_codes(best_k))


def chase_roots_cuda(best_k, stats=None):
    """Launch ``pb_chase_roots`` (csrc/chase.cu): the tile pass from the
    codes, then the global jump passes.  ``stats['passes']``: the jump
    passes after the tile pass."""
    _cuda.check(best_k, torch.uint8, "best_k")
    if best_k.dim() != 3:
        raise ValueError(f"best_k: expected a 3-D grid, got "
                         f"{tuple(best_k.shape)}")
    root = torch.empty(best_k.shape, dtype=torch.int32, device=best_k.device)
    flags = torch.empty((_JUMP_FLAGS,), dtype=torch.int32,
                        device=best_k.device)
    passes = ctypes.c_int(0)
    try:
        _cuda.call("pb_chase_roots", best_k.data_ptr(), root.data_ptr(),
                   *best_k.shape, flags.data_ptr(), _MAX_PASSES,
                   ctypes.addressof(passes), best_k.device.index or 0,
                   _cuda.stream(best_k))
    except _cuda.KernelError as e:
        if e.code == -1:
            raise RuntimeError(
                f"the chase did not converge in {_MAX_PASSES} jump passes "
                f"-- is the code graph acyclic?") from e
        raise
    _cuda.launches["chase_roots"] += 1
    if stats is not None:
        stats["passes"] = passes.value
    return root


def chase_gather(values: torch.Tensor, root: torch.Tensor, pads=(0, 0)):
    """One gather of the chase: ``values`` at ``root`` (the roots of
    :func:`chase_roots`, flat indices into ``values``), cropped by
    ``pads`` = (px, py) voxels at both ends of x and y (the ring a mesh
    shard is padded with).  returns (out int32 of the cropped shape, the
    number of its voxels whose value changed as a one-element int32 tensor
    on the values' device, so that a caller reads several at once).  A
    CUDA tensor runs ``csrc/chase.cu``."""
    if _cuda.on_cuda(values):
        return chase_gather_cuda(values, root, pads)
    return chase_gather_plain(values, root, pads)


def _crop(grid, pads):
    px, py = pads
    return grid[px:grid.shape[0] - px, py:grid.shape[1] - py]


def chase_gather_plain(values, root, pads=(0, 0)):
    """Index the flat values with the roots, crop, compare."""
    out = _crop(values.reshape(-1)[root.long()], pads).contiguous()
    changed = (out != _crop(values, pads)).sum()
    return out, changed.to(torch.int32).reshape(1)


def chase_gather_cuda(values, root, pads=(0, 0)):
    """Launch ``pb_chase_gather`` (csrc/chase.cu); the change count is
    read by the caller."""
    _cuda.check(values, torch.int32, "values")
    if values.dim() != 3:
        raise ValueError(f"values: expected a 3-D grid, got "
                         f"{tuple(values.shape)}")
    _cuda.check(root, torch.int32, "root", values.shape)
    px, py = (int(p) for p in pads)
    nx, ny, nz = values.shape
    if px < 0 or py < 0 or 2 * px > nx or 2 * py > ny:
        raise ValueError(f"pads: expected 0 <= 2 * pad <= ({nx}, {ny}), got "
                         f"{tuple(pads)}")
    out = torch.empty((nx - 2 * px, ny - 2 * py, nz), dtype=torch.int32,
                      device=values.device)
    count = torch.empty((1,), dtype=torch.int32, device=values.device)
    _cuda.call("pb_chase_gather", values.data_ptr(), root.data_ptr(),
               out.data_ptr(), count.data_ptr(), *out.shape, px, py,
               values.device.index or 0, _cuda.stream(values))
    _cuda.launches["chase_gather"] += 1
    return out, count


def step_code_from_parent(parent: torch.Tensor) -> torch.Tensor:
    """The OFFSETS step code (uint8) of each voxel's one-step pointer."""
    nx, ny, nz = parent.shape
    dev = parent.device
    p = parent.long()
    x = torch.arange(nx, device=dev).view(-1, 1, 1)
    y = torch.arange(ny, device=dev).view(1, -1, 1)
    z = torch.arange(nz, device=dev).view(1, 1, -1)
    ox = torch.remainder(p // (ny * nz) - x + 1, nx) - 1
    oy = torch.remainder((p // nz) % ny - y + 1, ny) - 1
    oz = torch.remainder(p % nz - z + 1, nz) - 1
    return ((ox + 1) * 9 + (oy + 1) * 3 + (oz + 1)).to(torch.uint8)


def resolve_roots_chase(parent: torch.Tensor,
                        best_k: torch.Tensor | None = None) -> torch.Tensor:
    """Each voxel's root by chasing one-step pointers (JAX's
    ``resolve_roots_pallas``).  ``parent``: int32 flat one-step pointers;
    ``best_k``: their step codes, derived from ``parent`` when None.  The
    single-device pipeline resolves roots with
    :func:`~pybader_tpu_torch.ops.pointer.resolve_roots`; this mirrors the
    JAX API, and the mesh runs :func:`chase` itself."""
    if best_k is None:
        best_k = step_code_from_parent(parent)
    return chase(parent.to(torch.int32).contiguous(), best_k)[0]


def maxima_mask(best_k: torch.Tensor, vacuum: torch.Tensor | None = None):
    """The flood's maxima: code 13 and not vacuum."""
    is_max = best_k == SELF_INDEX
    return is_max if vacuum is None else is_max & ~vacuum


def flood_seed(is_max: torch.Tensor, vacuum: torch.Tensor | None = None,
               offset: int = 0, n_max: int | None = None):
    """JAX's ``_flood_seed``: 0 unlabelled, ``offset`` + k on the k-th
    maximum in ascending flat order, M + 1 on vacuum.  A shard of a mesh
    passes the maxima of the shards before it as ``offset`` and the mesh's
    M as ``n_max`` (default: this grid's).  returns (seed int32 grid,
    M)."""
    if n_max is None:
        n_max = int(is_max.sum())
    seed = torch.where(is_max, offset + torch.cumsum(
        is_max.reshape(-1), 0).reshape(is_max.shape), 0)
    if vacuum is not None:
        seed = torch.where(vacuum, n_max + 1, seed)
    return seed.to(torch.int32), n_max


def flood_decode(out: torch.Tensor, n_max: int) -> torch.Tensor:
    """JAX's ``_flood_decode``: flooded values -> 0-based labels, the
    vacuum sentinel M + 1 -> -1."""
    labels = out - 1
    return torch.where(labels == n_max, -1, labels).to(torch.int32)


def labels_oneshot(best_k: torch.Tensor, vacuum: torch.Tensor | None = None):
    """Dense basin labels in one chase (JAX's ``labels_oneshot``): labels
    number the maxima by ascending flat index, vacuum voxels (which the
    caller gives code 13) are -1.  returns (labels int32 grid, n_maxima).
    The single-device pipeline floods with
    :func:`~pybader_tpu_torch.ops.pointer.labels_flood`, which gives the
    same labels; this mirrors the JAX API, and the mesh floods with the
    seed and decode here."""
    seed, n_max = flood_seed(maxima_mask(best_k, vacuum), vacuum)
    out, _ = chase(seed, best_k)
    return flood_decode(out, n_max), n_max
