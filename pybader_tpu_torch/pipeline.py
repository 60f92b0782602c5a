"""Partitioning pipelines, and the analysis stages on one device or a mesh.

Port of :mod:`pybader_tpu.pipeline`: the ongrid and neargrid partitions and
neargrid edge refinement, each stage on the device of the input, with the
hybrid's opt-in variants: the neargrid-first-step init
(``PYBADER_TPU_HYBRID_INIT=nginit``), the quantised-row modes
(``PYBADER_TPU_QROWS=screened|internal|all|off``), the block phase
(``PYBADER_TPU_BLOCK_WALK=1``, ``PYBADER_TPU_BLOCK_STEPS``) and the
internal step cap (``PYBADER_TPU_INTERNAL_CAP``).  The JAX package's other
TPU scheduling (the drain loop's segments and compaction, the
candidate-list switch, the roots compaction above 4096 maxima) gives the
same labels as the formulation ported here.

:func:`read_variants` reads these (and ``PYBADER_TPU_FULL_TRAJECTORIES``,
``_INTERNAL_ITERS``, ``_QROWS_CPU``, ``_FINE_BUCKETS``) once per call of
:func:`partition_neargrid` or :func:`refine_labels`; the functions below
take the :class:`Variants` as arguments.

Row formats.  Where the JAX package walks screened quantised rows without
the block phase (its default), the port walks the exact rows, unpadded:
the screen makes the two bit-identical, and only the block phase reads the
padding.  The quantised-row walkers run only where their result differs
from the exact walk's: the unscreened modes (``QROWS=internal|all``,
unscreened walks on CPU tensors only with ``PYBADER_TPU_QROWS_CPU=1``, as
in JAX), and any walk on which the block phase runs, since its steps do
not count toward the step cap.

With ``mesh=`` (a :class:`~pybader_tpu_torch.parallel.mesh.Mesh` of more
than one shard), or given :class:`~pybader_tpu_torch.parallel.mesh.Sharded`
grids, the entry points run sharded over the mesh, with the JAX package's
rules for it (:mod:`pybader_tpu_torch.parallel`); so do the analysis
stages at the end of this module, on ``Sharded`` grids.

Not ported (ROADMAP Queue 1): ``PYBADER_TPU_F32_ROWS``, which the JAX
package ignores on the CPU and so has no reference there, and the drain
knobs that leave results unchanged (``PYBADER_TPU_SEGMENTS``,
``_GATHER_RATE``, ``_COUNT_RTT``, ``_SORT_COMPACT``, ``_DRAIN_TRACE``).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from pybader_tpu_torch import trace
from pybader_tpu_torch.ops import block_walk, neargrid, reductions
from pybader_tpu_torch.ops.atoms import surface_distance_masked
from pybader_tpu_torch.ops.edges import edge_check, edge_find
from pybader_tpu_torch.ops.pointer import labels_flood, resolve_roots
from pybader_tpu_torch.ops.stencil import (
    neargrid_init_codes, ongrid_step_codes, parent_from_step_codes,
)
from pybader_tpu_torch.parallel import analysis, sharded
from pybader_tpu_torch.parallel.chase import sharded_chase
from pybader_tpu_torch.parallel.mesh import (
    Sharded, is_multi, layout_of, put, shard, take,
)
from pybader_tpu_torch.parallel.walk import shard_rows, walk_sharded

METHODS = ["ongrid", "neargrid"]
REFINEMENT_METHODS = ["neargrid"]

# Above this voxel count method='neargrid' runs the hybrid: the ongrid
# partition, then internal neargrid edge refinement (the JAX package's
# threshold, chosen for TPU gather rates; ROADMAP Queue 1 item 9).
_NEARGRID_HYBRID_THRESHOLD = 1 << 24
# Internal refinement iterations of the hybrid per 128 voxels of extent.
_HYBRID_ITERS_PER_128 = 3
# Internal refinement on top of the nginit init (JAX _NGINIT_HYBRID_REFINE).
_NGINIT_HYBRID_REFINE = ("changed", 1)
# Starts a full-trajectory q walk takes at once (JAX _WALK_BATCH): the
# batches decide which lanes share the block rounds.
_WALK_BATCH = 1 << 21
# Largest lane bucket a refinement q walk takes at once (JAX
# _WALK_CHUNK_CAP); larger buckets walk in chunks of this size.
_WALK_CHUNK_CAP = 1 << 23


@dataclass(frozen=True)
class Variants:
    """The walk variants of one entry call; the defaults are the main
    path's.  Row formats are 'exact', 'q' (unscreened) or 'qs' (screened),
    before :func:`_row_format`'s rules."""

    full_trajectories: bool | None = None  # the partition's; None: by size
    hybrid_init: str = "ongrid"  # or 'nginit'
    internal_iters: int | None = None  # None: hybrid_internal_budget
    internal_cap: int | None = None  # None: neargrid.refine_cap
    internal_rows: str = "qs"  # the hybrid's internal walks
    profile_rows: str = "qs"  # a refinement's own walks
    qrows_cpu: bool = False  # unscreened walks of CPU tensors too
    block_steps: int | None = None  # the block phase's; None: no phase
    fine_buckets: bool = True  # neargrid.bucket_size's 5 and 7 * 2^k


def read_variants() -> Variants:
    """The variants as the environment sets them, with the JAX package's
    names and values (``PYBADER_TPU_INTERNAL_CAP=0``: no cap)."""
    env = os.environ.get
    full = env("PYBADER_TPU_FULL_TRAJECTORIES")
    iters = env("PYBADER_TPU_INTERNAL_ITERS")
    qrows = env("PYBADER_TPU_QROWS", "screened")
    return Variants(
        full_trajectories=None if full is None
        else full.lower() not in ("0", "off", "false"),
        hybrid_init=env("PYBADER_TPU_HYBRID_INIT", "ongrid"),
        internal_iters=None if iters is None else int(iters),
        internal_cap=int(env("PYBADER_TPU_INTERNAL_CAP", "0")) or None,
        internal_rows={"off": "exact", "internal": "q",
                       "all": "q"}.get(qrows, "qs"),
        profile_rows={"screened": "qs", "all": "q"}.get(qrows, "exact"),
        qrows_cpu=env("PYBADER_TPU_QROWS_CPU") == "1",
        block_steps=int(env("PYBADER_TPU_BLOCK_STEPS",
                            str(block_walk.STEPS)))
        if env("PYBADER_TPU_BLOCK_WALK", "0") == "1" else None,
        fine_buckets=env("PYBADER_TPU_FINE_BUCKETS", "1") == "1",
    )


def _mesh_of(mesh, *grids):
    """The mesh an entry call runs sharded over: ``mesh`` where it has more
    than one shard, else the mesh of the first
    :class:`~pybader_tpu_torch.parallel.mesh.Sharded` grid, else None (one
    device)."""
    if is_multi(mesh):
        return mesh
    for g in grids:
        if isinstance(g, Sharded):
            return g.layout.mesh
    return None


def step_codes(reference: torch.Tensor, vacuum: torch.Tensor | None,
               weights) -> torch.Tensor:
    """Ascent step codes with vacuum voxels forced to the self step (13),
    so they never move."""
    bk = ongrid_step_codes(reference, weights)
    if vacuum is not None:
        bk = torch.where(vacuum, torch.tensor(13, dtype=torch.uint8,
                                              device=bk.device), bk)
    return bk


def renumber_discovery(labels_mo: torch.Tensor, is_max: torch.Tensor,
                       n_max: int):
    """Renumber ascending-maximum labels to discovery order.

    Discovery order = ascending first (minimum flat-index) member per
    basin, the order a serial threads=1 scan discovers maxima.  Any label
    count takes this path: the JAX package switches to a roots compaction
    above 4096 maxima because its masked sweeps cost O(K*N) on the TPU,
    while the min_pair and remap kernels take any K; both give the same
    labels (tests/test_torch_pipeline.py).  returns (labels int32 grid,
    maxima (M, 3) int64 numpy voxel coordinates).
    """
    _, ny, nz = labels_mo.shape
    dev = labels_mo.device
    first_member, max_pos = reductions.min_pair(labels_mo, is_max, n_max)
    with trace.span("download.first_member",
                    bytes=trace.moved(first_member, "cpu")):
        first_h = first_member.cpu().numpy()
    order = np.argsort(first_h, kind="stable").astype(np.int32)
    rank = np.argsort(order, kind="stable").astype(np.int32)
    rank = torch.from_numpy(rank)
    with trace.span("upload.rank", bytes=trace.moved(rank, dev)):
        rank = rank.to(dev)
    labels = reductions.remap_labels(labels_mo, rank, n_max)
    with trace.span("download.max_pos", bytes=trace.moved(max_pos, "cpu")):
        max_pos = max_pos.cpu().numpy()
    max_flat = max_pos[order].astype(np.int64)
    maxima = np.stack(
        [max_flat // (ny * nz), (max_flat // nz) % ny, max_flat % nz],
        axis=1).astype(np.int64)
    return labels, maxima


def partition_ongrid(reference: torch.Tensor, vacuum: torch.Tensor | None,
                     weights, progress=None, mesh=None):
    """Ongrid partition: step codes, roots, discovery-order labels.

    args:
        reference: (nx, ny, nz) f64 density tensor; its device decides
            where every stage runs.
        vacuum: bool mask on the same device, or None.
        weights: the 27 distance weights (OFFSETS order).
        progress: optional callback(str) for live stage ticks.
        mesh: optional :class:`~pybader_tpu_torch.parallel.mesh.Mesh` of
            more than one shard: the partition runs sharded over it
            (:func:`~pybader_tpu_torch.parallel.sharded_partition`; its
            devices decide where, and the labels come back sharded).  A
            one-shard mesh takes the single-device path; a ``Sharded``
            ``reference`` brings its own mesh.
    returns:
        (labels int32 tensor [-1 vacuum, 0..M-1 basins],
         maxima (M, 3) int64 numpy voxel indices in discovery order)
    """
    mesh = _mesh_of(mesh, reference)
    with trace.span("partition.init"):
        if mesh is not None:
            return sharded.sharded_partition(mesh, reference, vacuum,
                                             weights)
        return _partition_codes(step_codes(reference, vacuum, weights),
                                vacuum, progress)


def partition_nginit(reference: torch.Tensor, vacuum: torch.Tensor | None,
                     weights, t_grad, progress=None):
    """The hybrid's nginit init (JAX ``_partition_nginit``): the ongrid
    partition's flow on :func:`neargrid_init_codes` codes, each voxel's
    first neargrid step where it strictly ascends, else its ongrid step.
    Roots, maxima and numbering are the ongrid partition's."""
    with trace.span("partition.init"):
        bk = neargrid_init_codes(
            reference, ongrid_step_codes(reference, weights), t_grad)
        if vacuum is not None:
            bk = torch.where(vacuum, torch.tensor(13, dtype=torch.uint8,
                                                  device=bk.device), bk)
        return _partition_codes(bk, vacuum, progress)


def _partition_codes(bk, vacuum, progress):
    """Flood labels from step codes and renumber them to discovery
    order."""
    labels_mo, n_max = labels_flood(bk, vacuum)
    if progress is not None:
        progress(f"{n_max} maxima")
    n_max = max(n_max, 1)
    is_max = bk == 13
    if vacuum is not None:
        is_max &= ~vacuum
    return renumber_discovery(labels_mo, is_max, n_max)


def label_from_roots(roots: torch.Tensor, vacuum: torch.Tensor | None):
    """Labels and maxima from each voxel's end point: the contract of the
    JAX ``pointer.label_from_roots``.

    The maxima are the non-vacuum voxels that are their own end point.  A
    voxel is labelled by ``searchsorted(maxima, end point)`` -- the count of
    maxima below its end point -- and the labels are renumbered to
    discovery order.  For an end point that is a maximum that is its rank;
    a trajectory that ends on a vacuum voxel gets the next maximum above it
    (-1 past the last), as in the JAX package.  Vacuum voxels are -1.
    returns (labels int32 grid, maxima (M, 3) int64 numpy).
    """
    shape = roots.shape
    flat = roots.reshape(-1).long()
    iota = torch.arange(flat.numel(), device=flat.device)
    is_max = flat == iota
    if vacuum is not None:
        is_max &= ~vacuum.reshape(-1)
    n_max = int(is_max.sum())
    below = torch.cumsum(is_max, 0) - is_max.long()
    lab = below[flat]
    lab = torch.where(lab < n_max, lab, -1)
    if vacuum is not None:
        lab = torch.where(vacuum.reshape(-1), -1, lab)
    lab = lab.to(torch.int32).reshape(shape)
    if n_max == 0:
        return lab, np.zeros((0, 3), dtype=np.int64)
    return renumber_discovery(lab, is_max.reshape(shape), n_max)


def hybrid_internal_budget(shape):
    """The hybrid's internal refinement: ('changed', 3 per 128 voxels of
    the largest extent), so the refined band keeps a fixed physical
    width as the resolution grows."""
    return ("changed", _HYBRID_ITERS_PER_128 * max(1, -(-max(shape) // 128)))


def partition_neargrid(reference: torch.Tensor, vacuum: torch.Tensor | None,
                       weights, t_grad, full_trajectories: bool | None = None,
                       progress=None, carry_out=None, stats=None, mesh=None):
    """Neargrid partition.

    Every non-vacuum voxel walks its full neargrid trajectory to a maximum
    (the JAX package's order-free form of the reference method); lanes
    still walking at the step cap resolve through their ongrid root.  On
    grids above 2**24 voxels, or with ``full_trajectories=False``, the
    hybrid runs instead: the ongrid partition (or, with
    ``PYBADER_TPU_HYBRID_INIT=nginit``, :func:`partition_nginit`), then
    internal 'changed' refinement, :func:`hybrid_internal_budget`
    iterations (one after nginit), whose continuation state goes to
    ``carry_out`` so that a following ``refine_labels(...,
    carry_in=carry_out)`` chains on.

    The variants (:func:`read_variants`, once a call):
    ``PYBADER_TPU_FULL_TRAJECTORIES`` picks the path when
    ``full_trajectories`` is None; ``PYBADER_TPU_INTERNAL_ITERS`` overrides
    the hybrid's internal depth (-1: to convergence);
    ``PYBADER_TPU_INTERNAL_CAP`` caps its internal walks' steps;
    ``PYBADER_TPU_QROWS=internal|all`` walks them on unscreened q-rows,
    ``off`` on exact rows; ``PYBADER_TPU_BLOCK_WALK=1`` runs the block
    phase on q walks (full trajectories too, in JAX's batches of 2^21
    starts).  ``stats``, if a dict, receives ``cap_fires`` (full
    trajectories) or the internal refinement's ``iterations`` (hybrid),
    and ``block_rounds`` where the block phase ran.

    On a ``mesh`` of more than one shard (or for a ``Sharded``
    ``reference``) the hybrid always runs, from the mesh's ongrid
    partition, whatever ``full_trajectories``,
    ``PYBADER_TPU_FULL_TRAJECTORIES`` and ``PYBADER_TPU_HYBRID_INIT`` say;
    its internal refinement walks exact rows on the mesh and hands on no
    carry (:func:`refine_labels`).  The labels come back sharded.

    returns (labels int32 tensor, maxima (M, 3) int64 numpy)
    """
    shape = tuple(reference.shape)
    opts = read_variants()
    mesh = _mesh_of(mesh, reference)
    if mesh is None:
        if full_trajectories is None:
            full_trajectories = opts.full_trajectories
        if full_trajectories is None:
            full_trajectories = reference.numel() <= \
                _NEARGRID_HYBRID_THRESHOLD
        if full_trajectories:
            with trace.span("partition.walk"):
                return _partition_walk(reference, vacuum, weights, t_grad,
                                       shape, progress, stats, opts)
    if mesh is None and opts.hybrid_init == "nginit":
        labels, maxima = partition_nginit(reference, vacuum, weights,
                                          t_grad, progress)
        internal = _NGINIT_HYBRID_REFINE
    else:
        labels, maxima = partition_ongrid(reference, vacuum, weights,
                                          progress, mesh=mesh)
        internal = hybrid_internal_budget(shape)
    if opts.internal_iters is not None:
        internal = ("changed", opts.internal_iters)
    # refinement moves edge voxels between the existing basins: the
    # numbering and the maxima stay those of the init
    labels, _ = refine_labels(
        "neargrid", internal, reference, labels, weights, t_grad,
        verbose=False, progress=progress, carry_out=carry_out,
        stats=stats, quantized=opts.internal_rows,
        step_cap=opts.internal_cap, mesh=mesh, variants=opts)
    return labels, maxima


def _partition_walk(reference, vacuum, weights, t_grad, shape, progress,
                    stats, opts):
    """Every non-vacuum voxel's full trajectory (the neargrid partition
    below the hybrid's threshold)."""
    n = reference.numel()
    bk = step_codes(reference, vacuum, weights)
    cap = neargrid.initial_cap(shape)
    if progress is not None:
        progress(f"walking {n} trajectories")
    wstat = {} if stats is not None else None
    n_starts = n if vacuum is None else int((~vacuum).sum())
    # screened q walks unless PYBADER_TPU_QROWS=off
    if opts.internal_rows != "exact" and block_walk.enabled(
            shape, neargrid.padded_size(min(n_starts, _WALK_BATCH)),
            opts.block_steps is not None):
        pos, done = _walk_all_screened(reference, vacuum, bk, t_grad, shape,
                                       cap, wstat, opts)
    else:
        with trace.span("partition.rows"):
            rows = neargrid.neargrid_rows(reference, bk, t_grad,
                                          strict_grad=False)
        starts = torch.arange(n, dtype=torch.int32, device=reference.device)
        pos, done = neargrid.neargrid_walk(rows, starts, shape, cap)
        del rows
    n_capped = int((~done).sum())
    if n_capped:
        roots = resolve_roots(parent_from_step_codes(bk)).reshape(-1)
        pos = torch.where(done, pos, roots[pos.long()])
    if stats is not None:
        stats["cap_fires"] = n_capped
        if "block_rounds" in wstat:
            stats["block_rounds"] = wstat["block_rounds"]
    return label_from_roots(pos.reshape(shape), vacuum)


def _walk_all_screened(reference, vacuum, bk, t_grad, shape, cap, stats,
                       opts):
    """Every non-vacuum voxel's screened q walk with the block phase, in
    JAX's batches (``pad_starts`` of 2^21 starts); vacuum voxels end on
    themselves.  returns (pos, done) over the whole grid."""
    n = reference.numel()
    dev = reference.device
    with trace.span("partition.rows"):
        qrows = neargrid.neargrid_qrows(reference, bk, t_grad,
                                        strict_grad=False)
    exact = _Lazy(neargrid.neargrid_rows, reference, bk, t_grad, False,
                  span="partition.rows")
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    done = torch.ones(n, dtype=torch.bool, device=dev)
    starts_all = pos.clone() if vacuum is None else torch.nonzero(
        ~vacuum.reshape(-1)).reshape(-1).to(torch.int32)
    for chunk in starts_all.split(_WALK_BATCH):
        p, d = neargrid.walk_screened(
            qrows, exact, neargrid.pad_starts(chunk), shape, cap,
            stats=stats, block_steps=opts.block_steps,
            fine_buckets=opts.fine_buckets)
        idx = chunk.long()
        pos[idx] = p[:chunk.numel()]
        done[idx] = d[:chunk.numel()]
    return pos, done


class _Lazy:
    """Walk rows built at the first call, kept afterwards: the screened
    walk needs exact rows only if a lane is risky, and a refinement builds
    only the formats its walks use.  ``value``: rows already built; the
    build runs in a span named ``span``."""

    def __init__(self, build, *args, value=None, span="refine.rows"):
        self.build, self.args, self.value = build, args, value
        self.span = span

    def __call__(self):
        if self.value is None:
            with trace.span(self.span):
                self.value = self.build(*self.args)
        return self.value


def _row_format(quantized, reference, opts: Variants) -> str:
    """The walk-row format of a refinement: 'exact', 'q' (unscreened
    quantised rows) or 'qs' (screened).  ``quantized=None`` takes
    ``opts.profile_rows``; True means 'q', False 'exact'.  Unscreened
    walks of CPU tensors need ``opts.qrows_cpu``, as JAX's CPU backend
    does.  Without the block phase a screened walk is the exact walk."""
    kind = opts.profile_rows if quantized is None else quantized
    if kind is True:
        kind = "q"
    kind = kind or "exact"
    if kind == "q" and reference.device.type == "cpu" and \
            not opts.qrows_cpu:
        return "exact"
    if kind == "qs" and opts.block_steps is None:
        return "exact"
    return kind


def refinement_runs(method: str, refine_mode) -> bool:
    """False where refine_labels returns its labels untouched: unknown
    methods are skipped silently (as in the JAX package) and zero
    iterations are a no-op."""
    return method in REFINEMENT_METHODS and tuple(refine_mode)[1] != 0


def refine_labels(method: str, refine_mode, reference, labels, weights,
                  t_grad, verbose: bool = True, progress=None, stats=None,
                  carry_in=None, carry_out=None, quantized=None,
                  step_cap: int | None = None, mesh=None, variants=None):
    """Iterative neargrid edge refinement.

    Iteration 1 walks every edge voxel (``edge_find``); later iterations
    walk the fresh full edge set ('all') or the edges that ``edge_check``
    finds around the voxels that changed ('changed'), for ``iters``
    iterations or until nothing changes (``iters < 0``: to convergence).
    Unknown methods and ``iters == 0`` return the labels untouched.

    ``quantized`` picks the walk rows (:func:`_row_format`): 'qs', 'q',
    'exact', True, False, or None for ``PYBADER_TPU_QROWS``.  ``variants``
    (:class:`Variants`) are the caller's, else :func:`read_variants`'.
    Exact walks take the starts as they are; quantised walks take JAX's
    padded buckets (:func:`neargrid.bucket_size`, chunks of 2^23 lanes),
    since the padded lane count decides the block rounds.  ``step_cap``
    replaces the refinement cap (:func:`neargrid.refine_cap`); lanes past
    it resolve through their ongrid root.

    ``carry_in`` / ``carry_out`` chain successive 'changed' calls on the
    same labels into one sequence: a call given ``carry_out`` runs the
    ``edge_check`` after its last iteration and leaves its step codes,
    local-maximum mask, ``known`` grid and whichever walk rows it built
    (``rows`` exact, ``qrows`` quantised, None if not built) there, or
    ``converged`` when it converged; a call given that dict as
    ``carry_in`` resumes from it, building the rows its format needs that
    the carry lacks (and returns at once after convergence).  Both are
    ignored in 'all' mode.

    ``stats``, if a dict, receives ``iterations``: one (edges walked,
    changed, step-cap fires, risky lanes, seconds) tuple per iteration.
    The risky lanes are those of the screened q walks the port runs (with
    the block phase); where it walks exact rows in their place the count
    is 0.  ``stats['block_rounds']`` gets, per iteration, the live-lane
    counts after each block round of each walk.  Each iteration that walks
    runs in a ``refine.iteration`` span (:mod:`pybader_tpu_torch.trace`)
    whose counters ``edges``, ``changed``, ``cap_fires`` and ``risky`` are
    the first four fields of its tuple; the rows build in ``refine.rows``
    and ``edge_find`` / ``edge_check`` in ``refine.edges``.

    ``reference`` and ``labels`` are tensors on one device; ``t_grad`` is
    a host array (numpy or a CPU tensor: the rows kernel takes it by
    value).  returns (labels, total_changed).

    On a ``mesh`` of more than one shard, or for ``Sharded`` grids, the
    grids stay sharded (:func:`_refine_mesh`): exact rows only, no carry,
    no ``quantized``; ``reference`` and ``labels`` may be whole or
    :class:`~pybader_tpu_torch.parallel.mesh.Sharded`, and the labels come
    back sharded.
    """
    if not refinement_runs(method, refine_mode):
        return labels, 0
    mode, iters = tuple(refine_mode)
    max_iters = np.inf if iters < 0 else int(iters)
    mesh = _mesh_of(mesh, labels, reference)
    if mesh is not None:
        return _refine_mesh(mesh, str(mode).lower(), max_iters, reference,
                            labels, weights, t_grad, verbose, progress, stats,
                            step_cap)
    if str(mode).lower() != "changed":
        carry_in = carry_out = None
    if carry_in is not None and carry_in.get("converged"):
        return labels, 0
    shape = tuple(reference.shape)
    opts = read_variants() if variants is None else variants
    kind = _row_format(quantized, reference, opts)
    labels = labels.to(torch.int32).clone()  # updated in place below
    if carry_in is not None and "known" in carry_in:
        bk, is_max, known = carry_in["bk"], carry_in["is_max"], \
            carry_in["known"]
        rows, qrows = carry_in.get("rows"), carry_in.get("qrows")
    else:
        vac = labels == -1
        bk = step_codes(reference, vac, weights)
        is_max = (bk == 13) & ~vac
        with trace.span("refine.edges"):
            known = edge_find(reference, labels, is_max)
        rows = qrows = None
    exact = _Lazy(neargrid.neargrid_rows, reference, bk, t_grad, True,
                  value=rows)
    quant = _Lazy(neargrid.neargrid_qrows, reference, bk, t_grad, True,
                  value=qrows)
    cap = neargrid.refine_cap(shape) if step_cap is None else step_cap
    roots = None  # resolved on the first step-cap fire
    total_changed = 0
    converged = False
    if stats is not None:
        stats["iterations"] = []
        stats["block_rounds"] = []
    t_iter = time.perf_counter()
    it = 0
    while it < max_iters:
        it += 1
        starts = torch.nonzero(known.reshape(-1) == -2).reshape(-1).to(
            torch.int32)
        n_edges = starts.numel()
        if n_edges == 0:
            if verbose and it == 1:
                print("  No edges found.")
            converged = True
            break
        if verbose:
            print(f"  Iteration {it}: refining {n_edges} edges")
        if progress is not None:
            progress(f"iteration {it}: walking {n_edges} edges")
        with trace.span("refine.iteration", edges=n_edges):
            wstat = {}
            if kind == "exact":
                pos, done = neargrid.neargrid_walk(exact(), starts, shape,
                                                   cap, known)
            else:
                pos, done = _walk_padded(kind, quant, exact, starts, shape,
                                         cap, known, wstat, opts)
            n_capped = int((~done).sum())
            if n_capped:
                # step-cap stragglers resolve through their ongrid root
                if verbose:
                    print(f"  {n_capped} trajectories hit the step cap "
                          f"(resolved through ongrid roots)")
                if roots is None:
                    roots = resolve_roots(
                        parent_from_step_codes(bk)).reshape(-1)
                pos = torch.where(done, pos, roots[pos.long()])
            changed = _apply_walk_results(labels, known, starts, pos)
            total_changed += changed
            _count_iteration(changed, n_capped, wstat.get("risky", 0))
            if stats is not None:
                now = time.perf_counter()
                stats["iterations"].append(
                    (n_edges, changed, n_capped, wstat.get("risky", 0),
                     round(now - t_iter, 3)))
                stats["block_rounds"].append(wstat.get("block_rounds", []))
                t_iter = now
            if verbose:
                print(f"  {changed} points changed.")
            if changed == 0:
                converged = True
                break
            if it >= max_iters and carry_out is None:
                break
            with trace.span("refine.edges"):
                if str(mode).lower() == "all":
                    known = edge_find(reference, labels, is_max)
                else:
                    known = edge_check(known, labels, is_max)
    if carry_out is not None:
        if converged:
            carry_out["converged"] = True
        else:
            carry_out.update(known=known, bk=bk, is_max=is_max,
                             rows=exact.value, qrows=quant.value)
    return labels, total_changed


def _count_iteration(changed, cap_fires, risky):
    """The counters of a 'refine.iteration' span beside its ``edges``."""
    trace.count("changed", changed)
    trace.count("cap_fires", cap_fires)
    trace.count("risky", risky)


def _refine_mesh(mesh, mode, max_iters, reference, labels, weights, t_grad,
                 verbose, progress, stats, step_cap):
    """:func:`refine_labels` with every grid sharded over ``mesh``.

    JAX's rules on a mesh: exact rows (built once, per shard, by
    :func:`~pybader_tpu_torch.parallel.walk.shard_rows`), no carry and no
    candidate filter.  ``edge_find`` / ``edge_check`` run per shard on
    2-haloed grids, the walk is the owner-computes
    :func:`~pybader_tpu_torch.parallel.walk.walk_sharded`, and capped lanes
    resolve through roots from the mesh chase.  Each iteration's edge list
    is the shards' edges in shard order; walks and the label update do not
    depend on that order.  returns (labels :class:`Sharded`, total
    changed)."""
    lay = layout_of(mesh, labels)
    home = lay.devices[0]
    rho = shard(lay, reference, torch.float64)
    labels = shard(lay, labels, torch.int32).map(torch.clone)
    vac = labels.map(lambda b: b == -1)
    bk = sharded.step_codes(rho, weights, vac)
    is_max = Sharded(lay, [(b == 13) & ~v
                           for b, v in zip(bk.blocks, vac.blocks)])
    with trace.span("refine.edges"):
        known = sharded.edges_find(labels, is_max)
    with trace.span("refine.rows"):
        rows = shard_rows(rho, bk, t_grad, True)
    cap = neargrid.refine_cap(lay.shape) if step_cap is None else step_cap
    roots = None  # resolved on the first step-cap fire
    total_changed = 0
    if stats is not None:
        stats["iterations"] = []
    t_iter = time.perf_counter()
    it = 0
    while it < max_iters:
        it += 1
        starts = torch.cat([
            lay.to_global(torch.nonzero(k.view(-1) == -2).view(-1), s).to(home)
            for s, k in enumerate(known.blocks)]).to(torch.int32)
        n_edges = starts.numel()
        if n_edges == 0:
            if verbose and it == 1:
                print("  No edges found.")
            break
        if verbose:
            print(f"  Iteration {it}: refining {n_edges} edges")
        if progress is not None:
            progress(f"iteration {it}: walking {n_edges} edges")
        with trace.span("refine.iteration", edges=n_edges):
            pos, done = walk_sharded(mesh, starts, rho, bk,
                                     known.map(lambda k: k == 2), t_grad,
                                     True, cap, rows=rows)
            n_capped = int((~done).sum())
            if n_capped:
                if verbose:
                    print(f"  {n_capped} trajectories hit the step cap "
                          f"(resolved through ongrid roots)")
                if roots is None:
                    roots = sharded_chase(mesh, Sharded(lay, [
                        lay.parent(b, s) for s, b in enumerate(bk.blocks)]),
                        bk)
                pos = torch.where(done, pos, take(roots, pos))
            # every old and new label is gathered before any is written
            new, old = take(labels, pos), take(labels, starts)
            moved = new != old
            put(labels, starts, new)
            put(known, starts, torch.where(moved, -2, -1).to(torch.int8))
            changed = int(moved.sum())
            total_changed += changed
            _count_iteration(changed, n_capped, 0)
            if stats is not None:
                now = time.perf_counter()
                stats["iterations"].append(
                    (n_edges, changed, n_capped, 0, round(now - t_iter, 3)))
                t_iter = now
            if verbose:
                print(f"  {changed} points changed.")
            if changed == 0 or it >= max_iters:
                break
            with trace.span("refine.edges"):
                if mode == "all":
                    known = sharded.edges_find(labels, is_max)
                else:
                    known = sharded.edges_check(known, labels, is_max)
    return labels, total_changed


def _walk_padded(kind, quant, exact, starts, shape, cap, known, stats,
                 opts):
    """One quantised refinement walk in JAX's padded buckets and chunks.

    'q' walks the unscreened q-rows; 'qs' (with the block phase on) walks
    a chunk screened (risky lanes again on the exact rows) where the block
    phase runs on it, and on the exact rows otherwise, which gives the
    same result.  ``quant`` and ``exact`` build the rows on first use.
    ``stats`` sums the risky counts and collects the block rounds.
    returns (pos, done) of the unpadded starts."""
    n_edges = starts.numel()
    padded = neargrid.pad_to(starts, neargrid.bucket_size(
        n_edges, fine_buckets=opts.fine_buckets))
    parts = []
    for chunk in padded.split(_WALK_CHUNK_CAP):
        wstat = {}
        if kind == "q":
            parts.append(neargrid.walk_q(quant(), chunk, shape, cap, known,
                                         stats=wstat,
                                         block_steps=opts.block_steps))
        elif block_walk.enabled(shape, chunk.numel(),
                                opts.block_steps is not None):
            parts.append(neargrid.walk_screened(
                quant(), exact, chunk, shape, cap, known, stats=wstat,
                block_steps=opts.block_steps,
                fine_buckets=opts.fine_buckets))
        else:
            parts.append(neargrid.neargrid_walk(exact(), chunk, shape, cap,
                                                known))
        stats["risky"] = stats.get("risky", 0) + wstat.get("risky", 0)
        stats.setdefault("block_rounds", []).extend(
            wstat.get("block_rounds", []))
    pos = torch.cat([p for p, _ in parts])[:n_edges]
    done = torch.cat([d for _, d in parts])[:n_edges]
    return pos, done


def _apply_walk_results(labels, known, starts, pos) -> int:
    """Give each walked voxel the label of its end point, in place: gather
    every old and new label first, then scatter.  Walked voxels whose label
    changed become -2 in ``known`` (the next 'changed' iteration's seeds),
    the others -1.  returns the number of changed voxels."""
    lab = labels.view(-1)
    kn = known.view(-1)
    s = starts.long()
    new = lab[pos.long()]
    changed = new != lab[s]
    lab[s] = new
    kn[s] = torch.where(changed, -2, -1).to(torch.int8)
    return int(changed.sum())


# ------------------------------------------------------ analysis stages
def vacuum_mask(reference, vac_tol: float, density, voxel_vol: float):
    """:func:`reductions.vacuum_mask`, per shard for a ``Sharded``
    ``reference`` (the mask stays sharded)."""
    if isinstance(reference, Sharded):
        return analysis.sharded_vacuum_mask(reference.layout.mesh, reference,
                                            vac_tol, density, voxel_vol)
    return reductions.vacuum_mask(reference, vac_tol, density, voxel_vol)


def relabel(labels, swap):
    """:func:`reductions.relabel`, per shard for ``Sharded`` labels."""
    if isinstance(labels, Sharded):
        return analysis.sharded_relabel(labels.layout.mesh, labels, swap)
    return reductions.relabel(labels, swap)


def charge_volume_sum(density, labels, voxel_vol: float, num_segments: int):
    """:func:`reductions.charge_volume_sum`; for ``Sharded`` labels the
    shards' sums, added on the host."""
    if isinstance(labels, Sharded):
        return analysis.sharded_charge_volume_sum(
            labels.layout.mesh, density, labels, voxel_vol, num_segments)
    return reductions.charge_volume_sum(density, labels, voxel_vol,
                                        num_segments)


def surface_distance(reference, labels, lattice, atoms, num_atoms: int):
    """Each atom's distance to its volume's surface (``edge_find``, then
    ``surface_distance_masked``; for ``Sharded`` labels per shard, met on
    the host).  ``lattice`` stays on the host: the kernel takes it by
    value; ``atoms`` are the positions less the voxel offset."""
    if isinstance(labels, Sharded):
        return analysis.sharded_min_surface_distance(
            labels.layout.mesh, reference, labels, lattice, atoms, num_atoms)
    known = edge_find(reference, labels)
    return surface_distance_masked(
        labels, known == -2, torch.as_tensor(lattice, dtype=torch.float64),
        atoms, num_atoms)
