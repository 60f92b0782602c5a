"""GPU smoke test of the PyTorch/CUDA port (pybader_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (one line of output each, or a few):
  1. card: nvidia-smi name and power limit; no CUDA device -> exit 1
  2. build: compile the CUDA kernels from pybader_tpu_torch/csrc (one nvcc
     process per source, all at once)
  3. field: a 384^3 f64 blob density (60 blobs, seed 1) made on the card
  4. kernel: each of the six ongrid-path kernels against its plain PyTorch
     version on the card, on the inputs the ongrid path gives it at 384^3;
     min_pair (with two scatter_reduce_ calls as its library yardstick)
     also at a ragged length, on label and mask views at storage offsets 1
     and 3 (and 3 and 1), on labels -1 .. K, with a label change at every
     voxel, with a dense mask and on labels spread over more than 4096
     slots (global atomics);
     remap_labels also at a ragged length and at storage offsets 1 and 3;
     charge_volume also at a ragged length, on views at storage offsets,
     on labels outside [0, K), on labels spread over more than 512 slots
     (global atomics) and on the atom labels; edge_find on the surface
     stage's input (atom labels, maxima from the density); resolve_roots
     also on a ramp along x (chains across every tile) and a flat parent
     of odd length, with its pass counts; ongrid_step_codes also on ragged
     grids and axes of 1 and 2, the field shifted to negative values, a
     tie-heavy copy quantised to 1/8 and the mesh's 1-haloed shard block;
     surface_min_d2 also with five atoms that own no voxel, with labels of
     -1 and num_atoms among the edges, on a hexagonal lattice and on a
     mesh shard with its origin
  5. neargrid: the four refinement kernels at 384^3 on the same field:
     edge_find on the ongrid labels, neargrid_rows for both gradient tests
     (bit for bit; also on the stencil's hard inputs: ragged grids, axes of
     1 and 2, negative and tie-heavy densities, the mesh's shard block),
     neargrid_walk on iteration 1's full edge set (stop at known == 2, the
     refinement cap; with its stop bitmap against its plain version, the
     bitmap's build time, the occupancy
     its launch got and lane_steps / warp_steps, the share of lane-slots a
     one-thread-a-lane launch would keep busy) and edge_check on the known
     grid after that iteration (dense), then on 0.6 M of its edges sampled
     with a seed (sparse), the fixture's ragged 24x28x32 grid, a 37x29x45
     grid, grids with an axis of 2 and the field with 25 % vacuum, with
     the share of tiles that skip the labels; edge_find on refinement's
     input and on the same ragged, axis-2 and vacuum grids, with the share
     of tiles that skip is_max
  6. qrows: the four kernels of the quantised-row walks at 384^3 on the
     same field: nginit_codes on the ongrid codes, neargrid_qrows (refinement
     gradient), neargrid_walk_q unscreened and screened on iteration 1's
     padded edge bucket (stop at known == 2 as the bitmap the walks share,
     the refinement cap) and at a cap of 3, one block_walk round on those
     lanes (PYBADER_TPU_BLOCK_STEPS steps), then the whole block phase and
     the screened walk it feeds timed against the exact walk of the same
     edges, the q walker on the phase's hand-off (mostly done lanes) at
     the cap and at 3, and block rounds of 1 and 24 steps on a 16x16x128
     grid (one block) and a 32x16x128 grid; each walk bit for bit, with
     its lanes, lanes that step and lane_steps / warp_steps, the share of
     a one-thread-a-lane launch's lane-slots that step
  7. chase: the chase kernel (Pallas kernel 9) against its plain version
     (27-way roll-select passes) on the whole grid's ongrid codes at 384^3,
     seeded as labels_oneshot seeds it and with the one-step parents;
     labels_oneshot must equal labels_flood and resolve_roots_chase
     resolve_roots
  8. noise: a 384^3 white-noise field (about 2 M basins): the five
     partition and sum kernels against their plain versions at that label
     count and edge_find on its labels (no tile skipped), surface_min_d2 on
     its atom labels (nearly every voxel an edge) and with a basin an atom
     (about 2 M atoms), then the main-path partition and sums against the
     plain chain
  9. cli: the ``bader`` CLI on tests/fixtures/CHGCAR_fixture, with -m
     ongrid (charge conserved) and with the default profile (per-atom
     charges, volumes and maxima against the fixture's golden file)
 10. e2e: ``Bader(..., method='ongrid')()`` at 384^3 with the launch
     counters reset just before; its six kernels must have launched, charge
     must be conserved and the labels must equal the plain pipeline's
 11. default: ``Bader(...)()`` with the default profile at 384^3 (the
     hybrid: ongrid init, ('changed', 9) internal refinement chained into
     ('changed', 2)); all ten kernels must have launched, charge must be
     conserved, and the volume maps must equal the same call with every op
     on its plain version on the card; then an untimed second call, and
     edge_check against its plain version on the input its last
     edge_check received; a third call under ``torch.profiler``, whose
     ``upload.*`` and ``download.*`` spans must count its trace's memcpy
     bytes within 1 %, and their ``pinned`` counters its memcpys from and
     to pinned memory (the density's upload and both label grids'
     downloads, through the pinned ring, ``pinned == bytes``)
 12. variants: ``Bader(...)()`` at 384^3 under PYBADER_TPU_HYBRID_INIT=
     nginit, PYBADER_TPU_QROWS=internal and PYBADER_TPU_BLOCK_WALK=1, then
     under PYBADER_TPU_BLOCK_WALK=1 alone (screened walks); each must launch
     its quantised-row kernels, conserve charge and equal the same call with
     every op on its plain version on the card
 13. mesh: ``make_mesh(4, device="cuda")``, 2x2 shards of 192x192x384 on the
     one card: on shard 0's padded 194x194x384 block of the mesh's first
     chase round (frozen ring, halo from the neighbours), chase_roots on
     its codes, chase_gather of the flood seed at those roots (cropped as
     the round writes it) and the whole chase (the flood seed and the
     one-step parents) against their plain versions; sharded_chase of the
     flood seed against the per-round loop of the roll-select chase (the
     same values in the same number of rounds); the shards' stop bitmaps,
     then neargrid_walk_shard against its plain version on shard 0's lanes
     of iteration 1's edges (with its launch's occupancy and lane_steps /
     warp_steps), on the same lanes at a cap of 3 and on the lanes handed
     off after every shard's first round, resumed on their new owners, and
     the owner-computes walk of all the edges equal to neargrid_walk;
     ``Bader(method='ongrid')()``, the
     partition and a ('changed', 2) refinement on the mesh equal to one
     device's; the default ``Bader()`` on the mesh (its kernels launched,
     charge conserved) equal to the sequence it runs, on one device with
     the kernels: ongrid, the internal ('changed', 9) without carry, a
     fresh ('changed', 2)
 14. read: ``bader-read`` on the card.  The default call's 384^3 result is
     pickled (seconds and bytes); ``bader_read -vac <the field's 25th
     percentile> -a -v`` re-thresholds it (charge_volume launched at least
     twice, 5-50 % of the voxels vacuum, charge conserved) and prints the
     same text as with every op on its plain version on the card; ``-r``
     then ``-a`` prints the table of before the recast; on the fixture's
     pickle from the cli phase, exports (``-e``, with and without a
     re-threshold), ``-d`` and ``-f -f -d`` under ``--device cuda`` and
     ``--device cpu`` write byte-identical files and print the same text.
     Then the object readers: a GPAW calculator stub around the 384^3 field
     gives, with ``method='ongrid'``, the e2e phase's volume maps; a
     pymatgen VolumetricData stub around the fixture runs the default
     profile (charge conserved, golden charges)
 15. full: at 256^3, neargrid_walk against its plain version on 2^20
     random starts and on every voxel (the partition's walk, timed) with
     the initial cap, then the full-trajectory ``partition_neargrid``
     through the kernels (charge conserved)

Times are CUDA events, median of 5 (the chase's plain version: one run,
after a warm-up).  Each kernel's bound is the least time
the card could take for its work: the larger of the bytes it must move
(inputs read once, outputs written once; for the walks, the rows their lanes
touch) over 3.35 TB/s and its operations over the card's instruction rate
for their type: 132 SMs x 64 FP64 lanes x 1.98 GHz = 16.7e12 a second in
f64, 132 x 128 FP32 lanes x 1.98 GHz = 33.5e12 in f32.  The data sheet's 34
and 67 TFLOP/s count a fused multiply-add as two operations; the kernels
build with -fmad=false, so every add, subtract and multiply counted is one
instruction of its own, and a correctly rounded f64 division counts the
FP64 instructions of its fast path (DDIV_F64_OPS, from
``tools/sass_count.py --ddiv``).
``library_ms`` times one PyTorch call that computes the same function where
one exists; the port never calls it.

Any failure raises (non-zero exit, no result line).  The second-to-last
line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, redirect_stdout
from io import StringIO
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "tests", "fixtures", "CHGCAR_fixture")
GOLDEN = os.path.join(HERE, "tests", "fixtures", "CHGCAR_fixture_golden.json")
DEVICE = "cuda"
SIZE = 384
FULL_SIZE = 256
WALK_STARTS = 1 << 20
N_BLOBS = 60
LATTICE = np.diag([20.0, 20.0, 20.0])
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, device memory
# H100 SXM instruction rates outside the tensor cores (SMs x lanes x boost
# clock): each counted add, subtract or multiply is one instruction, since
# the library builds with -fmad=false (the data sheet's 34 and 67 TFLOP/s
# count an FMA as two operations)
F64_OPS_PER_S = 132 * 64 * 1.98e9
F32_OPS_PER_S = 132 * 128 * 1.98e9
# FP64 instructions of one __ddiv_rn's fast path on sm_90a, from
# `python3 tools/sass_count.py --ddiv`
DDIV_F64_OPS = 8
# labels up to which min_pair folds into tables in shared memory
# (csrc/reduce.cu kPairShared); above, global atomics
PAIR_SHARED = 4096
INT32_MAX = 2 ** 31 - 1
# the variant calls: environment over the default profile
VARIANTS = (
    {"PYBADER_TPU_HYBRID_INIT": "nginit", "PYBADER_TPU_QROWS": "internal",
     "PYBADER_TPU_BLOCK_WALK": "1"},
    {"PYBADER_TPU_BLOCK_WALK": "1"},
)

# kernel -> (CUDA source, TPU kernel it replaces: file:line of pallas_call)
KERNELS = {
    "ongrid_step_codes": ("pybader_tpu_torch/csrc/stencil.cu",
                          "pybader_tpu/ops/pallas_stencil.py:242"),
    "resolve_roots": ("pybader_tpu_torch/csrc/flood.cu",
                      "pybader_tpu/ops/pallas_flood.py:128"),
    "min_pair": ("pybader_tpu_torch/csrc/reduce.cu",
                 "pybader_tpu/ops/pallas_reduce.py:155"),
    "remap_labels": ("pybader_tpu_torch/csrc/reduce.cu",
                     "pybader_tpu/ops/pallas_reduce.py:301"),
    "charge_volume": ("pybader_tpu_torch/csrc/reduce.cu",
                      "pybader_tpu/ops/pallas_reduce.py:105"),
    "surface_min_d2": ("pybader_tpu_torch/csrc/reduce.cu",
                       "pybader_tpu/ops/pallas_reduce.py:255"),
    "edge_find": ("pybader_tpu_torch/csrc/edges.cu",
                  "pybader_tpu/ops/pallas_edges.py:178"),
    "edge_check": ("pybader_tpu_torch/csrc/edges.cu",
                   "pybader_tpu/ops/pallas_edges.py:178"),
    # the XLA walk rows and walker, which ROADMAP gives hand-written kernels
    "neargrid_rows": ("pybader_tpu_torch/csrc/neargrid.cu",
                      "pybader_tpu/ops/neargrid.py:484"),
    "neargrid_walk": ("pybader_tpu_torch/csrc/neargrid.cu",
                      "pybader_tpu/ops/neargrid.py:647"),
    # the quantised-row walks, and the block walker (Pallas kernel 10)
    "nginit_codes": ("pybader_tpu_torch/csrc/stencil.cu",
                     "pybader_tpu/ops/stencil.py:108"),
    "neargrid_qrows": ("pybader_tpu_torch/csrc/neargrid.cu",
                       "pybader_tpu/ops/neargrid.py:194"),
    "neargrid_walk_q": ("pybader_tpu_torch/csrc/neargrid.cu",
                        "pybader_tpu/ops/neargrid.py:238"),
    "block_walk": ("pybader_tpu_torch/csrc/block_walk.cu",
                   "pybader_tpu/ops/block_walk.py:299"),
    # the chase (Pallas kernel 9) as a whole and its two kernels, the mesh's
    # resumable shard walker, and the walkers' stop bitmap (JAX bakes the
    # stop set into the rows, update_stop)
    "chase": ("pybader_tpu_torch/csrc/chase.cu",
              "pybader_tpu/ops/pallas_chase.py:293"),
    "chase_roots": ("pybader_tpu_torch/csrc/chase.cu",
                    "pybader_tpu/ops/pallas_chase.py:293"),
    "chase_gather": ("pybader_tpu_torch/csrc/chase.cu",
                     "pybader_tpu/ops/pallas_chase.py:293"),
    "neargrid_walk_shard": ("pybader_tpu_torch/csrc/neargrid.cu",
                            "pybader_tpu/parallel/walk.py:68"),
    "stop_bitmap": ("pybader_tpu_torch/csrc/neargrid.cu",
                    "pybader_tpu/ops/neargrid.py:531"),
}
ONGRID_KERNELS = tuple(KERNELS)[:6]
DEFAULT_KERNELS = tuple(KERNELS)[:10]
Q_KERNELS = tuple(KERNELS)[10:14]
# what the default Bader() launches on a mesh: the ongrid path's kernels but
# the roots (the mesh floods with the chase), the refinement kernels but the
# single-device walker, and the mesh kernels: the chase's two and the shard
# walker with its stop bitmaps
MESH_KERNELS = ("chase_roots", "chase_gather", "neargrid_walk_shard",
                "stop_bitmap", "neargrid_rows", "ongrid_step_codes",
                "edge_find", "edge_check", "min_pair", "remap_labels",
                "charge_volume", "surface_min_d2")
# the table's launches of the mesh kernels come from the mesh default call;
# the chase's row counts its two kernels' launches
MESH_ROWS = ("chase_roots", "chase_gather", "neargrid_walk_shard")
MESH_SHARDS = 4


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    say("card", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return line


def blob_field(shape, device):
    """Dense periodic blob field (the recipe of bench.synthetic_density):
    60 impulses from default_rng(1), blurred at two scales with an FFT."""
    rng = np.random.default_rng(1)
    idx = tuple(rng.integers(0, s, size=N_BLOBS) for s in shape)
    vals = rng.uniform(1.0, 3.0, size=N_BLOBS)
    rho = torch.zeros(shape, dtype=torch.float64, device=device)
    rho[tuple(torch.as_tensor(i, device=device) for i in idx)] = \
        torch.as_tensor(vals, device=device)
    k2 = sum(
        torch.fft.fftfreq(s, dtype=torch.float64, device=device).reshape(
            [-1 if i == d else 1 for i in range(3)]) ** 2
        for d, s in enumerate(shape))
    filt = torch.exp(-k2 * 400.0) + 10.0 * torch.exp(-k2 * 40000.0)
    rho = torch.fft.ifftn(torch.fft.fftn(rho) * filt).real
    rho = (rho - rho.min() + 1e-9).contiguous()
    centers = np.stack(idx, axis=1) / np.asarray(shape)
    return rho, centers @ LATTICE


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a, b):
    a = a.double() if torch.is_tensor(a) else torch.as_tensor(a).double()
    b = b.double() if torch.is_tensor(b) else torch.as_tensor(b).double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        return float("inf")
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def bound(nbytes, f64_ops=0, f32_ops=0):
    """The least time for the work: bytes over the memory rate or the
    operations over their type's rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f64_ops / F64_OPS_PER_S + f32_ops / F32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def compare(name, results, kernel, plain, check, phase, cost, library=None,
            plain_reps=5):
    """Run kernel and plain version once, check them, time both (and the
    library call, where there is one) and record the row of the table."""
    out_k, out_p = kernel(), plain()
    check(out_k, out_p)
    ms = time_ms(kernel)
    plain_ms = time_ms(plain, plain_reps)
    library_ms = None if library is None else time_ms(library)
    if not isinstance(out_k, tuple):
        out_k, out_p = (out_k,), (out_p,)
    err = max(max_abs_err(a, b) for a, b in zip(out_k, out_p))
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     **cost, "library_ms": library_ms}
    lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
    say(phase, f"{name}: ok, max_abs_err {err}, kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms{lib}, bound {cost['bound_ms']:.3f} ms "
        f"({cost['bound_by']})")
    return out_p if len(out_p) > 1 else out_p[0]


def equal(a, b):
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            equal(x, y)
        return
    if not torch.equal(a, b):
        raise AssertionError("kernel and plain outputs differ")


def bits_equal(a, b):
    """Identical bit patterns (torch.equal takes -0.0 == 0.0)."""
    if not torch.equal(a.view(torch.int64), b.view(torch.int64)):
        raise AssertionError("kernel and plain outputs differ in their bits")


def close(rtol):
    def check(a, b):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                check(x, y)
            return
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=rtol, atol=0.0)
        elif not torch.equal(a, b):
            raise AssertionError("kernel and plain counts differ")
    return check


def partition_kernels(rho, shape, res, phase="kernel"):
    """Stencil, roots, min_pair, remap and charge_volume, each against its
    plain version, chained along the ongrid partition so every kernel sees
    the inputs that path gives it.  Returns the plain chain's labels,
    maxima (M, 3) in label order and label count."""
    from pybader_tpu_torch import grid
    from pybader_tpu_torch.ops import pointer, reductions, stencil

    n = rho.numel()
    w = tuple(grid.distance_weights(LATTICE, shape))
    codes = compare(
        "ongrid_step_codes", res,
        lambda: stencil.ongrid_step_codes_cuda(rho, w),
        lambda: stencil.ongrid_step_codes_plain(rho, w), equal, phase,
        stencil_cost(n))
    parent = stencil.parent_from_step_codes(codes)
    roots = compare(
        "resolve_roots", res,
        lambda: pointer.resolve_roots_cuda(parent),
        lambda: pointer.resolve_roots_plain(parent), equal, phase,
        bound(8 * n))
    roots_passes(parent, "ongrid parents", phase)
    is_max = codes == 13
    n_max = int(is_max.sum())
    rank = torch.cumsum(is_max.reshape(-1), 0) - 1
    flat = roots.reshape(-1).long()
    labels_mo = rank[flat].to(torch.int32).reshape(shape)
    # every label is in [0, K) here, so two scatter_reduce_ calls on int64
    # labels (built outside the timed call) compute the same pair
    lab64 = labels_mo.reshape(-1).long()
    iota = torch.arange(n, device=rho.device)
    sel = is_max.reshape(-1)
    mlab64, miota = lab64[sel], iota[sel]
    amin = torch.full((n_max,), INT32_MAX, dtype=torch.int64,
                      device=rho.device)
    mamin = amin.clone()
    first, max_pos = compare(
        "min_pair", res,
        lambda: reductions.min_pair_cuda(labels_mo, is_max, n_max),
        lambda: reductions.min_pair_plain(labels_mo, is_max, n_max), equal,
        phase, bound(5 * n + 8 * n_max),
        library=lambda: (amin.scatter_reduce_(0, lab64, iota, "amin"),
                         mamin.scatter_reduce_(0, mlab64, miota, "amin")))
    del lab64, iota, mlab64, miota
    min_pair_cases(labels_mo, is_max, n_max, phase)
    order = torch.argsort(first.long(), stable=True)
    table = torch.argsort(order, stable=True).to(torch.int32)
    labels = compare(
        "remap_labels", res,
        lambda: reductions.remap_labels_cuda(labels_mo, table, n_max),
        lambda: reductions.remap_labels_plain(labels_mo, table, n_max),
        equal, phase, bound(8 * n + 4 * n_max),
        library=lambda: torch.index_select(table, 0, labels_mo.reshape(-1)))
    remap_cases(labels_mo, table, n_max, phase)
    # every label is >= 0 here, so bincount computes the same sums
    compare("charge_volume", res,
            lambda: reductions.charge_volume_cuda(rho, labels, n_max),
            lambda: reductions.charge_volume_plain(rho, labels, n_max),
            close(1e-9), phase, bound(12 * n + 16 * n_max, n),
            library=lambda: torch.bincount(
                labels.reshape(-1), weights=rho.reshape(-1),
                minlength=n_max))
    charge_volume_cases(rho, labels, n_max, phase)
    _, ny, nz = shape
    mf = max_pos[order].long()
    maxima = torch.stack([mf // (ny * nz), (mf // nz) % ny, mf % nz], 1)
    return labels, maxima, n_max, codes


def min_pair_cases(labels, mask, k, phase):
    """min_pair equal to its plain version where its scalar heads and
    tails, its label filter, its run starts, its masked path and its
    global atomics run: a length that is not a multiple of 4, label and
    mask views at storage offsets 1 and 3 (and 3 and 1: the two phases
    differ), labels -1 .. K (both ends outside [0, K)), a label change at
    every voxel, a dense mask, and labels spread over more than
    PAIR_SHARED slots; with the time of each."""
    from pybader_tpu_torch.ops import reductions

    lab, msk = labels.reshape(-1), mask.reshape(-1)
    n = lab.numel()
    kk = max(k, 2)
    spread = -(-(PAIR_SHARED + 1) // k)
    cases = {"ragged": (lab[:-3], msk[:-3], k),
             "offsets 1 and 3": (lab[1:n - 2], msk[3:], k),
             "offsets 3 and 1": (lab[3:], msk[1:n - 2], k),
             "labels -1 .. K": (lab - 1, msk, max(k - 2, 1)),
             "a change at every voxel": (
                 (torch.arange(n, device=lab.device) % kk).to(torch.int32),
                 msk, kk),
             "a dense mask": (lab, torch.ones_like(msk), k)}
    if spread > 1:
        cases[f"labels x {spread} of {k * spread}"] = (lab * spread, msk,
                                                       k * spread)
    for name, (ll, mm, kk) in cases.items():
        equal(reductions.min_pair_cuda(ll, mm, kk),
              reductions.min_pair_plain(ll, mm, kk))
        ms = time_ms(lambda: reductions.min_pair_cuda(ll, mm, kk))
        say(phase, f"min_pair on {name} ({ll.numel()} voxels, {kk} labels, "
            f"{int(mm.sum())} masked): equal to its plain version; "
            f"{ms:.3f} ms, bound "
            f"{bound(5 * ll.numel() + 8 * kk)['bound_ms']:.3f} ms")


def roots_passes(parent, name, phase):
    """resolve_roots' global passes after its tile pass and the plain
    version's doubling passes (the last of each moves nothing), and the
    kernel's time."""
    from pybader_tpu_torch.ops import pointer

    st, st_p = {}, {}
    equal(pointer.resolve_roots_cuda(parent, st),
          pointer.resolve_roots_plain(parent, st_p))
    ms = time_ms(lambda: pointer.resolve_roots_cuda(parent))
    say(phase, f"resolve_roots on {name} {tuple(parent.shape)}: equal to "
        f"its plain version; {st['passes']} global passes after the tile "
        f"pass (plain doubling: {st_p['passes']}); {ms:.3f} ms")


def roots_inputs(shape, device):
    """Parents with long chains or not 3-D: a ramp along x (every chain
    runs to the last plane, across every tile) and a flat parent of odd
    length (steps of 0-7 voxels forward, 1 in 64 a root; seed 6)."""
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int32, device=device).view(shape)
    plane = shape[1] * shape[2]
    ramp = torch.where(idx < n - plane, idx + plane, idx)
    gen = torch.Generator(device=device).manual_seed(6)
    m = n - 1
    step = torch.randint(0, 8, (m,), generator=gen, device=device)
    step[torch.rand(m, generator=gen, device=device) < 1 / 64] = 0
    pos = torch.arange(m, device=device)
    flat = torch.minimum(pos + step, torch.full_like(pos, m - 1))
    return {"a ramp along x": ramp, "a flat parent": flat.to(torch.int32)}


def roots_cases(shape, phase):
    """resolve_roots against its plain version on :func:`roots_inputs`."""
    for name, parent in roots_inputs(shape, DEVICE).items():
        roots_passes(parent, name, phase)


def remap_cases(labels, table, k, phase):
    """The remap kernel against its plain version where its scalar head
    and tail run: a length that is not a multiple of 4, and contiguous
    views at storage offsets 1 and 3 (the output takes the input's offset
    within 16 bytes)."""
    from pybader_tpu_torch.ops import reductions

    flat = labels.reshape(-1)
    cases = {"ragged": flat[:-3], "offset 1": flat[1:],
             "offset 3": flat[3:-2]}
    for lab in cases.values():
        equal(reductions.remap_labels_cuda(lab, table, k),
              reductions.remap_labels_plain(lab, table, k))
    say(phase, f"remap_labels ({k} labels) equals its plain version on "
        + ", ".join(
            f"{name} ({lab.numel()} voxels)" for name, lab in cases.items()))


def charge_volume_cases(rho, labels, k, phase):
    """charge_volume against its plain version (close(1e-9)) where its
    scalar head and tail, its scalar density loads and its label filter
    run: a length that is not a multiple of 4, contiguous views at storage
    offsets (labels 1, density 1: 16-byte density vectors after the head;
    labels 3, density 2: scalar density loads), labels below -1 and at or
    past k, and labels spread over more than 512 slots (global atomics);
    with the time of each."""
    from pybader_tpu_torch.ops import reductions

    r, lab = rho.reshape(-1), labels.reshape(-1)
    cases = {"ragged": (r[:-3], lab[:-3], k),
             "offsets 1 and 1": (r[1:], lab[1:], k),
             "offsets 3 and 2": (r[2:-1], lab[3:], k),
             "labels -2 .. k - 3": (r, lab - 2, max(k - 4, 1)),
             f"labels x 10 of {10 * k}": (r, lab * 10, 10 * k)}
    for name, (d, ll, kk) in cases.items():
        close(1e-9)(reductions.charge_volume_cuda(d, ll, kk),
                    reductions.charge_volume_plain(d, ll, kk))
        ms = time_ms(lambda: reductions.charge_volume_cuda(d, ll, kk))
        say(phase, f"charge_volume on {name} ({ll.numel()} voxels, "
            f"{kk} labels): equal to its plain version; {ms:.3f} ms")


def find_cost(labels):
    """edge_find's bound from this run's data: labels read and known
    written everywhere (5 bytes a voxel), is_max where the function reads
    it (``edges.find_reads``)."""
    from pybader_tpu_torch.ops import edges

    return bound(5 * labels.numel() + int(edges.find_reads(labels).sum()))


def find_case(name, labels, is_max, phase):
    """edge_find against its plain version on one input; its time, its
    bound and the share of tiles that skipped is_max."""
    from pybader_tpu_torch.ops import edges

    equal(edges.edge_find_cuda(labels, is_max),
          edges.edge_find_plain(labels, is_max))
    active = edges.find_tiles_active(labels)
    ms = time_ms(lambda: edges.edge_find_cuda(labels, is_max))
    say(phase, f"edge_find on {name} {tuple(labels.shape)}: equal to its "
        f"plain version; {int((~active).sum())} of {active.numel()} tiles "
        f"skipped ({float((~active).float().mean()):.4f}); {ms:.3f} ms, "
        f"bound {find_cost(labels)['bound_ms']:.3f} ms")


def atom_labels_of(labels, maxima, atoms_cart):
    """Basin labels -> the labels of their atoms, as the default call's
    surface stage has them: each maximum (voxel indices, label order) goes
    to its nearest atom under the periodic lattice."""
    from pybader_tpu_torch.ops import atoms as atoms_ops
    from pybader_tpu_torch.ops import reductions

    dev = labels.device
    lat = torch.as_tensor(LATTICE, device=dev)
    maxima_cart = (torch.as_tensor(maxima, device=dev).double()
                   / torch.as_tensor(labels.shape, dtype=torch.float64,
                                     device=dev)) @ lat
    atoms_t = torch.as_tensor(atoms_cart, device=dev)
    # in chunks: the noise field has about 2 M maxima
    atom_idx = torch.cat([
        atoms_ops.assign_to_atoms(maxima_cart[i:i + (1 << 15)], atoms_t,
                                  lat)[0]
        for i in range(0, len(maxima_cart), 1 << 15)])
    return reductions.remap_labels_plain(labels, atom_idx.to(torch.int32),
                                         len(maxima))


def stencil_inputs(rho, shape):
    """The stencil's and the rows' hard inputs beside the blob field, as
    (name, density, weights, t_grad): ragged grids and axes of 1 and 2
    (blob fields of their own), the field shifted to negative values, a
    tie-heavy copy quantised to 1/8, and the mesh's 1-haloed block of
    shard 0 (make_mesh(4)), which takes the whole grid's weights and
    t_grad (a host array)."""
    from pybader_tpu_torch import grid
    from pybader_tpu_torch.parallel import make_mesh
    from pybader_tpu_torch.parallel import mesh as pmesh

    def weights(s):
        return tuple(grid.distance_weights(LATTICE, s))

    for s in ((9, 13, 37), (1, 5, 33), (2, 2, 40), (37, 29, 45),
              (shape[0] - 3, shape[1] - 1, shape[2] + 1)):
        yield ("ragged", blob_field(s, rho.device)[0], weights(s),
               grid.t_grad(LATTICE, s))
    tg = grid.t_grad(LATTICE, shape)
    yield "negative", rho - rho.mean(), weights(shape), tg
    yield "tie-heavy", torch.round(rho * 8.0) / 8.0, weights(shape), tg
    lay = pmesh.Layout(make_mesh(MESH_SHARDS, device=DEVICE), shape)
    yield ("shard block", pmesh.halo(pmesh.shard(lay, rho), 1)[0]
           .contiguous(), weights(shape), tg)


def stencil_cost(n):
    """ongrid_step_codes' bound: 8 bytes read and 1 written a voxel; 26
    candidates of (rho_n - rho_p) * w + rho_p, 78 f64 operations."""
    return bound(9 * n, 78 * n)


def stencil_cases(rho, shape, phase):
    """ongrid_step_codes against its plain version on
    :func:`stencil_inputs`, with the time of each."""
    from pybader_tpu_torch.ops import stencil

    for name, dens, w, _ in stencil_inputs(rho, shape):
        equal(stencil.ongrid_step_codes_cuda(dens, w),
              stencil.ongrid_step_codes_plain(dens, w))
        ms = time_ms(lambda: stencil.ongrid_step_codes_cuda(dens, w))
        say(phase, f"ongrid_step_codes on {name} {tuple(dens.shape)}: equal "
            f"to its plain version; {ms:.3f} ms, bound "
            f"{stencil_cost(dens.numel())['bound_ms']:.3f} ms")


def rows_cost(n):
    """neargrid_rows' bound: 8 + 1 bytes read and 32 written a voxel; 35
    f64 operations (6 compares, 3 differences, 3 halvings, 9 products, 9
    sums, 3 absolute values, 2 maxima) and three divisions of
    DDIV_F64_OPS FP64 instructions each."""
    return bound((8 + 1 + 32) * n, (35 + 3 * DDIV_F64_OPS) * n)


def rows_cases(rho, shape, phase):
    """neargrid_rows bit-equal to its plain version under both gradient
    tests on :func:`stencil_inputs`, with the time of each."""
    from pybader_tpu_torch.ops import neargrid, stencil

    for name, dens, w, tg in stencil_inputs(rho, shape):
        codes = stencil.ongrid_step_codes_cuda(dens, w)
        for strict in (False, True):
            bits_equal(neargrid.neargrid_rows_cuda(dens, codes, tg, strict),
                       neargrid.neargrid_rows_plain(dens, codes, tg, strict))
            ms = time_ms(lambda: neargrid.neargrid_rows_cuda(
                dens, codes, tg, strict))
            say(phase, f"neargrid_rows on {name} {tuple(dens.shape)}, "
                f"strict_grad={strict}: bit-equal to its plain version; "
                f"{ms:.3f} ms, bound "
                f"{rows_cost(dens.numel())['bound_ms']:.3f} ms")
        del codes


def surface_cost(labels, mask, num_atoms):
    """surface_min_d2's bound from this run's data: one mask byte a voxel,
    the 32-byte label sectors that hold an edge voxel, 32 bytes an atom
    (its position read, d2 written); for each edge voxel whose label is an
    atom, 3 f32 products (its fractional position), 15 f64 operations (its
    cartesian position) and per image 3 differences, 3 squares and 2 sums
    (the images atom + shift_s are formed once an atom, and not counted)."""
    idx = torch.nonzero(mask.reshape(-1)).reshape(-1)
    lab = labels.reshape(-1)[idx]
    n_edge = int(((lab >= 0) & (lab < num_atoms)).sum())
    sectors = int(torch.unique(idx // 8).numel())
    return bound(mask.numel() + 32 * sectors + 32 * num_atoms,
                 (15 + 27 * 8) * n_edge, 3 * n_edge)


def surface_inputs(labels, mask, atoms_t, gen):
    """surface_min_d2's hard inputs beside the surface stage's, as (name,
    labels, mask, atoms, num_atoms, origin, shape, lattice): five atoms
    more, placed by ``gen``, that own no voxel (+inf), labels of -1 and
    num_atoms among the edges (both skipped), a hexagonal lattice (the
    atoms at the same fractional places) and the last shard of
    make_mesh(4) with its origin in the grid."""
    from pybader_tpu_torch.parallel import make_mesh
    from pybader_tpu_torch.parallel import mesh as pmesh

    n_atoms = atoms_t.shape[0]
    lat = torch.as_tensor(LATTICE, device=labels.device)
    extra = torch.rand((5, 3), dtype=torch.float64, device=labels.device,
                       generator=gen) @ lat
    yield (f"{n_atoms + 5} atoms", labels, mask, torch.cat([atoms_t, extra]),
           n_atoms + 5, (0, 0, 0), None, LATTICE)
    flat = torch.arange(labels.numel(), device=labels.device).view(
        labels.shape)
    odd = torch.where(flat % 7 == 0, -1,
                      torch.where(flat % 11 == 0, n_atoms, labels))
    yield ("labels -1 and num_atoms", odd.to(torch.int32), mask, atoms_t,
           n_atoms, (0, 0, 0), None, LATTICE)
    hexagonal = np.array([[20.0, 0.0, 0.0], [-10.0, 10.0 * np.sqrt(3.0), 0.0],
                          [0.0, 0.0, 20.0]])
    frac = atoms_t @ torch.linalg.inv(lat)
    yield ("a hexagonal lattice", labels, mask,
           frac @ torch.as_tensor(hexagonal, device=labels.device), n_atoms,
           (0, 0, 0), None, hexagonal)
    lay = pmesh.Layout(make_mesh(MESH_SHARDS, device=DEVICE),
                       tuple(labels.shape))
    s = len(lay.ids) - 1
    yield (f"shard {s}", pmesh.shard(lay, labels).blocks[s],
           pmesh.shard(lay, mask).blocks[s], atoms_t, n_atoms, lay.origin(s),
           lay.shape, LATTICE)


def surface_case(name, labels, mask, atoms_t, k, origin, shape, lattice,
                 phase):
    """surface_min_d2 against its plain version (close(1e-12)) on one
    input, with its largest difference, its time and its bound."""
    from pybader_tpu_torch.ops import atoms as atoms_ops

    lat = torch.as_tensor(lattice)  # on the host, as the interface has it
    origin = tuple(origin)
    got = atoms_ops.surface_min_d2_cuda(labels, mask, lat, atoms_t, k,
                                        origin, shape)
    want = atoms_ops.surface_min_d2_plain(labels, mask, lat, atoms_t, k,
                                          origin, shape)
    close(1e-12)(got, want)
    ms = time_ms(lambda: atoms_ops.surface_min_d2_cuda(
        labels, mask, lat, atoms_t, k, origin, shape))
    say(phase, f"surface_min_d2 on {name} {tuple(labels.shape)} at {origin} "
        f"({k} atoms, {int(torch.isfinite(want).sum())} with edges): equal "
        f"to its plain version, max_abs_err {max_abs_err(got, want)}; "
        f"{ms:.3f} ms, bound "
        f"{surface_cost(labels, mask, k)['bound_ms']:.3f} ms")


def kernel_phase(rho, atoms_cart, shape):
    """All six kernels against their plain versions on the blob field.
    Returns the per-kernel results and the plain pipeline's labels."""
    from pybader_tpu_torch.ops import atoms as atoms_ops
    from pybader_tpu_torch.ops import edges, reductions

    res = {}
    labels, maxima, n_max, codes = partition_kernels(rho, shape, res)
    stencil_cases(rho, shape, "kernel")
    roots_cases(shape, "kernel")
    lat = torch.as_tensor(LATTICE)  # on the host, as the interface has it
    atoms_t = torch.as_tensor(atoms_cart, device=rho.device)
    atom_labels = atom_labels_of(labels, maxima, atoms_cart)
    n_atoms = atoms_t.shape[0]
    atom_max = edges.local_max(rho, atom_labels)
    edge_mask = edges.edge_find_plain(atom_labels, atom_max) == -2
    find_case("the surface stage's input", atom_labels, atom_max, "kernel")
    close(1e-9)(reductions.charge_volume_cuda(rho, atom_labels, n_atoms),
                reductions.charge_volume_plain(rho, atom_labels, n_atoms))
    ms = time_ms(lambda: reductions.charge_volume_cuda(rho, atom_labels,
                                                       n_atoms))
    say("kernel", f"charge_volume on the atom labels ({n_atoms}): equal to "
        f"its plain version; {ms:.3f} ms")
    n_edge = int(edge_mask.sum())
    compare("surface_min_d2", res,
            lambda: atoms_ops.surface_min_d2_cuda(
                atom_labels, edge_mask, lat, atoms_t, n_atoms),
            lambda: atoms_ops.surface_min_d2_plain(
                atom_labels, edge_mask, lat, atoms_t, n_atoms),
            close(1e-12), "kernel",
            surface_cost(atom_labels, edge_mask, n_atoms))
    say("kernel", f"{n_max} maxima, {n_edge} edge voxels")
    gen = torch.Generator(device=rho.device).manual_seed(8)
    for case in surface_inputs(atom_labels, edge_mask, atoms_t, gen):
        surface_case(*case, "kernel")
    return res, labels, atom_labels, codes


def walk_cost(rows, starts, shape, cap, known=None):
    """The walk's bound from this run's data: the rows (and known bytes)
    its lanes touch, the starts read and pos/done written, and 15 f64
    operations a lane-step.  The plain version counts both."""
    from pybader_tpu_torch.ops import neargrid

    st = {}
    neargrid.neargrid_walk_plain(rows, starts, shape, cap, known, stats=st)
    per_row = 32 + (0 if known is None else 1)
    cost = bound(st["rows_touched"] * per_row + 9 * starts.numel(),
                 15 * st["lane_steps"])
    return cost, st


def neargrid_phase(rho, shape, codes, labels, res):
    """The four refinement kernels against their plain versions, chained
    along refinement's first iteration on the ongrid labels."""
    from pybader_tpu_torch import grid, pipeline
    from pybader_tpu_torch.ops import edges, neargrid, pointer, stencil

    n = rho.numel()
    tg = grid.t_grad(LATTICE, shape)  # on the host, as the interface has it
    is_max = codes == 13
    known = compare(
        "edge_find", res, lambda: edges.edge_find_cuda(labels, is_max),
        lambda: edges.edge_find_plain(labels, is_max), equal,
        "neargrid", find_cost(labels))
    find_case("refinement's input", labels, is_max, "neargrid")
    for strict in (False, True):
        rows = compare(
            "neargrid_rows", res,
            lambda: neargrid.neargrid_rows_cuda(rho, codes, tg, strict),
            lambda: neargrid.neargrid_rows_plain(rho, codes, tg, strict),
            bits_equal, "neargrid", rows_cost(n))
        say("neargrid", f"rows bit-identical with strict_grad={strict}")
    rows_cases(rho, shape, "neargrid")
    starts = torch.nonzero(known.reshape(-1) == -2).reshape(-1).to(
        torch.int32)
    cap = neargrid.refine_cap(shape)
    cost, st = walk_cost(rows, starts, shape, cap, known)
    pos, done = compare(
        "neargrid_walk", res,
        lambda: neargrid.neargrid_walk_cuda(rows, starts, shape, cap, known),
        lambda: neargrid.neargrid_walk_plain(rows, starts, shape, cap, known),
        equal, "neargrid", cost)
    # the known grid read once, the bitmap written once
    compare("stop_bitmap", res, lambda: neargrid.stop_bitmap_cuda(known),
            lambda: neargrid.stop_bitmap_plain(known), equal, "neargrid",
            bound(n + 4 * -(-n // 32)))
    bitmap_ms = res["stop_bitmap"]["ms"]
    occ = neargrid.walk_occupancy(rho.device)
    say("neargrid", f"neargrid_walk {res['neargrid_walk']['ms']:.3f} ms, of "
        f"which the stop bitmap's build {bitmap_ms:.3f} ms (equal to its "
        f"plain version); the launch got {occ['blocks_per_sm']} blocks of "
        f"{occ['threads']} threads a SM on {occ['sms']} SMs "
        f"({occ['registers']} registers, {occ['spill_bytes']} spill bytes a "
        f"thread); lane_steps / warp_steps {st['lane_steps']} / "
        f"{st['warp_steps']} = {st['lane_steps'] / st['warp_steps']:.4f}")
    n_capped = int((~done).sum())
    if n_capped:
        roots = pointer.resolve_roots_plain(
            stencil.parent_from_step_codes(codes)).reshape(-1)
        pos = torch.where(done, pos, roots[pos.long()])
    labels1, known1 = labels.clone(), known.clone()
    changed = pipeline._apply_walk_results(labels1, known1, starts, pos)
    compare("edge_check", res,
            lambda: edges.edge_check_cuda(known1, labels1, is_max),
            lambda: edges.edge_check_plain(known1, labels1, is_max), equal,
            "neargrid", check_cost(known1, labels1))
    say("neargrid", f"iteration 1: {starts.numel()} edges walked "
        f"({st['lane_steps']} lane-steps, {st['rows_touched']} rows "
        f"touched), {changed} changed, {n_capped} at the cap {cap}")
    check_case("dense, iteration 1", known1, labels1, is_max)
    gen = torch.Generator(device=rho.device).manual_seed(5)
    sparse = sampled_edges(known1, 600_000, gen)
    check_case("sparse, 0.6 M sampled edges", sparse, labels1, is_max)
    edge_check_cases(rho, is_max, gen)


def check_cost(known, labels):
    """edge_check's bound from this run's data: known read and written
    everywhere (2 bytes a voxel), the 4-byte labels and 1-byte is_max
    where the function reads them (``edges.check_reads``)."""
    from pybader_tpu_torch.ops import edges

    lab, mx = edges.check_reads(known, labels)
    return bound(2 * known.numel() + 4 * int(lab.sum()) + int(mx.sum()))


def check_case(name, known, labels, is_max, phase="neargrid"):
    """edge_check against its plain version on one input; its time, its
    bound and the share of tiles that skipped labels and is_max."""
    from pybader_tpu_torch.ops import edges

    equal(edges.edge_check_cuda(known, labels, is_max),
          edges.edge_check_plain(known, labels, is_max))
    active = edges.check_tiles_active(known)
    ms = time_ms(lambda: edges.edge_check_cuda(known, labels, is_max))
    say(phase, f"edge_check on {name} {tuple(known.shape)}: equal to its "
        f"plain version; {int((known == -2).sum())} edges, "
        f"{int((~active).sum())} of {active.numel()} tiles skipped "
        f"({float((~active).float().mean()):.4f}); {ms:.3f} ms, bound "
        f"{check_cost(known, labels)['bound_ms']:.3f} ms")


def sampled_edges(known, count, gen):
    """known with only ``count`` of its -2 voxels, chosen with ``gen``; the
    other edges become -1."""
    flat = known.reshape(-1).clone()
    edge = torch.nonzero(flat == -2).reshape(-1)
    flat[edge] = -1
    keep = torch.randperm(edge.numel(), generator=gen,
                          device=known.device)[:count]
    flat[edge[keep]] = -2
    return flat.view(known.shape)


def perturbed(known, labels, gen):
    """One refinement iteration's changes on an edge_find grid: half the
    edges drop to -1 and a tenth take the next basin's label."""
    edge = known == -2
    kn = torch.where(edge & (torch.rand(known.shape, generator=gen,
                                        device=known.device) < 0.5),
                     -1, known).to(torch.int8)
    flip = edge & (torch.rand(known.shape, generator=gen,
                              device=known.device) < 0.1)
    lab = torch.where(flip, (labels + 1) % (int(labels.max()) + 1), labels)
    return kn, lab.to(torch.int32)


def edge_find_inputs(rho, is_max, gen):
    """Inputs (name, labels, is_max) where the edge kernels' tiles are
    ragged or their halo wraps: the fixture's 24x28x32 grid, a 37x29x45
    noise grid (no 16-byte rows), 2x30x40 and 30x2x40 grids (the halo wraps
    onto itself), and the blob field with 25 % of it vacuum; each with its
    ongrid labels and maxima."""
    from pybader_tpu_torch import grid, pipeline
    from pybader_tpu_torch.io import vasp
    from pybader_tpu_torch.ops import stencil

    density, lattice, _, _ = vasp.read(FIXTURE)
    fields = [("the fixture", torch.as_tensor(density["charge"],
                                              device=rho.device), lattice)]
    for shp in ((37, 29, 45), (2, 30, 40), (30, 2, 40)):
        fields.append(("noise", torch.rand(shp, dtype=torch.float64,
                                            generator=gen,
                                            device=rho.device), LATTICE))
    for name, field, lat in fields:
        w = tuple(grid.distance_weights(lat, field.shape))
        lab, _ = pipeline.partition_ongrid(field, None, w)
        yield name, lab, stencil.ongrid_step_codes_cuda(field, w) == 13
    vac = rho <= rho.reshape(-1).kthvalue(rho.numel() // 4).values
    w = tuple(grid.distance_weights(LATTICE, rho.shape))
    lab, _ = pipeline.partition_ongrid(rho, vac, w)
    yield "25 % vacuum", lab, is_max & ~vac


def edge_check_inputs(rho, is_max, gen):
    """Inputs (name, known, labels, is_max) of :func:`edge_find_inputs`,
    each an edge_find grid after :func:`perturbed`."""
    from pybader_tpu_torch.ops import edges

    for name, lab, mx in edge_find_inputs(rho, is_max, gen):
        kn, lab = perturbed(edges.edge_find_cuda(lab, mx), lab, gen)
        yield name, kn, lab, mx


def edge_check_cases(rho, is_max, gen):
    """edge_check against its plain version on :func:`edge_check_inputs`,
    then edge_find on :func:`edge_find_inputs` (seed 7)."""
    for case in edge_check_inputs(rho, is_max, gen):
        check_case(*case)
    gen = torch.Generator(device=rho.device).manual_seed(7)
    for case in edge_find_inputs(rho, is_max, gen):
        find_case(*case, "neargrid")


def state_equal(a, b):
    """Identical walk states, float fields bit for bit."""
    for x, y in zip(a, b):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        elif x.dtype == torch.float64:
            x, y = x.view(torch.int64), y.view(torch.int64)
        if not torch.equal(x, y):
            raise AssertionError("kernel and plain walk states differ")


def q_walk_cost(state, out, st, live=None, stop=True):
    """A q walk's or a block round's bound from this run's data, the input
    ``state`` and output ``out``.  Bytes: every lane's done flag (and each
    tile's block and live flag) read; the rest of the state (32 bytes a
    lane, 37 screened) read for the lanes the function walks (not done;
    in a live tile), and the whole state written for the lanes whose state
    changed; for each row touched its 8 bytes of q-row and, with a stop
    set, its bit of the stop bitmap.  Operations: 24 f32 a lane-step (3
    dequantising products, 3 + 3 rounding sums and truncations twice, 3 +
    3 + 3 dr sums), 26 more screened (12 absolute values, 6 differences, 4
    minima, 2 compares, 2 sums).  The plain version counts lane-steps and
    rows.  returns (cost, {"walk_lanes", "changed_lanes"})."""
    k = state[0].numel()
    screened = len(state) == 7
    walk = ~state[4]
    if live is not None:
        walk &= live.repeat_interleave(k // max(live.numel(), 1))
    changed = torch.zeros_like(walk)
    for a, b in zip(state, out):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        changed |= (a != b).reshape(k, -1).any(1)
    n_walk, n_changed = int(walk.sum()), int(changed.sum())
    full = 33 + (5 if screened else 0)
    nbytes = (k + (0 if live is None else 5 * live.numel())
              + (full - 1) * n_walk + full * n_changed
              + st["rows_touched"] * (8 + (0.125 if stop else 0)))
    return (bound(nbytes, f32_ops=(50 if screened else 24)
                  * st["lane_steps"]),
            {"walk_lanes": n_walk, "changed_lanes": n_changed})


def q_counts(st):
    """A q walk's counts from its plain version's stats, with the share of
    a one-thread-a-lane launch's lane-slots that step."""
    share = st["lane_steps"] / max(st["warp_steps"], 1)
    return (f"{st['stepped']} step, {st['lane_steps']} lane-steps (longest "
            f"{st['longest']}), {st['rows_touched']} rows touched, "
            f"lane_steps / warp_steps {st['lane_steps']} / "
            f"{st['warp_steps']} = {share:.4f}")


def q_case(name, state, kernel, plain):
    """A q-walk kernel against its plain version, bit for bit, on one more
    input; prints its lanes, counts and time."""
    st = {}
    want = plain(st)
    state_equal(kernel(), want)
    say("qrows", f"{name}: bit-identical, {state[0].numel()} lanes, "
        f"{int((~state[4]).sum())} not done, {q_counts(st)}, kernel "
        f"{time_ms(kernel):.3f} ms")
    return want


def block_grid_cases(seed):
    """One block round at 1 and 24 steps, unscreened and screened, on a
    16x16x128 grid (one block: every periodic wrap stays inside it) and a
    32x16x128 grid (two blocks along x): a blob field's q-rows, a random
    stop set of a fifteenth of the voxels, every voxel but the first 1000
    of a random order as a start and 1000 padding lanes."""
    from pybader_tpu_torch import grid, pipeline
    from pybader_tpu_torch.ops import block_walk, neargrid

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    for shape in ((16, 16, 128), (32, 16, 128)):
        rho, _ = blob_field(shape, DEVICE)
        codes = pipeline.step_codes(
            rho, None, tuple(grid.distance_weights(LATTICE, shape)))
        tg = torch.as_tensor(grid.t_grad(LATTICE, shape), device=DEVICE)
        qrows = neargrid.neargrid_qrows_cuda(rho, codes, tg, True)
        known = torch.where(
            torch.rand(shape, generator=gen, device=DEVICE) < 1 / 15, 2,
            0).to(torch.int8)
        n = rho.numel()
        starts = torch.randperm(n, generator=gen, device=DEVICE).to(
            torch.int32)
        starts[:1000] = -1
        bits = neargrid.stop_bitmap_cuda(known)
        for steps in (1, 24):
            for screened in (False, True):
                state = neargrid.init_state(starts, screened)
                order, blocks, live = block_walk.prep_round(state, shape)
                state = tuple(a[order] for a in state)
                q_case(f"block round {'x'.join(map(str, shape))}, {steps} "
                       f"steps, screened={screened}", state,
                       lambda: block_walk.block_round_cuda(
                           qrows, state, blocks, live, shape, steps,
                           stop=bits),
                       lambda st: block_walk.block_round_plain(
                           qrows, state, blocks, live, shape, steps, known,
                           st))


def qrows_phase(rho, shape, codes, labels, res):
    """The four quantised-row kernels against their plain versions on the
    blob field, on the inputs refinement's first iteration gives them, and
    the two walkers on the block phase's hand-off, at a cap of 3 and on
    grids of one and two blocks."""
    from pybader_tpu_torch import grid
    from pybader_tpu_torch.ops import block_walk, edges, neargrid, stencil

    n = rho.numel()
    tg_host = grid.t_grad(LATTICE, shape)
    tg = torch.as_tensor(tg_host, device=rho.device)
    # the rows' f64 operations (rows_cost), then 3 roundings of 2 sums,
    # 1 compare
    rows_ops = 35 + 3 * DDIV_F64_OPS
    compare("nginit_codes", res,
            lambda: stencil.neargrid_init_codes_cuda(rho, codes, tg),
            lambda: stencil.neargrid_init_codes_plain(rho, codes, tg), equal,
            "qrows", bound((8 + 1 + 1) * n, (rows_ops + 13) * n))
    # the rows' f64 operations and 3 scalings
    qrows = compare(
        "neargrid_qrows", res,
        lambda: neargrid.neargrid_qrows_cuda(rho, codes, tg, True),
        lambda: neargrid.neargrid_qrows_plain(rho, codes, tg, True), equal,
        "qrows", bound((8 + 1 + 8) * n, (rows_ops + 3) * n))
    known = edges.edge_find_cuda(labels, codes == 13)
    # the kernels read the stop set as this bitmap, built once a walk
    bits = neargrid.stop_bitmap_cuda(known)
    starts = torch.nonzero(known.reshape(-1) == -2).reshape(-1).to(
        torch.int32)
    lanes = neargrid.bucket_size(starts.numel())
    padded = neargrid.pad_to(starts, lanes)
    cap = neargrid.refine_cap(shape)
    for screened in (False, True):
        state = neargrid.init_state(padded, screened)
        st = {}
        out = neargrid.neargrid_walk_q_plain(qrows, state, shape, cap, known,
                                             st)
        out = compare(
            "neargrid_walk_q", res,
            lambda: neargrid.neargrid_walk_q_cuda(qrows, state, shape, cap,
                                                  stop=bits),
            lambda: neargrid.neargrid_walk_q_plain(qrows, state, shape, cap,
                                                   known),
            state_equal, "qrows", q_walk_cost(state, out, st)[0])
        risky = f", {int(out[6].sum())} risky" if screened else ""
        say("qrows", f"walk_q screened={screened}: {starts.numel()} edges in "
            f"{lanes} lanes, {q_counts(st)}, {int((~out[4]).sum())} at the "
            f"cap {cap}{risky}")
    q_case(f"walk_q at a cap of 3, {starts.numel()} fresh edges", state,
           lambda: neargrid.neargrid_walk_q_cuda(qrows, state, shape, 3,
                                                 stop=bits),
           lambda st: neargrid.neargrid_walk_q_plain(qrows, state, shape, 3,
                                                     known, st))
    steps = int(os.environ.get("PYBADER_TPU_BLOCK_STEPS", "24"))
    order, blocks, live = block_walk.prep_round(state, shape)
    state = tuple(a[order] for a in state)
    st = {}
    out = block_walk.block_round_plain(qrows, state, blocks, live, shape,
                                       steps, known, st)
    cost, counts = q_walk_cost(state, out, st, live)
    out = compare(
        "block_walk", res,
        lambda: block_walk.block_round_cuda(qrows, state, blocks, live, shape,
                                            steps, stop=bits),
        lambda: block_walk.block_round_plain(qrows, state, blocks, live,
                                             shape, steps, known),
        state_equal, "qrows", cost)
    say("qrows", f"block round ({steps} steps, {int(live.sum())} live tiles "
        f"of {live.numel()}, {counts['walk_lanes']} lanes to walk): "
        f"{int(out[4].sum() - state[4].sum())} lanes retired, "
        f"{q_counts(st)}")
    # the whole block phase and the screened walk it feeds, against the
    # exact walk the default path runs on the same edges; then the q
    # walker on the phase's hand-off (mostly done lanes: the variant calls'
    # input), at the cap and at a cap of 3
    rows = neargrid.neargrid_rows_cuda(rho, codes, tg_host, True)
    exact_ms = time_ms(lambda: neargrid.neargrid_walk_cuda(
        rows, starts, shape, cap, known))
    st = {}
    # in the rounds' last order, as walk_q hands the lanes on
    handed, _ = block_walk.block_rounds(
        qrows, neargrid.init_state(padded, True), shape, steps=steps,
        stats=st, stop=bits)
    # the phase as walk_q runs it: its rounds on the bitmap, then the
    # lanes back in their order
    phase_ms = time_ms(lambda: block_walk.unsort(
        *block_walk.block_rounds(
            qrows, neargrid.init_state(padded, True), shape, steps=steps,
            stop=bits)))
    walk_ms = time_ms(lambda: neargrid.walk_screened(
        qrows, lambda: rows, padded, shape, cap, known, block_steps=steps))
    alive = st["block_rounds"][0]
    say("qrows", f"block phase {phase_ms:.3f} ms ({len(alive)} rounds, "
        f"{alive[-1]} of {starts.numel()} lanes left), screened walk with "
        f"it {walk_ms:.3f} ms, exact walk {exact_ms:.3f} ms")
    for c in (cap, 3):
        q_case(f"walk_q on the block phase's hand-off, cap {c}", handed,
               lambda: neargrid.neargrid_walk_q_cuda(
                   qrows, handed, shape, c, stop=bits),
               lambda st: neargrid.neargrid_walk_q_plain(
                   qrows, handed, shape, c, known, st))
    del rows, handed
    block_grid_cases(9)


def noise_surface_inputs(rho, labels, maxima, atoms_cart):
    """surface_min_d2's inputs on the noise field, as (name, labels, atoms):
    its basins' atoms (each maximum to its nearest blob atom) and every
    basin an atom of its own at a random place (seed 9)."""
    dev = rho.device
    yield ("the noise field's atom labels",
           atom_labels_of(labels, maxima, atoms_cart),
           torch.as_tensor(atoms_cart, device=dev))
    gen = torch.Generator(device=dev).manual_seed(9)
    k = len(maxima)
    yield ("the noise field's basins as atoms", labels,
           torch.rand((k, 3), dtype=torch.float64, device=dev,
                      generator=gen) @ torch.as_tensor(LATTICE, device=dev))


def noise_phase(shape, atoms_cart, device="cuda"):
    """Many labels: a white-noise field has about N/27 one-voxel-deep
    basins, so charge_volume takes its global-atomic branch (K > 3072) and
    min_pair and remap run at millions of labels.  The kernels are held
    against their plain versions, and surface_min_d2 on the field's atom
    labels (its basins to the blob field's atoms: nearly every voxel is an
    edge) and with every basin an atom (random positions, seed 9); then the
    partition and the basin sums run through the main path and must give
    the plain chain's labels, maxima and volumes."""
    from pybader_tpu_torch import grid, pipeline
    from pybader_tpu_torch.ops import _cuda, edges, reductions

    gen = torch.Generator(device=device).manual_seed(2)
    rho = torch.rand(shape, dtype=torch.float64, device=device,
                     generator=gen)
    labels_p, maxima_p, n_max, codes = partition_kernels(rho, shape, {},
                                                          "noise")
    find_case("the noise field", labels_p, codes == 13, "noise")
    del codes
    for name, labels, atoms_t in noise_surface_inputs(
            rho, labels_p, maxima_p, atoms_cart):
        mask = edges.edge_find_plain(labels, edges.local_max(rho, labels)) \
            == -2
        surface_case(name, labels, mask, atoms_t, atoms_t.shape[0],
                     (0, 0, 0), None, LATTICE, "noise")
        del labels, mask
    vox = grid.voxel_volume(LATTICE, shape)
    _cuda.launches.clear()
    labels, maxima = pipeline.partition_ongrid(
        rho, None, tuple(grid.distance_weights(LATTICE, shape)))
    charge, volume = reductions.charge_volume_sum(rho, labels, vox, n_max)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    missing = [k for k in ONGRID_KERNELS
               if k != "surface_min_d2" and launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"many-label partition launched no {missing}")
    if not torch.equal(labels, labels_p):
        raise AssertionError("many-label labels differ from the plain chain")
    if not np.array_equal(maxima, maxima_p.cpu().numpy()):
        raise AssertionError("many-label maxima differ from the plain chain")
    charge_p, count_p = reductions.charge_volume_plain(rho, labels_p, n_max)
    torch.testing.assert_close(charge, charge_p * vox, rtol=1e-9, atol=0.0)
    if not torch.equal(volume, count_p.double() * vox):
        raise AssertionError("many-label volumes differ from the plain sums")
    say("noise", f"{n_max} maxima; main-path partition and sums equal the "
        f"plain chain; launches {json.dumps(launches)}")


def cli_phase(tmp):
    """The CLI on the fixture: -m ongrid (charge conserved) and the default
    profile (golden per-atom charges, volumes and maxima).  Each run writes
    its -o dat text, then a pickle whose results() must equal it; the
    default profile's pickle stays in ``tmp`` as ``bader.p``."""
    from pybader_tpu_torch import entry_points
    from pybader_tpu_torch.grid import voxel_volume

    with open(GOLDEN) as f:
        golden = json.load(f)
    # the CLI writes its config profile file; keep it in the temp dir
    entry_points.__config__ = os.path.join(tmp, "config.ini")
    # a copy read by a relative name: the results' prefix is empty, so what
    # bader-read exports from the pickle lands in its working directory
    name = os.path.basename(FIXTURE)
    shutil.copy(FIXTURE, os.path.join(tmp, name))
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        for flags in (["-m", "ongrid"], []):
            t0 = time.perf_counter()
            entry_points.bader([name, *flags, "-o", "dat"])
            t_dat = time.perf_counter() - t0
            entry_points.bader([name, *flags])  # pickle output
            with open("bader.p", "rb") as f:
                b = pickle.load(f)
            with open("CHGCAR_fixture-atoms.dat") as f:
                atoms_dat = f.read()
            if atoms_dat != b.results():
                raise AssertionError("CLI -o dat text differs from the "
                                     "results")
            total = float(b.density.sum()) * voxel_volume(
                b.lattice, b.density.shape)
            np.testing.assert_allclose(float(np.sum(b.atoms_charge)), total,
                                       rtol=1e-9)
            if not flags:
                golden_check(b, golden)
            say("cli", f"{' '.join(flags) or 'default profile'} on fixture "
                f"{b.density.shape}: {len(b.bader_charge)} basins, atoms "
                f"charge {float(np.sum(b.atoms_charge))!r} vs {total!r}, "
                f"-o dat run {t_dat:.3f} s")
    finally:
        os.chdir(cwd)


def golden_check(b, golden):
    """The fixture's golden file (tests/test_chgcar_fixture.py): per-atom
    charges and volumes to 1e-6 and the same set of maxima."""
    assert (b.method, tuple(b.refine_mode)) == ("neargrid", ("changed", 2))
    np.testing.assert_allclose(b.atoms_charge, golden["atoms_charge"],
                               atol=1e-6)
    np.testing.assert_allclose(b.atoms_volume, golden["atoms_volume"],
                               atol=1e-6)
    shape = np.array(b.density.shape)
    vox = np.rint(b.bader_maxima_fractional * shape
                  - b.voxel_offset_fractional).astype(int) % shape
    if {tuple(m) for m in vox} != {tuple(m) for m in golden["maxima"]}:
        raise AssertionError("default-profile maxima differ from golden")


def blob_bader(density, atoms_cart, tmp, **config):
    """A ``Bader`` on the card for a host density; its ``dat`` output goes
    to ``tmp``.  ``config``: profile keys over the default profile."""
    from pybader_tpu_torch.interface import Bader

    file_info = {"filename": f"blobs{density.shape[0]}",
                 "prefix": tmp + os.sep, "file_type": "VASP",
                 "voxel_offset": np.zeros(3)}
    return Bader({"charge": density}, LATTICE, atoms_cart, file_info,
                 output="dat", prefix=tmp + os.sep, device=DEVICE, **config)


def e2e_phase(rho, atoms_cart, shape, tmp, plain_labels, plain_atom_labels):
    from pybader_tpu_torch.ops import _cuda

    density = rho.cpu().numpy()
    b = blob_bader(density, atoms_cart, tmp, method="ongrid",
                   refine_method="ongrid")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.launches.clear()
    t0 = time.perf_counter()
    b()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    missing = [k for k in ONGRID_KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"ongrid path launched no {missing}")
    check_charge(b, density)
    if not np.array_equal(b.bader_volumes, plain_labels.cpu().numpy()):
        raise AssertionError("Bader volumes differ from the plain pipeline")
    if not np.array_equal(b.atoms_volumes, plain_atom_labels.cpu().numpy()):
        raise AssertionError("atom volumes differ from the plain pipeline")
    peak = torch.cuda.max_memory_allocated()
    say("e2e", f"{SIZE}^3 Bader(method='ongrid')(): {seconds:.3f} s, "
        f"{len(b.bader_charge)} basins, peak device memory {peak} bytes")
    say("e2e", "stage seconds " + json.dumps(b.stage_seconds))
    say("e2e", "launches " + json.dumps(launches))


def check_charge(b, density):
    """Charge conserved to rtol 1e-9 and finite, non-negative distances."""
    total = float(density.sum()) * b.voxel_volume
    np.testing.assert_allclose(float(np.sum(b.atoms_charge)), total,
                               rtol=1e-9)
    if hasattr(b, "bader_charge"):
        np.testing.assert_allclose(float(np.sum(b.bader_charge)), total,
                                   rtol=1e-9)
    if not (np.all(np.isfinite(b.atoms_surface_distance))
            and np.all(b.atoms_surface_distance >= 0)):
        raise AssertionError("surface distances not finite")
    say("charge", f"{float(np.sum(b.atoms_charge))!r} vs {total!r}")


@contextmanager
def refine_iterations(record):
    """Hand every refine_labels call a stats dict and keep, in ``record``,
    its per-iteration (edges, changed, cap fires, risky lanes) and block
    rounds (the hybrid's internal call and the user's)."""
    from pybader_tpu_torch import pipeline

    real = pipeline.refine_labels

    def counted(*args, **kwargs):
        stats = kwargs.get("stats")
        if stats is None:
            stats = kwargs["stats"] = {}
        out = real(*args, **kwargs)
        record.append({
            "iterations": [list(it[:4]) for it in stats.get("iterations", [])],
            "block_rounds": stats.get("block_rounds", [])})
        return out

    with mock.patch.object(pipeline, "refine_labels", counted):
        yield


@contextmanager
def last_edge_check(last):
    """Keep, in ``last``, a copy of the inputs of the last edge_check that
    refinement calls (refinement updates them in place afterwards)."""
    from pybader_tpu_torch import pipeline

    real = pipeline.edge_check

    def recorded(known, labels, is_max):
        last[:] = [known.clone(), labels.clone(), is_max]
        return real(known, labels, is_max)

    with mock.patch.object(pipeline, "edge_check", recorded):
        yield


@contextmanager
def environ(values):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_bader(b, record):
    """Call a Bader with fresh launch counts and peak memory; returns
    (seconds, launches, peak bytes)."""
    from pybader_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.launches.clear()
    t0 = time.perf_counter()
    with refine_iterations(record):
        b()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, dict(_cuda.launches),
            torch.cuda.max_memory_allocated())


def equal_plain(b, density, atoms_cart, tmp, phase):
    """The same call with every op on its plain version on the card must
    give the same volume maps and maxima."""
    from pybader_tpu_torch.ops import _cuda

    bp = blob_bader(density, atoms_cart, tmp)
    t0 = time.perf_counter()
    with mock.patch.object(_cuda, "on_cuda", lambda t: False):
        bp()
    torch.cuda.synchronize()
    for key in ("bader_volumes", "atoms_volumes", "bader_atoms"):
        if not np.array_equal(getattr(b, key), getattr(bp, key)):
            raise AssertionError(f"{key} differ from the plain pipeline")
    if not np.array_equal(b.bader_maxima_fractional,
                          bp.bader_maxima_fractional):
        raise AssertionError("maxima differ from the plain pipeline")
    say(phase, f"volume maps and maxima equal the plain pipeline on the "
        f"card ({time.perf_counter() - t0:.3f} s)")


def copy_bytes_case(density, atoms_cart, tmp, phase="default"):
    """One default call under ``torch.profiler``: the ``bytes`` of its
    ``upload.*`` and ``download.*`` spans must be its trace's memcpy bytes
    (HtoD, DtoH) within 1 %, and their ``pinned`` bytes the bytes of its
    memcpys from and to pinned memory, within 1 %: the density's upload and
    both label grids' downloads cross whole through the pinned ring
    (``hostcopy``), their spans reading ``pinned == bytes``."""
    from torch.profiler import ProfilerActivity, profile

    b = blob_bader(density, atoms_cart, tmp)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        b()
    path = os.path.join(tmp, "copy_bytes_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    got = {"upload": 0, "download": 0}
    pinned = {"upload": 0, "download": 0}
    for ev in events:
        name = ev.get("name", "")
        if ev.get("cat") == "gpu_memcpy" and ("HtoD" in name
                                              or "DtoH" in name):
            way = "upload" if "HtoD" in name else "download"
            n = int(ev.get("args", {}).get("bytes", 0))
            got[way] += n
            if "Pinned" in name:
                pinned[way] += n
    copies = [s for s in b.spans if s.name.startswith(("upload.",
                                                       "download."))]
    counted = {k: sum(s.counters["bytes"] for s in copies
                      if s.name.startswith(k + ".")) for k in got}
    staged = {k: sum(s.counters.get("pinned", 0) for s in copies
                     if s.name.startswith(k + ".")) for k in got}
    say(phase, f"bytes copied, spans {counted}, trace {got}; through the "
        f"pinned ring, spans {staged}, trace's pinned memcpys {pinned}")
    for k, want in got.items():
        if abs(counted[k] - want) > 0.01 * want:
            raise AssertionError(f"the {k} spans count {counted[k]} bytes, "
                                 f"the trace's memcpys {want}")
        if abs(staged[k] - pinned[k]) > 0.01 * pinned[k] or not pinned[k]:
            raise AssertionError(f"the {k} spans count {staged[k]} pinned "
                                 f"bytes, the trace's pinned memcpys "
                                 f"{pinned[k]}")
    for name in ("upload.density", "download.bader_volumes",
                 "download.atoms_volumes"):
        c = next(s.counters for s in copies if s.name == name)
        if c.get("pinned") != c["bytes"]:
            raise AssertionError(f"{name} crossed {c['bytes']} bytes, "
                                 f"{c.get('pinned')} of them pinned")


def default_phase(rho, atoms_cart, tmp):
    """The default profile at 384^3 through the kernels, then the same call
    with every op on its plain version on the card.  Returns the launches,
    the Bader result and the call's seconds."""
    density = rho.cpu().numpy()
    b = blob_bader(density, atoms_cart, tmp)
    assert (b.method, b.refine_method) == ("neargrid", "neargrid")
    assert tuple(b.refine_mode) == ("changed", 2) and not b.speed_flag
    record = []
    seconds, launches, peak = run_bader(b, record)
    missing = [k for k in DEFAULT_KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"default path launched no {missing}")
    check_charge(b, density)
    last = []
    with last_edge_check(last):
        blob_bader(density, atoms_cart, tmp)()
    check_case("the default call's last input", *last, phase="default")
    del last
    say("default", f"{SIZE}^3 Bader()() default profile: {seconds:.3f} s, "
        f"{len(b.bader_charge)} basins, peak device memory {peak} bytes")
    say("default", "stage seconds " + json.dumps(b.stage_seconds))
    say("default", "refine (edges, changed, cap fires, risky) per "
        "iteration, internal then user: "
        + json.dumps([r["iterations"] for r in record]))
    say("default", "launches " + json.dumps(launches))
    copy_bytes_case(density, atoms_cart, tmp)
    equal_plain(b, density, atoms_cart, tmp, "default")
    return launches, b, seconds


def relabelled(b, ref):
    """Voxels whose basin, named by its maximum, differs between two
    Bader results (the numbering of two inits may differ)."""
    index = {tuple(m): i for i, m in enumerate(ref.bader_maxima_fractional)}
    table = np.array([index.get(tuple(m), -2)
                      for m in b.bader_maxima_fractional])
    lab = b.bader_volumes
    mapped = np.where(lab >= 0, table[np.maximum(lab, 0)], lab)
    return int((mapped != ref.bader_volumes).sum())


def variants_phase(rho, atoms_cart, tmp, default):
    """``Bader()`` at 384^3 under each of VARIANTS, through the kernels and
    then with every op on its plain version on the card.  Returns the
    quantised-row kernels' launches, summed over the calls."""
    density = rho.cpu().numpy()
    total = {k: 0 for k in Q_KERNELS}
    for env in VARIANTS:
        name = " ".join(f"{k}={v}" for k, v in env.items())
        with environ(env):
            b = blob_bader(density, atoms_cart, tmp)
            record = []
            seconds, launches, peak = run_bader(b, record)
            want = Q_KERNELS if "PYBADER_TPU_HYBRID_INIT" in env \
                else Q_KERNELS[1:]
            missing = [k for k in want if launches.get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"{name} launched no {missing}")
            check_charge(b, density)
            diff = relabelled(b, default)
            say("variants", f"{name}: {SIZE}^3 Bader()() {seconds:.3f} s, "
                f"{len(b.bader_charge)} basins, peak device memory {peak} "
                f"bytes, {diff} voxels labelled unlike the default call")
            for call, r in zip(("internal", "user"), record):
                say("variants", f"{call} refine (edges, changed, cap fires, "
                    f"risky) per iteration: {json.dumps(r['iterations'])}")
                for it, walks in zip(r["iterations"], r["block_rounds"]):
                    for alive in walks:
                        live = [it[0]] + alive
                        say("variants", f"  {it[0]} edges: {len(alive)} "
                            f"block rounds, lanes retired each round "
                            f"{[a - b for a, b in zip(live, live[1:])]}, "
                            f"{alive[-1]} left for the q walker")
            say("variants", "stage seconds " + json.dumps(b.stage_seconds))
            say("variants", "launches " + json.dumps(launches))
            equal_plain(b, density, atoms_cart, tmp, "variants")
        for k in Q_KERNELS:
            total[k] += launches.get(k, 0)
    return total


# stage times and the writers' progress-bar clocks, masked where two runs'
# printed text is compared
TIMES = re.compile(r"done in \d+\.\d+s|\d\d:\d\d")
# bader-read runs on the fixture's pickle, each on a fresh copy under both
# devices; 0.25 makes about a quarter of the fixture's voxels vacuum
FIXTURE_READS = (["-e", "all_atoms"], ["-e", "all_volumes"],
                 ["-vac", "0.25", "-e", "all_atoms"], ["-d"],
                 ["-f", "-f", "-d"])


def printed(fn, argv):
    """Call ``fn(argv)`` and return (its stdout with times masked,
    seconds)."""
    out = StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(out):
        fn(argv)
    torch.cuda.synchronize()
    return TIMES.sub("-", out.getvalue()), time.perf_counter() - t0


class FakeGPAWCalc:
    """What io.gpaw.read_obj reads of a GPAW calculator (the stub of
    tests/test_io_objects.py): one density, no spin."""

    def __init__(self, rho, lattice, frac):
        self._rho = rho
        self._atoms = SimpleNamespace(
            cell=lattice, get_scaled_positions=lambda: frac,
            get_atomic_numbers=lambda: np.full(len(frac), 8))

    def get_atoms(self):
        return self._atoms

    def get_spin_polarized(self):
        return False

    def get_all_electron_density(self, spin=None, gridrefinement=4):
        return self._rho


def fake_volumetric_data(total, lattice, frac, symbols):
    """What io.pymatgen.read_obj reads of a pymatgen VolumetricData: the
    density in file units (rho times the cell volume) and a structure."""
    lat = SimpleNamespace(matrix=lattice,
                          volume=abs(float(np.linalg.det(lattice))))
    sites = [SimpleNamespace(specie=SimpleNamespace(symbol=s))
             for s in symbols]
    return SimpleNamespace(data={"total": total}, structure=SimpleNamespace(
        lattice=lat, frac_coords=frac, sites=sites))


def read_rethreshold(path, tol):
    """bader-read -vac tol -a -v on the pickle through the kernels, then
    with every op on its plain version on the card: the kernels' run must
    launch charge_volume, make 5-50 % of the voxels vacuum and conserve
    charge; both runs must print the same text."""
    from pybader_tpu_torch import entry_points
    from pybader_tpu_torch.ops import _cuda

    argv = [path, "-vac", repr(tol), "-a", "-v"]
    loaded = []
    real_load = entry_points.load

    def keep(f):  # the re-thresholded object, which -vac does not write
        loaded.append(real_load(f))
        return loaded[-1]

    torch.cuda.synchronize()
    _cuda.launches.clear()
    with mock.patch.object(entry_points, "load", keep):
        text, seconds = printed(entry_points.bader_read, argv)
    launches = dict(_cuda.launches)
    if launches.get("charge_volume", 0) < 2:
        raise AssertionError(f"bader-read -vac launched charge_volume "
                             f"{launches.get('charge_volume', 0)} times")
    b = loaded.pop()
    share = float(np.mean(b.atoms_volumes == -1))
    if not 0.05 <= share <= 0.5:
        raise AssertionError(f"vacuum share {share} outside 5-50 %")
    total = float(b.density.sum()) * b.voxel_volume
    atoms = float(np.sum(b.atoms_charge))
    np.testing.assert_allclose(atoms + b.vacuum_charge, total, rtol=1e-9)
    del b
    with mock.patch.object(_cuda, "on_cuda", lambda t: False):
        plain_text, plain_seconds = printed(entry_points.bader_read, argv)
    if plain_text != text:
        raise AssertionError("bader-read -vac prints other text than with "
                             "the plain versions")
    say("read", f"bader-read -vac {tol!r} -a -v: {seconds:.3f} s (plain "
        f"versions on the card {plain_seconds:.3f} s), {share:.4f} of the "
        f"voxels vacuum, atoms {atoms!r} + vacuum {total - atoms!r} "
        f"conserve {total!r}; text equals the plain versions'; launches "
        f"{json.dumps(launches)}")


def read_fixture(tmp, pickled):
    """bader-read's exports and density writes on the fixture's pickle,
    each on a fresh copy, under --device cuda and --device cpu: the files
    written byte-identical and the printed text equal."""
    from pybader_tpu_torch import entry_points

    cwd = os.getcwd()
    runs = {}
    for device in ("cuda", "cpu"):
        for i, flags in enumerate(FIXTURE_READS):
            where = os.path.join(tmp, f"read_{device}_{i}")
            os.makedirs(where)
            shutil.copy(pickled, os.path.join(where, "bader.p"))
            os.chdir(where)
            try:
                text, _ = printed(entry_points.bader_read,
                                  ["bader.p", *flags, "--device", device])
            finally:
                os.chdir(cwd)
            files = {}
            for n in sorted(os.listdir(where)):
                if n != "bader.p":
                    with open(os.path.join(where, n), "rb") as f:
                        files[n] = f.read()
            runs[device, i] = text, files
    count = 0
    for i, flags in enumerate(FIXTURE_READS):
        text, files = runs["cuda", i]
        if not files:
            raise AssertionError(f"bader-read {' '.join(flags)} wrote "
                                 f"nothing")
        if runs["cpu", i] != (text, files):
            raise AssertionError(f"bader-read {' '.join(flags)} differs "
                                 f"between --device cuda and cpu")
        count += len(files)
    say("read", f"fixture pickle: {', '.join(' '.join(f) for f in FIXTURE_READS)}"
        f": {count} files byte-identical and the same text under --device "
        f"cuda and cpu")


def read_phase(default, rho, atoms_cart, tmp, plain_labels,
               plain_atom_labels):
    """bader-read on the card against a pickle of the default call's
    384^3 result and the cli phase's fixture pickle, then the gpaw and
    pymatgen object readers through Bader."""
    from pybader_tpu_torch import entry_points
    from pybader_tpu_torch.interface import Bader
    from pybader_tpu_torch.io import cube, gpaw, pymatgen, vasp

    fixture_pickle = os.path.join(tmp, "fixture.p")
    os.replace(os.path.join(tmp, "bader.p"), fixture_pickle)
    path = os.path.join(tmp, "bader.p")  # where default.to_file() writes
    t0 = time.perf_counter()
    default.to_file()
    # the dat output cached the table: -vac then prints the cached table
    # beside the new vacuum footer, as the JAX package does
    say("read", f"pickled the {SIZE}^3 default result: "
        f"{os.path.getsize(path)} bytes in {time.perf_counter() - t0:.3f} s "
        f"(table cached: {default._dataframe is not None})")
    try:
        tol = float(rho.reshape(-1).kthvalue(rho.numel() // 4).values)
        read_rethreshold(path, tol)
        before, _ = printed(entry_points.bader_read, [path, "-a"])
        _, seconds = printed(entry_points.bader_read, [path, "-r"])
        after, _ = printed(entry_points.bader_read, [path, "-a"])
        if after != before:
            raise AssertionError("bader-read -a after -r prints another "
                                 "table")
        say("read", f"bader-read -r: {seconds:.3f} s; -a prints the same "
            f"table after the recast")
    finally:
        os.remove(path)
    read_fixture(tmp, fixture_pickle)

    # a GPAW calculator around the 384^3 field: the e2e phase's volume maps
    density = rho.cpu().numpy()
    frac = atoms_cart / np.diag(LATTICE)
    t0 = time.perf_counter()
    b = Bader(*gpaw.read_obj(FakeGPAWCalc(density, LATTICE, frac)),
              method="ongrid", refine_method="ongrid", output=None,
              device=DEVICE)
    b()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if (b.info["file_type"], b.info["write_function"]) != ("gpaw",
                                                            cube.write):
        raise AssertionError("gpaw-born result lacks the cube writer")
    check_charge(b, density)
    if not (np.array_equal(b.bader_volumes, plain_labels.cpu().numpy())
            and np.array_equal(b.atoms_volumes,
                               plain_atom_labels.cpu().numpy())):
        raise AssertionError("gpaw-born volume maps differ from the e2e "
                             "phase's")
    say("read", f"Bader(*gpaw.read_obj(stub), method='ongrid')() at "
        f"{SIZE}^3: {seconds:.3f} s, volume maps equal the e2e phase's "
        f"(atoms bit-equal: {np.array_equal(b.atoms, atoms_cart)})")
    del b

    # a pymatgen VolumetricData around the fixture: the default profile
    dens, lattice, atoms, info = vasp.read(FIXTURE)
    symbols = [e for e, n in zip(info["elements"], info["element_nums"])
               for _ in range(n)]
    data = fake_volumetric_data(
        dens["charge"] * abs(np.linalg.det(lattice)), lattice,
        atoms @ np.linalg.inv(lattice), symbols)
    with open(GOLDEN) as f:
        golden = json.load(f)
    t0 = time.perf_counter()
    b = Bader(*pymatgen.read_obj(data), output=None, device=DEVICE)
    b()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if b.info["write_function"] is not vasp.write:
        raise AssertionError("pymatgen-born result lacks the VASP writer")
    check_charge(b, b.charge)
    golden_check(b, golden)
    say("read", f"Bader(*pymatgen.read_obj(stub))() on the fixture "
        f"{b.density.shape}, default profile: {seconds:.3f} s, charge "
        f"conserved, golden charges and maxima")


def full_phase():
    """At 256^3: the walk kernel on random starts with the initial cap,
    then the full-trajectory partition through the kernels."""
    from pybader_tpu_torch import grid, pipeline
    from pybader_tpu_torch.ops import _cuda, neargrid, reductions, stencil

    shape = (FULL_SIZE,) * 3
    rho, _ = blob_field(shape, DEVICE)
    n = rho.numel()
    w = tuple(grid.distance_weights(LATTICE, shape))
    tg = grid.t_grad(LATTICE, shape)
    codes = stencil.ongrid_step_codes_cuda(rho, w)
    rows = neargrid.neargrid_rows_cuda(rho, codes, tg, False)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    starts = torch.randint(0, n, (WALK_STARTS,), generator=gen,
                           dtype=torch.int32, device=DEVICE)
    cap = neargrid.initial_cap(shape)
    cost, st = walk_cost(rows, starts, shape, cap)
    walk = {}
    _, done = compare(
        "neargrid_walk", walk,
        lambda: neargrid.neargrid_walk_cuda(rows, starts, shape, cap),
        lambda: neargrid.neargrid_walk_plain(rows, starts, shape, cap),
        equal, "full", cost)
    say("full", f"{WALK_STARTS} random starts at {FULL_SIZE}^3: "
        f"{st['lane_steps']} lane-steps, {st['rows_touched']} rows touched, "
        f"{int((~done).sum())} at the cap {cap}")
    # the walk the partition runs: every voxel, no stop set
    every = torch.arange(n, dtype=torch.int32, device=DEVICE)
    equal(neargrid.neargrid_walk_cuda(rows, every, shape, cap),
          neargrid.neargrid_walk_plain(rows, every, shape, cap))
    every_ms = time_ms(lambda: neargrid.neargrid_walk_cuda(rows, every, shape,
                                                           cap))
    say("full", f"neargrid_walk of all {n} voxels without a stop set: "
        f"{every_ms:.3f} ms, equal to its plain version")
    del rows, every
    _cuda.launches.clear()
    stats = {}
    t0 = time.perf_counter()
    labels, maxima = pipeline.partition_neargrid(
        rho, None, w, tg, full_trajectories=True, stats=stats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    used = ("ongrid_step_codes", "neargrid_rows", "neargrid_walk",
            "min_pair", "remap_labels")
    missing = [k for k in used if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"full-trajectory partition launched no "
                             f"{missing}")
    vox = grid.voxel_volume(LATTICE, shape)
    charge, _ = reductions.charge_volume_sum(rho, labels, vox,
                                             len(maxima))
    total = float(rho.sum()) * vox
    np.testing.assert_allclose(float(charge.sum()), total, rtol=1e-9)
    if int((labels < 0).sum()):
        raise AssertionError("full-trajectory labels left a voxel unlabelled")
    say("full", f"{FULL_SIZE}^3 partition_neargrid(full_trajectories=True): "
        f"{seconds:.3f} s, {len(maxima)} maxima, {stats['cap_fires']} cap "
        f"fires, charge {float(charge.sum())!r} vs {total!r}, launches "
        f"{json.dumps(launches)}")


def chase_same(a, b):
    """Identical chase outputs and change counts."""
    equal(a[0], b[0])
    if a[1] != b[1]:
        raise AssertionError("kernel and plain change counts differ")


def chase_phase(shape, codes):
    """The chase kernel against its plain version (27-way roll-select
    passes) on the whole grid's ongrid codes of the blob field, with
    periodic wrap: the label flood seed (``labels_oneshot``) and the
    one-step parents (``resolve_roots_chase``), each also equal to
    ``labels_flood`` and ``resolve_roots``.  The table's row comes from
    the shapes the mesh gives the kernel (:func:`mesh_chase_check`)."""
    from pybader_tpu_torch.ops import chase, pointer, stencil

    seed, n_max = chase.flood_seed(chase.maxima_mask(codes))
    chase_same(chase.chase_cuda(seed, codes), chase.chase_plain(seed, codes))
    ms = time_ms(lambda: chase.chase_cuda(seed, codes))
    labels, n_lab = chase.labels_oneshot(codes)
    flood, n_flood = pointer.labels_flood(codes)
    if n_lab != n_max or n_flood != n_max or not torch.equal(labels, flood):
        raise AssertionError("labels_oneshot differs from labels_flood")
    parent = stencil.parent_from_step_codes(codes)
    roots = chase.resolve_roots_chase(parent)
    chase_same(chase.chase_cuda(parent, codes),
               chase.chase_plain(parent, codes))
    if not torch.equal(roots, pointer.resolve_roots_cuda(parent)):
        raise AssertionError("resolve_roots_chase differs from resolve_roots")
    say("chase", f"labels_oneshot ({n_max} maxima) equals labels_flood and "
        f"resolve_roots_chase equals resolve_roots at {SIZE}^3; the kernel "
        f"equals chase_plain on both ({ms:.3f} ms on the whole grid)")


def mesh_chase_inputs(rho, shape, mesh, weights):
    """The chase's inputs in the mesh's first chase round on shard 0: the
    padded block's codes with their frozen ring of code 13, and its values
    with the halo from the neighbouring shards, seeded as the mesh
    partition seeds them and as the one-step parents of the cap-fire roots.
    returns (codes, seed values, parent values, the number of maxima)."""
    from pybader_tpu_torch.parallel import mesh as pmesh
    from pybader_tpu_torch.parallel import sharded
    from pybader_tpu_torch.parallel.chase import pin_codes

    lay = pmesh.Layout(mesh, shape)
    bk = sharded.step_codes(pmesh.shard(lay, rho), weights)
    seed, _, n_max = sharded._seed_local(bk, None)
    parent = pmesh.Sharded(lay, [lay.parent(b, s)
                                 for s, b in enumerate(bk.blocks)])
    return (pin_codes(bk)[0], pmesh.halo(seed, 1)[0].contiguous(),
            pmesh.halo(parent, 1)[0].contiguous(), n_max)


def mesh_chase_check(rho, shape, mesh, weights, res):
    """The chase's two kernels, each against its plain version, on
    :func:`mesh_chase_inputs` (shard 0's pinned padded block: the roots of
    its codes, the gather of the flood seed at them, cropped as the mesh
    round writes it), then the whole chase against the roll-select chase
    on the flood seed (the table's row) and the one-step parents; then
    ``sharded_chase`` of the flood seed against the per-round loop of the
    roll-select chase: the same values in the same number of rounds."""
    from pybader_tpu_torch.ops import chase
    from pybader_tpu_torch.parallel import mesh as pmesh
    from pybader_tpu_torch.parallel import sharded
    from pybader_tpu_torch.parallel.chase import pin_codes, sharded_chase

    codes, values, parents, n_max = mesh_chase_inputs(rho, shape, mesh,
                                                      weights)
    n = codes.numel()
    lay = pmesh.Layout(mesh, shape)
    pads = tuple(int(a in lay.pads) for a in (0, 1))
    inner = lay.local_shape[0] * lay.local_shape[1] * shape[2]
    # read 1 byte of code, write 4 of root: the jump passes' reads are the
    # kernel's own traffic, not the function's
    root = compare("chase_roots", res, lambda: chase.chase_roots_cuda(codes),
                   lambda: chase.chase_roots_plain(codes), equal, "mesh",
                   bound(5 * n))
    stats = {}
    chase.chase_roots_cuda(codes, stats)
    # read the padded values and the interior's roots, write the interior
    compare("chase_gather", res,
            lambda: chase.chase_gather_cuda(values, root, pads),
            lambda: chase.chase_gather_plain(values, root, pads), equal,
            "mesh", bound(4 * n + 8 * inner))
    # read 1 byte of code and 4 of value, write 4
    compare("chase", res, lambda: chase.chase_cuda(values, codes),
            lambda: chase.chase_plain(values, codes), chase_same, "mesh",
            bound(9 * n), plain_reps=1)
    chase_same(chase.chase_cuda(parents, codes),
               chase.chase_plain(parents, codes))
    say("mesh", f"chase_roots ({stats['passes']} jump passes after the tile "
        f"pass), chase_gather and the chase equal their plain versions on "
        f"shard 0's padded {tuple(codes.shape)} block of the first round "
        f"({n_max} maxima seeded, and the one-step parents)")
    bk = sharded.step_codes(pmesh.shard(lay, rho), weights)
    seed = sharded._seed_local(bk, None)[0]
    t0 = time.perf_counter()
    st = {}
    got = sharded_chase(mesh, seed, bk, stats=st)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # the per-round loop of the roll-select chase, as the mesh ran it
    # before the roots were resolved once a call
    vals, pinned, rounds = seed, pin_codes(bk), 0
    t0 = time.perf_counter()
    while True:
        rounds += 1
        blocks, changed = [], 0
        for padded, c in zip(pmesh.halo(vals, 1), pinned):
            out, k = chase.chase_plain(padded.contiguous(), c)
            blocks.append(pmesh.crop(out, lay, 1))
            changed += k
        vals = pmesh.Sharded(lay, blocks)
        if not changed:
            break
    plain_seconds = time.perf_counter() - t0
    if st["rounds"] != rounds or not all(
            torch.equal(a, b) for a, b in zip(got.blocks, vals.blocks)):
        raise AssertionError("sharded_chase differs from the per-round "
                             "plain loop")
    say("mesh", f"sharded_chase of the flood seed equals the per-round "
        f"roll-select loop in {rounds} rounds ({seconds:.3f} s; the plain "
        f"loop {plain_seconds:.1f} s)")


def shard_walk_cost(st, lanes):
    """The least time of one shard-walker launch: the rows its lanes touch
    (32 bytes each) and each lane's 48-byte state read and written, over
    the memory rate, against 15 f64 operations a lane-step."""
    return bound(st["rows_touched"] * 32 + 2 * 48 * lanes,
                 15 * st["lane_steps"])


def shard_walk_check(rho, shape, codes, labels, mesh, res):
    """neargrid_walk_shard against its plain version on the lanes of
    iteration 1's edges that shard 0 owns (the table's row), on the same
    lanes at a cap of 3, and on the lanes every shard hands off after its
    first round, resumed on their new owners, with the shards' stop
    bitmaps equal to their plain versions; then the whole owner-computes
    walk of all the edges against the single-device walker."""
    from pybader_tpu_torch import grid
    from pybader_tpu_torch.ops import edges, neargrid
    from pybader_tpu_torch.parallel import mesh as pmesh
    from pybader_tpu_torch.parallel.walk import gather, hand_off, shard_rows, \
        walk_sharded

    tg = grid.t_grad(LATTICE, shape)
    known = edges.edge_find_cuda(labels, codes == 13)
    starts = torch.nonzero(known.reshape(-1) == -2).reshape(-1).to(
        torch.int32)
    cap = neargrid.refine_cap(shape)
    lay = pmesh.Layout(mesh, shape)
    rows = shard_rows(pmesh.shard(lay, rho), pmesh.shard(lay, codes), tg,
                      True)
    stop = pmesh.shard(lay, known == 2)
    bits = [neargrid.stop_bitmap_cuda(b, 1) for b in stop.blocks]
    for b, s_ in zip(bits, stop.blocks):
        equal(b, neargrid.stop_bitmap_plain(s_, 1))
    state = neargrid.shard_state(starts[lay.owner(starts) == 0])
    args = (rows[0], bits[0], state, lay.origin(0)[:2], lay.local_shape,
            shape, cap)
    st = {}
    neargrid.neargrid_walk_shard_plain(*args, stats=st)
    k = state[0].numel()

    def flat(out):
        return (*out[0], out[1])

    kept = tuple(a.clone() for a in state)
    out = compare(
        "neargrid_walk_shard", res,
        lambda: flat(neargrid.neargrid_walk_shard_cuda(*args)),
        lambda: flat(neargrid.neargrid_walk_shard_plain(*args)),
        state_equal, "mesh", shard_walk_cost(st, k))
    state_equal(state, kept)  # the input state is left as it was
    status = out[-1]
    occ = neargrid.walk_occupancy(rho.device, shard=True)
    say("mesh", f"shard 0 of {lay.local_shape}: {k} of {starts.numel()} "
        f"edges, {st['lane_steps']} lane-steps (longest {st['longest']}), "
        f"ended done/cap/off-shard "
        f"{[int((status == c).sum()) for c in (1, 2, 0)]}; the launch got "
        f"{occ['blocks_per_sm']} blocks of {occ['threads']} threads a SM on "
        f"{occ['sms']} SMs ({occ['registers']} registers, "
        f"{occ['spill_bytes']} spill bytes a thread); lane_steps / "
        f"warp_steps {st['lane_steps']} / {st['warp_steps']} = "
        f"{st['lane_steps'] / st['warp_steps']:.4f}")
    capped = (*args[:-1], 3)
    state_equal(flat(neargrid.neargrid_walk_shard_cuda(*capped)),
                flat(neargrid.neargrid_walk_shard_plain(*capped)))
    # round 1 on every shard, then the lanes that left their shard resumed
    # on their new owner (steps, dr and history carried over)
    moving = [[] for _ in lay.ids]
    for s in range(len(lay.ids)):
        new, status = neargrid.neargrid_walk_shard_cuda(
            rows[s], bits[s],
            neargrid.shard_state(starts[lay.owner(starts) == s]),
            lay.origin(s)[:2], lay.local_shape, shape, cap)
        go = status == 0
        hand_off(lay, torch.nonzero(go).reshape(-1),
                 tuple(a[go] for a in new), moving)
    resumed = []
    for t, parts in enumerate(moving):
        if parts:
            _, state_t = gather(parts)
            args_t = (rows[t], bits[t], state_t, lay.origin(t)[:2],
                      lay.local_shape, shape, cap)
            state_equal(flat(neargrid.neargrid_walk_shard_cuda(*args_t)),
                        flat(neargrid.neargrid_walk_shard_plain(*args_t)))
            resumed.append(state_t[0].numel())
    if not resumed:
        raise AssertionError("no lane left its shard in round 1")
    say("mesh", f"neargrid_walk_shard equals its plain version at a cap of "
        f"3 and on the {sum(resumed)} lanes handed off in round 1, resumed "
        f"on their new owners ({resumed} a shard)")
    full = neargrid.neargrid_rows_cuda(rho, codes, tg, True)
    pos_1, done_1 = neargrid.neargrid_walk_cuda(full, starts, shape, cap,
                                                known)
    del full
    t0 = time.perf_counter()
    pos, done = walk_sharded(mesh, starts, rho, codes, stop, tg, True, cap,
                             rows=rows)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not (torch.equal(pos, pos_1) and torch.equal(done, done_1)):
        raise AssertionError("walk_sharded differs from neargrid_walk")
    say("mesh", f"walk_sharded of {starts.numel()} edges on "
        f"{len(lay.ids)} shards equals neargrid_walk ({seconds:.3f} s)")


def mesh_phase(rho, atoms_cart, shape, tmp, codes, plain_labels,
               plain_atom_labels, default_seconds, res):
    """The multi-device path on MESH_SHARDS shards of one card: the chase
    and the shard walker on the inputs the mesh gives them, the ongrid
    Bader(), the partition and a refinement, then the
    default Bader(), each against the single-device path with the kernels.
    Returns the default mesh call's launches."""
    from pybader_tpu_torch import grid, pipeline
    from pybader_tpu_torch.parallel import make_mesh

    mesh = make_mesh(MESH_SHARDS, device=DEVICE)
    say("mesh", f"{mesh}")
    w = tuple(grid.distance_weights(LATTICE, shape))
    mesh_chase_check(rho, shape, mesh, w, res)
    shard_walk_check(rho, shape, codes, plain_labels, mesh, res)
    density = rho.cpu().numpy()
    b = blob_bader(density, atoms_cart, tmp, method="ongrid",
                   refine_method="ongrid")
    b.mesh = mesh
    seconds, launches, _ = run_bader(b, [])
    check_charge(b, density)
    if not (np.array_equal(b.bader_volumes, plain_labels.cpu().numpy())
            and np.array_equal(b.atoms_volumes,
                               plain_atom_labels.cpu().numpy())):
        raise AssertionError("mesh ongrid Bader differs from one device")
    say("mesh", f"Bader(method='ongrid')() on the mesh: {seconds:.3f} s, "
        f"volume maps equal one device's; launches {json.dumps(launches)}")
    tg = grid.t_grad(LATTICE, shape)
    labels_1, maxima_1 = pipeline.partition_ongrid(rho, None, w)
    labels_n, maxima_n = pipeline.partition_ongrid(rho, None, w, mesh=mesh)
    if not (torch.equal(labels_n.join(DEVICE), labels_1)
            and np.array_equal(maxima_n, maxima_1)):
        raise AssertionError("mesh partition differs from one device")
    ref_1, ch_1 = pipeline.refine_labels("neargrid", ("changed", 2), rho,
                                         labels_1, w, tg, verbose=False)
    ref_n, ch_n = pipeline.refine_labels("neargrid", ("changed", 2), rho,
                                         labels_n, w, tg, verbose=False,
                                         mesh=mesh)
    if ch_n != ch_1 or not torch.equal(ref_n.join(DEVICE), ref_1):
        raise AssertionError("mesh refinement differs from one device")
    say("mesh", f"partition_ongrid + ('changed', 2) on the mesh equal one "
        f"device's: {len(maxima_1)} maxima, {ch_1} changed")
    # the single-device sequence the mesh's default runs: the ongrid
    # partition, the internal refinement and a fresh ('changed', 2)
    internal = pipeline.hybrid_internal_budget(shape)
    seq, _ = pipeline.refine_labels("neargrid", internal, rho, labels_1, w,
                                    tg, verbose=False)
    seq, _ = pipeline.refine_labels("neargrid", ("changed", 2), rho, seq, w,
                                    tg, verbose=False)
    b = blob_bader(density, atoms_cart, tmp)
    b.mesh = mesh
    record = []
    seconds, launches, peak = run_bader(b, record)
    missing = [k for k in MESH_KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"default path on the mesh launched no "
                             f"{missing}")
    check_charge(b, density)
    vox = np.rint(b.bader_maxima_fractional * np.asarray(shape)).astype(int)
    if not (np.array_equal(b.bader_volumes, seq.cpu().numpy())
            and np.array_equal(vox, maxima_1)):
        raise AssertionError("mesh default Bader differs from the "
                             "single-device sequence")
    say("mesh", f"{SIZE}^3 Bader()() default profile on {MESH_SHARDS} "
        f"shards: {seconds:.3f} s (one device: {default_seconds:.3f} s), "
        f"{len(b.bader_charge)} basins, peak device memory {peak} bytes; "
        f"equals ongrid + {internal} + ('changed', 2) on one device")
    say("mesh", "refine (edges, changed, cap fires, risky) per iteration, "
        "internal then user: " + json.dumps([r["iterations"]
                                             for r in record]))
    say("mesh", "stage seconds " + json.dumps(b.stage_seconds))
    say("mesh", "launches " + json.dumps(launches))
    return launches


def main():
    card()
    from pybader_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.library()
    say("build", f"kernels ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_cuda.build_seconds} s; report in "
        f"pybader_tpu_torch/_build/build.log)")
    shape = (SIZE, SIZE, SIZE)
    t0 = time.perf_counter()
    rho, atoms_cart = blob_field(shape, DEVICE)
    torch.cuda.synchronize()
    say("field", f"{SIZE}^3 f64 density on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    results, plain_labels, plain_atom_labels, codes = kernel_phase(
        rho, atoms_cart, shape)
    neargrid_phase(rho, shape, codes, plain_labels, results)
    qrows_phase(rho, shape, codes, plain_labels, results)
    chase_phase(shape, codes)
    noise_phase(shape, atoms_cart, DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        cli_phase(tmp)
        e2e_phase(rho, atoms_cart, shape, tmp, plain_labels,
                  plain_atom_labels)
        launches, default, seconds = default_phase(rho, atoms_cart, tmp)
        launches.update(variants_phase(rho, atoms_cart, tmp, default))
        mesh = mesh_phase(rho, atoms_cart, shape, tmp, codes, plain_labels,
                          plain_atom_labels, seconds, results)
        launches.update({k: mesh.get(k, 0) for k in MESH_ROWS})
        launches["chase"] = launches["chase_roots"] + \
            launches["chase_gather"]
        t0 = time.perf_counter()
        read_phase(default, rho, atoms_cart, tmp, plain_labels,
                   plain_atom_labels)
        say("read", f"phase {time.perf_counter() - t0:.1f} s")
        del default
    del rho, codes, plain_labels, plain_atom_labels
    full_phase()
    table = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
              "launches": launches[k], **results[k]}
             for k, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
