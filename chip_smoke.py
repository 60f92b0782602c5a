"""GPU smoke test of the PyTorch/CUDA port (pybader_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (one line of output each, or a few):
  1. card: nvidia-smi name and power limit; no CUDA device -> exit 1
  2. build: compile the CUDA kernels from pybader_tpu_torch/csrc
  3. field: a 384^3 f64 blob density (60 blobs, seed 1) made on the card
  4. kernels: each of the six kernels against its plain PyTorch version on
     the card, on the inputs the ongrid path gives it at 384^3, with both
     times (CUDA events, median of 5)
  5. noise: a 384^3 white-noise field (about 2 M basins): the five
     partition and sum kernels against their plain versions at that label
     count, then the main-path partition and sums against the plain chain
  6. cli: the ``bader`` CLI (-m ongrid) on tests/fixtures/CHGCAR_fixture,
     charge conserved to rtol 1e-9
  7. e2e: ``Bader(..., method='ongrid')()`` at 384^3 with the launch
     counters reset just before; every kernel must have launched, charge
     must be conserved and the labels must equal the plain pipeline's

Any failure raises (non-zero exit, no result line).  The second-to-last
line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "tests", "fixtures", "CHGCAR_fixture")
SIZE = 384
N_BLOBS = 60
LATTICE = np.diag([20.0, 20.0, 20.0])

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
}


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


def compare(name, results, kernel, plain, check, phase="kernel"):
    out_k, out_p = kernel(), plain()
    check(out_k, out_p)
    ms = time_ms(kernel)
    plain_ms = time_ms(plain)
    if not isinstance(out_k, tuple):
        out_k, out_p = (out_k,), (out_p,)
    err = max(max_abs_err(a, b) for a, b in zip(out_k, out_p))
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    say(phase, f"{name}: ok, max_abs_err {err}, kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")
    return out_p if len(out_p) > 1 else out_p[0]


def equal(a, b):
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            equal(x, y)
        return
    if not torch.equal(a, b):
        raise AssertionError("kernel and plain outputs differ")


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

    w = tuple(grid.distance_weights(LATTICE, shape))
    codes = compare(
        "ongrid_step_codes", res,
        lambda: stencil.ongrid_step_codes_cuda(rho, w),
        lambda: stencil.ongrid_step_codes_plain(rho, w), equal, phase)
    parent = stencil.parent_from_step_codes(codes)
    roots = compare(
        "resolve_roots", res,
        lambda: pointer.resolve_roots_cuda(parent),
        lambda: pointer.resolve_roots_plain(parent), equal, phase)
    is_max = codes == 13
    n_max = int(is_max.sum())
    rank = torch.cumsum(is_max.reshape(-1), 0) - 1
    flat = roots.reshape(-1).long()
    labels_mo = rank[flat].to(torch.int32).reshape(shape)
    first, max_pos = compare(
        "min_pair", res,
        lambda: reductions.min_pair_cuda(labels_mo, is_max, n_max),
        lambda: reductions.min_pair_plain(labels_mo, is_max, n_max), equal,
        phase)
    order = torch.argsort(first.long(), stable=True)
    table = torch.argsort(order, stable=True).to(torch.int32)
    labels = compare(
        "remap_labels", res,
        lambda: reductions.remap_labels_cuda(labels_mo, table, n_max),
        lambda: reductions.remap_labels_plain(labels_mo, table, n_max),
        equal, phase)
    compare("charge_volume", res,
            lambda: reductions.charge_volume_cuda(rho, labels, n_max),
            lambda: reductions.charge_volume_plain(rho, labels, n_max),
            close(1e-9), phase)
    _, ny, nz = shape
    mf = max_pos[order].long()
    maxima = torch.stack([mf // (ny * nz), (mf // nz) % ny, mf % nz], 1)
    return labels, maxima, n_max


def kernel_phase(rho, atoms_cart, shape):
    """All six kernels against their plain versions on the blob field.
    Returns the per-kernel results and the plain pipeline's labels."""
    from pybader_tpu_torch.ops import atoms as atoms_ops
    from pybader_tpu_torch.ops import edges, reductions

    res = {}
    labels, maxima, n_max = partition_kernels(rho, shape, res)
    lat = torch.as_tensor(LATTICE, device=rho.device)
    atoms_t = torch.as_tensor(atoms_cart, device=rho.device)
    maxima_cart = (maxima.double() / torch.as_tensor(
        shape, dtype=torch.float64, device=rho.device)) @ lat
    atom_idx, _ = atoms_ops.assign_to_atoms(maxima_cart, atoms_t, lat)
    atom_labels = reductions.remap_labels_plain(
        labels, atom_idx.to(torch.int32), n_max)
    edge_mask = edges.edge_find(rho, atom_labels) == -2
    n_atoms = atoms_t.shape[0]
    compare("surface_min_d2", res,
            lambda: atoms_ops.surface_min_d2_cuda(
                atom_labels, edge_mask, lat, atoms_t, n_atoms),
            lambda: atoms_ops.surface_min_d2_plain(
                atom_labels, edge_mask, lat, atoms_t, n_atoms),
            close(1e-12))
    say("kernel", f"{n_max} maxima, {int(edge_mask.sum())} edge voxels")
    return res, labels, atom_labels


def noise_phase(shape, device="cuda"):
    """Many labels: a white-noise field has about N/27 one-voxel-deep
    basins, so charge_volume takes its global-atomic branch (K > 3072) and
    min_pair and remap run at millions of labels.  The kernels are held
    against their plain versions, then the partition and the basin sums
    run through the main path and must give the plain chain's labels,
    maxima and volumes."""
    from pybader_tpu_torch import grid, pipeline
    from pybader_tpu_torch.ops import _cuda, reductions

    gen = torch.Generator(device=device).manual_seed(2)
    rho = torch.rand(shape, dtype=torch.float64, device=device,
                     generator=gen)
    labels_p, maxima_p, n_max = partition_kernels(rho, shape, {}, "noise")
    vox = grid.voxel_volume(LATTICE, shape)
    _cuda.launches.clear()
    labels, maxima = pipeline.partition_ongrid(
        rho, None, tuple(grid.distance_weights(LATTICE, shape)))
    charge, volume = reductions.charge_volume_sum(rho, labels, vox, n_max)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    missing = [k for k in KERNELS
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
    from pybader_tpu_torch import entry_points
    from pybader_tpu_torch.grid import voxel_volume

    # the CLI writes its config profile file; keep it in the temp dir
    entry_points.__config__ = os.path.join(tmp, "config.ini")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        t0 = time.perf_counter()
        entry_points.bader([FIXTURE, "-m", "ongrid", "-o", "dat"])
        t_dat = time.perf_counter() - t0
        entry_points.bader([FIXTURE, "-m", "ongrid"])  # pickle output
        with open("bader.p", "rb") as f:
            b = pickle.load(f)
        with open("CHGCAR_fixture-atoms.dat") as f:
            atoms_dat = f.read()
    finally:
        os.chdir(cwd)
    if atoms_dat != b.results():
        raise AssertionError("CLI -o dat text differs from the results")
    total = float(b.density.sum()) * voxel_volume(b.lattice, b.density.shape)
    np.testing.assert_allclose(float(np.sum(b.atoms_charge)), total,
                               rtol=1e-9)
    say("cli", f"fixture {b.density.shape}: {len(b.bader_charge)} basins, "
        f"atoms charge {float(np.sum(b.atoms_charge))!r} vs "
        f"{total!r}, -o dat run {t_dat:.3f} s")


def blob_bader(density, atoms_cart, tmp):
    """An ongrid ``Bader`` on the card for a host density; its ``dat``
    output goes to ``tmp``."""
    from pybader_tpu_torch.interface import Bader

    file_info = {"filename": f"blobs{density.shape[0]}",
                 "prefix": tmp + os.sep, "file_type": "VASP",
                 "voxel_offset": np.zeros(3)}
    return Bader({"charge": density}, LATTICE, atoms_cart, file_info,
                 method="ongrid", refine_method="ongrid", output="dat",
                 prefix=tmp + os.sep, device="cuda")


def e2e_phase(rho, atoms_cart, shape, tmp, plain_labels, plain_atom_labels):
    from pybader_tpu_torch.ops import _cuda

    density = rho.cpu().numpy()
    b = blob_bader(density, atoms_cart, tmp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.launches.clear()
    t0 = time.perf_counter()
    b()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    missing = [k for k in KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    total = float(density.sum()) * b.voxel_volume
    np.testing.assert_allclose(float(np.sum(b.atoms_charge)), total,
                               rtol=1e-9)
    np.testing.assert_allclose(float(np.sum(b.bader_charge)), total,
                               rtol=1e-9)
    if not np.array_equal(b.bader_volumes, plain_labels.cpu().numpy()):
        raise AssertionError("Bader volumes differ from the plain pipeline")
    if not np.array_equal(b.atoms_volumes, plain_atom_labels.cpu().numpy()):
        raise AssertionError("atom volumes differ from the plain pipeline")
    if not (np.all(np.isfinite(b.atoms_surface_distance))
            and np.all(b.atoms_surface_distance >= 0)):
        raise AssertionError("surface distances not finite")
    peak = torch.cuda.max_memory_allocated()
    say("e2e", f"{SIZE}^3 Bader(method='ongrid')(): {seconds:.3f} s, "
        f"{len(b.bader_charge)} basins, charge {float(np.sum(b.atoms_charge))!r}"
        f" vs {total!r}, peak device memory {peak} bytes")
    say("e2e", "stage seconds " + json.dumps(b.stage_seconds))
    say("e2e", "launches " + json.dumps(launches))
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
    rho, atoms_cart = blob_field(shape, "cuda")
    torch.cuda.synchronize()
    say("field", f"{SIZE}^3 f64 density on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    results, plain_labels, plain_atom_labels = kernel_phase(
        rho, atoms_cart, shape)
    noise_phase(shape)
    with tempfile.TemporaryDirectory() as tmp:
        cli_phase(tmp)
        launches = e2e_phase(rho, atoms_cart, shape, tmp, plain_labels,
                             plain_atom_labels)
    table = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
              "launches": launches[k], **results[k]}
             for k, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
