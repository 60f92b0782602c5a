"""Time remap_labels and the exact neargrid walker of one checkout of the port.

Run from the repository root on a machine with one CUDA GPU:

    python3 tools/kernel_ab.py [--root DIR] [--reps 20]

It imports ``pybader_tpu_torch`` and ``chip_smoke`` from ``--root`` (default:
this repository), so the same script times the kernels of an older checkout
(unpacked with ``git archive``) on the same card; compare two checkouts in
one command, in turns (old, new, new, old).  Inputs, all made on the card
from seeds: chip_smoke's 384^3 blob field and 384^3 white noise (seed 2),
each through ``partition_ongrid``; the remap of each field's labels through
a random permutation of its labels (62 and about 2.1 M), with
``torch.index_select`` of the same table and a device copy of the labels
timed beside it; the walk of refinement's first iteration on the blob
field (every edge voxel, the stop set at known == 2, the refinement cap);
and at 256^3 the walks of
chip_smoke's 2^20 random starts and of every voxel (the full-trajectory
partition's walk; no stop set, the initial cap).  Each kernel's output
must equal its plain PyTorch version.  Times are CUDA events, the median of
``--reps``.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from pybader_tpu_torch import grid, pipeline
    from pybader_tpu_torch.ops import edges, neargrid, reductions

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    out = {"root": os.path.relpath(root), "card": smi.stdout.strip()}

    def timed(fn):
        return cs.time_ms(fn, args.reps)

    def same(a, b, what):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{what}: kernel differs from plain")

    gen = torch.Generator(device="cuda").manual_seed(4)
    shape = (cs.SIZE,) * 3
    w = tuple(grid.distance_weights(cs.LATTICE, shape))
    rho, _ = cs.blob_field(shape, "cuda")
    noise = torch.rand(shape, dtype=torch.float64, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(2))
    for name, field in (("noise", noise), ("blob", rho)):
        labels, maxima = pipeline.partition_ongrid(field, None, w)
        k = len(maxima)
        table = torch.randperm(k, generator=gen, device="cuda").to(
            torch.int32)
        same((reductions.remap_labels_cuda(labels, table, k),),
             (reductions.remap_labels_plain(labels, table, k),), "remap")
        out[f"remap_{name}"] = {
            "labels": k,
            "ms": timed(lambda: reductions.remap_labels_cuda(labels, table,
                                                             k)),
            "index_select_ms": timed(lambda: torch.index_select(
                table, 0, labels.reshape(-1))),
            # a device copy moves the same 8 bytes a voxel: the rate the
            # card reaches on a plain stream
            "copy_ms": timed(labels.clone)}
    del noise  # labels: the blob field's
    codes = pipeline.step_codes(rho, None, w)
    tg = torch.as_tensor(grid.t_grad(cs.LATTICE, shape), device="cuda")
    known = edges.edge_find_cuda(labels, codes == 13)
    rows = neargrid.neargrid_rows_cuda(rho, codes, tg, True)
    starts = torch.nonzero(known.reshape(-1) == -2).reshape(-1).to(
        torch.int32)
    cap = neargrid.refine_cap(shape)
    same(neargrid.neargrid_walk_cuda(rows, starts, shape, cap, known),
         neargrid.neargrid_walk_plain(rows, starts, shape, cap, known),
         "walk")
    out["walk_iteration1"] = {
        "lanes": starts.numel(),
        "ms": timed(lambda: neargrid.neargrid_walk_cuda(rows, starts, shape,
                                                        cap, known))}
    del rho, codes, known, rows, labels
    shape = (cs.FULL_SIZE,) * 3
    rho, _ = cs.blob_field(shape, "cuda")
    w = tuple(grid.distance_weights(cs.LATTICE, shape))
    tg = torch.as_tensor(grid.t_grad(cs.LATTICE, shape), device="cuda")
    codes = pipeline.step_codes(rho, None, w)
    rows = neargrid.neargrid_rows_cuda(rho, codes, tg, False)
    cap = neargrid.initial_cap(shape)
    n = rho.numel()
    random = torch.randint(0, n, (cs.WALK_STARTS,), dtype=torch.int32,
                           device="cuda", generator=torch.Generator(
                               device="cuda").manual_seed(3))
    every = torch.arange(n, dtype=torch.int32, device="cuda")
    for name, starts in (("walk_random_256", random),
                         ("walk_full_256", every)):
        same(neargrid.neargrid_walk_cuda(rows, starts, shape, cap),
             neargrid.neargrid_walk_plain(rows, starts, shape, cap), name)
        out[name] = {"lanes": starts.numel(), "ms": timed(
            lambda: neargrid.neargrid_walk_cuda(rows, starts, shape, cap))}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
