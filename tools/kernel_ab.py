"""Time the redesigned kernels of one checkout of the port on fixed inputs.

Run from the repository root on a machine with one CUDA GPU:

    python3 tools/kernel_ab.py [--root DIR] [--reps 20]

It imports ``pybader_tpu_torch`` from ``--root`` (default: this repository)
and builds every input with this repository's ``chip_smoke``, so the same
script times the kernels of an older checkout (unpacked with ``git
archive``) or of a variant of the sources on the same inputs and card;
compare two checkouts in one command, in turns (old, new, new, old).
Inputs, all made on the card from seeds: chip_smoke's 384^3 blob field and
384^3 white noise (seed 2), each through ``partition_ongrid``;

- resolve_roots on the one-step parents of both fields and on
  ``chip_smoke.roots_inputs`` (a ramp along x, a flat parent of odd length);
- remap_labels of each field's labels through a random permutation of its
  labels (62 and about 2.1 M), with ``torch.index_select`` of the same
  table and a device copy of the labels timed beside it;
- the walk of refinement's first iteration on the blob field (every edge
  voxel, the stop set at known == 2, the refinement cap);
- edge_check on the known grid after that walk (dense), on 0.6 M of its
  edges sampled with seed 5 (sparse), on the input the last edge_check of
  a default ``Bader()`` call receives (last) and on
  ``chip_smoke.edge_check_inputs`` (ragged grids, an axis of 2, 25 %
  vacuum);
- the chase on shard 0's padded block of the first chase round on
  ``make_mesh(4, device="cuda")`` (the flood seed; the table's row);
- at 256^3 the walks of chip_smoke's 2^20 random starts and of every voxel
  (the full-trajectory partition's walk; no stop set, the initial cap).

Each kernel's output must equal its plain PyTorch version.  Times are CUDA
events, the median of ``--reps``.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    """This repository's chip_smoke, whatever ``--root`` is."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    cs = load_chip_smoke()
    from pybader_tpu_torch import grid, pipeline
    from pybader_tpu_torch.ops import chase, edges, neargrid, pointer
    from pybader_tpu_torch.ops import reductions, stencil
    from pybader_tpu_torch.parallel import make_mesh

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA device")
    out = {"root": os.path.relpath(root), "card": cs.card()}

    def timed(fn):
        return cs.time_ms(fn, args.reps)

    def same(a, b, what):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{what}: kernel differs from plain")

    def roots(name, parent):
        same((pointer.resolve_roots_cuda(parent),),
             (pointer.resolve_roots_plain(parent),), name)
        out[name] = {"ms": timed(lambda: pointer.resolve_roots_cuda(parent))}

    def check(name, known, labels, is_max):
        same((edges.edge_check_cuda(known, labels, is_max),),
             (edges.edge_check_plain(known, labels, is_max),), name)
        out[name] = {"edges": int((known == -2).sum()), "ms": timed(
            lambda: edges.edge_check_cuda(known, labels, is_max))}

    gen = torch.Generator(device="cuda").manual_seed(4)
    shape = (cs.SIZE,) * 3
    w = tuple(grid.distance_weights(cs.LATTICE, shape))
    rho, atoms = cs.blob_field(shape, "cuda")
    noise = torch.rand(shape, dtype=torch.float64, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(2))
    for name, field in (("noise", noise), ("blob", rho)):
        parent = stencil.parent_from_step_codes(
            pipeline.step_codes(field, None, w))
        roots(f"roots_{name}", parent)
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
    del noise, parent  # labels: the blob field's
    for name, parent in cs.roots_inputs(shape, "cuda").items():
        roots(f"roots_{name.split()[-1]}", parent)
    del parent
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
    pos, done = neargrid.neargrid_walk_cuda(rows, starts, shape, cap, known)
    roots_ = pointer.resolve_roots_plain(
        stencil.parent_from_step_codes(codes)).reshape(-1)
    pos = torch.where(done, pos, roots_[pos.long()])
    is_max = codes == 13
    pipeline._apply_walk_results(labels, known, starts, pos)
    check("check_dense", known, labels, is_max)
    check("check_sparse", cs.sampled_edges(
        known, 600_000, torch.Generator(device="cuda").manual_seed(5)),
        labels, is_max)
    del rows, known, roots_
    last = []
    with tempfile.TemporaryDirectory() as tmp, cs.last_edge_check(last):
        cs.blob_bader(rho.cpu().numpy(), atoms, tmp)()
    check("check_last", *last)
    del last
    for name, *case in cs.edge_check_inputs(
            rho, is_max, torch.Generator(device="cuda").manual_seed(6)):
        check(f"check_{name} {'x'.join(map(str, case[0].shape))}", *case)
    codes_b, values, _, _ = cs.mesh_chase_inputs(
        rho, shape, make_mesh(cs.MESH_SHARDS, device="cuda"), w)
    cs.chase_same(chase.chase_cuda(values, codes_b),
                  chase.chase_plain(values, codes_b))
    out["chase_shard_block"] = {"ms": timed(lambda: chase.chase_cuda(
        values, codes_b))}
    del rho, codes, labels, codes_b, values
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
