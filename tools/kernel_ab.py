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

- ongrid_step_codes on each field (the blob field: the main path's
  input) and on ``chip_smoke.stencil_inputs`` (ragged grids, axes of 1
  and 2, negative and tie-heavy densities, the mesh's shard block);
- neargrid_rows on each field's step codes with ``strict_grad=True`` (the
  blob field: the default call's input), t_grad from the host, with
  PyTorch's fill of the same rows timed beside it;
- min_pair on each field's basin labels in discovery order and maxima
  (``labels_mo`` and ``is_max`` of chip_smoke's partition chain: 62 and
  about 2.1 M labels; the blob field's is the default call's input);
- nginit_codes and neargrid_qrows on the blob field (they share the
  rows' gradient code), t_grad a device tensor as chip_smoke gives it;
- surface_min_d2 on the surface stage's input (the blob field's atom
  labels and their edges), on ``chip_smoke.noise_surface_inputs`` (the
  noise field's atom labels, its basins as atoms) and on
  ``chip_smoke.surface_inputs`` (five atoms that own no voxel, labels of
  -1 and num_atoms, a hexagonal lattice, a mesh shard with its origin);
- charge_volume on each field's labels (62 and about 2.1 M) and on the
  blob field's atom labels (60, ``chip_smoke.atom_labels_of``);
- edge_find on each field's labels with the stencil's maxima (on the blob
  field: refinement's input), on the atom labels with ``edges.local_max``
  (the surface stage's input) and on ``chip_smoke.edge_find_inputs``
  (ragged grids, axes of 2, 25 % vacuum);

- resolve_roots on the one-step parents of both fields and on
  ``chip_smoke.roots_inputs`` (a ramp along x, a flat parent of odd length),
  with ``device_ms``;
- remap_labels of each field's labels through a random permutation of its
  labels (62 and about 2.1 M), with ``torch.index_select`` of the same
  table and a device copy of the labels timed beside it;
- the walk of refinement's first iteration on the blob field (every edge
  voxel, the stop set at known == 2, the refinement cap), with
  ``device_ms`` (the walker's and its stop bitmap's kernels);
- the q walks of that iteration (``--only qwalk,block``): the screened
  q walker on its padded edge bucket at the refinement cap
  (``qwalk_fresh``) and at a cap of 3 (``qwalk_cap3``), on the block
  phase's hand-off (``qwalk_handoff``: mostly done lanes, the variant
  calls' input), one block round of 24 steps on the bucket
  (``block_round``) and the whole block phase (``block_phase``, as the
  checkout's ``walk_q`` runs it), each with ``device_ms`` of its walk
  kernel alone; the stop bitmap is built once and passed to the kernels
  in place of known where the checkout's wrappers take it;
  and the q walker and one block round on the same lanes with no stop
  set (``qwalk_free``, ``block_round_free``) and with a stop set that
  holds no voxel (``..._free_bits``): the same walks, so the two differ
  only by the stop-set reads;
- edge_check on the known grid after that walk (dense), on 0.6 M of its
  edges sampled with seed 5 (sparse), on the input the last edge_check of
  a default ``Bader()`` call receives (last) and on
  ``chip_smoke.edge_check_inputs`` (ragged grids, axes of 2, 25 %
  vacuum);
- the chase on shard 0's padded block of the first chase round on
  ``make_mesh(4, device="cuda")`` (the flood seed; the table's row);
- on that mesh, ``sharded_chase`` of the mesh partition's flood seed
  (``mesh_chase``) and ``walk_sharded`` of refinement's first iteration
  (``mesh_walk``: every edge voxel, the stop set, the refinement cap, the
  shards' rows built beforehand), each with ``device_ms`` of its own
  kernels (the chase's; the shard walker's and its stop bitmaps') beside
  the torch kernels of the host loop (``other_ms``);
- at 256^3 the walks of chip_smoke's 2^20 random starts and of every voxel
  (the full-trajectory partition's walk; no stop set, the initial cap),
  with ``device_ms``.

Each kernel's output must equal its plain PyTorch version (the rows bit
for bit).  Times are CUDA events, the median of ``--reps``; for
ongrid_step_codes, surface_min_d2, neargrid_rows, min_pair, nginit_codes,
neargrid_qrows and resolve_roots also ``device_ms``, the device time of
the call's kernels alone (from ``torch.profiler``, the mean of ``--reps``
calls), which leaves out the wrapper's own host work and copies.
``--only stencil,surface`` (prefixes of the case names) times those
cases alone; ``--only roots,chase,mesh`` the roots, the iteration-1 walk
and the chase on one device and on the mesh; ``--only qwalk,block`` the
q walks.
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
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
    ap.add_argument("--only", default="",
                    help="comma-separated prefixes of the cases to time")
    args = ap.parse_args(argv)
    only = tuple(p for p in args.only.split(",") if p)

    def want(name):
        return not only or name.startswith(only)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from unittest import mock

    import torch

    cs = load_chip_smoke()
    from pybader_tpu_torch import grid, pipeline
    from pybader_tpu_torch.ops import _cuda, block_walk
    from pybader_tpu_torch.ops import atoms as atoms_ops
    from pybader_tpu_torch.ops import chase, edges, neargrid, pointer
    from pybader_tpu_torch.ops import reductions, stencil
    from pybader_tpu_torch.parallel import make_mesh

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA device")
    out = {"root": os.path.relpath(root), "card": cs.card()}

    def timed(fn):
        return cs.time_ms(fn, args.reps)

    def device_ms(fn, names=None):
        """The mean device time of a call's kernels; with ``names``, of the
        kernels whose names contain one of them, and of the others."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        mine = other = 0.0
        for e in prof.key_averages():
            if e.key.startswith(("Memcpy", "Memset")):
                continue
            if names is None or any(n in e.key for n in names):
                mine += e.device_time_total
            else:
                other += e.device_time_total
        ms = mine / 1e3 / args.reps
        return ms if names is None else (ms, other / 1e3 / args.reps)

    def same(a, b, what):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{what}: kernel differs from plain")

    def codes_case(name, density, weights):
        if not want(name):
            return
        same((stencil.ongrid_step_codes_cuda(density, weights),),
             (stencil.ongrid_step_codes_plain(density, weights),), name)
        def call():
            return stencil.ongrid_step_codes_cuda(density, weights)

        out[name] = {"ms": timed(call), "device_ms": device_ms(call)}

    def surface(name, labels, mask, atoms_t, k, origin=(0, 0, 0),
                grid_shape=None, lattice=cs.LATTICE):
        if not want(name):
            return
        lat = torch.as_tensor(lattice)  # on the host, as Bader has it
        call = (labels, mask, lat, atoms_t, k, tuple(origin), grid_shape)
        cs.close(1e-12)(atoms_ops.surface_min_d2_cuda(*call),
                        atoms_ops.surface_min_d2_plain(
                            labels, mask, lat.cuda(), *call[3:]))
        def run():
            return atoms_ops.surface_min_d2_cuda(*call)

        out[name] = {"edges": int(mask.sum()), "atoms": k, "ms": timed(run),
                     "device_ms": device_ms(run)}

    def rows(name, density, codes, t_grad, strict):
        if not want(name):
            return
        got = neargrid.neargrid_rows_cuda(density, codes, t_grad, strict)
        cs.bits_equal(got, neargrid.neargrid_rows_plain(density, codes,
                                                        t_grad, strict))

        def call():
            return neargrid.neargrid_rows_cuda(density, codes, t_grad,
                                               strict)

        # zero_ms: PyTorch's fill of the same rows, a pure write stream of
        # their bytes (32 of the 41 a voxel the kernel moves)
        out[name] = {"ms": timed(call), "device_ms": device_ms(call),
                     "zero_ms": timed(got.zero_)}
        del got

    def pair(name, labels, mask, k):
        if not want(name):
            return
        same(reductions.min_pair_cuda(labels, mask, k),
             reductions.min_pair_plain(labels, mask, k), name)

        def call():
            return reductions.min_pair_cuda(labels, mask, k)

        out[name] = {"labels": k, "ms": timed(call),
                     "device_ms": device_ms(call)}

    def gradient_kernels(density, codes):
        """nginit_codes and neargrid_qrows, t_grad a device tensor."""
        tg = torch.as_tensor(grid.t_grad(cs.LATTICE, density.shape),
                             device="cuda")
        for name, kernel, plain in (
                ("nginit_blob", lambda: stencil.neargrid_init_codes_cuda(
                    density, codes, tg),
                 lambda: stencil.neargrid_init_codes_plain(density, codes,
                                                           tg)),
                ("qrows_blob", lambda: neargrid.neargrid_qrows_cuda(
                    density, codes, tg, True),
                 lambda: neargrid.neargrid_qrows_plain(density, codes, tg,
                                                       True))):
            if not want(name):
                continue
            same((kernel(),), (plain(),), name)
            out[name] = {"ms": timed(kernel), "device_ms": device_ms(kernel)}

    def roots(name, parent):
        if not want(name):
            return
        same((pointer.resolve_roots_cuda(parent),),
             (pointer.resolve_roots_plain(parent),), name)

        def call():
            return pointer.resolve_roots_cuda(parent)

        out[name] = {"ms": timed(call), "device_ms": device_ms(call)}

    def sums(name, density, labels, k):
        if not want(name):
            return
        cs.close(1e-9)(reductions.charge_volume_cuda(density, labels, k),
                       reductions.charge_volume_plain(density, labels, k))
        out[name] = {"labels": k, "ms": timed(
            lambda: reductions.charge_volume_cuda(density, labels, k))}

    def find(name, labels, is_max):
        if not want(name):
            return
        same((edges.edge_find_cuda(labels, is_max),),
             (edges.edge_find_plain(labels, is_max),), name)
        out[name] = {"ms": timed(lambda: edges.edge_find_cuda(labels,
                                                              is_max))}

    def check(name, known, labels, is_max):
        if not want(name):
            return
        same((edges.edge_check_cuda(known, labels, is_max),),
             (edges.edge_check_plain(known, labels, is_max),), name)
        out[name] = {"edges": int((known == -2).sum()), "ms": timed(
            lambda: edges.edge_check_cuda(known, labels, is_max))}

    def q_cases(rho, codes, known, starts, cap):
        """The q walks of refinement's first iteration, each against its
        plain version (the phase: the same phase with every op on its
        plain version), with the device time of its walk kernel alone."""
        tg = torch.as_tensor(grid.t_grad(cs.LATTICE, shape), device="cuda")
        qrows = neargrid.neargrid_qrows_cuda(rho, codes, tg, True)
        padded = neargrid.pad_to(starts, neargrid.bucket_size(starts.numel()))
        bits = neargrid.stop_bitmap_cuda(known)

        # the stop set as the checkout's wrappers take it: the bitmap in
        # place of known, or (an older checkout) known
        new = "stop" in inspect.signature(
            neargrid.neargrid_walk_q_cuda).parameters
        kq = {"stop": bits} if new else {"known": known}
        fresh = neargrid.init_state(padded, True)
        order, blocks, live = block_walk.prep_round(fresh, shape)
        ordered = tuple(a[order] for a in fresh)

        def phase():  # as the checkout's walk_q runs it
            if new:
                return block_walk.unsort(*block_walk.block_rounds(
                    qrows, fresh, shape, stop=bits))
            return block_walk.block_phase(qrows, fresh, shape, known)

        handed = phase()
        empty = torch.zeros_like(known)  # a stop set that holds no voxel
        ke = {"stop": neargrid.stop_bitmap_cuda(empty)} if new else {
            "known": empty}

        def plain_phase():
            with mock.patch.object(_cuda, "on_cuda", lambda t: False):
                return block_walk.block_phase(qrows, fresh, shape, known)

        cases = {
            "qwalk_fresh": (
                lambda: neargrid.neargrid_walk_q_cuda(
                    qrows, fresh, shape, cap, **kq),
                lambda: neargrid.neargrid_walk_q_plain(
                    qrows, fresh, shape, cap, known), "walk_q_kernel"),
            "qwalk_cap3": (
                lambda: neargrid.neargrid_walk_q_cuda(
                    qrows, fresh, shape, 3, **kq),
                lambda: neargrid.neargrid_walk_q_plain(
                    qrows, fresh, shape, 3, known), "walk_q_kernel"),
            "qwalk_handoff": (
                lambda: neargrid.neargrid_walk_q_cuda(
                    qrows, handed, shape, cap, **kq),
                lambda: neargrid.neargrid_walk_q_plain(
                    qrows, handed, shape, cap, known), "walk_q_kernel"),
            "block_round": (
                lambda: block_walk.block_round_cuda(
                    qrows, ordered, blocks, live, shape, 24, **kq),
                lambda: block_walk.block_round_plain(
                    qrows, ordered, blocks, live, shape, 24, known),
                "block_walk_kernel"),
            "block_phase": (phase, plain_phase, "block_walk_kernel"),
            "qwalk_free": (
                lambda: neargrid.neargrid_walk_q_cuda(
                    qrows, fresh, shape, cap),
                lambda: neargrid.neargrid_walk_q_plain(
                    qrows, fresh, shape, cap), "walk_q_kernel"),
            "qwalk_free_bits": (
                lambda: neargrid.neargrid_walk_q_cuda(
                    qrows, fresh, shape, cap, **ke),
                lambda: neargrid.neargrid_walk_q_plain(
                    qrows, fresh, shape, cap), "walk_q_kernel"),
            "block_round_free": (
                lambda: block_walk.block_round_cuda(
                    qrows, ordered, blocks, live, shape, 24),
                lambda: block_walk.block_round_plain(
                    qrows, ordered, blocks, live, shape, 24),
                "block_walk_kernel"),
            "block_round_free_bits": (
                lambda: block_walk.block_round_cuda(
                    qrows, ordered, blocks, live, shape, 24, **ke),
                lambda: block_walk.block_round_plain(
                    qrows, ordered, blocks, live, shape, 24),
                "block_walk_kernel")}
        for name, (kernel, plain, kname) in cases.items():
            if not want(name):
                continue
            cs.state_equal(kernel(), plain())
            out[name] = {"ms": timed(kernel),
                         "device_ms": device_ms(kernel, (kname,))[0]}

    def mesh_cases(mesh, rho, codes, w, starts, known, tg, cap, rows):
        """sharded_chase and walk_sharded on the mesh, each against the
        single-device result, with their kernels' device time."""
        from pybader_tpu_torch.parallel import mesh as pmesh
        from pybader_tpu_torch.parallel import sharded
        from pybader_tpu_torch.parallel.chase import sharded_chase
        from pybader_tpu_torch.parallel.walk import shard_rows, walk_sharded

        lay = pmesh.Layout(mesh, rho.shape)
        bk = sharded.step_codes(pmesh.shard(lay, rho), w)
        seed = sharded._seed_local(bk, None)[0]
        # the fixed point: each voxel's seed value at its root
        root = pointer.resolve_roots_cuda(
            stencil.parent_from_step_codes(codes)).reshape(-1).long()
        want_flood = seed.join("cuda").reshape(-1)[root].reshape(rho.shape)
        if not torch.equal(sharded_chase(mesh, seed, bk).join("cuda"),
                           want_flood):
            raise AssertionError("mesh_chase: differs from the seed at the "
                                 "roots")
        del root, want_flood

        def chase_call():
            return sharded_chase(mesh, seed, bk)

        dev, other = device_ms(chase_call, ("tile_roots_kernel",
                                            "jump_kernel", "gather_kernel",
                                            "pointer_kernel"))
        out["mesh_chase"] = {"ms": timed(chase_call), "device_ms": dev,
                             "other_ms": other}
        srows = shard_rows(pmesh.shard(lay, rho), pmesh.shard(lay, codes), tg,
                           True)
        stop = pmesh.shard(lay, known == 2)

        def walk_call():
            return walk_sharded(mesh, starts, rho, codes, stop, tg, True, cap,
                                rows=srows)

        same(walk_call(), neargrid.neargrid_walk_cuda(rows, starts,
                                                      rho.shape, cap, known),
             "mesh_walk")
        dev, other = device_ms(walk_call, ("walk_shard_kernel",
                                           "stop_bitmap_kernel"))
        out["mesh_walk"] = {"lanes": starts.numel(), "ms": timed(walk_call),
                            "device_ms": dev, "other_ms": other}

    gen = torch.Generator(device="cuda").manual_seed(4)
    shape = (cs.SIZE,) * 3
    w = tuple(grid.distance_weights(cs.LATTICE, shape))
    rho, atoms = cs.blob_field(shape, "cuda")
    noise = torch.rand(shape, dtype=torch.float64, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(2))
    for name, field in (("noise", noise), ("blob", rho)):
        codes_case(f"stencil_{name}", field, w)
        codes = pipeline.step_codes(field, None, w)
        rows(f"rows_{name}", field, codes, grid.t_grad(cs.LATTICE, shape),
             True)
        if name == "blob":
            gradient_kernels(field, codes)
        parent = stencil.parent_from_step_codes(codes)
        roots(f"roots_{name}", parent)
        if want(f"min_pair_{name}"):
            # the renumber stage's input, as chip_smoke.partition_kernels
            # makes it
            is_max = codes == 13
            rank = torch.cumsum(is_max.reshape(-1), 0) - 1
            root = pointer.resolve_roots_plain(parent).reshape(-1).long()
            pair(f"min_pair_{name}", rank[root].to(torch.int32).reshape(shape),
                 is_max, int(is_max.sum()))
            del is_max, rank, root
        labels, maxima = pipeline.partition_ongrid(field, None, w)
        k = len(maxima)
        sums(f"charge_volume_{name}", field, labels, k)
        find(f"find_{name}", labels, codes == 13)
        if name == "noise" and want("surface"):
            for key, (_, lab, atoms_t) in zip(
                    ("surface_noise", "surface_noise_basins"),
                    cs.noise_surface_inputs(field, labels, maxima, atoms)):
                surface(key, lab, edges.edge_find_plain(
                    lab, edges.local_max(field, lab)) == -2, atoms_t,
                    atoms_t.shape[0])
            del lab
        table = torch.randperm(k, generator=gen, device="cuda").to(
            torch.int32)
        if not want(f"remap_{name}"):
            continue
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
    del noise, parent  # labels, codes: the blob field's
    atom = cs.atom_labels_of(labels, maxima, atoms)
    sums("charge_volume_atoms", rho, atom, len(atoms))
    find("find_surface", atom, edges.local_max(rho, atom))
    atoms_t = torch.as_tensor(atoms, device="cuda")
    edge = edges.edge_find_plain(atom, edges.local_max(rho, atom)) == -2
    surface("surface_stage", atom, edge, atoms_t, len(atoms))
    gen8 = torch.Generator(device="cuda").manual_seed(8)
    for name, *case in cs.surface_inputs(atom, edge, atoms_t, gen8):
        surface(f"surface_{name}", *case)
    if want("stencil"):
        for name, density, weights, _ in cs.stencil_inputs(rho, shape):
            codes_case(f"stencil_{name} "
                       f"{'x'.join(map(str, density.shape))}", density,
                       weights)
        del density
    del atom, edge
    if only and not any(p.startswith(("roots", "walk", "check", "find",
                                      "chase", "mesh", "qwalk", "block"))
                        for p in only):
        print(json.dumps(out), flush=True)
        return
    for name, parent in cs.roots_inputs(shape, "cuda").items():
        roots(f"roots_{name.split()[-1]}", parent)
    del parent
    tg = grid.t_grad(cs.LATTICE, shape)
    known = edges.edge_find_cuda(labels, codes == 13)
    rows = neargrid.neargrid_rows_cuda(rho, codes, tg, True)
    starts = torch.nonzero(known.reshape(-1) == -2).reshape(-1).to(
        torch.int32)
    cap = neargrid.refine_cap(shape)
    same(neargrid.neargrid_walk_cuda(rows, starts, shape, cap, known),
         neargrid.neargrid_walk_plain(rows, starts, shape, cap, known),
         "walk")
    def walk1():
        return neargrid.neargrid_walk_cuda(rows, starts, shape, cap, known)

    out["walk_iteration1"] = {
        "lanes": starts.numel(), "ms": timed(walk1),
        "device_ms": device_ms(walk1, ("walk_kernel",
                                       "stop_bitmap_kernel"))}
    if not only or any(p.startswith(("qwalk", "block")) for p in only):
        q_cases(rho, codes, known, starts, cap)
    mesh = make_mesh(cs.MESH_SHARDS, device="cuda")
    if want("mesh"):
        mesh_cases(mesh, rho, codes, w, starts, known, tg, cap, rows)
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
    if want("check_last"):
        last = []
        with tempfile.TemporaryDirectory() as tmp, cs.last_edge_check(last):
            cs.blob_bader(rho.cpu().numpy(), atoms, tmp)()
        check("check_last", *last)
        del last
    for name, *case in cs.edge_check_inputs(
            rho, is_max, torch.Generator(device="cuda").manual_seed(6)):
        check(f"check_{name} {'x'.join(map(str, case[0].shape))}", *case)
    for name, *case in cs.edge_find_inputs(
            rho, is_max, torch.Generator(device="cuda").manual_seed(7)):
        find(f"find_{name} {'x'.join(map(str, case[0].shape))}", *case)
    if want("chase_shard_block"):
        codes_b, values, _, _ = cs.mesh_chase_inputs(rho, shape, mesh, w)
        cs.chase_same(chase.chase_cuda(values, codes_b),
                      chase.chase_plain(values, codes_b))
        out["chase_shard_block"] = {"ms": timed(lambda: chase.chase_cuda(
            values, codes_b))}
        del codes_b, values
    del rho, codes, labels
    if not want("walk_random_256") and not want("walk_full_256"):
        print(json.dumps(out), flush=True)
        return
    shape = (cs.FULL_SIZE,) * 3
    rho, _ = cs.blob_field(shape, "cuda")
    w = tuple(grid.distance_weights(cs.LATTICE, shape))
    tg = grid.t_grad(cs.LATTICE, shape)
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
        if not want(name):
            continue
        same(neargrid.neargrid_walk_cuda(rows, starts, shape, cap),
             neargrid.neargrid_walk_plain(rows, starts, shape, cap), name)
        def walk():
            return neargrid.neargrid_walk_cuda(rows, starts, shape, cap)

        out[name] = {"lanes": starts.numel(), "ms": timed(walk),
                     "device_ms": device_ms(walk, ("walk_kernel",))}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
