"""Per-launch numbers of the walkers (and the mesh chase) in one default
``Bader()`` call.

Run from the repository root on a machine with one CUDA GPU:

    python3 tools/walk_launches.py [--root DIR] [--size 384] [--reps 5]
                                   [--mesh N]

It imports ``pybader_tpu_torch`` and ``chip_smoke`` from ``--root`` (default:
this repository; an older checkout unpacked with ``git archive`` works too),
runs chip_smoke's blob field at ``--size``^3 through a default ``Bader()``
with ``neargrid.neargrid_walk`` wrapped to keep each launch's inputs.  Then
it times each launch again on those inputs (CUDA events, the median of
``--reps``, chip_smoke's ``time_ms``) and replays it on its plain version
for its counts (lanes, lane-steps, warp-steps where the plain version
counts them, rows touched).  Prints one JSON line: the card, the sum of
the launches' times and one entry a launch.

With ``--mesh N`` the call runs on ``make_mesh(N, device="cuda")`` and the
launches kept are the shard walker's (``neargrid_walk_shard``: lanes,
lane-steps, the longest lane's steps, rows touched, and a bound of (rows
touched x 32 + lanes x 2 x 48) bytes over chip_smoke's memory rate) and
the mesh chase's (``chase_roots``: voxels, a bound of 5 bytes a voxel;
``chase_gather``, one a round and shard: voxels written, a bound of the
padded values' 4 bytes a voxel and the interior's roots and outputs, 8),
each with its time (``ms``: CUDA events around the wrapper, host work
included) and its kernels' device time (``device_ms``: one replay of
every launch under ``torch.profiler``).  The JSON line then holds each
kind's launches and the sums of their times and bounds.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def device_times(calls, first, names):
    """The device time (ms) of each call's kernels, from one run of the
    calls in order under torch.profiler: a call's kernels are those whose
    names contain one of ``names``, from one whose name contains
    ``first`` (the call's first kernel) to the next."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and any(k in e.name for k in names))
    out = []
    for t0, t1, name in spans:
        if first in name:
            out.append(0.0)
        if out:
            out[-1] += (t1 - t0) / 1e3
    if len(out) != len(calls):
        raise AssertionError(f"{len(out)} {first} spans for {len(calls)} "
                             f"calls")
    return out


def mesh_launches(cs, density, atoms, n, reps):
    """Keep, time and count the shard walker's and the chase's launches of
    a default Bader() call on n shards of the card."""
    from pybader_tpu_torch.ops import chase, neargrid
    from pybader_tpu_torch.parallel import make_mesh

    kept = {"neargrid_walk_shard": [], "chase_roots": [], "chase_gather": []}
    real = {"neargrid_walk_shard": neargrid.neargrid_walk_shard,
            "chase_roots": chase.chase_roots,
            "chase_gather": chase.chase_gather}

    def keeper(name, mod):
        # every argument outlives the call unchanged: the walker keeps its
        # input state, and the padded values, roots, rows and stop bitmaps
        # are not written again
        def keep(*args):
            kept[name].append(args)
            return real[name](*args)
        setattr(mod, name, keep)

    mods = {"neargrid_walk_shard": neargrid, "chase_roots": chase,
            "chase_gather": chase}
    with tempfile.TemporaryDirectory() as tmp:
        b = cs.blob_bader(density, atoms, tmp)
        b.mesh = make_mesh(n, device=cs.DEVICE)
        for name, mod in mods.items():
            keeper(name, mod)
        try:
            b()
        finally:
            for name, mod in mods.items():
                setattr(mod, name, real[name])
    record = {k: [] for k in kept}
    dev = {
        "neargrid_walk_shard": device_times(
            [lambda a=a: real["neargrid_walk_shard"](*a)
             for a in kept["neargrid_walk_shard"]],
            "walk_shard_kernel", ("walk_shard_kernel",)),
        "chase_roots": device_times(
            [lambda a=a: real["chase_roots"](*a)
             for a in kept["chase_roots"]],
            "tile_roots_kernel", ("tile_roots_kernel", "jump_kernel")),
        "chase_gather": device_times(
            [lambda a=a: real["chase_gather"](*a)
             for a in kept["chase_gather"]],
            "gather_kernel", ("gather_kernel",))}
    for args in kept["neargrid_walk_shard"]:
        st = {}
        neargrid.neargrid_walk_shard_plain(*args, stats=st)
        lanes = args[2][0].numel()
        cost = cs.bound(st["rows_touched"] * 32 + 2 * 48 * lanes)
        record["neargrid_walk_shard"].append({
            "lanes": lanes, "lane_steps": st["lane_steps"],
            "longest": st["longest"], "rows_touched": st["rows_touched"],
            "ms": cs.time_ms(lambda: real["neargrid_walk_shard"](*args),
                             reps),
            "bound_ms": cost["bound_ms"]})
    for (codes,) in kept["chase_roots"]:
        record["chase_roots"].append({
            "voxels": codes.numel(),
            "ms": cs.time_ms(lambda: real["chase_roots"](codes), reps),
            "bound_ms": cs.bound(5 * codes.numel())["bound_ms"]})
    for values, root, pads in kept["chase_gather"]:
        inner = (values.shape[0] - 2 * pads[0]) * \
            (values.shape[1] - 2 * pads[1]) * values.shape[2]
        record["chase_gather"].append({
            "voxels": inner,
            "ms": cs.time_ms(lambda: real["chase_gather"](values, root,
                                                          pads), reps),
            "bound_ms": cs.bound(4 * values.numel() + 8 * inner)["bound_ms"]})
    for k, v in record.items():
        for r, ms in zip(v, dev[k]):
            r["device_ms"] = ms
    return {k: {"launches": len(v), "total_ms": sum(r["ms"] for r in v),
                "total_device_ms": sum(r["device_ms"] for r in v),
                "total_bound_ms": sum(r["bound_ms"] for r in v),
                "each": v} for k, v in record.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--size", type=int, default=384)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--mesh", type=int, default=0,
                    help="keep the shard walker's and the chase's launches "
                    "of the call on this many shards of the card")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from pybader_tpu_torch.ops import neargrid

    if not torch.cuda.is_available():
        sys.exit("walk_launches: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    rho, atoms = cs.blob_field((args.size,) * 3, "cuda")
    density = rho.cpu().numpy()
    del rho
    if args.mesh:
        print(json.dumps({"root": os.path.relpath(root),
                          "card": smi.stdout.strip(), "mesh": args.mesh,
                          **mesh_launches(cs, density, atoms, args.mesh,
                                          args.reps)}), flush=True)
        return
    real = neargrid.neargrid_walk
    calls = []

    def keep(rows, starts, shape, max_steps, known=None):
        calls.append((rows, starts.clone(), shape, max_steps,
                      None if known is None else known.clone()))
        return real(rows, starts, shape, max_steps, known)

    with tempfile.TemporaryDirectory() as tmp:
        neargrid.neargrid_walk = keep
        try:
            cs.blob_bader(density, atoms, tmp)()
        finally:
            neargrid.neargrid_walk = real
    record = []
    for args_i in calls:
        st = {}
        neargrid.neargrid_walk_plain(*args_i, stats=st)
        record.append({"lanes": args_i[1].numel(),
                       "stop_set": args_i[4] is not None,
                       "ms": cs.time_ms(lambda: real(*args_i), args.reps),
                       **st})
    print(json.dumps({"root": os.path.relpath(root),
                      "card": smi.stdout.strip(),
                      "total_ms": sum(r["ms"] for r in record),
                      "launches": record}), flush=True)


if __name__ == "__main__":
    main()
