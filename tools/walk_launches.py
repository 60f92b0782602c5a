"""Per-launch numbers of the walkers (and the mesh chase) in one
``Bader()`` call.

Run from the repository root on a machine with one CUDA GPU:

    python3 tools/walk_launches.py [--root DIR] [--size 384] [--reps 5]
                                   [--mesh N] [--env NAME=VALUE ...]

It imports ``pybader_tpu_torch`` from ``--root`` (default: this
repository; an older checkout unpacked with ``git archive`` works too),
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

With ``--env NAME=VALUE`` (repeatable; chip_smoke's VARIANTS, e.g.
``--env PYBADER_TPU_BLOCK_WALK=1``) the call runs under those environment
variables and the launches kept are the block rounds' (``block_walk``)
and the q walker's (``neargrid_walk_q``).  For each launch: lanes, the
live tiles of a round, the lanes the function must walk (``walk_lanes``:
not done, and in a live tile), the lanes that step and whose state
changed, lane-steps and the longest lane's steps (from the plain
version), rows touched, the bound of ``chip_smoke.q_walk_cost`` from
those counts, ``ms`` (CUDA events around the wrapper, host work
included) and ``device_ms`` (one replay of every launch under
``torch.profiler``).  The JSON line holds each kind's launches, the sums
of their times and bounds and the lost time (device ms less bounds).

The inputs come from this checkout's ``chip_smoke`` and the kernels from
``--root``, so the counts of an older checkout's launches are this
checkout's plain versions' (the launches' inputs are the same: the
walks are bit for bit the same).
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
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


def stop_grid(bits, shape):
    """The known grid of a stop bitmap (2 at a stop voxel, else 0), which
    the plain versions read where the kernel was given the bitmap."""
    import torch

    i = torch.arange(bits.numel() * 32, device=bits.device)
    on = (bits.long()[i >> 5] >> (i & 31)) & 1
    n = shape[0] * shape[1] * shape[2]
    return (2 * on[:n]).to(torch.int8).reshape(shape)


def q_launches(cs, density, atoms, env, reps):
    """Keep, time and count the block rounds' and the q walker's launches
    of a default Bader() call under the environment ``env``."""
    import torch

    from pybader_tpu_torch.ops import block_walk, neargrid

    where = {"block_walk": (block_walk, "block_round_cuda",
                            block_walk.block_round_plain,
                            "block_walk_kernel"),
             "neargrid_walk_q": (neargrid, "neargrid_walk_q_cuda",
                                 neargrid.neargrid_walk_q_plain,
                                 "walk_q_kernel")}
    real = {k: getattr(mod, name) for k, (mod, name, _, _) in where.items()}
    kept = {k: [] for k in where}
    # a copy of each version of the known grids, which refinement updates
    # in place between walks, with the grid itself, so that no later grid
    # takes its address while it is kept (a stop bitmap, built afresh for
    # each walk and not written after, is kept as given)
    grids = {}

    def fingerprint(state):
        return [int(state[0].long().sum()), int(state[4].sum()),
                int(state[3].view(torch.int32).long().sum())]

    def keeper(kind):
        sig = inspect.signature(real[kind])

        def keep(*args, **kw):
            call = sig.bind(*args, **kw)
            known = call.arguments.get("known")
            if known is not None:
                key = (known.data_ptr(), known._version)
                if key not in grids:
                    grids[key] = (known, known.clone())
                call.arguments["known"] = grids[key][1]
            out = real[kind](*args, **kw)
            kept[kind].append((call, fingerprint(out)))
            return out
        return keep

    with tempfile.TemporaryDirectory() as tmp, cs.environ(env):
        for kind, (mod, name, _, _) in where.items():
            setattr(mod, name, keeper(kind))
        try:
            cs.blob_bader(density, atoms, tmp)()
        finally:
            for kind, (mod, name, _, _) in where.items():
                setattr(mod, name, real[kind])
    out = {}
    for kind, (_, _, plain, kernel) in where.items():
        calls = kept[kind]
        dev = device_times(
            [lambda c=c: real[kind](*c.args, **c.kwargs) for c, _ in calls],
            kernel, (kernel,)) if calls else []
        each = []
        for (c, seen), device_ms in zip(calls, dev):
            a = c.arguments
            live = a.get("live")
            known = a.get("known")
            if a.get("stop") is not None:
                known = stop_grid(a["stop"], a["shape"])
            st = {}
            steps = a["steps"] if kind == "block_walk" else a["max_steps"]
            if kind == "block_walk":
                want = plain(a["qrows"], a["state"], a["blocks"], live,
                             a["shape"], steps, known, stats=st)
            else:
                want = plain(a["qrows"], a["state"], a["shape"], steps,
                             known, stats=st)
            got = real[kind](*c.args, **c.kwargs)
            if fingerprint(got) != seen:
                raise AssertionError(f"{kind}: a replay differs from its "
                                     f"launch in the call")
            cs.state_equal(got, want)
            del got
            cost, counts = cs.q_walk_cost(a["state"], want, st, live,
                                          known is not None)
            del known
            each.append({
                "lanes": a["state"][0].numel(),
                **({"live_tiles": int(live.sum())} if live is not None
                   else {}),
                **counts, **{k: st.get(k) for k in (
                    "stepped", "lane_steps", "longest", "warp_steps",
                    "rows_touched")},
                "ms": cs.time_ms(lambda: real[kind](*c.args, **c.kwargs),
                                 reps),
                "device_ms": device_ms, **cost})
        total_dev = sum(r["device_ms"] for r in each)
        total_bound = sum(r["bound_ms"] for r in each)
        out[kind] = {"launches": len(each),
                     "total_ms": sum(r["ms"] for r in each),
                     "total_device_ms": total_dev,
                     "total_bound_ms": total_bound,
                     "lost_ms": total_dev - total_bound, "each": each}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--size", type=int, default=384)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--mesh", type=int, default=0,
                    help="keep the shard walker's and the chase's launches "
                    "of the call on this many shards of the card")
    ap.add_argument("--env", action="append", default=[],
                    help="run the call under this environment variable and "
                    "keep the block rounds' and the q walker's launches")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    cs = load_chip_smoke()
    from pybader_tpu_torch.ops import neargrid

    if not torch.cuda.is_available():
        sys.exit("walk_launches: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    rho, atoms = cs.blob_field((args.size,) * 3, "cuda")
    density = rho.cpu().numpy()
    del rho
    if args.env:
        env = dict(e.split("=", 1) for e in args.env)
        print(json.dumps({"root": os.path.relpath(root),
                          "card": smi.stdout.strip(), "env": env,
                          **q_launches(cs, density, atoms, env,
                                       args.reps)}), flush=True)
        return
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
