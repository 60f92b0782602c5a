"""Device-time breakdown of the ``Bader()`` runs of chip_smoke.py.

Run from the repository root on a machine with one CUDA GPU:

    python3 tools/profile_ongrid.py [--size 384] [--warm 3] [--default]
                                    [--mesh N] [--trace PATH] [--root DIR]

It builds chip_smoke's blob density at ``--size``^3, runs
``Bader(method='ongrid')()`` (with ``--default``: ``Bader()()``, the default
profile; with ``--mesh N``: on N shards of the card,
``make_mesh(N, device="cuda")``) on the card ``--warm`` times unprofiled,
then once under
``torch.profiler``, and prints the wall time of each run and one JSON line
with the device time of the profiled run by kind: host<->device copies,
each hand-written kernel of ``pybader_tpu_torch/csrc``, every other kernel,
the share of the wall time in which the device was busy, and the sums of
edge_check's, resolve_roots', charge_volume's and edge_find's kernels over
their launches.  ``--trace``
also writes the chrome trace.  ``--root`` profiles the port of another
checkout (unpacked with ``git archive``), with this script's kernel names,
which include those of earlier designs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if "--root" in sys.argv:
    ROOT = os.path.abspath(sys.argv[sys.argv.index("--root") + 1])
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from pybader_tpu_torch.parallel import make_mesh  # noqa: E402

# __global__ functions of csrc/*.cu, matched in the demangled kernel names
# (check_flags/check_near: the edge_check design before edge_check_kernel;
# find_flags/find_known: edge_find's before edge_find_kernel)
HAND_WRITTEN = ("ongrid_step_codes_kernel", "jump_kernel", "min_pair_kernel",
                "remap_kernel", "charge_volume_kernel",
                "charge_volume_blocks_kernel", "surface_min_d2_kernel",
                "fill_int_kernel", "zero_sums_kernel", "fill_u64_kernel",
                "find_flags_kernel", "find_known_kernel", "edge_find_kernel",
                "check_flags_kernel", "check_near_kernel",
                "edge_check_kernel", "tile_roots_kernel", "rows_kernel",
                "walk_kernel", "pointer_kernel", "gather_kernel",
                "walk_shard_kernel", "stop_bitmap_kernel")
# kernels of one op, summed over its launches; on one device jump_kernel
# runs only in the roots (the chase runs on a mesh)
SUMS = {"edge_check": ("check_flags_kernel", "check_near_kernel",
                       "edge_check_kernel"),
        "resolve_roots": ("jump_kernel", "tile_roots_kernel"),
        "charge_volume": ("zero_sums_kernel", "charge_volume_kernel",
                          "charge_volume_blocks_kernel"),
        "edge_find": ("find_flags_kernel", "find_known_kernel",
                      "edge_find_kernel")}
ONGRID = {"method": "ongrid", "refine_method": "ongrid"}


def timed_call(density, atoms, tmp, config, mesh=None):
    b = chip_smoke.blob_bader(density, atoms, tmp, **config)
    b.mesh = mesh
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, b.stage_seconds


def kind_of(name: str) -> str:
    if name.startswith("Memcpy"):
        for d in ("HtoD", "DtoH", "DtoD"):
            if d in name:
                return f"memcpy {d}"
        return "memcpy other"
    if name.startswith("Memset"):
        return "memset"
    for k in HAND_WRITTEN:
        if k in name:
            return k
    return "other kernels"


def breakdown(prof, wall_s: float) -> dict:
    """Device activity of a profiled run: per kind (count, ms), the
    hand-written kernels' total, and the busy share of the wall time
    (union of the device intervals)."""
    from torch.autograd import DeviceType

    rows, spans = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        n, us = rows.get(kind_of(e.name), (0, 0.0))
        rows[kind_of(e.name)] = (n + 1, us + (t1 - t0))
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    return {
        "wall_s": wall_s,
        "busy_share": busy_us / (wall_s * 1e6),
        "hand_written_ms": sum(us for k, (_, us) in rows.items()
                               if k in HAND_WRITTEN) / 1e3,
        "kinds": {k: {"count": n, "ms": us / 1e3}
                  for k, (n, us) in sorted(rows.items())},
        "sums_ms": {op: sum(rows.get(k, (0, 0.0))[1] for k in ks) / 1e3
                    for op, ks in SUMS.items()},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=chip_smoke.SIZE)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--default", action="store_true",
                    help="profile the default profile instead of ongrid")
    ap.add_argument("--mesh", type=int, default=0,
                    help="run on a mesh of this many shards of the card")
    ap.add_argument("--trace", help="write the chrome trace to this path")
    ap.add_argument("--root", help="the checkout whose port is profiled "
                    "(read at import)")
    args = ap.parse_args(argv)
    config = {} if args.default else ONGRID
    if not torch.cuda.is_available():
        sys.exit("profile_ongrid: no CUDA device")
    chip_smoke.card()
    from torch.profiler import ProfilerActivity, profile

    shape = (args.size,) * 3
    rho, atoms = chip_smoke.blob_field(shape, "cuda")
    density = rho.cpu().numpy()
    del rho
    torch.cuda.empty_cache()
    mesh = make_mesh(args.mesh, device="cuda") if args.mesh else None
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.warm):
            wall, stages = timed_call(density, atoms, tmp, config, mesh)
            print(f"warm {i}: {wall:.3f} s {json.dumps(stages)}", flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, stages = timed_call(density, atoms, tmp, config, mesh)
    print(f"profiled: {wall:.3f} s {json.dumps(stages)}", flush=True)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps(breakdown(prof, wall)))


if __name__ == "__main__":
    main()
