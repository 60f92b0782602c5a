"""Times of the port's CHGCAR read (``pybader_tpu_torch.io.vasp.read``) on
this host: a CHGCAR of random densities at ``--size``³ (and a spin block
with ``--spin``) written as ``benchmark_torch/densities.write_chgcar``
writes the benchmark's, then read by the native direct path at each
thread count and by the Python path it falls back on (the library's load
made to fail), the grids checked bit for bit against each other.  Each
read comes after the last one's grids are dropped, so that the direct
path's grid lands in a warm pooled buffer (``warm`` in its span) from its
second read on.

    python3 tools/read_rates.py [--size 256] [--spin] [--reps 3]
        [--threads 1,2,4,8,0] [--out PATH]

Each line of standard output is one JSON record: ``what`` (``direct`` with
its ``threads``, 0 for the default; ``python``), the file's bytes, the
median and every time over ``--reps``, and the ``read.*`` spans'
counters; the first line gives the host's CPUs and the card's name and
power limit.  The file is written to a temporary directory and removed.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmark_torch"))

from densities import write_chgcar  # noqa: E402
from pybader_tpu_torch import trace  # noqa: E402
from pybader_tpu_torch.io import _fastparse, vasp  # noqa: E402


def host():
    model = ""
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                model = line.split(":", 1)[1].strip()
                break
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        card = None
    return {"cpus": len(os.sched_getaffinity(0)), "cpu": model,
            "card": card}


def timed(path, spin, threads, reps):
    """Times of ``reps`` reads, each after the last read's grids are
    dropped (their host buffers back in the pool, as in a loop over files),
    with the last read's grids and span counters."""
    times, grids, counters = [], None, {}
    for _ in range(reps):
        grids, spans = None, []
        with contextlib.redirect_stdout(io.StringIO()), \
                trace.recording(spans):
            t0 = time.perf_counter()
            grids = vasp.read(path, spin_flag=spin, threads=threads)[0]
            times.append(time.perf_counter() - t0)
        counters = {s.name: s.counters for s in spans}
    return times, grids, counters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spin", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--threads", default="1,2,4,8,0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    n = args.size
    rng = np.random.default_rng(22)
    density = {"charge": rng.lognormal(0.0, 2.0, (n, n, n))}
    if args.spin:
        density["spin"] = rng.standard_normal((n, n, n)) * 0.1
    lattice = np.diag([20.0, 20.0, 20.0])
    lines = [dict(what="host", **host())]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "CHGCAR")
        write_chgcar(path, density, lattice, rng.random((8, 3)) * 20.0)
        size = os.path.getsize(path)
        del density
        _fastparse.load_chgcar()  # the build, outside the times
        ref = None
        for th in [int(t) for t in args.threads.split(",")]:
            times, grids, counters = timed(path, args.spin, th or None,
                                           args.reps)
            if ref is None:
                ref = {k: v.copy() for k, v in grids.items()}
            lines.append({"what": "direct", "threads": th, "bytes": size,
                          "median_s": statistics.median(times),
                          "times_s": times, "spans": counters,
                          "equal": all(np.array_equal(
                              grids[k].view(np.int64), ref[k].view(np.int64))
                              for k in ref)})
        real = _fastparse.load_chgcar

        def broken():
            raise OSError("no library")
        _fastparse.load_chgcar = broken
        try:
            times, grids, counters = timed(path, args.spin, None,
                                           min(args.reps, 2))
        finally:
            _fastparse.load_chgcar = real
        lines.append({"what": "python", "bytes": size,
                      "median_s": statistics.median(times),
                      "times_s": times, "spans": counters,
                      "equal": all(np.array_equal(
                          grids[k].view(np.int64), ref[k].view(np.int64))
                          for k in ref)})
    for rec in lines:
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
