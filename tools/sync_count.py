"""Synchronisations and kernel launches of one benchmark analysis on the
card, to hold a change to the parent's counts.

Run from the repository root on a machine with one CUDA GPU:

    python3 tools/sync_count.py [--root DIR] [--workload default.bulk384]
                               [--seed N]

It takes ``pybader_tpu_torch`` and ``benchmark_torch`` from ``--root`` (an
older checkout unpacked with ``git archive``; default this one), makes the
cell's first density as the benchmark does, runs one warm analysis, and
then one analysis under ``torch.cuda.set_sync_debug_mode("warn")``: the
synchronising calls it makes (``syncs``, by source file in
``sync_files``) and its kernel launches by op (``launches``).  The last
line of standard output is one JSON object.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import warnings
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=ROOT)
    p.add_argument("--workload", default="default.bulk384")
    p.add_argument("--seed", type=int, default=2 ** 31 + 11)
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    for path in (os.path.join(root, "benchmark_torch"), root):
        sys.path.insert(0, path)
    import numpy as np
    import torch

    import densities
    import run
    from pybader_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        raise SystemExit("sync_count.py needs a CUDA device")
    _cuda.library()
    bench = run.read_json(root, "BENCHMARK.json")
    _, config, traffic, _, _ = run.cell_spec(bench, args.workload)
    out_dir = tempfile.mkdtemp(prefix="sync-count-")
    inputs = densities.make_inputs(dict(traffic, count=1),
                                   np.asarray(config["lattice"]), args.seed,
                                   "cuda", file_dir=out_dir)
    analyst = run.Analyst(inputs, config, traffic, "cuda", out_dir)
    sink = open(os.devnull, "w")
    result = {"root": root, "workload": args.workload, "seed": args.seed,
              "card": torch.cuda.get_device_name(0)}
    with contextlib.redirect_stdout(sink):
        analyst(0)
        torch.cuda.synchronize()
        before = Counter(_cuda.launches)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                analyst(0)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        launches = Counter(_cuda.launches) - before
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
        result["syncs"] = len(syncs)
        result["sync_files"] = dict(Counter(
            os.path.relpath(w.filename, root) if w.filename.startswith(root)
            else os.path.basename(w.filename) for w in syncs))
        result["launches"] = dict(sorted(launches.items()))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
