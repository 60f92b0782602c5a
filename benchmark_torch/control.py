"""The control of ``correct``: the plain reference put in the program's
place and computed one precision below the configuration's f64, in f32.
Its numbers must fail ``limits.json``; they set each limit's upper
reading.

    python benchmark_torch/control.py --workload <cell> --seeds 11 12 13

runs at the cell's own size on the card:
for each seed, the density the harness would check (drawn from the seed
among the mix's densities), analysed in f64 and in f32, compared as a run
compares the program.  One JSON line a seed, then the least reading of
each number over the seeds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import compare  # noqa: E402
import densities  # noqa: E402
import reference  # noqa: E402
from run import ROOT, cell_spec, checked_density, read_json  # noqa: E402


def control_numbers(config, traffic, seed, device):
    """The compared numbers of the f32 reference against the f64 one on
    the density a run of ``seed`` checks."""
    lattice = np.asarray(config["lattice"])
    index = checked_density(seed, int(traffic["count"]))
    fields, atoms = densities.make_input(traffic, lattice, seed, index, device)
    profile = dict(config["profile"])
    profile.update(traffic.get("call", {}))
    want = reference.analyse(fields, lattice, atoms, profile, device=device)
    got = reference.analyse(fields, lattice, atoms, profile, device=device,
                            dtype=torch.float32)
    return compare.numbers(got, want)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    _, config, traffic, _, _ = cell_spec(read_json(ROOT, "BENCHMARK.json"),
                                         args.workload)
    lim = compare.limits()
    readings = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        values = control_numbers(config, traffic, seed, "cuda")
        readings.append(values)
        print(json.dumps({"seed": seed, "fails": not compare.within(values, lim),
                          "seconds": time.perf_counter() - t0,
                          "numbers": {k: str(v) for k, v in values.items()}}),
              flush=True)
    least = {k: min(r[k] for r in readings) for k in readings[0]}
    print(json.dumps({"workload": args.workload, "least": {
        k: str(v) for k, v in least.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
