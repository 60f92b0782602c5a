"""Per-launch numbers of the exact walker in one default ``Bader()`` call.

Run from the repository root on a machine with one CUDA GPU:

    python3 tools/walk_launches.py [--root DIR] [--size 384] [--reps 5]

It imports ``pybader_tpu_torch`` and ``chip_smoke`` from ``--root`` (default:
this repository; an older checkout unpacked with ``git archive`` works too),
runs chip_smoke's blob field at ``--size``^3 through a default ``Bader()``
with ``neargrid.neargrid_walk`` wrapped to keep each launch's inputs.  Then
it times each launch again on those inputs (CUDA events, the median of
``--reps``, chip_smoke's ``time_ms``) and replays it on its plain version
for its counts (lanes, lane-steps, warp-steps where the plain version
counts them, rows touched).  Prints one JSON line: the card, the sum of
the launches' times and one entry a launch.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--size", type=int, default=384)
    ap.add_argument("--reps", type=int, default=5)
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
