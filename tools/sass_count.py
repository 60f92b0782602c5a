"""Count the SASS instructions of the port's CUDA kernels by opcode.

Run from the repository root on a machine with the CUDA toolkit:

    python3 tools/sass_count.py [--root DIR] [--kernel NAME ...] [--ddiv]
                                [--listing PATH]

It builds (or reuses) the kernel library of ``--root``'s
``pybader_tpu_torch`` (default: this repository) and disassembles it with
``cuobjdump -sass``.  For every kernel whose mangled name contains one of
the ``--kernel`` names (default: all), it prints one JSON line: the
kernel, its instruction count, its FP64-pipe instructions (DADD, DMUL,
DFMA, DSETP, DMNMX) and its opcode histogram.  ``--ddiv`` also compiles,
with the library's nvcc flags, a probe kernel that does one
``__ddiv_rn`` a thread and nothing else, and prints its line: the
instructions one correctly rounded f64 division costs (the probe's own
load, store and indexing are a handful of integer instructions).
``--listing`` writes the disassembly of the matched kernels (and the
probe) to PATH.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP64 = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX")
PROBE = r"""
__global__ void ddiv_probe(const double* __restrict__ a,
                           const double* __restrict__ b,
                           double* __restrict__ c) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    c[i] = __ddiv_rn(a[i], b[i]);
}
"""


def cuobjdump() -> str:
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(path):
        sys.exit("sass_count: cuobjdump not found")
    return path


def functions(binary: str) -> dict:
    """Mangled kernel name -> its SASS lines, from cuobjdump -sass."""
    out = subprocess.run([cuobjdump(), "-sass", binary], check=True,
                         capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            funcs[name].append(line)
    return funcs


def histogram(lines) -> Counter:
    ops = Counter()
    for line in lines:
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if m:
            ops[m.group(1).split(".")[0]] += 1
    return ops


def report(name, lines) -> dict:
    ops = histogram(lines)
    return {"kernel": name, "instructions": sum(ops.values()),
            "fp64": sum(ops[o] for o in FP64),
            "opcodes": dict(ops.most_common())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--kernel", nargs="*", default=[])
    ap.add_argument("--ddiv", action="store_true")
    ap.add_argument("--listing")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    from pybader_tpu_torch.ops import _cuda

    listing = []
    for name, lines in sorted(functions(_cuda.build()).items()):
        if args.kernel and not any(k in name for k in args.kernel):
            continue
        print(json.dumps(report(name, lines)), flush=True)
        listing += [f"Function : {name}", *lines]
    if args.ddiv:
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "ddiv_probe.cu")
            with open(src, "w") as f:
                f.write(PROBE)
            obj = os.path.join(tmp, "ddiv_probe.o")
            flags = [f for f in _cuda.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
            subprocess.run([_cuda._nvcc(), *flags, "-c", src, "-o", obj],
                           check=True)
            for name, lines in functions(obj).items():
                print(json.dumps(report(name, lines)), flush=True)
                listing += [f"Function : {name}", *lines]
    if args.listing:
        with open(args.listing, "w") as f:
            f.write("\n".join(listing) + "\n")


if __name__ == "__main__":
    main()
