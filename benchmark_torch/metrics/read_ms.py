"""read_ms: the density file's read per traced analysis, in ms: the summed
time of the ``read.*`` spans (``pybader_tpu_torch.trace``: each density
block of a CHGCAR, from its text to the x-major grid over the cell volume,
in ``Bader.from_file``), per analysis that ran under the profiler.  The
read is host work before the analysis's first upload: the device idles
through it.  None where the program keeps no read spans, or the cell
reads no file."""
from spantrace import totals


def read(ctx):
    got = totals()
    if got is None:
        return None
    spans, n = got
    ns = [c["ns"] for name, c in spans.items() if name.startswith("read.")]
    if not ns:
        return None
    return sum(ns) / n / 1e6
