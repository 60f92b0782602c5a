"""labels_ms: the per-label and per-atom stages' time per traced analysis,
in ms: the summed time of the ``atoms.assign`` (the maxima's nearest atoms
and its two downloads), ``surface.distance`` (each atom's distance to its
volume's surface and its download) and ``sums.*`` spans
(``pybader_tpu_torch.trace``: the per-label sums and their downloads), per
analysis that ran under the profiler.  Each ends on the host in a
download.  The assignment and the sums' downloads grow with the count of
maxima and atoms; the surface's download also waits for the surface
stage's kernels over the whole grid, so that part grows with the voxels.
None where the program keeps no per-atom spans."""
from spantrace import totals

PER_ATOM = ("atoms.assign", "surface.distance")


def read(ctx):
    got = totals()
    if got is None:
        return None
    spans, n = got
    if not any(name in spans for name in PER_ATOM):
        return None
    ns = sum(c["ns"] for name, c in spans.items()
             if name in PER_ATOM or name.startswith("sums."))
    return ns / n / 1e6
