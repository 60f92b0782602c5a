"""vacuum_ms: the vacuum mask's time per traced analysis, in ms: the
summed time of the ``vacuum.mask`` spans (``pybader_tpu_torch.trace``:
the mask, its two sums read on the host and its ``any``), per analysis
that ran under the profiler."""
from spantrace import totals


def read(ctx):
    got = totals()
    if got is None:
        return None
    spans, n = got
    if "vacuum.mask" not in spans:
        return None
    return spans["vacuum.mask"]["ns"] / n / 1e6
