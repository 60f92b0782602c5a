"""copy_gb: bytes the program copied between host and device per traced
analysis, in GB (1e9 bytes): the ``bytes`` counters of its ``upload.*``
and ``download.*`` spans (``pybader_tpu_torch.trace``), summed over the
analyses that ran under the profiler."""
from spantrace import totals


def read(ctx):
    got = totals()
    if got is None:
        return None
    spans, n = got
    nbytes = sum(c["bytes"] for name, c in spans.items()
                 if name.startswith(("upload.", "download.")))
    return nbytes / n / 1e9
