"""spin_ms: what the spin density costs a traced analysis, in ms: the
summed time of its ``upload.spin`` and ``sums.spin`` spans
(``pybader_tpu_torch.trace``), per analysis that ran under the profiler.
Both end on the host: the pageable upload and the sums' downloads."""
from spantrace import totals


def read(ctx):
    got = totals()
    if got is None:
        return None
    spans, n = got
    if "sums.spin" not in spans:
        return None
    ns = sum(spans.get(name, {}).get("ns", 0)
             for name in ("upload.spin", "sums.spin"))
    return ns / n / 1e6
