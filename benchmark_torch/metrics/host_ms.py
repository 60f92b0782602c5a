"""host_ms: the program's host numpy work inside a traced analysis, in ms:
the summed time of its ``host.*`` spans and of ``init`` (``Bader.__init__``)
(``pybader_tpu_torch.trace``), per analysis that ran under the profiler.
The device waits on it."""
from spantrace import totals


def read(ctx):
    got = totals()
    if got is None:
        return None
    spans, n = got
    ns = sum(c["ns"] for name, c in spans.items()
             if name.startswith("host.") or name == "init")
    return ns / n / 1e6
