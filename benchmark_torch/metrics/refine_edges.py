"""refine_edges: edge voxels walked by the refinement per traced analysis:
the ``edges`` counters of the ``refine.iteration`` spans
(``pybader_tpu_torch.trace``; the hybrid's internal iterations included),
per analysis that ran under the profiler."""
from spantrace import totals


def read(ctx):
    got = totals()
    if got is None:
        return None
    spans, n = got
    return spans.get("refine.iteration", {}).get("edges", 0) / n
