"""The program's spans (``pybader_tpu_torch.trace``) beside the device trace.

- :func:`totals`: the spans of the analyses run under the profiler,
  summed by name; what the readers ``copy_gb``, ``host_ms`` and
  ``refine_edges`` read.
- :func:`idle_spans`: the device's idle time inside the traced analyses
  put down to the innermost program span (``pb.<name>`` ranges), named
  ``<stage>/<span>`` inside a harness stage (``bench.stage:<stage>``),
  ``<span>`` outside one, and ``<stage>`` where the program's span of
  that stage is the innermost; ``between stages`` where the program opened
  no span (a program without them).

``idle_spans`` is to move into ``devtrace.reduce_events``, with
``breakdown.idle_gaps`` built from it and the readers given each
analysis's spans in the harness's ctx (ROADMAP item 18); until then
:func:`totals` reads ``trace.profiled``, and :func:`main` makes one traced
run of a cell as ``run.py --trace 1`` does and adds
``breakdown.idle_spans`` (seconds per analysis) to the result line:

    python3 benchmark_torch/spantrace.py --workload default.bulk384 \\
        --seed 7 --seconds 20
"""
from __future__ import annotations

import bisect
import json

STAGE = "bench.stage:"
SPAN = "pb."


def totals():
    """(span name -> Counter of ``count``, ``ns`` and the span's counters,
    analyses) over the analyses that ran under the profiler, or None where
    the program keeps no spans or none ran."""
    try:
        from pybader_tpu_torch import trace
    except ImportError:
        return None
    prof = getattr(trace, "profiled", None)
    n = prof.get("analysis", {}).get("count", 0) if prof else 0
    return (prof, n) if n else None


def _segments(ranges):
    """Nested ranges [(start, end, label)] -> the timeline as sorted,
    disjoint [(start, end, innermost label)] where some range is open."""
    points = sorted({t for s, e, _ in ranges for t in (s, e)})
    opened = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, live, j = [], [], 0
    for a, b in zip(points, points[1:]):
        while j < len(opened) and opened[j][0] <= a:
            live.append(opened[j])
            j += 1
        live = [r for r in live if r[1] > a]
        if live:
            # the innermost: the latest to open, the shortest among those
            inner = max(live, key=lambda r: (r[0], -r[1]))
            out.append((a, b, inner[2]))
    return out


def _label_at(segs, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and segs[i][0] <= t < segs[i][1]:
        return segs[i][2]
    return None


def idle_spans(events, gaps):
    """Idle seconds by program span.  ``events``: the profiler's kineto
    events; ``gaps``: the device's idle intervals inside the analyses, as
    [(start, end)] in seconds on the trace's clock."""
    stages, spans = [], []
    for ev in events:
        if str(ev.device_type()).split(".")[-1] != "CPU":
            continue
        name = ev.name()
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if name.startswith(STAGE):
            stages.append((s, e, name[len(STAGE):]))
        elif name.startswith(SPAN):
            spans.append((s, e, name[len(SPAN):]))
    seg_st, seg_sp = _segments(stages), _segments(spans)
    st0, sp0 = [s for s, _, _ in seg_st], [s for s, _, _ in seg_sp]
    # every boundary, to cut each gap where the innermost span changes
    bounds = sorted({t for seg in (seg_st, seg_sp) for s, e, _ in seg
                     for t in (s, e)})
    out = {}
    for g0, g1 in gaps:
        cuts = bounds[bisect.bisect_right(bounds, g0):
                      bisect.bisect_left(bounds, g1)]
        for a, b in zip([g0] + cuts, cuts + [g1]):
            stage = _label_at(seg_st, st0, a)
            span = _label_at(seg_sp, sp0, a)
            if span is None:
                label = stage or "between stages"
            elif stage is None:
                label = span
            elif span == "stage." + stage:
                label = stage
            else:
                label = f"{stage}/{span}"
            out[label] = out.get(label, 0.0) + (b - a)
    return out


def device_gaps(events):
    """The device's idle intervals inside the ``bench.analysis`` ranges,
    as ``devtrace.reduce_events`` finds them: [(start, end)] seconds."""
    import devtrace

    analyses, busy = [], []
    for ev in events:
        dev = str(ev.device_type()).split(".")[-1]
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if dev == "CPU":
            if ev.name() == "bench.analysis":
                analyses.append((s, e))
        elif devtrace._kind(ev) is not None:
            busy.append((s, e))
    windows = devtrace._union(analyses)
    inside = [(max(s, w0), min(e, w1)) for s, e in busy for w0, w1 in windows
              if min(e, w1) > max(s, w0)]
    busy = devtrace._union(inside)
    gaps = []
    for w0, w1 in windows:
        t = w0
        for s, e in busy:
            if e <= w0 or s >= w1:
                continue
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if w1 > t:
            gaps.append((t, w1))
    return gaps


def main(argv=None):
    import argparse
    import os
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    for path in (os.path.dirname(here), here):
        if path not in sys.path:
            sys.path.insert(0, path)
    import devtrace
    import run

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    bench = run.read_json(run.ROOT, "BENCHMARK.json")
    _, config, traffic, e2e, per_layer = run.cell_spec(bench, args.workload)
    seen = {}
    reduce = devtrace.reduce_events

    def reduce_and_keep(events, *a, **k):
        events = list(events)
        seen["idle_spans"] = idle_spans(events, device_gaps(events))
        red = reduce(events, *a, **k)
        seen["n"] = red["n"]
        return red

    devtrace.reduce_events = reduce_and_keep
    try:
        result, _, _, notes = run.run_cell(
            config, traffic, args.seed, args.seconds, 1, e2e, per_layer)
    finally:
        devtrace.reduce_events = reduce
    for line in notes:
        print(line, file=sys.stderr)
    n = seen["n"]
    result["breakdown"]["idle_spans"] = sorted(
        ([k, v / n] for k, v in seen["idle_spans"].items()),
        key=lambda kv: -kv[1])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
