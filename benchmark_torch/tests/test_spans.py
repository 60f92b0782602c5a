"""The readers of the program's spans (``copy_gb``, ``host_ms``,
``refine_edges``) and ``spantrace``'s reduction of a trace by span, on
synthetic inputs and on a traced run of the harness on the CPU.

    python -m pytest benchmark_torch/tests -q
"""
import os
import sys
from collections import Counter, defaultdict

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)

import devtrace  # noqa: E402
import run  # noqa: E402
import spantrace  # noqa: E402
from pybader_tpu_torch import trace  # noqa: E402

READERS = ("copy_gb", "host_ms", "refine_edges")


def reader(name):
    return run.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                           "bench_metric_" + name)


def totals(spans):
    out = defaultdict(Counter)
    for name, c in spans.items():
        out[name].update(c)
    return out


def test_readers_on_synthetic_spans(monkeypatch):
    monkeypatch.setattr(trace, "profiled", totals({
        "analysis": {"count": 4, "ns": 4_000_000_000},
        "init": {"count": 4, "ns": 2_000_000},
        "upload.reference": {"count": 8, "ns": 1, "bytes": 3_000_000_000},
        "upload.labels": {"count": 4, "ns": 1, "bytes": 1_000_000_000},
        "download.refined": {"count": 4, "ns": 1, "bytes": 2_000_000_000},
        "host.astype": {"count": 12, "ns": 30_000_000},
        "host.results": {"count": 8, "ns": 8_000_000},
        "stage.Refining volume edges": {"count": 4, "ns": 900_000_000},
        "refine.iteration": {"count": 44, "ns": 1, "edges": 400,
                             "changed": 9, "cap_fires": 0, "risky": 0},
        "refine.edges": {"count": 44, "ns": 1},
    }))
    got = {n: reader(n).read({"n": 4}) for n in READERS}
    assert got == {"copy_gb": 1.5, "host_ms": 10.0, "refine_edges": 100.0}


def test_readers_find_nothing_without_spans(monkeypatch):
    monkeypatch.setattr(trace, "profiled", defaultdict(Counter))
    assert all(reader(n).read({}) is None for n in READERS)
    # a program without the trace module (an older checkout)
    monkeypatch.setitem(sys.modules, "pybader_tpu_torch.trace", None)
    assert spantrace.totals() is None
    assert all(reader(n).read({}) is None for n in READERS)


class Event:
    """A kineto event as the profiler gives it."""

    def __init__(self, dev, name, start_us, end_us, act=None):
        self.dev, self._name, self.act = dev, name, act
        self.s, self.e = int(start_us * 1000), int(end_us * 1000)

    def device_type(self):
        return "DeviceType." + self.dev

    def name(self):
        return self._name

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s

    def activity_type(self):
        return self.act

    def is_user_annotation(self):
        return self.act == "gpu_user_annotation" or (
            self.dev == "CPU" and self._name.startswith(("pb.", "bench.")))


def cpu(name, s, e):
    return Event("CPU", name, s, e, act="user_annotation")


def gpu(name, s, e, act="kernel"):
    return Event("CUDA", name, s, e, act=act)


def fake_trace(with_spans):
    """One analysis (0-100 us): a harness stage (10-60) holding the
    program's stage span (10-60) with a nested span (20-40); device work
    at 0-5, 25-30 and 45-50, so the device idles 5-25 (from outside both
    into the nested span), 30-45 (the nested span, then the stage span)
    and 50-100 (the stage, then outside both)."""
    events = [cpu("bench.analysis", 0, 100),
              cpu("bench.stage:Refining volume edges", 10, 60),
              gpu("Memcpy HtoD (Pageable -> Device)", 0, 5, "gpu_memcpy"),
              gpu("pb::neargrid_walk<2>(int*)", 25, 30),
              gpu("Memcpy DtoH (Device -> Pageable)", 45, 50, "gpu_memcpy")]
    if with_spans:
        events += [cpu("pb.analysis", 1, 99),
                   cpu("pb.stage.Refining volume edges", 10, 60),
                   cpu("pb.refine.iteration", 20, 40),
                   gpu("pb.refine.iteration", 20, 40, "gpu_user_annotation"),
                   cpu("pb.host.results", 70, 90)]
    return events


def test_idle_spans_name_the_innermost_span():
    events = fake_trace(True)
    idle = spantrace.idle_spans(events, spantrace.device_gaps(events))
    want = {"analysis": 5 + 10 + 9,
            "Refining volume edges": 5 + 5 + 5 + 10,
            "Refining volume edges/refine.iteration": 5 + 10,
            "host.results": 20, "between stages": 1}
    assert set(idle) == set(want)
    for k, v in want.items():
        assert idle[k] == pytest.approx(v * 1e-6), k


def test_idle_spans_without_program_spans_split_devtrace_idle():
    """devtrace puts a whole gap down to the stage at its start;
    idle_spans cuts it where the stage begins or ends."""
    events = fake_trace(False)
    idle = spantrace.idle_spans(events, spantrace.device_gaps(events))
    match = devtrace.kernel_matcher({"neargrid_walk"})
    red = devtrace.reduce_events(events, match, {})
    assert idle.keys() == red["idle"].keys()
    assert red["idle"]["between stages"] == pytest.approx(20e-6)
    assert idle == pytest.approx({"between stages": (5 + 40) * 1e-6,
                                  "Refining volume edges": (15 + 15 + 10)
                                  * 1e-6})
    assert sum(idle.values()) == pytest.approx(sum(red["idle"].values()))


def test_program_spans_leave_devtrace_unchanged():
    match = devtrace.kernel_matcher({"neargrid_walk"})
    plain = devtrace.reduce_events(fake_trace(False), match, {})
    spanned = devtrace.reduce_events(fake_trace(True), match, {})
    assert spanned == plain
    idle = spantrace.idle_spans(fake_trace(True),
                                spantrace.device_gaps(fake_trace(True)))
    assert sum(idle.values()) == pytest.approx(sum(plain["idle"].values()))


def test_traced_run_reports_the_span_metrics(monkeypatch):
    """The harness's traced run on the CPU, with the readers' entries:
    copies read 0 bytes, the host work and the edges are counted."""
    monkeypatch.setattr(trace, "profiled", defaultdict(Counter))
    monkeypatch.setenv("PYBADER_TPU_FULL_TRAJECTORIES", "0")
    bench = run.read_json(ROOT, "BENCHMARK.json")
    _, config, traffic, e2e, per_layer = run.cell_spec(bench,
                                                       "default.bulk384")
    assert {m["name"] for m in per_layer} >= set(READERS)
    traffic = dict(traffic, shape=[32, 32, 48], count=2, blobs=12)
    result, _, _, _ = run.run_cell(config, traffic, 2 ** 31 + 3, 0.3, 1,
                                   e2e, per_layer, device="cpu")
    got = result["metrics"]
    assert got["copy_gb"]["value"] == 0
    assert got["host_ms"]["value"] > 0
    assert got["refine_edges"]["value"] > 0
    assert trace.profiled["analysis"]["count"] == result["attempted"]
