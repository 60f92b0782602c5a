"""The readers of the spin's and the vacuum mask's spans (``spin_ms``,
``vacuum_ms``) on given span totals, and on a program that keeps no such
spans.

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

import run  # noqa: E402
from pybader_tpu_torch import trace  # noqa: E402

READERS = ("spin_ms", "vacuum_ms")


def reader(name):
    return run.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                           "bench_metric_" + name)


def profiled(spans):
    out = defaultdict(Counter)
    for name, c in spans.items():
        out[name].update(c)
    return out


# what a program before these spans leaves: the spin's upload, no sums
# span and no mask span
OLDER = {"analysis": {"count": 4, "ns": 800_000_000},
         "upload.spin": {"count": 4, "ns": 280_000_000, "bytes": 4},
         "upload.density": {"count": 4, "ns": 270_000_000, "bytes": 4},
         "host.results": {"count": 8, "ns": 8_000_000}}


def test_readers_sum_their_spans_per_analysis(monkeypatch):
    monkeypatch.setattr(trace, "profiled", profiled(dict(OLDER, **{
        "sums.spin": {"count": 8, "ns": 20_000_000, "labels": 480},
        "sums.density": {"count": 8, "ns": 16_000_000, "labels": 480},
        "vacuum.mask": {"count": 4, "ns": 6_000_000, "voxels": 10 ** 8}})))
    got = {n: reader(n).read({"n": 4}) for n in READERS}
    # spin: (280 ms of uploads + 20 ms of sums) over 4 analyses
    assert got == {"spin_ms": 75.0, "vacuum_ms": 1.5}


@pytest.mark.parametrize("spans", [{}, OLDER], ids=["none", "older"])
def test_readers_find_nothing_without_their_spans(monkeypatch, spans):
    monkeypatch.setattr(trace, "profiled", profiled(spans))
    assert all(reader(n).read({}) is None for n in READERS)


def test_readers_find_nothing_without_the_trace_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "pybader_tpu_torch.trace", None)
    assert all(reader(n).read({}) is None for n in READERS)
