"""The reader of the density file's read spans (``read_ms``) on given span
totals, and on a program or a cell that keeps no read spans; the helpers
are ``test_interface_readers``'s.

    python -m pytest benchmark_torch/tests -q
"""
import sys

import pytest

from test_interface_readers import profiled, reader
from pybader_tpu_torch import trace

# what a program before the read spans leaves, or a cell on host arrays
OLDER = {"analysis": {"count": 4, "ns": 800_000_000},
         "init": {"count": 4, "ns": 1_000_000},
         "upload.density": {"count": 4, "ns": 270_000_000, "bytes": 4},
         "host.results": {"count": 8, "ns": 8_000_000}}


def test_read_ms_sums_its_spans_per_analysis(monkeypatch):
    monkeypatch.setattr(trace, "profiled", profiled(dict(OLDER, **{
        "read.charge": {"count": 4, "ns": 400_000_000, "bytes": 40,
                        "direct": 40},
        "read.spin": {"count": 2, "ns": 120_000_000, "bytes": 20,
                      "direct": 20}})))
    # (400 + 120 ms) over 4 analyses; init and the upload not at all
    assert reader("read_ms").read({"n": 4}) == 130.0


@pytest.mark.parametrize("spans", [{}, OLDER], ids=["none", "older"])
def test_read_ms_finds_nothing_without_read_spans(monkeypatch, spans):
    monkeypatch.setattr(trace, "profiled", profiled(spans))
    assert reader("read_ms").read({}) is None


def test_read_ms_finds_nothing_without_the_trace_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "pybader_tpu_torch.trace", None)
    assert reader("read_ms").read({}) is None
