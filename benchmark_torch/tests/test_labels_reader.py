"""The reader of the per-atom and per-label spans (``labels_ms``) on given
span totals, and on a program that keeps no per-atom spans; the helpers
are ``test_interface_readers``'s.

    python -m pytest benchmark_torch/tests -q
"""
import sys

import pytest

from test_interface_readers import profiled, reader
from pybader_tpu_torch import trace

# what a program before the per-atom spans leaves: the sums, no
# atoms.assign and no surface.distance
OLDER = {"analysis": {"count": 4, "ns": 800_000_000},
         "upload.density": {"count": 4, "ns": 270_000_000, "bytes": 4},
         "sums.density": {"count": 8, "ns": 16_000_000, "labels": 2504},
         "download.bader_atoms": {"count": 4, "ns": 1_000_000, "bytes": 8},
         "host.results": {"count": 8, "ns": 8_000_000}}


def test_labels_ms_sums_its_spans_per_analysis(monkeypatch):
    monkeypatch.setattr(trace, "profiled", profiled(dict(OLDER, **{
        "atoms.assign": {"count": 4, "ns": 12_000_000, "maxima": 2520,
                         "atoms": 2496},
        "surface.distance": {"count": 4, "ns": 8_000_000, "atoms": 2496},
        "sums.spin": {"count": 8, "ns": 4_000_000, "labels": 2504}})))
    # (12 + 8 + 16 + 4 ms) over 4 analyses; the download inside
    # atoms.assign is not counted twice, the upload and the text not at all
    assert reader("labels_ms").read({"n": 4}) == 10.0


@pytest.mark.parametrize("spans", [{}, OLDER], ids=["none", "older"])
def test_labels_ms_finds_nothing_without_per_atom_spans(monkeypatch, spans):
    monkeypatch.setattr(trace, "profiled", profiled(spans))
    assert reader("labels_ms").read({}) is None


def test_labels_ms_finds_nothing_without_the_trace_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "pybader_tpu_torch.trace", None)
    assert reader("labels_ms").read({}) is None
