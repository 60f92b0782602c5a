"""The benchmark's HKUST-1 deployment and its file-reading cell, at a size
the CPU holds, against the benchmark's plain reference (``benchmark_torch/
reference.py``): the harness's run (``run.run_cell``) on the program's
plain path (``device='cpu'``) with the hybrid forced, so that the
partition, the chained refinement, the atoms, the sums and the surface run
as at full size.  The MOF keeps more than 512 atoms and more than 127
maxima, so both result grids come down as int16 and the per-label sums pass
the kernel's shared-bin limit (``kPrivateK``, 512 labels) as at 512^3; the
file cell reads its CHGCARs with ``Bader.from_file`` inside the window.
The step cap and the hybrid's internal budget of the full-size 512^3 grid
are held to the reference's."""
import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = os.path.join(ROOT, "benchmark_torch")
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)

import reference  # noqa: E402
import run  # noqa: E402
from pybader_tpu_torch import pipeline  # noqa: E402
from pybader_tpu_torch.ops import neargrid  # noqa: E402

# (cell, the traffic's keys changed to fit the CPU)
SMALL = {
    "hkust1.mof512": {"shape": [48, 48, 48], "count": 2, "blobs": 520,
                      "narrow": 2.0, "wide": 20.0},
    "default.file256": {"shape": [24, 24, 24]},
}
SHARED_BINS = 512  # csrc/reduce.cu kPrivateK


@pytest.fixture
def hybrid(monkeypatch):
    monkeypatch.setenv("PYBADER_TPU_FULL_TRAJECTORIES", "0")
    monkeypatch.setattr(reference, "HYBRID_THRESHOLD", 0)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_small_cell_is_correct(hybrid, monkeypatch, workload):
    bench = run.read_json(ROOT, "BENCHMARK.json")
    _, config, traffic, e2e, per_layer = run.cell_spec(bench, workload)
    traffic = dict(traffic, **SMALL[workload])
    seen = []
    results = run.Analyst.results

    def kept(self, b):
        seen.append((b.bader_volumes.dtype, b.atoms_volumes.dtype,
                     len(b.bader_maxima), len(b.atoms), b.info["filename"]))
        return results(self, b)
    monkeypatch.setattr(run.Analyst, "results", kept)
    result, values, lim, notes = run.run_cell(
        config, traffic, 2 ** 31 + 7, 0.3, 0, e2e, per_layer, device="cpu")
    json.dumps(result)
    assert result["correct"], values
    assert result["failed"] == 0 and seen
    for bader_dtype, atoms_dtype, n_max, n_atoms, filename in seen:
        if workload == "hkust1.mof512":
            # past the shared bins, and above 127 labels: int16 grids
            assert n_atoms == 520 > SHARED_BINS and n_max > 127
            assert bader_dtype == atoms_dtype == np.int16
        else:
            # read from the CHGCAR the set-up wrote
            assert filename == "CHGCAR" and n_atoms == 60
            assert bader_dtype == atoms_dtype == np.int8


def test_full_size_cap_and_budget_match_the_reference():
    shape = (512, 512, 512)
    assert neargrid.refine_cap(shape) == reference.refine_cap(shape) == 352
    iters = reference.ITERS_PER_128 * -(-max(shape) // 128)
    assert pipeline.hybrid_internal_budget(shape) == ("changed", iters) \
        == ("changed", 12)
