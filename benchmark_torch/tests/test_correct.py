"""``correct`` at a size the CPU holds: a sound run passes, and the control
(the reference in f32) and every fault a cell can have fail.

Each case drives the harness's run (``run.run_cell``) past its look for a
chip, on the program's plain path (``device='cpu'``), with the hybrid
path forced (``PYBADER_TPU_FULL_TRAJECTORIES=0`` in the program, the
reference's threshold at 0) so that the partition, the chained refinement,
the atoms, the sums and the surface all run as at 384^3.

    python -m pytest benchmark_torch/tests -q
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)

import compare  # noqa: E402
import control  # noqa: E402
import reference  # noqa: E402
import run  # noqa: E402

SHAPE = [32, 32, 48]
CELLS = ("default.bulk384", "speed.bulk384", "default.slab384")


def small(workload):
    bench = run.read_json(ROOT, "BENCHMARK.json")
    cell, config, traffic, e2e, per_layer = run.cell_spec(bench, workload)
    traffic = dict(traffic, shape=SHAPE, count=2, blobs=12)
    return config, traffic, e2e, per_layer


@pytest.fixture
def hybrid(monkeypatch):
    monkeypatch.setenv("PYBADER_TPU_FULL_TRAJECTORIES", "0")
    monkeypatch.setattr(reference, "HYBRID_THRESHOLD", 0)


def run_small(workload, seed=2 ** 31 + 7, **extra):
    config, traffic, e2e, per_layer = small(workload)
    traffic.update(extra)
    result, values, lim, _ = run.run_cell(config, traffic, seed, 0.3, 0, e2e,
                                          per_layer, device="cpu")
    json.dumps(result)
    return result, values, lim


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(hybrid, workload):
    result, values, lim = run_small(workload)
    assert result["correct"], values
    assert result["attempted"] >= 2 and result["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(hybrid, workload):
    config, traffic, _, _ = small(workload)
    values = control.control_numbers(config, traffic, 11, "cpu")
    assert not compare.within(values, compare.limits()), values


# traffic that later cells add as data alone: a spin density, a campaign
# of mixed grids, densities read from CHGCAR files
SPIN = {"spin": {"heights": [-0.5, 0.5]},
        "call": {"spin_flag": True}}
MIXED = {"shapes": [SHAPE, [24, 32, 40]], "count": 3}
FILES = {"entry": "file"}


@pytest.mark.parametrize("extra", [SPIN, MIXED, FILES, dict(SPIN, **FILES)],
                         ids=["spin", "mixed", "file", "spin_file"])
def test_traffic_by_data_is_correct(hybrid, extra):
    result, values, lim = run_small("default.bulk384", **extra)
    assert result["correct"], values
    assert result["failed"] == 0


def test_spin_is_compared(hybrid, monkeypatch):
    """A spin sum altered where the sums produce it fails."""
    from pybader_tpu_torch.ops import reductions
    sums = reductions.charge_volume

    def altered(density, labels, k):
        charge, count = sums(density, labels, k)
        if float(density.min()) < 0:  # the signed spin density
            charge = charge.clone()
            charge[0] += 1e-6 * float(charge.abs().max())
        return charge, count
    monkeypatch.setattr(reductions, "charge_volume", altered)
    result, values, lim = run_small("default.bulk384", **SPIN)
    assert not result["correct"], values


def test_warm_one_analysis_a_shape():
    inputs = [{"shape": (4, 4, 4)}, {"shape": (4, 4, 4)}, {"shape": (2, 4, 4)},
              {"shape": (4, 4, 4)}]
    assert run.warm_indices(inputs) == [0, 2]


def test_chgcar_files_read_as_the_program_reads_them(tmp_path):
    """The plain reader gives what ``io.vasp.read`` gives on the harness's
    CHGCAR, bit for bit, and both hold the density to its 12 digits."""
    import densities
    from pybader_tpu_torch.io import vasp
    lattice = np.array([[7.0, 0.0, 0.0], [0.5, 6.0, 0.0], [0.0, 0.3, 9.0]])
    traffic = {"shape": [6, 7, 11], "blobs": 5, "heights": [1.0, 3.0],
               "narrow": 2.0, "wide": 20.0, "wide_weight": 10.0,
               "spin": {"heights": [-1.0, 1.0]}}
    fields, atoms = densities.make_input(traffic, lattice, 2 ** 40 + 3, 1,
                                         "cpu")
    fields["charge"][0, 0, 0] = 0.0
    path = str(tmp_path / "CHGCAR")
    densities.write_chgcar(path, fields, lattice, atoms)
    dens, lat, at = densities.read_chgcar(path)
    dens2, lat2, at2, _ = vasp.read(path, spin_flag=True)
    assert np.array_equal(lat, lat2) and np.array_equal(at, at2)
    for key in ("charge", "spin"):
        assert np.array_equal(dens[key], dens2[key])
        scale = np.abs(fields[key]).max()
        assert np.abs(dens[key] - fields[key]).max() <= 1e-11 * scale
    np.testing.assert_allclose(at, atoms, atol=1e-12)
    assert densities.format_block(np.array([-9.999999999996e-3, 0.0])) == \
        b" -1.00000000000E-02  0.00000000000E+00\n"


def unchanged_refinement(monkeypatch):
    """A refinement that returns its labels unchanged."""
    from pybader_tpu_torch import pipeline
    monkeypatch.setattr(pipeline, "refine_labels",
                        lambda method, mode, ref, labels, *a, **k:
                        (labels, 0))


def half_the_walks(monkeypatch):
    """Every walk leaves the second half of its lanes where they start."""
    from pybader_tpu_torch.ops import neargrid
    walk = neargrid.neargrid_walk

    def half(rows, starts, shape, cap, known=None):
        pos, done = walk(rows, starts, shape, cap, known)
        h = starts.numel() // 2
        pos[h:] = starts[h:].clamp(min=0)
        return pos, done
    monkeypatch.setattr(neargrid, "neargrid_walk", half)


def altered_charge(monkeypatch):
    """One basin's charge altered by 1 ppm where the sums produce it."""
    from pybader_tpu_torch.ops import reductions
    sums = reductions.charge_volume

    def altered(density, labels, k):
        charge, count = sums(density, labels, k)
        charge = charge.clone()
        charge[0] *= 1 + 1e-6
        return charge, count
    monkeypatch.setattr(reductions, "charge_volume", altered)


def altered_label(monkeypatch):
    """One walked voxel's label altered where refinement writes it."""
    from pybader_tpu_torch import pipeline
    apply = pipeline._apply_walk_results

    def altered(labels, known, starts, pos):
        changed = apply(labels, known, starts, pos)
        flat = labels.view(-1)
        i = starts[0].long()
        flat[i] = (flat[i] + 1) % (int(flat.max()) + 1)
        return changed
    monkeypatch.setattr(pipeline, "_apply_walk_results", altered)


@pytest.mark.parametrize("fault", [unchanged_refinement, half_the_walks,
                                   altered_charge, altered_label])
@pytest.mark.parametrize("workload", ("default.bulk384", "speed.bulk384"))
def test_fault_fails(hybrid, monkeypatch, fault, workload):
    fault(monkeypatch)
    result, values, lim = run_small(workload)
    assert not result["correct"], values
    assert result["failed"] == result["attempted"] or result["failed"] > 0


def test_text_err_reads_digits():
    a = " 1  0.500000  2.25\n total  3.1000"
    assert compare.text_err(a, a) == 0
    assert compare.text_err(a, a.replace("0.500000", "0.500002")) == 2
    assert compare.text_err(a, a.replace("total", "tot")) == float("inf")
    assert compare.mismatch(np.zeros((3, 2)), np.zeros((4, 2))) == 1
    assert compare.rel_err([(torch.ones(2).numpy(), np.ones(3))]) == \
        float("inf")
