"""Each cost file gives ``chip_smoke.py``'s bound on the same small input.

Run from the repository root on the CPU:

    python -m pytest benchmark_torch/tests -q

Skips where ``chip_smoke.py`` is not beside the benchmark (a checkout that
holds only the benchmark's files).
"""
import importlib.util
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

import densities  # noqa: E402
import reference  # noqa: E402
from peaks import bound_s  # noqa: E402

TRAFFIC = {"blobs": 10, "heights": [1.0, 3.0], "narrow": 400.0,
           "wide": 40000.0, "wide_weight": 10.0}
SHAPE = (20, 24, 28)
LATTICE = np.diag([20.0, 20.0, 20.0])


def cost_module(op):
    spec = importlib.util.spec_from_file_location(
        f"cost_{op}", os.path.join(BENCH, "costs", op + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    if not os.path.isfile(os.path.join(ROOT, "chip_smoke.py")):
        pytest.skip("chip_smoke.py is not in this checkout")
    import chip_smoke
    return chip_smoke


@pytest.fixture(scope="module")
def inputs():
    """A blob field, its step codes, ongrid labels, known grid after an
    edge_find, strict rows and the refinement's edge starts."""
    from pybader_tpu_torch.ops import neargrid

    fields, atoms = densities.blob_density(SHAPE, LATTICE, TRAFFIC, 5, 0,
                                           "cpu")
    rho = fields["charge"]
    w = reference.distance_weights(LATTICE, SHAPE)
    codes = reference.step_codes(rho, w)
    labels, _ = reference.partition_ongrid(rho, None, w)
    is_max = codes == 13
    known = reference.edge_find(labels, is_max)
    rows = neargrid.neargrid_rows_plain(
        rho, codes, reference.t_grad(LATTICE, SHAPE), True)
    starts = torch.nonzero(known.reshape(-1) == -2).reshape(-1).to(
        torch.int32)
    starts = torch.cat([starts, torch.full((37,), -1, dtype=torch.int32)])
    atom_labels = labels % len(atoms)
    mask = reference.edge_find(atom_labels,
                               reference.local_max(rho, atom_labels)) == -2
    return {"rho": rho, "codes": codes, "labels": labels, "is_max": is_max,
            "known": known, "rows": rows, "starts": starts, "atoms": atoms,
            "atom_labels": atom_labels.to(torch.int32), "mask": mask}


def ms(cost):
    return bound_s(cost) * 1e3


def test_elementwise_costs(smoke, inputs):
    n = inputs["rho"].numel()
    k = int(inputs["labels"].max()) + 1
    lab = inputs["labels"]
    cases = {
        "ongrid_step_codes": ((inputs["rho"], None), smoke.stencil_cost(n)),
        "resolve_roots": ((lab,), smoke.bound(8 * n)),
        "min_pair": ((lab, inputs["is_max"], k), smoke.bound(5 * n + 8 * k)),
        "remap_labels": ((lab, None, k), smoke.bound(8 * n + 4 * k)),
        "charge_volume": ((inputs["rho"], lab, k),
                          smoke.bound(12 * n + 16 * k, n)),
        "neargrid_rows": ((inputs["rho"], inputs["codes"], None, True),
                          smoke.rows_cost(n)),
        "stop_bitmap": ((inputs["known"],), smoke.bound(n + 4 * -(-n // 32))),
    }
    for op, (args, want) in cases.items():
        assert ms(cost_module(op).cost(*args)) == pytest.approx(
            want["bound_ms"], rel=1e-12), op


def test_data_dependent_costs(smoke, inputs):
    shape = tuple(inputs["rho"].shape)
    lab, known = inputs["labels"], inputs["known"]
    assert ms(cost_module("edge_find").cost(lab, inputs["is_max"])) == \
        pytest.approx(smoke.find_cost(lab)["bound_ms"], rel=1e-12)
    assert ms(cost_module("edge_check").cost(known, lab, inputs["is_max"])) \
        == pytest.approx(smoke.check_cost(known, lab)["bound_ms"], rel=1e-12)
    n_atoms = len(inputs["atoms"])
    lat = torch.as_tensor(LATTICE)
    got = cost_module("surface_min_d2").cost(
        inputs["atom_labels"], inputs["mask"], lat,
        torch.as_tensor(inputs["atoms"]), n_atoms)
    assert ms(got) == pytest.approx(
        smoke.surface_cost(inputs["atom_labels"], inputs["mask"],
                           n_atoms)["bound_ms"], rel=1e-12)
    for kn in (known, None):
        got = cost_module("neargrid_walk").cost(
            inputs["rows"], inputs["starts"], shape, 192, kn)
        want, st = smoke.walk_cost(inputs["rows"], inputs["starts"], shape,
                                   192, kn)
        assert st["lane_steps"] > 0
        assert ms(got) == pytest.approx(want["bound_ms"], rel=1e-12)


def test_every_cost_file_names_its_wrapper():
    """Each cost file's WRAPPER is a function of the program that counts
    its launch under the file's name."""
    import importlib
    import inspect

    for fn in sorted(os.listdir(os.path.join(BENCH, "costs"))):
        if not fn.endswith(".py"):
            continue
        op = fn[:-3]
        mod = cost_module(op)
        module, attr = mod.WRAPPER.split(":")
        src = inspect.getsource(getattr(importlib.import_module(module), attr))
        assert f'launches["{op}"]' in src, op
        assert mod.KERNELS, op
