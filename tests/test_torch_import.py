"""The PyTorch port never imports jax (neither does chip_smoke.py), and
its public names cover every one of the JAX package's."""
import importlib
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "pybader_tpu_torch")


def test_importing_every_port_module_loads_no_jax():
    mods = []
    for d, _, names in os.walk(PORT):
        pkg = os.path.relpath(d, ROOT).replace(os.sep, ".")
        mods += [pkg if n == "__init__.py" else f"{pkg}.{n[:-3]}"
                 for n in names if n.endswith(".py")]
    code = (
        "import importlib, sys\n"
        f"mods = {sorted(mods)!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'pybader_tpu.')) or m == 'pybader_tpu')\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 15, mods\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_sources_have_no_jax_import():
    # pybader_tpu\b does not match pybader_tpu_torch
    pattern = re.compile(r"^\s*(import|from)\s+(jax|pybader_tpu)\b", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            if pattern.search(f.read()):
                offenders.append(os.path.relpath(path, ROOT))
    assert len(files) > 10
    assert not offenders, offenders


# The one JAX-package name the port does not have: jax.numpy itself.  Every
# other public name of grid, utils, io, interface and entry_points is covered
NOT_PORTED = {"interface": {"jnp"}}


@pytest.mark.parametrize("module", ["grid", "utils", "io", "interface",
                                    "entry_points"])
def test_public_names_cover_jax_package(module):
    want = importlib.import_module(f"pybader_tpu.{module}")
    got = importlib.import_module(f"pybader_tpu_torch.{module}")

    def public(m):
        return {n for n in dir(m) if not n.startswith("_")}

    skip = NOT_PORTED.get(module, set())
    assert public(want) >= skip
    assert not public(want) - skip - public(got)
    if module == "interface":
        assert not public(want.Bader) - public(got.Bader)


def test_parallel_package_runs_without_jax():
    """``pybader_tpu_torch.parallel`` imports and runs a virtual CPU mesh
    with no jax module loaded."""
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "from pybader_tpu_torch.parallel import make_mesh, sharded_partition\n"
        "from pybader_tpu_torch.parallel import analysis, chase, walk\n"
        "rho = np.random.default_rng(0).random((8, 6, 4))\n"
        "labels, maxima = sharded_partition(make_mesh(4, device='cpu'), rho,"
        " None, [1.0] * 27)\n"
        "assert labels.join().shape == (8, 6, 4) and len(maxima)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'pybader_tpu.')) or m == 'pybader_tpu')\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
