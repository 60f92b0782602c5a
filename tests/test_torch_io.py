"""Parity of the port's file output, cube IO and host helpers with the JAX
package: ``Bader.write_density`` byte for byte on the CHGCAR fixture, a
cube file written by JAX's ``io.cube.write`` through the port's
``cube.read``, ``Bader.from_file`` and ``Bader.from_dict``, and the
geometry and stdout helpers of ``grid`` and ``utils``."""
import os

import numpy as np
import pytest
import torch

from pybader_tpu import grid as jgrid
from pybader_tpu import utils as jutils
from pybader_tpu.interface import Bader as JaxBader
from pybader_tpu.io import cube as jcube
from pybader_tpu_torch import grid as tgrid
from pybader_tpu_torch import utils as tutils
from pybader_tpu_torch.interface import Bader
from pybader_tpu_torch.io import cube
from tests.oracle import gaussian_density

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "CHGCAR_fixture")
LAT = np.array([[7.0, 0.0, 0.0], [0.4, 6.0, 0.0], [0.0, 0.3, 8.0]])
SHAPE = (14, 12, 16)
ATOMS = np.array([[1.0, 1.5, 2.0], [4.0, 3.5, 5.5], [5.5, 1.0, 6.5]])
ONGRID = dict(method="ongrid", refine_method="ongrid")


@pytest.mark.parametrize("fortran_format", [0, 1, 2])
def test_write_density_byte_identical(tmp_path, monkeypatch,
                                      fortran_format):
    written = {}
    for cls, sub, kw in ((JaxBader, "jax", {}),
                         (Bader, "port", {"device": "cpu"})):
        os.makedirs(tmp_path / sub)
        monkeypatch.chdir(tmp_path / sub)
        b = cls.from_file(FIXTURE, fortran_format=fortran_format, **kw)
        b.write_density()
        written[sub] = (tmp_path / sub / "CHGCAR_fixture").read_bytes()
    assert written["port"] == written["jax"]
    assert b"Full charge density output" in written["port"]


@pytest.fixture(scope="module")
def cube_file(tmp_path_factory):
    """A cube file written by the JAX package's writer."""
    rng = np.random.default_rng(11)
    frac = (ATOMS @ np.linalg.inv(LAT)) % 1
    rho = gaussian_density(SHAPE, LAT, frac, 0.8 + rng.random(3),
                           1 + rng.random(3)) + 1e-6
    d = tmp_path_factory.mktemp("cube")
    info = {"comment": "test\n", "elements": np.array([14, 8, 1]),
            "fortran_format": 0}
    jcube.write(str(d / "dens"), ATOMS.copy(), LAT.copy(),
                {"charge": rho}, info, prefix=None)
    return str(d / "dens.cube")


def test_cube_read_identical(cube_file):
    want = jcube.read(cube_file)
    got = cube.read(cube_file)
    for a, b in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0]["charge"], want[0]["charge"])
    assert got[0]["charge"].shape == SHAPE
    assert set(got[3]) == set(want[3])
    for k in set(want[3]) - {"write_function"}:
        np.testing.assert_array_equal(got[3][k], want[3][k])
    assert got[3]["write_function"] is cube.write


@pytest.mark.parametrize("config", [ONGRID, {}], ids=["ongrid", "default"])
def test_cube_from_file_matches_jax(cube_file, config):
    jb = JaxBader.from_file(cube_file, **config)
    tb = Bader.from_file(cube_file, device="cpu", **config)
    assert tb.info["file_type"] == "cube"
    assert tb.info["write_function"] is cube.write
    np.testing.assert_array_equal(tb.charge, jb.charge)
    np.testing.assert_array_equal(tb.lattice, jb.lattice)
    np.testing.assert_array_equal(tb.atoms, jb.atoms)
    jb(output=None)
    tb(output=None)
    for key in ("bader_volumes", "atoms_volumes", "bader_atoms"):
        np.testing.assert_array_equal(getattr(tb, key), getattr(jb, key),
                                      err_msg=key)
    for key in ("bader_charge", "bader_volume", "atoms_charge",
                "atoms_volume"):
        np.testing.assert_allclose(getattr(tb, key), getattr(jb, key),
                                   rtol=0, atol=1e-10, err_msg=key)
    assert tb.results() == jb.results()


def test_cube_from_dict_keeps_writer(cube_file, tmp_path):
    jb = JaxBader.from_file(cube_file, **ONGRID)
    jb(output=None, export_mode=("atoms", [1]))
    out = os.path.join(os.path.dirname(cube_file), "Bader-atoms-1.cube")
    want = open(out, "rb").read()
    os.remove(out)
    tb = Bader.from_dict(jb.as_dict, device="cpu")
    assert tb.info["write_function"] is cube.write
    tb.write_volume(1)
    assert open(out, "rb").read() == want


@pytest.mark.parametrize("name, args", [
    ("voxel_to_fractional", (np.array([[0, 1, 2], [13, 11, 15]]), SHAPE,
                             [0.5, 0.5, 0.5])),
    ("fractional_to_cartesian", (np.array([[0.1, 0.5, 0.9]]), LAT)),
    ("cartesian_to_fractional", (ATOMS, LAT)),
])
def test_grid_helpers_match_jax(name, args):
    want = getattr(jgrid, name)(*args)
    got = getattr(tgrid, name)(*args)
    np.testing.assert_array_equal(got, want)


def test_nostdout_matches_jax(capsys):
    for mod in (jutils, tutils):
        with mod.nostdout():
            print("hidden")
        print("shown")
    assert capsys.readouterr().out == "shown\nshown\n"
    saved = tutils.sys.stdout
    with pytest.raises(RuntimeError), tutils.nostdout():
        raise RuntimeError
    assert tutils.sys.stdout is saved
