"""Parity of the port's object readers with the JAX package's: ``gpaw`` and
``pymatgen`` ``read_obj`` on the stub objects of ``tests/test_io_objects.py``
(bit-identical arrays, the same ``file_info`` but for the port's writer),
``gpaw.read`` without gpaw, the default profile on the CPU on each stub
(identical volume maps and maxima; charges, volumes and distances within
1e-10; identical ``results()`` text), ``write_volume`` byte for byte,
``Bader.from_dict`` keeping each reader's writer, and the CLI's ``-i``
choices."""
import os
import re
from inspect import getmembers, ismodule

import numpy as np
import pytest
import torch

from pybader_tpu import io as jio
from pybader_tpu.interface import Bader as JaxBader
from pybader_tpu.io import gpaw as jgpaw
from pybader_tpu.io import pymatgen as jpymatgen
from pybader_tpu_torch import entry_points
from pybader_tpu_torch.interface import Bader
from pybader_tpu_torch.io import cube, gpaw, pymatgen, vasp
from tests.test_io_objects import FakeGPAWCalc, FakeVolumetricData
from tests.test_ongrid import make_density

torch.set_num_threads(1)

ARRAYS = ["bader_charge", "bader_volume", "bader_distance", "atoms_charge",
          "atoms_volume", "atoms_surface_distance"]


def stub(kind, spin):
    """(stub object, JAX reader module, port reader module, the port's
    writer) for one reader, with or without a spin density."""
    if kind == "gpaw":
        rho = make_density(1)
        obj = FakeGPAWCalc(rho, make_density(2) * 0.1 if spin else None)
        return obj, jgpaw, gpaw, cube.write
    rho = make_density(4)
    obj = FakeVolumetricData(rho, make_density(5) * 0.2 if spin else None)
    return obj, jpymatgen, pymatgen, vasp.write


STUBS = [("gpaw", False), ("gpaw", True), ("pymatgen", False),
         ("pymatgen", True)]
IDS = ["gpaw", "gpaw-spin", "pymatgen", "pymatgen-spin"]


@pytest.mark.parametrize("kind, spin", STUBS, ids=IDS)
def test_read_obj_identical_to_jax(kind, spin):
    obj, jmod, tmod, writer = stub(kind, spin)
    jd, jlat, jatoms, jinfo = jmod.read_obj(obj, spin_flag=spin)
    td, tlat, tatoms, tinfo = tmod.read_obj(obj, spin_flag=spin)
    assert sorted(td) == sorted(jd) == (["charge", "spin"] if spin
                                        else ["charge"])
    for key in jd:
        assert td[key].dtype == jd[key].dtype
        np.testing.assert_array_equal(td[key], jd[key])
    np.testing.assert_array_equal(tlat, jlat)
    np.testing.assert_array_equal(tatoms, jatoms)
    assert set(tinfo) == set(jinfo)
    for key in set(jinfo) - {"write_function"}:
        np.testing.assert_array_equal(tinfo[key], jinfo[key], err_msg=key)
    assert tinfo["write_function"] is writer


def test_gpaw_read_without_gpaw_raises(tmp_path):
    fn = str(tmp_path / "calc.gpw")
    assert not gpaw.GPAW_AVAIL and not jgpaw.GPAW_AVAIL
    assert gpaw.__extensions__ == jgpaw.__extensions__ == [".gpw"]
    assert gpaw.__args__ == jgpaw.__args__
    assert pymatgen.__extensions__ is None and pymatgen.__args__ == \
        jpymatgen.__args__
    for read in (jgpaw.read, gpaw.read, JaxBader.from_file, Bader.from_file):
        # from_file dispatches a .gpw name to the gpaw reader
        with pytest.raises(ImportError):
            read(fn)


@pytest.fixture(scope="module")
def results():
    """The default profile on each stub: JAX's Bader, the port's on the
    CPU, keyed by (kind, spin)."""
    out = {}
    for kind, spin in STUBS:
        obj, jmod, tmod, _ = stub(kind, spin)
        jb = JaxBader(*jmod.read_obj(obj, spin_flag=spin), spin_flag=spin)
        tb = Bader(*tmod.read_obj(obj, spin_flag=spin), spin_flag=spin,
                   device="cpu")
        assert (tb.method, tb.refine_mode) == ("neargrid", ("changed", 2))
        jb(output=None)
        tb(output=None)
        out[kind, spin] = jb, tb
    return out


@pytest.mark.parametrize("kind, spin", STUBS, ids=IDS)
def test_default_profile_volume_maps_identical(results, kind, spin):
    jb, tb = results[kind, spin]
    for key in ("bader_volumes", "atoms_volumes", "bader_atoms"):
        got, want = getattr(tb, key), getattr(jb, key)
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    np.testing.assert_array_equal(tb.bader_maxima_fractional,
                                  jb.bader_maxima_fractional)


@pytest.mark.parametrize("kind, spin", STUBS, ids=IDS)
def test_default_profile_sums_within_1e10(results, kind, spin):
    jb, tb = results[kind, spin]
    keys = ARRAYS + (["bader_spin", "atoms_spin"] if spin else [])
    for key in keys:
        np.testing.assert_allclose(getattr(tb, key), getattr(jb, key),
                                   rtol=0, atol=1e-10, err_msg=key)
    total = tb.charge.sum() * tb.voxel_volume
    np.testing.assert_allclose(tb.atoms_charge.sum(), total, rtol=1e-10)


@pytest.mark.parametrize("kind, spin", STUBS, ids=IDS)
def test_default_profile_results_text_identical(results, kind, spin):
    jb, tb = results[kind, spin]
    assert tb.results() == jb.results()
    assert tb.results(volume_flag=True) == jb.results(volume_flag=True)


def written_volumes(b, where):
    """Files of write_volume for every atom and the first two volumes,
    written in ``where`` (a reader's prefix is empty: the working
    directory)."""
    os.makedirs(where)
    cwd = os.getcwd()
    os.chdir(where)
    try:
        b.export_mode = ("atoms", None)
        for n in range(b.atoms.shape[0]):
            b.write_volume(n)
        b.export_mode = ("volumes", None)
        for n in (0, 1):
            b.write_volume(n)
    finally:
        os.chdir(cwd)
    return {n: open(os.path.join(where, n), "rb").read()
            for n in sorted(os.listdir(where))}


@pytest.mark.parametrize("kind, spin", STUBS, ids=IDS)
def test_write_volume_byte_identical(results, kind, spin, tmp_path):
    jb, tb = results[kind, spin]
    want = written_volumes(jb, str(tmp_path / "jax"))
    got = written_volumes(tb, str(tmp_path / "port"))
    assert len(want) == jb.atoms.shape[0] + 2
    assert got == want


@pytest.mark.parametrize("kind, spin", STUBS, ids=IDS)
def test_from_dict_keeps_reader_writer(results, kind, spin, tmp_path):
    jb, tb = results[kind, spin]
    writer = stub(kind, spin)[3]
    # from the port's own dict, and from the JAX package's (whose
    # write_function is the JAX writer)
    for d in (tb.as_dict, jb.as_dict):
        b = Bader.from_dict(d, device="cpu")
        assert b.info["file_type"] == jb.info["file_type"]
        assert b.info["write_function"] is writer
    assert (written_volumes(b, str(tmp_path / "recast"))
            == written_volumes(jb, str(tmp_path / "jax")))


def test_cli_file_type_choices_equal_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(entry_points, "__config__",
                        str(tmp_path / "cfg" / "config.ini"))
    with pytest.raises(SystemExit):
        entry_points.bader(["CHGCAR", "-i", "nosuchtype"])
    err = capsys.readouterr().err
    listed = re.search(r"choose from (.*)\)", err).group(1)
    got = re.findall(r"\w+", listed)
    want = [name for name, mod in getmembers(jio, ismodule)
            if hasattr(mod, "read")]
    assert got == want == ["cube", "gpaw", "vasp"]
