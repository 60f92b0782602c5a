"""End-to-end parity of the port's Bader class and CLI on the committed
CHGCAR fixture: ``method='ongrid'`` (with ``refine_method='ongrid'``, what
``bader -m ongrid`` sets), the default profile (neargrid partition and
('changed', 2) neargrid refinement) and the speed profile (ongrid, then
('changed', 3) neargrid refinement of the atom map).

Both packages get the same density, lattice, atoms and file_info: the port
through ``Bader.from_dict`` of the JAX object's ``as_dict``.  Volume maps
and maxima are identical; charges, volumes and distances agree to 1e-10;
the CLI's ``-o dat`` files equal the JAX ``results()`` text; the default
profile meets the fixture's golden charges.
"""
import contextlib
import gc
import io
import json
import os
import pickle
import shutil
import weakref
from collections import Counter

import numpy as np
import pytest
import torch

from pybader_tpu.interface import Bader as JaxBader
from pybader_tpu_torch import entry_points, trace
from pybader_tpu_torch.interface import Bader
from pybader_tpu_torch.io import vasp
from pybader_tpu_torch.utils import dtype_calc

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "CHGCAR_fixture")
GOLDEN = os.path.join(HERE, "fixtures", "CHGCAR_fixture_golden.json")
ONGRID = dict(method="ongrid", refine_method="ongrid")
ARRAYS = ["bader_charge", "bader_volume", "bader_distance", "atoms_charge",
          "atoms_volume", "atoms_surface_distance"]


@pytest.fixture(scope="module")
def pair():
    jb = JaxBader.from_file(FIXTURE, **ONGRID)
    tb = Bader.from_dict(jb.as_dict, device="cpu")
    jb(output=None)
    tb(output=None)
    return jb, tb


def test_volume_maps_and_maxima_identical(pair):
    jb, tb = pair
    for key in ("bader_volumes", "atoms_volumes", "bader_atoms"):
        got, want = getattr(tb, key), getattr(jb, key)
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    np.testing.assert_array_equal(tb.bader_maxima_fractional,
                                  jb.bader_maxima_fractional)


@pytest.mark.parametrize("key", ARRAYS)
def test_charges_volumes_distances_within_1e10(pair, key):
    jb, tb = pair
    np.testing.assert_allclose(getattr(tb, key), getattr(jb, key),
                               rtol=0, atol=1e-10)


def test_results_text_identical(pair):
    jb, tb = pair
    assert tb.results() == jb.results()
    assert tb.results(volume_flag=True) == jb.results(volume_flag=True)


def test_from_dict_swaps_in_port_writer(pair):
    _, tb = pair
    assert tb.info["write_function"] is vasp.write
    assert tb.device == "cpu" and Bader.device == "cuda"


def test_from_file_reads_like_jax():
    jb = JaxBader.from_file(FIXTURE)
    tb = Bader.from_file(FIXTURE)
    np.testing.assert_array_equal(tb.charge, jb.charge)
    np.testing.assert_array_equal(tb.lattice, jb.lattice)
    np.testing.assert_array_equal(tb.atoms, jb.atoms)
    assert tb.method == jb.method and tb.refine_mode == jb.refine_mode
    keys = set(jb.info) - {"write_function"}
    assert keys == set(tb.info) - {"write_function"}
    for k in keys:
        np.testing.assert_array_equal(tb.info[k], jb.info[k])


def test_cli_dat_files_equal_jax_results(pair, tmp_path, monkeypatch):
    jb, _ = pair
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(entry_points, "__config__",
                        str(tmp_path / "cfg" / "config.ini"))
    entry_points.bader([FIXTURE, "-m", "ongrid", "-o", "dat",
                        "--device", "cpu"])
    with open("CHGCAR_fixture-atoms.dat") as f:
        assert f.read() == jb.results()
    with open("CHGCAR_fixture-volumes.dat") as f:
        assert f.read() == jb.results(volume_flag=True)


def test_vacuum_and_spin_match_jax(tmp_path):
    jb = JaxBader.from_file(FIXTURE, vacuum_tol=0.2, spin_flag=True, **ONGRID)
    jb.spin = jb.charge * 0.25 - 2.0
    tb = Bader.from_dict(jb.as_dict, device="cpu")
    jb(output=None)
    tb(output=None)
    assert jb.vacuum_volume > 0
    np.testing.assert_array_equal(tb.bader_volumes, jb.bader_volumes)
    np.testing.assert_allclose([tb.vacuum_charge, tb.vacuum_volume],
                               [jb.vacuum_charge, jb.vacuum_volume],
                               rtol=0, atol=1e-10)
    for key in ARRAYS + ["bader_spin", "atoms_spin"]:
        np.testing.assert_allclose(getattr(tb, key), getattr(jb, key),
                                   rtol=0, atol=1e-10, err_msg=key)
    assert tb.results() == jb.results()


def test_export_volume_file_identical(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    src = tmp_path / "CHGCAR"
    shutil.copy(FIXTURE, src)
    for cls, sub, kw in ((JaxBader, "jax", {}), (Bader, "port",
                                                  {"device": "cpu"})):
        b = cls.from_file(str(src), **ONGRID, **kw)
        b.info["prefix"] = str(tmp_path / sub) + os.sep
        os.makedirs(b.info["prefix"])
        b(output=None, export_mode=("atoms", [0]))
    want = (tmp_path / "jax" / "Bader-atoms-0-CHGCAR").read_text()
    assert (tmp_path / "port" / "Bader-atoms-0-CHGCAR").read_text() == want


@pytest.fixture(scope="module")
def default_pair():
    jb = JaxBader.from_file(FIXTURE)
    tb = Bader.from_dict(jb.as_dict, device="cpu")
    assert (tb.method, tb.refine_method) == ("neargrid", "neargrid")
    assert tuple(tb.refine_mode) == ("changed", 2) and not tb.speed_flag
    jb(output=None)
    tb(output=None)
    return jb, tb


def test_default_profile_maps_and_maxima_identical(default_pair):
    jb, tb = default_pair
    for key in ("bader_volumes", "atoms_volumes", "bader_atoms"):
        np.testing.assert_array_equal(getattr(tb, key), getattr(jb, key),
                                      err_msg=key)
    np.testing.assert_array_equal(tb.bader_maxima_fractional,
                                  jb.bader_maxima_fractional)


@pytest.mark.parametrize("key", ARRAYS)
def test_default_profile_arrays_within_1e10(default_pair, key):
    jb, tb = default_pair
    np.testing.assert_allclose(getattr(tb, key), getattr(jb, key),
                               rtol=0, atol=1e-10)


def test_default_profile_results_text_identical(default_pair):
    jb, tb = default_pair
    assert tb.results() == jb.results()
    assert tb.results(volume_flag=True) == jb.results(volume_flag=True)


def test_default_profile_meets_golden(default_pair):
    """As tests/test_chgcar_fixture.py holds the JAX package: per-atom
    charges and volumes to 1e-6, the same maxima, charge conserved."""
    _, tb = default_pair
    with open(GOLDEN) as f:
        golden = json.load(f)
    np.testing.assert_allclose(tb.atoms_charge, golden["atoms_charge"],
                               atol=1e-6)
    np.testing.assert_allclose(tb.atoms_volume, golden["atoms_volume"],
                               atol=1e-6)
    shape = np.array(tb.density.shape)
    vox = np.rint(tb.bader_maxima_fractional * shape
                  - tb.voxel_offset_fractional).astype(int) % shape
    assert {tuple(m) for m in vox} == {tuple(m) for m in golden["maxima"]}
    np.testing.assert_allclose(np.sum(tb.atoms_charge),
                               golden["total_charge"], rtol=1e-9)


def test_cli_default_dat_files_equal_jax_results(default_pair, tmp_path,
                                                 monkeypatch):
    jb, _ = default_pair
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(entry_points, "__config__",
                        str(tmp_path / "cfg" / "config.ini"))
    entry_points.bader([FIXTURE, "-o", "dat", "--device", "cpu"])
    with open("CHGCAR_fixture-atoms.dat") as f:
        assert f.read() == jb.results()
    with open("CHGCAR_fixture-volumes.dat") as f:
        assert f.read() == jb.results(volume_flag=True)


def test_default_profile_vacuum_and_spin_match_jax():
    jb = JaxBader.from_file(FIXTURE, vacuum_tol=0.2, spin_flag=True)
    jb.spin = jb.charge * 0.25 - 2.0
    tb = Bader.from_dict(jb.as_dict, device="cpu")
    jb(output=None)
    tb(output=None)
    assert jb.vacuum_volume > 0 and (tb.bader_volumes == -1).any()
    np.testing.assert_array_equal(tb.bader_volumes, jb.bader_volumes)
    np.testing.assert_array_equal(tb.atoms_volumes, jb.atoms_volumes)
    for key in ARRAYS + ["bader_spin", "atoms_spin"]:
        np.testing.assert_allclose(getattr(tb, key), getattr(jb, key),
                                   rtol=0, atol=1e-10, err_msg=key)
    assert tb.results() == jb.results()


def test_speed_profile_matches_jax():
    """ongrid partition, then ('changed', 3) neargrid refinement of the
    atom map, which starts fresh (no carry)."""
    from pybader_tpu_torch.interface import SPEED_CONFIG

    jb = JaxBader.from_file(FIXTURE, **SPEED_CONFIG)
    tb = Bader.from_dict(jb.as_dict, device="cpu", **SPEED_CONFIG)
    jb(output=None)
    tb(output=None)
    assert not hasattr(tb, "bader_volumes")
    np.testing.assert_array_equal(tb.atoms_volumes, jb.atoms_volumes)
    for key in ("atoms_charge", "atoms_volume", "atoms_surface_distance"):
        np.testing.assert_allclose(getattr(tb, key), getattr(jb, key),
                                   rtol=0, atol=1e-10, err_msg=key)
    assert tb.results() == jb.results()


def test_cli_profile_writes_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(entry_points, "__config__",
                        str(tmp_path / "cfg" / "config.ini"))
    entry_points.bader([FIXTURE, "-m", "ongrid", "-o", "dat",
                        "--device", "cpu", "--profile", "prof"])
    trace = tmp_path / "prof" / "trace.json"
    assert trace.exists() and trace.stat().st_size > 0
    assert (tmp_path / "CHGCAR_fixture-atoms.dat").exists()


@pytest.fixture(scope="module")
def vacuum_pair():
    """The default profile with a vacuum (about a tenth of the voxels)."""
    jb = JaxBader.from_file(FIXTURE, vacuum_tol=0.2)
    tb = Bader.from_dict(jb.as_dict, device="cpu")
    jb(output=None)
    tb(output=None)
    assert jb.vacuum_volume > 0
    return jb, tb


@pytest.fixture(scope="module")
def speed_pair():
    from pybader_tpu_torch.interface import SPEED_CONFIG

    config = dict(SPEED_CONFIG, vacuum_tol=0.2)
    jb = JaxBader.from_file(FIXTURE, **config)
    tb = Bader.from_dict(jb.as_dict, device="cpu", **config)
    jb(output=None)
    tb(output=None)
    return jb, tb


@pytest.mark.parametrize("which", ["pair", "default_pair", "vacuum_pair",
                                   "speed_pair"])
def test_result_label_grids_are_numpy_in_the_dtype_calc_dtype(which,
                                                              request):
    """The grids that stay on the device during a call reach the object
    as numpy, in the dtype the JAX package gives them, and equal."""
    jb, tb = request.getfixturevalue(which)
    counts = {"bader_volumes": len(tb.bader_maxima_fractional),
              "atoms_volumes": len(tb.atoms)}
    keys = ["atoms_volumes"] if tb.speed_flag else list(counts)
    assert hasattr(tb, "bader_volumes") == (not tb.speed_flag)
    for key in keys:
        got, want = getattr(tb, key), getattr(jb, key)
        assert type(got) is np.ndarray, key
        assert got.dtype == np.dtype(dtype_calc(-counts[key])) == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert "_resident" not in tb.__dict__


def test_standalone_stages_re_threshold_like_jax(default_pair):
    """``bader-read -vac``'s stages on unpickled objects: ``volumes_init``
    on a label grid and ``sum_volumes`` take host attributes, hold no grid,
    and sum as the JAX package does; the mask comes from one upload."""
    jb, tb = (pickle.loads(pickle.dumps(b)) for b in default_pair)
    spans = []
    for b in (jb, tb):
        b.vacuum_tol = 0.25
        with contextlib.redirect_stdout(io.StringIO()), \
                trace.recording(spans if b is tb else []):
            b.volumes_init(volumes=b.bader_volumes)
            b.sum_volumes(bader=True)
            b.volumes_init(volumes=b.atoms_volumes)
            b.atoms_volumes = b.bader_volumes
            b.sum_volumes()
    assert tb.vacuum_volume > 0
    np.testing.assert_array_equal(tb.atoms_volumes, jb.atoms_volumes)
    for key in ("bader_charge", "bader_volume", "atoms_charge",
                "atoms_volume", "vacuum_charge", "vacuum_volume"):
        np.testing.assert_allclose(getattr(tb, key), getattr(jb, key),
                                   rtol=0, atol=1e-10, err_msg=key)
    names = Counter(s.name for s in spans)
    assert not [k for k in names if k.startswith("resident.")]
    assert names["upload.reference"] == 0
    assert names["upload.density"] == 4  # two masks, two sums
    assert names["download.vacuum_mask"] == 2
    assert names["upload.bader_volumes"] == names["upload.atoms_volumes"] \
        == 1


@pytest.mark.parametrize("config", [
    {}, {"vacuum_tol": 0.2},
    {"method": "ongrid", "refine_mode": ("changed", 3), "speed_flag": True},
    {"env": "0"}], ids=["default", "vacuum", "speed", "hybrid"])
def test_a_finished_call_is_freed_at_del(config, tmp_path, monkeypatch):
    """A call leaves no reference cycle: dropping the object frees it, and
    its label grids with it, by reference count (``hostcopy``'s pool takes
    a result's buffer back only then), with the collector off.  Its
    downloads carry ``warm``, 0 where nothing was pooled (on the CPU)."""
    config = dict(config)
    if "env" in config:  # the hybrid partition, whatever the grid's size
        monkeypatch.setenv("PYBADER_TPU_FULL_TRAJECTORIES", config.pop("env"))
    with contextlib.redirect_stdout(io.StringIO()):
        b = Bader(*vasp.read(FIXTURE), device="cpu", output="dat",
                  prefix=str(tmp_path) + os.sep, **config)
        gc.collect()
        gc.disable()
        try:
            b()
            downloads = [s for s in b.spans
                         if s.name.startswith("download.")]
            alive = [weakref.ref(b), weakref.ref(b.atoms_volumes)]
            del b
            assert [r() for r in alive] == [None, None]
        finally:
            gc.enable()
    names = {s.name for s in downloads}
    assert {"download.atoms_volumes"} <= names
    assert all(s.counters["warm"] == 0 for s in downloads
               if s.name not in ("download.first_member", "download.max_pos"))
