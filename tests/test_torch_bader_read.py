"""Parity of the port's ``bader-read`` (``entry_points.bader_read``) with the
JAX package's, on the committed CHGCAR fixture.

Each package's ``bader`` CLI writes its own pickle (the port's with
``--device cpu``): the default profile; ``-m ongrid -s`` on a copy of the
fixture with a spin block; and the default pickle after ``results()`` has
cached its table.  Each package's ``bader_read`` then runs on a fresh copy
of its own pickle with the same flags.  The printed text must be equal
(with the stage times and progress-bar clocks masked), every file written byte-identical, and after
``-r`` the rewritten pickle's ``as_dict`` equal: arrays identical but
floats, which agree within 1e-10.
"""
import os
import pickle
import re
import shutil

import numpy as np
import pytest
import torch

from pybader_tpu import entry_points as jax_entry
from pybader_tpu import precompile
from pybader_tpu_torch import entry_points
from pybader_tpu_torch.interface import Bader
from pybader_tpu_torch.io import vasp

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "CHGCAR_fixture")
# stage times and the writers' progress-bar clocks
TIMES = re.compile(r"done in \d+\.\d+s|\d\d:\d\d")
# the fixture's density lies in [0.116, 4.74]; 0.25 makes about a quarter
# of the voxels vacuum, `auto` (1e-3) none
VAC = "0.25"

# profile -> the bader CLI's flags and its input file
PROFILES = {
    "default": ([], "CHGCAR_fixture"),
    "spin": (["-m", "ongrid", "-s"], "CHGCAR_spin"),
    "cached": ([], "CHGCAR_fixture"),
}

# (profile, bader_read runs in order, each its flags after the pickle name)
CASES = [
    ("default", [["-a"]]),
    ("default", [["-v"]]),
    ("default", [["-vac", "auto", "-a"]]),
    ("default", [["-vac", VAC, "-v", "-a"]]),
    ("default", [["-vac", "0"]]),
    ("default", [["-vac", VAC, "-r"], ["-vac", "0.2", "-a"]]),
    ("default", [["-e", "0", "3"]]),
    ("default", [["-e", "all_atoms"]]),
    ("default", [["-e", "all_volumes"]]),
    ("default", [["-e", "sel_atoms", "1", "2"]]),
    ("default", [["-e", "sel_volumes", "0", "2"]]),
    ("default", [["-e", "atoms"]]),
    ("default", [["-e", "volumes", "1"]]),
    ("default", [["-vac", VAC, "-e", "all_atoms"]]),
    ("default", [["-d"]]),
    ("default", [["-f", "-f", "-d"]]),
    ("default", [["-r"], ["-a"]]),
    ("default", [["-vac", VAC, "-r"], ["-a", "-v"]]),
    ("spin", [["-vac", "auto", "-v", "-a"]]),
    ("spin", [["-vac", VAC, "-v", "-a"]]),
    ("spin", [["-r"], ["-a"]]),
    ("cached", [["-vac", VAC, "-a"]]),
]


def spin_chgcar(path):
    """The fixture with a spin block made from a seed, written with the
    sign column (format 1): the readers take every line of a block to be
    as long as its first, which format 0 breaks with mixed signs."""
    density, lattice, atoms, info = vasp.read(FIXTURE)
    rng = np.random.default_rng(7)
    charge = density["charge"]
    spin = 0.2 * charge * (rng.random(charge.shape) - 0.5)
    info = dict(info, comment="fixture with spin\n", spin_flag=True,
                fortran_format=1)
    vasp.write(str(path), atoms, lattice, {"charge": charge, "spin": spin},
               info, prefix="", suffix="")


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    """root / profile / package / bader.p for each profile and package."""
    root = tmp_path_factory.mktemp("bader_read")
    inputs = root / "inputs"
    inputs.mkdir()
    shutil.copy(FIXTURE, inputs / "CHGCAR_fixture")
    spin_chgcar(inputs / "CHGCAR_spin")
    # a compilation cache that is not empty: the JAX CLI warms none
    cache = root / "jax_cache"
    cache.mkdir()
    (cache / "seeded").write_text("")
    clis = {"jax": lambda a: jax_entry.bader(a),
            "port": lambda a: entry_points.bader(a + ["--device", "cpu"])}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(precompile, "enable_persistent_cache", lambda: str(cache))
        mp.setattr(jax_entry, "__config__", str(root / "jax.ini"))
        mp.setattr(entry_points, "__config__", str(root / "port.ini"))
        for profile, (flags, name) in PROFILES.items():
            for pkg, cli in clis.items():
                where = root / profile / pkg
                where.mkdir(parents=True)
                shutil.copy(inputs / name, where / name)
                mp.chdir(where)
                cli([name, *flags])  # a relative name: an empty prefix
                os.remove(name)
                if profile == "cached":
                    with open("bader.p", "rb") as f:
                        b = pickle.load(f)
                    b.results()
                    b.to_file()
    return root


def run_reads(pkg, profile, runs, pickles, where, monkeypatch, capsys):
    """bader_read of one package on a fresh copy of its pickle, one call a
    run: (printed text of each run, files written, the pickle after)."""
    where.mkdir()
    shutil.copy(pickles / profile / pkg / "bader.p", where / "bader.p")
    monkeypatch.chdir(where)
    capsys.readouterr()
    texts = []
    for flags in runs:
        if pkg == "jax":
            jax_entry.bader_read(["bader.p", *flags])
        else:
            entry_points.bader_read(["bader.p", *flags, "--device", "cpu"])
        texts.append(TIMES.sub("-", capsys.readouterr().out))
    files = {n: (where / n).read_bytes() for n in sorted(os.listdir(where))
             if n != "bader.p"}
    with open(where / "bader.p", "rb") as f:
        return texts, files, pickle.load(f)


def assert_same_value(got, want, key):
    if isinstance(want, dict):
        assert set(got) == set(want), key
        for k in want:
            assert_same_value(got[k], want[k], f"{key}[{k!r}]")
    elif isinstance(want, (np.ndarray, np.generic)) or isinstance(got, (
            np.ndarray, np.generic)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-10,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    elif isinstance(want, float):
        assert isinstance(got, float), key
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10,
                                   err_msg=key)
    else:
        assert got == want, key


def assert_dicts_equal(got, want):
    """as_dict of the two rewritten pickles: every entry equal, file_info
    but its writer, which must be the port's."""
    assert set(got) == set(want)
    info_got, info_want = dict(got["_file_info"]), dict(want["_file_info"])
    assert info_got.pop("write_function") is vasp.write
    info_want.pop("write_function")
    assert_same_value(info_got, info_want, "_file_info")
    for key in set(want) - {"_file_info"}:
        assert_same_value(got[key], want[key], key)


@pytest.mark.parametrize(
    "profile, runs", CASES,
    ids=[f"{p}:" + "|".join(" ".join(r) for r in runs) for p, runs in CASES])
def test_bader_read_matches_jax(pickles, profile, runs, tmp_path,
                                monkeypatch, capsys):
    want = run_reads("jax", profile, runs, pickles, tmp_path / "jax",
                     monkeypatch, capsys)
    got = run_reads("port", profile, runs, pickles, tmp_path / "port",
                    monkeypatch, capsys)
    assert got[0] == want[0]
    assert list(got[1]) == list(want[1])
    for name in want[1]:
        assert got[1][name] == want[1][name], name
    flags = {f for r in runs for f in r}
    if flags & {"-e", "-d"}:
        assert want[1]
    if "-r" in flags:
        assert isinstance(got[2], Bader) and got[2].device == "cpu"
        assert_dicts_equal(got[2].as_dict, want[2].as_dict)
    if "-a" in flags or "-v" in flags:
        assert "Number of Electrons:" in got[0][-1]
        if profile == "default" and VAC in flags:
            assert "Vacuum Charge:" in got[0][-1]


def test_recast_after_rethreshold_conserves_charge(pickles, tmp_path,
                                                   monkeypatch, capsys):
    _, _, b = run_reads("port", "default", [["-vac", VAC, "-r"]], pickles,
                        tmp_path / "port", monkeypatch, capsys)
    assert 0 < b.vacuum_volume
    np.testing.assert_allclose(
        b.atoms_charge.sum() + b.vacuum_charge,
        b.density.sum() * b.voxel_volume, rtol=1e-10)


class NoTorchUnpickler(pickle.Unpickler):
    """Refuses every torch class, so a pickled tensor cannot load."""

    def find_class(self, module, name):
        if module == "torch" or module.startswith("torch."):
            raise AssertionError(f"pickle holds {module}.{name}")
        return super().find_class(module, name)


@pytest.mark.parametrize("profile", list(PROFILES))
def test_port_pickle_holds_no_tensor(pickles, profile, tmp_path, monkeypatch,
                                     capsys):
    run_reads("port", profile, [["-vac", VAC, "-r"]], pickles,
              tmp_path / "port", monkeypatch, capsys)
    for path in (pickles / profile / "port" / "bader.p",
                 tmp_path / "port" / "bader.p"):
        with open(path, "rb") as f:
            assert isinstance(NoTorchUnpickler(f).load(), Bader)


def test_device_comes_from_the_flag(pickles, tmp_path, monkeypatch, capsys):
    """The pickle's stored device is ignored: without CUDA the default
    device raises on a re-threshold and leaves the file as it was; with
    --device cpu a pickle that says cuda re-thresholds on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    monkeypatch.chdir(tmp_path)
    shutil.copy(pickles / "default" / "port" / "bader.p", "bader.p")
    before = open("bader.p", "rb").read()
    assert pickle.loads(before).device == "cpu"
    for flags in (["-vac", "auto"], ["-vac", VAC, "-a", "-r"]):
        with pytest.raises((AssertionError, RuntimeError)):
            entry_points.bader_read(["bader.p", *flags])
        assert open("bader.p", "rb").read() == before
    b = pickle.loads(before)
    b.device = "cuda"
    with open("bader.p", "wb") as f:
        pickle.dump(b, f)
    capsys.readouterr()
    entry_points.bader_read(["bader.p", "-vac", VAC, "-a", "-r",
                             "--device", "cpu"])
    assert "Vacuum Charge:" in capsys.readouterr().out
    with open("bader.p", "rb") as f:
        assert pickle.load(f).device == "cpu"
