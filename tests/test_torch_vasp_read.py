"""The port's CHGCAR reader (``pybader_tpu_torch.io.vasp.read``) against
the JAX package's, bit for bit, on every file both can read: the
committed fixture, a grid whose point count is no multiple of 5, files
with and without a species line, augmentation lines between the charge
and the spin blocks, a skipped charge block, and a 64³ file that gives
every thread several tiles, each on one thread and on four.  Then what
only the port reads (lines of varying width, held to a plain
``text.split()`` parse), every kind of token against Python's
``float()``, the errors of a file short of values or with a token that is
no number, the Python path taken where the native library cannot be
loaded, with its ``read.*`` spans, and the host buffer a second read
reuses."""
import contextlib
import io
import os

import numpy as np
import pytest

from pybader_tpu.io import vasp as jvasp
from pybader_tpu_torch import hostcopy, trace
from pybader_tpu_torch import utils as tutils
from pybader_tpu_torch.io import _fastparse, vasp

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "CHGCAR_fixture")
LAT = np.array([[5.4, 0.0, 0.0], [0.3, 6.2, 0.0], [0.0, 0.4, 7.0]])
AUGMENTATION = ("augmentation occupancies   1  4\n"
                "  0.1234567E+00 -0.2345678E-01  0.3456789E-02  0.0000000E+00\n"
                "augmentation occupancies   2  4\n"
                "  0.4567890E+00  0.5678901E-01 -0.6789012E-02  0.7890123E-03\n")


def _python_rows(a, prec):
    return tutils.python_format(a, prec, " ")


def _header(species=True):
    lines = ["test density", "   1.00000000000000"]
    lines += ["  " + " ".join(f"{x:.12f}" for x in row) for row in LAT]
    if species:
        lines.append("   Si   O")
    lines += ["   1   2", "Direct", "  0.10 0.20 0.30", "  0.50 0.50 0.50",
              "  0.75 0.25 0.60", ""]
    return "\n".join(lines) + "\n"


def write_chgcar(path, shape, seed, species=True, spin=False,
                 augmentation=False, fortran=False, wide=False):
    """A CHGCAR of fixed-width lines, five values each, as VASP (fortran
    standard form, ``0.ddd``/``-.ddd``) or a Python writer (a sign column)
    writes them; ``wide`` draws magnitudes over 10^±40, so that many
    tokens fall outside the exact fast path."""
    rng = np.random.default_rng(seed)
    if wide:
        charge = 10.0 ** rng.uniform(-40, 40, shape)
    else:
        charge = rng.lognormal(0.0, 2.0, shape)
    rows = tutils.fortran_format if fortran else _python_rows
    grid = " " + " ".join(f"{s:5d}" for s in shape) + "\n"
    with open(path, "w") as f:
        f.write(_header(species) + grid)
        vasp._write_block(f, charge, rows)
        if augmentation:
            f.write(AUGMENTATION)
        if spin:
            f.write(grid)
            vasp._write_block(f, rng.standard_normal(shape) * 0.3, rows)
            if augmentation:
                f.write(AUGMENTATION)
    return path


def read(fn, reader=vasp.read, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return reader(fn, **kw)


def assert_same(got, want):
    """Two reads (density dict, lattice, atoms, file_info), bit for bit."""
    assert set(got[0]) == set(want[0])
    for key in want[0]:
        g, w = got[0][key], want[0][key]
        assert g.shape == w.shape and g.dtype == w.dtype == np.float64
        assert g.flags.c_contiguous
        assert np.array_equal(g.view(np.int64), w.view(np.int64)), key
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[2], want[2])
    for key in ("element_nums", "charge_flag", "spin_flag"):
        assert np.array_equal(got[3][key], want[3][key])
    assert got[3].get("elements") == want[3].get("elements")


# name -> (file maker over a directory, read flags); the JAX reader cannot
# skip the charge block (text-mode files refuse its relative seek), so
# "spin_only" is held to its read of both blocks, less the charge
CASES = {
    "fixture": (lambda d: FIXTURE, {}),
    "fixture_spin": (lambda d: FIXTURE, {"spin_flag": True}),
    "odd_7x9x11": (lambda d: write_chgcar(d / "odd", (7, 9, 11), 1), {}),
    "odd_no_species": (lambda d: write_chgcar(d / "nospecies", (7, 9, 11),
                                              2, species=False), {}),
    "augmented_spin": (lambda d: write_chgcar(
        d / "spin", (10, 12, 14), 3, spin=True, augmentation=True,
        fortran=True), {"spin_flag": True}),
    "spin_only": (lambda d: write_chgcar(
        d / "spin", (10, 12, 14), 4, spin=True, augmentation=True,
        fortran=True), {"charge_flag": False, "spin_flag": True}),
    "wide_64": (lambda d: write_chgcar(d / "wide", (64, 64, 64), 5,
                                       wide=True), {}),
}


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_reads_bit_equal_to_jax(tmp_path, case, threads):
    make, flags = CASES[case]
    fn = str(make(tmp_path))
    got = read(fn, threads=threads, **flags)
    if flags.get("charge_flag", True):
        want = read(fn, jvasp.read, threads=threads, **flags)
    else:
        want = read(fn, jvasp.read, threads=threads, spin_flag=True)
        del want[0]["charge"]
        want[3]["charge_flag"] = False
    assert_same(got, want)
    if case == "wide_64":
        # the slabs outnumber the threads, and the text passes the exact
        # fast path's 10^±22 as often as not
        text = open(fn).read()
        assert text.count("E-") + text.count("E+") == 64 ** 3
        assert text.count("E+3") + text.count("E-3") > 64 ** 3 // 5


def _varying(path, shape, seed, spin=False):
    """A CHGCAR whose lines hold 1 to 9 values, each ``f"{v:.11E}"`` (no
    sign column, so negatives are a character wider): the values it holds,
    in file order, as text."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    grid = " " + " ".join(f"{s:5d}" for s in shape) + "\n"
    blocks = []
    with open(path, "w") as f:
        f.write(_header() + grid)
        for key in ("charge", "spin") if spin else ("charge",):
            vals = rng.standard_normal(n) * 10.0 ** rng.integers(-5, 5, n)
            toks = [f"{v:.11E}" for v in vals]
            blocks.append(toks)
            i = 0
            while i < n:
                k = int(rng.integers(1, 10))
                f.write(" ".join(toks[i:i + k]) + "\n")
                i += k
            if spin and key == "charge":
                f.write(AUGMENTATION + grid)
    return blocks


@pytest.mark.parametrize("threads", [1, 4])
def test_lines_of_varying_width_read_as_split(tmp_path, threads):
    shape = (9, 10, 19)
    fn = str(tmp_path / "CHGCAR")
    blocks = _varying(fn, shape, 6, spin=True)
    density, lattice = read(fn, threads=threads, spin_flag=True)[:2]
    vol = np.dot(lattice[0], np.cross(lattice[1], lattice[2]))
    for key, toks in zip(("charge", "spin"), blocks):
        want = np.array([float(t) for t in toks]).reshape(shape[::-1])
        want = np.ascontiguousarray(np.swapaxes(want, 0, -1)) / vol
        assert np.array_equal(density[key].view(np.int64),
                              want.view(np.int64)), key


def _fortran(v):
    """``v`` as VASP's fortran standard form: ``0.ddd`` or ``-.ddd``."""
    return tutils.fortran_format(np.array([[v]]), 11).strip()


def test_every_token_parses_as_python_float(tmp_path):
    rng = np.random.default_rng(7)
    shape = (10, 10, 10)
    n = int(np.prod(shape))
    vals = (rng.choice([-1.0, 1.0], n) * rng.uniform(1, 10, n)
            * 10.0 ** rng.integers(-99, 99, n)).tolist()
    forms = [lambda v: f"{v:.11E}", lambda v: f"{v: .11e}", _fortran,
             repr, lambda v: f"{v:.17g}", lambda v: f"{v:.3E}"]
    toks = [forms[int(rng.integers(len(forms)))](v) for v in vals]
    # the fast path's edges: zeros, 10^±22, 10^±23, the exponent's range
    edges = ["0.00000000000E+00", "-0.00000000000E+00", "-.00000000000E+00",
             "1.23456789012E+33", "1.23456789012E+34", "9.99999999999E-11",
             "9.99999999999E-12", "1.00000000000E+99", "-.99999999999E-99",
             "0.12345678901e+05", "1", ".5", "-7.", "1e5", "4.9E-324",
             "1.7976931348623157E+308", "0.00000000001E+00"]
    toks[:len(edges)] = edges
    fn = str(tmp_path / "CHGCAR")
    grid = " " + " ".join(f"{s:5d}" for s in shape) + "\n"
    with open(fn, "w") as f:
        f.write(_header() + grid)
        for i in range(0, n, 5):
            f.write(" " + " ".join(toks[i:i + 5]) + "\n")
    for threads in (1, 3):
        density, lattice = read(fn, threads=threads)[:2]
        vol = np.dot(lattice[0], np.cross(lattice[1], lattice[2]))
        want = np.array([float(t) for t in toks]).reshape(shape[::-1])
        want = np.ascontiguousarray(np.swapaxes(want, 0, -1)) / vol
        assert np.array_equal(density["charge"].view(np.int64),
                              want.view(np.int64))


def test_a_file_short_of_values_raises(tmp_path):
    fn = tmp_path / "CHGCAR"
    write_chgcar(fn, (7, 9, 11), 8)
    text = fn.read_text().splitlines(keepends=True)
    fn.write_text("".join(text[:-3]))  # 693 values less the last 13
    with pytest.raises(ValueError, match="ends after 680 of 693 values"):
        read(str(fn))


def test_a_token_that_is_no_number_raises(tmp_path):
    fn = tmp_path / "CHGCAR"
    write_chgcar(fn, (7, 9, 11), 9)
    text = fn.read_text().splitlines(keepends=True)
    text[-20] = text[-20].replace("E", "X", 1)
    fn.write_text("".join(text))
    with pytest.raises(ValueError, match="no number at byte"):
        read(str(fn))


def _spans(fn, **kw):
    spans = []
    with trace.recording(spans):
        got = read(fn, **kw)
    return got, {s.name: s.counters for s in spans}


@pytest.mark.parametrize("case", ["fixture", "augmented_spin"])
def test_without_the_library_the_python_path_reads_the_same(
        tmp_path, monkeypatch, case):
    make, flags = CASES[case]
    fn = str(make(tmp_path))
    direct, direct_spans = _spans(fn, **flags)

    def broken():
        raise OSError("no compiler")
    monkeypatch.setattr(_fastparse, "load_chgcar", broken)
    fallback, fallback_spans = _spans(fn, **flags)
    assert_same(fallback, direct)
    assert set(fallback_spans) == set(direct_spans) == \
        {"read." + key for key in direct[0]}
    for name, counters in direct_spans.items():
        # the same block's bytes either way; only the direct path parses
        assert counters["bytes"] == fallback_spans[name]["bytes"] > 0
        assert counters["direct"] == counters["bytes"]
        assert fallback_spans[name]["direct"] == 0


def test_a_second_read_lands_in_the_first_reads_buffer(monkeypatch):
    pool = hostcopy.Pool()
    monkeypatch.setattr(hostcopy, "_pool", pool)
    first, spans = _spans(FIXTURE)
    grid = first[0]["charge"]
    assert spans["read.charge"]["warm"] == 0
    where, want = grid.__array_interface__["data"][0], grid.copy()
    del first, grid
    assert [buf.nbytes for buf in pool.free] == [want.nbytes]
    second, spans = _spans(FIXTURE)
    grid = second[0]["charge"]
    assert spans["read.charge"]["warm"] == want.nbytes
    # counters are ints, as a JSON line of them needs
    assert {type(v) for v in spans["read.charge"].values()} == {int}
    assert grid.__array_interface__["data"][0] == where
    assert np.array_equal(grid.view(np.int64), want.view(np.int64))
