"""Host-side utility helpers: dtype policy, text formatting, stdout tools.

A copy of :mod:`pybader_tpu.utils`.  Behavioural parity targets in the
reference pybader package:
 - dtype_calc       (utils.py:15-37)
 - fortran_format   (utils.py:40-82)  — including its string-truncation
   behaviour when rounding crosses a power of ten
 - python_format    (utils.py:85-94)
 - nostdout         (utils.py:97-104)
"""
from __future__ import annotations

import sys
from contextlib import contextmanager
from io import StringIO

import numpy as np


def dtype_calc(max_val) -> str:
    """Smallest integer dtype able to represent max_val.

    Negative input selects a signed dtype sized for +/- that magnitude.
    """
    signed = max_val < 0
    mag = -2 * max_val if signed else max_val
    names = (
        ["int8", "int16", "int32", "int64"] if signed
        else ["uint8", "uint16", "uint32", "uint64"]
    )
    for name, limit in zip(names, (255, 65535, 4294967295)):
        if mag <= limit:
            return name
    return names[3]


_NATIVE_FORMAT_MIN = 1 << 14  # below this, ctypes call overhead dominates


def _native_format(a: np.ndarray, mode: int, prec: int) -> str | None:
    """Native formatter fast path (two orders of magnitude faster than the
    per-value Python paths; byte-exact, tests/test_native_format.py)."""
    if a.size < _NATIVE_FORMAT_MIN:
        return None
    try:
        from pybader_tpu_torch.io._fastparse import format_floats

        return format_floats(a, a.shape[1], mode, prec)
    except Exception:  # toolchain unavailable: fall back to Python
        return None


def fortran_format(a: np.ndarray, prec: int) -> str:
    """Format a 2-D array in Fortran 'standard form' rows.

    Every number is written with a zero integer part (mantissa shifted one
    place right) and negative numbers replace the leading zero with a minus:
    ``0.12345E+02`` / ``-.12345E+02``.
    """
    native = _native_format(a, 2, prec)
    if native is not None:
        return native
    rows, cols = a.shape
    flat = a.reshape(-1)
    out = []
    for i, v in enumerate(flat):
        if v == 0.0:
            s = " 0." + "0" * prec + "E+00"
        else:
            av = abs(v)
            exp = int(np.floor(np.log10(av))) + 1
            value = int(0.5 + av / 10.0 ** (exp - prec))
            digits = str(value)[:prec].ljust(prec, "0")
            sign = " -." if v < 0 else " 0."
            esign = "E-" if exp < 0 else "E+"
            s = f"{sign}{digits}{esign}{abs(exp):02d}"
        out.append(s)
        if (i + 1) % cols == 0:
            out.append("\n")
    return "".join(out)


def python_format(a: np.ndarray, prec: int, align: str = "") -> str:
    """Format a 2-D array in standard exponent form, one row per line."""
    if align in ("", " "):
        native = _native_format(a, 1 if align == " " else 0, prec)
        if native is not None:
            return native
    fmt = (f" {{:{align}.{prec}E}}" * a.shape[1] + "\n") * a.shape[0]
    return fmt.format(*a.reshape(-1))


def tqdm_wrap(*args, **kwargs):
    """Progress-bar wrapper matching the reference's formatting.

    Returns a plain passthrough iterator when tqdm is unavailable.
    """
    try:
        from shutil import get_terminal_size

        from tqdm import tqdm
    except ImportError:  # pragma: no cover
        class _Passthrough:
            def __init__(self, it=None, **kw):
                self._it = it

            def __iter__(self):
                return iter(self._it or ())

            def update(self, *_):
                pass

            def close(self):
                pass

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

        return _Passthrough(args[0] if args else None)
    ncols, _ = get_terminal_size((0, 0))
    bar_format = "  {desc} [{bar}] {percentage:3.0f}% {elapsed}<{remaining}  "
    ncols = 80 if ncols >= 80 else None
    return tqdm(*args, ascii=True, ncols=ncols, bar_format=bar_format,
                file=sys.stdout, **kwargs)


@contextmanager
def nostdout():
    """Temporarily silence stdout."""
    saved = sys.stdout
    sys.stdout = StringIO()
    try:
        yield
    finally:
        sys.stdout = saved


def parse_float_block(text: str, count: int,
                      threads: int | None = None) -> np.ndarray:
    """Parse whitespace-separated floats from text (first ``count`` values).

    Uses the native C++ fast parser when built (see native/), falling back
    to numpy.  This is the hot path of CHGCAR reading.  ``threads`` caps the
    parser's host threads (the CLI -j flag; None = one per CPU, up to 16).
    """
    try:
        from pybader_tpu_torch.io._fastparse import parse_floats  # noqa
        return parse_floats(text, count, n_threads=threads)
    except Exception:
        vals = np.array(text.split()[:count], dtype=np.float64)
        return vals
