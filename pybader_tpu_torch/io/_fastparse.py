"""ctypes binding for the native float-block parser (native/fastparse.cpp).

Builds the shared library lazily on first use (g++ -O3) into a
content-hash-keyed path, so the binary is never shared across hosts or
stale source revisions (an -march=native build from another CPU would
SIGILL straight through the callers' ``except Exception`` fallbacks).
Falls back cleanly: callers catch any exception raised here and use the
numpy parse path (pybader_tpu_torch/utils.py:parse_float_block).  A copy
of :mod:`pybader_tpu.io._fastparse`; both build the same native source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, os.pardir, os.pardir, "native", "fastparse.cpp")
_lib = None


def _lib_path(src: str) -> str:
    """Build-product path keyed on the source content hash.

    The package dir is preferred (persists across runs); a per-user temp
    dir is the fallback for read-only installs.
    """
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    name = f"libfastparse-{digest}.so"
    if os.access(_HERE, os.W_OK):
        return os.path.join(_HERE, name)
    cache = os.path.join(
        tempfile.gettempdir(), f"pybader_tpu_torch-{os.getuid()}")
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, name)


def _build(src: str, lib_path: str):
    # -march=native is safe: the output path is host-local and never
    # committed, so a binary can't migrate to a CPU it wasn't built for
    tmp = lib_path + f".tmp{os.getpid()}"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
        "-o", tmp, src,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, lib_path)  # atomic when several processes build at once


def _load():
    global _lib
    if _lib is not None:
        return _lib
    src = os.path.abspath(_SRC)
    if not os.path.isfile(src):
        raise FileNotFoundError(src)
    lib_path = _lib_path(src)
    if not os.path.isfile(lib_path):
        _build(src, lib_path)
    lib = ctypes.CDLL(lib_path)
    lib.fp_parse.restype = ctypes.c_long
    lib.fp_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_int,
    ]
    lib.fp_format.restype = ctypes.c_long
    lib.fp_format.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
    ]
    _lib = lib
    return lib


def format_floats(values: np.ndarray, cols: int, mode: int, prec: int,
                  n_threads: int | None = None, row_len: int = 0) -> str:
    """Format doubles into density-text rows (native fast path).

    ``mode``: 0 = python exponent form, 1 = sign-column padded, 2 =
    fortran standard form — byte-exact vs utils.python_format /
    fortran_format (asserted in tests/test_native_format.py).
    ``row_len`` > 0 formats logical rows of that many values independently
    (each ends its own line — the cube writer's per-z-row layout).
    """
    lib = _load()
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    vals = np.ascontiguousarray(values, dtype=np.float64).reshape(-1)
    cap = vals.size * (prec + 12) + 64
    buf = ctypes.create_string_buffer(cap)
    got = lib.fp_format(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), vals.size,
        cols, mode, prec, row_len, buf, cap, n_threads,
    )
    if got < -1:  # buffer estimate too small (huge exponents): retry
        cap = -got + 64
        buf = ctypes.create_string_buffer(cap)
        got = lib.fp_format(
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            vals.size, cols, mode, prec, row_len, buf, cap, n_threads,
        )
    if got < 0:
        raise ValueError("fp_format failed")
    return buf.raw[:got].decode("ascii")


def parse_floats(text: str, count: int, n_threads: int | None = None
                 ) -> np.ndarray:
    """Parse the first ``count`` whitespace-separated floats from text."""
    lib = _load()
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    buf = text.encode() if isinstance(text, str) else bytes(text)
    out = np.empty(count, dtype=np.float64)
    got = lib.fp_parse(
        buf, len(buf),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        count, n_threads,
    )
    if got < count:
        raise ValueError(f"expected {count} floats, parsed {got}")
    return out
